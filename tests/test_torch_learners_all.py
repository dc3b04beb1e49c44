"""Every dense learner of the port against the JAX package, on the same numpy
inputs: init, update, update_per_record, predict, loss, score and merge.

Random initial parameters (the RFF projection, K-means' centroids, the
NN's weights) are drawn with jax.random in one package and a
torch.Generator in the other, so each comparison loads the JAX draw into
the port. Tolerances: tensors within rtol=2e-4, atol=2e-5 and scalar
losses and scores within 1e-5 (float32 reductions summed in another
order), ORR's Cholesky solve and NN's Adam step included; predictions that
are class ids or signs equal. HT runs the same numpy code on both sides,
so its losses, tree sizes and predictions are equal.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import LearnerSpec as JaxSpec
from omldm_tpu.learners.registry import LEARNERS as JAX_LEARNERS
from omldm_tpu.pipelines import MLPipeline as JaxPipeline
from omldm_tpu_torch.api.requests import LearnerSpec
from omldm_tpu_torch.learners.base import Learner
from omldm_tpu_torch.learners.registry import LEARNERS
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.pipelines.pipeline import _leaves, state_from_numpy

RTOL, ATOL = 2e-4, 2e-5
SCALAR_ATOL = 1e-5
D, B = 6, 40

# (id, learner name, hyper-parameters, data structure, label kind)
CASES = [
    ("regressor_pa_I", "RegressorPA", {"C": 0.5, "epsilon": 0.05}, {}, "regression"),
    ("regressor_pa_II", "RegressorPA", {"C": 0.2, "variant": "PA-II"}, {}, "regression"),
    ("orr", "ORR", {"lambda": 0.5}, {}, "regression"),
    ("svm_linear", "SVM", {"lambda": 1e-2}, {}, "binary"),
    ("svm_rff", "SVM", {"lambda": 1e-2}, {"rffDim": 16, "gamma": 0.5}, "binary"),
    ("softmax2", "Softmax", {"learningRate": 0.2}, {}, "binary"),
    ("softmax3", "Softmax", {"nClasses": 3}, {}, "multi3"),
    ("mcpa_I", "MultiClassPA", {"C": 0.3}, {}, "multi3"),
    ("mcpa_II", "MultiClassPA", {"C": 0.3, "variant": "PA-II", "nClasses": 4}, {}, "multi4"),
    ("kmeans", "K-means", {"k": 3}, {}, "none"),
    ("nn_adam", "NN", {}, {"hiddenLayers": [8, 5]}, "binary"),
    ("nn_adam3", "NN", {"learningRate": 0.05}, {"hiddenLayers": [7], "nClasses": 3,
                                                 "activation": "tanh"}, "multi3"),
    ("nn_sgd", "NN", {"optimizer": "sgd", "learningRate": 0.1}, {"hiddenLayers": [6]},
     "binary"),
    ("nn_sgd_momentum", "NN", {"optimizer": "sgd", "momentum": 0.9}, {"hiddenLayers": [6]},
     "binary"),
]
IDS = [c[0] for c in CASES]


def _labels(kind, rng, x):
    if kind == "regression":
        return (x @ rng.randn(D) + 0.1 * rng.randn(x.shape[0])).astype(np.float32)
    if kind == "binary":
        return (x @ rng.randn(D) > 0).astype(np.float32)
    if kind.startswith("multi"):
        return rng.randint(0, int(kind[5:]), x.shape[0]).astype(np.float32)
    return np.zeros(x.shape[0], np.float32)


def _batch(kind, seed, n=B):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, D) * 1.3 + 0.2).astype(np.float32)
    y = _labels(kind, rng, x)
    mask = np.ones(n, np.float32)
    mask[n - 5:] = 0.0
    mask[2] = 0.0
    return x, y, mask


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _to_port(jparams):
    """A JAX parameter tree (optax states included) as the port's tree."""
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _flat_j(jparams):
    return np.asarray(jax.flatten_util.ravel_pytree(jparams)[0])


def _flat_t(tparams):
    return torch.cat([t.reshape(-1).to(torch.float32) for t in _leaves(tparams)]).numpy()


def _learners(name, hp, ds):
    return JAX_LEARNERS[name](hp, ds), LEARNERS[name](hp, ds)


def _trained(jl, kind, seed=0):
    """JAX params after one update from init, so later checks start from a
    non-trivial model."""
    p = jl.init(D, jax.random.PRNGKey(seed))
    x, y, m = _batch(kind, seed + 100)
    return jl.update(p, _j(x), _j(y), _j(m))[0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_init(case):
    """Deterministic inits are equal; a random init has JAX's layout (the
    flat vector's length and each leaf's shape and dtype) and is the seeded
    generator's draw (two inits from one seed are equal)."""
    _, name, hp, ds, _ = case
    jl, tl = _learners(name, hp, ds)
    jp = jl.init(D, jax.random.PRNGKey(3))
    tp = tl.init(D, torch.Generator().manual_seed(3), torch.device("cpu"))
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves = _leaves(tp)
    assert [l.shape for l in tleaves] == [tuple(np.shape(l)) for l in jleaves]
    assert [str(l.dtype).split(".")[-1] for l in tleaves] == [str(np.asarray(l).dtype)
                                                              for l in jleaves]
    again = tl.init(D, torch.Generator().manual_seed(3), torch.device("cpu"))
    np.testing.assert_array_equal(_flat_t(again), _flat_t(tp))
    random = name in ("K-means", "NN") or ds.get("rffDim")
    if not random:
        np.testing.assert_array_equal(_flat_t(tp), _flat_j(jp))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("per_record", [False, True], ids=["batch", "per_record"])
def test_update(case, per_record):
    _, name, hp, ds, kind = case
    jl, tl = _learners(name, hp, ds)
    jp = _trained(jl, kind)
    x, y, m = _batch(kind, 7)
    jfn = jl.update_per_record if per_record else jl.update
    tfn = tl.update_per_record if per_record else tl.update
    jp2, jloss = jfn(jp, _j(x), _j(y), _j(m))
    tp2, tloss = tfn(_to_port(jp), _t(x), _t(y), _t(m))
    np.testing.assert_allclose(_flat_t(tp2), _flat_j(jp2), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=SCALAR_ATOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_predict_loss_score(case):
    _, name, hp, ds, kind = case
    jl, tl = _learners(name, hp, ds)
    jp = _trained(jl, kind, seed=1)
    tp = _to_port(jp)
    x, y, m = _batch(kind, 8)
    jpred = np.asarray(jl.predict(jp, _j(x)))
    tpred = tl.predict(tp, _t(x)).numpy()
    if kind == "regression":
        np.testing.assert_allclose(tpred, jpred, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(tpred, jpred)
    for fn in ("loss", "score"):
        jv = float(getattr(jl, fn)(jp, _j(x), _j(y), _j(m)))
        tv = float(getattr(tl, fn)(tp, _t(x), _t(y), _t(m)))
        np.testing.assert_allclose(tv, jv, rtol=0, atol=SCALAR_ATOL, err_msg=fn)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_merge(case):
    """Three replicas trained on different batches merge alike: ORR sums
    its statistics, K-means weights by counts, NN averages its layers and
    resets the optimizer, the rest average."""
    _, name, hp, ds, kind = case
    jl, tl = _learners(name, hp, ds)
    reps = [_trained(jl, kind, seed=s) for s in range(3)]
    jm = jl.merge(reps)
    tm = tl.merge([_to_port(p) for p in reps])
    np.testing.assert_allclose(_flat_t(tm), _flat_j(jm), rtol=RTOL, atol=ATOL)


def test_base_merge_averages_a_nested_tree():
    """Learner.merge is a tree average: dicts, lists and tuples nest."""
    trees = [{"a": [torch.full((2,), float(i)), (torch.tensor(2.0 * i),)],
              "b": torch.tensor([i, -i], dtype=torch.float32)} for i in range(3)]
    m = Learner().merge(trees)
    np.testing.assert_array_equal(m["a"][0].numpy(), [1.0, 1.0])
    assert isinstance(m["a"][1], tuple) and float(m["a"][1][0]) == 2.0
    np.testing.assert_array_equal(m["b"].numpy(), [1.0, -1.0])


# --- out-of-range class labels ------------------------------------------------

OOR_CASES = [
    ("Softmax", {"learningRate": 0.3}, {}),
    ("MultiClassPA", {"C": 0.5, "nClasses": 2}, {}),
    ("NN", {"learningRate": 0.05}, {"hiddenLayers": [5], "nClasses": 3}),
]


@pytest.mark.parametrize("name,hp,ds", OOR_CASES, ids=[c[0] for c in OOR_CASES])
@pytest.mark.parametrize("masked", [False, True], ids=["valid", "masked"])
def test_out_of_range_labels(name, hp, ds, masked):
    """Labels -1, 0, K-1 and K (and -2, past the wrap): the port gives the
    JAX package's values -- a zero one-hot row, -1 wrapped to the last
    class, NaN loss past K -- where torch's one_hot and gather would raise.
    ``masked`` masks the out-of-range rows out of the update."""
    jl, tl = _learners(name, hp, ds)
    k = int(hp.get("nClasses", ds.get("nClasses", 2)))
    rng = np.random.RandomState(5)
    x = rng.randn(12, D).astype(np.float32)
    y = np.array([-1, 0, k - 1, k, -2, 0, k, k - 1, -1, 1, 0, k - 1], np.float32)
    m = np.ones(12, np.float32)
    if masked:
        m[(y < 0) | (y >= k)] = 0.0
    jp = _trained(jl, "multi%d" % k if k > 2 else "binary", seed=2)
    tp = _to_port(jp)
    jp2, jloss = jl.update(jp, _j(x), _j(y), _j(m))
    tp2, tloss = tl.update(tp, _t(x), _t(y), _t(m))
    np.testing.assert_allclose(_flat_t(tp2), _flat_j(jp2), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=SCALAR_ATOL)
    for fn in ("loss", "score"):
        jv = float(getattr(jl, fn)(jp2, _j(x), _j(y), _j(m)))
        tv = float(getattr(tl, fn)(_to_port(jp2), _t(x), _t(y), _t(m)))
        np.testing.assert_allclose(tv, jv, rtol=0, atol=SCALAR_ATOL, err_msg=fn)
    np.testing.assert_array_equal(tl.predict(_to_port(jp2), _t(x)).numpy(),
                                  np.asarray(jl.predict(jp2, _j(x))))


def test_out_of_range_loss_is_nan_past_k():
    """The unmasked loss past K is NaN in both packages (take_along_axis
    fills), and finite at -1 (it wraps)."""
    jl, tl = _learners("Softmax", {}, {})
    x = np.ones((2, D), np.float32)
    m = np.ones(2, np.float32)
    params = tl.init(D, None, torch.device("cpu"))
    for label, nan in ((2.0, True), (-1.0, False)):
        y = np.array([0.0, label], np.float32)
        jv = float(jl.loss(jl.init(D), _j(x), _j(y), _j(m)))
        tv = float(tl.loss(params, _t(x), _t(y), _t(m)))
        assert np.isnan(jv) == np.isnan(tv) == nan


def test_ties_pick_the_first_index():
    """MultiClassPA's rival and K-means' assignment take the first of tied
    scores, as jnp.argmax/argmin do."""
    jl, tl = _learners("MultiClassPA", {"C": 1.0, "nClasses": 4}, {})
    x = np.ones((3, D), np.float32)
    y = np.array([2, 0, 3], np.float32)
    m = np.ones(3, np.float32)
    jp, _ = jl.update(jl.init(D), _j(x), _j(y), _j(m))
    tp, _ = tl.update(tl.init(D), _t(x), _t(y), _t(m))
    np.testing.assert_allclose(tp["W"].numpy(), np.asarray(jp["W"]), rtol=RTOL, atol=ATOL)
    jk, tk = _learners("K-means", {"k": 3}, {})
    cents = {"centroids": np.zeros((3, D), np.float32), "counts": np.zeros(3, np.float32)}
    jv = np.asarray(jk.predict(jax.tree_util.tree_map(_j, cents), _j(x)))
    tv = tk.predict(state_from_numpy(cents, "cpu"), _t(x)).numpy()
    np.testing.assert_array_equal(tv, jv)
    assert (tv == 0).all()


# --- NN: the flat vector and the weight carrier --------------------------------


@pytest.mark.parametrize("hp", [{}, {"optimizer": "sgd"}, {"optimizer": "sgd", "momentum": 0.5}],
                         ids=["adam", "sgd", "sgd_momentum"])
def test_nn_flat_params_follow_ravel_pytree(hp):
    """The pipeline's flat vector is JAX's ravel_pytree of the same NN
    state, optimizer state included: layers' W, b, then Adam's count (a
    float), mu, nu -- or SGD's trace, which exists even at momentum 0. It
    round-trips with the count back to int32."""
    ds = {"hiddenLayers": [4], "nFeatures": 3}
    jpipe = JaxPipeline(JaxSpec("NN", hyper_parameters=hp, data_structure=ds), dim=3, rng=jax.random.PRNGKey(0))
    tpipe = MLPipeline(LearnerSpec("NN", hyper_parameters=hp, data_structure=ds), dim=3, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = rng.randn(8, 3).astype(np.float32)
        y = (rng.rand(8) > 0.5).astype(np.float32)
        jpipe.fit(x, y, np.ones(8, np.float32))
    tpipe.load_state(state_from_numpy(jax.tree_util.tree_map(np.asarray, jpipe.state), "cpu"))
    jflat, _ = jpipe.get_flat_params()
    tflat, unravel = tpipe.get_flat_params()
    n_layers = 3 * 4 + 4 + 4 * 1 + 1
    assert jflat.size == tflat.size == (3 * n_layers + 1 if not hp else 2 * n_layers)
    np.testing.assert_array_equal(tflat, jflat)
    if not hp:
        assert tflat[n_layers] == 3.0  # Adam's count after three fits
        assert tpipe.state["params"]["opt"][0]["count"].dtype == torch.int32
    back = unravel(tflat)
    assert [t.dtype for t in _leaves(back)] == [t.dtype for t in _leaves(tpipe.state["params"])]
    np.testing.assert_array_equal(_flat_t(back), tflat)


def test_trained_jax_nn_state_carries_across():
    """A JAX NN pipeline state trained with Adam (optax NamedTuples in its
    tree) carries into the port through state_from_numpy and predicts the
    same classes; the next fit matches too."""
    ds = {"hiddenLayers": [6, 4], "nClasses": 3}
    jpipe = JaxPipeline(JaxSpec("NN", hyper_parameters={"learningRate": 0.05}, data_structure=ds), dim=D,
                        rng=jax.random.PRNGKey(1))
    rng = np.random.RandomState(3)
    for _ in range(5):
        x, y, m = _batch("multi3", int(rng.randint(1000)))
        jpipe.fit(x, y, m)
    state = jax.tree_util.tree_map(np.asarray, jpipe.state)
    tpipe = MLPipeline(LearnerSpec("NN", hyper_parameters={"learningRate": 0.05}, data_structure=ds), dim=D, device="cpu")
    tpipe.load_state(state_from_numpy(state, "cpu"))
    assert isinstance(tpipe.state["params"]["opt"][0], dict)
    x, y, m = _batch("multi3", 99)
    np.testing.assert_array_equal(tpipe.predict(x).numpy(), np.asarray(jpipe.predict(x)))
    jpipe.fit(x, y, m)
    tpipe.fit(x, y, m)
    np.testing.assert_allclose(tpipe.get_flat_params()[0], jpipe.get_flat_params()[0],
                               rtol=RTOL, atol=ATOL)


# --- HT: the same numpy code on both sides ---------------------------------------


def test_hoeffding_tree_matches():
    """The port's copy grows the same tree from the same stream: equal
    losses, node counts and predictions (nothing of it is a tensor)."""
    hp = {"nClasses": 3, "gracePeriod": 30, "delta": 0.05, "tau": 0.3}
    jl, tl = _learners("HT", hp, {})
    jp, tp = jl.init(D), tl.init(D)
    rng = np.random.RandomState(4)
    for step in range(12):
        x = rng.randn(25, D).astype(np.float32)
        y = (np.digitize(x[:, 0] + 0.3 * x[:, 1], [-0.5, 0.5])).astype(np.float32)
        m = np.ones(25, np.float32)
        m[step % 25] = 0.0
        jp, jloss = jl.update(jp, x, y, m)
        tp, tloss = tl.update(tp, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m))
        assert float(tloss) == float(jloss)
    assert tp["n_nodes"] == jp["n_nodes"] > 1
    xt = rng.randn(50, D).astype(np.float32)
    np.testing.assert_array_equal(tl.predict(tp, xt), jl.predict(jp, xt))
    assert tl.host_side and jl.host_side
