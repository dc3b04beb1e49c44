"""The port's sparse learners (omldm_tpu_torch.learners.sparse_linear)
against the JAX package's, from the same state on the same numpy batches:
``update``, ``update_per_record``, ``predict``, ``loss`` and ``score``.

Tolerances: parameters and losses within rtol=2e-4, atol=2e-5 after a
mini-batch update or a per-record pass of 16 dependent rows (float32 sums
over K in another order, carried through the chain); predictions of the
classifiers equal (no margin of these inputs lies within rounding of zero),
the regressor's margins within rtol=atol=1e-5; scores within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import LearnerSpec as JaxLearnerSpec
from omldm_tpu.learners.registry import make_learner as jax_make_learner
from omldm_tpu_torch.api.requests import LearnerSpec
from omldm_tpu_torch.learners import SPARSE_LEARNERS, make_learner
from omldm_tpu_torch.learners.sparse_linear import SparseLinear

D, B, K = 13 + (1 << 10), 16, 9
TOL = dict(rtol=2e-4, atol=2e-5)
SPECS = {
    "PA-I": ("PA", {"C": 0.5, "variant": "PA-I"}),
    "PA-II": ("PA", {"C": 0.1, "variant": "PA-II"}),
    "PA": ("PA", {"variant": "PA"}),
    "RegressorPA": ("RegressorPA", {"C": 0.5, "epsilon": 0.05}),
    "SVM": ("SVM", {"lambda": 1e-2}),
    "Softmax3": ("Softmax", {"learningRate": 0.1, "nClasses": 3}),
    "Softmax2": ("Softmax", {"learningRate": 0.1, "nClasses": 2}),
}


def _learners(key):
    name, hp = SPECS[key]
    ds = {"sparse": True, "nFeatures": D}
    return (jax_make_learner(JaxLearnerSpec(name, hyper_parameters=hp, data_structure=ds)),
            make_learner(LearnerSpec(name, hyper_parameters=hp, data_structure=ds)))


def _state(key, rng):
    name, hp = SPECS[key]
    if name == "Softmax":
        return {"W": (rng.randn(D + 1, hp["nClasses"]) * 0.3).astype(np.float32)}
    state = {"w": (rng.randn(D + 1) * 0.3).astype(np.float32)}
    if name == "SVM":
        state["t"] = np.float32(5.0)
    return state


def _batch(key, rng):
    """Criteo-shaped rows: 3 numeric slots, hashed slots from a small pool
    (so rows share weights), a pad slot, a few rows masked."""
    idx = np.zeros((B, K), np.int32)
    val = np.zeros((B, K), np.float32)
    idx[:, :3] = np.arange(3)
    val[:, :3] = rng.randn(B, 3)
    pool = rng.randint(13, D, size=40)
    idx[:, 3:K - 1] = rng.choice(pool, size=(B, K - 4))
    val[:, 3:K - 1] = rng.choice([-1.0, 1.0], size=(B, K - 4))
    name, hp = SPECS[key]
    if name == "Softmax":
        y = rng.randint(0, hp["nClasses"], B).astype(np.float32)
    elif name == "RegressorPA":
        y = rng.randn(B).astype(np.float32)
    else:
        y = rng.randint(0, 2, B).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[[2, 11, 15]] = 0.0
    return (idx, val), y, mask


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(x, lib):
    return tuple(lib(a) for a in x)


def test_every_sparse_learner_is_ported():
    from omldm_tpu.learners.sparse_linear import SPARSE_LEARNERS as JAX_SPARSE

    assert set(SPARSE_LEARNERS) == set(JAX_SPARSE)
    assert all(issubclass(cls, SparseLinear) for cls in SPARSE_LEARNERS.values())


@pytest.mark.parametrize("per_record", [False, True])
@pytest.mark.parametrize("key", list(SPECS))
def test_update_matches_jax(key, per_record):
    rng = np.random.RandomState(len(key) + 7 * per_record)
    jl, tl = _learners(key)
    state = _state(key, rng)
    x, y, mask = _batch(key, rng)
    j_fn = jl.update_per_record if per_record else jl.update
    t_fn = tl.update_per_record if per_record else tl.update
    jp, jloss = j_fn(_jax(state), _x(x, jnp.asarray), jnp.asarray(y), jnp.asarray(mask))
    tp, tloss = t_fn(_torch(state), _x(x, torch.from_numpy), torch.from_numpy(y),
                     torch.from_numpy(mask))
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32 and tuple(tp[k].shape) == jp[k].shape
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL, err_msg=k)
    assert tloss.shape == ()
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    # the update moved the model
    moved = "t" if "t" in state else next(iter(state))
    assert not np.array_equal(tp[moved].numpy(), state[moved])


@pytest.mark.parametrize("key", list(SPECS))
def test_predict_loss_score_match_jax(key):
    rng = np.random.RandomState(len(key) + 100)
    jl, tl = _learners(key)
    state = _state(key, rng)
    x, y, mask = _batch(key, rng)
    jargs = (_jax(state), _x(x, jnp.asarray))
    targs = (_torch(state), _x(x, torch.from_numpy))
    jpred, tpred = np.asarray(jl.predict(*jargs)), tl.predict(*targs).numpy()
    if SPECS[key][0] == "RegressorPA":
        np.testing.assert_allclose(tpred, jpred, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(tpred, jpred)
    for fn in ("loss", "score"):
        jv = float(getattr(jl, fn)(*jargs, jnp.asarray(y), jnp.asarray(mask)))
        tv = float(getattr(tl, fn)(*targs, torch.from_numpy(y), torch.from_numpy(mask)))
        assert abs(tv - jv) <= (1e-6 if fn == "score" else 1e-5 + 1e-5 * abs(jv)), (fn, tv, jv)


@pytest.mark.parametrize("key", ["PA-I", "SVM", "Softmax3"])
def test_init_matches_jax(key):
    jl, tl = _learners(key)
    jp = jl.init(D)
    tp = tl.init(D, device=torch.device("cpu"))
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_no_sparse_variant_raises():
    with pytest.raises(KeyError, match="no sparse variant"):
        make_learner(LearnerSpec("ORR", data_structure={"sparse": True, "nFeatures": 8}))


# --- donation: the pipeline's fit gives the state up; a direct call does not ---


@pytest.mark.parametrize("per_record", [False, True])
@pytest.mark.parametrize("key", list(SPECS))
def test_update_leaves_its_input_params_unchanged(key, per_record):
    """Called directly (no donation), an update returns new tensors and
    leaves the ones it was given as they were."""
    rng = np.random.RandomState(len(key) + 31 * per_record)
    _, tl = _learners(key)
    state = _state(key, rng)
    x, y, mask = _batch(key, rng)
    params = _torch(state)
    fn = tl.update_per_record if per_record else tl.update
    new, _ = fn(params, _x(x, torch.from_numpy), torch.from_numpy(y), torch.from_numpy(mask))
    for k in state:
        np.testing.assert_array_equal(params[k].numpy(), state[k], err_msg=k)
        assert new[k].data_ptr() != params[k].data_ptr(), k
        assert not np.array_equal(new[k].numpy(), state[k]), k


@pytest.mark.parametrize("per_record", [False, True])
@pytest.mark.parametrize("key", list(SPECS))
def test_donated_update_writes_in_place(key, per_record):
    """With ``donate=True`` the result equals the functional update's
    exactly (the same sums in the same order), and the scatter wrote it into
    the donated weight's memory (SVM's decay makes a new tensor first)."""
    rng = np.random.RandomState(len(key) + 57 * per_record)
    _, tl = _learners(key)
    state = _state(key, rng)
    x, y, mask = _batch(key, rng)
    fn = tl.update_per_record if per_record else tl.update
    args = (_x(x, torch.from_numpy), torch.from_numpy(y), torch.from_numpy(mask))
    want, want_loss = fn(_torch(state), *args)
    params = _torch(state)
    leaf = "W" if "W" in state else "w"
    ptr = params[leaf].data_ptr()
    got, loss = fn(params, *args, donate=True)
    for k in state:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert float(loss) == float(want_loss)
    assert (got[leaf].data_ptr() == ptr) == (SPECS[key][0] != "SVM")


PIPELINE_KEYS = ["PA-II", "RegressorPA", "SVM", "Softmax2"]


def _pipelines(key):
    from omldm_tpu.pipelines import MLPipeline as JaxPipeline
    from omldm_tpu_torch.pipelines import MLPipeline

    name, hp = SPECS[key]
    ds = {"sparse": True, "nFeatures": D}
    return (JaxPipeline(JaxLearnerSpec(name, hyper_parameters=hp, data_structure=ds), dim=D),
            MLPipeline(LearnerSpec(name, hyper_parameters=hp, data_structure=ds), dim=D,
                       device="cpu"))


@pytest.mark.parametrize("key", PIPELINE_KEYS)
def test_pipeline_fits_in_place_and_match_jax(key):
    """Six donated fits through MLPipeline.fit against the JAX pipeline
    (whose jitted fit donates its state): parameters within the scatter
    envelope of tests/test_torch_sparse_ops.py, losses within it; the
    sparse scatter wrote every fit into the same memory; flat parameters
    taken before a fit are a copy the fit leaves alone."""
    from tests.test_torch_sparse_ops import SCATTER_TOL

    jp, tp = _pipelines(key)
    leaf = "W" if SPECS[key][0] == "Softmax" else "w"
    ptr = tp.state["params"][leaf].data_ptr()
    rng = np.random.RandomState(len(key) + 3)
    for step in range(6):
        x, y, mask = _batch(key, rng)
        flat_before, _ = tp.get_flat_params()
        kept = flat_before.copy()
        jl = jp.fit(x, y, mask)
        tl = tp.fit(x, y, mask)
        np.testing.assert_allclose(float(tl), float(jl), **SCATTER_TOL)
        np.testing.assert_array_equal(flat_before, kept)
        jf, _ = jp.get_flat_params()
        tf, _ = tp.get_flat_params()
        np.testing.assert_allclose(tf, jf, **SCATTER_TOL, err_msg=f"fit {step}")
        assert not np.array_equal(tf, flat_before)
        if key != "SVM":
            assert tp.state["params"][leaf].data_ptr() == ptr
    assert tp.fitted == jp.fitted
