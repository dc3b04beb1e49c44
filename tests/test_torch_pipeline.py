"""The port's MLPipeline (StandardScaler -> PA-I) against the JAX
MLPipeline on the same numpy batches. Tolerance rtol=2e-4, atol=2e-5 on
parameters and 1e-5 on losses (float32 reductions in another order);
predictions are signs and must agree exactly at these margins."""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import LearnerSpec as JaxLearnerSpec
from omldm_tpu.api.requests import PreprocessorSpec as JaxPrepSpec
from omldm_tpu.pipelines import MLPipeline as JaxPipeline
from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec
from omldm_tpu_torch.pipelines import MLPipeline, state_from_numpy, state_to_numpy

RTOL, ATOL = 2e-4, 2e-5
D, B = 7, 32
HP = {"C": 0.01, "variant": "PA-I"}


def _pipelines(per_record):
    # the JAX side runs its Pallas kernel (interpret mode) on the per-record
    # route; the port accepts and ignores the flag
    hp = dict(HP, usePallas=True) if per_record else HP
    jp = JaxPipeline(
        JaxLearnerSpec("PA", hyper_parameters=hp),
        [JaxPrepSpec("StandardScaler")], dim=D, per_record=per_record,
    )
    tp = MLPipeline(
        LearnerSpec("PA", hyper_parameters=hp),
        [PreprocessorSpec("StandardScaler")], dim=D, per_record=per_record,
        device="cpu",
    )
    return jp, tp


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(D)
    out = []
    for i in range(n):
        x = (rng.randn(B, D) * 3.0 + 2.0).astype(np.float32)
        y = ((x - 2.0) @ w > 0).astype(np.float32)
        mask = np.ones(B, np.float32)
        if i % 3 == 2:
            mask[B - 5:] = 0.0  # a ragged batch
        out.append((x, y, mask))
    return out


def _assert_same(jp, tp, probe):
    x, y, mask = probe
    jf, _ = jp.get_flat_params()
    tf, _ = tp.get_flat_params()
    assert tf.dtype == np.float32
    np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        tp.predict(x).numpy(), np.asarray(jp.predict(x))
    )
    jl, js = jp.evaluate(x, y, mask)
    tl, ts = tp.evaluate(x, y, mask)
    assert abs(tl - jl) <= 1e-5 and abs(ts - js) <= 1e-6
    assert tp.fitted == jp.fitted


@pytest.mark.parametrize("per_record", [True, False])
def test_ten_batches_match(per_record):
    jp, tp = _pipelines(per_record)
    batches = _batches(11)
    probe = batches[-1]
    launches = []
    tp.on_launch = lambda: launches.append(1)
    for x, y, mask in batches[:10]:
        jl = jp.fit(x, y, mask)
        tl = tp.fit(x, y, mask)
        assert abs(float(tl) - float(jl)) <= 1e-5
        _assert_same(jp, tp, probe)
    # one counted launch per fit, predict and evaluate (10 of each)
    assert len(launches) == 30
    jc, tc = jp.curve_slice(), tp.curve_slice()
    assert [f for _, f in tc] == [f for _, f in jc]
    np.testing.assert_allclose([l for l, _ in tc], [l for l, _ in jc], atol=1e-5)
    assert abs(tp.cumulative_loss - jp.cumulative_loss) <= 1e-3


@pytest.mark.parametrize("per_record", [True, False])
def test_fit_many_matches_sequential_fits(per_record):
    jp, tp = _pipelines(per_record)
    batches = _batches(4, seed=1)
    xs, ys, ms = (np.stack([b[i] for b in batches]) for i in range(3))
    jl = jp.fit_many(xs, ys, ms)
    tl = tp.fit_many(xs, ys, ms)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    _assert_same(jp, tp, batches[0])
    assert [f for _, f in tp.curve_slice()] == [f for _, f in jp.curve_slice()]


@pytest.mark.parametrize("per_record", [True, False])
def test_state_from_numpy_carries_a_jax_state(per_record):
    """A JAX state after 5 fits, carried into the port, then 5 more fits on
    both sides."""
    jp, tp = _pipelines(per_record)
    batches = _batches(11, seed=2)
    for x, y, mask in batches[:5]:
        jp.fit(x, y, mask)
    tree = jax.tree_util.tree_map(np.asarray, jp.state)
    tp.load_state(state_from_numpy(tree, "cpu"))
    assert tp.fitted == jp.fitted
    back = state_to_numpy(tp.state)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for x, y, mask in batches[5:10]:
        jp.fit(x, y, mask)
        tp.fit(x, y, mask)
    _assert_same(jp, tp, batches[10])


def test_flat_params_follow_ravel_pytree_order():
    """Sorted dict keys, leaves flattened C-order, float32."""
    rng = np.random.RandomState(3)
    params = {
        "w": rng.randn(3, 2).astype(np.float32),
        "b": rng.randn(4).astype(np.float32),
        "a": {"z": rng.randn(2).astype(np.float32), "c": rng.randn(1, 3).astype(np.float32)},
    }
    flat_j, _ = jax.flatten_util.ravel_pytree(jax.tree_util.tree_map(jnp.asarray, params))
    _, tp = _pipelines(False)
    tp.state["params"] = state_from_numpy(params, "cpu")
    flat_t, unravel = tp.get_flat_params()
    np.testing.assert_array_equal(flat_t, np.asarray(flat_j))
    rebuilt = unravel(flat_t * 2.0)
    assert list(rebuilt) == list(params)
    np.testing.assert_array_equal(rebuilt["a"]["c"].numpy(), params["a"]["c"] * 2.0)
    tp.set_flat_params(np.asarray(flat_j, np.float64))  # float64 in, float32 kept
    assert tp.state["params"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(tp.state["params"]["w"].numpy(), params["w"])
