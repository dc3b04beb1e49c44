"""The port's PA learner and StandardScaler against the JAX package, on the
same numpy inputs. Tolerance rtol=2e-4, atol=2e-5 on tensors (float32
reductions summed in another order), 1e-5 on scalar losses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.learners.base import Learner as JaxLearner
from omldm_tpu.learners.linear import PAClassifier as JaxPA
from omldm_tpu.preprocessors.transforms import StandardScaler as JaxScaler
from omldm_tpu_torch.learners.base import Learner
from omldm_tpu_torch.learners.linear import PAClassifier
from omldm_tpu_torch.preprocessors.transforms import StandardScaler

RTOL, ATOL = 2e-4, 2e-5
VARIANTS = ["PA", "PA-I", "PA-II"]


def _batch(B=48, D=6, seed=0, masked=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, D) * 1.5 + 0.5).astype(np.float32)
    y = rng.randint(0, 2, B).astype(np.float32)
    mask = np.ones(B, np.float32)
    if masked:
        mask[B - 7:] = 0.0
        mask[3] = 0.0
    w0 = (rng.randn(D + 1) * 0.2).astype(np.float32)
    return w0, x, y, mask


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


@pytest.mark.parametrize("variant", VARIANTS)
def test_minibatch_update(variant):
    hp = {"C": 0.3, "variant": variant}
    w0, x, y, mask = _batch(seed=1)
    jp, jl = JaxPA(hp).update({"w": _j(w0)}, _j(x), _j(y), _j(mask))
    tp, tl = PAClassifier(hp).update({"w": _t(w0)}, _t(x), _t(y), _t(mask))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=RTOL, atol=ATOL)
    assert abs(float(tl) - float(jl)) <= 1e-5


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_update_per_record(variant, use_pallas):
    """JAX side: the generic lax.scan path, or the Pallas kernel in
    interpret mode (usePallas). The port takes its plain version on CPU and
    accepts usePallas without changing route."""
    hp = {"C": 0.05, "variant": variant, "usePallas": use_pallas}
    w0, x, y, mask = _batch(B=64, seed=2)
    jp, jl = JaxPA(hp).update_per_record({"w": _j(w0)}, _j(x), _j(y), _j(mask))
    tp, tl = PAClassifier(hp).update_per_record({"w": _t(w0)}, _t(x), _t(y), _t(mask))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=RTOL, atol=ATOL)
    assert abs(float(tl) - float(jl)) <= 1e-5


@pytest.mark.parametrize("variant", VARIANTS)
def test_generic_per_record_loop(variant):
    """Learner.update_per_record, the B=1 loop (JAX: lax.scan), on PA's
    mini-batch rule."""
    hp = {"C": 0.2, "variant": variant}
    w0, x, y, mask = _batch(B=32, seed=3)
    jp, jl = JaxLearner.update_per_record(
        JaxPA(hp), {"w": _j(w0)}, _j(x), _j(y), _j(mask)
    )
    tp, tl = Learner.update_per_record(
        PAClassifier(hp), {"w": _t(w0)}, _t(x), _t(y), _t(mask)
    )
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=RTOL, atol=ATOL)
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_predict_zero_weights_is_plus_one():
    """sign(x.w + 1e-30): a zero-weight model predicts +1 in both."""
    x = np.random.RandomState(4).randn(10, 5).astype(np.float32)
    w = np.zeros(6, np.float32)
    jp = np.asarray(JaxPA().predict({"w": _j(w)}, _j(x)))
    tp = PAClassifier().predict({"w": _t(w)}, _t(x)).numpy()
    np.testing.assert_array_equal(tp, jp)
    assert (tp == 1.0).all()


@pytest.mark.parametrize("seed", [5, 6])
def test_predict_loss_score(seed):
    w0, x, y, mask = _batch(seed=seed)
    params_j, params_t = {"w": _j(w0)}, {"w": _t(w0)}
    np.testing.assert_array_equal(
        PAClassifier().predict(params_t, _t(x)).numpy(),
        np.asarray(JaxPA().predict(params_j, _j(x))),
    )
    jl = JaxPA().loss(params_j, _j(x), _j(y), _j(mask))
    tl = PAClassifier().loss(params_t, _t(x), _t(y), _t(mask))
    assert abs(float(tl) - float(jl)) <= 1e-5
    js = JaxPA().score(params_j, _j(x), _j(y), _j(mask))
    ts = PAClassifier().score(params_t, _t(x), _t(y), _t(mask))
    assert abs(float(ts) - float(js)) <= 1e-6


def test_merge_averages_params():
    a, b = np.arange(4, dtype=np.float32), np.ones(4, np.float32)
    jm = JaxPA().merge([{"w": _j(a)}, {"w": _j(b)}])
    tm = PAClassifier().merge([{"w": _t(a)}, {"w": _t(b)}])
    np.testing.assert_allclose(tm["w"].numpy(), np.asarray(jm["w"]), rtol=0, atol=0)


def _scaler_close(ts, js):
    for key in ("count", "mean", "m2"):
        np.testing.assert_allclose(
            ts[key].numpy(), np.asarray(js[key]), rtol=RTOL, atol=ATOL, err_msg=key
        )


@pytest.mark.parametrize("D", [1, 6])
def test_standard_scaler_over_masked_batches(D):
    """Chan/Welford merge and transform over several masked batches,
    including an all-masked one (which must leave the statistics alone)."""
    rng = np.random.RandomState(7 + D)
    js, ts = JaxScaler().init(D), StandardScaler().init(D)
    # before any data: transform is the identity
    x0 = rng.randn(5, D).astype(np.float32)
    np.testing.assert_array_equal(StandardScaler().transform(ts, _t(x0)).numpy(), x0)
    for step in range(6):
        B = 24
        x = (rng.randn(B, D) * (step + 1) + step).astype(np.float32)
        mask = (rng.rand(B) > 0.3).astype(np.float32)
        if step == 3:
            mask[:] = 0.0
        js = JaxScaler().update(js, _j(x), _j(mask))
        ts = StandardScaler().update(ts, _t(x), _t(mask))
        _scaler_close(ts, js)
        np.testing.assert_allclose(
            StandardScaler().transform(ts, _t(x)).numpy(),
            np.asarray(JaxScaler().transform(js, _j(x))),
            rtol=RTOL, atol=ATOL,
        )


def test_standard_scaler_merge():
    rng = np.random.RandomState(11)
    states_j, states_t = [], []
    for k in range(3):
        x = (rng.randn(20, 4) + k).astype(np.float32)
        mask = np.ones(20, np.float32)
        states_j.append(JaxScaler().update(JaxScaler().init(4), _j(x), _j(mask)))
        states_t.append(StandardScaler().update(StandardScaler().init(4), _t(x), _t(mask)))
    _scaler_close(StandardScaler().merge(states_t), JaxScaler().merge(states_j))
