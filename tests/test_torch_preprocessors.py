"""The port's MinMaxScaler and PolynomialFeatures against the JAX package, on
the same numpy inputs, alone and in front of a learner in a pipeline.

Tolerances: MinMaxScaler's extrema are copies of input values, so its
state must be equal; transforms within rtol=2e-4, atol=2e-5 (a division,
and the pipeline's float32 reductions summed in another order).
PolynomialFeatures' products are single multiplies, so its output must be
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import LearnerSpec as JaxLearnerSpec
from omldm_tpu.api.requests import PreprocessorSpec as JaxPrepSpec
from omldm_tpu.pipelines import MLPipeline as JaxPipeline
from omldm_tpu.preprocessors.transforms import MinMaxScaler as JaxMinMax
from omldm_tpu.preprocessors.transforms import PolynomialFeatures as JaxPoly
from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.preprocessors.transforms import MinMaxScaler, PolynomialFeatures

RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("D", [1, 5])
def test_minmax_over_masked_batches(D):
    """Running extrema over masked batches, an all-masked one among them:
    +-inf until a feature is seen, so a feature never seen passes through
    unscaled (the ``seen`` mask)."""
    rng = np.random.RandomState(D)
    js, ts = JaxMinMax().init(D), MinMaxScaler().init(D)
    x0 = rng.randn(4, D).astype(np.float32)
    np.testing.assert_array_equal(MinMaxScaler().transform(ts, _t(x0)).numpy(), x0)
    np.testing.assert_array_equal(ts["min"].numpy(), np.asarray(js["min"]))
    for step in range(5):
        x = (rng.randn(16, D) * (step + 1)).astype(np.float32)
        mask = (rng.rand(16) > 0.4).astype(np.float32)
        if step == 0:
            mask[:] = 0.0  # nothing seen yet: still the identity
        js = JaxMinMax().update(js, jnp.asarray(x), jnp.asarray(mask))
        ts = MinMaxScaler().update(ts, _t(x), _t(mask))
        for key in ("min", "max"):
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]), err_msg=key)
        np.testing.assert_allclose(
            MinMaxScaler().transform(ts, _t(x)).numpy(),
            np.asarray(JaxMinMax().transform(js, jnp.asarray(x))), rtol=RTOL, atol=ATOL,
        )


def test_minmax_constant_feature_and_merge():
    """A constant feature spans 1e-12, not zero; merging takes the extrema
    of every state."""
    x = np.array([[1.0, 2.0], [1.0, 5.0], [1.0, -1.0]], np.float32)
    m = np.ones(3, np.float32)
    states_j, states_t = [], []
    for k in range(3):
        xk = x + k
        states_j.append(JaxMinMax().update(JaxMinMax().init(2), jnp.asarray(xk), jnp.asarray(m)))
        states_t.append(MinMaxScaler().update(MinMaxScaler().init(2), _t(xk), _t(m)))
    jm, tm = JaxMinMax().merge(states_j), MinMaxScaler().merge(states_t)
    for key in ("min", "max"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]))
    np.testing.assert_allclose(MinMaxScaler().transform(states_t[0], _t(x)).numpy(),
                               np.asarray(JaxMinMax().transform(states_j[0], jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("D", [1, 4, 28])
def test_polynomial_features(degree, D):
    """out_dim and the expansion, column for column: x, the row-major upper
    triangle of x (x) x, then (degree 3) x**3 alone. At D = 28 that is
    434 columns (degree 2)."""
    x = np.random.RandomState(D).randn(9, D).astype(np.float32) * 2.0
    jp, tp = JaxPoly({"degree": degree}), PolynomialFeatures({"degree": degree})
    assert tp.out_dim(D) == jp.out_dim(D)
    if D == 28 and degree == 2:
        assert tp.out_dim(D) == 434
    out = tp.transform(tp.init(D), _t(x)).numpy()
    assert out.shape == (9, jp.out_dim(D))
    np.testing.assert_array_equal(out, np.asarray(jp.transform((), jnp.asarray(x))))


@pytest.mark.parametrize("preps", [
    [("MinMaxScaler", {})],
    [("PolynomialFeatures", {})],
    [("StandardScaler", {}), ("PolynomialFeatures", {"degree": 3}), ("MinMaxScaler", {})],
], ids=["minmax", "poly2", "chain"])
def test_pipeline_with_preprocessors(preps):
    """A PA pipeline behind each preprocessor (and a chain of three, the dim
    running through out_dim): the same weights and predictions after a few
    fits."""
    D = 5
    rng = np.random.RandomState(3)
    hp = {"C": 0.1}
    jpipe = JaxPipeline(JaxLearnerSpec("PA", hyper_parameters=hp),
                        [JaxPrepSpec(n, h) for n, h in preps], dim=D)
    tpipe = MLPipeline(LearnerSpec("PA", hyper_parameters=hp),
                       [PreprocessorSpec(n, h) for n, h in preps], dim=D, device="cpu")
    w = rng.randn(D)
    for _ in range(6):
        x = (rng.randn(24, D) * 2.0 + 1.0).astype(np.float32)
        y = (x @ w > 0).astype(np.float32)
        m = (rng.rand(24) > 0.2).astype(np.float32)
        jpipe.fit(x, y, m)
        tpipe.fit(x, y, m)
    np.testing.assert_allclose(tpipe.get_flat_params()[0], jpipe.get_flat_params()[0],
                               rtol=RTOL, atol=ATOL)
    x = rng.randn(30, D).astype(np.float32)
    np.testing.assert_array_equal(tpipe.predict(x).numpy(), np.asarray(jpipe.predict(x)))
