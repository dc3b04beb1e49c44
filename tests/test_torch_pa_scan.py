"""The port's PA scan (omldm_tpu_torch.ops.pa_scan) against the JAX Pallas
kernel run in interpret mode, on the same numpy inputs.

Tolerance: rtol=2e-4, atol=2e-5 on w and 1e-5 absolute on the loss -- the
tolerance tests/test_pallas_ops.py holds the Pallas kernel to; it allows for
float32 rounding carried through up to 256 dependent rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.ops.pa_scan import pa_scan_update as jax_pa_scan
from omldm_tpu_torch.ops import pa_scan

SHAPES = [(1, 3), (64, 7), (256, 29), (200, 130)]


def _inputs(B, D, masked, labels, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, D).astype(np.float32)
    x[:, -1] = 1.0  # the bias column the learner appends
    w0 = (rng.randn(D) * 0.1).astype(np.float32)
    if labels == "01":
        y = rng.randint(0, 2, B).astype(np.float32)
    else:
        y = rng.choice([-1.0, 1.0], B).astype(np.float32)
    mask = np.ones(B, np.float32)
    if masked:
        mask[rng.rand(B) < 0.2] = 0.0   # scattered zeros
        mask[-max(B // 8, 1):] = 0.0    # trailing zeros (a ragged batch)
    return w0, x, y, mask


@pytest.mark.parametrize("labels", ["01", "pm1"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C", [0.01, 0.5])
@pytest.mark.parametrize("variant", ["PA", "PA-I", "PA-II"])
@pytest.mark.parametrize("B,D", SHAPES)
def test_reference_matches_pallas_interpret(B, D, variant, C, masked, labels):
    w0, x, y, mask = _inputs(B, D, masked, labels, seed=B * 1000 + D)
    jw, jl = jax_pa_scan(
        jnp.asarray(w0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        variant=variant, C=C, interpret=True,
    )
    before = pa_scan.launches
    tw, tl = pa_scan.pa_scan_update(
        torch.from_numpy(w0), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(mask), variant=variant, C=C,
    )
    assert tw.dtype == torch.float32 and tw.shape == (D,)
    assert tl.shape == ()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-4, atol=2e-5)
    assert abs(float(tl) - float(jl)) <= 1e-5
    # the CPU path is the plain version: it never counts a kernel launch
    assert pa_scan.launches == before == 0


def test_all_masked_batch_is_a_no_op():
    w0, x, y, _ = _inputs(16, 5, False, "pm1", seed=3)
    tw, tl = pa_scan.pa_scan_update(
        torch.from_numpy(w0), torch.from_numpy(x), torch.from_numpy(y),
        torch.zeros(16),
    )
    np.testing.assert_array_equal(tw.numpy(), w0)
    assert float(tl) == 0.0


def test_unsupported_device_raises():
    t = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pa_scan.pa_scan_update(
            torch.zeros(3, device="meta"), t, torch.zeros(4, device="meta"),
            torch.zeros(4, device="meta"),
        )
