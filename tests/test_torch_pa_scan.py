"""The port's PA scan (omldm_tpu_torch.ops.pa_scan) against the JAX Pallas
kernel run in interpret mode, on the same numpy inputs.

Tolerance: rtol=2e-4, atol=2e-5 on w and 1e-5 absolute on the loss -- the
tolerance tests/test_pallas_ops.py holds the Pallas kernel to; it allows for
float32 rounding carried through up to 256 dependent rows.

The CUDA kernel (csrc/pa_scan.cu) runs a Gram-form chain whose margins
round in another order than a dot on the current weights. Its
float32 twin below (:func:`_pa_scan_gram`, test-only) is held to the Pallas
kernel at the same tolerance, so the rounding order itself is checked on
the CPU; the card holds the kernel to ``pa_scan_reference``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.ops.pa_scan import pa_scan_update as jax_pa_scan
from omldm_tpu_torch.ops import pa_scan

SHAPES = [(1, 3), (64, 7), (256, 29), (200, 130)]
W_RTOL, W_ATOL, LOSS_ATOL = 2e-4, 2e-5, 1e-5
GRAM_BLOCK = 32  # rows a block of the kernel's chain (kRows in csrc/pa_scan.cu)


def _pa_scan_gram(w, x, y, mask, variant="PA-I", C=0.01, block=GRAM_BLOCK, segments=8):
    """Float32 twin of the kernel's Gram-form scan, in its order of sums:
    G = X X^T and base = X w0; per block of rows from t0, margin_i =
    (base_i + the terms of blocks before the previous one, block by block)
    + (the previous block's terms) + this block's terms one row at a time;
    tau from the precomputed 1 / sq (PA-II: 1 / (sq + 1/2C)); then
    w = w0 + the sums of X^T c over ``segments`` row segments, in order."""
    w0 = w.to(torch.float32)
    x, mask = x.to(torch.float32), mask.to(torch.float32)
    n = x.shape[0]
    ys = torch.where(y > 0, 1.0, -1.0).to(torch.float32)
    cap = C if variant == "PA-I" else float("inf")
    g = x @ x.T
    msm = x @ w0
    sq = torch.clamp(torch.diagonal(g), min=1e-12)
    inv = 1.0 / (sq + 1.0 / (2.0 * C)) if variant not in ("PA", "PA-I") else 1.0 / sq
    coef = torch.zeros(n, dtype=torch.float32)
    carry = torch.zeros(block, dtype=torch.float32)
    hsum = torch.zeros((), dtype=torch.float32)
    for t0 in range(0, n, block):
        rows = slice(t0, min(n, t0 + block))
        nxt = slice(t0 + block, max(t0 + block, min(n, t0 + 2 * block)))
        margin = msm[rows] + carry[:rows.stop - t0]
        carry = torch.zeros(block, dtype=torch.float32)
        for r in range(rows.stop - t0):
            i = t0 + r
            hinge = torch.clamp(1.0 - ys[i] * margin[r], min=0.0)
            coef[i] = torch.clamp(hinge * inv[i], max=cap) * ys[i] * mask[i]
            hsum = hsum + hinge * mask[i]
            margin = margin + coef[i] * g[i, rows]
            carry[:nxt.stop - nxt.start] += coef[i] * g[i, nxt]
        later = slice(t0 + 2 * block, n)  # the blocks after the next: the helper warps' mat-vec
        for i in range(t0, rows.stop):
            msm[later] = msm[later] + coef[i] * g[i, later]
    per = -(-n // segments)
    parts = [coef[s:s + per] @ x[s:s + per] for s in range(0, n, per)] if n else []
    w = w0.clone()
    for part in parts:
        w = w + part
    return w, hsum / torch.clamp(mask.sum(), min=1.0)


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


@pytest.mark.parametrize("labels", ["01", "pm1"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C", [0.01, 0.5])
@pytest.mark.parametrize("variant", ["PA", "PA-I", "PA-II"])
@pytest.mark.parametrize("B,D", SHAPES)
def test_gram_twin_matches_pallas_interpret(B, D, variant, C, masked, labels):
    w0, x, y, mask = _inputs(B, D, masked, labels, seed=B * 1000 + D)
    jw, jl = jax_pa_scan(
        jnp.asarray(w0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        variant=variant, C=C, interpret=True,
    )
    gw, gl = _pa_scan_gram(torch.from_numpy(w0), torch.from_numpy(x), torch.from_numpy(y),
                           torch.from_numpy(mask), variant, C)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), rtol=W_RTOL, atol=W_ATOL)
    assert abs(float(gl) - float(jl)) <= LOSS_ATOL


def test_gram_twin_ill_conditioned():
    """Nearly parallel rows of norm ~1000 with random labels: every Gram
    term is ~1e6 and the margins cancel across them, and almost every row is
    hinge-active (mean hinge ~1.76), so every row adds terms to the chain.
    PA, uncapped. Readings (printed): max|dw| 1.043e-07, 2.0e-3 of the
    limit, |dloss| 1.19e-07 -- the per-row reference reads 5.96e-08 and
    5.96e-07 against the same Pallas result."""
    rng = np.random.RandomState(11)
    B, D = 256, 29
    u = rng.randn(D).astype(np.float32)
    u /= np.linalg.norm(u)
    x = (1000.0 * (u + 1e-3 * rng.randn(B, D))).astype(np.float32)
    x[:, -1] = 1.0
    w0 = (rng.randn(D) * 0.1).astype(np.float32)
    y = rng.choice([-1.0, 1.0], B).astype(np.float32)
    mask = np.ones(B, np.float32)
    jw, jl = jax_pa_scan(jnp.asarray(w0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                         variant="PA", C=0.5, interpret=True)
    tw = torch.from_numpy(w0)
    gw, gl = _pa_scan_gram(tw, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask),
                           "PA", 0.5)
    # almost every row is hinge-active under the reference's own pass
    _, ref_loss = pa_scan.pa_scan_reference(tw, torch.from_numpy(x), torch.from_numpy(y),
                                            torch.from_numpy(mask), "PA", 0.5)
    assert float(ref_loss) > 1.0
    jw = np.asarray(jw)
    err = np.abs(gw.numpy() - jw)
    print(f"ill-conditioned Gram twin vs Pallas: max|dw| {err.max():.3e}, "
          f"max|dw|/(atol + rtol|w|) {(err / (W_ATOL + W_RTOL * np.abs(jw))).max():.3e}, "
          f"|dloss| {abs(float(gl) - float(jl)):.3e}")
    np.testing.assert_allclose(gw.numpy(), jw, rtol=W_RTOL, atol=W_ATOL)
    assert abs(float(gl) - float(jl)) <= LOSS_ATOL


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


def test_kernel_refuses_rows_not_width():
    """The kernel takes any D but a bounded B; the refusal names rows."""
    x = torch.zeros((33, 70_000))
    w, y, m = torch.zeros(70_000), torch.zeros(33), torch.ones(33)
    assert pa_scan._validate(w, x[:32], y[:32], m[:32], max_rows=32) == (32, 70_000)
    with pytest.raises(ValueError, match=r"B=33 exceeds .*\(32 rows\)"):
        pa_scan._validate(w, x, y, m, max_rows=32)


def test_row_limit_matches_the_source():
    """omldm_pa_scan_max_rows() as the source computes it: the chain's shared
    memory (kSmemLimit bytes) less its fixed part, two floats a row, rounded
    down to a block -- the 26,944 rows the wrapper's docstring states."""
    import re
    from pathlib import Path

    src = (Path(pa_scan.__file__).resolve().parent.parent / "csrc" / "pa_scan.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))  # noqa: E731
    rows, limit = const("kRows"), const("kSmemLimit")
    assert rows == GRAM_BLOCK
    assert "constexpr int kChainFixed = 4 * kRows * kRows + 4 * kRows;" in src
    fixed = 4 * rows * rows + 4 * rows
    assert (limit // 4 - fixed) // 2 // rows * rows == 26_944
    assert "26,944" in pa_scan.pa_scan_update.__doc__
