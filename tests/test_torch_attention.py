"""The port's attention (omldm_tpu_torch.ops.attention) against the JAX
package on the same numpy inputs.

The kernels' plain twins (what the wrappers run on CPU tensors) are held to
the Pallas kernels run in interpret mode: the forward's out and lse against
``flash_attention_pallas(..., interpret=True, return_lse=True)``, and the
gradients through ``FlashAttention`` against ``jax.vjp`` of ``_flash_diff``
(the Pallas dQ and dK/dV kernels). Everything is float32.

Tolerances: out and grads atol 1e-5 (met: <= 5e-7), lse atol 1e-5 (met:
<= 5e-7) -- float32 sums taken in another order. The bfloat16 forward is
compared in its working type: atol 1e-2, one or two bf16 ulps at |out| ~ 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.ops import attention as jatt
from omldm_tpu_torch.ops import attention as tatt

# (B, Lq, Lk, H, Dh, q_offset, kv_offset): square, ragged Lq != Lk, a query
# offset, and a key offset that leaves the first 16 query rows seeing no key
CASES = [
    (2, 48, 48, 2, 16, 0, 0),
    (1, 40, 72, 2, 16, 0, 0),
    (1, 40, 72, 2, 16, 32, 0),
    (1, 40, 40, 2, 16, 0, 16),
]
IDS = ["square", "ragged", "q_offset32", "masked_rows"]


def _inputs(b, lq, lk, h, dh, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, lq, h, dh) * 0.3).astype(np.float32)
    k = (rng.randn(b, lk, h, dh) * 0.3).astype(np.float32)
    v = (rng.randn(b, lk, h, dh) * 0.3).astype(np.float32)
    g = rng.randn(b, lq, h, dh).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_pallas_interpret(case, causal):
    b, lq, lk, h, dh, qo, ko = case
    q, k, v, _ = _inputs(b, lq, lk, h, dh, seed=lq + lk)
    jo, jl = jatt.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=qo, kv_offset=ko, block_q=16, block_k=16, interpret=True,
        return_lse=True,
    )
    before = dict(tatt.launches)
    to, tl = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, qo, ko, return_lse=True)
    assert to.shape == (b, lq, h, dh) and tl.shape == (b * h, lq, 1)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :lq], atol=1e-5, rtol=1e-6)
    # the CPU path is the plain twin: it never counts a kernel launch
    assert tatt.launches == before


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grads_match_pallas_backward(case, causal):
    b, lq, lk, h, dh, qo, ko = case
    q, k, v, g = _inputs(b, lq, lk, h, dh, seed=7 * lq + lk)
    _, vjp = jax.vjp(
        lambda q, k, v: jatt._flash_diff(q, k, v, causal, qo, ko, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tatt.attention(tq, tk, tv, causal, qo, ko).backward(torch.from_numpy(g))
    for jg, t in zip(jgrads, (tq, tk, tv)):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-5)


def test_fully_masked_rows_are_zero_with_zero_grads():
    """Query rows that see no key (kv_offset past them): zero output, an lse
    near NEG_INF, and finite zero gradients -- in both packages."""
    q, k, v, g = _inputs(1, 40, 40, 2, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out, lse = tatt.flash_attention(tq, tk, tv, True, 0, 16, return_lse=True)
    assert float(out.detach()[:, :16].abs().max()) == 0.0
    assert float(lse.detach().reshape(2, 40)[:, :16].max()) < tatt.NEG_INF / 2
    tatt.attention(tq, tk, tv, True, 0, 16).backward(torch.from_numpy(g))
    assert torch.isfinite(tq.grad).all()
    assert float(tq.grad[:, :16].abs().max()) == 0.0
    _, vjp = jax.vjp(lambda q: jatt._flash_diff(q, jnp.asarray(k), jnp.asarray(v),
                                                True, 0, 16, True), jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0])[:, :16], 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_bfloat16_forward_in_working_type(causal):
    q, k, v, _ = _inputs(1, 64, 64, 2, 32, seed=11)
    jo = jatt.flash_attention_pallas(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=causal, interpret=True,
    )
    to = tatt.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), atol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_references_match_jax(causal):
    """mha_reference, blockwise_attention (ragged final block) and the
    online-softmax sweep with offsets, against their JAX counterparts."""
    q, k, v, _ = _inputs(2, 32, 32, 2, 8, seed=5)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    np.testing.assert_allclose(tatt.mha_reference(tq, tk, tv, causal).numpy(),
                               np.asarray(jatt.mha_reference(jq, jk, jv, causal)), atol=1e-5)
    np.testing.assert_allclose(
        tatt.blockwise_attention(tq, tk, tv, causal, block_k=12).numpy(),
        np.asarray(jatt.blockwise_attention(jq, jk, jv, causal, block_k=12)), atol=1e-5)
    np.testing.assert_allclose(
        tatt.blockwise_attention(tq[:, 16:], tk, tv, causal, block_k=8, q_offset=16).numpy(),
        np.asarray(jatt.mha_reference(jq, jk, jv, causal))[:, 16:], atol=1e-5)


def test_bwd_twin_accepts_both_lse_layouts():
    q, k, v, g = _inputs(1, 24, 24, 2, 16, seed=9)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = tatt.flash_attention(tq, tk, tv, True, return_lse=True)
    delta = (tg * out).sum(-1).transpose(1, 2).reshape(2, 24)
    a = tatt.flash_attention_bwd(tq, tk, tv, tg, lse, delta, True)
    b = tatt.flash_attention_bwd(tq, tk, tv, tg, lse.reshape(2, 24), delta[..., None], True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_unsupported_device_raises():
    t = torch.zeros((1, 8, 1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.flash_attention_bwd(t, t, t, t, t, t)


def _bad(kind):
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    if kind == "dtype":
        return [("q", q.half())], "float32 or bfloat16"
    if kind == "mixed":
        return [("q", q), ("k", q.float())], "is torch.float32"
    if kind == "head_width":  # every width from 1 up runs; an empty head does not
        return [("q", torch.zeros((1, 8, 2, 0), dtype=torch.bfloat16))], "head width 0"
    if kind == "f32_128":  # float32 at 128 now runs; float16 at 128 does not
        return [("q", torch.zeros((1, 8, 2, 128), dtype=torch.float16))], "float32 or bfloat16"
    if kind == "rank":
        return [("q", q[0])], r"\[B, L, H, Dh\]"
    if kind == "stride":
        return [("q", q.transpose(2, 3).contiguous().transpose(2, 3))], "unit stride"
    return [("q", q), ("k", torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device="meta"))], \
        "on meta, q on cpu"


@pytest.mark.parametrize("kind", ["dtype", "mixed", "head_width", "f32_128", "rank", "stride",
                                  "device"])
def test_kernel_input_checks_refuse(kind):
    """What the CUDA wrappers refuse before a launch (checked here on CPU
    tensors: the checks read only dtype, shape, strides and alignment)."""
    named, match = _bad(kind)
    with pytest.raises(ValueError, match=match):
        tatt._check_kernel_inputs("flash_attention", named)


def test_kernel_input_checks_take_strided_qkv_views():
    qkv = torch.zeros((2, 16, 3, 4, 128), dtype=torch.bfloat16)
    named = [("q", qkv[:, :, 0]), ("k", qkv[:, :, 1]), ("v", qkv[:, :, 2])]
    assert tatt._check_kernel_inputs("flash_attention", named) == torch.bfloat16


@pytest.mark.parametrize("bad", ["dout", "kv", "lse", "delta_dtype"])
def test_backward_input_checks_refuse(bad):
    q = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    k = v = dout = q
    lse = delta = torch.zeros((2, 16))
    if bad == "dout":
        dout = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    elif bad == "kv":
        v = torch.zeros((1, 24, 2, 64), dtype=torch.bfloat16)
    elif bad == "lse":
        lse = torch.zeros((2, 8))
    else:
        delta = torch.zeros((2, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="do not fit|contiguous float32"):
        tatt._check_bwd_inputs("flash_attention_bwd", q, k, v, dout, lse, delta)


# head widths off the built instances (32, 64, 128, 256): the JAX tests'
# width 8, rows that are not whole 16-byte groups in bf16 (12), a width
# padded into the Hopper instance at 128 (80) and the widest (256)
PADDED_DH = [8, 12, 80, 256]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", PADDED_DH)
def test_forward_matches_pallas_interpret_at_padded_widths(dh, causal):
    """The plain twins take any width, as the JAX kernel tiles the whole
    dh: out and lse at atol 1e-5 (float32)."""
    q, k, v, _ = _inputs(1, 40, 48, 2, dh, seed=dh)
    jo, jl = jatt.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=16,
        block_k=16, interpret=True, return_lse=True)
    to, tl = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :40], atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", PADDED_DH)
def test_grads_match_pallas_backward_at_padded_widths(dh, causal):
    """Gradients through FlashAttention against jax.vjp of the Pallas dQ
    and dK/dV kernels at atol 1e-5 (float32)."""
    q, k, v, g = _inputs(1, 40, 40, 2, dh, seed=3 * dh)
    _, vjp = jax.vjp(lambda q, k, v: jatt._flash_diff(q, k, v, causal, 0, 0, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tatt.attention(tq, tk, tv, causal).backward(torch.from_numpy(g))
    for jg, t in zip(jgrads, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-5)


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 8), (torch.bfloat16, 12),
                                      (torch.bfloat16, 80), (torch.bfloat16, 256),
                                      (torch.float32, 128), (torch.float32, 12),
                                      (torch.float32, 256)])
def test_kernel_input_checks_take_every_width_to_256(dtype, dh):
    """Widths the kernels used to refuse now pass the checks, contiguous
    and as strided views into a packed projection."""
    q = torch.zeros((2, 16, 4, dh), dtype=dtype)
    assert tatt._check_kernel_inputs("flash_attention", [("q", q), ("k", q), ("v", q)]) == dtype
    qkv = torch.zeros((2, 16, 3, 4, dh), dtype=dtype)
    named = [("q", qkv[:, :, 0]), ("k", qkv[:, :, 1]), ("v", qkv[:, :, 2])]
    assert tatt._check_kernel_inputs("flash_attention", named) == dtype


def test_kernel_widths_and_designs():
    """Every width 1..256 runs the next built instance and every wider one
    the cluster design (the WIDE class); bf16 rows of whole 16-byte groups
    inside 33..128 take the Hopper design, the rest up to 256 mma.sync."""
    assert [tatt.kernel_width(d) for d in (1, 8, 32, 33, 64, 65, 80, 128, 129, 256)] == \
        [32, 32, 32, 64, 64, 128, 128, 128, 256, 256]
    assert [tatt.kernel_width(d) for d in (257, 320, 512, 1000)] == [tatt.WIDE] * 4
    with pytest.raises(ValueError, match="head width"):
        tatt.kernel_width(0)
    designs = tatt.KERNEL_DESIGNS
    assert len(designs) == 2 * 512
    assert {dh for (dt, dh), d in designs.items() if d == "sm90"} == set(range(40, 129, 8))
    assert all(d == "mma" for (dt, dh), d in designs.items() if dt == torch.float32 and dh <= 256)
    assert all(d == "cluster" for (_, dh), d in designs.items() if dh > 256)
    assert designs[(torch.bfloat16, 12)] == designs[(torch.bfloat16, 36)] == "mma"


def test_sm90_widths_still_need_aligned_rows():
    """A padded width on the Hopper design (bf16 80) whose view is 2 bytes
    off 16-byte alignment passes the checks and runs mma.sync at the same
    width; the aligned view runs the Hopper design. A width on mma.sync
    (bf16 12) reads rows at any 2-byte offset."""
    off = torch.zeros(1 * 9 * 2 * 80 + 1, dtype=torch.bfloat16)[1:].view(1, 9, 2, 80)
    assert tatt._check_kernel_inputs("flash_attention", [("q", off)]) == torch.bfloat16
    assert tatt.kernel_design(off, off, off) == "mma"
    assert tatt.kernel_width(80) == 128
    aligned = torch.zeros((1, 9, 2, 80), dtype=torch.bfloat16)
    assert tatt.kernel_design(aligned, aligned, aligned) == "sm90"
    # one view of four off alignment (dout, in the backward) takes mma.sync
    assert tatt.kernel_design(aligned, aligned, aligned, off) == "mma"
    # a row stride that is not whole 16-byte groups: mma.sync too
    odd = torch.zeros((1, 9, 2, 84), dtype=torch.bfloat16)[..., :80]
    assert tatt.kernel_design(odd, aligned, aligned) == "mma"
    off12 = torch.zeros(1 * 9 * 2 * 12 + 1, dtype=torch.bfloat16)[1:].view(1, 9, 2, 12)
    assert tatt._check_kernel_inputs("flash_attention", [("q", off12)]) == torch.bfloat16
    assert tatt.kernel_design(off12, off12, off12) == "mma"


# head widths past the widest built instance: the cluster design's
# 128-column slices with a ragged last slice (320) and without (512)
WIDE_DH = [320, 512]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", WIDE_DH)
def test_forward_matches_pallas_interpret_at_wide_widths(dh, causal):
    """float32: out and lse at atol 1e-5, as at the built widths."""
    q, k, v, _ = _inputs(1, 40, 48, 2, dh, seed=dh)
    jo, jl = jatt.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_q=16,
        block_k=16, interpret=True, return_lse=True)
    to, tl = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :40], atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", WIDE_DH)
def test_grads_match_pallas_backward_at_wide_widths(dh, causal):
    """float32 gradients through FlashAttention against jax.vjp of the
    Pallas dQ and dK/dV kernels at atol 1e-5."""
    q, k, v, g = _inputs(1, 40, 40, 2, dh, seed=3 * dh)
    _, vjp = jax.vjp(lambda q, k, v: jatt._flash_diff(q, k, v, causal, 0, 0, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tatt.attention(tq, tk, tv, causal).backward(torch.from_numpy(g))
    for jg, t in zip(jgrads, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-5)


# the offsets of phase 43's two newest wide cases on the card, at this
# size: a query offset (bf16 dh 300 there) and a key offset that leaves the
# first 12 query rows seeing no key and the last 12 keys seen by no query
# (float32 dh 1100, past the cluster's reach of 8 slices of 128)
WIDE_OFFSETS = [(300, 12, 0), (1100, 0, 12)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh,qo,ko", WIDE_OFFSETS, ids=["dh300_q_offset", "dh1100_kv_offset"])
def test_forward_matches_pallas_interpret_at_wide_offsets(dh, qo, ko, causal):
    """float32 out and lse at a width past 256 with a query or key offset,
    against the Pallas forward in interpret mode at atol 1e-5, as at the
    other wide widths; rows that see no key get exactly zero output and an
    lse at or below NEG_INF / 2."""
    q, k, v, _ = _inputs(1, 40, 40, 2, dh, seed=11 * dh)
    jo, jl = jatt.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, q_offset=qo,
        kv_offset=ko, block_q=16, block_k=16, interpret=True, return_lse=True)
    to, tl = tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal, qo, ko, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :40], atol=1e-5, rtol=1e-6)
    if causal and ko > qo:
        assert to[:, :ko - qo].abs().max().item() == 0.0
        assert tl.reshape(2, 40)[:, :ko - qo].max().item() <= tatt.NEG_INF / 2

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh,qo,ko", WIDE_OFFSETS, ids=["dh300_q_offset", "dh1100_kv_offset"])
def test_grads_match_pallas_backward_at_wide_offsets(dh, qo, ko, causal):
    """float32 gradients through FlashAttention at a width past 256 with a
    query or key offset, against jax.vjp of the Pallas dQ and dK/dV
    kernels at atol 1e-5; rows that see no key get zero dQ."""
    q, k, v, g = _inputs(1, 40, 40, 2, dh, seed=7 * dh)
    _, vjp = jax.vjp(lambda q, k, v: jatt._flash_diff(q, k, v, causal, qo, ko, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tatt.attention(tq, tk, tv, causal, qo, ko).backward(torch.from_numpy(g))
    for jg, t in zip(jgrads, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-5)
    if causal and ko > qo:
        assert tq.grad[:, :ko - qo].abs().max().item() == 0.0
        assert tk.grad[:, -(ko - qo):].abs().max().item() == 0.0


def _bf16(a):
    """numpy float32 rounded to bf16 and back, so both packages start from
    the same bf16 values."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", WIDE_DH)
def test_bfloat16_at_wide_widths_in_working_type(dh, causal):
    """bf16 forward and gradients against the Pallas kernels in interpret
    mode on the same bf16 inputs, compared in the working type: out atol
    1e-2 (one or two bf16 ulps at |out| ~ 1, as the bf16 forward above;
    met: 9.8e-4); gradients within one bf16 ulp of their largest element,
    4e-3 of it (met: 3.3e-7 of it) -- both sides round P and dS to bf16
    before their products, from float32 sums taken in another order."""
    q, k, v, g = (_bf16(a) for a in _inputs(1, 40, 40, 2, dh, seed=5 * dh))
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    jo = jatt.flash_attention_pallas(jq, jk, jv, causal=causal, block_q=16, block_k=16,
                                     interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: jatt._flash_diff(q, k, v, causal, 0, 0, True), jq, jk, jv)
    jgrads = vjp(jg)
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v))
    to = tatt.attention(tq, tk, tv, causal)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.detach().float().numpy(), np.asarray(jo, np.float32),
                               atol=1e-2)
    to.backward(torch.from_numpy(g).bfloat16())
    for jgrad, t in zip(jgrads, (tq, tk, tv)):
        ref = np.asarray(jgrad, np.float32)
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), ref,
                                   atol=4e-3 * float(np.abs(ref).max()))
