"""Attention: plain references, and flash attention with hand-written CUDA kernels.

Counterpart of ``omldm_tpu/ops/attention.py``, with the same contract
``[B, L, H, Dh] -> [B, L, H, Dh]``:

- ``mha_reference``        materialises the [Lq, Lk] scores; the tests' oracle.
- ``online_softmax_sweep`` / ``blockwise_attention``
                           flash-style online softmax over K/V blocks in
                           plain torch (the per-device loop ring attention
                           will reuse).
- ``flash_attention``      the forward kernel (``csrc/flash_attention.cu``)
                           on a CUDA tensor, its plain twin on a CPU tensor;
                           returns the per-row logsumexp too.
- ``flash_attention_bwd``  the dQ and dK/dV kernels on CUDA, their plain twin
                           (P recomputed from the lse block by block, as the
                           kernels do) on the CPU.
- ``FlashAttention``       the ``torch.autograd.Function`` pairing them (the
                           JAX package's ``_flash_diff`` custom VJP).
- ``attention``            the entry point the transformer calls.

The kernels take any head width from 1 up in float32 or bfloat16, and any
B * H: ``kernel_width`` gives the built width a head width runs at (the
wide instance past 256), ``KERNEL_DESIGNS`` which of the two CUDA designs
runs a (dtype, head width), and ``kernel_design`` which one runs a call's
views (a Hopper width whose views the tensor maps cannot take runs
mma.sync); ``sm90_tile_plan`` and ``tensor_map_geometry`` restate on the
host what the Hopper design's loops visit and which TMA tensor map it
encodes.

A CUDA tensor the kernels cannot take (dtype, layout) raises; nothing falls
back to the plain version. Every kernel launch counts in :data:`launches`,
and by design in :data:`design_launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from omldm_tpu_torch.ops._build import KernelLibrary

NEG_INF = -1e30

#: kernel launches by name (CUDA tensors only)
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkdv": 0}
#: the same launches by the design that ran them (``kernel_design``)
design_launches = {"sm90": 0, "mma": 0}

#: the widths instances are built at; a head width with none of its own runs
#: the next of them, zero-padded in shared memory (``kernel_width``)
KERNEL_WIDTHS = (32, 64, 128, 256)
#: the instance every head width past 256 runs: its tiles hold one column
#: chunk of a row (64 float32, 128 bf16) and it loops over the width
WIDE = "wide"


def kernel_width(dh: int):
    """The built width a head width runs at: the next of KERNEL_WIDTHS, or
    WIDE past 256."""
    if dh < 1:
        raise ValueError(f"head width {dh} is below 1")
    return next((w for w in KERNEL_WIDTHS if w >= dh), WIDE)


def _design(dtype: torch.dtype, dh: int) -> str:
    # bf16 rows of whole 16-byte groups fit the TMA boxes of the Hopper
    # instances at 64 and 128; everything else runs mma.sync
    if dtype == torch.bfloat16 and kernel_width(dh) in (64, 128) and dh % 8 == 0:
        return "sm90"
    return "mma"


#: which design runs all three passes (forward, dQ, dK/dV) for each (dtype,
#: head width) on views that are whole 16-byte groups, as ``run_dtype`` in
#: csrc/flash_attention.cu dispatches: "sm90" (TMA ring, warp-specialised
#: wgmma) or "mma" (mma.sync, synchronous copies, column chunks). Listed to
#: 512: every width past 256 runs the wide instance as 257..512 do.
KERNEL_DESIGNS = {(dtype, dh): _design(dtype, dh)
                  for dtype in (torch.bfloat16, torch.float32)
                  for dh in range(1, 2 * KERNEL_WIDTHS[-1] + 1)}


def _rows_of_16(t: torch.Tensor) -> bool:
    """rows_of_16 in csrc/flash_attention.cu: the base, the three outer
    strides and the width of a [B, L, H, Dh] view are whole 16-byte groups."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * size % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:3]))


def kernel_design(*views: torch.Tensor) -> str:
    """The design a call on these views runs, as ``run_dtype`` picks it:
    ``KERNEL_DESIGNS``' design for (dtype, head width), except that a Hopper
    width runs mma.sync at the same width where any view's rows are not
    whole 16-byte groups at 16-byte aligned addresses or a TMA tensor map
    would refuse it (``tensor_map_geometry``). The views are q, k, v and,
    for the backward passes, dout."""
    design = _design(views[0].dtype, views[0].shape[-1])
    if design == "sm90":
        for t in views:
            if not _rows_of_16(t):
                return "mma"
            try:
                tensor_map_geometry(t)
            except ValueError:
                return "mma"
    return design


#: tiles of the sm90 design: forward and dQ (query rows a CTA, keys a
#: tile), dK/dV (keys a CTA, query rows a tile); each CTA's two consumer
#: warpgroups take half of its rows (keys) each
SM90_FWD_TILE = (128, 128)
SM90_DQ_TILE = (128, 64)
SM90_DKDV_TILE = (128, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD, _DQ, _DKDV = 0, 1, 2


def _configure(lib: ctypes.CDLL) -> None:
    lib.omldm_flash_attention.argtypes = (
        [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_void_p] * 11
    )
    lib.omldm_flash_attention.restype = ctypes.c_int


LIBRARY = KernelLibrary("flash_attention.cu", _configure)


# ---------------------------------------------------------------------------
# plain references
# ---------------------------------------------------------------------------


def _allowed(lq: int, lk: int, causal: bool, q_offset: int, kv_offset: int,
             device) -> Optional[torch.Tensor]:
    """[Lq, Lk] bool: which (query, key) pairs the causal mask keeps."""
    if not causal:
        return None
    qi = q_offset + torch.arange(lq, device=device)[:, None]
    ki = kv_offset + torch.arange(lk, device=device)[None, :]
    return qi >= ki


def mha_reference(q, k, v, causal: bool = False, q_offset: int = 0,
                  kv_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention. q, k, v: [B, L, H, Dh]."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    keep = _allowed(q.shape[1], k.shape[1], causal, q_offset, kv_offset, q.device)
    if keep is not None:
        scores = scores.masked_fill(~keep, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def online_softmax_sweep(q32, k, v, carry, q_pos, kv_pos_start, causal=False,
                         block_k: int = 256):
    """Sweep ONE K/V chunk in key blocks, updating an online-softmax carry.

    q32: [B, Lq, H, Dh] float32; k/v: [B, Lk, H, Dh]; carry is
    ``(o [B,H,Lq,Dh], m [B,H,Lq], l [B,H,Lq])``; ``q_pos`` are absolute query
    positions [Lq] and ``kv_pos_start`` the absolute position of key row 0.
    Never materialises more than [.., Lq, block_k] scores."""
    lk, dh = k.shape[1], q32.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    o, m, l = carry
    for start in range(0, lk, block_k):
        kb = k[:, start:start + block_k].float()
        vb = v[:, start:start + block_k].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb) * scale
        if causal:
            ki = kv_pos_start + start + torch.arange(kb.shape[1], device=s.device)
            s = s.masked_fill(q_pos[:, None] < ki[None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # a row with every key masked so far must get zero weights
        p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m_new[..., None]))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        l = alpha * l + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    return o, m, l


def blockwise_attention(q, k, v, causal: bool = False, block_k: int = 256,
                        q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Flash-style attention in plain torch: online softmax over K/V blocks.
    q, k, v: [B, L, H, Dh] (Lk may differ from Lq)."""
    b, lq, h, dh = q.shape
    q32 = q.float()
    q_pos = q_offset + torch.arange(lq, device=q.device)
    o = torch.zeros((b, h, lq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    o, m, l = online_softmax_sweep(q32, k, v, (o, m, l), q_pos, kv_offset,
                                   causal=causal, block_k=block_k)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# plain twins of the kernels
# ---------------------------------------------------------------------------


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The twins' working type: float32, or float64 for float64 operands."""
    return t if t.dtype == torch.float64 else t.float()


def flash_attention_reference(q, k, v, causal: bool = False, q_offset: int = 0,
                              kv_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out [B, Lq, H, Dh] in q's dtype,
    lse [B*H, Lq, 1] float32). Scores and sums in float32 from the operands'
    own values (float64 for float64 operands: the exact answer a float32
    kernel is held to); P rounded to v's dtype before the P V product, as
    the kernel rounds it. Materialises the [Lq, Lk] scores of every head at
    once."""
    b, lq, h, dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) * (1.0 / math.sqrt(dh))
    keep = _allowed(lq, k.shape[1], causal, q_offset, kv_offset, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", _wide(p.to(v.dtype)), _wide(v)) / l
    lse = (m + torch.log(l)).reshape(b * h, lq, 1)
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, dout, lse, delta, causal: bool = False,
                                  q_offset: int = 0, kv_offset: int = 0,
                                  block_k: int = 128):
    """Plain version of the dQ and dK/dV kernels: P recomputed from the saved
    lse one key block at a time, ``dS = P (dP - delta)``, float32 sums
    (float64 for float64 operands), P and dS rounded to the operand dtype
    before their products. lse and delta:
    [B*H, Lq] (a trailing unit axis is accepted). Returns dq, dk, dv in
    [B, L, H, Dh] and the dtypes of q, k, v."""
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, dof = (_wide(t).transpose(1, 2) for t in (q, k, v, dout))  # [B,H,L,D]
    lse4 = lse.reshape(b, h, lq, 1).to(qf.dtype)
    delta4 = delta.reshape(b, h, lq, 1).to(qf.dtype)
    keep = _allowed(lq, lk, causal, q_offset, kv_offset, q.device)
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for k0 in range(0, lk, block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if keep is not None:
            s = s.masked_fill(~keep[:, k0:k0 + block_k], NEG_INF)
        p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse4))
        dv[:, :, k0:k0 + block_k] = _wide(p.to(dout.dtype)).transpose(-1, -2) @ dof
        ds = p * (dof @ vb.transpose(-1, -2) - delta4)
        dq += _wide(ds.to(k.dtype)) @ kb
        dk[:, :, k0:k0 + block_k] = (_wide(ds.to(q.dtype)).transpose(-1, -2) @ qf) * scale
    dq = dq * scale
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_kernel_inputs(fn: str, named) -> torch.dtype:
    """Raise unless every tensor is one the kernels take: one dtype of
    float32/bfloat16, on one device, [B, L, H, Dh] with Dh >= 1 and unit
    stride on Dh. Any such view runs: where the Hopper design cannot take it
    (``kernel_design``), mma.sync reads its rows (16 bytes at a time where
    they allow it)."""
    dtype = named[0][1].dtype
    device = named[0][1].device
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: dtype {dtype} is not float32 or bfloat16")
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype}, q is {dtype}")
        if t.dim() != 4:
            raise ValueError(f"{fn}: {name} must be [B, L, H, Dh], got {tuple(t.shape)}")
        if t.shape[-1] < 1:
            raise ValueError(f"{fn}: head width {t.shape[-1]} of {name} is below 1")
        if t.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} needs unit stride on Dh (strides {t.stride()})")
    return dtype


def tensor_map_geometry(t: torch.Tensor):
    """The TMA tensor map the sm90 design encodes for a [B, L, H, Dh] view:
    dimensions innermost first (Dh, H, L, B) and the byte strides of H, L
    and B. Raises where cuTensorMapEncodeTiled would refuse the map (a
    byte stride not a multiple of 16, or of 2^40 or more)."""
    b, l, h, dh = t.shape
    size = t.element_size()
    strides = tuple(s * size for s in (t.stride(2), t.stride(1), t.stride(0)))
    if t.stride(3) != 1 or any(s % 16 or s >= 1 << 40 for s in strides):
        raise ValueError(f"a TMA tensor map needs unit stride on Dh and byte strides that are "
                         f"multiples of 16 below 2^40, got {strides} bytes")
    return (dh, h, l, b), strides


def sm90_tile_plan(which: str, lq: int, lk: int, causal: bool, q_offset: int = 0,
                   kv_offset: int = 0):
    """The sm90 kernels' work for one (b, h) head, as their loops run it:
    the CTAs in launch order along the grid's slow axis, each as (its tile,
    [(tile of its sweep, (state of consumer 0, state of consumer 1)), ...]).
    ``which``: "fwd" or "dq" (CTAs over query tiles, sweeping key tiles;
    longest causal sweeps first) or "dkdv" (CTAs over key tiles, sweeping
    query tiles). A consumer's state on a tile: "skip" (its 64 rows or keys lie
    wholly on the masked side: it releases the tile untouched), "cut" (it
    applies the mask), "full" (no pair of it is masked: no mask)."""
    by_query = which in ("fwd", "dq")
    if by_query:
        outer, inner = SM90_FWD_TILE if which == "fwd" else SM90_DQ_TILE
        n_outer, n_inner = -(-lq // outer), -(-lk // inner)
    elif which == "dkdv":
        outer, inner = SM90_DKDV_TILE
        n_outer, n_inner = -(-lk // outer), -(-lq // inner)
    else:
        raise ValueError(f"sm90_tile_plan: which is 'fwd', 'dq' or 'dkdv', not {which!r}")
    half = outer // 2
    plan = []
    order = range(n_outer - 1, -1, -1) if by_query else range(n_outer)
    for o in order:
        if by_query:  # k_tiles_needed
            last = q_offset + o * outer + outer - 1 - kv_offset
            if not causal:
                span = range(n_inner)
            else:
                span = range(0 if last < 0 else min(n_inner, last // inner + 1))
        else:               # first_q_tile_needed
            x = kv_offset + o * outer - q_offset
            span = range(x // inner if causal and x > 0 else 0, n_inner)
        tiles = []
        for i in span:
            states = []
            for w in range(2):
                if by_query:
                    r0, k0 = o * outer + w * half, i * inner
                    skip = causal and q_offset + r0 + half - 1 < kv_offset + k0
                    cut = k0 + inner > lk or (causal and q_offset + r0 < kv_offset + k0 + inner - 1)
                else:
                    q0, kw0 = i * inner, o * outer + w * half
                    skip = causal and q_offset + q0 + inner - 1 < kv_offset + kw0
                    cut = q0 + inner > lq or (causal and q_offset + q0 < kv_offset + kw0 + half - 1)
                states.append("skip" if skip else "cut" if cut else "full")
            tiles.append((i, tuple(states)))
        plan.append((o, tiles))
    return plan


def _launch(which, dtype, q, k, v, causal, q_offset, kv_offset, dout=None,
            out=None, dq=None, dk=None, dv=None, lse=None, delta=None):
    b, lq, h, dh = q.shape
    lk = k.shape[1]
    lib = LIBRARY.load()
    do = dout if dout is not None else q
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.omldm_flash_attention(
            which, _DTYPE_CODES[dtype], dh, b, h, lq, lk, int(causal),
            int(q_offset), int(kv_offset), 1.0 / math.sqrt(dh), strides,
            ptr(q), ptr(k), ptr(v), ptr(dout), ptr(out), ptr(dq), ptr(dk),
            ptr(dv), ptr(lse), ptr(delta), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel {which} launch failed: CUDA error {rc}")
    design_launches[kernel_design(q, k, v, *(() if dout is None else (dout,)))] += 1


def _check_device(fn: str, q: torch.Tensor) -> bool:
    """True for CUDA (kernels), False for the CPU (plain twins); raises else."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    return True


def flash_attention(q, k, v, causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0, return_lse: bool = False):
    """Flash attention forward. q: [B, Lq, H, Dh], k/v: [B, Lk, H, Dh] ->
    out [B, Lq, H, Dh] (q's dtype) and, with ``return_lse``, the per-row
    logsumexp [B*H, Lq, 1] float32. CUDA tensors run the forward kernel, CPU
    tensors :func:`flash_attention_reference`."""
    if not _check_device("flash_attention", q):
        out, lse = flash_attention_reference(q, k, v, causal, q_offset, kv_offset)
        return (out, lse) if return_lse else out
    dtype = _check_kernel_inputs("flash_attention", [("q", q), ("k", k), ("v", v)])
    b, lq, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    out = torch.empty((b, lq, h, dh), dtype=dtype, device=q.device)
    lse = torch.empty((b * h, lq, 1), dtype=torch.float32, device=q.device)
    _launch(_FWD, dtype, q, k, v, causal, q_offset, kv_offset, out=out, lse=lse)
    launches["flash_fwd"] += 1
    return (out, lse) if return_lse else out


def _check_bwd_inputs(fn, q, k, v, dout, lse, delta) -> torch.dtype:
    dtype = _check_kernel_inputs(fn, [("q", q), ("k", k), ("v", v), ("dout", dout)])
    b, lq, h, _ = q.shape
    if dout.shape != q.shape or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, dout {tuple(dout.shape)} do not fit")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.numel() != b * h * lq \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be contiguous float32 [B*H, Lq] on {q.device}")
    return dtype


def flash_attention_dq(q, k, v, dout, lse, delta, causal: bool = False,
                       q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """The dQ kernel (CUDA tensors only); see :func:`flash_attention_bwd`."""
    dtype = _check_bwd_inputs("flash_attention_dq", q, k, v, dout, lse, delta)
    dq = torch.empty(q.shape, dtype=dtype, device=q.device)
    _launch(_DQ, dtype, q, k, v, causal, q_offset, kv_offset, dout=dout, dq=dq,
            lse=lse, delta=delta)
    launches["flash_dq"] += 1
    return dq


def flash_attention_dkdv(q, k, v, dout, lse, delta, causal: bool = False,
                         q_offset: int = 0, kv_offset: int = 0):
    """The dK/dV kernel (CUDA tensors only); see :func:`flash_attention_bwd`."""
    dtype = _check_bwd_inputs("flash_attention_dkdv", q, k, v, dout, lse, delta)
    dk = torch.empty(k.shape, dtype=dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=dtype, device=q.device)
    _launch(_DKDV, dtype, q, k, v, causal, q_offset, kv_offset, dout=dout, dk=dk,
            dv=dv, lse=lse, delta=delta)
    launches["flash_dkdv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, dout, lse, delta, causal: bool = False,
                        q_offset: int = 0, kv_offset: int = 0):
    """Flash attention backward: (dq, dk, dv) from the forward's inputs, the
    output cotangent ``dout`` [B, Lq, H, Dh], its ``lse`` and
    ``delta = rowsum(dout * out)``, both float32 [B*H, Lq] (or [B*H, Lq, 1]).
    CUDA tensors run the dQ and dK/dV kernels, CPU tensors
    :func:`flash_attention_bwd_reference`."""
    if not _check_device("flash_attention_bwd", q):
        return flash_attention_bwd_reference(q, k, v, dout, lse, delta, causal,
                                             q_offset, kv_offset)
    dq = flash_attention_dq(q, k, v, dout, lse, delta, causal, q_offset, kv_offset)
    dk, dv = flash_attention_dkdv(q, k, v, dout, lse, delta, causal, q_offset, kv_offset)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, and the dQ and
    dK/dV kernels recomputing P from the saved logsumexp (the JAX package's
    ``_flash_diff``). On CPU tensors the plain twins stand in for both."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, kv_offset: int):
        out, lse = flash_attention(q, k, v, causal, q_offset, kv_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, q_offset, kv_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()  # autograd may hand over an expanded or strided cotangent
        b, lq, h, _ = q.shape
        # delta_i = rowsum(dO * O), in plain torch as the JAX package does
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, lq)
        dq, dk, dv = flash_attention_bwd(q, k, v, g, lse, delta, *ctx.mask)
        return dq, dk, dv, None, None, None


def attention(q, k, v, causal: bool = False, q_offset: int = 0,
              kv_offset: int = 0) -> torch.Tensor:
    """The transformer's attention: :class:`FlashAttention` -- the kernels on
    CUDA tensors, their plain twins on CPU tensors."""
    return FlashAttention.apply(q, k, v, causal, q_offset, kv_offset)
