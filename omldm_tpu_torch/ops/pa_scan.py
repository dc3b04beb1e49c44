"""Fused per-record Passive-Aggressive scan: CUDA kernel + plain version.

Counterpart of ``omldm_tpu/ops/pa_scan.py`` (the Pallas ``_pa_kernel``).
The exact per-record PA update is sequential: each row's margin depends on
the weights the previous row left. The kernel (``csrc/pa_scan.cu``) runs it
in Gram form -- margin_i = x_i . w0 + sum_{k<i} c_k (x_k . x_i) -- as three
launches on the stream: the Gram matrix and x . w0 over many CTAs, the
chain of scalar coefficients in one CTA, then w = w0 + X^T c; see the
source for its design and what bounds it.

``pa_scan_update`` launches the kernel for CUDA tensors and runs
``pa_scan_reference`` -- the same function as a Python loop over rows --
for CPU tensors. There is no fallback from one to the other: a CUDA tensor
the kernel cannot take raises.

``pa_scan_update_batched`` runs C independent scans (the members of a
cohort, the workers of a data-parallel fleet) in one launch sequence: the
member index is the kernels' grid y axis and every member's chain gets a
CTA of its own. ``pa_scan_op`` is ``pa_scan_update`` registered as a
``torch.library`` custom op whose vmap rule calls the batched entry, so
``torch.func.vmap`` of a member's fit launches the kernel once for all
members, as ``jax.vmap`` batches the JAX package's ``pallas_call`` into
one call with a member grid axis.

The kernel is built with ``nvcc`` on first use, from the sources in the
checkout, and bound with ``ctypes`` (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from omldm_tpu_torch.ops._build import KernelLibrary

_VARIANTS = {"PA": 0, "PA-I": 1}  # anything else is PA-II, as in the JAX kernel

#: kernel launches made by :func:`pa_scan_update` (CUDA tensors only)
launches = 0
#: kernel launches made by :func:`pa_scan_update_batched` (CUDA tensors only)
batched_launches = 0
#: device scratch, in floats, that one batched launch may take (4 GiB):
#: members past it run as further launches (:func:`member_groups`)
SCRATCH_BUDGET_FLOATS = 1 << 30


def _configure(lib: ctypes.CDLL) -> None:
    lib.omldm_pa_scan.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.omldm_pa_scan.restype = ctypes.c_int
    lib.omldm_pa_scan_batched.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.omldm_pa_scan_batched.restype = ctypes.c_int
    lib.omldm_pa_scan_max_rows.argtypes = []
    lib.omldm_pa_scan_max_rows.restype = ctypes.c_int
    lib.omldm_pa_scan_scratch_floats.argtypes = [ctypes.c_int]
    lib.omldm_pa_scan_scratch_floats.restype = ctypes.c_longlong


#: the kernel library, built from the checkout's source on first use; its
#: ``build_seconds`` and ``build_log`` hold nvcc's time and report
LIBRARY = KernelLibrary("pa_scan.cu", _configure)


def pa_scan_reference(
    w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
    variant: str = "PA-I", C: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same sequential pass, one row at a time.

    w[D], x[B, D], y[B], mask[B] -> (new_w[D], mean masked hinge)."""
    w = w.to(torch.float32).clone()
    x = x.to(torch.float32)
    mask = mask.to(torch.float32)
    ys = torch.where(y > 0, 1.0, -1.0).to(torch.float32)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        xi = x[i]
        hinge = torch.clamp(1.0 - ys[i] * torch.dot(w, xi), min=0.0)
        sq = torch.clamp(torch.dot(xi, xi), min=1e-12)
        if variant == "PA":
            tau = hinge / sq
        elif variant == "PA-I":
            tau = torch.clamp(hinge / sq, max=C)
        else:
            tau = hinge / (sq + 1.0 / (2.0 * C))
        w = w + (tau * ys[i] * mask[i]) * xi
        acc = acc + hinge * mask[i]
    return w, acc / torch.clamp(mask.sum(), min=1.0)


def _validate(w, x, y, mask, name: str = "pa_scan_update") -> Tuple[int, ...]:
    """The shape of ``x`` -- (B, D), or (C, B, D) for the batched entry --
    of a call the kernel takes, in chunks of rows; raises ValueError for
    any other."""
    *lead, B, D = x.shape
    lead = tuple(lead)
    for arg, t, shape in (("w", w, lead + (D,)), ("x", x, lead + (B, D)),
                          ("y", y, lead + (B,)), ("mask", mask, lead + (B,))):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return tuple(x.shape)


def pa_scan_chunked(step, w, x, y, mask, max_rows: int):
    """The scan over B rows as consecutive chunks of at most ``max_rows``.

    ``step(w, x, y, mask) -> (new_w, mean masked hinge)`` scans one chunk;
    each chunk starts from the ``w`` the previous one left, which is exact,
    since the scan is sequential. The loss is the masked mean over the
    whole batch: each chunk's hinge sum (its mean times its mask count,
    the count taken as at least 1 as the mean takes it) over the batch's
    mask count -- not a mean of the chunks' means. One chunk is one call of
    ``step`` as it is. Rows are the second-to-last axis of ``x`` and the
    last of ``y`` and ``mask``, so a leading member axis chunks the same
    way (the chunks of a member axis are copied contiguous)."""
    B = x.shape[-2]
    if B <= max_rows:
        return step(w, x, y, mask)
    hinge_sum = torch.zeros(mask.shape[:-1], dtype=torch.float32, device=x.device)
    for r0 in range(0, B, max_rows):
        rows = slice(r0, min(B, r0 + max_rows))
        m = mask[..., rows].contiguous()
        w, mean = step(w, x[..., rows, :].contiguous(), y[..., rows].contiguous(), m)
        hinge_sum = hinge_sum + mean * torch.clamp(m.sum(dim=-1), min=1.0)
    return w, hinge_sum / torch.clamp(mask.sum(dim=-1), min=1.0)


def _variant_args(variant: str, C: float) -> Tuple[int, float]:
    code = _VARIANTS.get(variant, 2)
    return code, (1.0 / (2.0 * float(C)) if code == 2 else 0.0)


def pa_scan_update(
    w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
    variant: str = "PA-I", C: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential PA pass over a micro-batch.

    w[D], x[B, D] (bias column already appended), y[B], mask[B] ->
    (new_w[D], mean masked hinge as a 0-d tensor). CUDA tensors go through
    the kernel, CPU tensors through :func:`pa_scan_reference`.

    The kernel takes any D but at most ``omldm_pa_scan_max_rows()`` rows
    (26,944: its chain keeps two floats a row in shared memory); a larger
    batch runs as consecutive chunks of that many rows
    (:func:`pa_scan_chunked`), so any B is taken, as the JAX package's
    ``lax.scan`` takes it. Each chunk allocates Bp^2 + 2 Bp + 1 floats of
    device scratch, Bp = its rows rounded up to 32 (0.26 MB at B = 256,
    2.9 GB at the limit), and its Gram prologue does Bp^2 D / 2 FMAs."""
    if x.device.type == "cpu":
        return pa_scan_reference(w, x, y, mask, variant, C)
    if x.device.type != "cuda":
        raise ValueError(f"pa_scan_update: unsupported device {x.device}")
    lib = LIBRARY.load()
    _validate(w, x, y, mask)
    code, inv2c = _variant_args(variant, C)

    def launch(w, x, y, mask):
        B, D = x.shape
        w_out = torch.empty_like(w)
        # the kernel's scratch (the Gram matrix and two rows, 16-byte
        # aligned at the allocation's start), then the mean hinge
        n = lib.omldm_pa_scan_scratch_floats(B)
        buf = torch.empty((n + 1,), dtype=torch.float32, device=x.device)
        loss = buf[n:]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.omldm_pa_scan(
                w.data_ptr(), x.data_ptr(), y.data_ptr(), mask.data_ptr(),
                w_out.data_ptr(), loss.data_ptr(), buf.data_ptr(), B, D, code,
                float(C), inv2c, stream,
            )
        if rc != 0:
            raise RuntimeError(f"pa_scan kernel launch failed: CUDA error {rc}")
        global launches
        launches += 1
        return w_out, loss.reshape(())

    return pa_scan_chunked(launch, w, x, y, mask, lib.omldm_pa_scan_max_rows())


def member_groups(members: int, member_floats: int,
                  budget: int = SCRATCH_BUDGET_FLOATS) -> List[Tuple[int, int]]:
    """The [start, stop) ranges of members that one batched launch takes:
    as many as fit ``budget`` floats of scratch at ``member_floats`` a
    member, and at least one (one member's scratch is what a single scan
    needs). 64 members at B = 256 take one launch; at B = 16,384 (1.07 GB
    of Gram matrix a member) a launch takes 3."""
    k = max(1, budget // max(1, member_floats))
    return [(m, min(members, m + k)) for m in range(0, members, k)]


def pa_scan_batched_reference(
    w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
    variant: str = "PA-I", C: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the batched entry: :func:`pa_scan_reference` member
    by member. A member whose mask is all zero keeps its ``w`` as it is,
    as the kernel does (the JAX cohort's select keeps such a member's
    state)."""
    ws, losses = [], []
    for m in range(x.shape[0]):
        new_w, loss = pa_scan_reference(w[m], x[m], y[m], mask[m], variant, C)
        ws.append(torch.where(mask[m].sum() > 0, new_w, w[m].to(torch.float32)))
        losses.append(loss)
    return torch.stack(ws), torch.stack(losses)


def pa_scan_update_batched(
    w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
    variant: str = "PA-I", C: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """C independent exact PA passes in one launch sequence.

    w[C, D], x[C, B, D] (bias column appended), y[C, B], mask[C, B] ->
    (new_w[C, D], mean masked hinge [C]). CUDA tensors go through the
    kernel's batched entry (``omldm_pa_scan_batched``), CPU tensors through
    :func:`pa_scan_batched_reference`. A batch past
    ``omldm_pa_scan_max_rows()`` rows runs as chunks of rows, every member
    at once (:func:`pa_scan_chunked`). The scratch is the one-scan scratch a
    member (16.9 MB at C = 64, B = 256); members whose scratch would pass
    ``SCRATCH_BUDGET_FLOATS`` run as further launches over groups of
    members (:func:`member_groups`), one scratch buffer reused by each."""
    if x.device.type == "cpu":
        return pa_scan_batched_reference(w, x, y, mask, variant, C)
    if x.device.type != "cuda":
        raise ValueError(f"pa_scan_update_batched: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"pa_scan_update_batched: x must be [C, B, D], got {tuple(x.shape)}")
    lib = LIBRARY.load()
    _validate(w, x, y, mask, "pa_scan_update_batched")
    code, inv2c = _variant_args(variant, C)

    def launch(w, x, y, mask):
        global batched_launches
        members, B, D = x.shape
        w_out = torch.empty_like(w)
        loss = torch.empty((members,), dtype=torch.float32, device=x.device)
        n = lib.omldm_pa_scan_scratch_floats(B)
        groups = member_groups(members, n)
        scratch = torch.empty(((groups[0][1] - groups[0][0]) * n,), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            for m0, m1 in groups:
                rc = lib.omldm_pa_scan_batched(
                    w[m0].data_ptr(), x[m0].data_ptr(), y[m0].data_ptr(), mask[m0].data_ptr(),
                    w_out[m0].data_ptr(), loss[m0:].data_ptr(), scratch.data_ptr(), m1 - m0,
                    B, D, code, float(C), inv2c, stream,
                )
                if rc != 0:
                    raise RuntimeError(f"pa_scan batched kernel launch failed: CUDA error {rc}")
                batched_launches += 1
        return w_out, loss

    return pa_scan_chunked(launch, w, x, y, mask, lib.omldm_pa_scan_max_rows())


@torch.library.custom_op("omldm::pa_scan_update", mutates_args=())
def pa_scan_op(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
               variant: str, C: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pa_scan_update` as an operator ``torch.func.vmap`` can batch:
    under vmap it runs :func:`pa_scan_update_batched` over the vmapped
    axis (one launch for every member)."""
    return pa_scan_update(w, x, y, mask, variant, C)


@pa_scan_op.register_fake
def _(w, x, y, mask, variant, C):
    return torch.empty_like(w), w.new_empty(())


@pa_scan_op.register_vmap
def _(info, in_dims, w, x, y, mask, variant, C):
    size = info.batch_size

    def lead(t, d):
        t = t.unsqueeze(0).expand(size, *t.shape) if d is None else t.movedim(d, 0)
        return t.contiguous()

    wd, xd, yd, md = in_dims[:4]
    w_out, loss = pa_scan_update_batched(
        lead(w, wd), lead(x, xd), lead(y, yd), lead(mask, md), variant, C
    )
    return (w_out, loss), (0, 0)
