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

The kernel is built with ``nvcc`` on first use, from the sources in the
checkout, and bound with ``ctypes`` (``ops/_build.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from omldm_tpu_torch.ops._build import KernelLibrary

_VARIANTS = {"PA": 0, "PA-I": 1}  # anything else is PA-II, as in the JAX kernel

#: kernel launches made by :func:`pa_scan_update` (CUDA tensors only)
launches = 0


def _configure(lib: ctypes.CDLL) -> None:
    lib.omldm_pa_scan.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.omldm_pa_scan.restype = ctypes.c_int
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


def _validate(w, x, y, mask) -> Tuple[int, int]:
    """(B, D) of a call the kernel takes, in chunks of rows; raises
    ValueError for any other."""
    B, D = x.shape
    for name, t, shape in (("w", w, (D,)), ("x", x, (B, D)), ("y", y, (B,)),
                           ("mask", mask, (B,))):
        if t.device != x.device:
            raise ValueError(f"pa_scan_update: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"pa_scan_update: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"pa_scan_update: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"pa_scan_update: {name} must be contiguous")
    return B, D


def pa_scan_chunked(step, w, x, y, mask, max_rows: int):
    """The scan over B rows as consecutive chunks of at most ``max_rows``.

    ``step(w, x, y, mask) -> (new_w, mean masked hinge)`` scans one chunk;
    each chunk starts from the ``w`` the previous one left, which is exact,
    since the scan is sequential. The loss is the masked mean over the
    whole batch: each chunk's hinge sum (its mean times its mask count,
    the count taken as at least 1 as the mean takes it) over the batch's
    mask count -- not a mean of the chunks' means. One chunk is one call of
    ``step`` as it is."""
    B = x.shape[0]
    if B <= max_rows:
        return step(w, x, y, mask)
    hinge_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for r0 in range(0, B, max_rows):
        rows = slice(r0, min(B, r0 + max_rows))
        w, mean = step(w, x[rows], y[rows], mask[rows])
        hinge_sum = hinge_sum + mean * torch.clamp(mask[rows].sum(), min=1.0)
    return w, hinge_sum / torch.clamp(mask.sum(), min=1.0)


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
    code = _VARIANTS.get(variant, 2)
    inv2c = 1.0 / (2.0 * float(C)) if code == 2 else 0.0

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
