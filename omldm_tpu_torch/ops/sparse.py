"""Sparse (padded-COO) feature ops for high-dimensional linear learners.

Counterpart of ``omldm_tpu/ops/sparse.py``. A batch is ``(idx[B, K] int32,
val[B, K] float32)`` with a fixed K (max nnz per record), padded with
idx=0 / val=0: a zero value adds nothing to the gather-dot or the
scatter-add. The model stays dense on the device; each record touches only
its K active rows.

The scatter-add is the sparse learners' device work. ``sparse_scatter_add``
and ``sparse_scatter_add_outer`` launch the CUDA kernel
``csrc/scatter_add.cu`` (the counterpart of the TPU kernel ``pallas_serial``
in ``benchmarks/sparse_scatter_experiment.py``) for CUDA tensors and run
``sparse_scatter_add_reference`` -- ``index_add_`` -- for CPU tensors.
There is no fallback from one to the other: a CUDA tensor the kernel cannot
take raises. Updates whose index lies outside [0, D) are dropped by both
(the JAX scatter drops indices >= D and wraps negative ones; the gate keeps
the port's producers inside [0, D)). The gather-dot and the two other
scatter formulations (``mxu``, ``segsum``) are plain PyTorch, as the JAX
package leaves them to XLA.

Every scatter formulation takes ``inplace``. By default it returns a new
tensor and leaves ``w`` as it was; with ``inplace=True`` it writes into
``w`` and returns it. The pipeline's fit gives the learner state up (as the
JAX package donates its state to every fit), so on the main path the
kernel updates ``w`` where it lies, without a copy.
"""

from __future__ import annotations

import ctypes
import os

import torch

from omldm_tpu_torch.ops._build import KernelLibrary

#: kernel launches by entry point (CUDA tensors only)
launches = {"scatter_add": 0, "scatter_add_outer": 0}


def _configure(lib: ctypes.CDLL) -> None:
    lib.omldm_scatter_add.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.omldm_scatter_add.restype = ctypes.c_int
    lib.omldm_empty_launch.argtypes = [ctypes.c_void_p]
    lib.omldm_empty_launch.restype = ctypes.c_int


#: the kernel library, built from the checkout's source on first use
LIBRARY = KernelLibrary("scatter_add.cu", _configure)


def sparse_matvec(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """margins[b] = sum_k w[idx[b, k]] * val[b, k]  (gather-dot)."""
    rows = w.index_select(0, idx.reshape(-1)).reshape(idx.shape)
    return (rows * val).sum(dim=1)


def sparse_matmat(W: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """logits[b, c] = sum_k W[idx[b, k], c] * val[b, k] for W[D, C]."""
    rows = W.index_select(0, idx.reshape(-1)).reshape(*idx.shape, W.shape[1])
    return (rows * val[:, :, None]).sum(dim=1)


def sparse_scatter_add_reference(
    w: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, val: torch.Tensor,
    inplace: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``index_add_`` on a clone of
    ``w``, or on ``w`` itself with ``inplace``.

    w[D] with coef[B], or W[D, C] with coef[B, C]; idx/val[B, K]. The
    update u = coef * val is rounded to float32 before it is added;
    out-of-range indices are dropped (masked to a zero update on row 0, so
    the CUDA ``index_add_`` never sees them)."""
    d = w.shape[0]
    flat = idx.reshape(-1).to(torch.int64)
    keep = (flat >= 0) & (flat < d)
    if w.dim() == 1:
        upd = torch.where(keep, (coef[:, None] * val).reshape(-1), 0.0)
    else:
        upd = (val[:, :, None] * coef[:, None, :]).reshape(flat.shape[0], w.shape[1])
        upd = torch.where(keep[:, None], upd, 0.0)
    safe = torch.where(keep, flat, 0)
    return (w if inplace else w.clone()).index_add_(0, safe, upd)


def _launch(entry: str, w, idx, coef, val, inplace: bool) -> torch.Tensor:
    """Check what the kernel takes, allocate the output unless in place,
    launch, count."""
    if w.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {w.device}")
    outer = entry == "scatter_add_outer"
    if idx.dim() != 2 or w.dim() != (2 if outer else 1):
        raise ValueError(f"{entry}: want idx[B, K] and w[{'D, C' if outer else 'D'}], got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    b, k = idx.shape
    c = w.shape[1] if outer else 1
    for name, t, dtype, shape in (
        ("w", w, torch.float32, tuple(w.shape)),
        ("idx", idx, torch.int32, (b, k)),
        ("coef", coef, torch.float32, (b, c) if outer else (b,)),
        ("val", val, torch.float32, (b, k)),
    ):
        if t.device != w.device:
            raise ValueError(f"{entry}: {name} on {t.device}, w on {w.device}")
        if t.dtype != dtype:
            raise ValueError(f"{entry}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{entry}: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous")
    out = w if inplace else torch.empty_like(w)
    if b * k == 0:
        return out if inplace else out.copy_(w)
    lib = LIBRARY.load()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.omldm_scatter_add(
            w.data_ptr(), idx.data_ptr(), coef.data_ptr(), val.data_ptr(),
            out.data_ptr(), b, k, c, w.shape[0], stream,
        )
    if rc != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {rc}")
    launches[entry] += 1
    return out


def sparse_scatter_add(
    w: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, val: torch.Tensor,
    inplace: bool = False,
) -> torch.Tensor:
    """w[idx[b, k]] += coef[b] * val[b, k] over the whole batch (duplicate
    indices accumulate), as a new tensor or, with ``inplace``, into ``w``.
    CUDA tensors go through the kernel, CPU tensors through
    :func:`sparse_scatter_add_reference`."""
    if w.device.type == "cpu":
        return sparse_scatter_add_reference(w, idx, coef, val, inplace)
    return _launch("scatter_add", w, idx, coef, val, inplace)


def empty_launch() -> None:
    """One launch of an empty kernel on the current stream: the floor under
    one launch, timed beside the scatter's bound (never on the main path)."""
    lib = LIBRARY.load()
    rc = lib.omldm_empty_launch(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


# lane width of the kron factorization below (the JAX package's MXU_LANES)
MXU_LANES = 512


def sparse_scatter_add_mxu(
    w: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, val: torch.Tensor,
    inplace: bool = False,
) -> torch.Tensor:
    """The same scatter-add as one contraction of one-hot operands.

    Factor D <= R*C as (hi, lo) = divmod(idx, C), C = 512; then
    delta[hi, lo] = OneHotHi[n, R]^T @ (OneHotLo[n, C] * u_n). As in the
    JAX package, u is split into two bf16 halves concatenated along the
    contraction, so every operand is exact in bf16; the port widens them to
    float32 and multiplies with TF32 off, which keeps every product exact
    and the sum float32 (a bf16 ``torch.matmul`` would return bf16). Within
    2e-5 of the plain scatter."""
    d = w.shape[0]
    c = MXU_LANES
    r = -(-d // c)
    flat_idx = idx.reshape(-1).to(torch.int64)
    n = flat_idx.shape[0]
    u = (coef[:, None] * val).reshape(n).to(torch.float32)
    one_hi = torch.nn.functional.one_hot(flat_idx // c, r).to(torch.float32)
    lo_oh = torch.nn.functional.one_hot(flat_idx % c, c).to(torch.float32)
    u_hi = u.to(torch.bfloat16).to(torch.float32)
    u_lo = u - u_hi
    rhs = torch.cat([
        (lo_oh * u_hi[:, None]).to(torch.bfloat16),
        (lo_oh * u_lo[:, None]).to(torch.bfloat16),
    ]).to(torch.float32)                                        # [2n, C]
    lhs = torch.cat([one_hi, one_hi])                           # [2n, R]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        delta = lhs.T @ rhs                                     # [R, C]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    delta = delta.reshape(-1)[:d]
    return w.add_(delta) if inplace else w + delta


def sparse_scatter_add_segsum(
    w: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, val: torch.Tensor,
    inplace: bool = False,
) -> torch.Tensor:
    """The same scatter-add with duplicate indices pre-combined by a sort and
    a segment sum; the final scatter of one total per distinct index goes
    through :func:`sparse_scatter_add` (the kernel on the card). Shapes stay
    static: run totals land in the first R slots of an [n] array, and the
    slots past them scatter a zero onto row 0. Within 2e-5 of the plain
    scatter (only the sum order differs)."""
    flat_idx = idx.reshape(-1)
    n = flat_idx.shape[0]
    if n == 0:
        return w if inplace else w.clone()
    u = (coef[:, None] * val).reshape(n).to(torch.float32)
    si, order = torch.sort(flat_idx, stable=True)
    su = u[order]
    is_start = torch.ones(n, dtype=torch.bool, device=w.device)
    is_start[1:] = si[1:] != si[:-1]
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1       # run id, sorted
    run_total = torch.zeros(n, dtype=torch.float32, device=w.device).index_add_(0, seg, su)
    run_idx = torch.zeros(n, dtype=si.dtype, device=w.device).scatter_(0, seg, si)
    real = torch.arange(n, device=w.device) <= seg[-1]
    run_idx = torch.where(real, run_idx, torch.zeros_like(run_idx))
    run_total = torch.where(real, run_total, torch.zeros_like(run_total))
    ones = torch.ones((n, 1), dtype=torch.float32, device=w.device)
    return sparse_scatter_add(w, run_idx.reshape(n, 1).contiguous(), run_total, ones, inplace)


SCATTER_IMPLS = {
    "scatter": sparse_scatter_add,
    "mxu": sparse_scatter_add_mxu,
    "segsum": sparse_scatter_add_segsum,
}

# env knob: OMLDM_SPARSE_SCATTER = scatter | mxu | segsum | auto ("auto" or
# unset reads the calibration table); config twin: dataStructure
# {"scatterImpl": "..."} on the sparse learner spec (learners pass impl=).
_ENV_KNOB = "OMLDM_SPARSE_SCATTER"


def _resolve_impl(d: int, n_updates: int, impl=None, backend: str = "cpu") -> str:
    """Dispatch decision, in precedence order: the ``impl`` argument (from
    dataStructure.scatterImpl), the OMLDM_SPARSE_SCATTER env var, the
    port's calibration table (``ops/sparse_dispatch.json``, nearest (D,
    updates) grid point for ``backend``), then ``"scatter"``. The table's
    ``cuda`` section, measured on an H100, picks ``"scatter"`` -- the
    kernel -- at every grid point."""
    if impl:
        name = str(impl)
        if name not in SCATTER_IMPLS:
            raise ValueError(
                f"unknown sparse scatter impl {name!r}; "
                f"expected one of {sorted(SCATTER_IMPLS)} "
            )
        return name
    env = os.environ.get(_ENV_KNOB, "").strip().lower()
    if env and env != "auto":
        if env not in SCATTER_IMPLS:
            raise ValueError(
                f"{_ENV_KNOB}={env!r}: expected "
                f"{sorted(SCATTER_IMPLS) + ['auto']}"
            )
        return env
    from omldm_tpu_torch.ops.sparse_calibrate import lookup_winner

    winner = lookup_winner(backend, d, n_updates)
    return winner if winner is not None else "scatter"


def sparse_scatter_add_auto(
    w: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, val: torch.Tensor,
    impl: str = None, inplace: bool = False,
) -> torch.Tensor:
    """Dispatch between the three scatter formulations; the backend name is
    the weight tensor's device type. See :func:`_resolve_impl`."""
    name = _resolve_impl(int(w.shape[0]), int(idx.numel()), impl, w.device.type)
    return SCATTER_IMPLS[name](w, idx, coef, val, inplace)


def sparse_scatter_add_outer(
    W: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor, val: torch.Tensor,
    inplace: bool = False,
) -> torch.Tensor:
    """W[idx[b, k], :] += val[b, k] * coef[b, :] for W[D, C] (the rank-1
    per-record outer product of a multiclass gradient), as a new tensor or,
    with ``inplace``, into ``W``. CUDA tensors go through the kernel, CPU
    tensors through :func:`sparse_scatter_add_reference`."""
    if W.device.type == "cpu":
        return sparse_scatter_add_reference(W, idx, coef, val, inplace)
    return _launch("scatter_add_outer", W, idx, coef, val, inplace)


def sparse_sq_norm(val: torch.Tensor) -> torch.Tensor:
    """||x_b||^2 per record (pad slots contribute 0)."""
    return (val * val).sum(dim=1)


def append_bias_sparse(idx: torch.Tensor, val: torch.Tensor, bias_index: int):
    """Append the constant-1 bias slot (weight row ``bias_index``) to every
    record -- the sparse analogue of learners.base.append_bias."""
    b = idx.shape[0]
    bias_idx = torch.full((b, 1), bias_index, dtype=idx.dtype, device=idx.device)
    bias_val = torch.ones((b, 1), dtype=val.dtype, device=val.device)
    return torch.cat([idx, bias_idx], dim=1), torch.cat([val, bias_val], dim=1)
