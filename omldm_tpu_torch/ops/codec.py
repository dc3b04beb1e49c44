"""Quantization kernels for the hub<->spoke transport codec.

Counterpart of ``omldm_tpu/ops/codec.py``. Two families live here:

- **Host kernels** (numpy): exact affine int8, fp16 round-trips and top-k
  delta sparsification, used by the host plane's transport codec
  (``runtime.codec``) at the message ship boundary. They are the JAX
  package's numpy code, so both packages put the same bytes on the wire.
- **Device twins** (torch): quantize-dequantize (QDQ) of the SPMD engine,
  applied to the vectors entering and leaving the protocol collectives
  inside ``SPMDTrainer``'s step. The JAX package computes them as XLA
  fusions of ``jnp`` ops, not in a Pallas kernel, so they stay plain torch
  on every device.

Error feedback is the caller's job (the transport codec keeps per-stream
residuals; the SPMD step keeps an ``ef`` state leaf): the kernels here are
stateless and deterministic, so a sender's encode and a receiver's decode
of the same bytes always agree. The SPMD engine prices its collectives with
the wire constants (``SPMDTrainer.protocol_traffic_bytes``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# wire bytes per parameter element, by codec kind (the int8 affine meta --
# scale + zero point, two float32 -- is accounted per LEAF, not per element)
BYTES_PER_ELEMENT = {"none": 4.0, "fp16": 2.0, "int8": 1.0}
# per-leaf metadata bytes on the wire
LEAF_META_BYTES = {"none": 0, "fp16": 0, "int8": 8}


# --- host kernels (numpy) ---


def fp16_encode(x: np.ndarray) -> np.ndarray:
    """Lossy fp32 -> fp16 cast (2 bytes/element on the wire)."""
    return np.asarray(x, np.float16)


def fp16_decode(q: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.asarray(q, dtype)


def int8_affine_encode(x: np.ndarray) -> Tuple[np.ndarray, np.float32, np.float32]:
    """Per-leaf affine (asymmetric) quantization to uint8:
    ``q = round((x - zero) / scale)`` with ``zero = min(x)`` and ``scale =
    (max(x) - min(x)) / 255``. Returns ``(q, scale, zero)``; a non-finite
    leaf raises (the codec must never launder corrupt state into a
    plausible-looking model)."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return x.astype(np.uint8), np.float32(1.0), np.float32(0.0)
    lo = np.float32(x.min())
    hi = np.float32(x.max())
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(
            "int8 codec: non-finite values in leaf "
            f"(min={x.min()!r}, max={x.max()!r}); refusing to encode"
        )
    scale = np.float32((hi - lo) / 255.0)
    if not np.isfinite(scale) or scale <= 0:
        # degenerate range (a constant leaf, or a subnormal span whose /255
        # underflows): scale 1 with zero point lo encodes every element as
        # q=0 and decodes to lo exactly, leaving no residual
        scale = np.float32(1.0)
    q = np.clip(np.rint((x - lo) / scale), 0, 255).astype(np.uint8)
    return q, scale, lo


def int8_affine_decode(q: np.ndarray, scale: float, zero: float, dtype=np.float32) -> np.ndarray:
    return (np.asarray(q, np.float32) * np.float32(scale) + np.float32(zero)).astype(dtype)


def int8_quantization_step(x: np.ndarray) -> float:
    """The affine grid step for ``x``: the clip at the range ends makes one
    full step the bound of the round-trip error."""
    x = np.asarray(x, np.float32)
    if x.size == 0:
        return 0.0
    return max(float(x.max() - x.min()) / 255.0, 0.0)


def topk_encode(delta: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k magnitude sparsification of a (flat) delta vector: ``(idx
    int32, val float32)`` of the k largest-|.| entries, 8 wire bytes a kept
    element. The dropped mass is the caller's to ship later."""
    flat = np.asarray(delta, np.float32).ravel()
    k = max(min(int(k), flat.size), 0)
    if k == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.float32)
    if k >= flat.size:
        idx = np.arange(flat.size, dtype=np.int32)
        return idx, flat.copy()
    part = np.argpartition(np.abs(flat), flat.size - k)[flat.size - k:]
    idx = np.sort(part).astype(np.int32)
    return idx, flat[idx]


def topk_decode(idx: np.ndarray, val: np.ndarray, size: int, dtype=np.float32) -> np.ndarray:
    """Scatter a top-k (idx, val) delta back into a dense flat vector."""
    out = np.zeros((int(size),), dtype)
    out[np.asarray(idx, np.int64)] = np.asarray(val, dtype)
    return out


# --- device twins (torch; QDQ = quantize-dequantize at the ship boundary) ---


def qdq_fp16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp16 -> fp32 round trip: every value that crosses the
    (emulated) wire is fp16-representable; past 65504 it becomes inf."""
    return x.to(torch.float16).to(torch.float32)


def qdq_int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 QDQ over the last axis: ``scale = max|x| / 127`` (1.0
    where that max is 0), ``q = clip(round(x / scale), -127, 127)``,
    returns ``q * scale``. ``torch.round`` rounds half to even, as
    ``jnp.round`` does. On a 1-D vector this is the JAX twin; a ``[dp, F]``
    fleet matrix quantizes each worker's row, as the JAX step does for each
    worker inside its ``shard_map``."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    return q * scale


def make_qdq(kind: str):
    """The device QDQ for a codec kind (None for ``none``)."""
    if kind in (None, "none"):
        return None
    if kind == "fp16":
        return qdq_fp16
    if kind == "int8":
        return qdq_int8
    raise ValueError(
        f"no device QDQ kernel for codec {kind!r} (topk is a host-plane "
        "transport codec: the collective engine's allreduce needs dense "
        "operands)"
    )
