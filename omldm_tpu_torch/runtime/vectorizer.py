"""Record featurization and fixed-shape micro-batch assembly.

Counterpart of ``omldm_tpu/runtime/vectorizer.py`` (the dense route; the
sparse padded-COO route is not ported). Records are vectorized on the host
and accumulated into fixed-shape padded micro-batches; categorical features
are feature-hashed into ``hash_dims`` trailing buckets.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

import numpy as np

from omldm_tpu_torch.api.data import DataInstance

# float32 boundary clamp: a finite JSON double beyond float32 range would
# otherwise overflow to inf during batch assembly
F32_MAX = float(np.finfo(np.float32).max)


def clamp_f32(feats) -> np.ndarray:
    """float64 view -> clamp to float32 finite range -> float32."""
    a = np.asarray(feats, np.float64)
    return np.clip(a, -F32_MAX, F32_MAX).astype(np.float32)


@dataclasses.dataclass
class Vectorizer:
    """Maps DataInstances to fixed-dim float32 vectors: records with fewer
    features are zero-padded, longer ones truncated; ``hash_dims`` > 0
    reserves that many trailing dims for hashed categorical features."""

    dim: int
    hash_dims: int = 0

    def vectorize(self, inst: DataInstance) -> np.ndarray:
        out = np.zeros((self.dim,), np.float32)
        pos = 0
        dense_budget = self.dim - self.hash_dims
        for feats in (inst.numerical_features, inst.discrete_features):
            if feats:
                take = min(len(feats), dense_budget - pos)
                if take > 0:
                    out[pos : pos + take] = clamp_f32(feats[:take])
                    pos += take
        if self.hash_dims > 0 and inst.categorical_features:
            base = self.dim - self.hash_dims
            for i, cat in enumerate(inst.categorical_features):
                # stable hash: Python's builtin hash() is salted per process
                h = zlib.crc32(f"{i}={cat}".encode())
                idx = base + (h % self.hash_dims)
                # signed hashing keeps the estimate unbiased
                out[idx] += 1.0 if (h >> 1) % 2 == 0 else -1.0
        return out

    @staticmethod
    def infer_dim(inst: DataInstance, hash_dims: int = 0) -> int:
        """Feature width implied by the first record of a stream."""
        n = len(inst.numerical_features or []) + len(inst.discrete_features or [])
        return n + hash_dims


class MicroBatcher:
    """Accumulates vectorized records into fixed-shape (x, y, mask) batches.

    ``flush`` pads the ragged tail with zero rows and a zero mask -- masked
    rows contribute nothing to learner updates."""

    def __init__(self, dim: int, batch_size: int):
        self.batch_size = batch_size
        self._x = np.zeros((batch_size, dim), np.float32)
        self._y = np.zeros((batch_size,), np.float32)
        self._n = 0

    @property
    def full(self) -> bool:
        return self._n >= self.batch_size

    def add(self, x: np.ndarray, y: float) -> None:
        self._x[self._n] = x
        self._y[self._n] = y
        self._n += 1

    def flush(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Return the padded (x, y, mask) batch and reset; None if empty."""
        if self._n == 0:
            return None
        mask = np.zeros((self.batch_size,), np.float32)
        mask[: self._n] = 1.0
        x = self._x.copy()
        y = self._y.copy()
        x[self._n :] = 0.0
        y[self._n :] = 0.0
        self._n = 0
        return x, y, mask
