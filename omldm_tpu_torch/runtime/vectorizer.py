"""Record featurization and fixed-shape micro-batch assembly.

Counterpart of ``omldm_tpu/runtime/vectorizer.py``. Records are vectorized
on the host and accumulated into fixed-shape padded micro-batches. The dense
route hashes categorical features into ``hash_dims`` trailing buckets; the
sparse route keeps each record as a padded-COO pair (idx[K], val[K]) and
hashes categoricals into a wide index space without densifying.
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


@dataclasses.dataclass(frozen=True)
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


@dataclasses.dataclass(frozen=True)
class SparseVectorizer:
    """Maps DataInstances to padded-COO (idx[K], val[K]) records: dense
    features keep their positional slots [0, dense_dim), categorical
    features hash into [dense_dim, dense_dim + hash_space). ``dim`` =
    dense_dim + hash_space is the model width; ``max_nnz`` (K) is the fixed
    per-record active-feature budget (pad slots idx=0/val=0 are inert in
    the gather and the scatter, ops/sparse.py)."""

    dim: int
    hash_space: int
    max_nnz: int

    def vectorize(self, inst: DataInstance) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.zeros((self.max_nnz,), np.int32)
        val = np.zeros((self.max_nnz,), np.float32)
        k = 0
        pos = 0
        dense_budget = self.dim - self.hash_space
        for feats in (inst.numerical_features, inst.discrete_features):
            if feats:
                for v in feats:
                    if pos >= dense_budget or k >= self.max_nnz:
                        break
                    fv = min(max(float(v), -F32_MAX), F32_MAX)
                    if fv != 0.0:
                        idx[k] = pos
                        val[k] = fv
                        k += 1
                    pos += 1
        if self.hash_space > 0 and inst.categorical_features:
            base = self.dim - self.hash_space
            for i, cat in enumerate(inst.categorical_features):
                if k >= self.max_nnz:
                    break
                h = zlib.crc32(f"{i}={cat}".encode())
                idx[k] = base + (h % self.hash_space)
                # signed hashing, the same rule as the dense Vectorizer
                val[k] = 1.0 if (h >> 1) % 2 == 0 else -1.0
                k += 1
        return idx, val


class SparseMicroBatcher:
    """Accumulates sparse records into fixed-shape ((idx, val), y, mask)
    micro-batches -- the padded-COO twin of MicroBatcher."""

    def __init__(self, max_nnz: int, batch_size: int):
        self.batch_size = batch_size
        self._idx = np.zeros((batch_size, max_nnz), np.int32)
        self._val = np.zeros((batch_size, max_nnz), np.float32)
        self._y = np.zeros((batch_size,), np.float32)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def queued(self) -> int:
        """Pending (staged, unflushed) rows: the queue-depth accessor
        (``ServingPlane.queued()``'s contract)."""
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.batch_size

    def add(self, x: Tuple[np.ndarray, np.ndarray], y: float) -> None:
        """Stage one record: ``x`` is the vectorizer's (idx, val) pair."""
        self._idx[self._n], self._val[self._n] = x
        self._y[self._n] = y
        self._n += 1

    def drain(self):
        """UNPADDED pending rows ((idx, val), y) and reset; None if empty
        (a shrink rescale re-feeds them into another batcher)."""
        if self._n == 0:
            return None
        out = ((self._idx[: self._n].copy(), self._val[: self._n].copy()),
               self._y[: self._n].copy())
        self._idx[:] = 0
        self._val[:] = 0.0
        self._y[:] = 0.0
        self._n = 0
        return out

    def flush(self):
        """((idx, val), y, mask) padded batch and reset; None if empty."""
        if self._n == 0:
            return None
        mask = np.zeros((self.batch_size,), np.float32)
        mask[: self._n] = 1.0
        out = ((self._idx.copy(), self._val.copy()), self._y.copy(), mask)
        self._idx[:] = 0
        self._val[:] = 0.0
        self._y[:] = 0.0
        self._n = 0
        return out


class MicroBatcher:
    """Accumulates vectorized records into fixed-shape (x, y, mask) batches.

    ``flush`` pads the ragged tail with zero rows and a zero mask -- masked
    rows contribute nothing to learner updates."""

    def __init__(self, dim: int, batch_size: int):
        self.batch_size = batch_size
        self._x = np.zeros((batch_size, dim), np.float32)
        self._y = np.zeros((batch_size,), np.float32)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def queued(self) -> int:
        """Pending (staged, unflushed) rows: the queue-depth accessor
        (``ServingPlane.queued()``'s contract)."""
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.batch_size

    def add(self, x: np.ndarray, y: float) -> None:
        self._x[self._n] = x
        self._y[self._n] = y
        self._n += 1

    def add_many(self, x: np.ndarray, y: np.ndarray) -> int:
        """Bulk-add up to the remaining capacity; returns #rows taken.
        Callers loop: take, flush when full, repeat with the rest."""
        take = min(self.batch_size - self._n, x.shape[0])
        if take > 0:
            self._x[self._n : self._n + take] = x[:take]
            self._y[self._n : self._n + take] = y[:take]
            self._n += take
        return take

    def drain(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The UNPADDED pending rows (x[:n], y[:n]) and reset; None if
        empty (a shrink rescale re-feeds them into another batcher)."""
        if self._n == 0:
            return None
        out = self._x[: self._n].copy(), self._y[: self._n].copy()
        self._n = 0
        return out

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

    def flush_views(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Zero-copy flush: padded VIEWS of the internal buffers (valid only
        until the next add) and a fresh mask, for consumers that copy the
        rows at once -- a cohort member's fit stages them into the gang
        buffers."""
        if self._n == 0:
            return None
        mask = np.zeros((self.batch_size,), np.float32)
        mask[: self._n] = 1.0
        self._x[self._n :] = 0.0
        self._y[self._n :] = 0.0
        self._n = 0
        return self._x, self._y, mask
