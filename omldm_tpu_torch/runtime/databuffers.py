"""Bounded FIFO data buffers.

Counterpart of ``omldm_tpu/runtime/databuffers.py``: the reference's
``mlAPI.dataBuffers.DataSet`` with ``append -> Option[evicted]``
(FlinkSpoke.scala:41,96-98), used for the sliding holdout test set, the
pre-creation record buffer and the hub's pre-creation message cache; and
its numpy ring twin ``RingHoldout`` over aligned columns, as
``ArrayHoldout`` (dense rows) and ``SparseHoldout`` (padded-COO rows), the
SPMD bridges' holdout sets, whose arrays the fused C stages write into.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Generic, Iterable, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


class DataSet(Generic[T]):
    def __init__(self, max_size: int):
        self.max_size = max_size
        self._buf: Deque[T] = deque()

    def append(self, item: T) -> Optional[T]:
        """Append; returns the evicted oldest item when full (the reference
        trains on evicted holdout points, FlinkSpoke.scala:96-104)."""
        evicted = None
        if len(self._buf) >= self.max_size:
            evicted = self._buf.popleft()
        self._buf.append(item)
        return evicted

    def merge(self, others: Iterable["DataSet[T]"]) -> None:
        """Merge parallel buffers (a shrink rescale, CommonUtils.scala:36-48):
        this buffer's items, then each other's, keeping the newest
        ``max_size``."""
        merged: List[T] = list(self._buf)
        for other in others:
            merged.extend(other._buf)
        self._buf = deque(merged[-self.max_size :])

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def is_empty(self) -> bool:
        return not self._buf

    def __iter__(self):
        return iter(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def to_list(self) -> List[T]:
        return list(self._buf)


class RingHoldout:
    """Vectorized bounded FIFO of rows held as aligned numpy columns -- the
    bulk-ingest counterpart of ``DataSet`` for holdout test sets
    (FlinkSpoke.scala:94-104 semantics: append evicts the oldest once full;
    evicted points re-enter training).

    ``columns`` gives each column's per-row shape and dtype; the last one is
    the target. Stored as ring buffers so a block of rows appends without a
    per-record Python loop; ``append_many`` reports each evicted row and the
    index (into the incoming block) of the row that evicted it."""

    def __init__(self, max_size: int, columns: Sequence[Tuple[tuple, type]]):
        self.max_size = max_size
        self._cols = tuple(np.zeros((max_size,) + tuple(shape), dtype)
                           for shape, dtype in columns)
        self._n = 0
        self._head = 0  # oldest element

    def __len__(self) -> int:
        return self._n

    @property
    def is_empty(self) -> bool:
        return self._n == 0

    def append_many(self, *cols: np.ndarray) -> Tuple[np.ndarray, ...]:
        """FIFO-append a block given as one array a column; returns the
        evicted rows' columns and then evictor_idx, where evictor_idx[i] is
        the row index within the block whose arrival evicted row i (exact
        DataSet.append-loop parity)."""
        out: List[List[np.ndarray]] = [[] for _ in self._cols]
        out_src: List[np.ndarray] = []
        cap = self.max_size
        # chunks of <= cap keep scatter positions distinct within a chunk
        for s in range(0, cols[0].shape[0], cap):
            chunk = [c[s : s + cap] for c in cols]
            k = chunk[0].shape[0]
            fill = min(cap - self._n, k)
            if fill > 0:
                pos = (self._head + self._n + np.arange(fill)) % cap
                for ring, c in zip(self._cols, chunk):
                    ring[pos] = c[:fill]
                self._n += fill
            k2 = k - fill
            if k2 > 0:
                pos = (self._head + np.arange(k2)) % cap
                for o, ring, c in zip(out, self._cols, chunk):
                    o.append(ring[pos].copy())
                    ring[pos] = c[fill:]
                out_src.append(np.arange(s + fill, s + k))
                self._head = (self._head + k2) % cap
        if not out_src:
            return tuple(np.zeros((0,) + r.shape[1:], r.dtype) for r in self._cols) + (
                np.zeros((0,), np.int64),)
        return tuple(np.concatenate(o) for o in out) + (np.concatenate(out_src),)

    def arrays(self) -> Tuple[np.ndarray, ...]:
        """Contents oldest-to-newest, one array (a copy) a column."""
        order = (self._head + np.arange(self._n)) % self.max_size
        return tuple(r[order] for r in self._cols)

    def clear(self) -> None:
        self._n = 0
        self._head = 0


class ArrayHoldout(RingHoldout):
    """Dense rows: columns (x [D] float32, y)."""

    def __init__(self, max_size: int, dim: int):
        super().__init__(max_size, [((dim,), np.float32), ((), np.float32)])
        self._x, self._y = self._cols


class SparseHoldout(RingHoldout):
    """Padded-COO rows: columns (idx [K] int32, val [K] float32, y)."""

    def __init__(self, max_size: int, max_nnz: int):
        super().__init__(max_size, [((max_nnz,), np.int32), ((max_nnz,), np.float32),
                                    ((), np.float32)])
        self.max_nnz = max_nnz
        self._idx, self._val, self._y = self._cols
