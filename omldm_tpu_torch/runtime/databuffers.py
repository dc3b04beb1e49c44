"""Bounded FIFO data buffers.

Counterpart of ``omldm_tpu/runtime/databuffers.py`` (only ``DataSet`` is
used by the ported route): the reference's ``mlAPI.dataBuffers.DataSet``
with ``append -> Option[evicted]`` (FlinkSpoke.scala:41,96-98). Used for the
sliding holdout test set, the pre-creation record buffer and the hub's
pre-creation message cache.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Generic, List, Optional, TypeVar

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
