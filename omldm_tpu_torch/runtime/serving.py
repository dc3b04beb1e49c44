"""Forecast serving telemetry.

Counterpart of ``omldm_tpu/runtime/serving.py``; only ``ServeStats`` is
ported -- the adaptive-batching serving plane is not, so every forecast
takes the immediate per-record predict path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# latency samples retained per net (the percentile window)
LATENCY_RING_CAP = 8192


class ServeStats:
    """Per-net serving telemetry: served count + a bounded ring of
    enqueue->emit latencies (ms)."""

    __slots__ = ("count", "_ring", "_n", "_i")

    def __init__(self, cap: int = LATENCY_RING_CAP):
        self.count = 0
        self._ring = np.zeros((cap,), np.float64)
        self._n = 0
        self._i = 0

    def note(self, latency_ms: float) -> None:
        self.count += 1
        self._ring[self._i] = latency_ms
        self._i = (self._i + 1) % self._ring.shape[0]
        self._n = min(self._n + 1, self._ring.shape[0])

    def percentiles(self) -> Tuple[float, float, float]:
        """(p50, p99, p999) ms over the retained window; zeros if empty."""
        if self._n == 0:
            return 0.0, 0.0, 0.0
        p = np.percentile(self._ring[: self._n], (50.0, 99.0, 99.9))
        return float(p[0]), float(p[1]), float(p[2])

    def reset(self) -> None:
        """Drop the folded-out count (the percentile window is retained)."""
        self.count = 0
