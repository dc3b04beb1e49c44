"""Host-side step timing (counterpart of ``omldm_tpu/utils/tracing.py``;
only ``StepTimer`` is ported -- the JAX profiler wrapper has no use here).

:class:`StepTimer` is cheap wall-clock accounting for streaming steps:
per-step ms percentiles and steps/sec, and the recent p99 the overload
controller reads as its serve-latency signal.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class StepTimer:
    """Record per-step wall-clock durations and summarize percentiles.

    ``cap`` bounds the retained sample window (a ring of the most recent
    ``cap`` durations, like ServeStats' latency ring): a timer on a
    per-record hot path of a long-lived streaming job must not grow host
    memory with the stream. ``count`` stays the TOTAL recorded;
    percentiles summarize the retained window. ``cap=None`` (default)
    keeps every sample."""

    def __init__(self, name: str = "step", cap: Optional[int] = None):
        self.name = name
        self.cap = cap
        self._durations_ms: List[float] = []
        self._total = 0
        # exact cumulative wall (ms) across ALL recorded steps — the ring
        # bounds the percentile window, not the total
        self.total_ms = 0.0
        # a stack: one shared timer may wrap NESTED steps (a flush whose
        # protocol reply synchronously drains another pipeline's flush)
        self._starts: List[float] = []

    def __enter__(self):
        self._starts.append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        self.record((time.perf_counter() - self._starts.pop()) * 1000.0)
        return False

    def record(self, duration_ms: float) -> None:
        if self.cap is not None and len(self._durations_ms) >= self.cap:
            self._durations_ms[self._total % self.cap] = float(duration_ms)
        else:
            self._durations_ms.append(float(duration_ms))
        self._total += 1
        self.total_ms += float(duration_ms)

    @property
    def count(self) -> int:
        return self._total

    def summary(self) -> Dict[str, float]:
        """{count, mean_ms, p50_ms, p99_ms, steps_per_sec}; zeros if empty."""
        import numpy as np

        if not self._durations_ms:
            return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p99_ms": 0.0,
                    "steps_per_sec": 0.0}
        d = np.asarray(self._durations_ms)
        mean = float(d.mean())
        return {
            "count": self._total,
            "mean_ms": mean,
            "p50_ms": float(np.percentile(d, 50)),
            "p99_ms": float(np.percentile(d, 99)),
            "steps_per_sec": 1000.0 / mean if mean > 0 else 0.0,
        }

    def recent_p99(self, window: int = 256) -> float:
        """p99 ms over (about) the newest ``window`` samples: the overload
        controller's latency signal. It reads the tail of the ring without
        sorting the whole window (past one wrap the ring's order scrambles
        recency a little, which a pressure signal tolerates); 0.0 when
        empty."""
        import numpy as np

        if not self._durations_ms:
            return 0.0
        tail = self._durations_ms[-min(window, len(self._durations_ms)):]
        return float(np.percentile(np.asarray(tail), 99))

    def reset(self) -> None:
        self._durations_ms = []
        self._total = 0
        self.total_ms = 0.0
