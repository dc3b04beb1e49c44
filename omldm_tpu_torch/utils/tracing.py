"""Profiling and host-side step timing (counterpart of
``omldm_tpu/utils/tracing.py``).

- :func:`trace` -- a context manager around ``torch.profiler`` writing a
  Chrome trace (``chrome://tracing``, Perfetto) into a directory: the
  port's ``--profileDir``, where the JAX package writes an XLA profile.
- :class:`StepTimer` -- cheap wall-clock accounting for streaming steps:
  per-step ms percentiles and steps/sec, and the recent p99 the overload
  controller reads as its serve-latency signal.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional


def trace_path(log_dir: str) -> str:
    """The Chrome trace :func:`trace` writes into ``log_dir``."""
    return os.path.join(log_dir, f"trace-{os.getpid()}.json")


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """Profile the enclosed block with ``torch.profiler`` when ``log_dir``
    is set (a no-op otherwise, so call sites pass the flag through).

    CPU activity is always recorded; CUDA activity too when ``device`` is
    a CUDA device, and then a profiler that cannot record the card raises
    instead of writing a CPU-only trace. The trace lands in
    :func:`trace_path`. An exception in the block stops the profiler and
    propagates unchanged (no trace is written for a failed block)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                "--profileDir: this torch.profiler cannot record CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    except BaseException:
        try:
            prof.__exit__(None, None, None)
        except Exception:
            pass  # the block's own exception is the one to report
        raise
    prof.__exit__(None, None, None)
    # the raw trace's events (prof.events() would build the whole event
    # tree first, seconds on a long run)
    if cuda and not any(e.device_type() == torch.autograd.DeviceType.CUDA
                        for e in prof.profiler.kineto_results.events()):
        raise RuntimeError(
            "--profileDir: torch.profiler recorded no CUDA activity on a CUDA job")
    prof.export_chrome_trace(trace_path(log_dir))


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
