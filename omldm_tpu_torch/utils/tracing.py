"""Profiling and host-side step timing (counterpart of
``omldm_tpu/utils/tracing.py``).

- :func:`trace` -- a context manager around ``torch.profiler`` writing a
  Chrome trace (``chrome://tracing``, Perfetto) into a directory: the
  port's ``--profileDir``, where the JAX package writes an XLA profile;
  :class:`ProfileWindow` -- the same trace over a window opened and closed
  by hand (the Kafka route's ``--profileSteps`` window).
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


class ProfileWindow:
    """A ``torch.profiler`` trace over a window the caller opens and closes:
    :meth:`start` begins recording, :meth:`stop` ends it (once; a second
    call does nothing) and writes the Chrome trace into :func:`trace_path`.
    The Kafka route bounds its window to ``--profileSteps`` events this way
    (the stream is unbounded); :func:`trace` wraps a block in one.

    CPU activity is always recorded; CUDA activity too when ``device`` is
    a CUDA device, and then a profiler that cannot record the card raises
    at :meth:`start`, and a window that recorded no CUDA activity raises at
    :meth:`stop`, instead of writing a CPU-only trace."""

    def __init__(self, log_dir: str, device=None):
        import torch
        from torch.profiler import ProfilerActivity

        self.log_dir = log_dir
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._activities = [ProfilerActivity.CPU]
        if self.cuda:
            if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
                raise RuntimeError(
                    "--profileDir: this torch.profiler cannot record CUDA activity")
            self._activities.append(ProfilerActivity.CUDA)
        self._prof = None
        self.active = False

    def start(self) -> "ProfileWindow":
        from torch.profiler import profile

        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = profile(activities=self._activities)
        self._prof.__enter__()
        self.active = True
        return self

    def stop(self, write: bool = True) -> None:
        """End the window; with ``write``, export the trace (``write=False``
        discards it: the window's block failed)."""
        if not self.active:
            return
        self.active = False
        prof = self._prof
        if not write:
            try:
                prof.__exit__(None, None, None)
            except Exception:
                pass  # the block's own exception is the one to report
            return
        prof.__exit__(None, None, None)
        import torch

        # the raw trace's events (prof.events() would build the whole event
        # tree first, seconds on a long run)
        if self.cuda and not any(e.device_type() == torch.autograd.DeviceType.CUDA
                                 for e in prof.profiler.kineto_results.events()):
            raise RuntimeError(
                "--profileDir: torch.profiler recorded no CUDA activity on a CUDA job")
        prof.export_chrome_trace(trace_path(self.log_dir))

    @property
    def profiler(self):
        return self._prof


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """Profile the enclosed block with ``torch.profiler`` when ``log_dir``
    is set (a no-op otherwise, so call sites pass the flag through): a
    :class:`ProfileWindow` over the block. The trace lands in
    :func:`trace_path`. An exception in the block stops the profiler and
    propagates unchanged (no trace is written for a failed block)."""
    if not log_dir:
        yield None
        return
    window = ProfileWindow(log_dir, device).start()
    try:
        yield window.profiler
    except BaseException:
        window.stop(write=False)
        raise
    window.stop()


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
