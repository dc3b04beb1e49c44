"""Failure classification and the restart policy of supervised recovery.

Counterpart of the part of ``omldm_tpu/runtime/selfheal.py`` that the
in-process supervisor (``runtime.recovery.JobSupervisor``) uses. The
reference's failure story is crash-stop: ``JobTerminator.scala:6-10``
throws and Flink restarts the whole job with a fixed-delay strategy
(Job.scala:14).

- :func:`classify_exception` -- the failure taxonomy: ``crash`` (a failure
  after the attempt had made progress), ``hang`` (a timeout shape) and
  ``launch`` (an attempt that failed before processing a single event).
- :func:`classify_failure` -- the same taxonomy for a process, from its exit
  code and heartbeat (the sharded ingest plane's parser workers,
  ``runtime.ingest_shard``), with ``HANG_EXIT``, the exit code a wedged
  slot's watchdog uses.
- :class:`RestartPolicy` -- exponential backoff (Flink's fixed delay is
  ``growth=1``) with deterministic, seeded jitter.
- :class:`HangWatchdog` -- the fleet worker's deadline around group
  collectives: a worker stuck waiting on a killed or stopped peer dumps
  its black box and exits :data:`HANG_EXIT` instead of wedging forever.
- :func:`sigstop_self` -- the hang fault injector's trigger.

The supervisor's half of the JAX module -- ``SelfHealPolicy`` (slot
strikes, shrink-to-survivors, probed re-expansion) and ``kill_escalate``
-- waits for the fleet supervisor (ROADMAP queue 1, item 4.3), its only
caller.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
from typing import Callable, Optional

from omldm_tpu_torch.utils import clock as uclock
from omldm_tpu_torch.utils.backoff import BackoffPolicy, seeded_rng

# --- failure taxonomy -------------------------------------------------------

CRASH = "crash"    # a failure after the attempt had proven itself alive
HANG = "hang"      # heartbeat silence / wedged in a collective
LAUNCH = "launch"  # died without ever making progress: never came up

# exit code a worker's hang watchdog uses: "my peer is dead or wedged; I am
# exiting instead of blocking in this collective forever". Distinct from
# RESCALE_EXIT (17) and the fault injector's crash code (3), so a
# supervisor blames the WEDGED slot, not the honest survivor.
HANG_EXIT = 19


def classify_failure(
    returncode: Optional[int] = None,
    heartbeat_silent: bool = False,
    ever_beat: Optional[bool] = None,
) -> str:
    """One failed process's failure class. ``ever_beat`` is None when the
    heartbeat channel is unarmed (launch failures are then
    indistinguishable from crashes and classify as ``crash``)."""
    if heartbeat_silent or returncode == HANG_EXIT:
        return HANG
    if ever_beat is False:
        return LAUNCH
    return CRASH


def classify_exception(exc: BaseException, progressed: bool = True) -> str:
    """The in-process twin (``recovery.JobSupervisor``): an attempt that
    failed before processing a single event is the launch class; a timeout
    shape is a hang; everything else is a crash."""
    if isinstance(exc, TimeoutError):
        return HANG
    if not progressed:
        return LAUNCH
    return CRASH


# --- restart policy ---------------------------------------------------------


@dataclasses.dataclass
class RestartPolicy:
    """``max_restarts`` relaunches with exponential backoff
    (``base_delay_s * growth**k``) and deterministic jitter (``U(0,
    jitter_s)`` from a seeded stream: same seed, same delays, every run).
    ``growth=1.0`` is the reference's fixedDelayRestart.

    ``seed=None`` derives the stream from the process id, so co-hosted
    supervisors still desynchronize; an explicit seed pins the schedule
    for replays and tests."""

    max_restarts: int = 3
    base_delay_s: float = 0.0
    growth: float = 2.0
    jitter_s: float = 0.0
    seed: Optional[int] = None

    def backoff(self) -> BackoffPolicy:
        return BackoffPolicy(
            attempts=self.max_restarts + 1,
            base_delay=self.base_delay_s,
            growth=self.growth,
            jitter=self.jitter_s,
        )

    def rng(self) -> Callable[[], float]:
        seed = self.seed if self.seed is not None else os.getpid()
        return seeded_rng(seed, "restart")


# --- worker-side hang watchdog ----------------------------------------------


class HangWatchdog:
    """Deadline watchdog around group collectives.

    A worker whose peer died mid-collective blocks in native code forever
    (gloo keeps waiting); the supervisor's heartbeat channel eventually
    notices the SILENT worker, but the honest survivors would wedge until
    killed. This watchdog gives every guarded region a deadline: re-entrant
    ``guard(phase)`` context managers refresh the deadline on entry (each
    completed collective round is progress), and a poll thread fires
    ``on_expire(phase)`` -- the worker's reason-coded HANG_EXIT path -- when
    a region overstays ``timeout_s``.

    The FIRST entry per phase uses ``warmup_s`` (default: ``timeout_s``):
    a first step's kernel build and imports legitimately dwarf any sane
    collective timeout, and a watchdog that shoots a warming worker would be
    the fault it exists to contain. ``thread=False`` builds the
    deterministic unit-test form: no thread, expiry checked by explicit
    :meth:`check` calls."""

    def __init__(
        self,
        timeout_s: float,
        on_expire: Callable[[str], None],
        *,
        warmup_s: Optional[float] = None,
        clock: Callable[[], float] = uclock.MONOTONIC,
        thread: bool = True,
        poll_s: Optional[float] = None,
    ):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.warmup_s = float(warmup_s if warmup_s is not None else timeout_s)
        self.on_expire = on_expire
        self._clock = clock
        self._lock = threading.Lock()
        self._depth = 0
        self._deadline: Optional[float] = None
        self._phase: Optional[str] = None
        self._warmed: set = set()
        self.fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if thread:
            self._thread = threading.Thread(
                target=self._poll_loop,
                args=(poll_s or max(min(self.timeout_s / 4.0, 0.25), 0.01),),
                name="omldm-hang-watchdog",
                daemon=True,
            )
            self._thread.start()

    def _poll_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            self.check()

    def check(self, now: Optional[float] = None) -> bool:
        """Fire ``on_expire`` (once) when the armed deadline has passed;
        returns whether it fired."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.fired or self._deadline is None or now < self._deadline:
                return False
            self.fired = True
            phase = self._phase or "?"
        # outside the lock: on_expire typically dumps files and _exits
        self.on_expire(phase)
        return True

    def _arm(self, phase: str) -> None:
        with self._lock:
            self._depth += 1
            allowance = self.timeout_s
            if phase not in self._warmed:
                self._warmed.add(phase)
                allowance = max(self.warmup_s, self.timeout_s)
            self._deadline = self._clock() + allowance
            self._phase = phase

    def _disarm(self) -> None:
        with self._lock:
            self._depth = max(self._depth - 1, 0)
            if self._depth == 0:
                self._deadline = None
                self._phase = None

    def guard(self, phase: str):
        """Re-entrant deadline guard: every entry refreshes the deadline
        (progress resets the clock); the deadline disarms when the
        OUTERMOST guard exits."""
        return _WatchdogGuard(self, phase)

    def rewarm(self) -> None:
        """Re-grant every phase its warm-up allowance. Called when something
        that legitimately warms up again lands mid-stream (a new pipeline
        deployed by a Create): its first step inside an already-warmed
        phase must not read as a hang."""
        with self._lock:
            self._warmed.clear()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._deadline = None


class _WatchdogGuard:
    __slots__ = ("_wd", "_phase")

    def __init__(self, wd: HangWatchdog, phase: str):
        self._wd = wd
        self._phase = phase

    def __enter__(self):
        self._wd._arm(self._phase)
        return self

    def __exit__(self, *exc):
        self._wd._disarm()
        return False


def sigstop_self() -> None:
    """The hang fault injector's trigger: freeze THIS process the way a
    livelocked or priority-inverted worker freezes -- still alive (poll()
    returns None), never beating, never exiting on its own."""
    os.kill(os.getpid(), signal.SIGSTOP)
