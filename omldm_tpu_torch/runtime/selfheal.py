"""The self-healing policy layer: failure classification, slot strikes,
shrink-to-survivors, probed re-expansion, hang watchdogs, kill escalation.

Counterpart of ``omldm_tpu/runtime/selfheal.py``. The reference's failure
story is crash-stop: ``JobTerminator.scala:6-10`` throws and Flink restarts
the whole job with a fixed-delay strategy (Job.scala:14), so one
permanently bad slot burns the restart budget until the job dies. The
supervisors (``runtime.supervisor.DistributedJobSupervisor``,
``runtime.recovery.JobSupervisor``) consume this pure half; the fleet's
workers arm its hang watchdog.

- :func:`classify_exception` -- the failure taxonomy: ``crash`` (a failure
  after the attempt had made progress), ``hang`` (a timeout shape) and
  ``launch`` (an attempt that failed before processing a single event).
- :func:`classify_failure` -- the same taxonomy for a process, from its exit
  code and heartbeat (the sharded ingest plane's parser workers,
  ``runtime.ingest_shard``), with ``HANG_EXIT``, the exit code a wedged
  slot's watchdog uses.
- :class:`RestartPolicy` -- exponential backoff (Flink's fixed delay is
  ``growth=1``) with deterministic, seeded jitter.
- :class:`SelfHealPolicy` -- per-slot strike accounting with a
  strike/degrade/probe state machine: ``strike_threshold`` consecutive
  failures blamed on one slot DEGRADE the fleet to the survivors through
  restore-with-rescale; a degraded fleet PROBES back toward the configured
  width, which heals after ``probe_window_s`` of health or re-degrades at
  once. Pure and clock-injectable.
- :class:`HangWatchdog` -- the fleet worker's deadline around group
  collectives: a worker stuck waiting on a killed or stopped peer dumps
  its black box and exits :data:`HANG_EXIT` instead of wedging forever.
- :func:`kill_escalate` -- SIGTERM, a deadline, then SIGKILL, so a stopped
  or wedged worker cannot stall the supervisor's restart path.
- :func:`sigstop_self` -- the hang fault injector's trigger.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

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


# --- slot strikes + degrade/probe state machine -----------------------------


class SelfHealPolicy:
    """Per-slot strike accounting and the degrade/probe state machine.

    Pure and clock-injectable (no I/O, no processes): the supervisor feeds
    it classified failures and poll ticks, it answers with target process
    counts. State:

    - FULL: the fleet runs at ``configured`` width. Each failure strikes
      its blamed slots; a slot reaching ``strike_threshold`` CONSECUTIVE
      strikes joins the bad set and :meth:`note_failure` returns the
      shrink target ``nproc - |newly bad|`` (floored at
      ``min_processes``). Strikes are per slot id and reset on any width
      change (a shrink renumbers the survivors).
    - DEGRADED (``degraded_by > 0``): after ``probe_after_s`` of degraded
      running, :meth:`probe_target` answers the configured width -- the
      supervisor signals a restore-with-rescale back to full.
    - PROBING: a failure inside the probe (before ``probe_window_s`` of
      healthy running since the probe fleet spawned) RE-DEGRADES at once
      (no fresh strike budget for a slot that just proved itself bad);
      ``probe_window_s`` of health HEALS -- strikes and the degraded width
      both clear.

    ``strikes`` survives fleet restarts by living here, in the supervisor
    process, not in any worker."""

    def __init__(
        self,
        strike_threshold: int,
        configured: int,
        *,
        min_processes: int = 1,
        probe_after_s: float = 30.0,
        probe_window_s: float = 10.0,
        clock: Callable[[], float] = uclock.MONOTONIC,
    ):
        if strike_threshold < 1:
            raise ValueError(f"slotStrikes must be >= 1, got {strike_threshold}")
        if min_processes < 1:
            raise ValueError(f"minProcesses must be >= 1, got {min_processes}")
        if configured < min_processes:
            raise ValueError(f"configured width {configured} < minProcesses {min_processes}")
        self.strike_threshold = strike_threshold
        self.configured = configured
        self.min_processes = min_processes
        self.probe_after_s = probe_after_s
        self.probe_window_s = probe_window_s
        self._clock = clock
        self.strikes: Dict[int, int] = {}
        self.degraded_by = 0
        self.probing = False
        self._probe_spawned: Optional[float] = None
        self._degraded_at: Optional[float] = None
        # counters (the supervisor mirrors them into its strike file and
        # decision events)
        self.degrades = 0
        self.probes = 0
        self.probe_failures = 0
        self.heals = 0

    @property
    def degraded(self) -> bool:
        return self.degraded_by > 0

    def snapshot(self) -> dict:
        """JSON-shaped state for the supervisor's strike file."""
        return {
            "strikes": {str(k): v for k, v in self.strikes.items()},
            "degradedBy": self.degraded_by,
            "probing": self.probing,
            "degrades": self.degrades,
            "probes": self.probes,
            "probeFailures": self.probe_failures,
            "heals": self.heals,
        }

    def note_failure(
        self,
        slots: Sequence[int],
        kinds: Optional[Dict[int, str]] = None,
        nproc: Optional[int] = None,
        now: Optional[float] = None,
    ) -> Optional[int]:
        """Charge a classified fleet failure to its blamed slots; returns
        the process count to DEGRADE to, or None (restart at the current
        width through the normal restart policy). ``kinds`` maps slot ->
        failure class (recorded by the caller; the policy treats every
        class the same -- consecutive failures of one slot are the signal,
        whatever their shape)."""
        now = self._clock() if now is None else now
        nproc = self.configured - self.degraded_by if nproc is None else nproc
        if self.probing:
            # a failure inside the probe window: the bad slot is still bad.
            # Re-degrade at once to the width that was healthy -- no fresh
            # strike budget, no restart attempt burned
            self.probing = False
            self._probe_spawned = None
            self.probe_failures += 1
            self._degraded_at = now
            target = max(self.configured - self.degraded_by, self.min_processes)
            return target if target < nproc else None
        if not slots:
            return None
        newly_bad: List[int] = []
        for slot in slots:
            self.strikes[slot] = self.strikes.get(slot, 0) + 1
            if self.strikes[slot] >= self.strike_threshold:
                newly_bad.append(slot)
        if not newly_bad:
            return None
        target = max(nproc - len(newly_bad), self.min_processes)
        if target >= nproc:
            # already at the floor: nothing to shrink away; the restart
            # policy (and its attempt budget) owns this slot
            return None
        self.degraded_by += nproc - target
        self.degrades += 1
        self._degraded_at = now
        # the shrink renumbers every surviving slot: stale per-slot counts
        # would blame the wrong survivors
        self.strikes.clear()
        return target

    def note_healthy_attempt(self) -> None:
        """A fleet attempt ran to clean completion: consecutive-failure
        streaks are over."""
        self.strikes.clear()

    def probe_target(self, nproc: int, now: Optional[float] = None) -> Optional[int]:
        """The width to probe back toward, once the degraded fleet has run
        quietly for ``probe_after_s`` -- or None (hold)."""
        now = self._clock() if now is None else now
        if (not self.degraded or self.probing or nproc >= self.configured
                or self._degraded_at is None or now - self._degraded_at < self.probe_after_s):
            return None
        return self.configured

    def note_probe_signaled(self) -> None:
        """The supervisor wrote the probe's rescale signal: the next
        relaunch is the probe fleet."""
        self.probing = True
        self._probe_spawned = None
        self.probes += 1

    def note_spawn(self, now: Optional[float] = None) -> None:
        """A fleet incarnation spawned; if it is the probe fleet, the probe
        window starts here (not at signal time -- the checkpoint and
        relaunch latency must not eat the window)."""
        if self.probing and self._probe_spawned is None:
            self._probe_spawned = self._clock() if now is None else now

    def tick_healthy(self, now: Optional[float] = None) -> bool:
        """Poll-loop tick while the fleet runs: True exactly once when a
        probe has stayed healthy for ``probe_window_s`` -- the HEAL
        transition (strikes and the degraded width both clear)."""
        if not self.probing or self._probe_spawned is None:
            return False
        now = self._clock() if now is None else now
        if now - self._probe_spawned < self.probe_window_s:
            return False
        self.probing = False
        self._probe_spawned = None
        self.degraded_by = 0
        self.strikes.clear()
        self.heals += 1
        return True


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


# --- supervisor-side kill escalation ----------------------------------------


def kill_escalate(
    procs: Sequence[Any],
    term_deadline_s: float = 5.0,
    *,
    poll_s: float = 0.02,
    clock: Callable[[], float] = uclock.MONOTONIC,
    sleep: Callable[[float], None] = time.sleep,
) -> List[int]:
    """Terminate a fleet: SIGTERM everyone, give the polite ones
    ``term_deadline_s`` to exit, SIGKILL the stragglers, reap everything.
    Returns the indices that needed the SIGKILL.

    The escalation makes the supervisor's restart path hang-safe: SIGTERM
    is only QUEUED for a SIGSTOP'd process (it would stay stopped forever),
    and a worker wedged in a native collective may never run its signal
    handler -- SIGKILL takes both down. ``procs`` are
    ``subprocess.Popen``-shaped (poll/terminate/kill/wait)."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = clock() + max(term_deadline_s, 0.0)
    escalated: List[int] = []
    for i, p in enumerate(procs):
        while p.poll() is None and clock() < deadline:
            sleep(poll_s)
        if p.poll() is None:
            escalated.append(i)
            try:
                p.kill()
            except OSError:
                pass
            p.wait()
    return escalated


def sigstop_self() -> None:
    """The hang fault injector's trigger: freeze THIS process the way a
    livelocked or priority-inverted worker freezes -- still alive (poll()
    returns None), never beating, never exiting on its own."""
    os.kill(os.getpid(), signal.SIGSTOP)
