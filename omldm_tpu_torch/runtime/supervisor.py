"""The fleet supervisor, the fleet's fault injector, and the chaos channels.

Counterpart of ``omldm_tpu/runtime/supervisor.py``. The reference gets
fault tolerance from Flink: the JobManager detects a lost TaskManager or a
heartbeat loss, applies the restart strategy
(``RestartStrategies.fixedDelayRestart(attempts, delay)``, Job.scala:14),
restores every operator from the latest completed checkpoint and rewinds
the Kafka sources to the checkpointed offsets.

:class:`DistributedJobSupervisor` plays the JobManager for the fleet
(``runtime.distributed_job``): it launches the N worker processes
(``python -m omldm_tpu_torch.runtime.distributed_job``), watches their exit
codes and heartbeat files, and on a failure kills the whole fleet and
relaunches it with ``--restore true`` under the shared restart policy. On
top of that it classifies failures, strikes bad slots and shrinks the fleet
to the survivors, probes back to full width (``runtime.selfheal``), and
rescales on sustained pressure (:class:`AutoscalePolicy`). It reads files
and waits on processes: it never joins the group and never touches a
device. :func:`supervise_from_flags` is the CLI's ``--supervise``.

Output dedupe: final outputs are emitted once per SUCCESSFUL incarnation.
File sinks are rewritten whole, so restarts dedupe themselves; topic
publication is guarded by ``EMITTED.p<i>`` markers beside the checkpoints
(written after a process publishes, honoured on restore), so a crash
between publication and exit does not publish twice.

The reference's psMessages edge is a Kafka topic (Job.scala:76-87): at least
once, so a message may be duplicated, delayed, reordered or lost.
:class:`ChaosChannel` makes the in-process bridge misbehave that way, and
corrupts payloads on request (a NaN in a shipped parameter vector, or a
1e12 norm explosion), each fate drawn from a seeded RNG, so a schedule is
a pure function of ``(seed, name, call sequence)``: the JAX package's, call
for call (:func:`_chaos_rng` is its ``numpy.random.RandomState`` seeded by
crc32). ``StreamJob`` wraps both directions of its bridge in one when
``JobConfig.chaos`` or ``OMLDM_CHAOS`` holds a spec
(:func:`parse_chaos_spec`), and every pipeline's reliable channel arms.

The spec's burst keys arm :class:`BurstInjector`, the overload plane's
seeded hot-tenant flood: the job feeds it every forecasting record and
handles the tenant-addressed copies it returns.

:class:`ChaosConsumer` makes a Kafka-style consumer misbehave the way a
broker does across restarts and rebalances (drop, duplicate, reorder, and
poisoned record values), on the same seeded schedule; the Kafka route arms
it with ``OMLDM_CHAOS_KAFKA``, the fleet also with ``--kafkaChaos``
(:func:`maybe_chaos_consumer`).

:class:`DistributedFaultInjector` fires faults inside the fleet's real
worker processes (a crash, a torn or lost checkpoint shard, a frozen
worker, a refused launch, a severed file-backed broker), armed from CLI
flags and driven by the drive loops at synchronized pump points;
:data:`RESCALE_EXIT` is the exit code of a fleet that checkpointed to be
relaunched at another process count.

CLI: one command supervises the whole fleet::

    python -m omldm_tpu_torch --supervise true --processes 2 \\
        --requests reqs.jsonl --trainingData train.jsonl \\
        --checkpointDir /ckpts --checkpointEvery 50 \\
        --restartAttempts 3 --restartDelayMs 1000 --heartbeatTimeoutMs 60000
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from omldm_tpu_torch.runtime import events as ev
from omldm_tpu_torch.runtime.codec import EncodedLeaf
from omldm_tpu_torch.runtime.selfheal import (
    CRASH,
    HANG,
    HANG_EXIT,
    LAUNCH,
    RestartPolicy,
    SelfHealPolicy,
    classify_failure,
    kill_escalate,
)
from omldm_tpu_torch.utils import clock as uclock
from omldm_tpu_torch.utils.backoff import with_backoff

# exit code a worker fleet uses to signal "checkpointed and exiting for a
# supervised relaunch at a new process count" (distributed_job's
# _maybe_rescale_exit) -- distinct from failure codes so a restart policy
# does not burn an attempt on a planned rescale
RESCALE_EXIT = 17


# flags the supervisor consumes itself; everything else passes through to
# the workers verbatim
SUPERVISOR_ONLY_FLAGS = {
    "supervise",
    "restartAttempts",
    "restartDelayMs",
    "restartJitterMs",
    "heartbeatTimeoutMs",
    "workerBoot",
    "supervisorDir",
    # pressure-driven autoscaling (AutoscalePolicy knobs)
    "autoscale",
    "minProcesses",
    "maxProcesses",
    "scaleFactor",
    "scaleUpAfterMs",
    "scaleDownAfterMs",
    "scaleCooldownMs",
    "maxRescales",
    # host-plane heartbeat-frame signal thresholds (AutoscalePolicy: serve
    # p99 ms / tenant-imbalance excess treated as CRITICAL)
    "scaleP99Ms",
    "scaleImbalance",
    # the self-healing fleet (runtime/selfheal.SelfHealPolicy knobs)
    "slotStrikes",
    "probeAfterMs",
    "probeWindowMs",
    "restartGrowth",
    "restartSeed",
    "killDeadlineMs",
}

# the module a worker process runs (never a module of the JAX package)
WORKER_MODULE = "omldm_tpu_torch.runtime.distributed_job"


class FleetFailure(RuntimeError):
    """One failed attempt of the supervised fleet (cause + exit code +
    per-slot failure classification, runtime/selfheal.classify_failure)."""

    def __init__(self, cause: str, returncode: int, failed: Sequence[int],
                 kinds: Optional[Dict[int, str]] = None):
        super().__init__(cause)
        self.cause = cause
        self.returncode = returncode
        self.failed = list(failed)
        # slot -> failure class ("crash" | "hang" | "launch"); slots the
        # detection path could not classify default to crash
        self.kinds = dict(kinds or {})

    def kind(self) -> str:
        """The attempt's headline class: hang > launch > crash (a hang
        implicates the fleet's liveness machinery, a launch failure will
        repeat -- both more actionable than a generic crash)."""
        kinds = set(self.kinds.values())
        for k in (HANG, LAUNCH):
            if k in kinds:
                return k
        return CRASH


@dataclasses.dataclass
class AttemptRecord:
    """One detected fleet failure (the supervisor's incident log)."""

    attempt: int  # 1-based attempt index that failed
    cause: str  # "process 1 exited 3" | "heartbeat timeout on process 0"
    failed: List[int]  # process ids implicated
    at: float
    restored: bool  # whether a checkpoint existed to restore from
    kind: str = CRASH  # headline failure class (crash | hang | launch)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclasses.dataclass
class RescaleRecord:
    """One fleet rescale (the supervisor's scaling log): autoscale pressure
    decisions and self-heal re-expansion probes both land here (probes ride
    the same signal file, cooldown and maxRescales budget)."""

    from_procs: int
    to_procs: int
    level: int  # folded fleet pressure level that drove the decision
    at: float
    cause: str = "pressure"  # "pressure" (autoscale) | "probe" (self-heal)


class _FleetRescaled(RuntimeError):
    """Internal control flow: the fleet checkpointed and exited with
    RESCALE_EXIT; relaunch at ``target`` processes (not a failure)."""

    def __init__(self, target: int, level: int):
        super().__init__(f"fleet rescaling to {target} processes")
        self.target = target
        self.level = level


@dataclasses.dataclass
class DegradeRecord:
    """One shrink-to-survivors transition (the supervisor's healing log)."""

    from_procs: int
    to_procs: int
    slots: List[int]  # the struck-out slot ids (pre-shrink numbering)
    kind: str  # headline failure class that struck them out
    at: float


class AutoscalePolicy:
    """Pure pressure -> target-process-count policy (injectable clock, no
    I/O).

    The input is the FOLDED fleet pressure level at each supervisor poll
    (the max over worker heartbeats: 0 OK / 1 ELEVATED / 2 CRITICAL, the
    overload plane's ladder). Sustained CRITICAL for ``up_after_s`` scales
    out by ``scale_factor`` (bounded by ``max_processes``); sustained OK
    for ``down_after_s`` scales back in (floored at ``min_processes``).
    ELEVATED holds steady -- the worker-local degradation ladder owns that
    band. ``cooldown_s`` after each rescale gives the relaunched fleet time
    to drain the backlog it inherited before the next decision; sustain
    streaks reset across rescales and restarts (a fresh incarnation's
    pressure must re-prove itself).

    Host-plane signals: worker heartbeat frames carry more than the level
    (``serveP99`` ms, ``imbalance`` fair-share excess, ``backlog`` rows --
    :meth:`DistributedJobSupervisor.fleet_signals` folds them). With
    ``serve_p99_critical_ms`` / ``imbalance_critical`` armed (> 0, off by
    default), :meth:`decide` treats a folded signal at or over its
    threshold as CRITICAL pressure even when the backlog level reads OK."""

    def __init__(self, *, min_processes: int = 1, max_processes: int = 8,
                 scale_factor: int = 2, up_after_s: float = 1.0, down_after_s: float = 5.0,
                 cooldown_s: float = 2.0, serve_p99_critical_ms: float = 0.0,
                 imbalance_critical: float = 0.0):
        if min_processes < 1:
            raise ValueError(f"minProcesses must be >= 1, got {min_processes}")
        if max_processes < min_processes:
            raise ValueError(f"maxProcesses {max_processes} < minProcesses {min_processes}")
        if scale_factor < 2:
            raise ValueError(f"scaleFactor must be >= 2, got {scale_factor}")
        if serve_p99_critical_ms < 0:
            raise ValueError(
                f"serve_p99_critical_ms must be >= 0, got {serve_p99_critical_ms}")
        if imbalance_critical < 0:
            raise ValueError(f"imbalance_critical must be >= 0, got {imbalance_critical}")
        self.min_processes = min_processes
        self.max_processes = max_processes
        self.scale_factor = scale_factor
        self.up_after_s = up_after_s
        self.down_after_s = down_after_s
        self.cooldown_s = cooldown_s
        self.serve_p99_critical_ms = serve_p99_critical_ms
        self.imbalance_critical = imbalance_critical
        self._crit_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._last_rescale: Optional[float] = None

    def reset(self) -> None:
        """Forget sustain streaks (a fleet (re)launch: fresh evidence)."""
        self._crit_since = None
        self._calm_since = None

    def note_rescaled(self, now: float) -> None:
        self._last_rescale = now
        self.reset()

    def effective_level(self, level: int, signals: Optional[Dict[str, float]] = None) -> int:
        """Fold the heartbeat-frame host signals into the pressure level: an
        armed threshold at or over its limit reads as CRITICAL. UNKNOWN
        (< 0) stays unknown -- signals only exist once somebody beat."""
        if level < 0 or not signals:
            return level
        if (self.serve_p99_critical_ms > 0
                and signals.get("serveP99", 0.0) >= self.serve_p99_critical_ms):
            return 2
        if self.imbalance_critical > 0 and signals.get("imbalance", 0.0) >= self.imbalance_critical:
            return 2
        return level

    def decide(self, nproc: int, level: int, now: float,
               signals: Optional[Dict[str, float]] = None) -> Optional[int]:
        """The target process count to rescale to, or None (hold).
        ``level < 0`` means UNKNOWN (no pressure evidence yet -- a fleet
        still starting): both streaks clear and nothing fires. ``signals``
        is the folded heartbeat-frame dict; armed host-signal thresholds
        raise the effective level to CRITICAL (:meth:`effective_level`)."""
        level = self.effective_level(level, signals)
        if level < 0:
            self._crit_since = None
            self._calm_since = None
            return None
        if level >= 2:
            self._calm_since = None
            if self._crit_since is None:
                self._crit_since = now
        elif level <= 0:
            self._crit_since = None
            if self._calm_since is None:
                self._calm_since = now
        else:
            self._crit_since = None
            self._calm_since = None
        if self._last_rescale is not None and now - self._last_rescale < self.cooldown_s:
            return None
        if (self._crit_since is not None and now - self._crit_since >= self.up_after_s
                and nproc < self.max_processes):
            return min(nproc * self.scale_factor, self.max_processes)
        if (self._calm_since is not None and now - self._calm_since >= self.down_after_s
                and nproc > self.min_processes):
            return max(nproc // self.scale_factor, self.min_processes)
        return None


class DistributedJobSupervisor:
    """Run the N-process fleet under a restart policy.

    ``worker_args`` is the job's flag list WITHOUT the per-process plumbing
    (``--processes/--processId/--coordinator/--restore`` are added per
    attempt; a fresh coordinator port is drawn each time so a dying fleet's
    socket never blocks its successor). ``worker_cmd`` overrides the
    interpreter command prefix (default ``python -m
    omldm_tpu_torch.runtime.distributed_job``) -- tests use it to install
    the file-backed Kafka fake inside real subprocesses.

    The supervisor reads files and waits on processes: it never joins the
    workers' process group and never touches a device (a worker's
    ``--device`` passes through to it). A worker that cannot reach its
    device exits nonzero, and that is a failure like any other.

    Restart policy: ``max_restarts`` relaunches at ``restart_delay_s``
    backing off by ``restart_growth`` (+ seeded jitter), Flink's
    fixedDelayRestart at growth 1.0. Restarts pass ``--restore true``: with
    a ``--checkpointDir`` in ``worker_args`` the fleet resumes from the
    newest consistent snapshot and replays the source from its cursor;
    without one (or before the first snapshot) the relaunch is a fresh run.

    Health channels: a worker exiting nonzero fails the attempt at once.
    With ``heartbeat_timeout_s > 0`` the supervisor also passes each worker
    ``--heartbeatDir`` and fails the attempt when a live worker's beat goes
    stale -- a worker blocked in a collective whose peer died may never
    exit on its own. A worker's clock starts at its spawn.

    Autoscaling (an :class:`AutoscalePolicy`): the supervisor folds the
    fleet's pressure level (each worker's heartbeat carries its
    window-peak overload level) at every poll. A sustained decision writes
    the target count into the ``RESCALE`` signal file; the workers agree on
    it over their group at the next synchronized pump point, snapshot the
    consistent cut and exit :data:`RESCALE_EXIT`; the supervisor relaunches
    at the new ``--processes`` with ``--restore`` (restore-with-rescale
    redistributes the snapshot), WITHOUT consuming a restart attempt.
    Requires a ``--checkpointDir``; the cumulative count reaches the
    workers' Statistics through ``--rescaleCount``.

    Self-healing (a :class:`~omldm_tpu_torch.runtime.selfheal.SelfHealPolicy`,
    ``--slotStrikes``): every FleetFailure is CLASSIFIED (a crash exit, a
    heartbeat-silent hang, a never-beat launch failure; survivors'
    HANG_EXITs blame the wedged peer) and charged to its slots;
    ``strike_threshold`` consecutive failures of one slot DEGRADE the fleet
    to the survivors through the restore-with-rescale relaunch -- a DEGRADE
    event, no restart attempt charged. While degraded the supervisor PROBES
    back toward the configured width through the RESCALE signal file; a
    probe healthy for the probe window clears the strikes, a failed probe
    re-degrades at once. Fleet kills escalate SIGTERM -> SIGKILL after
    ``kill_deadline_s``, so a SIGSTOP'd worker cannot stall the restart
    path.
    """

    def __init__(
        self,
        worker_args: Sequence[str],
        num_processes: int,
        *,
        max_restarts: int = 3,
        restart_delay_s: float = 0.0,
        restart_jitter_s: float = 0.0,
        heartbeat_timeout_s: float = 0.0,
        worker_cmd: Optional[Sequence[str]] = None,
        env: Optional[Dict[str, str]] = None,
        cwd: Optional[str] = None,
        run_dir: Optional[str] = None,
        poll_interval_s: float = 0.05,
        autoscale: Optional[AutoscalePolicy] = None,
        max_rescales: int = 32,
        blackbox_dir: Optional[str] = None,
        selfheal: Optional[SelfHealPolicy] = None,
        restart_growth: float = 2.0,
        restart_seed: Optional[int] = None,
        kill_deadline_s: float = 5.0,
        clock=None,
        wall=None,
    ):
        # injectable clocks (utils/clock.py): ``clock`` paces the monotonic
        # policy windows (autoscale sustain, self-heal probes), ``wall``
        # stamps what crosses processes (beat-file ages, incident floors)
        self._clock = uclock.resolve(clock, uclock.MONOTONIC)
        self._wall = uclock.resolve(wall, uclock.WALL)
        if num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {num_processes}")
        self.worker_args = list(worker_args)
        self.nproc = num_processes
        self.max_restarts = max_restarts
        self.restart_delay_s = restart_delay_s
        self.restart_jitter_s = restart_jitter_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.worker_cmd = list(worker_cmd or [sys.executable, "-m", WORKER_MODULE])
        self.env = env
        self.cwd = cwd
        self.poll_interval_s = poll_interval_s
        self._own_run_dir = run_dir is None
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="omldm-supervise-")
        os.makedirs(self.run_dir, exist_ok=True)
        self.hb_dir = os.path.join(self.run_dir, "heartbeats")
        self.failures: List[AttemptRecord] = []
        self.autoscale = autoscale
        self.max_rescales = max_rescales
        self.rescales: List[RescaleRecord] = []
        self.degrades: List[DegradeRecord] = []
        # self-healing: classified slot strikes + shrink-to-survivors +
        # probed re-expansion. None = the plain restart behaviour
        self.selfheal = selfheal
        # restart backoff (the shared RestartPolicy), derived from these
        # attributes at run() time so pre-run mutation keeps working
        self.restart_growth = restart_growth
        self.restart_seed = restart_seed
        self.kill_deadline_s = kill_deadline_s
        # flight recorder: with a black-box directory (the --blackboxPath
        # the workers dump their rings into) the supervisor keeps its OWN
        # decision journal and gathers the worker dumps and that journal
        # into one incident bundle on every failure, rescale and degrade,
        # and at the end of the run. None = no recorder object
        self.blackbox_dir = blackbox_dir
        self.journal = None
        self.bundles: List[str] = []
        # set after a fleet failure; the relaunched fleet's first heartbeat
        # records a HEAL event closing the restart window
        self._heal_pending = False
        # dumps older than this run never enter a bundle (a reused
        # black-box directory)
        self._blackbox_floor = self._wall()
        if blackbox_dir:
            self.journal = ev.EventJournal(cap=1024, pid="sup", path=blackbox_dir)
        if autoscale is not None and not self._checkpoint_root():
            # a rescale relaunch without a checkpoint would lose all state:
            # refuse at construction, not mid-burst
            raise ValueError("autoscale requires --checkpointDir in the worker args "
                             "(rescale relaunches restore from the latest snapshot)")
        if selfheal is not None and not self._checkpoint_root():
            raise ValueError("slotStrikes requires --checkpointDir in the worker args "
                             "(shrink-to-survivors restores the snapshot across the "
                             "surviving process count)")

    def _log(self, msg: str) -> None:
        print(f"[supervisor] {msg}", file=sys.stderr, flush=True)

    def _record(self, kind: str, cause: str, **fields) -> None:
        if self.journal is not None:
            self.journal.record(kind, cause, **fields)

    def gather_incident(self, reason: str) -> Optional[str]:
        """Gather the workers' black-box ring dumps plus the supervisor's
        own decision log into ONE incident bundle (the fleet timeline,
        merge-sorted on the transport stamps; runtime/events.py). Called on
        every fleet failure, rescale and degrade, and at run end; returns
        the bundle path, or None when no black box is armed."""
        if not self.blackbox_dir or self.journal is None:
            return None
        streams = ev.gather_blackbox(self.blackbox_dir, min_mtime=self._blackbox_floor)
        if self.journal.events:
            streams.append(self.journal.tail())
        path = ev.write_bundle(
            os.path.join(self.blackbox_dir, f"incident-{len(self.bundles)}.json"),
            streams,
            meta={"reason": reason, "processes": self.nproc, "restarts": len(self.failures),
                  "rescales": len(self.rescales), "degrades": len(self.degrades)},
        )
        if path is not None:
            self.bundles.append(path)
        return path

    # --- one attempt -------------------------------------------------------

    def _worker_argv(self, pid: int, port: int, restore: bool) -> List[str]:
        args = list(self.worker_cmd) + list(self.worker_args)
        args += ["--processes", str(self.nproc), "--processId", str(pid)]
        if self.nproc > 1:
            args += ["--coordinator", f"127.0.0.1:{port}"]
        if restore:
            args += ["--restore", "true"]
        if self._beats_armed():
            args += ["--heartbeatDir", self.hb_dir]
        if self._signal_armed():
            args += ["--rescaleSignalDir", self.run_dir,
                     "--rescaleCount", str(len(self.rescales))]
        if self.selfheal is not None:
            # the degraded-width gauge rides to Statistics and the report as
            # --rescaleCount does: slots this LAUNCH is short of the
            # configured width (a probe fleet launches at full width: 0)
            args += ["--fleetDegraded", str(max(self.selfheal.configured - self.nproc, 0))]
        return args

    def _beats_armed(self) -> bool:
        # the heartbeat files are the pressure channel AND the failure
        # classification channel (launch = never beat, hang = silent), so
        # the autoscaler and the self-heal policy arm them without a timeout
        return (self.heartbeat_timeout_s > 0 or self.autoscale is not None
                or self.selfheal is not None)

    def _signal_armed(self) -> bool:
        # the RESCALE signal file has two writers: autoscale decisions and
        # self-heal re-expansion probes
        return self.autoscale is not None or self.selfheal is not None

    def _checkpoint_root(self) -> Optional[str]:
        root = None
        for i, arg in enumerate(self.worker_args):
            if arg == "--checkpointDir" and i + 1 < len(self.worker_args):
                root = self.worker_args[i + 1]
        return root

    def _signal_path(self) -> str:
        return os.path.join(self.run_dir, "RESCALE")

    def _read_signal(self) -> int:
        """Target count in the standing signal file (0 = none or garbled)."""
        try:
            with open(self._signal_path()) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _beat_path(self, pid: int) -> str:
        return os.path.join(self.hb_dir, f"proc{pid}.hb")

    def _beat_age(self, pid: int, spawned_at: float, now: float) -> float:
        # wall clock throughout: beat files only expose epoch mtimes
        try:
            return now - os.path.getmtime(self._beat_path(pid))
        except OSError:
            return now - spawned_at  # no beat yet: the clock runs from spawn

    def _beat_frame(self, pid: int) -> Optional[Dict[str, float]]:
        """This worker's last heartbeat METRICS FRAME: ``{"level",
        "serveP99", "imbalance", "backlog", "events", "alerts"}``. The file
        body is ``<epoch> <level> [key=value ...]``
        (distributed_job._heartbeat); a two-token beat parses with zero
        signals, a bare-epoch or torn beat reads level 0 (never a crash).
        None when the worker has not beaten yet."""
        try:
            with open(self._beat_path(pid)) as f:
                parts = f.read().split()
        except OSError:
            return None
        frame = {"level": 0.0, "serveP99": 0.0, "imbalance": 0.0,
                 "backlog": 0.0, "events": 0.0, "alerts": 0.0}
        try:
            if len(parts) > 1:
                frame["level"] = float(parts[1])
        except ValueError:
            return frame  # torn or garbled: level 0, no signals
        for token in parts[2:]:
            key, sep, value = token.partition("=")
            if not sep or key not in frame:
                continue
            try:
                frame[key] = float(value)
            except ValueError:
                pass  # one torn token must not discard the rest
        return frame

    def _beat_level(self, pid: int) -> Optional[int]:
        """This worker's last pressure level (None before its first beat)."""
        frame = self._beat_frame(pid)
        return None if frame is None else int(frame["level"])

    def fleet_pressure(self) -> int:
        """The folded fleet pressure level: the max over every worker's
        heartbeat-reported window peak. -1 while NO worker has beaten yet --
        a starting fleet reads as unknown, not calm, or the scale-in streak
        would start during start-up."""
        levels = [lvl for lvl in (self._beat_level(pid) for pid in range(self.nproc))
                  if lvl is not None]
        return max(levels) if levels else -1

    def fleet_signals(self) -> Optional[Dict[str, float]]:
        """The folded heartbeat-frame signals across the fleet: the worst
        serve p99 and imbalance (max), the total backlog (sum), the worst
        level. None while no worker has beaten yet."""
        frames = [f for f in (self._beat_frame(pid) for pid in range(self.nproc))
                  if f is not None]
        if not frames:
            return None
        return {
            "level": max(f["level"] for f in frames),
            "serveP99": max(f["serveP99"] for f in frames),
            "imbalance": max(f["imbalance"] for f in frames),
            "backlog": sum(f["backlog"] for f in frames),
        }

    def _kill_fleet(self, procs: List[subprocess.Popen]) -> None:
        # SIGTERM -> deadline -> SIGKILL: a SIGSTOP'd or natively wedged
        # worker never honours SIGTERM
        escalated = kill_escalate(procs, self.kill_deadline_s)
        if escalated:
            self._log("process " + ", ".join(map(str, escalated))
                      + " ignored SIGTERM (stopped/wedged); escalated to SIGKILL")

    def _ever_beat(self, pid: int) -> Optional[bool]:
        """Whether this worker beat at least once THIS attempt (the
        heartbeat dir is wiped at every attempt start). None when beats are
        unarmed -- launch and crash are then indistinguishable."""
        if not self._beats_armed():
            return None
        return os.path.exists(self._beat_path(pid))

    def _classify_exits(self, codes: List[Optional[int]], bad: List[int]) -> FleetFailure:
        """The classified FleetFailure for bad exit codes. HANG_EXIT is a
        VICTIM's code ("my peer is wedged; I refuse to block forever"):
        when every bad exit is a HANG_EXIT and some process is still alive,
        the blame lands on the live (wedged) processes, not the honest
        survivors."""
        live = [i for i, rc in enumerate(codes) if rc is None]
        hang_exits = [i for i in bad if codes[i] == HANG_EXIT]
        if hang_exits and len(hang_exits) == len(bad) and live:
            return FleetFailure(
                "process " + ", ".join(f"{i} exited HANG_EXIT" for i in hang_exits)
                + "; blaming wedged process " + ", ".join(map(str, live)),
                returncode=HANG_EXIT, failed=live, kinds={i: HANG for i in live})
        kinds = {i: classify_failure(returncode=codes[i], ever_beat=self._ever_beat(i))
                 for i in bad}
        return FleetFailure("process " + ", ".join(f"{i} exited {codes[i]}" for i in bad),
                            returncode=codes[bad[0]], failed=bad, kinds=kinds)

    def _run_attempt(self, restore: bool) -> None:
        """Spawn the fleet and block until success (all exit 0), a detected
        failure (raises :class:`FleetFailure`), or an agreed rescale exit
        (raises :class:`_FleetRescaled` once every worker has exited)."""
        if self._beats_armed():
            shutil.rmtree(self.hb_dir, ignore_errors=True)
            os.makedirs(self.hb_dir, exist_ok=True)
        if self.autoscale is not None:
            self.autoscale.reset()
        ok_codes = (0,) if not self._signal_armed() else (0, RESCALE_EXIT)
        pending_target = 0  # a written-but-not-yet-honoured rescale signal
        decision_level = 0
        port = _free_port()
        spawned_at = self._wall()
        procs = [subprocess.Popen(self._worker_argv(pid, port, restore), env=self.env,
                                  cwd=self.cwd)
                 for pid in range(self.nproc)]
        if self.selfheal is not None:
            # a probe fleet's health window starts at ITS spawn
            self.selfheal.note_spawn(self._clock())
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [i for i, rc in enumerate(codes) if rc is not None and rc not in ok_codes]
                if bad:
                    raise self._classify_exits(codes, bad)
                if all(rc == 0 for rc in codes):
                    return
                if (self._signal_armed() and all(rc is not None for rc in codes)
                        and any(rc == RESCALE_EXIT for rc in codes)):
                    # the fleet checkpointed the agreed cut and exited to be
                    # relaunched at the signalled count
                    raise _FleetRescaled(pending_target or self._read_signal() or self.nproc,
                                         decision_level)
                if self._heal_pending and self._beats_armed():
                    # hb_dir is wiped at attempt start, so any beat file
                    # proves THIS incarnation came up: that is the heal
                    if any(os.path.exists(self._beat_path(i)) for i in range(self.nproc)):
                        self._record(ev.HEAL, "first_heartbeat", attempt=len(self.failures),
                                     processes=self.nproc)
                        self._heal_pending = False
                if self.heartbeat_timeout_s > 0:
                    now = self._wall()
                    stale = [i for i, rc in enumerate(codes)
                             if rc is None
                             and self._beat_age(i, spawned_at, now) > self.heartbeat_timeout_s]
                    if stale:
                        raise FleetFailure(
                            "heartbeat timeout on process " + ", ".join(map(str, stale)),
                            returncode=1, failed=stale, kinds={i: HANG for i in stale})
                if self.selfheal is not None and not pending_target:
                    # probed re-expansion: a degraded fleet that has run
                    # quietly for probeAfterMs is signalled back toward the
                    # configured width (the autoscaler's signal file)
                    mono = self._clock()
                    if self.selfheal.tick_healthy(mono):
                        self._log(f"probe healthy for {self.selfheal.probe_window_s:.1f}s: fleet "
                                  f"healed at {self.nproc} processes; slot strikes cleared")
                        self._record(ev.PROBE, "probe_healthy", processes=self.nproc)
                        self._write_strike_file()
                    target = self.selfheal.probe_target(self.nproc, mono)
                    if len(self.rescales) >= self.max_rescales:
                        # probes ride the rescale budget; once it is spent
                        # the fleet stays at the degraded width
                        target = None
                    if target is not None and target != self.nproc:
                        pending_target = target
                        self.selfheal.note_probe_signaled()
                        self._record(ev.PROBE, "probe_signaled", from_procs=self.nproc,
                                     target=target)
                        with open(self._signal_path(), "w") as f:
                            f.write(str(target))
                        self._log(f"degraded fleet quiet for {self.selfheal.probe_after_s:.1f}s: "
                                  f"probing back {self.nproc} -> {target} processes")
                if self.autoscale is not None and not pending_target:
                    # ONE frame read a worker a poll: the level is folded
                    # inside the signals
                    signals = self.fleet_signals()
                    level = int(signals["level"]) if signals else -1
                    target = self.autoscale.decide(self.nproc, level, self._clock(),
                                                   signals=signals)
                    if target is not None and target != self.nproc:
                        pending_target = target
                        decision_level = self.autoscale.effective_level(level, signals)
                        self._record(ev.SCALE, "pressure_sustained", from_procs=self.nproc,
                                     target=target, level=decision_level)
                        with open(self._signal_path(), "w") as f:
                            f.write(str(target))
                        self._log(f"fleet pressure level {level} sustained: signaling rescale "
                                  f"{self.nproc} -> {target} processes")
                time.sleep(self.poll_interval_s)
        finally:
            self._kill_fleet(procs)

    # --- the restart policy ------------------------------------------------

    def _checkpoint_exists(self) -> bool:
        root = self._checkpoint_root()
        return bool(root) and os.path.exists(os.path.join(root, "LATEST"))

    # --- self-healing: strikes, shrink-to-survivors, probes ---------------

    def _write_strike_file(self) -> None:
        """Persist the strike and degrade state into the run dir (for an
        operator; the policy state itself lives in this process).
        Best-effort."""
        if self.selfheal is None:
            return
        try:
            with open(os.path.join(self.run_dir, "STRIKES"), "w") as f:
                f.write(json.dumps(self.selfheal.snapshot()))
        except OSError:
            pass

    def _note_strikes(self, exc: FleetFailure) -> Optional[int]:
        """Charge a classified fleet failure to its blamed slots; returns the
        shrink-to-survivors target (None = the normal restart policy). Every
        classification is journalled as a STRIKE event."""
        if self.selfheal is None:
            return None
        was_probing = self.selfheal.probing
        if was_probing:
            # a failure with a probe in flight voids the probe: the standing
            # signal must not be honoured by the NEXT incarnation
            try:
                os.unlink(self._signal_path())
            except OSError:
                pass
        target = self.selfheal.note_failure(exc.failed, exc.kinds, self.nproc, self._clock())
        for slot in exc.failed:
            self._record(ev.STRIKE, exc.kinds.get(slot, CRASH), worker=slot,
                         strikes=self.selfheal.strikes.get(slot, 0)
                         or self.selfheal.strike_threshold,
                         error=exc.cause)
        if was_probing and target is not None:
            self._record(ev.PROBE, "probe_failed", target=target, error=exc.cause)
            self._log(f"re-expansion probe failed ({exc.cause}); re-degrading to {target} "
                      "processes immediately")
        self._write_strike_file()
        return target

    def _apply_degrade(self, exc: FleetFailure, target: int) -> None:
        """Commit a shrink-to-survivors: journal the DEGRADE, bundle the dead
        fleet's rings, and relaunch at the survivor count through
        restore-with-rescale -- WITHOUT consuming a restart attempt."""
        self.degrades.append(DegradeRecord(from_procs=self.nproc, to_procs=target,
                                           slots=list(exc.failed), kind=exc.kind(),
                                           at=self._wall()))
        self._log(f"slot {', '.join(map(str, exc.failed))} struck out ({exc.kind()}: "
                  f"{exc.cause}); degrading fleet {self.nproc} -> {target} processes "
                  "(shrink-to-survivors; restore-with-rescale relaunch)")
        self._record(ev.DEGRADE, exc.kind(), from_procs=self.nproc, to_procs=target,
                     slots=list(exc.failed), error=exc.cause)
        # the dead fleet's rings are about to be overwritten by the degraded
        # incarnation's dumps: bundle them now
        self.gather_incident("degrade")
        self.nproc = target
        if self.autoscale is not None:
            # a degrade is a rescale for autoscale pacing
            self.autoscale.note_rescaled(self._clock())
        self._write_strike_file()

    def _apply_rescale(self, rescaled: _FleetRescaled) -> None:
        """Commit a rescale: clear the signal, record the decision, move the
        fleet width, start the cooldown clock."""
        if len(self.rescales) >= self.max_rescales:
            raise FleetFailure(f"autoscale rescale budget exhausted ({self.max_rescales} "
                               "rescales)", returncode=1, failed=[])
        try:
            os.unlink(self._signal_path())
        except OSError:
            pass
        probe = self.selfheal is not None and self.selfheal.probing
        self.rescales.append(RescaleRecord(from_procs=self.nproc, to_procs=rescaled.target,
                                           level=rescaled.level, at=self._wall(),
                                           cause="probe" if probe else "pressure"))
        self._log(f"rescaling fleet {self.nproc} -> {rescaled.target} processes "
                  f"({'re-expansion probe' if probe else 'pressure-driven'}; rescale "
                  f"{len(self.rescales)})")
        self._record(ev.RESCALE, "probe_agreed" if probe else "pressure_driven",
                     from_procs=self.nproc, to_procs=rescaled.target, level=rescaled.level)
        self.gather_incident("rescale")
        self.nproc = rescaled.target
        if self.autoscale is not None:
            self.autoscale.note_rescaled(self._clock())

    def run(self) -> int:
        """Supervise to completion. Returns 0 on success; raises the last
        :class:`FleetFailure` once ``max_restarts`` is exhausted. Rescales
        and degrades relaunch WITHOUT consuming a restart attempt."""
        state = {"first": True}

        def attempt() -> int:
            restore = not state["first"]
            state["first"] = False
            while True:
                if restore:
                    self._log("relaunching fleet" + (
                        " from latest consistent checkpoint" if self._checkpoint_exists()
                        else " fresh (no checkpoint taken before the failure)"))
                try:
                    self._run_attempt(restore=restore)
                    if self.selfheal is not None:
                        # a clean completion ends every failure streak
                        self.selfheal.note_healthy_attempt()
                        self._write_strike_file()
                    return 0
                except _FleetRescaled as rescaled:
                    self._apply_rescale(rescaled)
                    restore = True
                except FleetFailure as exc:
                    # a struck-out slot shrinks the fleet to the survivors
                    # INSTEAD of burning a restart on a width that keeps
                    # failing
                    target = self._note_strikes(exc)
                    if target is None:
                        raise
                    self._apply_degrade(exc, target)
                    restore = True

        def on_retry(exc: Exception, next_attempt: int) -> None:
            record = AttemptRecord(
                attempt=next_attempt - 1, cause=str(exc), failed=getattr(exc, "failed", []),
                at=self._wall(), restored=self._checkpoint_exists(),
                kind=exc.kind() if isinstance(exc, FleetFailure) else CRASH)
            self.failures.append(record)
            self._log(f"fleet failure ({record.kind}: {record.cause}); restart "
                      f"{record.attempt}/{self.max_restarts}")
            self._record(ev.RESTART, "fleet_failure", error=record.cause,
                         failed=list(record.failed), attempt=record.attempt,
                         restored=record.restored, failure_kind=record.kind)
            # the next attempt's first heartbeat closes this restart's heal
            # window (the load harness reads the restart -> heal delta)
            self._heal_pending = True
            # bundle the dead fleet's rings BEFORE the relaunch overwrites them
            self.gather_incident("worker_death")

        restart_policy = RestartPolicy(
            max_restarts=self.max_restarts,
            base_delay_s=self.restart_delay_s,
            growth=self.restart_growth,
            jitter_s=self.restart_jitter_s,
            seed=self.restart_seed,
        )
        try:
            return with_backoff(attempt, policy=restart_policy.backoff(),
                                retry_on=(FleetFailure,), on_retry=on_retry,
                                rng=restart_policy.rng())
        except FleetFailure as exc:
            # the terminal failure is an incident too
            self.failures.append(AttemptRecord(
                attempt=len(self.failures) + 1, cause=exc.cause, failed=exc.failed,
                at=self._wall(), restored=self._checkpoint_exists(), kind=exc.kind()))
            self._log(f"giving up after {len(self.failures)} failed attempt(s): {exc.cause}")
            self._record(ev.RESTART, "restarts_exhausted", error=exc.cause,
                         attempts=len(self.failures))
            raise
        finally:
            # the end-of-run bundle on EVERY exit path: the run an operator
            # most wants a bundle for is the one that did not end cleanly
            self.gather_incident("run_end")
            if self._own_run_dir:
                shutil.rmtree(self.run_dir, ignore_errors=True)


def supervise_from_flags(flags: Dict[str, str]) -> int:
    """CLI adapter: ``--supervise`` turns the launcher process into the
    fleet supervisor (it never joins the group or touches a device). Every
    flag that is not the supervisor's own passes through to every worker.
    Returns the exit code for the CLI; exhausted restarts exit with the
    last failed worker's code."""
    nproc = int(flags.get("processes", "1"))
    worker_args: List[str] = []
    for key, value in flags.items():
        if key in SUPERVISOR_ONLY_FLAGS or key in ("processes", "processId", "coordinator",
                                                   "restore"):
            continue
        worker_args += [f"--{key}", value]
    worker_cmd = None
    if flags.get("workerBoot"):
        # bootstrap code for the worker interpreters (tests install the
        # file-backed Kafka fake before the port's imports resolve)
        worker_cmd = [sys.executable, "-c", flags["workerBoot"]]
    autoscale = None
    if flags.get("autoscale", "").lower() in ("true", "1", "yes", "on"):
        if not flags.get("checkpointDir"):
            raise SystemExit("--autoscale requires --checkpointDir (rescale relaunches "
                             "restore the fleet from the latest snapshot)")
        autoscale = AutoscalePolicy(
            min_processes=int(flags.get("minProcesses", "1")),
            max_processes=int(flags.get("maxProcesses", "8")),
            scale_factor=int(flags.get("scaleFactor", "2")),
            up_after_s=float(flags.get("scaleUpAfterMs", "1000")) / 1000.0,
            down_after_s=float(flags.get("scaleDownAfterMs", "5000")) / 1000.0,
            cooldown_s=float(flags.get("scaleCooldownMs", "2000")) / 1000.0,
            # host-plane heartbeat-frame thresholds (off by default): the
            # fleet's own frames carry serveP99; imbalance reads 0 there
            serve_p99_critical_ms=float(flags.get("scaleP99Ms", "0")),
            imbalance_critical=float(flags.get("scaleImbalance", "0")),
        )
    selfheal = None
    strikes = int(flags.get("slotStrikes", "0") or 0)
    if strikes > 0:
        if not flags.get("checkpointDir"):
            raise SystemExit("--slotStrikes requires --checkpointDir (shrink-to-survivors "
                             "restores the snapshot across the surviving process count)")
        selfheal = SelfHealPolicy(
            strikes, nproc,
            min_processes=int(flags.get("minProcesses", "1")),
            probe_after_s=float(flags.get("probeAfterMs", "30000")) / 1000.0,
            probe_window_s=float(flags.get("probeWindowMs", "10000")) / 1000.0,
        )
    sup = DistributedJobSupervisor(
        worker_args,
        nproc,
        max_restarts=int(flags.get("restartAttempts", "3")),
        restart_delay_s=float(flags.get("restartDelayMs", "0")) / 1000.0,
        restart_jitter_s=float(flags.get("restartJitterMs", "0")) / 1000.0,
        heartbeat_timeout_s=float(flags.get("heartbeatTimeoutMs", "0")) / 1000.0,
        worker_cmd=worker_cmd,
        run_dir=flags.get("supervisorDir"),
        autoscale=autoscale,
        max_rescales=int(flags.get("maxRescales", "32")),
        # the workers dump their journal rings here (the passthrough
        # --blackboxPath); the supervisor gathers them with its own log
        blackbox_dir=flags.get("blackboxPath"),
        selfheal=selfheal,
        # exponential backoff (growth 1.0 is the reference's fixed delay);
        # --restartSeed pins the jitter stream (unset: derived from the pid)
        restart_growth=float(flags.get("restartGrowth", "2.0")),
        restart_seed=int(flags["restartSeed"]) if "restartSeed" in flags else None,
        kill_deadline_s=float(flags.get("killDeadlineMs", "5000")) / 1000.0,
    )
    try:
        return sup.run()
    except FleetFailure as exc:
        return exc.returncode or 1


class DistributedFaultInjector:
    """Flag-driven deterministic fault injection for the multi-process job.

    The single-process :class:`~omldm_tpu_torch.runtime.recovery.FaultInjector`
    patches spokes in-process; the fleet needs faults that fire inside REAL
    worker processes, so this one is armed from CLI flags and driven by the
    drive loops at synchronized pump points:

    - ``--failProcess p --failAfterRecords N``: process ``p`` hard-exits
      (code 3) at the first pump point after ingesting >= N records -- the
      chosen-worker crash (a lost TaskManager).
    - ``--failAfterChunks k``: EVERY process exits after chunk ``k`` (the
      whole-deployment cut used by the checkpoint-resume tests).
    - ``--corruptShardProcess p --corruptShardSeq k`` (+
      ``--corruptShardMode truncate|withhold``): after checkpoint ``k``
      commits, process ``p`` truncates (or deletes) its own proc shard in
      that snapshot -- the torn-write or lost-file disk fault that restore
      must survive by falling back to the previous complete snapshot.
    - ``--hangProcess p --hangAfterChunks k``: process ``p`` SIGSTOPs
      ITSELF at chunk ``k`` -- alive but frozen: never beating, never
      exiting, wedging every peer's next collective. Drives the survivors'
      collective watchdog (HANG_EXIT). One-shot ACROSS incarnations when
      ``--faultStateDir`` names a directory for the marker file (without
      it, every incarnation of process ``p`` hangs again).
    - ``--refuseLaunchProcess p --refuseLaunchCount n``: process ``p``
      hard-exits at injector construction -- before its first heartbeat --
      for the first ``n`` incarnations (counted in ``--faultStateDir``):
      the un-launchable-slot fault.

    All triggers are one-shot and deterministic given a fixed chunk size.
    """

    EXIT_CODE = 3

    def __init__(self, flags: Dict[str, str], pid: int):
        self.pid = pid
        self.fail_process = int(flags.get("failProcess", "-1"))
        self.fail_after_records = int(flags.get("failAfterRecords", "0"))
        self.fail_after_chunks = int(flags.get("failAfterChunks", "0"))
        self.corrupt_process = int(flags.get("corruptShardProcess", "-1"))
        self.corrupt_seq = int(flags.get("corruptShardSeq", "-1"))
        self.corrupt_mode = flags.get("corruptShardMode", "truncate")
        self.sever_after_chunks = int(flags.get("severBrokerAfterChunks", "0"))
        self.hang_process = int(flags.get("hangProcess", "-1"))
        self.hang_after_chunks = int(flags.get("hangAfterChunks", "0"))
        self.refuse_launch_process = int(flags.get("refuseLaunchProcess", "-1"))
        self.refuse_launch_count = int(flags.get("refuseLaunchCount", "0"))
        # cross-incarnation fault state (markers, counters): a relaunched
        # fleet re-runs the injector with the SAME flags, so one-shot faults
        # need disk state to stay one-shot
        self.fault_state_dir = flags.get("faultStateDir", "")
        self.records_seen = 0
        self._severed = False
        self._hung = False

    def note_records(self, n: int) -> None:
        """Count records this process's ingest moved past a pump point."""
        self.records_seen += int(n)

    def _once(self, name: str) -> bool:
        """True exactly once across incarnations (a marker file in the
        fault state dir); without a state dir, True every incarnation."""
        if not self.fault_state_dir:
            return True
        marker = os.path.join(self.fault_state_dir, name)
        try:
            os.makedirs(self.fault_state_dir, exist_ok=True)
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except OSError:
            return False  # marker exists (or undrivable dir): already fired

    def on_launch(self) -> None:
        """Called once at worker startup, BEFORE the first heartbeat: the
        launch-refusal fault exits here, so a supervisor's classifier sees
        a process that died without ever coming up."""
        if self.refuse_launch_process != self.pid or self.refuse_launch_count <= 0:
            return
        counter = os.path.join(self.fault_state_dir or ".", f"refused.p{self.pid}")
        n = 0
        try:
            with open(counter) as f:
                n = int(f.read().strip() or 0)
        except (OSError, ValueError):
            n = 0
        if n >= self.refuse_launch_count:
            return
        try:
            if self.fault_state_dir:
                os.makedirs(self.fault_state_dir, exist_ok=True)
            with open(counter, "w") as f:
                f.write(str(n + 1))
        except OSError:
            pass
        self._die(f"worker {self.pid} refused launch ({n + 1}/{self.refuse_launch_count})")

    def _die(self, why: str) -> None:
        print(f"[fault-injector p{self.pid}] injected crash: {why}", file=sys.stderr,
              flush=True)
        # hard exit, like a SIGKILLed or OOMed worker: no atexit, no flush
        # of in-flight state -- recovery must come from the disk truth
        os._exit(self.EXIT_CODE)

    def on_chunk(self, chunk_idx: int) -> None:
        """Called at every synchronized pump point (after the checkpoint
        cadence ran for this chunk)."""
        if self.fail_after_chunks and chunk_idx + 1 >= self.fail_after_chunks:
            self._die(f"after chunk {chunk_idx + 1} (all processes)")
        if (self.fail_process == self.pid and self.fail_after_records > 0
                and self.records_seen >= self.fail_after_records):
            self._die(f"worker {self.pid} after {self.records_seen} records")
        if (self.sever_after_chunks and chunk_idx + 1 >= self.sever_after_chunks
                and not self._severed and self.pid == 0):
            self._severed = True
            self._sever_broker()
        if (self.hang_process == self.pid and self.hang_after_chunks
                and chunk_idx + 1 >= self.hang_after_chunks and not self._hung
                and self._once(f"hang.p{self.pid}")):
            self._hung = True
            print(f"[fault-injector p{self.pid}] injected hang: SIGSTOP after chunk "
                  f"{chunk_idx + 1} (process stays alive, frozen -- no beats, no exit)",
                  file=sys.stderr, flush=True)
            from omldm_tpu_torch.runtime import selfheal

            selfheal.sigstop_self()

    def on_checkpoint(self, ckpt_dir: str) -> None:
        """Called after a distributed snapshot commits (post-barrier)."""
        if self.corrupt_process != self.pid or self.corrupt_seq < 0:
            return
        try:
            seq = int(os.path.basename(ckpt_dir).split("-", 1)[1])
        except (IndexError, ValueError):
            return
        if seq != self.corrupt_seq:
            return
        shard = os.path.join(ckpt_dir, f"proc{self.pid}.npz")
        self.corrupt_seq = -1  # one-shot
        if self.corrupt_mode == "withhold":
            os.unlink(shard)
            verb = "withheld"
        else:
            size = os.path.getsize(shard)
            with open(shard, "r+b") as f:
                f.truncate(max(size // 2, 1))
            verb = f"truncated to {max(size // 2, 1)}B"
        print(f"[fault-injector p{self.pid}] {verb} checkpoint shard {shard}",
              file=sys.stderr, flush=True)

    def _sever_broker(self) -> None:
        broker = os.environ.get("FSKAFKA_DIR")
        if broker and os.path.isdir(broker):
            os.rename(broker, broker + ".severed")
            # leave a plain FILE at the broker path: consumers list no
            # partitions (permanently idle) and producer appends raise -- a
            # dead broker, not a fresh empty one the next send recreates
            with open(broker, "w"):
                pass
            print(f"[fault-injector p{self.pid}] severed file-backed broker {broker}",
                  file=sys.stderr, flush=True)
        else:
            print(f"[fault-injector p{self.pid}] severBroker requested but no file-backed "
                  "broker to sever (FSKAFKA_DIR unset)", file=sys.stderr, flush=True)


_CHAOS_PARAMS = ("drop", "dup", "reorder", "delay")
# corruption (poison) fault classes -- distinct from the loss classes
# above: the message ARRIVES, but its content is hostile. ``nan`` plants a
# NaN in a shipped parameter vector, ``explode`` scales it past any sane
# norm, ``poison`` (record streams only) mutates a source record into
# malformed/non-finite input. These drive the model-integrity guard's
# detection/rollback/quarantine paths the way drop/dup drive the reliable
# channel. Probability draws happen ONLY when a corruption class is armed,
# so pre-existing specs keep their exact seeded schedules.
_CHAOS_CORRUPT = ("nan", "explode", "poison")

# burst / hot-tenant injector keys (channel-wide, not per-direction): the
# overload-control plane's fault injectors. ``burst=K`` amplifies every
# forecasting record inside the window [burstFrom, burstFrom+burstLen)
# (counted in FORECAST records) into K copies, the K-1 extras
# tenant-addressed at ``hotTenant`` -- a deterministic traffic flood at
# one tenant that the fair-share admission must absorb without degrading
# its gang siblings.
_CHAOS_BURST = ("burst", "burstFrom", "burstLen", "hotTenant")


def parse_chaos_spec(spec: Optional[str]) -> Optional[Dict]:
    """Parse a chaos spec string into ``{seed, window, up: {...}, down:
    {...}, burst...}``.

    Format: comma-separated ``key=value`` pairs. ``seed`` and ``window``
    are channel-wide; ``drop``/``dup``/``reorder``/``delay`` (loss
    classes) and ``nan``/``explode``/``poison`` (corruption classes) are
    probabilities applied to BOTH directions unless prefixed
    (``up.drop=0.1`` hits only worker->hub, ``down.dup=0.05`` only
    hub->worker); ``burst``/``burstFrom``/``burstLen``/``hotTenant`` arm
    the hot-tenant burst injector (channel-wide ints). Returns None for
    an empty/None spec; raises ValueError on unknown keys so a typo'd
    flag fails loudly instead of running fault-free."""
    if not spec:
        return None
    base = {k: 0.0 for k in _CHAOS_PARAMS + _CHAOS_CORRUPT}
    out: Dict = {"seed": 0, "window": 4, "up": dict(base), "down": dict(base),
                 "burst": 0, "burstFrom": 0, "burstLen": 1 << 31,
                 "hotTenant": 0}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        value = value.strip() or "0"
        if key in ("seed", "window") or key in _CHAOS_BURST:
            out[key] = int(float(value))
        elif "." in key:
            direction, _, param = key.partition(".")
            if direction not in ("up", "down") or param not in (
                _CHAOS_PARAMS + _CHAOS_CORRUPT
            ):
                raise ValueError(f"unknown chaos key {key!r}")
            out[direction][param] = float(value)
        elif key in _CHAOS_PARAMS + _CHAOS_CORRUPT:
            out["up"][key] = out["down"][key] = float(value)
        else:
            raise ValueError(f"unknown chaos key {key!r}")
    return out


def _corrupt_payload(payload, mode: str, rng):
    """A corrupted COPY of a protocol payload, or None when the payload
    carries nothing corruptible (control votes, NACKs, raw-data forwards --
    corrupting those would test the wrong layer). ``nan`` plants a NaN at
    a seeded position of the shipped parameter vector; ``explode`` scales
    the vector by 1e12, far past any configured guard norm limit.
    Codec-encoded params (``EncodedLeaf``) corrupt too -- the on-wire form
    is exactly what a real fault would hit, and skipping it would make
    ``nan``/``explode`` silently inert on codec-armed pipelines. The
    original payload object is never mutated (the sender may hold
    references)."""

    def corrupt_vec(vec):
        vec = vec.copy()
        flat = vec.ravel()
        if mode == "nan":
            flat[int(rng.randint(flat.size))] = np.nan
        else:  # explode
            flat *= np.float32(1e12)
        return vec

    def corrupt_leaf(leaf):
        if leaf.kind == "fp16":
            data = leaf.data.copy()
            if mode == "nan":
                data.ravel()[int(rng.randint(data.size))] = np.float16(np.nan)
            else:  # fp16 max is 65504: a big scale overflows to inf
                data = data * np.float16(1e4) * np.float16(1e4)
            meta = leaf.meta
        elif leaf.kind == "int8":
            # uint8 codes can't hold a NaN; corrupt the affine meta so the
            # DECODE goes non-finite/exploded -- the receiver-side shape of
            # the same fault
            data = leaf.data
            scale, zero = leaf.meta
            meta = (
                (np.float32(np.nan), zero) if mode == "nan"
                else (np.float32(1e12), zero)
            )
        elif leaf.kind == "topk":
            idx, val = leaf.data
            if val.size == 0:
                return None
            data = (idx, corrupt_vec(val))
            meta = leaf.meta
        else:
            return None
        return EncodedLeaf(
            leaf.kind, data, meta, leaf.shape, leaf.dtype, leaf.stream,
            leaf.seq,
        )

    def corrupt_any(value):
        if (
            isinstance(value, np.ndarray)
            and value.dtype.kind == "f"
            and value.size
        ):
            return corrupt_vec(value)
        if isinstance(value, EncodedLeaf):
            return corrupt_leaf(value)
        return None

    corrupted = corrupt_any(payload)
    if corrupted is not None:
        return corrupted
    if isinstance(payload, dict):
        params = corrupt_any(payload.get("params"))
        if params is not None:
            out = dict(payload)
            out["params"] = params
            return out
    return None


def _chaos_rng(seed: int, name: str):
    # stable per-channel stream: python's hash() is salted per process,
    # crc32 is not -- same (seed, name) => same schedule, everywhere
    return np.random.RandomState(
        (int(seed) ^ zlib.crc32(name.encode())) & 0x7FFFFFFF
    )


class ChaosChannel:
    """Seeded lossy wrapper around a deliver callable (the in-process
    hub<->spoke bridge).

    Every :meth:`send` draws an independent fate per fault class from the
    channel's private RNG, so the drop/dup/reorder/delay schedule is a pure
    function of ``(seed, name, call sequence)`` -- deterministic, replayable,
    assertable. Held messages (reordered / delayed / duplicate copies)
    release after 1..window subsequent sends pass, preserving bounded
    reordering. ``quiesce()`` ends the fault window: held traffic flushes
    and later sends pass through untouched (stream-end must not eat final
    state pushes)."""

    def __init__(
        self,
        deliver,
        *,
        seed: int = 0,
        drop: float = 0.0,
        dup: float = 0.0,
        reorder: float = 0.0,
        delay: float = 0.0,
        nan: float = 0.0,
        explode: float = 0.0,
        poison: float = 0.0,  # record-stream class; inert on the bridge
        window: int = 4,
        name: str = "chan",
    ):
        self._deliver = deliver
        self._rng = _chaos_rng(seed, name)
        self.drop = float(drop)
        self.dup = float(dup)
        self.reorder = float(reorder)
        self.delay = float(delay)
        # payload corruption, the faults the model-integrity guard meets:
        # the message still arrives, but its parameter vector carries a
        # seeded NaN or a 1e12 norm explosion. Fate draws happen ONLY when
        # a corruption class is armed, so loss-only specs keep their exact
        # seeded schedules.
        self.nan = float(nan)
        self.explode = float(explode)
        self.window = max(int(window), 1)
        self.name = name
        self.active = True
        self._held: List[list] = []  # [countdown, args]
        self.sent = 0
        self.delivered = 0
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.corrupted = 0

    @classmethod
    def from_spec(cls, deliver, spec: Dict, direction: str, name: str = ""):
        return cls(
            deliver,
            seed=spec["seed"],
            window=spec["window"],
            name=name or direction,
            **spec[direction],
        )

    def send(self, *args) -> None:
        self.sent += 1
        if not self.active:
            self.delivered += 1
            self._deliver(*args)
            return
        if self.nan > 0.0 or self.explode > 0.0:
            # (net, hub, worker, op, payload, seq) on both directions:
            # payload rides at index 4
            u_nan, u_explode = self._rng.random_sample(2)
            mode = (
                "nan" if u_nan < self.nan
                else "explode" if u_explode < self.explode
                else None
            )
            if mode is not None and len(args) > 4:
                corrupted = _corrupt_payload(args[4], mode, self._rng)
                if corrupted is not None:
                    args = args[:4] + (corrupted,) + args[5:]
                    self.corrupted += 1
        u_drop, u_dup, u_reorder, u_delay = self._rng.random_sample(4)
        if u_drop < self.drop:
            self.dropped += 1
        elif u_reorder < self.reorder or u_delay < self.delay:
            self._held.append([int(self._rng.randint(1, self.window + 1)), args])
            self.reordered += 1
        else:
            self.delivered += 1
            self._deliver(*args)
        if u_dup < self.dup:
            # the duplicate copy arrives LATE (held like a reordered
            # message): receivers must survive out-of-order duplicates,
            # not just back-to-back ones
            self._held.append([int(self._rng.randint(1, self.window + 1)), args])
            self.duplicated += 1
        self._tick()

    def _tick(self) -> None:
        for h in self._held:
            h[0] -= 1
        # pop-one-at-a-time: delivering may recurse into send() and mutate
        # the queue (in-process routing is synchronous)
        while True:
            due = next((h for h in self._held if h[0] <= 0), None)
            if due is None:
                return
            self._held.remove(due)
            self.delivered += 1
            self._deliver(*due[1])

    def flush(self) -> None:
        """Deliver everything held, in hold order."""
        while self._held:
            _, args = self._held.pop(0)
            self.delivered += 1
            self._deliver(*args)

    def quiesce(self) -> None:
        """End the fault window (stream end / termination probe)."""
        self.active = False
        self.flush()

    def counters(self) -> Dict[str, int]:
        return {
            "sent": self.sent,
            "delivered": self.delivered,
            "dropped": self.dropped,
            "duplicated": self.duplicated,
            "reordered": self.reordered,
            "corrupted": self.corrupted,
        }


class BurstInjector:
    """Seeded hot-tenant burst injector (the overload plane's fault
    injector): inside a window counted in forecasting records, every
    forecast gains ``factor - 1`` TENANT-ADDRESSED copies
    (``metadata.tenant``) that flood one pipeline.

    The schedule is a pure function of the spec and the forecast sequence,
    so a spec replays the same flood and, downstream, the same shed and
    throttle schedule. The seed keys the injector's own RNG stream
    (``_chaos_rng``, the JAX package's draw for draw) for stochastic
    classes; the window itself draws nothing."""

    def __init__(self, factor: int, start: int = 0, length: int = 1 << 31,
                 hot_tenant: int = 0, seed: int = 0):
        self.factor = int(factor)
        self.start = int(start)
        self.length = int(length)
        self.hot_tenant = int(hot_tenant)
        self._rng = _chaos_rng(seed, "burst")
        self.forecasts_seen = 0
        self.injected = 0

    @classmethod
    def from_spec(cls, spec: Optional[Dict]) -> Optional["BurstInjector"]:
        """The injector a parsed chaos spec arms, or None (no ``burst`` of
        at least 2)."""
        if not spec or int(spec.get("burst", 0)) < 2:
            return None
        return cls(spec["burst"], spec.get("burstFrom", 0),
                   spec.get("burstLen", 1 << 31), spec.get("hotTenant", 0),
                   seed=spec.get("seed", 0))

    def clones(self, inst):
        """The extra copies of ``inst`` to inject: empty outside the window
        and for a training record. Copies share the feature payload
        (read-only) and carry the hot tenant's address."""
        from omldm_tpu_torch.api.data import FORECASTING

        if inst.operation != FORECASTING:
            return ()
        i = self.forecasts_seen
        self.forecasts_seen += 1
        if not (self.start <= i < self.start + self.length):
            return ()
        clone = dataclasses.replace(inst, metadata={"tenant": self.hot_tenant, "burst": True})
        k = self.factor - 1
        self.injected += k
        return [clone] * k


# poison-record templates: malformed or non-finite record values a
# hostile producer could publish (ChaosConsumer's ``poison`` class)
_POISON_RECORDS = (
    '{"numericalFeatures": [NaN, 1.0], "target": 1.0}',
    '{"numericalFeatures": [1e999, 0.5], "target": 0.0}',
    '{"numericalFeatures": [1.0, 2.0], "target": Infinity}',
    '{"numericalFeatures": [1.0, 2.0], "target": ',
)


class _PoisonedRecord:
    """Minimal ConsumerRecord stand-in carrying a poisoned value."""

    __slots__ = ("topic", "value", "partition", "offset")

    def __init__(self, rec, value):
        self.topic = rec.topic
        self.value = value
        self.partition = getattr(rec, "partition", 0)
        self.offset = getattr(rec, "offset", None)


class ChaosConsumer:
    """Seeded lossy wrapper around a Kafka-style consumer iterator.

    Applies drop/dup/reorder to the RECORD stream (the broker-side faults
    of an at-least-once source: redelivery after rebalance, replayed
    batches after restart). Drops model transient loss before commit --
    offsets of dropped records are never recorded, so a checkpoint/restore
    cycle re-reads them: at-least-once is preserved, exactly what the
    reference's Kafka sources guarantee. All non-iterator attributes
    (assign/seek/position/...) delegate to the wrapped consumer."""

    def __init__(self, inner, *, seed: int = 0, drop: float = 0.0,
                 dup: float = 0.0, reorder: float = 0.0, delay: float = 0.0,
                 poison: float = 0.0, nan: float = 0.0, explode: float = 0.0,
                 window: int = 4, name: str = "kafka",
                 poison_exempt_topics=()):
        self._inner = inner
        self._rng = _chaos_rng(seed, name)
        self._drop = float(drop)
        self._dup = float(dup)
        self._reorder = float(reorder + delay)
        # poison-record injection: with probability ``poison`` a consumed
        # record's VALUE is replaced by a seeded malformed/non-finite
        # template (_POISON_RECORDS) -- the hostile-producer fault the
        # dead-letter quarantine + isValid boundary must absorb without
        # crashing or training on it. ``nan``/``explode`` are channel
        # (parameter-payload) classes and are inert on a record stream --
        # accepted so one spec string can arm both layers.
        self._poison = float(poison)
        # topics poison must never touch (the CONTROL stream): a poisoned
        # record is consumed -- its offset advances -- so unlike the drop
        # class it is not replayed later. Destroying a Create/Delete
        # would silently change the job topology forever, which is a
        # different fault class than hostile data records. The fate draw
        # still happens for exempt topics so the corruption schedule of
        # the data streams does not depend on the topic mix.
        self._poison_exempt = frozenset(poison_exempt_topics)
        self._window = max(int(window), 1)
        self._held: List[list] = []  # [countdown, record]
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.poisoned = 0

    def __iter__(self):
        return self

    def _due(self):
        due = next((h for h in self._held if h[0] <= 0), None)
        if due is not None:
            self._held.remove(due)
        return due

    def __next__(self):
        while True:
            due = self._due()
            if due is not None:
                return due[1]
            try:
                rec = next(self._inner)
            except StopIteration:
                # idle window: release held records (nothing left for them
                # to reorder past) before going idle ourselves
                if self._held:
                    return self._held.pop(0)[1]
                raise
            for h in self._held:
                h[0] -= 1
            if self._poison > 0.0:
                u_poison = self._rng.random_sample()
                hit = u_poison < self._poison
                if hit:
                    value = _POISON_RECORDS[
                        int(self._rng.randint(len(_POISON_RECORDS)))
                    ]
                if hit and getattr(rec, "topic", None) not in self._poison_exempt:
                    rec = _PoisonedRecord(rec, value)
                    self.poisoned += 1
            u_drop, u_dup, u_reorder = self._rng.random_sample(3)
            if u_dup < self._dup:
                self._held.append(
                    [int(self._rng.randint(1, self._window + 1)), rec]
                )
                self.duplicated += 1
            if u_drop < self._drop:
                self.dropped += 1
                continue
            if u_reorder < self._reorder:
                self._held.append(
                    [int(self._rng.randint(1, self._window + 1)), rec]
                )
                self.reordered += 1
                continue
            return rec

    def __getattr__(self, name):
        return getattr(self._inner, name)


def maybe_chaos_consumer(
    consumer,
    flags: Optional[Dict[str, str]] = None,
    env_var: str = "OMLDM_CHAOS_KAFKA",
    name: str = "kafka",
    poison_exempt_topics=(),
):
    """Wrap ``consumer`` in a :class:`ChaosConsumer` when broker chaos is
    armed (the fleet's ``--kafkaChaos`` flag, or the env var, which reaches
    supervised worker subprocesses); otherwise return it untouched.
    ``poison_exempt_topics`` names topics the poison class must never
    mutate -- callers pass their request/control topics."""
    spec = parse_chaos_spec((flags or {}).get("kafkaChaos") or os.environ.get(env_var, ""))
    if spec is None:
        return consumer
    params = spec["up"]
    if not any(params.values()):
        return consumer
    print(
        f"[chaos] kafka consumer chaos armed: seed={spec['seed']} {params}",
        file=sys.stderr,
        flush=True,
    )
    return ChaosConsumer(
        consumer, seed=spec["seed"], window=spec["window"], name=name,
        poison_exempt_topics=poison_exempt_topics, **params
    )


__all__ = [
    "RESCALE_EXIT",
    "SUPERVISOR_ONLY_FLAGS",
    "WORKER_MODULE",
    "AttemptRecord",
    "AutoscalePolicy",
    "BurstInjector",
    "ChaosChannel",
    "ChaosConsumer",
    "DegradeRecord",
    "DistributedFaultInjector",
    "DistributedJobSupervisor",
    "FleetFailure",
    "RescaleRecord",
    "maybe_chaos_consumer",
    "parse_chaos_spec",
    "supervise_from_flags",
]
