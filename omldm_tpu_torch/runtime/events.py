"""Flight recorder: the structured decision-event journal, incident
bundles and watchdog alerts.

Counterpart of ``omldm_tpu/runtime/events.py`` (a copy: the port imports
nothing of the JAX package). The reference's failure story is a black box:
its only observability is the terminate-time ``JobStatistics`` report
(StatisticsOperator.scala:21-150), and its ``JobTerminator`` kills the job
by throwing on the first performance record (JobTerminator.scala:6-10).
The planes of this runtime make decisions on their own (guard rollback and
eviction, overload shed and pause, lifecycle promote and rollback, live
rescale, transport resync and quorum release); this module records them.

Armed per job by ``JobConfig.events`` or lazily by the first pipeline whose
``trainingConfiguration.events`` table arms it. Unset (the default): no
recorder object exists and every route is the plain one. Three layers:

- :class:`EventJournal` -- a typed, bounded, per-process ring of decision
  events with monotonic ids, the count-clock position, wall time,
  pipeline and tenant and a machine-readable ``cause``. Events at a
  transport boundary carry the reliable channel's ``(networkId, seq)``
  stamp.
- Incident bundles -- on a guard trip, a supervised worker death, a
  rescale or terminate the ring dumps to JSONL under ``blackboxPath``
  (``blackbox-proc<pid>.jsonl``, atomic replace); a supervisor gathers the
  dumps and its own decision log into one bundle (``incident-*.json``)
  whose timeline is merge-sorted on the transport stamps
  (:func:`merge_timeline`). ``benchmarks/incident_report.py`` renders one.
- :class:`Watchdog` -- rules evaluated every ``watchdogEvery`` records
  (and by the wall-clock silence poll): throughput collapse, serve-p99
  budget, rising shed/rejection rate, learning-curve regression and
  heartbeat silence. A fired rule records an ``alert`` event and, through
  the job's ``on_alert`` hook, a ``kind="alert"`` record on the
  performance sink, with fire/clear hysteresis and an injectable clock.

No watchdog signal and no event field reads a CUDA tensor: the journal
records host values only, so arming the recorder adds no device work.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from omldm_tpu_torch.utils import clock as uclock

# --- event taxonomy ---------------------------------------------------------
# kinds are a closed vocabulary (the README table); causes are free-form
# machine-readable strings scoped by kind

# model-integrity guard (guard.py, runtime/spoke.py, protocols/base.py)
GUARD_TRIP = "guard_trip"            # worker-side divergence detected
GUARD_ROLLBACK = "guard_rollback"    # LKG rollback performed
GUARD_EVICT = "guard_evict"          # cohort member evicted to solo
DELTA_REJECTED = "delta_rejected"    # hub admission rejected a worker push
WORKER_RETIRED = "worker_retired"    # round accounting dropped a worker
WORKER_READMITTED = "worker_readmitted"
# reliable transport (runtime/messages.py, runtime/hub.py, runtime/spoke.py)
QUORUM_RELEASE = "quorum_release"    # barrier released under retirement
RESYNC = "resync"                    # authoritative state re-ship decided
GAP_RESYNC = "gap_resync"            # receive window declared a gap lost
CHANNEL_RESYNC = "channel_resync"    # worker accepted an OP_RESYNC re-ship
# overload plane (runtime/overload.py)
PRESSURE = "pressure"                # ladder level transition
SHED = "shed"                        # forecasts shed (aggregated per tick)
THROTTLE = "throttle"                # training rows deferred (aggregated)
PAUSE = "pause"                      # upstream source pause / resume
# lifecycle plane (runtime/lifecycle.py)
LIFECYCLE = "lifecycle"              # canary state-machine transition
# elastic rescale / supervision (runtime/job.py, runtime/recovery.py; the
# JAX package's multi-process fleet records SCALE too)
RESCALE = "rescale"                  # parallelism change decided/agreed
RESTORE = "restore"                  # checkpoint-restore decision
RESTART = "restart"                  # supervisor restart decision
SCALE = "scale"                      # autoscale decision signaled
# the JAX package's self-healing fleet (its supervisor and distributed
# job; the kinds are kept so a fleet bundle reads the same vocabulary)
STRIKE = "strike"                    # classified failure charged to a slot
DEGRADE = "degrade"                  # shrink-to-survivors decided
PROBE = "probe"                      # re-expansion probe signaled/settled
HANG = "hang"                        # worker hang-watchdog fired (HANG_EXIT)
HEAL = "heal"                        # relaunched fleet's first heartbeat
# recorder-internal
ALERT = "alert"                      # watchdog rule fired
ALERT_CLEAR = "alert_clear"          # watchdog rule cleared (hysteresis)
INCIDENT_DUMP = "incident_dump"      # ring dumped to the black box
TERMINATE = "terminate"              # termination protocol fired

# ordering rank for events sharing one (networkId, seq) transport stamp:
# a push is rejected before its sender retires, retirement precedes the
# resync decision, and re-admission follows it — merge_timeline breaks
# same-stamp ties with this so the causal chain reads in order even when
# two processes' wall clocks disagree
_STAMP_RANK = {
    GAP_RESYNC: 0,
    DELTA_REJECTED: 1,
    WORKER_RETIRED: 2,
    RESYNC: 3,
    CHANNEL_RESYNC: 4,
    WORKER_READMITTED: 5,
}
_STAMP_RANK_DEFAULT = 6

DEFAULT_CAP = 4096
DEFAULT_TAIL = 8
DEFAULT_WATCHDOG_EVERY = 10_000
DEFAULT_CLEAR_AFTER = 2
DEFAULT_COLLAPSE_WINDOWS = 4


@dataclasses.dataclass
class EventsConfig:
    """Parsed ``JobConfig.events`` / ``trainingConfiguration.events``
    knobs."""

    # journal ring capacity (events; oldest evict)
    cap: int = DEFAULT_CAP
    # directory for JSONL ring dumps + incident bundles ("" = in-memory
    # ring only; JobConfig.blackbox_path supplies the job-wide default)
    blackbox_path: str = ""
    # per-pipeline event-tail length carried on Query responses
    tail: int = DEFAULT_TAIL
    # watchdog evaluation cadence in RECORDS (count-clocked, deterministic
    # under replay; 0 disables the rule layer entirely)
    watchdog_every: int = DEFAULT_WATCHDOG_EVERY
    # consecutive healthy evaluations before a fired rule clears
    clear_after: int = DEFAULT_CLEAR_AFTER
    # --- rules (each 0 = off) -------------------------------------------
    # fire when the current window's records/s drops below this fraction
    # of the trailing-window mean (0 < frac < 1 arms)
    collapse_frac: float = 0.0
    # trailing windows the collapse/curve rules compare against
    collapse_windows: int = DEFAULT_COLLAPSE_WINDOWS
    # fire when the serving p99 exceeds this budget (ms)
    p99_budget_ms: float = 0.0
    # fire when shed+throttled+rejected grows by at least this much in
    # one watchdog window
    shed_high: float = 0.0
    # fire when the mean latest learning-curve loss rises at least this
    # far above its trailing-window minimum
    curve_slope: float = 0.0
    # fire when no stream activity for this long (wall-clocked — the one
    # rule a stalled stream NEEDS a wall clock for; evaluated from the
    # live loop's silence poll as well as at watchdog cadence)
    silence_ms: float = 0.0

    def any_rule_armed(self) -> bool:
        return (
            0.0 < self.collapse_frac < 1.0
            or self.p99_budget_ms > 0
            or self.shed_high > 0
            or self.curve_slope > 0
            or self.silence_ms > 0
        )


_KNOBS = {
    "cap": ("cap", int),
    "blackboxPath": ("blackbox_path", str),
    "tail": ("tail", int),
    "watchdogEvery": ("watchdog_every", int),
    "clearAfter": ("clear_after", int),
    "collapseFrac": ("collapse_frac", float),
    "collapseWindows": ("collapse_windows", int),
    "p99BudgetMs": ("p99_budget_ms", float),
    "shedHigh": ("shed_high", float),
    "curveSlope": ("curve_slope", float),
    "silenceMs": ("silence_ms", float),
}


def parse_events_spec(spec) -> Optional[EventsConfig]:
    """dict / spec-string / True -> EventsConfig; None / False / "" ->
    None (unarmed). Raises ValueError on unknown knobs or nonsense values
    — the control gate turns that into a request drop, the job
    constructor into a fail-fast (the serving/overload/telemetry
    pattern)."""
    if spec is None or spec is False or spec == "":
        return None
    if spec is True:
        spec = {}
    if isinstance(spec, str):
        s = spec.strip()
        if s.lower() == "on":
            spec = {}
        else:
            out: dict = {}
            for part in s.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ValueError(
                        f"bad events spec entry {part!r} (want k=v)"
                    )
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
            spec = out
    if not isinstance(spec, dict):
        raise ValueError(
            f"events spec must be a table, got {type(spec).__name__}"
        )
    unknown = set(spec) - set(_KNOBS)
    if unknown:
        raise ValueError(f"unknown events knob(s): {sorted(unknown)}")
    cfg = EventsConfig()
    for key, raw in spec.items():
        field, conv = _KNOBS[key]
        value = str(raw) if conv is str else conv(float(raw))
        setattr(cfg, field, value)
    if cfg.cap < 1:
        raise ValueError("events.cap must be >= 1")
    if cfg.tail < 0:
        raise ValueError("events.tail must be >= 0")
    if cfg.watchdog_every < 0:
        raise ValueError("events.watchdogEvery must be >= 0")
    if cfg.clear_after < 1:
        raise ValueError("events.clearAfter must be >= 1")
    if cfg.collapse_frac < 0 or cfg.collapse_frac >= 1:
        raise ValueError("events.collapseFrac must be in [0, 1)")
    if cfg.collapse_windows < 1:
        raise ValueError("events.collapseWindows must be >= 1")
    for name in ("p99_budget_ms", "shed_high", "curve_slope", "silence_ms"):
        if getattr(cfg, name) < 0:
            raise ValueError(f"events.{name} must be >= 0")
    return cfg


def events_config(tc, job_spec: str = "") -> Optional[EventsConfig]:
    """The pipeline's events config: ``trainingConfiguration.events`` wins
    (including an explicit False = opt out under a job default); otherwise
    the job-wide ``JobConfig.events`` spec applies. None = unarmed."""
    extra = getattr(tc, "extra", None) or {}
    if "events" in extra:
        return parse_events_spec(extra["events"])
    return parse_events_spec(job_spec or "")


def validate_events(tc) -> Optional[str]:
    """Control-gate twin of :func:`events_config`: the error string for an
    undeployable events table, or None (a bad request drops at admission
    instead of killing the job)."""
    try:
        events_config(tc)
    except (ValueError, TypeError) as exc:
        return str(exc)
    return None


def events_armed_for(tc, job_spec: str = "") -> bool:
    """Whether this pipeline participates in recording (the per-pipeline
    opt-out rule, shared by hub-shard wiring at create time and the
    lazy-arming walk so the two can never diverge). A gate-validated
    table can still raise here on the belt-and-braces path — treated as
    unarmed."""
    try:
        return events_config(tc, job_spec) is not None
    except (ValueError, TypeError):
        return False


class EventJournal:
    """Typed, bounded, per-process decision-event ring.

    Every event is one JSON-shaped dict: ``id`` (monotonic within this
    journal), ``kind`` (the closed taxonomy above), ``cause``
    (machine-readable reason string), ``clock`` (the count-clock position
    — events/records processed, a pure function of the stream so replays
    stamp identically), ``wall`` (epoch seconds — the ONE
    non-deterministic field; determinism tests strip it), ``pid``, plus
    optional ``pipeline``/``tenant``/``worker``/``stamp`` and free extra
    fields. ``stamp`` is the reliable transport's ``[networkId, seq]``
    pair when the event sits at a transport boundary — the key
    :func:`merge_timeline` orders cross-process causality by.

    Recording NEVER raises and costs one dict build + deque append; the
    ring bounds memory however long the stream runs."""

    def __init__(
        self,
        cap: int = DEFAULT_CAP,
        pid: Any = 0,
        path: str = "",
        clock: Callable[[], float] = uclock.WALL,
        position: Optional[Callable[[], int]] = None,
        tail_len: int = DEFAULT_TAIL,
    ):
        self.cap = max(int(cap), 1)
        self.pid = pid
        self.path = path or ""
        self._clock = clock
        self._position = position
        self.tail_len = int(tail_len)
        # per-pipeline tail deques maintained at record time: the Query
        # path reads O(tail), not an O(cap) ring scan per fragment
        self._tails: Dict[Any, Any] = {}
        self.events: List[dict] = []
        self.total = 0          # events ever recorded (ring evicts)
        self.alerts = 0         # ALERT events ever recorded
        self.by_kind: Dict[str, int] = {}
        self.dumps_written = 0
        # ring dumps the disk refused (ENOSPC, permissions, a yanked
        # volume): the black box degrades to the in-memory ring and
        # COUNTS the drop instead of raising on the data path — the
        # counter surfaces as ``blackboxWriteErrors`` in Statistics
        self.write_errors = 0
        self._dirty = False     # events since the last dump
        # transport-stream incarnation: a LIVE rescale restarts the
        # per-net sequence counters (reused worker slots count from 0
        # again) while this journal ring persists — bumping the epoch
        # keeps merge_timeline from cross-comparing pre- and post-rescale
        # seqs under one stream key (StreamJob.rescale bumps it)
        self.epoch = 0

    def bump_epoch(self) -> None:
        self.epoch += 1

    @property
    def high_water(self) -> int:
        """The last assigned event id (0 before the first event) — the
        cross-reference dead-letter entries and heartbeat frames carry."""
        return self.total

    @property
    def dirty(self) -> bool:
        return self._dirty

    def record(
        self,
        kind: str,
        cause: str,
        pipeline: Optional[int] = None,
        tenant: Optional[int] = None,
        worker: Optional[int] = None,
        stamp: Optional[Tuple[int, int]] = None,
        **fields: Any,
    ) -> dict:
        self.total += 1
        event: dict = {
            "id": self.total,
            "kind": kind,
            "cause": cause,
            "clock": self._position() if self._position is not None else 0,
            "wall": self._clock(),
            "pid": self.pid,
        }
        if pipeline is not None:
            event["pipeline"] = pipeline
            if self.tail_len > 0:
                tail = self._tails.get(pipeline)
                if tail is None:
                    import collections

                    tail = self._tails[pipeline] = collections.deque(
                        maxlen=self.tail_len
                    )
                tail.append(event)
        if tenant is not None:
            event["tenant"] = tenant
        if worker is not None:
            event["worker"] = worker
        if stamp is not None and stamp[1] is not None:
            event["stamp"] = [int(stamp[0]), int(stamp[1])]
            if self.epoch:
                event["epoch"] = self.epoch
        if fields:
            event.update(fields)
        self.events.append(event)
        if len(self.events) > self.cap:
            del self.events[: len(self.events) - self.cap]
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        if kind == ALERT:
            self.alerts += 1
        self._dirty = True
        return event

    def tail(self, n: Optional[int] = None) -> List[dict]:
        return list(self.events if n is None else self.events[-n:])

    def tail_for(self, pipeline: int, n: Optional[int] = None) -> List[dict]:
        """The last ``tail_len`` events tagged with this pipeline — the
        ring tail a Query response carries (served from the per-pipeline
        deque, O(tail); ``n`` below the default trims further)."""
        tail = list(self._tails.get(pipeline, ()))
        if n is not None:
            tail = tail[-n:] if n else []
        return tail

    def dump_path(self) -> Optional[str]:
        if not self.path:
            return None
        return os.path.join(self.path, f"blackbox-proc{self.pid}.jsonl")

    def dump(self) -> Optional[str]:
        """Write the current ring to ``blackbox-proc<pid>.jsonl`` (atomic
        replace — a supervisor polling the black box between writes never
        reads a torn dump). Never raises; a full/odd disk degrades to the
        in-memory ring. Returns the path written, or None."""
        path = self.dump_path()
        if path is None:
            return None
        try:
            os.makedirs(self.path, exist_ok=True)
            _atomic_write_text(
                path,
                "".join(json.dumps(e) + "\n" for e in self.events),
            )
        except OSError:
            self.write_errors += 1
            return None
        self.dumps_written += 1
        self._dirty = False
        return path

    def incident(self, cause: str, **fields: Any) -> Optional[str]:
        """Record an ``incident_dump`` marker and dump the ring — the
        guard-trip / worker-death / rescale / terminate hook."""
        self.record(INCIDENT_DUMP, cause, **fields)
        return self.dump()


# --- incident bundles -------------------------------------------------------


def merge_timeline(streams: Sequence[Sequence[dict]]) -> List[dict]:
    """Merge per-process event streams into one fleet timeline.

    Base order is a stable ``(wall, pid, id)`` sort across every ring.
    Then the transport stamps repair transport-order: stamped events
    sharing one SENDER STREAM — same source ring, ``networkId``,
    ``worker``, ``hub`` shard and receive side — re-sort by
    ``(seq, rank)``, where rank
    orders the same-stamp chain push-rejection -> retirement -> resync ->
    re-admission, and land back in the same timeline slots. A chaos
    reorder that made the receiver process seq 7 before seq 5 therefore
    reads in SEND order in the bundle.

    Seq counters from INDEPENDENT streams are never cross-compared: each
    worker's channel, each direction, each restarted incarnation's ring,
    and each LIVE-RESCALE epoch within one ring (a reused worker slot's
    sequencer restarts at 0 while the journal persists — the journal
    epoch, bumped at every rescale, keeps the halves apart) counts from
    0 on its own (the reliable channel's per-stream contract,
    runtime/messages.StreamSequencer), so re-sorting across them would
    scramble unrelated history — a rescaled-in worker's seq 3 must not
    jump ahead of a veteran's seq 400. Across rings and for unstamped
    events the wall-time base order stands."""
    merged: List[Tuple[int, dict]] = []
    for epoch, events in enumerate(streams):
        for event in events:
            merged.append((epoch, event))
    merged.sort(
        key=lambda t: (
            t[1].get("wall", 0.0), str(t[1].get("pid", "")), t[1]["id"],
        )
    )
    by_stream: Dict[tuple, List[int]] = {}
    for i, (epoch, event) in enumerate(merged):
        stamp = event.get("stamp")
        if stamp is None:
            continue
        try:
            net, _seq = int(stamp[0]), int(stamp[1])
        except (TypeError, ValueError, IndexError):
            # a torn dump's garbled stamp is treated as unstamped — the
            # gather contract (never fatal) extends to the merge
            continue
        key = (
            epoch, event.get("epoch", 0), net, event.get("worker"),
            event.get("hub"), event.get("side", ""),
        )
        by_stream.setdefault(key, []).append(i)
    for positions in by_stream.values():
        ordered = sorted(
            (merged[i][1] for i in positions),
            key=lambda e: (
                int(e["stamp"][1]),
                _STAMP_RANK.get(e["kind"], _STAMP_RANK_DEFAULT),
                e.get("wall", 0.0),
                e["id"],
            ),
        )
        for slot, event in zip(positions, ordered):
            merged[slot] = (merged[slot][0], event)
    return [event for _, event in merged]


def gather_blackbox(
    path: str, min_mtime: float = 0.0
) -> List[List[dict]]:
    """Read every per-process ring dump (``blackbox-*.jsonl``) under a
    black-box directory. Torn/garbled lines are skipped, never fatal — a
    bundle built mid-crash must salvage what it can. ``min_mtime``
    excludes dumps older than the caller's run (the checkpoint-floor
    rule: a reused directory's stale rings from an earlier run — or an
    earlier, larger fleet's extra procN files — must not pollute this
    run's bundles)."""
    streams: List[List[dict]] = []
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return streams
    for name in names:
        if not (name.startswith("blackbox-") and name.endswith(".jsonl")):
            continue
        if min_mtime > 0:
            try:
                if os.path.getmtime(os.path.join(path, name)) < min_mtime:
                    continue
            except OSError:
                continue
        events: List[dict] = []
        try:
            with open(os.path.join(path, name), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(obj, dict) and "id" in obj:
                        events.append(obj)
        except OSError:
            continue
        if events:
            streams.append(events)
    return streams


def write_bundle(
    path: str,
    streams: Sequence[Sequence[dict]],
    meta: Optional[dict] = None,
) -> Optional[str]:
    """Write one incident bundle: ``{"meta", "processes", "timeline"}``
    with the fleet timeline merge-sorted on the transport stamps. Atomic
    replace; never raises (a failing disk must not take down the
    supervisor it reports for). Returns the path written, or None."""
    try:
        timeline = merge_timeline(streams)
        counts: Dict[str, int] = {}
        for event in timeline:
            counts[event.get("kind", "?")] = (
                counts.get(event.get("kind", "?"), 0) + 1
            )
        bundle = {
            "meta": dict(meta or {}),
            "processes": [
                {
                    "pid": events[0].get("pid") if events else None,
                    "events": len(events),
                }
                for events in streams
            ],
            "byKind": counts,
            "timeline": timeline,
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _atomic_write_text(path, json.dumps(bundle))
    except Exception:
        # the never-raises contract is absolute: a bundle is built from
        # possibly-torn crash artifacts INSIDE a supervisor's restart
        # path — no input may take down the supervisor it reports for
        return None
    return path


def _atomic_write_text(path: str, text: str) -> None:
    """tmp-write + os.replace (the dump/bundle atomicity primitive —
    readers polling between writes never see a torn file). Raises
    OSError; callers own the degrade-not-crash policy."""
    with open(path + ".tmp", "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


# --- watchdog rule layer ----------------------------------------------------


class Watchdog:
    """Fire/clear alerting rules over periodic metrics snapshots.

    ``evaluate(signals, now)`` runs every armed rule against one signals
    dict (built by the job from the telemetry plane's registry when telemetry
    is armed, from the same underlying accessors otherwise):

    - ``records``: cumulative record count (throughput-collapse rule)
    - ``serve_p99_ms``: current serving p99 (budget rule)
    - ``shed``: cumulative shed+throttled+rejected count (shed-rate rule)
    - ``loss``: mean latest learning-curve loss, or None (curve rule)
    - ``last_activity``: epoch of the last stream activity (silence rule)

    Each rule is a tiny state machine: the first breaching evaluation
    FIRES (one ``alert`` event through the journal + the ``on_alert``
    callback, which the job uses to emit a ``kind="alert"`` record on the
    performance sink); subsequent breaches hold; ``clearAfter``
    consecutive healthy evaluations CLEAR it (an ``alert_clear`` event) so
    a flapping signal cannot storm the sink. ``now`` is injectable."""

    def __init__(
        self,
        cfg: EventsConfig,
        journal: EventJournal,
        on_alert: Optional[Callable[[dict], None]] = None,
        clock: Callable[[], float] = uclock.WALL,
    ):
        self.cfg = cfg
        self.journal = journal
        self.on_alert = on_alert
        self._clock = clock
        self.evaluations = 0
        # records since the last evaluation (the count clock)
        self._records_since = 0
        # rule name -> {"firing": bool, "healthy": int}
        self._state: Dict[str, Dict[str, Any]] = {}
        # trailing history (collapse + curve rules)
        self._rates: List[float] = []
        self._losses: List[float] = []
        self._last_records: Optional[int] = None
        self._last_eval_wall: Optional[float] = None

    # --- the count clock -------------------------------------------------

    def note_records(self, n: int) -> bool:
        """Advance the count clock; True when an evaluation is due."""
        if self.cfg.watchdog_every <= 0:
            return False
        self._records_since += n
        return self._records_since >= self.cfg.watchdog_every

    # --- rule evaluation -------------------------------------------------

    def _rule(self, name: str) -> Dict[str, Any]:
        st = self._state.get(name)
        if st is None:
            st = self._state[name] = {"firing": False, "healthy": 0}
        return st

    def _settle(
        self, name: str, breach: Optional[dict], fired: List[dict]
    ) -> None:
        st = self._rule(name)
        if breach is not None:
            st["healthy"] = 0
            if not st["firing"]:
                st["firing"] = True
                event = self.journal.record(ALERT, name, **breach)
                fired.append(event)
                if self.on_alert is not None:
                    try:
                        self.on_alert(event)
                    except Exception:
                        pass  # a broken sink must not kill the job
        elif st["firing"]:
            st["healthy"] += 1
            if st["healthy"] >= self.cfg.clear_after:
                st["firing"] = False
                st["healthy"] = 0
                self.journal.record(ALERT_CLEAR, name)

    def evaluate(
        self, signals: Dict[str, Any], now: Optional[float] = None
    ) -> List[dict]:
        """One watchdog pass; returns the alert events fired. Resets the
        count clock."""
        cfg = self.cfg
        now = self._clock() if now is None else now
        self.evaluations += 1
        self._records_since = 0
        fired: List[dict] = []
        # throughput collapse: current window rate vs trailing mean
        if 0.0 < cfg.collapse_frac < 1.0:
            records = int(signals.get("records", 0))
            breach = None
            if (
                self._last_records is not None
                and self._last_eval_wall is not None
                and now > self._last_eval_wall
            ):
                rate = (records - self._last_records) / (
                    now - self._last_eval_wall
                )
                if len(self._rates) >= cfg.collapse_windows:
                    trailing = sum(self._rates) / len(self._rates)
                    if trailing > 0 and rate < cfg.collapse_frac * trailing:
                        breach = {
                            "rate": round(rate, 3),
                            "trailing": round(trailing, 3),
                        }
                self._rates.append(rate)
                if len(self._rates) > cfg.collapse_windows:
                    del self._rates[: len(self._rates) - cfg.collapse_windows]
            self._last_records = records
            self._settle("throughput_collapse", breach, fired)
        self._last_eval_wall = now
        # serving p99 budget
        if cfg.p99_budget_ms > 0:
            p99 = float(signals.get("serve_p99_ms", 0.0) or 0.0)
            self._settle(
                "serve_p99_budget",
                {"p99Ms": round(p99, 3), "budgetMs": cfg.p99_budget_ms}
                if p99 >= cfg.p99_budget_ms
                else None,
                fired,
            )
        # rising shed/rejection rate (delta per window)
        if cfg.shed_high > 0:
            shed = float(signals.get("shed", 0.0) or 0.0)
            st = self._rule("shed_rate")
            last = st.get("last")
            st["last"] = shed
            delta = shed - last if last is not None else 0.0
            self._settle(
                "shed_rate",
                {"delta": delta} if delta >= cfg.shed_high else None,
                fired,
            )
        # learning-curve regression: latest loss vs trailing minimum
        if cfg.curve_slope > 0:
            loss = signals.get("loss")
            breach = None
            if loss is not None:
                loss = float(loss)
                if len(self._losses) >= 1:
                    floor = min(self._losses)
                    if loss - floor >= cfg.curve_slope:
                        breach = {
                            "loss": round(loss, 6),
                            "floor": round(floor, 6),
                        }
                self._losses.append(loss)
                if len(self._losses) > cfg.collapse_windows:
                    del self._losses[
                        : len(self._losses) - cfg.collapse_windows
                    ]
            self._settle("curve_regression", breach, fired)
        # heartbeat silence (also evaluated by poll_silence)
        if cfg.silence_ms > 0:
            self._silence(signals.get("last_activity"), now, fired)
        return fired

    def _silence(
        self, last_activity, now: float, fired: List[dict]
    ) -> None:
        breach = None
        if last_activity is not None:
            silent_ms = (now - float(last_activity)) * 1000.0
            if silent_ms >= self.cfg.silence_ms:
                breach = {"silentMs": round(silent_ms, 1)}
        self._settle("heartbeat_silence", breach, fired)

    def poll_silence(
        self, last_activity, now: Optional[float] = None
    ) -> List[dict]:
        """Wall-clock poll for the silence rule alone (the live loop's
        check_silence hook) — the count clock cannot advance while nothing
        flows, which is exactly when this rule matters."""
        if self.cfg.silence_ms <= 0:
            return []
        now = self._clock() if now is None else now
        fired: List[dict] = []
        self._silence(last_activity, now, fired)
        return fired


class FlightRecorder:
    """Per-job flight-recorder state: the journal plus (when any rule is
    armed) the watchdog. One instance per StreamJob / distributed process
    when armed; None (the default) everywhere else."""

    def __init__(
        self,
        cfg: EventsConfig,
        pid: Any = 0,
        clock: Callable[[], float] = uclock.WALL,
        position: Optional[Callable[[], int]] = None,
        on_alert: Optional[Callable[[dict], None]] = None,
        blackbox_default: str = "",
    ):
        self.cfg = cfg
        path = cfg.blackbox_path or blackbox_default
        self.journal = EventJournal(
            cap=cfg.cap,
            pid=pid,
            path=path,
            clock=clock,
            position=position,
            tail_len=cfg.tail,
        )
        self.watchdog: Optional[Watchdog] = None
        if cfg.watchdog_every > 0 and cfg.any_rule_armed():
            self.watchdog = Watchdog(
                cfg, self.journal, on_alert=on_alert, clock=clock
            )
        # records seen (the throughput rule's cumulative count)
        self.records_seen = 0

    def note_records(self, n: int) -> bool:
        """Advance the record clock; True when a watchdog pass is due."""
        self.records_seen += n
        if self.watchdog is None:
            return False
        return self.watchdog.note_records(n)


__all__ = [
    "ALERT",
    "ALERT_CLEAR",
    "CHANNEL_RESYNC",
    "DEGRADE",
    "DELTA_REJECTED",
    "EventJournal",
    "EventsConfig",
    "FlightRecorder",
    "GAP_RESYNC",
    "GUARD_EVICT",
    "GUARD_ROLLBACK",
    "GUARD_TRIP",
    "HANG",
    "INCIDENT_DUMP",
    "LIFECYCLE",
    "PAUSE",
    "PRESSURE",
    "PROBE",
    "QUORUM_RELEASE",
    "RESCALE",
    "RESTART",
    "RESTORE",
    "RESYNC",
    "SCALE",
    "SHED",
    "STRIKE",
    "TERMINATE",
    "THROTTLE",
    "Watchdog",
    "WORKER_READMITTED",
    "WORKER_RETIRED",
    "events_config",
    "gather_blackbox",
    "merge_timeline",
    "parse_events_spec",
    "validate_events",
    "write_bundle",
]
