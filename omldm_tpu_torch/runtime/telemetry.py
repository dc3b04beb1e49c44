"""Telemetry plane: metrics registry, continuous performance heartbeats,
phase-attributed hot-loop profiling and sampled round spans.

Counterpart of ``omldm_tpu/runtime/telemetry.py`` (a copy: the port imports
nothing of the JAX package). The reference's only observability is the
terminate-time ``JobStatistics`` report (StatisticsOperator.scala:21-150);
this plane reports while the job runs:

- :class:`MetricsRegistry` -- counters (additive), gauges (last-write, with
  a max-combining variant), bounded-ring histograms and probes, with
  ``snapshot()``/``merge()`` as the pull point. A probe is a callable read
  at snapshot time; every value a probe of the port reads is already on
  the host (counters, ``StepTimer`` rings, ``ServeStats``), never a CUDA
  tensor, so a snapshot adds no device sync.
- :class:`TelemetryPlane` -- armed per job by ``JobConfig.telemetry`` or
  lazily by the first pipeline whose ``trainingConfiguration.telemetry``
  table arms it. Unset (the default): no telemetry object exists and every
  route is the plain one. Armed, the job emits a heartbeat every
  ``statsEvery`` records (count-clocked, so the schedule is a function of
  the record sequence) through the ``on_performance`` sink, plus a
  wall-clock idle tick (``idleMs``). Heartbeats carry counters and latency
  percentiles, never holdout scores: scoring would launch evaluation
  programs into the hot loop.
- :class:`PhaseProfile` -- per-phase wall-clock accounting (bounded sample
  rings and exact totals) for ``read``/``parse``/``stage``/``holdout``/
  ``fit``/``device_wait``/``serve``/``ship``. ``fit`` and ``serve`` are the
  spokes' ``StepTimer`` totals: on a CUDA job they time the host's
  dispatch and the syncs that fall inside a flush, not the kernels.
- :class:`SpanLog` -- sampled (``traceSample`` = 1/N) spans of protocol
  rounds, keyed by the reliable channel's (networkId, seq) stamps (a local
  per-stream counter stands in when the channel is unarmed), written as
  JSONL records (``spanPath``) and kept in a bounded ring.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from omldm_tpu_torch.utils.tracing import linear_percentiles

# canonical hot-loop phase names; PhaseProfile accepts any name, these are
# the ones the runtime wires
PHASES = (
    "read",        # source I/O: kafka poll / file block read / shard ring
    "parse",       # bytes -> rows (JSON parse, C block parse, shard procs)
    "stage",       # rows -> fixed-shape micro-batches (vectorize + batcher)
    "holdout",     # 8-of-10 test-set split bookkeeping
    "fit",         # training program dispatch (the StepTimer flush path)
    "device_wait", # blocking on device results (SPMD drain; 0 on host CPU)
    "serve",       # forecast predict dispatch (the serve StepTimer path)
    "ship",        # transport codec encode+decode (wire prep)
)

# bounded per-phase / per-histogram sample window (percentiles summarize
# the most recent window; totals stay exact)
RING_CAP = 4096
SPAN_RING_CAP = 4096

DEFAULT_STATS_EVERY = 10_000
DEFAULT_IDLE_MS = 2_000.0


@dataclasses.dataclass
class TelemetryConfig:
    """Parsed ``JobConfig.telemetry`` / ``trainingConfiguration.telemetry``
    knobs."""

    # heartbeat cadence in RECORDS (count-clocked: the emission schedule
    # is a pure function of the record sequence, deterministic under
    # replay); <= 0 disables count-clocked heartbeats
    stats_every: int = DEFAULT_STATS_EVERY
    # wall-clock idle heartbeat: with activity pending since the last
    # beat, an idle stream still reports after this many ms (0 = off —
    # the one wall-clock knob, so replay determinism is opt-out only for
    # the idle tick, never for the count-clocked cadence)
    idle_ms: float = DEFAULT_IDLE_MS
    # span sampling rate 1/N on protocol sends (0 = spans off)
    trace_sample: int = 0
    # JSONL file for completed spans ("" = in-memory ring only)
    span_path: str = ""
    # in-memory completed-span ring cap
    span_cap: int = SPAN_RING_CAP
    # phase-attributed profiling on the hot paths (on by default when the
    # plane is armed; the hooks cost two perf_counter reads per block)
    phases: bool = True


_KNOBS = {
    "statsEvery": ("stats_every", int),
    "idleMs": ("idle_ms", float),
    "traceSample": ("trace_sample", int),
    "spanPath": ("span_path", str),
    "spanCap": ("span_cap", int),
    "phases": ("phases", None),  # bool-ish
}


def _parse_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def parse_telemetry_spec(spec) -> Optional[TelemetryConfig]:
    """dict / spec-string / True -> TelemetryConfig; None / False / "" ->
    None (unarmed). Raises ValueError on unknown knobs or nonsense values
    — the control gate turns that into a request drop, the job
    constructor into a fail-fast (the serving/overload/lifecycle
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
                        f"bad telemetry spec entry {part!r} (want k=v)"
                    )
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
            spec = out
    if not isinstance(spec, dict):
        raise ValueError(
            f"telemetry spec must be a table, got {type(spec).__name__}"
        )
    unknown = set(spec) - set(_KNOBS)
    if unknown:
        raise ValueError(f"unknown telemetry knob(s): {sorted(unknown)}")
    cfg = TelemetryConfig()
    for key, raw in spec.items():
        field, conv = _KNOBS[key]
        if conv is None:
            value: Any = _parse_bool(raw)
        elif conv is str:
            value = str(raw)
        else:
            value = conv(float(raw))
        setattr(cfg, field, value)
    if cfg.stats_every < 0:
        raise ValueError("telemetry.statsEvery must be >= 0")
    if cfg.idle_ms < 0:
        raise ValueError("telemetry.idleMs must be >= 0")
    if cfg.trace_sample < 0:
        raise ValueError("telemetry.traceSample must be >= 0")
    if cfg.span_cap < 1:
        raise ValueError("telemetry.spanCap must be >= 1")
    if cfg.stats_every == 0 and cfg.idle_ms == 0 and cfg.trace_sample == 0:
        raise ValueError(
            "telemetry spec arms nothing (statsEvery, idleMs and "
            "traceSample all 0); unset it instead"
        )
    return cfg


def telemetry_config(tc, job_spec: str = "") -> Optional[TelemetryConfig]:
    """The pipeline's telemetry config: ``trainingConfiguration.telemetry``
    wins (including an explicit False = opt this pipeline out of span
    sampling under a job default); otherwise the job-wide
    ``JobConfig.telemetry`` spec applies. None = unarmed."""
    extra = getattr(tc, "extra", None) or {}
    if "telemetry" in extra:
        return parse_telemetry_spec(extra["telemetry"])
    return parse_telemetry_spec(job_spec or "")


def validate_telemetry(tc) -> Optional[str]:
    """Control-gate twin of :func:`telemetry_config`: the error string for
    an undeployable telemetry table, or None (a bad request drops at
    admission instead of killing the job)."""
    try:
        telemetry_config(tc)
    except (ValueError, TypeError) as exc:
        return str(exc)
    return None


class _Ring:
    """Bounded float sample ring (the ServeStats layout) with an EXACT
    running total — percentiles summarize the retained window, sums and
    counts stay true for the whole stream."""

    __slots__ = ("count", "total", "_ring", "_n", "_i")

    def __init__(self, cap: int = RING_CAP):
        self.count = 0
        self.total = 0.0
        self._ring = np.zeros((cap,), np.float64)
        self._n = 0
        self._i = 0

    def note(self, value: float) -> None:
        self.count += 1
        self.total += value
        self._ring[self._i] = value
        self._i = (self._i + 1) % self._ring.shape[0]
        self._n = min(self._n + 1, self._ring.shape[0])

    def percentiles(self, qs=(50.0, 99.0)) -> Tuple[float, ...]:
        if self._n == 0:
            return tuple(0.0 for _ in qs)
        return linear_percentiles(np.sort(self._ring[: self._n]), qs)

    def merge(self, other: "_Ring") -> None:
        self.count += other.count
        self.total += other.total
        for v in other._ring[: other._n]:
            self._ring[self._i] = v
            self._i = (self._i + 1) % self._ring.shape[0]
            self._n = min(self._n + 1, self._ring.shape[0])


class MetricsRegistry:
    """The unified pull point: counters, gauges, histograms, probes.

    - ``counter(name, n)`` — additive; snapshots sum, merges sum.
    - ``gauge(name, v)`` — last-write wins (an operator rollback really
      moves the value back down); ``gauge_max(name, v)`` — peak-combining
      (pressure levels, mesh widths).
    - ``observe(name, v)`` — bounded-ring histogram sample (exact
      count/total, windowed percentiles).
    - ``probe(name, fn)`` — a zero-argument callable read at snapshot
      time: existing accounting (StepTimer rings, queue depths, overload
      signals) publishes into the registry WITHOUT double bookkeeping on
      its hot path. Probe errors degrade to absence, never crash a
      heartbeat.
    """

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._max_gauges: set = set()
        self.histograms: Dict[str, _Ring] = {}
        self._probes: Dict[str, Callable[[], float]] = {}

    # --- writes ----------------------------------------------------------

    def counter(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        self._max_gauges.add(name)
        if value > self.gauges.get(name, float("-inf")):
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        ring = self.histograms.get(name)
        if ring is None:
            ring = self.histograms[name] = _Ring()
        ring.note(value)

    def probe(self, name: str, fn: Callable[[], float]) -> None:
        self._probes[name] = fn

    def read_probe(self, name: str, default: float = 0.0) -> float:
        fn = self._probes.get(name)
        if fn is None:
            return default
        try:
            return float(fn())
        except Exception:
            return default

    # --- the pull point --------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-shaped view of everything registered: counters,
        gauges, histogram summaries ({count, total, p50, p99}), and the
        probes' current values (under ``gauges``, read now)."""
        gauges = dict(self.gauges)
        for name, fn in self._probes.items():
            try:
                gauges[name] = float(fn())
            except Exception:
                pass  # a dead probe must not kill a heartbeat
        hists = {}
        for name, ring in self.histograms.items():
            p50, p99 = ring.percentiles()
            hists[name] = {
                "count": ring.count,
                "total": round(ring.total, 6),
                "p50": round(p50, 4),
                "p99": round(p99, 4),
            }
        return {"counters": dict(self.counters), "gauges": gauges,
                "histograms": hists}

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in: counters sum, max-gauges peak, plain
        gauges last-write (other wins), histogram rings concatenate
        (bounded)."""
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        for k, v in other.gauges.items():
            if k in other._max_gauges or k in self._max_gauges:
                self.gauge_max(k, v)
            else:
                self.gauges[k] = v
        for k, ring in other.histograms.items():
            mine = self.histograms.get(k)
            if mine is None:
                mine = self.histograms[k] = _Ring()
            mine.merge(ring)


class _PhaseCtx:
    """Reusable context manager for ``PhaseProfile.phase`` (a stack, so
    one profile survives nested phases — inner time is attributed to the
    inner phase only by the caller's discipline; the runtime's hooks never
    nest)."""

    __slots__ = ("_profile", "_name", "_starts")

    def __init__(self, profile: "PhaseProfile", name: str):
        self._profile = profile
        self._name = name
        self._starts: List[float] = []

    def __enter__(self):
        self._starts.append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        self._profile.note(
            self._name, time.perf_counter() - self._starts.pop()
        )
        return False


class PhaseProfile:
    """Per-phase wall-clock attribution: exact total seconds + counts +
    bounded sample rings per phase. ``table(e2e_s)`` is the breakdown the
    benchmarks print; ``share`` sums to the measured attribution
    fraction."""

    def __init__(self):
        self._rings: Dict[str, _Ring] = {}
        self._ctxs: Dict[str, _PhaseCtx] = {}

    def note(self, name: str, seconds: float) -> None:
        ring = self._rings.get(name)
        if ring is None:
            ring = self._rings[name] = _Ring()
        ring.note(seconds)

    def phase(self, name: str) -> _PhaseCtx:
        ctx = self._ctxs.get(name)
        if ctx is None:
            ctx = self._ctxs[name] = _PhaseCtx(self, name)
        return ctx

    def seconds(self, name: str) -> float:
        ring = self._rings.get(name)
        return ring.total if ring is not None else 0.0

    def total_seconds(self) -> float:
        return sum(r.total for r in self._rings.values())

    def table(self, e2e_s: Optional[float] = None,
              extra: Optional[Dict[str, float]] = None) -> dict:
        """{phase: {seconds, count, p50_ms, p99_ms, share}} + a
        ``_coverage`` row when ``e2e_s`` is given: the fraction of the
        measured end-to-end wall the attributed phases account for.
        ``extra`` folds in phase totals tracked elsewhere (StepTimer
        total_ms, codec seconds) as {phase: seconds} without sample
        rings."""
        out: dict = {}
        total = 0.0
        for name, ring in self._rings.items():
            p50, p99 = ring.percentiles()
            out[name] = {
                "seconds": round(ring.total, 4),
                "count": ring.count,
                "p50_ms": round(p50 * 1000.0, 4),
                "p99_ms": round(p99 * 1000.0, 4),
            }
            total += ring.total
        for name, secs in (extra or {}).items():
            row = out.setdefault(
                name, {"seconds": 0.0, "count": 0, "p50_ms": 0.0,
                       "p99_ms": 0.0}
            )
            row["seconds"] = round(row["seconds"] + secs, 4)
            total += secs
        if e2e_s and e2e_s > 0:
            for row in out.values():
                row["share"] = round(row["seconds"] / e2e_s, 4)
            out["_coverage"] = round(total / e2e_s, 4)
        return out

    def merge(self, other: "PhaseProfile") -> None:
        for name, ring in other._rings.items():
            mine = self._rings.get(name)
            if mine is None:
                mine = self._rings[name] = _Ring()
            mine.merge(ring)


class SpanLog:
    """Sampled protocol-round spans: 1/N of worker->hub sends open a span
    keyed by the transport's (networkId, seq) stamp (a local per-stream
    counter stands in when the reliable channel is unarmed); the next
    hub->worker delivery on that stream closes it with the round-trip
    latency. Completed spans land in a bounded ring and (optionally) a
    JSONL file — compact records an operator can join across processes.

    One outstanding span per (networkId, hubId, workerId) stream: protocol
    rounds on one stream are serial (the worker blocks or proceeds, but
    reply k answers send k), so a second sampled send before the reply
    would measure queueing noise — the sampler skips it instead."""

    def __init__(self, sample: int, path: str = "", cap: int = SPAN_RING_CAP,
                 clock: Callable[[], float] = time.perf_counter):
        self.sample = int(sample)
        self.path = path
        self.cap = int(cap)
        self._clock = clock
        self._file = None
        self._sends: Dict[Tuple[int, int, int], int] = {}
        self._open: Dict[Tuple[int, int, int], Tuple[int, str, float]] = {}
        self.spans: List[dict] = []
        self.opened = 0
        self.completed = 0

    @property
    def active(self) -> bool:
        return self.sample > 0

    def maybe_open(
        self, network_id: int, hub_id: int, worker_id: int, op: str,
        seq: Optional[int],
    ) -> None:
        key = (network_id, hub_id, worker_id)
        n = self._sends.get(key, 0)
        self._sends[key] = n + 1
        if n % self.sample != 0 or key in self._open:
            return
        self._open[key] = (n if seq is None else int(seq), op, self._clock())
        self.opened += 1

    def maybe_close(
        self, network_id: int, hub_id: int, worker_id: int, reply_op: str
    ) -> None:
        key = (network_id, hub_id, worker_id)
        entry = self._open.pop(key, None)
        if entry is None:
            return
        seq, op, t0 = entry
        span = {
            "networkId": network_id,
            "hubId": hub_id,
            "workerId": worker_id,
            "seq": seq,
            "op": op,
            "replyOp": reply_op,
            "rttMs": round((self._clock() - t0) * 1000.0, 4),
        }
        self.completed += 1
        self.spans.append(span)
        if len(self.spans) > self.cap:
            del self.spans[: len(self.spans) - self.cap]
        if self.path:
            try:
                if self._file is None:
                    self._file = open(self.path, "a")
                self._file.write(json.dumps(span) + "\n")
                self._file.flush()
            except OSError:
                self.path = ""  # a full disk must not kill the job

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None


class TelemetryPlane:
    """Job-level telemetry state: the registry, the phase profile, the
    span log, and the heartbeat clock. One instance per StreamJob when
    armed; None (the default) everywhere else."""

    def __init__(
        self,
        cfg: TelemetryConfig,
        wall: Callable[[], float] = time.time,
    ):
        self.cfg = cfg
        self.registry = MetricsRegistry()
        self.phases = PhaseProfile() if cfg.phases else None
        self.spans = SpanLog(cfg.trace_sample, cfg.span_path, cfg.span_cap)
        self._wall = wall
        self.heartbeats_emitted = 0
        # records since the last heartbeat (the count clock)
        self._records_since = 0
        self._last_beat_wall: Optional[float] = None

    # --- the heartbeat clock --------------------------------------------

    def note_records(self, n: int) -> bool:
        """Advance the count clock by ``n`` records; True when the
        count-clocked cadence says a heartbeat is due."""
        self._records_since += n
        self.registry.counter("records", n)
        return (
            self.cfg.stats_every > 0
            and self._records_since >= self.cfg.stats_every
        )

    def idle_due(self, now: Optional[float] = None) -> bool:
        """Wall-clock idle tick: a beat is due when activity is pending
        since the last one and ``idleMs`` elapsed — an idle/paused stream
        still reports what it has instead of going dark until terminate."""
        if self.cfg.idle_ms <= 0 or self._records_since == 0:
            return False
        now = self._wall() if now is None else now
        if self._last_beat_wall is None:
            # records flowed but no beat yet (statsEvery not reached):
            # the idle clock starts at the first pending check — stamped
            # from the CALLER's clock so a caller that injects now
            # (check_silence's pattern) never mixes clock domains
            self._last_beat_wall = now
            return False
        return (now - self._last_beat_wall) * 1000.0 >= self.cfg.idle_ms

    def mark_beat(self, now: Optional[float] = None) -> int:
        """Reset the clocks after an emission; returns the beat seq."""
        self._records_since = 0
        self._last_beat_wall = self._wall() if now is None else now
        self.heartbeats_emitted += 1
        self.registry.counter("heartbeats")
        return self.heartbeats_emitted

    def close(self) -> None:
        self.spans.close()


__all__ = [
    "DEFAULT_IDLE_MS",
    "DEFAULT_STATS_EVERY",
    "MetricsRegistry",
    "PHASES",
    "PhaseProfile",
    "SpanLog",
    "TelemetryConfig",
    "TelemetryPlane",
    "parse_telemetry_spec",
    "telemetry_config",
    "validate_telemetry",
]
