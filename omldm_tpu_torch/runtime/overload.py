"""Overload-control plane: backpressure, fair-share admission, load
shedding and a degradation ladder.

Counterpart of ``omldm_tpu/runtime/overload.py``. The reference leaves
overload to Flink's credit-based network backpressure (SURVEY section 5):
the job has no admission control, a slow operator stalls the Kafka
consumer, and one hot pipeline degrades every co-hosted tenant alike.

Armed per job (``JobConfig.overload``, a spec string) and per pipeline
(``trainingConfiguration.overload``); off by default, and then no
controller object exists anywhere. Armed, each Spoke hosts one
:class:`OverloadController` that

(a) derives a PRESSURE LEVEL (OK / ELEVATED / CRITICAL, with hysteresis)
    from signals the runtime already has: serving queue depth, the
    deferred-work backlog, the tenants' admission imbalance and, when its
    knob arms it, the serve-launch p99 of the spoke's ``StepTimer``;
(b) enforces per-tenant TOKEN-BUDGET rate limits with fair-share refill.
    The budget clock is the ADMISSION STREAM itself (one tick per tenant
    row admitted), never wall time, so every shed and throttle schedule is
    a pure function of the record sequence and a seeded chaos burst
    replays exactly. Each tenant's recent admissions accumulate in a
    counter halved once per fair-share window; its budget is
    ``share x fair_share - count``, a bucket whose refill is the fair share
    of observed traffic, so uniform fan-out never flags anyone while a
    flooded tenant's counter races ahead of the mean. Over-limit flags are
    recomputed at record and block BOUNDARIES (the tick), never mid
    fan-out, or the first tenant served in a block would look hot by
    iteration order;
(c) climbs a DEGRADATION LADDER: under ELEVATED pressure serving
    ``maxBatch``/``maxDelayMs`` widen and exact staleness relaxes for
    over-limit tenants, whose training rows also defer into a bounded ring
    (drained when the tenant recovers or pressure clears; overflow is
    quarantined with reason ``throttled``); under CRITICAL pressure an
    over-limit tenant's forecasts are SHED with reason-coded dead letters
    (``shed_overload``, carrying the tenant and queue depth);
(d) folds into the job's ``StreamJob.overload_level()``, the signal a
    source loop pauses on while any spoke is CRITICAL.

Levels gate ACTIONS; the buckets account continuously, so the plane's cost
when healthy is one bucket update an admission and a strided signal scan.
With the flight recorder armed (``events``, wired by the spoke) every
ladder transition records a ``pressure`` event and the shed and throttle
volume one aggregated ``shed``/``throttle`` event an evaluation window
(``_record_events``); with the telemetry plane armed (the spoke's
``telemetry``) the serve p99 is measured as a signal without the
``p99HighMs`` knob.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from omldm_tpu_torch.runtime.events import PRESSURE, SHED, THROTTLE
from omldm_tpu_torch.runtime.serving import ServeStats, ServingConfig

# pressure levels (the Statistics ``pressureLevel`` gauge reports the peak)
OK = 0
ELEVATED = 1
CRITICAL = 2
LEVEL_NAMES = ("OK", "ELEVATED", "CRITICAL")

# bounded shed-schedule log (determinism tests replay it) and shed-latency
# sample ring caps
SHED_LOG_CAP = 4096
SHED_LATENCY_RING = 1024

# boundary ticks between full signal re-derivations (the O(#tenants)
# rebalance): count-based, so striding costs responsiveness — 8 records
# of flag lag — without costing determinism. Forced evaluations (level
# transitions wanted NOW: idle ticks under a paused source) bypass it.
TICK_STRIDE = 8


@dataclasses.dataclass
class OverloadConfig:
    """Parsed ``trainingConfiguration.overload`` knobs for one pipeline.

    All windows/rates are in ROWS of the admission stream (count-clocked,
    see the module docstring), never seconds — except the optional
    latency-signal thresholds, which are wall-clock by nature and default
    OFF so the controller stays deterministic out of the box."""

    # --- fair-share token budget -------------------------------------
    # per-tenant accounting window, in FAIR-SHARE rows (decayed counters
    # halve once per window x n_tenants global rows; the window also
    # floors the over-limit threshold so trickle traffic never flags)
    window: int = 64
    # fair-share factor: a tenant goes OVER LIMIT when its decayed
    # admission count exceeds share x max(fair_share, window) — share
    # 2.0 tolerates a tenant running at 2x its fair share
    share: float = 2.0
    # absolute per-tenant cap: over limit when the decayed count exceeds
    # tenantRate x window rows (on top of the fair-share rule)
    tenant_rate: float = 0.0
    # --- pressure thresholds -----------------------------------------
    # hottest tenant's EXCESS over the fair-share mean, in decayed rows
    # (uniform traffic scores 0 whatever its volume)
    hot_high: float = 64.0
    hot_critical: float = 256.0
    # serving rows queued on the spoke (runtime/serving.py). ABSOLUTE and
    # opt-in (0 = off, the default): the plane's NORMAL operating depth
    # scales with tenants x maxBatch, so a deployment arming these must
    # set them above its own healthy batching depth
    queue_high: int = 0
    queue_critical: int = 0
    # deferred (throttled) rows held on the spoke
    backlog_high: int = 4096
    backlog_critical: int = 32768
    # serve-launch p99 ms over the StepTimer ring (0 = signal off — it is
    # the one wall-clock signal, so arming it trades determinism)
    p99_high_ms: float = 0.0
    p99_critical_ms: float = 0.0
    # consecutive ticks below every threshold before the level steps DOWN
    # (upward transitions are immediate) — the hysteresis that stops the
    # ladder from flapping at a threshold boundary
    cool: int = 64
    # --- degradation ladder ------------------------------------------
    # ELEVATED+: serving maxBatch/maxDelayMs multiply by this
    widen: float = 4.0
    # ELEVATED+: serving exact staleness relaxes (more batching per
    # launch at bounded model staleness)
    relax: bool = True
    # CRITICAL: over-limit tenants' forecasts shed (reason-coded
    # dead-letter entries) instead of queueing
    shed: bool = True
    # deferral-ring row cap per tenant (oldest rows beyond it are dropped
    # AND quarantined with reason ``throttled``)
    defer_cap: int = 100_000


_KNOBS = {
    "window": ("window", int),
    "share": ("share", float),
    "tenantRate": ("tenant_rate", float),
    "hotHigh": ("hot_high", float),
    "hotCritical": ("hot_critical", float),
    "queueHigh": ("queue_high", int),
    "queueCritical": ("queue_critical", int),
    "backlogHigh": ("backlog_high", int),
    "backlogCritical": ("backlog_critical", int),
    "p99HighMs": ("p99_high_ms", float),
    "p99CriticalMs": ("p99_critical_ms", float),
    "cool": ("cool", int),
    "widen": ("widen", float),
    "relax": ("relax", None),  # bool-ish
    "shed": ("shed", None),
    "deferCap": ("defer_cap", int),
}


def _parse_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def parse_overload_spec(spec) -> Optional[OverloadConfig]:
    """dict / spec-string / True -> OverloadConfig; None / False / "" ->
    None (unarmed). Raises ValueError on unknown knobs or non-positive
    windows — the control gate turns that into a request drop, the job
    constructor into a fail-fast."""
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
                        f"bad overload spec entry {part!r} (want k=v)"
                    )
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
            spec = out
    if not isinstance(spec, dict):
        raise ValueError(
            f"overload spec must be a table, got {type(spec).__name__}"
        )
    unknown = set(spec) - set(_KNOBS)
    if unknown:
        raise ValueError(f"unknown overload knob(s): {sorted(unknown)}")
    cfg = OverloadConfig()
    for key, raw in spec.items():
        field, conv = _KNOBS[key]
        value = _parse_bool(raw) if conv is None else conv(float(raw))
        setattr(cfg, field, value)
    if cfg.window < 1:
        raise ValueError("overload.window must be >= 1")
    if cfg.share <= 0:
        raise ValueError("overload.share must be > 0")
    if cfg.widen < 1.0:
        raise ValueError("overload.widen must be >= 1")
    if cfg.cool < 1:
        raise ValueError("overload.cool must be >= 1")
    if cfg.hot_critical < cfg.hot_high:
        raise ValueError("overload.hotCritical must be >= hotHigh")
    if cfg.defer_cap < 1:
        raise ValueError("overload.deferCap must be >= 1")
    return cfg


def overload_config(tc, job_spec: str = "") -> Optional[OverloadConfig]:
    """The pipeline's overload config: ``trainingConfiguration.overload``
    wins (including an explicit False = opt out of the job default);
    otherwise the job-wide ``JobConfig.overload`` spec string applies.
    None = unarmed, the exact pre-plane routes."""
    extra = getattr(tc, "extra", None) or {}
    if "overload" in extra:
        return parse_overload_spec(extra["overload"])
    return parse_overload_spec(job_spec or "")


def validate_overload(tc) -> Optional[str]:
    """Control-gate twin of :func:`overload_config`: the error string for
    an undeployable overload table, or None (mirrors the serving/codec
    gates — a bad request drops at admission instead of killing the
    job)."""
    try:
        overload_config(tc)
    except (ValueError, TypeError) as exc:
        return str(exc)
    return None


class _TenantState:
    """One tenant's admission accounting: a decayed recent-admissions
    counter (the count-clocked token budget's consumption side)."""

    __slots__ = ("count", "last_window")

    def __init__(self, clock: int, span: int):
        self.count = 0.0
        self.last_window = clock // max(span, 1)


class OverloadController:
    """Per-spoke overload controller: admission accounting, pressure
    derivation, ladder state, shed/throttle counters.

    ``spoke`` provides the signals (serving plane depth, serve timer) and
    executes the actions (defer, shed, drain) — the controller only
    decides. ``clock`` is the wall clock used by the OPTIONAL latency
    signal and shed-latency accounting; every admission/fairness decision
    runs on the count clock instead (see module docstring)."""

    def __init__(self, spoke, clock: Callable[[], float] = time.perf_counter):
        self.spoke = spoke
        self._clock = clock
        self.level = OK
        #: worst level ever reached (the Statistics pressureLevel gauge)
        self.level_peak = OK
        self._below = 0  # consecutive ticks with every signal below HIGH
        #: global admission clock: one tick per (tenant, row) admitted
        self.clock = 0
        self._tenants: Dict[int, _TenantState] = {}
        self._configs: Dict[int, OverloadConfig] = {}
        # over-limit flags + hot signal, recomputed at boundary ticks
        self._over: set = set()
        self._hot = 0.0
        self._n_live = 1
        # tick striding: full signal re-derivation every TICK_STRIDE
        # boundary ticks (count-based — deterministic)
        self._ticks = 0
        self._last_eval = 0
        #: pressure/ladder knobs: the job-level config when set, else the
        #: first armed pipeline's (per-tenant admission knobs always come
        #: from the tenant's own config)
        self.config: Optional[OverloadConfig] = None
        # deferred training rows per tenant (the ELEVATED ladder rung);
        # buffers are runtime/spoke._PauseBuffer instances, owned here so
        # they never entangle with the cooperative-pause machinery
        self.deferred: Dict[int, Any] = {}
        # per-tenant fold-once counters (reset when the spoke folds them
        # into the pipeline's hub statistics at query/terminate)
        self._shed: Dict[int, int] = {}
        self._throttled: Dict[int, int] = {}
        self._shed_lat: Dict[int, ServeStats] = {}
        #: bounded (clock, tenant, rows) shed schedule — the determinism
        #: pin's replay target
        self.shed_log: List[Tuple[int, int, int]] = []
        #: cumulative totals (survive folds; observability)
        self.total_shed = 0
        self.total_throttled = 0
        #: named external signals (e.g. prefetch occupancy): callables
        #: returning a (value, high, critical) triple, scanned at tick
        self.extra_signals: Dict[str, Callable[[], Tuple[float, float, float]]] = {}
        # degraded-serving cache: (tenant, level) -> ServingConfig
        self._eff: Dict[Tuple[int, int], ServingConfig] = {}
        # flight-recorder journal (runtime/events.EventJournal) or None:
        # ladder transitions record through it, and shed/throttle volume
        # records AGGREGATED at evaluation ticks (one event per window of
        # activity, never one per flooded record — the recorder must stay
        # far cheaper than the flood it documents)
        self.events = None
        self._ev_shed = 0
        self._ev_throttled = 0

    # --- membership ------------------------------------------------------

    def arm(self, net) -> None:
        """Register one overload-armed net (it starts with a clean,
        in-budget counter)."""
        nid = net.request.id
        cfg = net.overload
        self._configs[nid] = cfg
        if self.config is None:
            self.config = cfg
        self._tenants[nid] = _TenantState(
            self.clock, cfg.window * max(len(self._tenants) + 1, 1)
        )
        self._n_live = max(len(self._tenants), 1)
        # a re-created pipeline (Update) may carry new knobs, and its
        # over-limit flag must not survive the teardown
        self._over.discard(nid)
        self._eff = {k: v for k, v in self._eff.items() if k[0] != nid}
        net._octl = self

    def retire(self, nid: int) -> None:
        """Drop a deleted tenant's accounting (its deferred rows go with
        it, like the net's pause buffer does)."""
        self._tenants.pop(nid, None)
        self._configs.pop(nid, None)
        self.deferred.pop(nid, None)
        self._over.discard(nid)
        self._n_live = max(len(self._tenants), 1)
        self._eff = {k: v for k, v in self._eff.items() if k[0] != nid}

    @property
    def n_live(self) -> int:
        return self._n_live

    # --- fair-share token budget (count-clocked) -------------------------

    def _decay(self, st: _TenantState, cfg: OverloadConfig) -> None:
        """Halve the tenant's recent-admissions counter once per elapsed
        fair-share window (window x n_live global rows) — lazy, so the
        per-admission cost stays O(1)."""
        span = max(cfg.window * self.n_live, 1)
        w = self.clock // span
        if w > st.last_window:
            st.count *= 0.5 ** (w - st.last_window)
            st.last_window = w

    def spend(self, net, rows: int = 1) -> bool:
        """Account ``rows`` admissions for ``net``'s tenant and return its
        OVER-LIMIT flag. Accounting always runs (even at level OK) so the
        signals are warm when pressure arrives; the flag itself was
        computed at the LAST evaluated boundary tick — mid-fan-out
        recomputation would flag tenants by iteration order, not by
        load. Decay is deferred to the evaluation points (O(1) here)."""
        nid = net.request.id
        st = self._tenants.get(nid)
        self.clock += rows
        if st is None:
            return False
        st.count += rows
        return nid in self._over

    def is_over(self, nid: int) -> bool:
        """The tenant's over-limit flag as of the last boundary tick."""
        return nid in self._over

    def budget(self, nid: int) -> float:
        """Remaining fair-share token budget (share x limit base minus
        the decayed recent count; negative = over). Observability and
        tests — admission uses the boundary flags."""
        st = self._tenants.get(nid)
        if st is None:
            return 0.0
        cfg = self._configs[nid]
        self._decay(st, cfg)
        return self._limit(cfg) - st.count

    def _fair(self) -> float:
        total = 0.0
        for nid, st in self._tenants.items():
            self._decay(st, self._configs[nid])
            total += st.count
        return total / self.n_live

    def _limit(self, cfg: OverloadConfig) -> float:
        limit = cfg.share * max(self._fair(), float(cfg.window))
        if cfg.tenant_rate > 0:
            limit = min(limit, cfg.tenant_rate * cfg.window)
        return limit

    def _rebalance(self) -> float:
        """Boundary recomputation: decay every counter, recompute each
        tenant's over-limit flag against share x max(fair, window) (and
        its absolute tenantRate cap), and return the hot signal — the
        hottest tenant's EXCESS over the fair-share mean (uniform
        traffic scores 0 whatever its volume)."""
        fair = self._fair()  # decays every counter as it sums
        hot = 0.0
        over = set()
        for nid, st in self._tenants.items():
            cfg = self._configs[nid]
            excess = st.count - fair
            if excess > hot:
                hot = excess
            limit = cfg.share * max(fair, float(cfg.window))
            if st.count > limit or (
                cfg.tenant_rate > 0
                and st.count > cfg.tenant_rate * cfg.window
            ):
                over.add(nid)
        self._over = over
        self._hot = hot
        return hot

    # --- pressure --------------------------------------------------------

    def backlog_rows(self) -> int:
        return sum(len(b) for b in self.deferred.values())

    def signals(self) -> Dict[str, float]:
        """The raw pressure signals (observability + the tick input;
        ``hot`` is as of the last boundary rebalance).

        The serve-launch p99 — the one wall-clock signal — is measured
        when its threshold knob arms it (``p99HighMs > 0``, the
        pre-telemetry contract) OR when the job's telemetry plane is
        armed: arming telemetry makes the latency signal available to
        the ladder without a separate knob (the thresholds still gate
        whether it ACTS; un-thresholded it is observability only)."""
        spoke = self.spoke
        plane = getattr(spoke, "serving_plane", None)
        out = {
            "hot": self._hot,
            "queue": float(plane.queued()) if plane is not None else 0.0,
            "backlog": float(self.backlog_rows()),
        }
        cfg = self.config
        if (cfg is not None and cfg.p99_high_ms > 0) or getattr(
            spoke, "telemetry", None
        ) is not None:
            out["p99_ms"] = spoke.serve_timer.recent_p99()
        return out

    def _target_level(self) -> int:
        cfg = self.config
        if cfg is None:
            return OK
        sig = self.signals()
        pairs = [
            (sig["hot"], cfg.hot_high, cfg.hot_critical),
            (sig["queue"], cfg.queue_high, cfg.queue_critical),
            (sig["backlog"], cfg.backlog_high, cfg.backlog_critical),
        ]
        if "p99_ms" in sig:
            pairs.append(
                (sig["p99_ms"], cfg.p99_high_ms,
                 cfg.p99_critical_ms or float("inf"))
            )
        for probe in self.extra_signals.values():
            pairs.append(probe())
        level = OK
        for value, high, critical in pairs:
            if critical > 0 and value >= critical:
                return CRITICAL
            if high > 0 and value >= high:
                level = ELEVATED
        return level

    def tick(self, force: bool = False) -> Tuple[int, int]:
        """Re-derive the pressure level. Upward transitions apply
        immediately (at evaluation ticks); downward ones only after
        ``cool`` consecutive boundary ticks below every HIGH threshold
        (hysteresis). The O(#tenants) re-derivation runs every
        TICK_STRIDE boundary ticks (count-based, still deterministic);
        ``force`` evaluates now. Returns (old, new)."""
        old = self.level
        self._ticks += 1
        gap = self._ticks - self._last_eval
        if not force and gap < TICK_STRIDE:
            return old, self.level
        self._last_eval = self._ticks
        self._rebalance()
        target = self._target_level()
        if target >= self.level:
            self.level = target
            self._below = 0
        else:
            self._below += gap
            if self._below >= (self.config.cool if self.config else 1):
                self.level = target
                self._below = 0
        if self.level > self.level_peak:
            self.level_peak = self.level
        if self.events is not None:
            self._record_events(old)
        return old, self.level

    def _record_events(self, old: int) -> None:
        """Flight-recorder fold at an evaluation tick: one ``pressure``
        event per ladder transition, one aggregated ``shed``/``throttle``
        event per window with new volume (count-clocked — same-seed
        bursts replay the same event stream)."""
        if self.level != old:
            self.events.record(
                PRESSURE, LEVEL_NAMES[self.level], old=old, new=self.level,
                hot=round(self._hot, 3), over=sorted(self._over),
            )
        if self.total_shed > self._ev_shed:
            self.events.record(
                SHED, "overload_critical",
                rows=self.total_shed - self._ev_shed,
            )
            self._ev_shed = self.total_shed
        if self.total_throttled > self._ev_throttled:
            self.events.record(
                THROTTLE, "overload_elevated",
                rows=self.total_throttled - self._ev_throttled,
            )
            self._ev_throttled = self.total_throttled

    def idle_tick(self, rows: Optional[int] = None) -> None:
        """Advance the count clock while the source is PAUSED (upstream
        backpressure): nothing admits while paused, so without this the
        buckets would never refill, the overflow never decay, and the
        level never drop — the pause would dead-lock itself. One idle
        tick models a quarter-window of recovered capacity."""
        cfg = self.config
        if cfg is None:
            return
        if rows is None:
            rows = max(cfg.window * self.n_live // 4, 1)
        self.clock += rows
        self.tick(force=True)

    # --- degradation ladder ---------------------------------------------

    def degraded_serving(self, net) -> ServingConfig:
        """The EFFECTIVE serving config for ``net`` at the current level:
        widened maxBatch/maxDelayMs (x ``widen``) and (opt-out
        ``relax=false``) relaxed staleness — more rows per predict
        launch, bounded extra latency/staleness, instead of one launch
        per starved queue.

        Scope is the FAIRNESS story: the degradation applies to
        OVER-LIMIT tenants only — healthy tenants keep their exact
        config and latency budget while the hot tenant batches harder.
        Only a CRITICAL level with NO over-limit tenant (uniform global
        overload, e.g. an armed queue/backlog/p99 signal firing without
        imbalance) widens everyone. Cached per (tenant, level)."""
        cfg = net.serving
        if cfg is None or self.level == OK:
            return cfg
        nid = net.request.id
        if nid not in self._over and not (
            self.level >= CRITICAL and not self._over
        ):
            return cfg
        key = (nid, self.level)
        out = self._eff.get(key)
        if out is None:
            ocfg = self._configs.get(nid) or self.config
            out = ServingConfig(
                max_batch=max(int(cfg.max_batch * ocfg.widen), 1),
                max_delay_ms=cfg.max_delay_ms * ocfg.widen,
                staleness=(
                    "relaxed" if ocfg.relax else cfg.staleness
                ),
                stale_chunks=cfg.stale_chunks,
            )
            self._eff[key] = out
        return out

    # --- shed / throttle accounting -------------------------------------

    def note_shed(
        self, nid: int, rows: int, latency_ms: Optional[float] = None
    ) -> None:
        """Count ``rows`` shed forecasts. ``latency_ms`` is the
        enqueue->shed WAIT and only applies to queue-drain sheds —
        admission-time refusals never waited, and noting them as 0 would
        drown the percentile in zeros."""
        self._shed[nid] = self._shed.get(nid, 0) + rows
        self.total_shed += rows
        if latency_ms is not None:
            stats = self._shed_lat.get(nid)
            if stats is None:
                stats = self._shed_lat[nid] = ServeStats(
                    cap=SHED_LATENCY_RING
                )
            stats.note(latency_ms)
        if len(self.shed_log) < SHED_LOG_CAP:
            self.shed_log.append((self.clock, nid, rows))

    def note_throttled(self, nid: int, rows: int) -> None:
        self._throttled[nid] = self._throttled.get(nid, 0) + rows
        self.total_throttled += rows

    def take_shed(self, nid: int) -> int:
        return self._shed.pop(nid, 0)

    def take_throttled(self, nid: int) -> int:
        return self._throttled.pop(nid, 0)

    def shed_latency_p99(self, nid: int) -> float:
        stats = self._shed_lat.get(nid)
        if stats is None or stats.count == 0:
            return 0.0
        return stats.percentiles()[1]

    def drainable(self) -> List[int]:
        """Tenants whose deferred rows may re-enter the stream now: the
        whole backlog at level OK, recovered (no longer over-limit)
        tenants at any level."""
        out = []
        for nid, buf in self.deferred.items():
            if len(buf) and (self.level == OK or not self.is_over(nid)):
                out.append(nid)
        return out

    def now(self) -> float:
        return self._clock()
