"""Model lifecycle plane: versioned registry, shadow scoring, canary rollout.

Counterpart of ``omldm_tpu/runtime/lifecycle.py``. The reference keeps one
live model a pipeline: ``FlinkSpoke`` trains and serves a single mutable
learner, and its only "rollout" is a destructive Update that tears the old
model down and cold-starts the new one (PipelineMap.scala:43-47,
FlinkSpoke.scala:155-160).

This module turns the runtime into a versioned serving fleet, armed per
pipeline by ``trainingConfiguration.lifecycle`` (or the job-wide
``JobConfig.lifecycle`` default spec). Unarmed, no lifecycle object exists
and every route is the plain one.

The state machine of a candidate version::

    registered --Shadow--> shadow --Promote--> canary --auto--> active
                              |                   |
                              +---- guard trip / score regression ----> rolled_back
                              +---- operator Rollback ----------------> rolled_back

- **Registry**: each (spoke, pipeline) holds a :class:`LifecycleState`
  whose :class:`VersionEntry` rows keep flat parameter vectors
  (``MLPipeline.get_flat_params``, the row shape of the cohort's ``[C, P]``
  matrix). Version 0 is the Create-time model and starts ``active``.
- **Shadow scoring**: a ``Shadow`` request registers a candidate (its own
  ``MLPipeline``, typically with other hyper-parameters) that trains on the
  SAME flushed micro-batches as the active version and is scored on the
  SAME holdout set; serving stays on the active version, whose state,
  batches and predictions are untouched. Under ``perRecord`` the
  candidate's fit is a second solo ``pa_scan`` launch beside the active
  one's.
- **Canary routing**: a ``Promote`` request starts a percentage ramp. The
  split is a seeded hash of the net's forecast COUNT CLOCK
  (:func:`canary_hash`), so a routing schedule is a pure function of the
  record sequence. Candidate-routed forecasts serve at once through the
  candidate and carry its version tag (``Prediction.version``); the others
  take the baseline path as before.
- **Guard-fenced rollback**: the candidate always carries a
  ``guard.ModelGuard`` (the pipeline's own config, or defaults). A trip, or
  a shadow score regressing past ``scoreEnvelope``, demotes the candidate
  to ``rolled_back`` and routing snaps back to the baseline, which never
  moved.
- **Promotion**: once the ramp reaches ``rampTo`` and the candidate has
  served ``promoteAfter`` canary forecasts at it with healthy shadow
  scores, it becomes the active version; the outgoing model is retained for
  an operator ``Rollback``.

Decision clocks count fits and forecasts, never wall time, so decisions are
deterministic and a checkpoint restored mid-canary reaches the same one.
The registry lives per (spoke, pipeline): at parallelism > 1 each worker
decides on its own share of the stream. Candidates must keep the
baseline's flat-parameter size (a promotion swaps the protocol node's
pipeline under a hub that keeps its state). With the flight recorder armed
(``events``, wired by the spoke) every canary transition records a
``lifecycle`` event (:meth:`LifecycleState._event`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec
from omldm_tpu_torch.runtime.events import LIFECYCLE

# version states
REGISTERED = "registered"
SHADOW = "shadow"
CANARY = "canary"
ACTIVE = "active"
ROLLED_BACK = "rolled_back"

# candidate-demotion reason codes (alongside the guard's trip reasons)
REASON_SCORE_REGRESSED = "score_regressed"
REASON_OPERATOR = "operator"

DEFAULT_RAMP_FROM = 0.0
DEFAULT_RAMP_TO = 0.5
DEFAULT_RAMP_EVERY = 256
DEFAULT_RAMP_STEP = 0.1
DEFAULT_PROMOTE_AFTER = 512
DEFAULT_SHADOW_EVERY = 64
DEFAULT_MIN_SHADOW_EVALS = 2
DEFAULT_SCORE_ENVELOPE = 0.05
DEFAULT_MAX_VERSIONS = 8

# candidate padded-predict bucket floor (mirrors the spoke's PREDICT_BATCH
# without importing it — runtime.spoke imports this module)
_PREDICT_BATCH = 16

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Parsed ``trainingConfiguration.lifecycle`` knobs for one pipeline."""

    # canary ramp: fraction of forecasts routed to the candidate starts at
    # ramp_from and steps by ramp_step every ramp_every canary-era
    # forecasts, capped at ramp_to
    ramp_from: float = DEFAULT_RAMP_FROM
    ramp_to: float = DEFAULT_RAMP_TO
    ramp_every: int = DEFAULT_RAMP_EVERY
    ramp_step: float = DEFAULT_RAMP_STEP
    # canary forecasts the candidate must serve AT the full ramp before
    # auto-promotion fires
    promote_after: int = DEFAULT_PROMOTE_AFTER
    # candidate fits between shadow evaluations (holdout-set scoring of
    # candidate AND baseline)
    shadow_every: int = DEFAULT_SHADOW_EVERY
    # shadow evaluations required before the envelope verdict (and before
    # promotion). 0 disables shadow gating — the production-mode (test
    # off, no holdout) escape hatch
    min_shadow_evals: int = DEFAULT_MIN_SHADOW_EVALS
    # max tolerated candidate score regression vs the baseline's score on
    # the same holdout window before auto-rollback
    score_envelope: float = DEFAULT_SCORE_ENVELOPE
    # canary hash-route seed (same schedule <=> same seed)
    seed: int = 0
    # registry ring bound: oldest retired versions beyond this drop
    max_versions: int = DEFAULT_MAX_VERSIONS


_KNOBS = {
    "rampFrom": ("ramp_from", float),
    "rampTo": ("ramp_to", float),
    "rampEvery": ("ramp_every", int),
    "rampStep": ("ramp_step", float),
    "promoteAfter": ("promote_after", int),
    "shadowEvery": ("shadow_every", int),
    "minShadowEvals": ("min_shadow_evals", int),
    "scoreEnvelope": ("score_envelope", float),
    "seed": ("seed", int),
    "maxVersions": ("max_versions", int),
}


def _parse_spec_str(spec: str) -> dict:
    """``"rampTo=0.5,rampEvery=64,seed=7"`` -> dict; the bare ``"on"``
    selects defaults."""
    spec = spec.strip()
    if spec.lower() == "on":
        return {}
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad lifecycle spec entry {part!r} (want k=v)")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def parse_lifecycle_spec(spec) -> Optional[LifecycleConfig]:
    """dict / spec-string / True -> LifecycleConfig; None / False / "" ->
    None (unarmed). Raises ValueError on unknown knobs or out-of-range
    values — callers at the control gate turn that into a request drop."""
    if spec is None or spec is False or spec == "":
        return None
    if spec is True:
        spec = {}
    if isinstance(spec, str):
        spec = _parse_spec_str(spec)
    if not isinstance(spec, dict):
        raise ValueError(
            f"lifecycle spec must be a table, got {type(spec).__name__}"
        )
    unknown = set(spec) - set(_KNOBS)
    if unknown:
        raise ValueError(f"unknown lifecycle knob(s): {sorted(unknown)}")
    kwargs = {}
    for key, (field, cast) in _KNOBS.items():
        if key in spec:
            kwargs[field] = cast(spec[key])
    cfg = LifecycleConfig(**kwargs)
    if not (0.0 <= cfg.ramp_from <= cfg.ramp_to <= 1.0):
        raise ValueError(
            "lifecycle ramp must satisfy 0 <= rampFrom <= rampTo <= 1"
        )
    if cfg.ramp_every < 1:
        raise ValueError("lifecycle.rampEvery must be >= 1")
    if cfg.ramp_step <= 0:
        raise ValueError("lifecycle.rampStep must be > 0")
    if cfg.promote_after < 1:
        raise ValueError("lifecycle.promoteAfter must be >= 1")
    if cfg.shadow_every < 1:
        raise ValueError("lifecycle.shadowEvery must be >= 1")
    if cfg.min_shadow_evals < 0:
        raise ValueError("lifecycle.minShadowEvals must be >= 0")
    if cfg.score_envelope < 0:
        raise ValueError("lifecycle.scoreEnvelope must be >= 0")
    if cfg.max_versions < 2:
        raise ValueError("lifecycle.maxVersions must be >= 2")
    return cfg


def lifecycle_config(tc, job_spec: str = "") -> Optional[LifecycleConfig]:
    """The pipeline's lifecycle config: ``trainingConfiguration.lifecycle``
    wins (including an explicit False = opt out of the job default);
    otherwise the job-wide ``JobConfig.lifecycle`` spec string applies.
    None = unarmed, the exact pre-plane code paths."""
    extra = getattr(tc, "extra", None) or {}
    if "lifecycle" in extra:
        return parse_lifecycle_spec(extra["lifecycle"])
    return parse_lifecycle_spec(job_spec or "")


def validate_lifecycle(request) -> Optional[str]:
    """Control-gate twin of :func:`lifecycle_config`: the error string for
    an undeployable lifecycle table, or None. Mirrors the serving/overload
    gates — a bad request must drop at admission, not raise at SpokeNet
    construction and kill the job. Also rejects the combinations the plane
    cannot serve: sparse learners (the candidate predict/flat-param paths
    are dense) and the SPMD collective engine (lifecycle lives on the host
    plane's spoke replicas)."""
    tc = request.training_configuration
    try:
        cfg = parse_lifecycle_spec((tc.extra or {}).get("lifecycle"))
    except (ValueError, TypeError) as exc:
        return str(exc)
    if cfg is None:
        return None
    ds = (request.learner.data_structure or {}) if request.learner else {}
    if ds.get("sparse"):
        return "lifecycle plane supports dense learners only"
    if str(tc.extra.get("engine", "")).lower() == "spmd":
        return "lifecycle plane is host-plane only"
    return None


def canary_hash(seed: int, n: int) -> float:
    """Deterministic route hash for the ``n``-th canary-era forecast of a
    seeded stream -> [0, 1). splitmix64 finalizer: well-mixed (adjacent
    clocks decorrelate), dependency-free, and a pure function of
    (seed, n) so the canary split is stable and replayable — the same
    count-clocked determinism contract as the overload plane's token
    buckets."""
    z = (int(n) + 1 + (int(seed) << 17)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z = z ^ (z >> 31)
    return (z >> 11) / float(1 << 53)


def build_candidate(net, request, version: int):
    """Construct a Shadow request's candidate pipeline: the candidate
    learner (new hyper-parameters — the "new model configuration") over
    the net's feature width, with the request's preprocessors (falling
    back to the live pipeline's chain) and a deterministic seed.
    ``per_record`` is an execution-mode knob of the PIPELINE, not of the
    model configuration, so the candidate inherits the live pipeline's —
    shadow scores must compare two models under one training regime. The
    candidate is ALWAYS guard-armed — the pipeline's own guard config, or
    defaults — because the guard trip is the canary's rollback fence.
    The candidate lives on the net's device (a CUDA net's candidate fits
    through the same kernel wrappers as the active model). Returns
    (pipeline, spec_dict); the spec dict is what checkpoints persist to
    rebuild the candidate on restore."""
    import torch

    from omldm_tpu_torch.guard import GuardConfig, guard_config
    from omldm_tpu_torch.pipelines import MLPipeline

    preps = list(request.preprocessors or net.request.preprocessors)
    per_record = net.request.training_configuration.per_record
    gcfg = guard_config(net.request.training_configuration) or GuardConfig()
    pipe = MLPipeline(
        request.learner,
        preps,
        dim=net.dim,
        # seeded from the request id and the version, as the JAX package
        # keys its PRNG
        generator=torch.Generator().manual_seed(
            (net.request.id * 1_000_003 + version) & 0x7FFFFFFF
        ),
        per_record=per_record,
        device=net.device,
        guard=gcfg,
    )
    # the spec is what checkpoints persist to rebuild the candidate; the
    # training regime (per_record) is NOT part of it — a rebuilt candidate
    # inherits the live pipeline's, exactly like this build did
    spec = {
        "learner": request.learner.to_dict(),
        "preProcessors": [p.to_dict() for p in preps],
    }
    return pipe, spec


def _version_zero_pipeline(net):
    """Rebuild version 0 — the net's Create-spec model — through the ONE
    Create-pipeline recipe (runtime.spoke.create_pipeline), so this can
    never drift from what SpokeNet construction built."""
    from omldm_tpu_torch.runtime.spoke import create_pipeline

    return create_pipeline(net.request, net.dim, net.device)


def _pipeline_from_spec(net, spec: dict, version: int):
    """Rebuild a versioned pipeline from its persisted spec (restore) —
    through :func:`build_candidate`, so construction (rng, guard arming,
    per-record inheritance) cannot drift from the live Shadow path."""
    shadow_like = dataclasses.replace(
        net.request,
        learner=LearnerSpec.from_dict(spec["learner"]),
        preprocessors=[
            PreprocessorSpec.from_dict(p)
            for p in spec.get("preProcessors", [])
        ],
    )
    pipe, _ = build_candidate(net, shadow_like, version)
    return pipe


def _safe_flat(pipeline) -> Optional[np.ndarray]:
    """A pipeline's flat-param registry row, or None for host-side state
    the raveler cannot flatten."""
    try:
        flat, _ = pipeline.get_flat_params()
        return np.asarray(flat, np.float32).copy()
    except Exception:
        return None


@dataclasses.dataclass
class VersionEntry:
    """One registry row: a model version's state, its flat-param vector
    (the cohort-matrix row shape), and its shadow/canary telemetry."""

    version: int
    state: str
    # candidate rebuild spec ({"learner", "preProcessors", "perRecord"});
    # None for version 0, whose spec IS the pipeline's Create request
    spec: Optional[dict] = None
    # flat parameter row — captured when the version stops being live
    # (demotion, promotion hand-off); None while a live pipeline holds it
    flat: Optional[np.ndarray] = None
    # the live MLPipeline for versions still held in memory (the
    # candidate; the pre-promotion model retained for operator Rollback)
    pipeline: Any = None
    shadow_score: Optional[float] = None
    baseline_score: Optional[float] = None
    shadow_evals: int = 0
    canary_served: int = 0
    # canary serves AT the full ramp (canary_pct == rampTo) — the count
    # the promoteAfter threshold compares, so promotion always reflects
    # exposure at the configured target traffic share, not partial-ramp
    # trickle
    ramp_served: int = 0
    fits: int = 0
    trip_reason: Optional[str] = None

    def describe(self) -> dict:
        return {
            "version": self.version,
            "state": self.state,
            "shadowScore": self.shadow_score,
            "baselineScore": self.baseline_score,
            "shadowEvals": self.shadow_evals,
            "canaryServed": self.canary_served,
            "rampServed": self.ramp_served,
            "fits": self.fits,
            "tripReason": self.trip_reason,
        }


class LifecycleState:
    """Per-(spoke, pipeline) version registry + decision clocks.

    The hosting :class:`~omldm_tpu_torch.runtime.spoke.SpokeNet` owns one of
    these when the plane is armed; the Spoke calls :meth:`tick` at record/
    block boundaries (next to the guard tick) and executes the returned
    decision — the MECHANICS of promotion/rollback (queue flush, codec
    reset, protocol resync) live on the Spoke, the POLICY lives here so it
    can be unit-tested and checkpointed without a runtime."""

    def __init__(self, cfg: LifecycleConfig):
        self.cfg = cfg
        self.versions: Dict[int, VersionEntry] = {
            0: VersionEntry(0, ACTIVE)
        }
        self.active_version = 0
        self.candidate: Optional[int] = None
        self._next = 1
        self.canary_pct = 0.0
        # canary-era forecast count clock (the route hash input)
        self.forecast_clock = 0
        self._fits_since_eval = 0
        # persistent candidate padded-predict scratch (pow2 buckets,
        # floored at the per-record predict width)
        self._scratch: Optional[np.ndarray] = None
        # statistics: pending fold deltas (drained at query/terminate via
        # take_counters) + running totals (describe/observability)
        self._pending = {
            "shadow_scored": 0,
            "canary_promotions": 0,
            "canary_rollbacks": 0,
        }
        self.totals = dict(self._pending)
        # flight-recorder journal + the pipeline id events are tagged
        # with (wired by the Spoke when the plane is armed); None (the
        # default) = no recording anywhere in the state machine
        self.events = None
        self.net_id: Optional[int] = None

    def _event(self, cause: str, **fields) -> None:
        """Record one canary state-machine transition (kind
        ``lifecycle``) when the flight recorder is armed."""
        if self.events is not None:
            self.events.record(
                LIFECYCLE, cause, pipeline=self.net_id, **fields
            )

    # --- registry views --------------------------------------------------

    @property
    def next_version(self) -> int:
        """The version id the next :meth:`arm_shadow` will assign — the
        Spoke builds the candidate (whose rng seeds on the version) before
        registering it."""
        return self._next

    @property
    def candidate_entry(self) -> Optional[VersionEntry]:
        if self.candidate is None:
            return None
        return self.versions.get(self.candidate)

    @property
    def training_active(self) -> bool:
        """Whether a candidate version is live (shadow or canary) and must
        see every flushed training batch."""
        e = self.candidate_entry
        return e is not None and e.state in (SHADOW, CANARY)

    @property
    def canary_active(self) -> bool:
        e = self.candidate_entry
        return e is not None and e.state == CANARY

    @property
    def previous(self) -> Optional[VersionEntry]:
        """The most recent registered version still holding its pipeline —
        the operator-``Rollback`` reactivation target after a promotion."""
        best = None
        for e in self.versions.values():
            if e.state == REGISTERED and e.pipeline is not None:
                if best is None or e.version > best.version:
                    best = e
        return best

    def _bump(self, key: str, n: int = 1) -> None:
        self._pending[key] += n
        self.totals[key] += n

    def take_counters(self) -> Dict[str, int]:
        """Drain the pending statistics deltas (the query/terminate fold,
        same once-semantics as the spoke's launch-tally fold)."""
        out = {k: v for k, v in self._pending.items() if v}
        for k in self._pending:
            self._pending[k] = 0
        return out

    def _trim(self) -> None:
        """Bound the registry: oldest retired (non-active, non-candidate)
        versions beyond ``maxVersions`` drop, their pipelines released."""
        while len(self.versions) > self.cfg.max_versions:
            victims = [
                v
                for v in sorted(self.versions)
                if v != self.active_version and v != self.candidate
            ]
            if not victims:
                return
            self.versions.pop(victims[0])

    # --- state transitions ----------------------------------------------

    def arm_shadow(self, pipeline, spec: dict) -> int:
        """Register a candidate and enter shadow mode. A prior candidate
        (re-issued Shadow) demotes to ``registered`` — replaced, not
        tripped."""
        if self.candidate is not None:
            self.demote_candidate(None, to_state=REGISTERED)
        v = self._next
        self._next += 1
        pipeline.version = v
        entry = VersionEntry(v, SHADOW, spec=spec, pipeline=pipeline)
        self.versions[v] = entry
        self.candidate = v
        self.canary_pct = 0.0
        self.forecast_clock = 0
        self._fits_since_eval = 0
        self._trim()
        self._event("shadow_armed", version=v)
        return v

    def start_canary(self) -> bool:
        """Promote request on a shadow candidate: begin the traffic ramp."""
        e = self.candidate_entry
        if e is None or e.state != SHADOW:
            return False
        e.state = CANARY
        self.canary_pct = self.cfg.ramp_from
        self.forecast_clock = 0
        self._event(
            "canary_started", version=e.version, pct=self.canary_pct
        )
        return True

    def demote_candidate(
        self, reason: Optional[str], to_state: str = ROLLED_BACK
    ) -> Optional[VersionEntry]:
        """Take the candidate out of rotation. ``reason`` non-None marks a
        tripped rollback (guard fence, score envelope, operator rollback)
        and counts into ``canaryRollbacks``; None is a silent replace."""
        e = self.candidate_entry
        if e is None:
            return None
        e.trip_reason = reason
        e.state = to_state
        if e.pipeline is not None:
            e.flat = _safe_flat(e.pipeline)
        e.pipeline = None  # the live candidate model is released; row kept
        self.candidate = None
        self.canary_pct = 0.0
        if reason is not None:
            self._bump("canary_rollbacks")
            self._event("canary_rolled_back", version=e.version,
                        reason=reason)
        else:
            self._event("candidate_replaced", version=e.version)
        return e

    def promote(self, net) -> Any:
        """Registry bookkeeping for a promotion: the candidate becomes the
        active version, the outgoing model is retained (flat row + live
        pipeline) for operator Rollback. Returns the new active pipeline;
        the Spoke performs the runtime swap."""
        e = self.candidate_entry
        old = self.versions[self.active_version]
        old.state = REGISTERED
        old.flat = _safe_flat(net.pipeline)
        old.pipeline = net.pipeline
        e.state = ACTIVE
        e.flat = None
        self.active_version = e.version
        self.candidate = None
        self.canary_pct = 0.0
        self._bump("canary_promotions")
        self._trim()
        self._event(
            "canary_promoted", version=e.version, retired=old.version
        )
        return e.pipeline

    def reactivate(self, entry: VersionEntry, net) -> Any:
        """Operator Rollback after a promotion: swap a retained version
        back active; the (bad) current active demotes to ``rolled_back``.
        Returns the reactivated pipeline for the Spoke to install."""
        cur = self.versions[self.active_version]
        cur.state = ROLLED_BACK
        cur.trip_reason = REASON_OPERATOR
        cur.flat = _safe_flat(net.pipeline)
        cur.pipeline = None
        entry.state = ACTIVE
        entry.flat = None  # the live pipeline carries the params again
        self.active_version = entry.version
        self._bump("canary_rollbacks")
        self._event(
            "version_reactivated", version=entry.version,
            demoted=cur.version,
        )
        return entry.pipeline

    # --- stream hooks ----------------------------------------------------

    def fit_candidate(self, x, y, mask) -> None:
        """Train the candidate on the SAME flushed micro-batch the active
        version just consumed (its own solo launch; active state is never
        touched)."""
        e = self.candidate_entry
        if e is None or e.pipeline is None:
            return
        e.pipeline.fit(x, y, mask)
        e.fits += 1
        self._fits_since_eval += 1

    def route_candidate(self) -> bool:
        """One forecast admission's canary routing decision. Count-clocked
        and seeded: the ``n``-th canary-era forecast routes to the
        candidate iff ``canary_hash(seed, n) < pct(n)`` — a pure function
        of the record sequence, replayable across restarts. The ramp steps
        on the same clock. A candidate that has not trained yet (``fits``
        0 — e.g. a spoke whose share of the stream carried no training
        rows) never takes traffic: its predictions would come from the
        init model, which no shadow eval has vetted. The clock still
        ticks, so the hash schedule stays aligned with the forecast count
        (and with restarts — ``fits`` persists in the registry row)."""
        e = self.candidate_entry
        if e is None or e.state != CANARY:
            return False
        idx = self.forecast_clock
        self.forecast_clock += 1
        if idx and idx % self.cfg.ramp_every == 0:
            self.canary_pct = min(
                self.canary_pct + self.cfg.ramp_step, self.cfg.ramp_to
            )
        take = e.fits > 0 and canary_hash(self.cfg.seed, idx) < self.canary_pct
        if take:
            e.canary_served += 1
            if self.canary_pct >= self.cfg.ramp_to:
                e.ramp_served += 1
        return take

    def predict_candidate(self, rows: np.ndarray) -> np.ndarray:
        """Padded candidate predict over ``[k, dim]`` rows -> ``[k]``
        values, through the candidate's own persistent scratch (same pow2
        bucketing as the net's predict pad)."""
        e = self.candidate_entry
        k = rows.shape[0]
        b = _PREDICT_BATCH
        while b < k:
            b <<= 1
        if self._scratch is None or self._scratch.shape != (b, rows.shape[1]):
            self._scratch = np.zeros((b, rows.shape[1]), np.float32)
        else:
            self._scratch[:] = 0.0
        self._scratch[:k] = rows
        preds = e.pipeline.predict(self._scratch)
        return preds.detach().cpu().numpy().reshape(b, -1)[:k, 0]

    def tick(self, net) -> Optional[Tuple[str, ...]]:
        """Boundary decision pass (called next to the guard tick):

        1. candidate guard check — a normLimit/non-finite trip returns
           ``("rollback", reason)``;
        2. shadow-eval cadence — every ``shadowEvery`` candidate fits,
           score candidate AND baseline on the shared holdout set; a
           regression past ``scoreEnvelope`` (after ``minShadowEvals``)
           returns ``("rollback", "score_regressed")``;
        3. promotion check — full ramp + ``promoteAfter`` canary serves +
           healthy shadow record returns ``("promote",)``.

        Returns None when nothing fires. The Spoke executes the action."""
        e = self.candidate_entry
        if e is None or e.pipeline is None:
            return None
        guard = e.pipeline.guard
        if guard is not None:
            reason = guard.check()
            if reason is not None:
                return ("rollback", reason)
        if self._fits_since_eval >= self.cfg.shadow_every:
            self._fits_since_eval = 0
            test = net.test_arrays()
            if test is not None:
                _, cand_score = e.pipeline.evaluate(*test)
                _, base_score = net.pipeline.evaluate(*test)
                e.shadow_score = float(cand_score)
                e.baseline_score = float(base_score)
                e.shadow_evals += 1
                self._bump("shadow_scored")
                if (
                    e.shadow_evals >= max(self.cfg.min_shadow_evals, 1)
                    and e.baseline_score - e.shadow_score
                    > self.cfg.score_envelope
                ):
                    return ("rollback", REASON_SCORE_REGRESSED)
        if (
            e.state == CANARY
            and self.canary_pct >= self.cfg.ramp_to
            # exposure AT the full ramp, not partial-ramp trickle: the
            # knob promises promoteAfter serves at the target share
            and e.ramp_served >= self.cfg.promote_after
            and e.shadow_evals >= self.cfg.min_shadow_evals
        ):
            return ("promote",)
        return None

    # --- observability ---------------------------------------------------

    def describe(self) -> dict:
        """Operator view: active version, canary percentage, per-version
        shadow scores — surfaced in Query responses and
        ``StreamJob.tenant_topology()`` so a rollout is observable without
        scraping logs."""
        return {
            "activeVersion": self.active_version,
            "candidateVersion": self.candidate,
            "canaryPct": round(self.canary_pct, 6),
            "forecastClock": self.forecast_clock,
            "counters": dict(self.totals),
            "versions": [
                self.versions[v].describe() for v in sorted(self.versions)
            ],
        }

    # --- checkpoint persistence ------------------------------------------

    def snapshot(self) -> dict:
        """Host-side snapshot of the registry, clocks and counters (plus
        the candidate/retained pipelines' state) for checkpointing — a
        supervised restart resumes MID-CANARY instead of silently
        reverting to a single unversioned model."""
        from omldm_tpu_torch.checkpoint.checkpoint import _pipeline_snapshot

        versions: List[dict] = []
        for v in sorted(self.versions):
            e = self.versions[v]
            d = {
                "version": e.version,
                "state": e.state,
                "spec": e.spec,
                "flat": None if e.flat is None else np.asarray(e.flat),
                "shadow_score": e.shadow_score,
                "baseline_score": e.baseline_score,
                "shadow_evals": e.shadow_evals,
                "canary_served": e.canary_served,
                "ramp_served": e.ramp_served,
                "fits": e.fits,
                "trip_reason": e.trip_reason,
            }
            if e.pipeline is not None and e.version != self.active_version:
                d["pipeline"] = _pipeline_snapshot(e.pipeline)
                if e.pipeline.guard is not None:
                    d["guard"] = e.pipeline.guard.snapshot()
            versions.append(d)
        return {
            "active": self.active_version,
            "next": self._next,
            "candidate": self.candidate,
            "canary_pct": self.canary_pct,
            "forecast_clock": self.forecast_clock,
            "fits_since_eval": self._fits_since_eval,
            "pending": dict(self._pending),
            "totals": dict(self.totals),
            "versions": versions,
        }

    def restore(self, net, sv: dict, net_sv: dict) -> bool:
        """Rebuild the registry from a snapshot. Returns True when the
        ACTIVE version was a promoted candidate and this call rebuilt +
        installed its pipeline (loading ``net_sv``'s pipeline fields into
        it) — the caller must then skip the default active-pipeline load,
        which would push promoted-spec params into the Create-spec
        pipeline."""
        from omldm_tpu_torch.checkpoint.checkpoint import _pipeline_load

        self.active_version = int(sv["active"])
        self._next = int(sv["next"])
        self.candidate = sv["candidate"]
        self.canary_pct = float(sv["canary_pct"])
        self.forecast_clock = int(sv["forecast_clock"])
        self._fits_since_eval = int(sv["fits_since_eval"])
        self._pending = dict(sv["pending"])
        self.totals = dict(sv["totals"])
        self.versions = {}
        swapped = False
        for d in sv["versions"]:
            e = VersionEntry(
                version=int(d["version"]),
                state=d["state"],
                spec=d["spec"],
                flat=None if d["flat"] is None else np.asarray(d["flat"]),
                shadow_score=d["shadow_score"],
                baseline_score=d["baseline_score"],
                shadow_evals=int(d["shadow_evals"]),
                canary_served=int(d["canary_served"]),
                ramp_served=int(d.get("ramp_served", 0)),
                fits=int(d["fits"]),
                trip_reason=d["trip_reason"],
            )
            self.versions[e.version] = e
            if "pipeline" in d:
                if e.spec is not None:
                    pipe = _pipeline_from_spec(net, e.spec, e.version)
                elif e.version == 0:
                    # the retained pre-promotion model IS the net's own
                    # Create spec (version 0 carries no candidate spec)
                    pipe = _version_zero_pipeline(net)
                else:
                    continue
                pipe.version = e.version
                pipe.on_launch = net._note_launch
                _pipeline_load(pipe, d["pipeline"])
                if pipe.guard is not None and d.get("guard") is not None:
                    pipe.guard.restore(d["guard"])
                e.pipeline = pipe
        active = self.versions.get(self.active_version)
        if (
            active is not None
            and self.active_version != 0
            and active.spec is not None
        ):
            # the live model is a PROMOTED candidate: the runtime deployed
            # the Create-spec pipeline, so rebuild the promoted one and
            # install it (the same swap promotion performed live). The
            # Create-spec pipeline first detaches from any cohort it
            # auto-joined at deploy — promoted models run solo, and a
            # zombie member would pin a gang slot nothing feeds.
            old = net.node.pipeline
            if old._cohort is not None:
                old._cohort.detach(old)
            pipe = _pipeline_from_spec(net, active.spec, active.version)
            pipe.version = active.version
            pipe.on_launch = net._note_launch
            _pipeline_load(pipe, net_sv)
            net.node.pipeline = pipe
            active.pipeline = pipe
            swapped = True
        elif active is not None:
            active.pipeline = None  # version 0: the net's own pipeline
        return swapped
