"""Model-integrity guard: divergence detection, LKG rollback, containment.

Counterpart of ``omldm_tpu/guard.py``; the reference has none (its only
integrity mechanism is ``DataInstance.isValid`` dropping malformed records,
DataPointParser.scala:13-21). Armed per pipeline by
``trainingConfiguration.guard`` (absent or false: no guard object and the
plain code on every route):

- :func:`guard_config` parses the knob into a :class:`GuardConfig`.
- :class:`ModelGuard` is the worker-side half: it holds the health scalar
  each guarded fit computes on the device (the squared norm of the float
  parameter leaves, non-finite whenever any parameter is), reads the
  newest one at a check, and keeps the bounded last-known-good (LKG) ring
  of flat parameters that a rollback restores.
- :func:`admission_reason` is the hub-side half: the payload check the
  delta-admission boundary (``HubNode.guard_admit``, wired at
  ``Hub._dispatch``) runs on every decoded worker message.

The module imports nothing from the runtime packages.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Deque, Optional

import numpy as np
import torch

# guard trip / admission-rejection reason codes
REASON_NON_FINITE = "non_finite"
REASON_NORM_EXPLODED = "norm_exploded"

# default cap on the parameter L2 norm: generous for every built-in
# learner (linear/PA/NN params stay O(1..1e3) on normalized streams) while
# still catching runaway divergence within one sync cadence
DEFAULT_NORM_LIMIT = 1.0e6
# bad deltas from one worker before the hub retires it from round
# accounting (1 = first offense retires; a healthy params push re-admits)
DEFAULT_MAX_STRIKES = 1
# last-known-good snapshots retained per pipeline
DEFAULT_LKG_DEPTH = 4
# fits between LKG snapshots. A snapshot costs one flat-param ravel +
# host copy, so the cadence bounds BOTH the worst-case progress a
# rollback discards (snapshot_every * lkg_depth fits) AND the guard's
# clean-stream overhead (the <= 3% --guard-smoke bar); rollback usually
# recovers most of the discarded progress from the hub resync anyway.
DEFAULT_SNAPSHOT_EVERY = 32


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Parsed ``trainingConfiguration.guard`` knobs."""

    norm_limit: float = DEFAULT_NORM_LIMIT
    max_strikes: int = DEFAULT_MAX_STRIKES
    lkg_depth: int = DEFAULT_LKG_DEPTH
    snapshot_every: int = DEFAULT_SNAPSHOT_EVERY


def guard_config(tc) -> Optional[GuardConfig]:
    """The pipeline's guard configuration, or None when unarmed.

    ``trainingConfiguration.guard`` accepts ``true`` (all defaults) or a
    table ``{"normLimit": ..., "maxStrikes": ..., "lkgDepth": ...,
    "snapshotEvery": ...}``. Absent or falsy => None => every guard hook
    in the stack compiles/executes the exact pre-guard path."""
    extra = getattr(tc, "extra", None) or {}
    g = extra.get("guard")
    if not g:
        return None
    if not isinstance(g, dict):
        return GuardConfig()
    return GuardConfig(
        norm_limit=float(g.get("normLimit", DEFAULT_NORM_LIMIT)),
        max_strikes=max(int(g.get("maxStrikes", DEFAULT_MAX_STRIKES)), 1),
        lkg_depth=max(int(g.get("lkgDepth", DEFAULT_LKG_DEPTH)), 1),
        snapshot_every=max(
            int(g.get("snapshotEvery", DEFAULT_SNAPSHOT_EVERY)), 1
        ),
    )


def gang_health_values(sq_norms) -> np.ndarray:
    """A gang launch's ``[C]`` member-health vector on the host, in one
    device-to-host copy (numpy passes through)."""
    if isinstance(sq_norms, torch.Tensor):
        return sq_norms.detach().cpu().numpy()
    return np.asarray(sq_norms)


def _payload_vector(payload: Any) -> Optional[np.ndarray]:
    """The model/delta vector a worker message carries, if any. Worker
    pushes ship flat float vectors under ``params`` (all six parameter
    protocols) or as the bare payload; control traffic (votes, thetas,
    NACKs) carries none and is admitted untouched."""
    vec = None
    if isinstance(payload, np.ndarray):
        vec = payload
    elif isinstance(payload, dict):
        p = payload.get("params")
        if isinstance(p, np.ndarray):
            vec = p
    if vec is None or vec.dtype.kind != "f" or vec.size == 0:
        return None
    return vec


def payload_non_finite(payload: Any) -> bool:
    """Whether a ship payload carries any non-finite float content (array
    leaves or top-level scalars). Used by the guarded ship boundary to
    decide if a codec encode failure is the EXPECTED corrupt-state case
    (suppress, let rollback recover) or an unrelated codec bug (re-raise
    -- swallowing those would hide real defects behind the guard)."""
    values = payload.values() if isinstance(payload, dict) else (payload,)
    for value in values:
        if isinstance(value, np.ndarray) and value.dtype.kind == "f":
            if not np.all(np.isfinite(value)):
                return True
        elif isinstance(value, float) and not math.isfinite(value):
            return True
    return False


def admission_reason(payload: Any, norm_limit: float) -> Optional[str]:
    """Why this worker payload must NOT enter protocol state, or None.

    Checks the shipped parameter vector (non-finite values, exploded L2
    norm) plus any top-level scalar floats a safe-zone protocol folds into
    shared state (FGM's ``phi`` -- a NaN phi would poison the quantum and
    crash increment counting fleet-wide). Curve slices are skipped: a
    NaN loss point only ever reaches the learning-curve statistics, and
    rejecting a healed worker's whole push for an old curve entry would
    block its recovery."""
    vec = _payload_vector(payload)
    if vec is not None:
        # one fused pass decides both checks: the squared norm is itself
        # non-finite whenever any element is (this runs on EVERY admitted
        # worker push, so the healthy path must be one BLAS call, not an
        # isfinite scan + a norm)
        flat = vec.ravel()
        sq = float(np.dot(flat, flat))
        if not math.isfinite(sq):
            # rare path: distinguish a NaN/Inf element from a genuine
            # float32 overflow of the sum (huge-but-finite values)
            if not np.all(np.isfinite(flat)):
                return REASON_NON_FINITE
            return REASON_NORM_EXPLODED
        if sq > norm_limit * norm_limit:
            return REASON_NORM_EXPLODED
    if isinstance(payload, dict):
        for key, value in payload.items():
            if key == "curve":
                continue
            if isinstance(value, float) and not math.isfinite(value):
                return REASON_NON_FINITE
    return None


class ModelGuard:
    """Worker-side guard state for ONE pipeline.

    The guarded fits hand every launch's health scalar -- the squared
    parameter norm, whose value is itself non-finite whenever ANY
    parameter is -- to :meth:`note` as a 0-d device tensor (nothing waits
    on the device in a fit); :meth:`check` reads only the NEWEST
    pending value (corruption is sticky: NaN parameters stay NaN and an
    exploded norm does not shrink back, so the latest state's health
    subsumes the intermediate ones). Healthy states feed the bounded LKG
    ring through :meth:`maybe_snapshot`; a trip rolls the pipeline's
    parameters back to the most recent snapshot via :meth:`rollback`."""

    def __init__(self, cfg: GuardConfig):
        self.cfg = cfg
        self._pending = None  # newest lazy squared-norm health scalar
        self._ring: Deque[np.ndarray] = collections.deque(
            maxlen=cfg.lkg_depth
        )
        self._fits_since_snapshot = 0
        self.trips = 0
        self.last_reason: Optional[str] = None

    def note(self, sq_norm, fits: int = 1) -> None:
        """Record one launch's lazy health scalar (newest wins).
        ``fits`` is the number of micro-batch fits the launch covered
        (chained ``fit_many`` / staged gang launches > 1), so the
        ``snapshotEvery`` cadence counts actual fits, not launches."""
        self._pending = sq_norm
        self._fits_since_snapshot += max(int(fits), 1)

    def check(self) -> Optional[str]:
        """Evaluate the newest pending health scalar; returns the trip
        reason, or None when healthy / nothing new happened."""
        if self._pending is None:
            return None
        sq_norm = float(self._pending)
        self._pending = None
        if math.isnan(sq_norm):
            self.last_reason = REASON_NON_FINITE
            return self.last_reason
        # inf covers both +/-inf params and a genuine float32 overflow of
        # the sum -- either way the norm bound is blown
        if sq_norm > self.cfg.norm_limit * self.cfg.norm_limit:
            self.last_reason = REASON_NORM_EXPLODED
            return self.last_reason
        return None

    @property
    def lkg_depth(self) -> int:
        return len(self._ring)

    def maybe_snapshot(self, pipeline) -> None:
        """Push a last-known-good flat-param copy every
        ``snapshot_every`` fits (and always seed the first one). The copy
        is health-checked DIRECTLY before it enters the ring: the pending
        fit-launch evidence :meth:`check` evaluates does not cover hub
        broadcasts that may have replaced the params since (e.g. a
        down-direction chaos-corrupted round release), and a corrupt
        snapshot would poison the rollback target itself."""
        if self._ring and self._fits_since_snapshot < self.cfg.snapshot_every:
            return
        self._fits_since_snapshot = 0
        flat, _ = pipeline.get_flat_params()  # already a writable copy
        sq = float(np.dot(flat.ravel(), flat.ravel()))
        if not math.isfinite(sq) or sq > self.cfg.norm_limit**2:
            return  # keep the older healthy snapshots instead
        self._ring.append(flat)

    def reseed(self, pipeline) -> None:
        """Model replaced wholesale (grow-rescale seed, restore): stale
        snapshots would roll back PAST the replacement."""
        self._ring.clear()
        self._fits_since_snapshot = 0
        self.maybe_snapshot(pipeline)

    def snapshot(self) -> dict:
        """Host-side snapshot of the LKG ring + cadence/trip counters for
        checkpointing -- a supervised restart must keep its rollback
        targets instead of reseeding the ring at the restored params (a
        corruption that slipped into the snapshot would then be its own
        rollback target)."""
        return {
            "ring": [r.copy() for r in self._ring],
            "fits_since": self._fits_since_snapshot,
            "trips": self.trips,
            "last_reason": self.last_reason,
        }

    def restore(self, sv: dict) -> None:
        """Reload a :meth:`snapshot` (the ring keeps its configured
        ``lkgDepth`` bound; pending in-flight health evidence does not
        survive a restart -- the snapshot was taken between events)."""
        self._ring.clear()
        for row in sv.get("ring", ()):
            self._ring.append(np.asarray(row, np.float32).copy())
        self._fits_since_snapshot = int(sv.get("fits_since", 0))
        self.trips = int(sv.get("trips", 0))
        self.last_reason = sv.get("last_reason")
        self._pending = None

    def rollback(self, pipeline) -> bool:
        """Restore the most recent LKG snapshot into the pipeline (and
        sanitize a non-finite cumulative loss so statistics stay
        reportable). Returns False when no snapshot exists -- the guard
        always seeds one at pipeline creation, so this only happens for a
        guard constructed out-of-band."""
        self.trips += 1
        self._pending = None
        self._fits_since_snapshot = 0
        if not self._ring:
            return False
        pipeline.set_flat_params(self._ring[-1].copy())
        state = pipeline.state
        cum = state["cum_loss"]
        if not math.isfinite(float(cum)):
            state["cum_loss"] = torch.zeros((), dtype=torch.float32, device=cum.device)
        return True
