"""Control plane: request validation and pipeline bookkeeping.

Counterpart of ``omldm_tpu/runtime/control.py`` (the reference's
``PipelineMap``, PipelineMap.scala:14-71): validates learner/preprocessor
names against the allowlists, keeps the map of live pipelines, and routes
Query to worker 0 only for single-learner models.

Every learner, preprocessor and protocol of the JAX package's host engine
is admitted. A sparse Create must name its width and a learner with a
sparse variant, and takes no preprocessors (``validate_sparse``). A
``serving`` table must parse (``runtime.serving.validate_serving``): a bad
one drops its request. A Create for the SPMD engine (``engine: spmd``)
that the engine hosts must name a feed dtype it takes and, under SSP, a
staleness bound of at least 1 (``validate_spmd``); the JAX package raises
on both at deploy. A transport codec must be one the port knows, and
``topk`` stays off the collective engine, whose allreduce needs dense
operands (``validate_codec``, the JAX gate's ``_validate_codec``). An
``overload`` table must parse (``runtime.overload.validate_overload``), and
a ``lifecycle`` table must parse and name a dense host-plane pipeline
(``runtime.lifecycle.validate_lifecycle``). The lifecycle verbs (Shadow,
Promote, Rollback) must target a live pipeline, and a Shadow must name a
known dense candidate learner and known preprocessors
(``_validate_lifecycle_verb``); whether the target is armed is the job's
call, since it holds the job-wide default spec. A ``telemetry`` and an
``events`` table must parse (``runtime.telemetry.validate_telemetry``,
``runtime.events.validate_events``), so a request that would fail at
deploy drops alone instead of killing the job.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from omldm_tpu_torch.api.requests import LIFECYCLE_REQUESTS, Request, RequestType
from omldm_tpu_torch.learners.registry import SINGLE_LEARNER_ONLY, is_valid_learner
from omldm_tpu_torch.learners.sparse_linear import SPARSE_LEARNERS
from omldm_tpu_torch.preprocessors.registry import is_valid_preprocessor
from omldm_tpu_torch.runtime.events import validate_events
from omldm_tpu_torch.runtime.lifecycle import validate_lifecycle
from omldm_tpu_torch.runtime.messages import comm_codec_name
from omldm_tpu_torch.runtime.overload import validate_overload
from omldm_tpu_torch.runtime.serving import validate_serving
from omldm_tpu_torch.runtime.spmd_bridge import spmd_engine_requested, spmd_engine_supported
from omldm_tpu_torch.runtime.telemetry import validate_telemetry


def validate_codec(request: Request) -> Optional[str]:
    """The transport codec must be deployable: an unknown name, or ``topk``
    on the collective engine (its allreduce needs dense operands), would
    raise at deploy and kill the job instead of dropping the request. The
    engine is matched as ``spmd_engine_requested`` does (case-blind)."""
    tc = request.training_configuration
    try:
        name = comm_codec_name(tc)
    except ValueError as exc:
        return str(exc)
    if name == "topk" and spmd_engine_requested(request):
        return "topk codec is host-plane only (SPMD allreduce needs dense operands)"
    return None


def validate_spmd(request: Request) -> Optional[str]:
    """A Create the SPMD engine will host must be deployable there: the
    bridge and the trainer raise at deploy on a feed dtype other than
    float32 or float16, and on an SSP staleness bound below 1 (a bound of 0
    refuses every batch)."""
    if not (spmd_engine_requested(request) and spmd_engine_supported(request)):
        return None
    tc = request.training_configuration
    feed = str(tc.extra.get("feedDtype", "float32"))
    if feed not in ("float32", "float16"):
        return f"engine 'spmd': feedDtype must be float32|float16, got {feed!r}"
    try:
        staleness = int(tc.extra.get("staleness", 3))
    except (TypeError, ValueError):
        return f"engine 'spmd': staleness {tc.extra.get('staleness')!r} must be an integer"
    if tc.protocol == "SSP" and staleness < 1:
        return f"engine 'spmd': SSP staleness must be >= 1, got {staleness}"
    return None


def validate_sparse(request: Request) -> Optional[str]:
    """A sparse request must be deployable: one that passed the gate but
    raised at SpokeNet construction or at its first fit would kill the whole
    job, not just itself (the reference drops invalid requests,
    PipelineMap.scala:34,46).

    The hashed space lies inside the model's width, so ``hashSpace`` must lie
    in [0, nFeatures]. A wider one gives the vectorizer a negative base, and
    the indices it emits would fault the gather on the card. Here the port
    differs from the JAX package on purpose: that package accepts such a
    Create and trains a model of NaN margins without a word (``jnp.take``
    fills out-of-range indices with NaN)."""
    ds = request.learner.data_structure or {}
    if "nFeatures" not in ds:
        # the wide hashed index space cannot be inferred from the first
        # record (SparseVectorizer needs the model width)
        return "sparse learners require dataStructure.nFeatures"
    try:
        n_features = int(ds["nFeatures"])
        hash_space = int(ds.get("hashSpace", 0))
    except (TypeError, ValueError):
        return (f"dataStructure.nFeatures {ds['nFeatures']!r} and hashSpace "
                f"{ds.get('hashSpace')!r} must be integers")
    if not 0 <= hash_space <= n_features:
        return (f"dataStructure.hashSpace {hash_space} must lie in [0, nFeatures "
                f"{n_features}]: the hashed space is part of the model's width")
    if request.learner.name not in SPARSE_LEARNERS:
        return f"learner {request.learner.name!r} has no sparse variant"
    if request.preprocessors:
        return "sparse learners do not take preprocessors"
    return None


class PipelineManager:
    """Validates and routes control requests; parallelism-1 by design."""

    def __init__(self) -> None:
        self.node_map: Dict[int, Request] = {}

    def validate(self, request: Request) -> Optional[str]:
        """Returns an error string, or None if the request is acceptable."""
        if request.request == RequestType.CREATE:
            if request.id in self.node_map:
                return f"pipeline {request.id} already exists"
            if request.learner is None:
                return "create request without learner"
            return self._validate_spec(request)
        if request.request in LIFECYCLE_REQUESTS:
            return self._validate_lifecycle_verb(request)
        if request.request in (RequestType.UPDATE, RequestType.QUERY, RequestType.DELETE):
            if request.id not in self.node_map:
                return f"pipeline {request.id} does not exist"
            if request.request == RequestType.UPDATE:
                if request.learner is None:
                    return "invalid update learner"
                return self._validate_spec(request)
            return None
        return f"unknown request type {request.request}"

    def _validate_spec(self, request: Request) -> Optional[str]:
        name = request.learner.name
        if not is_valid_learner(name):
            return f"unknown learner {name!r}"
        if (request.learner.data_structure or {}).get("sparse"):
            err = validate_sparse(request)
            if err is not None:
                return err
        for p in request.preprocessors:
            if not is_valid_preprocessor(p.name):
                return f"unknown preprocessor {p.name!r}"
        tc = request.training_configuration
        if tc.hub_parallelism < 1:
            return "HubParallelism must be >= 1"
        err = validate_serving(tc)
        if err is not None:
            return err
        err = validate_overload(tc)
        if err is not None:
            return err
        err = validate_codec(request)
        if err is not None:
            return err
        err = validate_spmd(request)
        if err is not None:
            return err
        err = validate_telemetry(tc)
        if err is not None:
            return err
        err = validate_events(tc)
        if err is not None:
            return err
        return validate_lifecycle(request)

    def _validate_lifecycle_verb(self, request: Request) -> Optional[str]:
        """Shadow, Promote and Rollback target a live pipeline; a Shadow
        also names the candidate configuration, a whole learner spec that
        must be dense (the candidate's predict and flat-parameter paths
        are). Whether the target has the plane armed is the job's call."""
        if request.id not in self.node_map:
            return f"pipeline {request.id} does not exist"
        if request.request == RequestType.SHADOW:
            if request.learner is None:
                return "Shadow request without a candidate learner"
            if not is_valid_learner(request.learner.name):
                return f"unknown learner {request.learner.name!r}"
            if (request.learner.data_structure or {}).get("sparse"):
                return "lifecycle candidates must be dense learners"
            for p in request.preprocessors:
                if not is_valid_preprocessor(p.name):
                    return f"unknown preprocessor {p.name!r}"
        return None

    def apply(self, request: Request) -> None:
        """Bookkeeping for an ALREADY-validated request."""
        if request.request in (RequestType.CREATE, RequestType.UPDATE):
            self.node_map[request.id] = request
        elif request.request == RequestType.DELETE:
            del self.node_map[request.id]

    def query_targets(self, request: Request, parallelism: int) -> List[int]:
        """Worker ids a Query goes to: worker 0 only for single-learner
        models, else all workers (PipelineMap.scala:37-42)."""
        live = self.node_map.get(request.id)
        if live is not None and live.learner is not None and (
            live.learner.name in SINGLE_LEARNER_ONLY
        ):
            return [0]
        return list(range(parallelism))

    @property
    def live_pipelines(self) -> List[int]:
        return sorted(self.node_map)
