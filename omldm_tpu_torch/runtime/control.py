"""Control plane: request validation and pipeline bookkeeping.

Counterpart of ``omldm_tpu/runtime/control.py`` (the reference's
``PipelineMap``, PipelineMap.scala:14-71): validates learner/preprocessor
names against the allowlists, keeps the map of live pipelines, and routes
Query to worker 0 only for single-learner models.

A sparse Create must name its width and a learner with a sparse variant,
and takes no preprocessors (``validate_sparse``). The port's gate also
rejects what the port cannot run yet -- learners,
preprocessors and protocols not yet ported, and per-pipeline switches that
arm a plane the port lacks -- with a reason that names it, so a request
that would fail at deploy drops alone instead of killing the job.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from omldm_tpu_torch.api.requests import LIFECYCLE_REQUESTS, Request, RequestType
from omldm_tpu_torch.learners.registry import (
    REFERENCE_LEARNERS,
    SINGLE_LEARNER_ONLY,
    is_valid_learner,
)
from omldm_tpu_torch.learners.sparse_linear import SPARSE_LEARNERS
from omldm_tpu_torch.preprocessors.registry import (
    REFERENCE_PREPROCESSORS,
    is_valid_preprocessor,
)
from omldm_tpu_torch.protocols.registry import PROTOCOLS, resolve_protocol
from omldm_tpu_torch.runtime.messages import comm_dict

# trainingConfiguration keys that arm a plane the port does not have
UNPORTED_PIPELINE_PLANES = ("guard", "serving", "overload", "lifecycle",
                            "telemetry", "events")
# trainingConfiguration.comm keys of the reliable channel (not ported)
RELIABILITY_KEYS = ("reliable", "quorum", "workerTimeoutMs", "windowSize",
                    "stallAfter")


def _armed(value) -> bool:
    """Whether a per-pipeline switch arms its plane (absent, false and the
    "off" spellings leave it unarmed)."""
    if isinstance(value, str):
        return value.strip().lower() not in ("", "off", "false", "none", "0")
    return bool(value)


def unported_option(request: Request) -> Optional[str]:
    """The reason a Create/Update names something the port cannot run yet,
    or None."""
    tc = request.training_configuration
    extra = tc.extra or {}
    for key in UNPORTED_PIPELINE_PLANES:
        if _armed(extra.get(key)):
            return f"trainingConfiguration.{key} is not yet ported"
    comm = comm_dict(tc)
    codec = str(comm.get("codec", extra.get("codec", "none")) or "none").lower()
    if codec != "none":
        return f"comm.codec {codec!r} is not yet ported"
    for key in RELIABILITY_KEYS:
        if key in comm:
            return f"comm.{key} (reliable channel) is not yet ported"
    if str(extra.get("engine", "")).lower() == "spmd":
        return "engine 'spmd' is not yet ported"
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

    def __init__(self, parallelism: int = 16) -> None:
        self.parallelism = parallelism
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
            return f"{request.request.value} (model lifecycle) is not yet ported"
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
        if name not in REFERENCE_LEARNERS:
            return f"unknown learner {name!r}"
        if (request.learner.data_structure or {}).get("sparse"):
            # the sparse variants pass on their own table, whether or not
            # the dense learner of the same name is ported
            err = validate_sparse(request)
            if err is not None:
                return err
        elif not is_valid_learner(name):
            return f"learner {name!r} is not yet ported"
        for p in request.preprocessors:
            if not is_valid_preprocessor(p.name):
                if p.name in REFERENCE_PREPROCESSORS:
                    return f"preprocessor {p.name!r} is not yet ported"
                return f"unknown preprocessor {p.name!r}"
        tc = request.training_configuration
        if tc.hub_parallelism < 1:
            return "HubParallelism must be >= 1"
        protocol = resolve_protocol(tc.protocol, name, self.parallelism)
        if protocol not in PROTOCOLS:
            return f"protocol {protocol!r} is not yet ported"
        return unported_option(request)

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
