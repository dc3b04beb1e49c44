"""Control-plane requests: Create / Update / Query / Delete pipelines.

Reference counterpart: ControlAPI's ``Request`` POJO ``{id, request,
requestId, learner{name, parameters, hyperParameters, dataStructure},
preProcessors[], trainingConfiguration{protocol, HubParallelism, ...}}``
(reference: src/main/scala/omldm/utils/parsers/requestStream/PipelineMap.scala:22-47,
src/main/scala/omldm/operators/spoke/FlinkSpoke.scala:141-171,184,203-215,
src/main/scala/omldm/utils/deserializers/RequestDeserializer.scala:22-31).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Mapping, Optional, Sequence


class RequestType(str, enum.Enum):
    CREATE = "Create"
    UPDATE = "Update"
    QUERY = "Query"
    DELETE = "Delete"
    # model-lifecycle verbs (runtime/lifecycle.py; the reference's only
    # rollout is the destructive Update, PipelineMap.scala:43-47): Shadow
    # registers a candidate configuration that trains and scores on the
    # live stream without serving; Promote starts (or completes) the canary
    # ramp; Rollback demotes the candidate, or after a promotion
    # reactivates the retained previous version
    SHADOW = "Shadow"
    PROMOTE = "Promote"
    ROLLBACK = "Rollback"


# the lifecycle verb subset (validated and routed together)
LIFECYCLE_REQUESTS = (
    RequestType.SHADOW,
    RequestType.PROMOTE,
    RequestType.ROLLBACK,
)


@dataclasses.dataclass
class LearnerSpec:
    """Learner descriptor inside a request (PipelineMap.scala:26-29).

    ``name`` must be in the learner allowlist (PipelineMap.scala:68);
    ``hyper_parameters`` configure the update rule (e.g. PA's C, pegasos
    lambda); ``parameters`` optionally seed the model state; ``data_structure``
    carries learner-specific structural config (e.g. NN layer sizes, RFF dims).
    """

    name: str
    parameters: Optional[Mapping[str, Any]] = None
    hyper_parameters: Optional[Mapping[str, Any]] = None
    data_structure: Optional[Mapping[str, Any]] = None

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "LearnerSpec":
        return cls(
            name=obj["name"],
            parameters=obj.get("parameters"),
            hyper_parameters=obj.get("hyperParameters"),
            data_structure=obj.get("dataStructure"),
        )

    def to_dict(self) -> dict:
        out: dict = {"name": self.name}
        if self.parameters is not None:
            out["parameters"] = dict(self.parameters)
        if self.hyper_parameters is not None:
            out["hyperParameters"] = dict(self.hyper_parameters)
        if self.data_structure is not None:
            out["dataStructure"] = dict(self.data_structure)
        return out


@dataclasses.dataclass
class PreprocessorSpec:
    """Preprocessor descriptor (the reference's ``PreprocessorPOJO``,
    PipelineMap.scala:26-29); ``name`` must be in the preprocessor allowlist
    (PipelineMap.scala:67)."""

    name: str
    parameters: Optional[Mapping[str, Any]] = None
    hyper_parameters: Optional[Mapping[str, Any]] = None

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "PreprocessorSpec":
        return cls(
            name=obj["name"],
            parameters=obj.get("parameters"),
            hyper_parameters=obj.get("hyperParameters"),
        )

    def to_dict(self) -> dict:
        out: dict = {"name": self.name}
        if self.parameters is not None:
            out["parameters"] = dict(self.parameters)
        if self.hyper_parameters is not None:
            out["hyperParameters"] = dict(self.hyper_parameters)
        return out


@dataclasses.dataclass
class TrainingConfiguration:
    """Per-pipeline training configuration carried by the request
    (FlinkSpoke.scala:184,203-215, MLNodeGenerator.scala:22-43).

    ``protocol`` selects one of the 8 distributed-learning protocols;
    ``hub_parallelism`` (the reference's ``HubParallelism`` key,
    FlinkSpoke.scala:181-195) shards the parameter server; ``mini_batch_size``
    and ``per_record`` pick micro-batched vs exact per-record update
    semantics; protocol-specific knobs (staleness bound, EASGD alpha, GM/FGM
    threshold) ride in ``extra``.
    """

    protocol: str = "Asynchronous"
    hub_parallelism: int = 1
    mini_batch_size: Optional[int] = None
    per_record: bool = False
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: Optional[Mapping[str, Any]]) -> "TrainingConfiguration":
        if not obj:
            return cls()
        known = {"protocol", "HubParallelism", "hubParallelism", "miniBatchSize", "perRecord"}
        extra = {k: v for k, v in obj.items() if k not in known}
        # knobs may arrive flat (the wire shape: unknown keys ARE the extra
        # map) or under an explicit "extra" object (the dataclass field
        # name, natural for programmatic construction via to_dict/asdict
        # round trips) — merge the nested form instead of burying it at
        # extra["extra"] where every lookup would miss it
        nested = extra.pop("extra", None)
        if isinstance(nested, Mapping):
            extra = {**nested, **extra}
        return cls(
            protocol=obj.get("protocol", "Asynchronous"),
            hub_parallelism=int(
                obj.get("HubParallelism", obj.get("hubParallelism", 1)) or 1
            ),
            mini_batch_size=obj.get("miniBatchSize"),
            per_record=bool(obj.get("perRecord", False)),
            extra=extra,
        )

    def to_dict(self) -> dict:
        out: dict = {
            "protocol": self.protocol,
            "HubParallelism": self.hub_parallelism,
        }
        if self.mini_batch_size is not None:
            out["miniBatchSize"] = self.mini_batch_size
        if self.per_record:
            out["perRecord"] = True
        out.update(self.extra)
        return out


@dataclasses.dataclass
class Request:
    """A control-plane request targeting pipeline ``id`` (the networkId)."""

    id: int
    request: RequestType
    request_id: Optional[int] = None
    learner: Optional[LearnerSpec] = None
    preprocessors: Sequence[PreprocessorSpec] = dataclasses.field(default_factory=list)
    training_configuration: TrainingConfiguration = dataclasses.field(
        default_factory=TrainingConfiguration
    )

    @classmethod
    def from_json(cls, text: str) -> Optional["Request"]:
        """JSON -> Request, mirroring RequestParser.scala:12-17 (drops
        malformed requests silently)."""
        try:
            obj = json.loads(text)
            return cls.from_dict(obj)
        except (json.JSONDecodeError, KeyError, ValueError, TypeError):
            return None

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "Request":
        return cls(
            id=int(obj["id"]),
            request=RequestType(obj["request"]),
            request_id=obj.get("requestId"),
            learner=LearnerSpec.from_dict(obj["learner"]) if obj.get("learner") else None,
            preprocessors=[
                PreprocessorSpec.from_dict(p) for p in obj.get("preProcessors") or []
            ],
            training_configuration=TrainingConfiguration.from_dict(
                obj.get("trainingConfiguration")
            ),
        )

    def to_dict(self) -> dict:
        out: dict = {"id": self.id, "request": self.request.value}
        if self.request_id is not None:
            out["requestId"] = self.request_id
        if self.learner is not None:
            out["learner"] = self.learner.to_dict()
        if self.preprocessors:
            out["preProcessors"] = [p.to_dict() for p in self.preprocessors]
        out["trainingConfiguration"] = self.training_configuration.to_dict()
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
