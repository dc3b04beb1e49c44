"""Data-plane records: ``DataInstance`` in, ``Prediction`` out.

Reference counterpart: ControlAPI's ``DataInstance`` POJO with
``{numericalFeatures[], discreteFeatures[], categoricalFeatures[], target,
operation in {training, forecasting}, isValid, metadata}``
(reference: src/main/scala/omldm/utils/parsers/dataStream/DataPointParser.scala:17-47,
src/main/scala/omldm/utils/deserializers/DataInstanceDeserializer.scala:24-33)
and the ``Prediction`` POJO forwarded verbatim to the predictions topic
(src/main/scala/omldm/job/FlinkLearning.scala:98-101,
src/main/scala/omldm/network/FlinkNetwork.scala:250-255).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Mapping, Optional, Sequence, Tuple

TRAINING = "training"
FORECASTING = "forecasting"

# End-of-stream marker records: the reference's DataInstanceParser drops a bare
# "EOS" string marker (DataInstanceParser.scala:14); we honor the same marker
# for file-replay tooling.
EOS = "EOS"


# slots: the serving plane materializes one DataInstance per emitted
# prediction on its hot path — slot-backed instances construct ~2x faster
# and every field here is declared up front anyway
@dataclasses.dataclass(slots=True)
class DataInstance:
    """One streaming record, either a training or a forecasting point.

    ``numerical_features`` are continuous values, ``discrete_features`` are
    integer-valued, ``categorical_features`` are strings (one-hot/hashed by
    preprocessors). ``target`` is present for labeled training data.
    Mirrors DataPointParser.scala:16-54 semantics: a record is usable when it
    has at least one feature; a training operation additionally requires a
    target to become a labeled point.
    """

    id: Optional[int] = None
    numerical_features: Optional[Sequence[float]] = None
    discrete_features: Optional[Sequence[int]] = None
    categorical_features: Optional[Sequence[str]] = None
    target: Optional[float] = None
    operation: str = TRAINING
    metadata: Optional[Mapping[str, Any]] = None

    def invalid_reason(self) -> Optional[str]:
        """Why this record fails the reference's ``isValid`` check
        (DataInstanceParser.scala:13-21), or None when usable. The reason
        code feeds the dead-letter sink (runtime/deadletter) so rejected
        records are quarantined with a cause instead of silently dropped."""
        if self.operation not in (TRAINING, FORECASTING):
            return "unknown_operation"
        has_features = any(
            f is not None and len(f) > 0
            for f in (
                self.numerical_features,
                self.discrete_features,
                self.categorical_features,
            )
        )
        if not has_features:
            return "no_features"
        # Python's json.loads accepts bare NaN/Infinity literals that the
        # reference's Jackson parser rejects; a single non-finite value would
        # poison model parameters, so reject them here.
        try:
            for f in (self.numerical_features, self.discrete_features):
                if f is not None and any(
                    v is None or not math.isfinite(v) for v in f
                ):
                    return "non_finite_feature"
            if self.target is not None and not math.isfinite(self.target):
                return "non_finite_target"
        except TypeError:
            # non-numeric feature elements (e.g. strings in numericalFeatures)
            return "non_numeric_feature"
        return None

    def is_valid(self) -> bool:
        """Validation mirroring the reference's ``isValid`` check applied in
        DataInstanceParser.scala:13-21: the record must carry features and a
        known operation."""
        return self.invalid_reason() is None

    @classmethod
    def forecast_payload(cls, numerical_features) -> "DataInstance":
        """Hot-path factory for the serving plane: the forecasting
        DataInstance a served prediction carries, built by direct slot
        fill. One such instance materializes per emitted prediction —
        at adaptive-batching throughput the generated ``__init__``'s
        seven keyword assignments are a measurable fraction of the whole
        serve path, and every field here is statically known."""
        di = cls.__new__(cls)
        di.id = None
        di.numerical_features = numerical_features
        di.discrete_features = None
        di.categorical_features = None
        di.target = None
        di.operation = FORECASTING
        di.metadata = None
        return di

    # --- JSON codec (Jackson-compatible camelCase field names) ---

    @classmethod
    def parse(
        cls, text: str
    ) -> Tuple[Optional["DataInstance"], Optional[str]]:
        """Parse a JSON record into ``(instance, rejection_reason)``.

        Exactly one of the pair is non-None, except for EOS markers and
        blank lines which return ``(None, None)`` — they are protocol
        markers (DataInstanceParser.scala:14), not malformed input, and
        must not be quarantined."""
        text = text.strip()
        if not text or text == EOS or text == f'"{EOS}"':
            return None, None
        try:
            obj = json.loads(text)
        except (json.JSONDecodeError, ValueError):
            return None, "malformed_json"
        if not isinstance(obj, dict):
            return None, "not_an_object"
        try:
            inst = cls.from_dict(obj)
        except (TypeError, ValueError):
            # e.g. non-numeric target: the reference's Jackson deserializer
            # fails and the record is dropped (DataInstanceDeserializer.scala:24-33)
            return None, "bad_field_type"
        reason = inst.invalid_reason()
        if reason is not None:
            return None, reason
        return inst, None

    @classmethod
    def from_json(cls, text: str) -> Optional["DataInstance"]:
        """Parse a JSON record; returns None for invalid records and the EOS
        marker, mirroring DataInstanceParser.scala:12-22 (drops invalid, drops
        "EOS", swallows parse errors)."""
        return cls.parse(text)[0]

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "DataInstance":
        target = obj.get("target")
        if target is not None:
            # non-numeric target => raise; from_json drops the record, matching
            # Jackson deserialization failure in the reference
            target = float(target)
        return cls(
            id=obj.get("id"),
            numerical_features=obj.get("numericalFeatures"),
            discrete_features=obj.get("discreteFeatures"),
            categorical_features=obj.get("categoricalFeatures"),
            target=target,
            operation=obj.get("operation", TRAINING),
            metadata=obj.get("metadata"),
        )

    def to_dict(self) -> dict:
        out: dict = {"operation": self.operation}
        if self.id is not None:
            out["id"] = self.id
        if self.numerical_features is not None:
            nf = self.numerical_features
            # feature rows may be numpy arrays; tolist() gives the same
            # native-float JSON list() gives for list payloads
            out["numericalFeatures"] = (
                nf.tolist() if hasattr(nf, "tolist") else list(nf)
            )
        if self.discrete_features is not None:
            out["discreteFeatures"] = list(self.discrete_features)
        if self.categorical_features is not None:
            out["categoricalFeatures"] = list(self.categorical_features)
        if self.target is not None:
            out["target"] = self.target
        if self.metadata is not None:
            out["metadata"] = dict(self.metadata)
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


@dataclasses.dataclass(slots=True)
class Prediction:
    """A served prediction, emitted on the predictions stream.

    The reference forwards ControlAPI ``Prediction`` objects verbatim from the
    worker to the predictions Kafka topic (FlinkNetwork.scala:250-255,
    Job.scala:98-105)."""

    mlp_id: int
    data_instance: Optional[DataInstance]
    value: Any
    # the model-lifecycle plane's version tag (runtime/lifecycle.py): set
    # only on canary-routed predictions a candidate version served. None,
    # the default and always for a lifecycle-unarmed pipeline, keeps the
    # wire payload as it was
    version: Optional[int] = None

    def to_dict(self) -> dict:
        out = {
            "mlpId": self.mlp_id,
            "dataInstance": self.data_instance.to_dict() if self.data_instance else None,
            "value": self.value,
        }
        if self.version is not None:
            out["version"] = self.version
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
