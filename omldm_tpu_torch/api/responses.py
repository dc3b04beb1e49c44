"""Query responses, possibly split into parameter buckets.

Reference counterpart: ControlAPI's ``QueryResponse`` ``{responseId,
id(bucket), mlpId, preprocessors, learner{parameters, hyperParameters,
dataStructure}, protocol, dataFitted, loss, cumulativeLoss, score}``
(reference: src/main/scala/omldm/network/FlinkNetwork.scala:196-231,
src/main/scala/omldm/utils/ResponseConstructor.scala:36-52). ``response_id ==
-1`` marks the internal termination probe (FlinkLearning.scala:115-133).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional, Sequence

# responseId used by the termination probe (FlinkLearning.scala:115-133).
TERMINATION_RESPONSE_ID = -1


@dataclasses.dataclass
class QueryResponse:
    response_id: int
    mlp_id: int
    bucket: int = 0  # the reference's `id` field: index of this param bucket
    num_buckets: int = 1
    preprocessors: Optional[Sequence[Mapping[str, Any]]] = None
    learner: Optional[Mapping[str, Any]] = None
    protocol: Optional[str] = None
    data_fitted: int = 0
    loss: Optional[float] = None
    cumulative_loss: Optional[float] = None
    score: Optional[float] = None
    # the model-lifecycle plane's registry view (runtime/lifecycle.py):
    # active version, canary percentage, per-version shadow scores, on the
    # bucket-0 fragment of a lifecycle-armed pipeline; None keeps the wire
    # shape as it was
    lifecycle: Optional[Mapping[str, Any]] = None
    # the flight recorder's view (runtime/events.py): the tail of the
    # pipeline's event ring on the bucket-0 fragment when the recorder is
    # armed; None keeps the wire shape as it was
    events: Optional[Sequence[Mapping[str, Any]]] = None
    # internal routing metadata (NOT part of the wire format): which worker
    # emitted this fragment — lets the merger re-assemble parameter buckets
    # from a single replica's fragment set even when replicas differ
    # (async protocols between syncs)
    source_worker: Optional[int] = None

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "QueryResponse":
        return cls(
            response_id=int(obj["responseId"]),
            mlp_id=int(obj.get("mlpId", -1)),
            bucket=int(obj.get("id", 0)),
            num_buckets=int(obj.get("numBuckets", 1)),
            preprocessors=obj.get("preprocessors"),
            learner=obj.get("learner"),
            protocol=obj.get("protocol"),
            data_fitted=int(obj.get("dataFitted", 0)),
            loss=obj.get("loss"),
            cumulative_loss=obj.get("cumulativeLoss"),
            score=obj.get("score"),
            lifecycle=obj.get("lifecycle"),
            events=obj.get("events"),
        )

    def to_dict(self) -> dict:
        out = {
            "responseId": self.response_id,
            "id": self.bucket,
            "numBuckets": self.num_buckets,
            "mlpId": self.mlp_id,
            "preprocessors": self.preprocessors,
            "learner": self.learner,
            "protocol": self.protocol,
            "dataFitted": self.data_fitted,
            "loss": self.loss,
            "cumulativeLoss": self.cumulative_loss,
            "score": self.score,
        }
        if self.lifecycle is not None:
            out["lifecycle"] = dict(self.lifecycle)
        if self.events is not None:
            out["events"] = [dict(e) for e in self.events]
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
