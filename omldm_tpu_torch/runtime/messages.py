"""In-process wire protocol between spokes (workers) and hubs (PS shards).

Counterpart of ``omldm_tpu/runtime/messages.py`` without the reliable
channel (sequence numbers, receive windows), which is not ported. Messages
are plain Python objects routed through function calls; ``payload_size``
keeps the reference's byte-accounting contract (``CountableSerial.getSize``,
FlinkMessage.scala:16-23), which feeds modelsShipped / bytesShipped /
numOfBlocks (FlinkHub.scala:118-127).
"""

from __future__ import annotations

from typing import Any

import numpy as np

# RPC operation names
OP_PUSH = "push"            # worker -> PS: model/gradient contribution
OP_UPDATE = "update"        # PS -> worker: new global model
OP_PULL = "pull"            # PS -> worker: send your model (GM/FGM)
OP_ZETA = "zeta"            # GM/FGM safe-zone traffic


def payload_size(payload: Any) -> int:
    """Serialized byte size of a message payload. Array leaves count their
    exact buffer size (``nbytes``); Python scalars count 8 bytes;
    containers recurse."""
    if payload is None:
        return 0
    t = type(payload)
    if t is float or t is int:
        return 8
    if t is tuple or t is list:
        return sum(payload_size(p) for p in payload)
    if isinstance(payload, np.ndarray):
        return int(payload.nbytes)
    if hasattr(payload, "nbytes"):  # numpy scalars, tensors
        return int(payload.nbytes)
    if isinstance(payload, (list, tuple)):
        return sum(payload_size(p) for p in payload)
    if isinstance(payload, dict):
        return sum(payload_size(v) for v in payload.values())
    if isinstance(payload, (int, float, bool)):
        return 8
    if isinstance(payload, str):
        return len(payload.encode())
    return 8


def comm_dict(tc) -> dict:
    """The ``trainingConfiguration.comm`` table (empty when absent)."""
    extra = getattr(tc, "extra", None) or {}
    return extra.get("comm") or {}


def comm_codec_name(tc) -> str:
    """The pipeline's transport codec (``comm.codec``, a flat ``codec``
    accepted too), ``"none"`` by default."""
    extra = getattr(tc, "extra", None) or {}
    return str(comm_dict(tc).get("codec", extra.get("codec", "none")) or "none").lower()
