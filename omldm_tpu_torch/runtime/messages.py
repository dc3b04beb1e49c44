"""In-process wire protocol between spokes (workers) and hubs (PS shards).

Counterpart of ``omldm_tpu/runtime/messages.py``. Messages are plain
Python objects routed through function calls; ``payload_size`` keeps the
reference's byte-accounting contract (``CountableSerial.getSize``,
FlinkMessage.scala:16-23), which feeds modelsShipped / bytesShipped /
numOfBlocks (FlinkHub.scala:118-127), and counts a transport-encoded leaf
(``runtime.codec.EncodedLeaf``) at its wire size.

The reliable channel lives here too: per-stream sequence numbers
(:class:`StreamSequencer`) and receive windows (:class:`ReceiveWindow`)
that drop duplicates, hold reordered messages and declare a gap lost past
their bound. A pipeline arms it with ``comm.reliable``, a ``comm.quorum``,
or whenever the job runs a chaos spec (:func:`reliability_armed`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# RPC operation names
OP_PUSH = "push"            # worker -> PS: model/gradient contribution
OP_UPDATE = "update"        # PS -> worker: new global model
OP_PULL = "pull"            # PS -> worker: send your model (GM/FGM)
OP_ZETA = "zeta"            # GM/FGM safe-zone traffic
# reliable-channel control plane: the receiver asks the sender to re-ship
# (a gap or a stall), and the authoritative full-state re-ship itself
OP_NACK = "nack"
OP_RESYNC = "resync"

# the transport codecs (trainingConfiguration.comm.codec)
CODECS = ("none", "fp16", "int8", "topk")


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
    if hasattr(payload, "nbytes"):  # numpy scalars, tensors, EncodedLeaf
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
    accepted too), ``"none"`` by default; an unknown name raises."""
    extra = getattr(tc, "extra", None) or {}
    name = str(comm_dict(tc).get("codec", extra.get("codec", "none")) or "none").lower()
    if name not in CODECS:
        raise ValueError(f"unknown comm codec {name!r}; expected one of {CODECS}")
    return name



@dataclasses.dataclass
class NodeId:
    """(nodeType, id): BipartiteTopologyAPI.sites.NodeId
    (FlinkNetwork.scala:295)."""

    node_type: str
    id: int

    def __str__(self) -> str:
        return f"{self.node_type}:{self.id}"


@dataclasses.dataclass
class Message:
    """Point-to-point message (SpokeMessage / single-destination
    HubMessage). ``seq`` is the reliable channel's per-stream number (None
    when the channel is not armed)."""

    network_id: int
    operation: str
    source: Optional[NodeId]
    destination: Optional[NodeId]
    payload: Any = None
    request: Any = None
    seq: Optional[int] = None

    def get_size(self) -> int:
        # 16 bytes of header (networkId + op id) + ids + payload
        # (SpokeMessage.scala:48-55)
        return 16 + 8 * 2 + payload_size(self.payload)


@dataclasses.dataclass
class BroadcastMessage:
    """One payload shipped to many workers (the reference's ``HubMessage``
    with parallel arrays of destinations, HubMessage.scala:8-13); ``seqs``
    holds one sequence number a destination, since a broadcast is one
    reliable stream a destination."""

    network_id: int
    operation: str
    source: Optional[NodeId]
    destinations: Sequence[NodeId]
    payload: Any = None
    request: Any = None
    seqs: Optional[Sequence[int]] = None

    def get_size(self) -> int:
        return 16 + 8 * (1 + len(self.destinations)) + payload_size(self.payload)

    def expand(self) -> List[Message]:
        """The per-destination Messages (FlinkLearning.scala:65-75)."""
        return [
            Message(self.network_id, self.operation, self.source, d, self.payload,
                    self.request, self.seqs[i] if self.seqs is not None else None)
            for i, d in enumerate(self.destinations)
        ]


# --- the reliable channel: per-stream sequencing and receive windows ---
#
# The reference's PS->worker edge is a Kafka topic (psMessages,
# Job.scala:76-87): at least once, so messages may be duplicated, delayed,
# reordered or lost. The in-process router delivers each message exactly
# once; once a lossy channel (the chaos channel) sits between hub and
# spoke, the endpoints need the dedupe / reorder / resync discipline below.
# Unarmed, nothing is stamped and no window exists.


class StreamSequencer:
    """Monotonic per-stream sequence numbers for one sender."""

    def __init__(self) -> None:
        self._next: Dict[Any, int] = {}

    def next(self, key: Any) -> int:
        n = self._next.get(key, 0)
        self._next[key] = n + 1
        return n

    def drop_streams(self, keys) -> None:
        """Forget streams (to retired workers), so a reused slot restarts
        at seq 0, as the fresh window its receiver builds expects."""
        for k in list(keys):
            self._next.pop(k, None)


class WindowResult:
    """Outcome of offering one message to a :class:`ReceiveWindow`."""

    __slots__ = ("deliver", "duplicates", "gap", "gap_from", "gap_to")

    def __init__(self) -> None:
        self.deliver: List[Tuple[str, Any]] = []  # in order: (op, payload)
        self.duplicates = 0
        self.gap = False
        # with ``gap``: the receiver expected gap_from and jumped to gap_to
        self.gap_from = 0
        self.gap_to = 0


class ReceiveWindow:
    """Receive-side dedupe and bounded reorder buffer for ONE stream.

    - a duplicate (a seq already delivered or held) drops;
    - an out-of-order message is held until its gap fills, up to ``size``
      outstanding, and delivery is in sequence order;
    - a gap that outlives the bound is declared LOST: the window fast-
      forwards past it (delivering what it held, in order) and reports
      ``gap=True`` so the caller NACKs the sender for a re-ship;
    - an :data:`OP_RESYNC` message is that re-ship: it supersedes whatever
      is held and restarts the window at its seq.
    """

    def __init__(self, size: int = 16, passthrough: bool = False):
        self.size = max(int(size), 1)
        self.expected = 0
        self._held: Dict[int, Tuple[str, Any]] = {}
        # after flush() (stream end) messages pass at once: holding a final
        # push behind a hole would starve the final statistics. A window
        # born after the quiesce starts so.
        self._passthrough = bool(passthrough)
        self.duplicates_dropped = 0
        self.gaps_resynced = 0

    def __len__(self) -> int:
        return len(self._held)

    def offer(self, seq: int, op: str, payload: Any) -> WindowResult:
        res = WindowResult()
        if self._passthrough:
            if seq < self.expected:
                res.duplicates = 1
                self.duplicates_dropped += 1
            else:
                self.expected = seq + 1
                res.deliver.append((op, payload))
            return res
        # the duplicate check comes first, for a resync too: a late copy of
        # a resync already taken must not rewind the window
        if seq < self.expected or seq in self._held:
            res.duplicates = 1
            self.duplicates_dropped += 1
            return res
        if op == OP_RESYNC:
            # whatever is held was sent before the re-ship: superseded
            self._held.clear()
            self.expected = seq + 1
            res.deliver.append((op, payload))
            return res
        if seq == self.expected:
            res.deliver.append((op, payload))
            self.expected = seq + 1
            while self.expected in self._held:
                res.deliver.append(self._held.pop(self.expected))
                self.expected += 1
            return res
        # out of order: hold, or declare the gap lost past the bound
        self._held[seq] = (op, payload)
        if seq - self.expected > self.size or len(self._held) > self.size:
            res.gap = True
            res.gap_from = self.expected
            res.gap_to = max(self._held) + 1
            self.gaps_resynced += 1
            for s in sorted(self._held):
                res.deliver.append(self._held[s])
            self.expected = max(self._held) + 1
            self._held.clear()
        return res

    def flush(self) -> List[Tuple[str, Any]]:
        """Stream end: hand back everything held, in sequence order (its
        gaps will never fill), and pass later messages through."""
        out = [self._held[s] for s in sorted(self._held)]
        if self._held:
            self.expected = max(self._held) + 1
        self._held.clear()
        self._passthrough = True
        return out


# --- reliability configuration (trainingConfiguration.comm.*) ---

DEFAULT_WINDOW_SIZE = 16
# batches a blocked worker buffers before it suspects a lost message and
# re-fires its pending exchange (the stall watchdog, armed with the
# reliable channel only; a spurious firing is harmless: the NACK and the
# re-push are idempotent)
DEFAULT_STALL_AFTER = 16


def channel_chaos_spec(config) -> str:
    """The job's chaos spec: ``JobConfig.chaos``, else the ``OMLDM_CHAOS``
    environment variable."""
    return getattr(config, "chaos", "") or os.environ.get("OMLDM_CHAOS", "")


def reliability_armed(tc, chaos_spec: str = "") -> bool:
    """Whether this pipeline's hub<->spoke channel runs the reliable layer
    (sequence numbers, receive windows, NACK and resync): an explicit
    ``comm.reliable`` wins; otherwise a chaos spec or a ``comm.quorum``
    arms it (quorum's retire and re-admit path rides resync)."""
    comm = comm_dict(tc)
    if "reliable" in comm:
        return bool(comm["reliable"])
    return bool(chaos_spec) or comm.get("quorum") is not None


def channel_window_size(tc) -> int:
    return int(comm_dict(tc).get("windowSize", DEFAULT_WINDOW_SIZE))
