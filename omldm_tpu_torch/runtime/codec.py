"""Transport codec for hub<->spoke model and delta payloads.

Counterpart of ``omldm_tpu/runtime/codec.py``; the reference ships full
model buckets and only counts them (``CountableSerial.getSize``,
FlinkMessage.scala:16-23). This layer keeps the counting contract (encoded
bytes flow into ``bytesOnWire``) and compresses each shipped array leaf,
with sender-side error feedback.

How it plugs in:

- **Senders** (``WorkerNode._send_encoded``, ``HubNode._reply_ship`` and
  ``_broadcast_ship`` in ``protocols/base.py``) call
  :meth:`TransportCodec.encode` once a message with a stream key unique to
  the direction (``w{worker}>h{hub}``, ``h{hub}>w{worker}``, ``h{hub}>*``).
  Float array leaves of at least ``minLeafSize`` elements become
  :class:`EncodedLeaf`; everything else passes through. Each leaf's
  quantization error lands in a per-(stream, leaf) residual added to the
  next value shipped on that stream.
- **Receivers** (``Hub._dispatch``, ``WorkerNode.deliver``) decode once;
  protocol logic never sees an encoded leaf.
- ``payload_size`` counts ``EncodedLeaf.nbytes``, the wire size.

Codecs (``trainingConfiguration.comm.codec``): ``none`` (no codec object at
all: every route is the plain one), ``fp16`` (2 bytes an element), ``int8``
(affine, 1 byte an element + 8 bytes a leaf) and ``topk`` (top-k deltas
against a per-stream base both ends advance; every ``anchorEvery``
messages, default 64, the sender restarts the stream at seq 0 and a zero
base, so a receiver that missed a delta realigns within one cycle).

The codec works on host numpy arrays: the payloads the host plane ships
are flat parameter vectors already read back to the host at a sync point.
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from omldm_tpu_torch.ops.codec import (
    fp16_decode,
    fp16_encode,
    int8_affine_decode,
    int8_affine_encode,
    topk_decode,
    topk_encode,
)
from omldm_tpu_torch.runtime.messages import CODECS, comm_codec_name, comm_dict

# leaves below this many elements ship raw: per-leaf metadata would eat
# the win, and tiny payloads (votes, thetas, curve slices) are not the
# traffic this layer exists to shrink
DEFAULT_MIN_LEAF_SIZE = 16

# default top-k keep fraction: 1/16 of the vector per sync (8 wire bytes
# per kept element -> ~8x below raw fp32 at this fraction)
DEFAULT_TOPK_FRACTION = 16

# topk stream anchor cadence: every N messages the sender restarts the
# delta stream from a zero base (seq wraps to 0, the receiver re-anchors
# on seeing it), bounding the lifetime of any base desync
DEFAULT_ANCHOR_EVERY = 64


class EncodedLeaf:
    """One compressed array leaf inside a message payload.

    ``nbytes`` is the WIRE size, so ``payload_size`` (which prefers the
    ``nbytes`` attribute) counts transport bytes for encoded payloads the
    same way it counts buffer bytes for raw ndarrays."""

    __slots__ = ("kind", "data", "meta", "shape", "dtype", "stream", "seq")

    def __init__(self, kind, data, meta, shape, dtype, stream, seq=0):
        self.kind = kind
        self.data = data       # ndarray (fp16/int8) or (idx, val) for topk
        self.meta = meta       # codec-specific: int8 (scale, zero); else None
        self.shape = shape
        self.dtype = dtype
        self.stream = stream   # sender stream key; names the rx base (topk)
        self.seq = seq         # per-stream message ordinal (topk sync check)

    @property
    def nbytes(self) -> int:
        if self.kind == "topk":
            idx, val = self.data
            return int(idx.nbytes + val.nbytes)
        n = int(self.data.nbytes)
        if self.kind == "int8":
            n += 8  # scale + zero point, float32 each
        return n

    @property
    def logical_nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize

    def __repr__(self) -> str:  # debugging aid, never on the wire
        return (
            f"EncodedLeaf({self.kind}, shape={self.shape}, "
            f"wire={self.nbytes}B, stream={self.stream!r})"
        )


def _is_codable(leaf: Any, min_size: int) -> bool:
    return (
        isinstance(leaf, np.ndarray)
        and leaf.dtype.kind == "f"
        and leaf.size >= min_size
    )


class TransportCodec:
    """Per-node encoder/decoder with error-feedback state.

    One instance lives on each protocol node (worker or hub shard); its
    ``_residual``/``_tx_base`` dicts are SENDER state keyed by the node's
    outgoing streams, and ``_rx_base`` is RECEIVER state for the streams
    it decodes. Streams are strings unique per direction
    (``w{worker}>h{hub}``, ``h{hub}>w{worker}``, ``h{hub}>*``), so one
    object can hold both roles without collisions."""

    def __init__(
        self,
        kind: str,
        top_k: Optional[int] = None,
        min_leaf_size: int = DEFAULT_MIN_LEAF_SIZE,
        anchor_every: int = DEFAULT_ANCHOR_EVERY,
    ):
        if kind not in CODECS or kind == "none":
            raise ValueError(f"TransportCodec kind must be one of "
                             f"{CODECS[1:]}, got {kind!r}")
        self.kind = kind
        self.top_k = top_k
        self.min_leaf_size = int(min_leaf_size)
        self.anchor_every = max(int(anchor_every), 1)
        self._residual: Dict[Tuple[str, str], np.ndarray] = {}
        self._tx_base: Dict[Tuple[str, str], np.ndarray] = {}
        self._tx_seq: Dict[Tuple[str, str], int] = {}
        self._rx_base: Dict[Tuple[str, str], np.ndarray] = {}
        # instrumentation (benchmarks read these)
        self.leaves_encoded = 0
        self.bytes_logical = 0
        self.bytes_wire = 0
        self.encode_seconds = 0.0
        self.decode_seconds = 0.0

    # --- encode ---

    def encode(self, payload: Any, stream: str) -> Any:
        """Compress qualifying array leaves of ``payload``; non-array
        structure passes through unchanged (and payloads with nothing to
        encode come back identical, not wrapped)."""
        t0 = time.perf_counter()
        out = self._walk_encode(payload, stream, "")
        self.encode_seconds += time.perf_counter() - t0
        return out

    def _walk_encode(self, node: Any, stream: str, path: str) -> Any:
        if _is_codable(node, self.min_leaf_size):
            return self._encode_leaf(node, stream, path)
        if isinstance(node, dict):
            return {
                k: self._walk_encode(v, stream, f"{path}.{k}")
                for k, v in node.items()
            }
        if isinstance(node, (list, tuple)) and any(
            _is_codable(v, self.min_leaf_size) or isinstance(v, (dict, list, tuple))
            for v in node
        ):
            walked = [
                self._walk_encode(v, stream, f"{path}.{i}")
                for i, v in enumerate(node)
            ]
            return type(node)(walked)
        return node

    def _ef(self, key: Tuple[str, str], x: np.ndarray) -> np.ndarray:
        r = self._residual.get(key)
        if r is None or r.shape != x.shape:
            return np.asarray(x, np.float32)
        return np.asarray(x, np.float32) + r

    def _encode_leaf(self, x: np.ndarray, stream: str, path: str) -> EncodedLeaf:
        key = (stream, path)
        send = self._ef(key, x)  # error-feedback: ship value + residual
        if self.kind == "fp16":
            q = fp16_encode(send)
            dec = fp16_decode(q)
            leaf = EncodedLeaf("fp16", q, None, x.shape, str(x.dtype), stream)
        elif self.kind == "int8":
            q, scale, zero = int8_affine_encode(send)
            dec = int8_affine_decode(q, scale, zero)
            leaf = EncodedLeaf(
                "int8", q, (scale, zero), x.shape, str(x.dtype), stream
            )
        else:  # topk: ship the delta against the shared stream base
            # the base mechanism IS the error feedback here: the delta
            # x - base already carries all not-yet-shipped mass (the base
            # only ever advances by what was decoded), so adding the
            # residual again would double-count it
            send = np.asarray(x, np.float32)
            seq = self._tx_seq.get(key, 0)
            base = self._tx_base.get(key)
            if base is None or seq == 0 or base.shape != (x.size,):
                # anchor: the stream restarts from a zero base (seq 0
                # tells the receiver to do the same), bounding how long
                # a joined-late or gapped receiver can stay desynced
                base = np.zeros((x.size,), np.float32)
            delta = send.ravel() - base
            k = self.top_k or max(1, x.size // DEFAULT_TOPK_FRACTION)
            idx, val = topk_encode(delta, k)
            new_base = base + topk_decode(idx, val, x.size)
            self._tx_base[key] = new_base
            self._tx_seq[key] = (seq + 1) % self.anchor_every
            leaf = EncodedLeaf(
                "topk", (idx, val), None, x.shape, str(x.dtype), stream, seq
            )
            self.leaves_encoded += 1
            self.bytes_logical += leaf.logical_nbytes
            self.bytes_wire += leaf.nbytes
            return leaf
        self._residual[key] = send - np.asarray(dec, np.float32).reshape(
            send.shape
        )
        self.leaves_encoded += 1
        self.bytes_logical += leaf.logical_nbytes
        self.bytes_wire += leaf.nbytes
        return leaf

    # --- decode ---

    def decode(self, payload: Any) -> Any:
        t0 = time.perf_counter()
        out = _walk_decode(payload, self)
        self.decode_seconds += time.perf_counter() - t0
        return out

    def _decode_topk(self, leaf: EncodedLeaf, path: str) -> np.ndarray:
        key = (leaf.stream, path)
        base = self._rx_base.get(key)
        if base is None or leaf.seq == 0 or base.size != int(
            np.prod(leaf.shape, dtype=np.int64)
        ):
            # stream anchor (seq 0, every anchor_every messages on the
            # sender) or a fresh stream: re-anchor at zero exactly as the
            # sender did. A receiver whose base desynced (missed a delta,
            # joined mid-stream) converges again within one anchor cycle.
            base = np.zeros(
                (int(np.prod(leaf.shape, dtype=np.int64)),), np.float32
            )
        idx, val = leaf.data
        base = base + topk_decode(idx, val, base.size)
        self._rx_base[key] = base
        # a missed delta is not detectable here (and not recoverable if
        # it were) -- recovery rides the next anchor either way
        return base.reshape(leaf.shape).astype(leaf.dtype)

    def reset_streams(self) -> None:
        """Drop all codec state (sender residuals/bases and receiver
        bases) -- e.g. after a model was replaced wholesale."""
        self._residual.clear()
        self._tx_base.clear()
        self._tx_seq.clear()
        self._rx_base.clear()

    # stream keys embed the worker endpoint as ``w<id>`` (``w3>h0``,
    # ``h0>w3``); ``h0>*`` broadcast streams name no worker
    _WORKER_IN_STREAM = re.compile(r"(?:^|>)w(\d+)(?:>|$)")

    def reset_tx_stream(self, stream: str) -> None:
        """Restart one OUTGOING stream from scratch: residuals drop and the
        next topk encode re-anchors at seq 0 / zero base. The reliable
        channel calls this on a NACK so a receiver that lost deltas
        realigns within one message instead of one anchor cycle."""
        for d in (self._residual, self._tx_base, self._tx_seq):
            for key in [k for k in d if k[0] == stream]:
                del d[key]

    def reset_rx_stream(self, stream: str) -> None:
        """Drop the RECEIVE-side delta bases of one stream (the reliable
        channel detected a gap: the base no longer matches the sender's)."""
        for key in [k for k in self._rx_base if k[0] == stream]:
            del self._rx_base[key]

    def reset_retired_worker_streams(self, n_workers: int) -> None:
        """Drop every per-stream state -- INCLUDING receive-side delta
        bases -- belonging to worker node-ids retired by a shrink
        (id >= ``n_workers``). A worker slot reused by a later grow starts
        a fresh stream at seq 0; without this, the hub side would still
        hold the dead worker's bases/residuals keyed to the same stream
        names, and a mid-cycle tx base would make the reused slot decode
        garbage until the next anchor."""
        for d in (self._residual, self._tx_base, self._tx_seq, self._rx_base):
            for key in list(d):
                m = self._WORKER_IN_STREAM.search(key[0])
                if m is not None and int(m.group(1)) >= n_workers:
                    del d[key]


def _decode_leaf(leaf: EncodedLeaf, codec: Optional[TransportCodec], path: str):
    if leaf.kind == "fp16":
        return fp16_decode(leaf.data, leaf.dtype).reshape(leaf.shape)
    if leaf.kind == "int8":
        scale, zero = leaf.meta
        return int8_affine_decode(leaf.data, scale, zero, leaf.dtype).reshape(
            leaf.shape
        )
    if leaf.kind == "topk":
        if codec is None:
            raise ValueError(
                "topk-encoded payloads need a stateful TransportCodec on "
                "the receiver (the stream base); fp16/int8 decode statelessly"
            )
        return codec._decode_topk(leaf, path)
    raise ValueError(f"unknown codec leaf kind {leaf.kind!r}")


def _walk_decode(node: Any, codec: Optional[TransportCodec], path: str = ""):
    if isinstance(node, EncodedLeaf):
        return _decode_leaf(node, codec, path)
    if isinstance(node, dict):
        return {
            k: _walk_decode(v, codec, f"{path}.{k}") for k, v in node.items()
        }
    if isinstance(node, (list, tuple)) and any(
        isinstance(v, (EncodedLeaf, dict, list, tuple)) for v in node
    ):
        return type(node)(
            _walk_decode(v, codec, f"{path}.{i}") for i, v in enumerate(node)
        )
    return node


def decode_payload(payload: Any, codec: Optional[TransportCodec] = None) -> Any:
    """Decode a (possibly) encoded payload back to raw arrays. Stateless
    for fp16/int8; ``topk`` needs the receiving node's codec instance.
    Raw payloads come back untouched (identity, zero copies)."""
    if codec is not None:
        return codec.decode(payload)
    return _walk_decode(payload, None)


def make_transport_codec(tc) -> Optional[TransportCodec]:
    """The pipeline's transport codec from its training configuration, or
    None for ``none`` (the default: the ship and receive paths stay the
    plain ones)."""
    name = comm_codec_name(tc)
    if name == "none":
        return None
    extra = getattr(tc, "extra", None) or {}
    comm = comm_dict(tc)
    top_k = comm.get("topK", extra.get("topK"))
    min_leaf = comm.get("minLeafSize", extra.get("minLeafSize", DEFAULT_MIN_LEAF_SIZE))
    anchor = comm.get("anchorEvery", extra.get("anchorEvery", DEFAULT_ANCHOR_EVERY))
    return TransportCodec(
        name,
        top_k=int(top_k) if top_k is not None else None,
        min_leaf_size=int(min_leaf),
        anchor_every=int(anchor),
    )
