"""Hub: the parameter-server-side runtime.

Counterpart of ``omldm_tpu/runtime/hub.py`` (the reference's ``FlinkHub`` +
``HubLogic``, FlinkHub.scala:25-197) on its default route: one instance per
(networkId, hubId); worker messages arriving before hub creation are cached
(FlinkHub.scala:70-87) and drained after creation; each hub keeps its
pipeline's ``Statistics``. A SingleLearner hub holds the pipeline's one
model, on the job's device (FlinkHub.scala:128-153). With cohorts armed
(``JobConfig.cohort`` ``auto`` or ``on``) every shard gets the manager's
``GangAverager``, so same-protocol shards whose rounds complete in one
event window average in one stacked reduction.

A hub's receive boundary (:meth:`Hub.receive`, :meth:`Hub._dispatch`)
runs, in order: the liveness clock, the reliable channel's receive window
(a worker's stream: duplicates drop, reordered messages wait, a lost gap
NACKs the worker), the wire-byte count, the transport codec's decode and
the guard's delta admission, then the protocol node. With the flight
recorder armed, a gap records a ``gap_resync`` event and the message's
``(networkId, seq)`` stamp rides the decision events the node records.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from omldm_tpu_torch.api.requests import Request
from omldm_tpu_torch.api.stats import Statistics
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.protocols.centralized import CentralizedMLServer
from omldm_tpu_torch.protocols.registry import make_hub_node, resolve_protocol
from omldm_tpu_torch.runtime.cohort import GangAverager
from omldm_tpu_torch.runtime.databuffers import DataSet
from omldm_tpu_torch.runtime.events import GAP_RESYNC, events_armed_for
from omldm_tpu_torch.runtime.messages import (
    OP_NACK,
    ReceiveWindow,
    StreamSequencer,
    channel_chaos_spec,
    channel_window_size,
    payload_size,
    reliability_armed,
)
from omldm_tpu_torch.runtime.spoke import create_pipeline


class Hub:
    """One (networkId, hubId) parameter-server shard."""

    def __init__(
        self,
        network_id: int,
        hub_id: int,
        request: Request,
        dim: int,
        config: JobConfig,
        reply: Callable,       # (worker_id, op, payload)
        broadcast: Callable,   # (op, payload)
        device,
    ):
        self.network_id = network_id
        self.hub_id = hub_id
        tc = request.training_configuration
        self.protocol = resolve_protocol(
            tc.protocol, request.learner.name, config.parallelism
        )
        self.node = make_hub_node(
            self.protocol, network_id, hub_id, config.parallelism,
            tc.hub_parallelism, tc, reply, broadcast,
        )
        # stats carry the resolved protocol, not the requested one
        self.node.stats.protocol = self.protocol
        # the reliable channel: one receive window a worker stream (None:
        # not armed, the plain receive)
        self._windows: Optional[Dict[int, ReceiveWindow]] = (
            {} if reliability_armed(tc, channel_chaos_spec(config)) else None
        )
        self._window_size = channel_window_size(tc)
        self._quiesced = False
        if isinstance(self.node, CentralizedMLServer):
            # SingleLearner: the central model, seeded from the request id
            # as the workers' replicas are; no spoke checks a guard on it,
            # and the JAX hub builds it unguarded
            self.node.attach_pipeline(create_pipeline(request, dim, device, guarded=False))
            # hub-side fits are program launches too
            stats = self.node.stats
            self.node.pipeline.on_launch = (
                lambda: stats.update_stats(program_launches=1)
            )

    def receive(self, worker_id: int, op: str, payload: Any,
                seq: Optional[int] = None) -> None:
        """Worker->hub receive boundary. With the reliable channel armed,
        each message passes the worker's :class:`ReceiveWindow` first: a
        duplicate drops (counted), an out-of-order message waits for its
        gap, and a gap past the window fast-forwards and NACKs the worker
        (its codec delta stream re-anchors too). A message from anyone is
        also the liveness clock's tick."""
        if self.node.events is not None:
            # the transport stamp of the message being dispatched: the
            # decision events this receive triggers (rejection, retirement,
            # resync, re-admission) carry it. A held or reordered delivery
            # keeps the triggering message's stamp: the decision happened
            # at this receive
            self.node._rx_stamp = (self.network_id, seq) if seq is not None else None
        if self.node.liveness_armed:
            self.node.note_worker(worker_id)
            self.node.check_liveness()
        if seq is None or self._windows is None:
            self._dispatch(worker_id, op, payload)
            return
        window = self._windows.get(worker_id)
        if window is None:
            # a window born after the quiesce (every earlier message of the
            # worker was lost) passes through, or its final push would wait
            # forever
            window = self._windows[worker_id] = ReceiveWindow(
                self._window_size, passthrough=self._quiesced
            )
        res = window.offer(seq, op, payload)
        if res.duplicates:
            self.node.stats.update_stats(duplicates_dropped=res.duplicates)
        if res.gap:
            self.node.stats.update_stats(gaps_resynced=1)
            if self.node.events is not None:
                self.node.events.record(
                    GAP_RESYNC, "window_gap", pipeline=self.network_id,
                    worker=worker_id, stamp=(self.network_id, seq), side="hub",
                    hub=self.hub_id, expected=res.gap_from, got=res.gap_to)
            if self.node.codec is not None:
                # deltas were lost: the rx base no longer matches the
                # sender's; drop it and make the sender re-anchor
                self.node.codec.reset_rx_stream(f"w{worker_id}>h{self.hub_id}")
            self.node.nack_worker(worker_id)
        for d_op, d_payload in res.deliver:
            self._dispatch(worker_id, d_op, d_payload)

    def _dispatch(self, worker_id: int, op: str, payload: Any) -> None:
        # count the bytes that crossed the wire (encoded when the worker
        # compressed) and decode once: protocol logic and its bytesShipped
        # accounting never see an encoded leaf
        self.node.stats.update_stats(bytes_on_wire=payload_size(payload))
        if op == OP_NACK:
            self.node.on_nack(worker_id, payload)
            return
        if self.node.codec is not None:
            payload = self.node.codec.decode(payload)
        # delta admission: a non-finite or exploded worker update stops here,
        # before protocol logic or round accounting can fold it in
        if self.node.guard_armed:
            if self.node.guard_admit(worker_id, op, payload) is not None:
                return
        self.node.receive(worker_id, op, payload)

    def flush_windows(self) -> None:
        """Stream end: deliver whatever the receive windows still hold."""
        self._quiesced = True
        if not self._windows:
            return
        # a delivery may complete a round whose release makes a worker push
        # into a NEW window: iterate over a snapshot
        for worker_id, window in list(self._windows.items()):
            for op, payload in window.flush():
                self._dispatch(worker_id, op, payload)

    def set_parallelism(self, n_workers: int) -> None:
        """The worker count changed: retired workers' windows go (a reused
        slot restarts at seq 0 against a fresh one), then the protocol node
        prunes its round state."""
        if self._windows:
            for w in [w for w in self._windows if w >= n_workers]:
                del self._windows[w]
        self.node.set_parallelism(n_workers)

    def statistics(self) -> Statistics:
        return self.node.stats

    def on_terminate(self) -> None:
        self.node.on_terminate()
        # the hub's codec seconds fold into its statistics once, here (the
        # spoke side folds a delta at each query and at termination)
        codec = self.node.codec
        if codec is not None:
            self.node.stats.update_stats(
                codec_encode_seconds=codec.encode_seconds,
                codec_decode_seconds=codec.decode_seconds,
            )


class HubManager:
    """Routes worker->hub traffic; caches messages that beat hub creation
    (FlinkHub.scala:70-87)."""

    def __init__(self, config: JobConfig, reply_to_spoke: Callable, device):
        self.config = config
        self.device = device
        self.hubs: Dict[Tuple[int, int], Hub] = {}
        # (network_id, hub_id, worker_id, op, payload, seq)
        self._reply_to_spoke = reply_to_spoke
        self._pre_creation: Dict[Tuple[int, int], DataSet] = {}
        # hub->worker sequencers, one a (network, hub), for pipelines whose
        # channel runs the reliable layer
        self._down_seq: Dict[Tuple[int, int], Optional[StreamSequencer]] = {}
        # whether any shard armed liveness: the per-record tick on the data
        # path costs one attribute read when none did
        self._any_liveness = False
        # the every-hub liveness walk runs every `liveness_stride` events,
        # or when a quarter of the tightest armed worker timeout passed
        self._liveness_stride = max(int(getattr(config, "liveness_stride", 16)), 1)
        self._liveness_tick = 0
        self._liveness_deadline = 0.0
        self._liveness_period = 0.0
        # cohort gang averaging: same-cohort PS shards stage completed
        # rounds inside a job event window and average in one stacked
        # [M, W, P] reduction (the per-hub mean, bitwise)
        self.gang: Optional[GangAverager] = (
            GangAverager() if str(config.cohort).lower() in ("auto", "on") else None
        )
        # the flight-recorder journal (runtime/events.EventJournal) handed
        # to every shard's protocol node at creation; None: unarmed
        self.events = None

    def create_hub(self, request: Request, hub_id: int, dim: int) -> Hub:
        key = (request.id, hub_id)
        if key in self.hubs:
            return self.hubs[key]
        net_id = request.id
        armed = reliability_armed(request.training_configuration,
                                  channel_chaos_spec(self.config))
        seqr = StreamSequencer() if armed else None
        self._down_seq[key] = seqr

        def reply(worker_id: int, op: str, payload: Any) -> None:
            self._reply_to_spoke(net_id, hub_id, worker_id, op, payload,
                                 seqr.next(worker_id) if seqr is not None else None)

        def broadcast(op: str, payload: Any) -> None:
            # one reliable stream a destination: each copy carries that
            # worker's next sequence number
            for w in range(self.config.parallelism):
                self._reply_to_spoke(net_id, hub_id, w, op, payload,
                                     seqr.next(w) if seqr is not None else None)

        hub = Hub(net_id, hub_id, request, dim, self.config, reply, broadcast,
                  self.device)
        hub.node.gang = self.gang
        # a pipeline that opts out (trainingConfiguration.events = false)
        # never records, even with the job's recorder armed
        if self.events is not None and events_armed_for(
                request.training_configuration, self.config.events):
            hub.node.events = self.events
        self.hubs[key] = hub
        self._any_liveness = self._any_liveness or hub.node.liveness_armed
        self._refresh_liveness_period()
        cached = self._pre_creation.pop(key, None)
        if cached is not None:
            for worker_id, op, payload, seq in cached:
                hub.receive(worker_id, op, payload, seq)
        return hub

    def set_parallelism(self, n_workers: int) -> None:
        """The worker count changed: every shard updates it and drops the
        retired workers' round state, and the hub->worker sequencers forget
        the retired workers' streams."""
        for seqr in self._down_seq.values():
            if seqr is not None:
                seqr.drop_streams(
                    [w for w in seqr._next if isinstance(w, int) and w >= n_workers])
        for hub in self.hubs.values():
            hub.set_parallelism(n_workers)

    def delete_network(self, network_id: int) -> None:
        for key in [k for k in self.hubs if k[0] == network_id]:
            del self.hubs[key]
        for key in [k for k in self._pre_creation if k[0] == network_id]:
            del self._pre_creation[key]
        for key in [k for k in self._down_seq if k[0] == network_id]:
            del self._down_seq[key]
        self._any_liveness = any(h.node.liveness_armed for h in self.hubs.values())
        self._refresh_liveness_period()

    def route(self, network_id: int, hub_id: int, worker_id: int, op: str,
              payload: Any, seq: Optional[int] = None) -> None:
        hub = self.hubs.get((network_id, hub_id))
        if hub is None:
            cache = self._pre_creation.setdefault(
                (network_id, hub_id), DataSet(self.config.hub_cache_cap)
            )
            cache.append((worker_id, op, payload, seq))
            return
        hub.receive(worker_id, op, payload, seq)

    def flush_windows(self) -> None:
        """Stream end: every shard's receive windows hand back what they
        hold."""
        for hub in self.hubs.values():
            hub.flush_windows()

    def _refresh_liveness_period(self) -> None:
        """The deadline half of the stride: walk at least every quarter of
        the tightest armed worker timeout, however sparse the events."""
        timeouts = [h.node.worker_timeout_s for h in self.hubs.values()
                    if h.node.liveness_armed]
        self._liveness_period = min(timeouts) / 4.0 if timeouts else 0.0
        self._liveness_deadline = 0.0  # walk on the next armed event

    def check_liveness(self, force: bool = False) -> None:
        """Clock every liveness-armed shard's deadline check from the data
        path: when a silent worker blocks the fleet on a barrier no
        protocol message reaches ``Hub.receive``, but records keep coming.
        One flag read when nothing armed liveness; armed, the walk runs
        every ``liveness_stride`` events or when the deadline passed."""
        if not self._any_liveness:
            return
        self._liveness_tick += 1
        if not force and self._liveness_tick < self._liveness_stride:
            if time.monotonic() < self._liveness_deadline:
                return
        self._liveness_tick = 0
        self._liveness_deadline = time.monotonic() + self._liveness_period
        for hub in self.hubs.values():
            if hub.node.liveness_armed:
                hub.node.check_liveness()

    def network_statistics(self, network_id: int) -> Optional[Statistics]:
        """Merged cross-hub statistics for one pipeline
        (StateAccumulators.scala:54-126)."""
        stats = [
            h.statistics() for (nid, _), h in self.hubs.items() if nid == network_id
        ]
        if not stats:
            return None
        merged = stats[0]
        for s in stats[1:]:
            merged = merged.merge(s)
        return merged

    def on_terminate(self) -> None:
        for hub in self.hubs.values():
            hub.on_terminate()
