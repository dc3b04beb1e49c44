"""Protocol node interfaces: worker (spoke-side) and hub (PS-side).

Counterpart of ``omldm_tpu/protocols/base.py``. Nodes are plain Python objects exchanging in-process
messages through ``send``/``reply``/``broadcast`` callables. A worker node
wraps an ``MLPipeline`` replica; a hub node owns the protocol's global
state and the per-pipeline ``Statistics``.

The boundaries every message crosses live here:

- **Transport codec** (``comm.codec``, ``runtime.codec``): a worker encodes
  each outgoing payload once (``_send_encoded``) and decodes hub payloads
  in ``deliver``; a hub encodes each reply or broadcast once
  (``_reply_ship``, ``_broadcast_ship``) and counts the bytes that cross
  the wire into ``bytesOnWire``. Without a codec no codec object exists.
- **Reliable channel**: a NACK restarts the codec stream and re-ships
  state (``on_channel_nack``, ``on_nack``), an ``OP_RESYNC`` carries the
  hub's authoritative state (``resync_worker``, ``on_resync``).
- **Liveness and quorum** (``comm.quorum``, ``comm.workerTimeoutMs``): a
  worker silent past the timeout is retired from round accounting, never
  below the quorum, and re-admitted with a resync when it speaks again;
  ``active_workers`` and ``round_target`` count the active ones.
- **Delta admission** (``trainingConfiguration.guard``): each decoded
  worker payload passes ``guard_admit`` first; a non-finite or exploded
  one is rejected (``deltasRejected``), its sender resynced and, past the
  strike budget, retired until a healthy push re-admits it.
- **Cohorts**: a worker that consumes its batch at once says so
  (``consumes_batch_synchronously``), and a hub may stage its round
  average on the job's ``GangAverager`` (``HubNode.gang``).
- **Flight recorder** (``runtime.events``): with the job's journal armed
  (``HubNode.events``) the admission, liveness, quorum and resync decisions
  above record typed events, stamped with the ``(networkId, seq)`` of the
  message that triggered them (``_rx_stamp``, set by ``Hub.receive``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional, Set

import numpy as np

from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.api.stats import Statistics
from omldm_tpu_torch.guard import _payload_vector, admission_reason, guard_config, payload_non_finite
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.runtime.codec import make_transport_codec
from omldm_tpu_torch.runtime.events import (
    DELTA_REJECTED,
    QUORUM_RELEASE,
    RESYNC,
    WORKER_READMITTED,
    WORKER_RETIRED,
)
from omldm_tpu_torch.runtime.messages import OP_NACK, OP_RESYNC, comm_dict, payload_size

# send(op: str, payload, hub_id: int) -> None           (worker -> hub)
SendFn = Callable[[str, Any, int], None]
# reply(worker_id: int, op: str, payload) -> None       (hub -> one worker)
ReplyFn = Callable[[int, str, Any], None]
# broadcast(op: str, payload) -> None                   (hub -> all workers)
BroadcastFn = Callable[[str, Any], None]


class WorkerNode:
    """Spoke-side protocol node wrapping a local pipeline replica."""

    # True for a node whose on_training_batch fits (or stages) the batch
    # before it returns, keeping no reference to it: the spoke may then
    # hand a cohort member zero-copy views of its batcher
    consumes_batch_synchronously = False

    def __init__(
        self,
        pipeline: MLPipeline,
        worker_id: int,
        n_workers: int,
        config: TrainingConfiguration,
        send: SendFn,
    ):
        self.pipeline = pipeline
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.config = config
        self.send = send
        self.paused = False  # toggle() support (FlinkSpoke.scala:130)
        # transport codec: every outgoing payload is encoded once at this
        # ship boundary; with none, ``send`` stays the raw router callable
        self._send_raw = send
        self.codec = make_transport_codec(config)
        if self.codec is not None:
            self.send = self._send_encoded
        # set by the spoke when the pipeline's channel runs the reliable
        # layer; gates SyncingWorker's stall watchdog
        self.channel_armed = False

    def _send_encoded(self, op: str, payload: Any, hub_id: int = 0) -> None:
        try:
            payload = self.codec.encode(payload, stream=f"w{self.worker_id}>h{hub_id}")
        except ValueError:
            guard = getattr(self.pipeline, "guard", None)
            if guard is None or not payload_non_finite(payload):
                # unguarded, or a finite payload the codec refused: a bug
                # upstream or in the codec, which must fail loudly
                raise
            # guarded and corrupt: the guard's pending check recovers
            # (rollback + resync); hub admission would reject the payload
            return
        self._send_raw(op, payload, hub_id)

    def deliver(self, op: str, payload: Any, hub_id: int = 0) -> None:
        """Receive boundary for hub messages (Spoke.receive_from_hub):
        reliable-channel control messages (NACK, resync; never encoded) go
        to their handlers, everything else is decoded once and handed to
        :meth:`receive`."""
        if op == OP_NACK:
            self.on_channel_nack(hub_id)
            return
        if op == OP_RESYNC:
            self.on_resync(payload, hub_id)
            return
        if self.codec is not None:
            payload = self.codec.decode(payload)
        self.receive(op, payload, hub_id)

    # --- reliable-channel hooks ---

    def on_channel_nack(self, hub_id: int = 0) -> None:
        """Hub shard ``hub_id`` found a gap (or a stalled round) on our
        stream: restart the stream's codec state, so the next top-k encode
        re-anchors, and re-push local state."""
        if self.codec is not None:
            self.codec.reset_tx_stream(f"w{self.worker_id}>h{hub_id}")
        self.resend_state(hub_id)

    def resend_state(self, hub_id: int = 0) -> None:
        """Re-ship whatever the protocol's hub needs from this worker."""

    def on_resync(self, payload: Any, hub_id: int = 0) -> None:
        """Authoritative full-state re-ship from hub ``hub_id`` (a raw dict
        with at least ``params``). Base workers ignore it; SyncingWorker
        adopts the shard and clears its wait state."""

    def request_resync(self) -> None:
        """Ask every hub shard for an authoritative re-ship. The guard fires
        this right after a rollback: the NACK takes the channel's repair
        path (Hub._dispatch -> on_nack -> resync_worker -> OP_RESYNC),
        armed or not, so the rolled-back worker catches up to the fleet."""
        n_hubs = max(int(getattr(self.config, "hub_parallelism", 1)), 1)
        for h in range(n_hubs):
            self.send(OP_NACK, {"guard": True}, h)

    def on_start(self) -> None:
        """Called once after creation (GM and FGM anchor their drift
        baseline at the initial model)."""

    def on_model_seeded(self) -> None:
        """The caller replaced this node's pipeline state wholesale (a
        loaded state): protocols that snapshot a drift baseline re-anchor
        here, or the seeded params would register as drift from the init
        estimate."""

    def on_training_batch(self, x, y, mask) -> Optional[Any]:
        """Consume one micro-batch; returns the (lazy) loss or None if the
        batch was held."""
        raise NotImplementedError

    def on_forecast_batch(self, x) -> np.ndarray:
        """Serve predictions with the local (possibly stale) model. The copy
        to the host waits for the device."""
        return self.pipeline.predict(x).cpu().numpy()

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        """Handle a hub->worker message from hub shard ``hub_id``."""

    def query_stats(self) -> dict:
        """Fitted/loss numbers for query responses."""
        return {
            "data_fitted": self.pipeline.fitted,
            "cumulative_loss": self.pipeline.cumulative_loss,
        }

    def on_flush(self) -> None:
        """Stream quiescing (termination probe): push any pending state so
        hub-side statistics are complete."""

    def toggle(self) -> None:
        self.paused = not self.paused

    def set_parallelism(self, n_workers: int) -> None:
        """The worker count changed (the reference's shared
        ``spokeParallelism``, FlinkSpoke.scala:31,345-348)."""
        self.n_workers = n_workers


class HubNode:
    """Hub-side protocol node owning global protocol state + statistics."""

    def __init__(
        self,
        network_id: int,
        hub_id: int,
        n_workers: int,
        n_hubs: int,
        config: TrainingConfiguration,
        reply: ReplyFn,
        broadcast: BroadcastFn,
    ):
        self.network_id = network_id
        self.hub_id = hub_id
        self.n_workers = n_workers
        self.n_hubs = n_hubs
        self.config = config
        self.stats = Statistics(pipeline=network_id, protocol=config.protocol)
        # ship hooks: every hub->worker payload leaves through these two
        # wrappers, which count the bytes that cross the wire into
        # ``bytes_on_wire`` (logical accounting, bytesShipped, stays at the
        # protocol call sites through count_shipped)
        self._reply_raw = reply
        self._broadcast_raw = broadcast
        # cohort gang averaging (runtime.cohort.GangAverager): set by the
        # HubManager when the job arms cohorts; a protocol that averages
        # rounds (SynchronousParameterServer) stages its completed rounds
        # on it while a window is open. None: every round averages inline
        self.gang = None
        # the flight-recorder journal (runtime/events.EventJournal), set by
        # the HubManager when the plane is armed: the decision sites below
        # record through it (one attribute read a site when None).
        # ``_rx_stamp`` is the transport stamp of the message being
        # dispatched (set by Hub.receive), which those events carry
        self.events = None
        self._rx_stamp = None
        # the transport codec: each reply or broadcast is encoded once
        self.codec = make_transport_codec(config)
        self.reply = self._reply_ship
        self.broadcast = self._broadcast_ship
        # worker liveness (comm.quorum, comm.workerTimeoutMs): with a quorum,
        # a worker silent past the timeout is retired from round accounting
        # while at least ``quorum`` stay active, and re-admitted with a
        # resync when it speaks again. Without one: n of n.
        comm = comm_dict(config)
        q = comm.get("quorum")
        self.quorum: Optional[int] = int(q) if q is not None else None
        self.worker_timeout_s = float(comm.get("workerTimeoutMs", 30_000)) / 1000.0
        self._clock = time.time  # injectable (tests use a fake clock)
        self._last_seen: dict = {}
        self._liveness_epoch: Optional[float] = None
        self._retired_live: Set[int] = set()
        # delta admission (trainingConfiguration.guard): rejected pushes
        # count strikes; past ``maxStrikes`` the sender is retired until an
        # admitted params push re-admits it
        self.guard_cfg = guard_config(config)
        self._guard_strikes: dict = {}
        self._guard_retired: Set[int] = set()

    def _reply_ship(self, worker_id: int, op: str, payload: Any) -> None:
        if self.codec is not None:
            payload = self.codec.encode(payload, stream=f"h{self.hub_id}>w{worker_id}")
        self.stats.update_stats(bytes_on_wire=payload_size(payload))
        self._reply_raw(worker_id, op, payload)

    def _broadcast_ship(self, op: str, payload: Any) -> None:
        if self.codec is not None:
            # one encode a broadcast: every destination decodes the same bytes
            payload = self.codec.encode(payload, stream=f"h{self.hub_id}>*")
        self.stats.update_stats(
            bytes_on_wire=payload_size(payload) * self.n_workers
        )
        self._broadcast_raw(op, payload)

    # --- worker liveness and quorum round release ---

    @property
    def liveness_armed(self) -> bool:
        return self.quorum is not None

    def _event(self, kind: str, cause: str, **fields) -> None:
        """Record one decision tagged with this pipeline when the flight
        recorder is armed (runtime/events.py)."""
        if self.events is not None:
            self.events.record(kind, cause, pipeline=self.network_id, **fields)

    def _retired(self) -> Set[int]:
        """Workers left out of round accounting: liveness-retired (silent
        past the deadline) and guard-retired (repeatedly poisoned)."""
        if self._guard_retired:
            return self._retired_live | self._guard_retired
        return self._retired_live

    def note_worker(self, worker_id: int) -> None:
        """A sign of life; a liveness-retired worker is re-admitted as a
        fresh join and caught up with a resync."""
        now = self._clock()
        if self._liveness_epoch is None:
            self._liveness_epoch = now
        self._last_seen[worker_id] = now
        if worker_id in self._retired_live:
            self._retired_live.discard(worker_id)
            self._event(WORKER_READMITTED, "sign_of_life", worker=worker_id,
                        stamp=self._rx_stamp, hub=self.hub_id)
            self.resync_worker(worker_id)

    def check_liveness(self) -> None:
        """Retire workers silent past ``comm.workerTimeoutMs`` (never below
        the quorum) and re-evaluate the barriers the smaller active set now
        satisfies."""
        if not self.liveness_armed or self._liveness_epoch is None:
            return
        now = self._clock()
        retired_any = False
        for w in range(self.n_workers):
            if w in self._retired_live:
                continue
            if self.round_target() <= max(self.quorum, 1):
                break  # at the quorum floor: nobody else may retire
            seen = self._last_seen.get(w, self._liveness_epoch)
            if now - seen > self.worker_timeout_s:
                self._retired_live.add(w)
                retired_any = True
                self._event(WORKER_RETIRED, "liveness_timeout", worker=w,
                            silent_s=round(now - seen, 3), hub=self.hub_id)
                self.worker_retired(w)
        if retired_any:
            self._barrier_recheck()

    def worker_retired(self, worker_id: int) -> None:
        """``worker_id`` left round accounting: protocols with worker-keyed
        barrier state drop its entries here (the re-evaluation follows in
        :meth:`_barrier_recheck`)."""

    def _barrier_recheck(self) -> None:
        """Re-evaluate every barrier against the smaller active set;
        protocols with rounds, clocks or polls override it (a barrier
        blocked on a retired worker would otherwise never release)."""

    def note_round_release(self) -> None:
        """A barrier released; with liveness-retired workers it was a
        quorum release."""
        if self._retired_live:
            self.stats.update_stats(quorum_releases=1)
            self._event(QUORUM_RELEASE, "retired_worker_excluded",
                        active=self.round_target(), retired=sorted(self._retired()))

    # --- delta admission (trainingConfiguration.guard) ---

    @property
    def guard_armed(self) -> bool:
        return self.guard_cfg is not None

    def guard_admit(self, worker_id: int, op: str, payload: Any) -> Optional[str]:
        """Admission of one decoded worker payload: None (admitted) or the
        rejection reason, in which case the payload must not reach
        :meth:`receive`: the rejection was counted, the worker resynced and,
        past the strike budget, retired so barriers release without it."""
        reason = admission_reason(payload, self.guard_cfg.norm_limit)
        if reason is None:
            if worker_id in self._guard_retired and self._carries_params(payload):
                # a healthy params push is the re-admission ticket (a
                # control message carries no model to judge)
                self._guard_retired.discard(worker_id)
                self._guard_strikes.pop(worker_id, None)
                self._event(WORKER_READMITTED, "healthy_push", worker=worker_id,
                            stamp=self._rx_stamp, hub=self.hub_id)
                self.resync_worker(worker_id)
            elif worker_id in self._guard_strikes and self._carries_params(payload):
                self._guard_strikes.pop(worker_id, None)
            return None
        self.stats.update_stats(deltas_rejected=1)
        strikes = self._guard_strikes.get(worker_id, 0) + 1
        self._guard_strikes[worker_id] = strikes
        self._event(DELTA_REJECTED, reason, worker=worker_id, stamp=self._rx_stamp,
                    op=op, strikes=strikes, hub=self.hub_id)
        if (
            strikes >= self.guard_cfg.max_strikes
            and worker_id not in self._guard_retired
            # the liveness floor: never below the quorum, or one worker
            and self.round_target() > max(self.quorum or 1, 1)
        ):
            # the offender stops being waited for but keeps receiving
            # broadcasts, so a healed model can re-admit it later
            self._guard_retired.add(worker_id)
            self._event(WORKER_RETIRED, "guard_strikes", worker=worker_id,
                        stamp=self._rx_stamp, strikes=strikes, hub=self.hub_id)
            self.worker_retired(worker_id)
            self._barrier_recheck()
        if self.codec is not None:
            # decode ran before admission: a rejected top-k delta already
            # advanced our rx base with the poison. Drop the base and, at
            # the first strike only, NACK the sender so both ends re-anchor
            # (the NACK makes the worker re-push at once, and a worker
            # still corrupt would otherwise recurse without bound)
            self.codec.reset_rx_stream(f"w{worker_id}>h{self.hub_id}")
            if strikes == 1:
                self.nack_worker(worker_id)
        # authoritative catch-up: ship the sender the last good global
        self.resync_worker(worker_id)
        return reason

    @staticmethod
    def _carries_params(payload: Any) -> bool:
        """Whether the payload ships a model vector that admission judged
        (the re-admission ticket must be a healthy model)."""
        return _payload_vector(payload) is not None

    def resync_payload(self) -> Optional[dict]:
        """The hub's authoritative state for a re-ship (``params`` at
        least), or None when it has none yet."""
        params = getattr(self, "global_params", None)
        if params is None:
            return None
        return {"params": params}

    def resync_worker(self, worker_id: int) -> None:
        """Re-ship authoritative state to one worker (a NACK's answer, or a
        re-admitted worker's catch-up). It ships RAW, past the codec, and
        restarts the codec's stream to that worker so the next top-k delta
        re-anchors."""
        if self.codec is not None:
            self.codec.reset_tx_stream(f"h{self.hub_id}>w{worker_id}")
        payload = self.resync_payload()
        if payload is None:
            return
        self._event(RESYNC, "authoritative_reship", worker=worker_id,
                    stamp=self._rx_stamp, hub=self.hub_id)
        self.stats.update_stats(bytes_on_wire=payload_size(payload))
        self._reply_raw(worker_id, OP_RESYNC, payload)

    def nack_worker(self, worker_id: int) -> None:
        """Ask one worker to re-ship its state (a gap on its stream)."""
        self.stats.update_stats(bytes_on_wire=payload_size({"gap": True}))
        self._reply_raw(worker_id, OP_NACK, {"gap": True})

    def on_nack(self, worker_id: int, payload: Any = None) -> None:
        """A worker NACKed us (a gap on its window, its stall watchdog, or
        its guard's rollback): re-ship the authoritative model."""
        self.resync_worker(worker_id)

    # --- statistics helpers (byte accounting at the send sites, mirroring
    # FlinkHub.scala:118-127 / FlinkNetwork getSize calls) ---

    def count_received(self, payload: Any) -> None:
        self.stats.update_stats(bytes_shipped=payload_size(payload))

    def count_shipped(
        self,
        payload: Any,
        n_dest: int = 1,
        blocks: int = 1,
        models: Optional[int] = None,
    ) -> None:
        """``models`` overrides the model count (shard hubs > 0 pass 0 so a
        model sharded over h hubs counts once, with h blocks)."""
        self.stats.update_stats(
            models_shipped=n_dest if models is None else models,
            bytes_shipped=payload_size(payload) * n_dest,
            num_of_blocks=blocks,
        )

    def record_curve(self, slices) -> None:
        """Accumulate (loss, fitted) learning-curve points pushed by workers
        (FlinkHub.scala:101-116)."""
        self.stats.extend_curve(slices)

    def active_workers(self):
        """Worker ids a barrier counts (liveness- and guard-retired ids
        excluded)."""
        retired = self._retired()
        return [w for w in range(self.n_workers) if w not in retired]

    def round_target(self) -> int:
        """Contributions a barrier needs to release: the active workers."""
        return max(self.n_workers - len(self._retired()), 1)

    def set_parallelism(self, n_workers: int) -> None:
        """The worker count changed. ``_fitted_seen`` (the per-worker
        fitted watermark) folds into survivor ``w % n_workers``, whose
        pipeline absorbs the retired replica's; liveness and guard records
        of retired slots go; the codec forgets their streams, so a reused
        slot starts fresh ones. Protocols with worker-keyed barrier state
        override it to prune and re-check their barriers."""
        self.n_workers = n_workers
        seen = getattr(self, "_fitted_seen", None)
        if isinstance(seen, dict):
            for w in [w for w in seen if isinstance(w, int) and w >= n_workers]:
                seen[w % n_workers] = seen.get(w % n_workers, 0) + seen.pop(w)
        self._prune_retired(self._last_seen, n_workers)
        self._retired_live = {w for w in self._retired_live if w < n_workers}
        self._prune_retired(self._guard_strikes, n_workers)
        self._guard_retired = {w for w in self._guard_retired if w < n_workers}
        if self.codec is not None:
            self.codec.reset_retired_worker_streams(n_workers)

    @staticmethod
    def _prune_retired(d: dict, n_workers: int) -> None:
        """Drop worker-keyed entries of retired workers (id >= n)."""
        for w in [w for w in d if isinstance(w, int) and w >= n_workers]:
            del d[w]

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        raise NotImplementedError

    def on_terminate(self) -> None:
        """Final chance to fold state into stats before the job report."""
