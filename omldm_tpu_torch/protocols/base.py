"""Protocol node interfaces: worker (spoke-side) and hub (PS-side).

Counterpart of ``omldm_tpu/protocols/base.py`` on its default route: the
transport codec, the model-integrity guard, worker liveness and quorum,
the reliable channel and the flight recorder are not ported, so their
hooks are gone rather than unarmed. The cohort engine's hooks are here: a
worker that consumes its batch at once says so
(``consumes_batch_synchronously``), and a hub may stage its round average
on the job's ``GangAverager`` (``HubNode.gang``). Without liveness every worker stays
active: ``active_workers`` is every worker and ``round_target`` their
count. Nodes are plain Python objects exchanging in-process messages
through ``send``/``reply``/``broadcast`` callables. A worker node wraps an
``MLPipeline`` replica; a hub node owns the protocol's global state and the
per-pipeline ``Statistics``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.api.stats import Statistics
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.runtime.messages import payload_size

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

    def deliver(self, op: str, payload: Any, hub_id: int = 0) -> None:
        """Receive boundary for hub messages (Spoke.receive_from_hub)."""
        self.receive(op, payload, hub_id)

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
        self.reply = self._reply_ship
        self.broadcast = self._broadcast_ship

    def _reply_ship(self, worker_id: int, op: str, payload: Any) -> None:
        self.stats.update_stats(bytes_on_wire=payload_size(payload))
        self._reply_raw(worker_id, op, payload)

    def _broadcast_ship(self, op: str, payload: Any) -> None:
        self.stats.update_stats(
            bytes_on_wire=payload_size(payload) * self.n_workers
        )
        self._broadcast_raw(op, payload)

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

    def active_workers(self) -> range:
        """Worker ids a barrier counts: all of them (no liveness here)."""
        return range(self.n_workers)

    def round_target(self) -> int:
        """Contributions a barrier needs to release."""
        return self.n_workers

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        raise NotImplementedError

    def on_terminate(self) -> None:
        """Final chance to fold state into stats before the job report."""
