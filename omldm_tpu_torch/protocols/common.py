"""Shared machinery for parameter-exchanging protocol workers.

Counterpart of ``omldm_tpu/protocols/common.py``. ``SyncingWorker`` gives
flat-param access, a sync cadence (``syncEvery`` batches), blocking
semantics (a worker waiting for the PS buffers incoming batches),
curve/fitted piggybacking on pushes, and the reliable channel's recovery:
a worker that buffers ``comm.stallAfter`` batches while waiting (the stall
watchdog, armed with the channel) NACKs its hubs and re-pushes, and an
authoritative resync stands in for a lost release.

Every sync point reads the flat parameters back to the host: one
device->host copy every ``syncEvery`` fits per worker.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from omldm_tpu_torch.protocols.base import WorkerNode
from omldm_tpu_torch.runtime.messages import DEFAULT_STALL_AFTER, OP_NACK, comm_dict

# cap on batches buffered while blocked on the PS (the reference's record
# buffer cap is 100_000 records, SpokeLogic.scala:32)
MAX_BLOCKED_BATCHES = 1024


def shard_slice(h: int, size: int, n_hubs: int) -> slice:
    """Contiguous shard h of a flat parameter vector split over n_hubs."""
    base, rem = divmod(size, n_hubs)
    start = h * base + min(h, rem)
    return slice(start, start + base + (1 if h < rem else 0))


class SyncingWorker(WorkerNode):
    # a batch that does not wait fits into the replica before returning; a
    # waiting worker holds its batches, which then own their arrays (the
    # spoke hands views only to a worker that is not waiting)
    consumes_batch_synchronously = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.sync_every = int(self.config.extra.get("syncEvery", 4))
        self._batches = 0
        self.waiting = False
        self._blocked: List[Tuple[Any, Any, Any]] = []
        # the stall watchdog (reliable channel only): a worker that buffers
        # ``stallAfter`` batches while waiting suspects a lost push or a
        # lost release, NACKs every hub and re-pushes (barrier entries are
        # worker-keyed, so the re-push is idempotent)
        self._stall_after = int(comm_dict(self.config).get("stallAfter", DEFAULT_STALL_AFTER))
        self._stalled_batches = 0

    # --- flat param helpers ---

    @property
    def n_hubs(self) -> int:
        return max(int(self.config.hub_parallelism), 1)

    def get_flat(self) -> np.ndarray:
        flat, _ = self.pipeline.get_flat_params()
        return flat

    def set_flat(self, flat: np.ndarray) -> None:
        self.pipeline.set_flat_params(flat)

    def send_vector(self, op: str, key: str, flat: np.ndarray, extra=None) -> None:
        """Ship a parameter-sized vector to the PS, sharded across the hub
        instances when HubParallelism > 1. Curve/fitted piggyback rides only
        on the shard-0 message so cross-hub stat merging does not double
        count."""
        extra = dict(extra or {})
        piggy = self.piggyback()
        if self.n_hubs == 1:
            self.send(op, {key: flat, **extra, **piggy}, 0)
            return
        for h in range(self.n_hubs):
            meta = piggy if h == 0 else {"curve": [], "fitted": 0}
            self.send(op, {key: flat[shard_slice(h, flat.size, self.n_hubs)],
                           **extra, **meta}, h)

    def apply_shard(self, flat_update: np.ndarray, hub_id: int) -> np.ndarray:
        """Fold a hub shard's vector update into the local flat params;
        returns the new full flat vector."""
        if self.n_hubs == 1:
            self.set_flat(flat_update)
            return flat_update
        current = self.get_flat()
        current[shard_slice(hub_id, current.size, self.n_hubs)] = flat_update
        self.set_flat(current)
        return current

    def piggyback(self) -> dict:
        """Metadata shipped with every push so the PS can keep statistics
        (curve slices + fitted watermark, FlinkHub.scala:101-127)."""
        return {
            "curve": self.pipeline.curve_slice(),
            "fitted": self.pipeline.fitted,
        }

    # --- training path with blocking support ---

    def on_training_batch(self, x, y, mask) -> Optional[Any]:
        # a sync point deferred past the last gang launch may set
        # `waiting`: run it first, so this batch blocks where the
        # undeferred path would block it
        self.pipeline.settle_deferred()
        if self.waiting:
            if len(self._blocked) < MAX_BLOCKED_BATCHES:
                self._blocked.append((x, y, mask))
            if self.channel_armed and self._stall_after > 0:
                self._stalled_batches += 1
                if self._stalled_batches >= self._stall_after:
                    self._stalled_batches = 0
                    self.on_stall()
            return None
        self._stalled_batches = 0
        loss = self.pipeline.fit(x, y, mask)
        self._batches += 1
        if self._batches % self.sync_every == 0:
            # a staged cohort fit: the sync point (which reads the model
            # after the fit) runs right after the gang launch
            if not self.pipeline.defer_after_launch(self.on_sync_point):
                self.on_sync_point()
        return loss

    def drain_blocked(self) -> None:
        """Train the backlog accumulated while waiting on the PS, batches up
        to the next sync point chained through ``fit_many``."""
        while self._blocked and not self.waiting:
            until_sync = self.sync_every - (self._batches % self.sync_every)
            n = min(until_sync, len(self._blocked))
            chunk = self._blocked[:n]
            del self._blocked[:n]
            if n == 1:
                self.pipeline.fit(*chunk[0])
            else:
                self.pipeline.fit_many(
                    np.stack([c[0] for c in chunk]),
                    np.stack([c[1] for c in chunk]),
                    np.stack([c[2] for c in chunk]),
                )
            self._batches += n
            if self._batches % self.sync_every == 0:
                self.on_sync_point()

    def on_sync_point(self) -> None:
        """Called every ``syncEvery`` batches; protocol-specific."""
        raise NotImplementedError

    # --- reliable-channel recovery ---

    def on_stall(self) -> None:
        """Blocked too long: NACK every hub shard (each answers with a
        resync if it has state) and re-push our contribution, in case the
        push was what vanished."""
        for h in range(self.n_hubs):
            self.send(OP_NACK, {"stall": True}, h)
        if self.waiting:
            self.resend_state()

    def resend_state(self, hub_id: int = 0) -> None:
        """Re-ship this worker's contribution (idempotent on the PS)."""
        self.final_push()

    def on_resync(self, payload: Any, hub_id: int = 0) -> None:
        """Adopt the hub's authoritative shard and clear this hub's wait:
        the resync stands in for whatever release was lost. Protocols
        refine ``channel_resynced``."""
        params = (payload or {}).get("params")
        if params is not None:
            self.apply_shard(np.asarray(params), hub_id)
        self.channel_resynced(payload or {}, hub_id)
        if not self.waiting:
            self.drain_blocked()

    def channel_resynced(self, payload: dict, hub_id: int) -> None:
        self.waiting = False

    def on_flush(self) -> None:
        """Quiesce: push whatever the protocol needs for final stats."""
        self.waiting = False
        self.drain_blocked()
        self.final_push()

    def final_push(self) -> None:
        raise NotImplementedError
