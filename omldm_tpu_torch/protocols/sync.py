"""Synchronous (BSP) and stale-synchronous (SSP) parameter servers.

Counterpart of ``omldm_tpu/protocols/sync.py`` (MLNodeGenerator.scala:20-76).
Both barriers count the active workers (``HubNode.round_target``,
``active_workers``), so a worker that liveness or the guard retires stops
being waited for, and ``_barrier_recheck`` releases what its retirement
completed; a resync stands in for a lost release. A Synchronous round that
completes while the job's cohort gang-averaging window is open averages
with the other hubs' rounds of that window (``runtime.cohort.GangAverager``):

- Synchronous: a worker that reaches its sync point blocks (buffers
  incoming batches) until the PS has collected a contribution from every
  worker, averaged them, and broadcast the round's model.
- SSP: workers advance in local rounds; a worker may run ahead of the
  slowest by at most ``staleness`` rounds (config extra, default 3).
  Within the bound it keeps training on its stale local view; beyond it,
  it blocks until the stragglers catch up. The PS folds each pushed model
  into a running global and releases blocked workers as the slowest clock
  advances.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import numpy as np

from omldm_tpu_torch.protocols.base import HubNode
from omldm_tpu_torch.protocols.common import SyncingWorker
from omldm_tpu_torch.runtime.messages import OP_PUSH, OP_UPDATE


class SynchronousWorker(SyncingWorker):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending_hubs: set = set()

    def on_sync_point(self) -> None:
        # mark waiting BEFORE pushing: with in-process routing the hub's
        # round-completing broadcast arrives inside send_vector, and setting
        # the flags afterwards would overwrite that release and stall the
        # whole fleet
        self._pending_hubs = set(range(self.n_hubs))
        self.waiting = True  # block until every hub shard replies
        self.send_vector(OP_PUSH, "params", self.get_flat())

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        if op == OP_UPDATE:
            self.apply_shard(payload, hub_id)
            self._pending_hubs.discard(hub_id)
            if not self._pending_hubs:
                self.waiting = False
                self.drain_blocked()

    def channel_resynced(self, payload: dict, hub_id: int) -> None:
        # the resync stands in for this hub shard's lost round release
        self._pending_hubs.discard(hub_id)
        self.waiting = bool(self._pending_hubs)

    def final_push(self) -> None:
        self.send_vector(OP_PUSH, "params", self.get_flat())


class SynchronousParameterServer(HubNode):
    """Collects one contribution per worker per round; averages; broadcasts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._round: Dict[int, np.ndarray] = {}
        self._fitted_seen: Dict[int, int] = {}
        self.global_params: Optional[np.ndarray] = None

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op != OP_PUSH:
            return
        self.count_received(payload)
        self.record_curve(payload["curve"])
        d = payload["fitted"] - self._fitted_seen.get(worker_id, 0)
        self._fitted_seen[worker_id] = payload["fitted"]
        self.stats.update_fitted(max(d, 0))
        self._round[worker_id] = payload["params"]
        self._maybe_finish_round()

    def _maybe_finish_round(self) -> None:
        # round_target shrinks when a worker retires, so the active ones
        # release the round instead of the fleet blocking on a straggler
        if len(self._round) >= self.round_target():
            stacked = np.stack(list(self._round.values()))
            self._round.clear()
            if self.gang is not None and self.gang.active:
                # cohort gang averaging: the rounds that complete in this
                # event window average together, one stacked reduction
                self.gang.stage(self, stacked)
            else:
                self._finish_round(stacked.mean(axis=0))

    def _finish_round(self, averaged: np.ndarray) -> None:
        self.global_params = averaged
        self.note_round_release()
        self.count_shipped(
            self.global_params,
            n_dest=self.n_workers,
            models=self.n_workers if self.hub_id == 0 else 0,
        )
        self.broadcast(OP_UPDATE, self.global_params)

    def worker_retired(self, worker_id: int) -> None:
        # its in-flight contribution still averages into the round it
        # joined; it just stops being waited for
        pass

    def _barrier_recheck(self) -> None:
        self._maybe_finish_round()

    def set_parallelism(self, n_workers: int) -> None:
        """A shrink may leave the pruned round complete, with every
        survivor waiting: the barrier is re-checked here."""
        super().set_parallelism(n_workers)
        self._prune_retired(self._round, n_workers)
        self._maybe_finish_round()

    def on_terminate(self) -> None:
        # release any round stuck behind a straggler that quiesced
        if self._round and self.global_params is None:
            self.global_params = np.stack(list(self._round.values())).mean(axis=0)


class SSPWorker(SyncingWorker):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.clock = 0
        self._wait_hubs: set = set()

    def on_sync_point(self) -> None:
        self.clock += 1
        # optimistically continue: the PS replies with the fresher global,
        # and a "wait" order when this worker is too far ahead
        self.send_vector(
            OP_PUSH, "params", self.get_flat(), extra={"clock": self.clock}
        )

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        if op == OP_UPDATE:
            if payload.get("params") is not None:
                self.apply_shard(payload["params"], hub_id)
            if payload.get("wait", False):
                self._wait_hubs.add(hub_id)
            else:
                self._wait_hubs.discard(hub_id)
            self.waiting = bool(self._wait_hubs)
            if not self.waiting:
                self.drain_blocked()

    def channel_resynced(self, payload: dict, hub_id: int) -> None:
        # a resync releases this hub's staleness hold (the PS resyncs only
        # workers it considers releasable or re-admitted)
        self._wait_hubs.discard(hub_id)
        self.waiting = bool(self._wait_hubs)

    def final_push(self) -> None:
        self.send_vector(
            OP_PUSH, "params", self.get_flat(), extra={"clock": self.clock}
        )


class SSPClock:
    """Per-worker SSP round clocks + wait-set: the two worker-keyed tables
    of the staleness barrier (last pushed clock, blocked-on-staleness
    flag). ``slowest`` ranges over the active workers."""

    def __init__(self, staleness: int):
        self.staleness = int(staleness)
        self.clocks: Dict[int, int] = {}
        self.waiting: Dict[int, bool] = {}

    def note_push(self, worker_id: int, clock: int) -> None:
        self.clocks[worker_id] = clock

    def slowest(self, active: Iterable[int]) -> int:
        clocks = [self.clocks.get(w, 0) for w in active]
        return min(clocks) if clocks else 0

    def should_wait(self, worker_id: int, active: Iterable[int]) -> bool:
        wait = self.clocks.get(worker_id, 0) - self.slowest(active) > self.staleness
        self.waiting[worker_id] = wait
        return wait

    def releasable(self, active: Iterable[int]) -> list:
        """Waiting workers back inside the staleness bound, marked
        released."""
        slowest = self.slowest(active)
        out = []
        for w, waiting in list(self.waiting.items()):
            if waiting and self.clocks.get(w, 0) - slowest <= self.staleness:
                self.waiting[w] = False
                out.append(w)
        return out

    def worker_retired(self, worker_id: int) -> None:
        """Drop a retired worker from the window: its clock no longer
        anchors ``slowest`` and it cannot sit in the wait-set. The caller
        re-evaluates ``releasable`` after."""
        self.clocks.pop(worker_id, None)
        self.waiting.pop(worker_id, None)


class SSPParameterServer(HubNode):
    """Tracks per-worker clocks; enforces ``fastest - slowest <= staleness``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.staleness = int(self.config.extra.get("staleness", 3))
        self._clock_table = SSPClock(self.staleness)
        self._fitted_seen: Dict[int, int] = {}
        self.global_params: Optional[np.ndarray] = None

    @property
    def _clocks(self) -> Dict[int, int]:
        return self._clock_table.clocks

    @property
    def _waiting(self) -> Dict[int, bool]:
        return self._clock_table.waiting

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op != OP_PUSH:
            return
        self.count_received(payload)
        self.record_curve(payload["curve"])
        d = payload["fitted"] - self._fitted_seen.get(worker_id, 0)
        self._fitted_seen[worker_id] = payload["fitted"]
        self.stats.update_fitted(max(d, 0))

        self._clock_table.note_push(worker_id, payload["clock"])
        if self.global_params is None:
            self.global_params = payload["params"].copy()
        else:
            # running average fold (async-style within the staleness window)
            self.global_params = (
                self.global_params * (self.n_workers - 1) + payload["params"]
            ) / float(self.n_workers)

        wait = self._clock_table.should_wait(worker_id, self.active_workers())
        self.count_shipped(self.global_params, models=1 if self.hub_id == 0 else 0)
        self.reply(worker_id, OP_UPDATE, {"params": self.global_params, "wait": wait})
        if not wait:
            self._release_unblocked()

    def _release_unblocked(self) -> None:
        for w in self._clock_table.releasable(self.active_workers()):
            self.note_round_release()
            self.count_shipped(self.global_params, models=1 if self.hub_id == 0 else 0)
            self.reply(w, OP_UPDATE, {"params": self.global_params, "wait": False})

    def worker_retired(self, worker_id: int) -> None:
        self._clock_table.worker_retired(worker_id)

    def _barrier_recheck(self) -> None:
        # the retired straggler may have been all that held the staleness
        # window down: survivors waiting only on it release here
        if self.global_params is not None:
            self._release_unblocked()

    def set_parallelism(self, n_workers: int) -> None:
        """Retired clocks leave the staleness window; releases are
        re-evaluated."""
        super().set_parallelism(n_workers)
        for w in [w for w in list(self._clocks) if w >= n_workers]:
            self._clock_table.worker_retired(w)
        if self.global_params is not None:
            self._release_unblocked()

    def on_terminate(self) -> None:
        # release everything at quiesce
        for w in list(self._waiting):
            if self._waiting[w]:
                self._waiting[w] = False
                self.reply(w, OP_UPDATE, {"params": self.global_params, "wait": False})
