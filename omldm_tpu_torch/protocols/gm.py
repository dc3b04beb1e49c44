"""Geometric Monitoring (GM): threshold-based communication skipping.

Counterpart of ``omldm_tpu/protocols/gm.py``: the PS holds an estimate
``e`` (the model average at the last synchronization); each worker
monitors its local drift ``||w_i - e||`` at every sync point (on the host:
the flat params are read back there, as in the JAX package). While every
worker stays inside the threshold sphere no parameters move; a worker
that leaves it sends a tiny violation message, the PS pulls every model,
averages, and starts a new round with the new estimate.

Config extras: ``threshold`` (drift radius T, default 0.5).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from omldm_tpu_torch.protocols.base import HubNode
from omldm_tpu_torch.protocols.common import SyncingWorker
from omldm_tpu_torch.runtime.messages import OP_PULL, OP_PUSH, OP_UPDATE, OP_ZETA


class GMWorker(SyncingWorker):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.threshold = float(self.config.extra.get("threshold", 0.5))
        self._estimate: Optional[np.ndarray] = None
        self._violated = False

    def on_start(self) -> None:
        self._estimate = self.get_flat()

    def on_model_seeded(self) -> None:
        self._estimate = self.get_flat()

    def on_sync_point(self) -> None:
        if self._violated:
            return  # already reported this round; wait for the collection
        current = self.get_flat()
        est = self._estimate if self._estimate is not None else np.zeros_like(current)
        if float(np.linalg.norm(current - est)) > self.threshold:
            self._violated = True
            # a violation message, not a model transfer
            self.send(OP_ZETA, {"violation": True, **self.piggyback()}, 0)

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        if op == OP_PULL:
            self.send(OP_PUSH, {"params": self.get_flat(), **self.piggyback()}, 0)
        elif op == OP_UPDATE:
            self.set_flat(payload)
            self._estimate = payload
            self._violated = False

    def channel_resynced(self, payload: dict, hub_id: int) -> None:
        # the resync carries the estimate of a release we missed: monitor
        # drift from it, or every check would measure from a stale one
        params = payload.get("params")
        if params is not None:
            self._estimate = np.asarray(params)
            self._violated = False
        super().channel_resynced(payload, hub_id)

    def final_push(self) -> None:
        self.send(OP_PUSH, {"params": self.get_flat(), **self.piggyback()}, 0)


def _account(node: HubNode, seen: Dict[int, int], worker_id: int, payload: Any) -> None:
    """Bytes, curve and the fitted delta of one GM/FGM worker message."""
    node.count_received(payload)
    if "curve" in payload:
        node.record_curve(payload["curve"])
    if "fitted" in payload:
        d = payload["fitted"] - seen.get(worker_id, 0)
        seen[worker_id] = payload["fitted"]
        node.stats.update_fitted(max(d, 0))


class GMParameterServer(HubNode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._collecting = False
        self._collected: Dict[int, np.ndarray] = {}
        self._fitted_seen: Dict[int, int] = {}
        self.global_params: Optional[np.ndarray] = None
        self.rounds = 0

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op == OP_ZETA and payload.get("violation"):
            _account(self, self._fitted_seen, worker_id, payload)
            if not self._collecting:
                self._collecting = True
                self._collected.clear()
                self.count_shipped({"pull": True}, n_dest=self.n_workers)
                self.broadcast(OP_PULL, {})
        elif op == OP_PUSH:
            # collection rounds and quiesce-time final pushes fold alike
            _account(self, self._fitted_seen, worker_id, payload)
            self._collected[worker_id] = payload["params"]
            if len(self._collected) >= self.round_target():
                self._finish_round()

    def worker_retired(self, worker_id: int) -> None:
        self._collected.pop(worker_id, None)

    def _barrier_recheck(self) -> None:
        if self._collecting and len(self._collected) >= self.round_target():
            self._finish_round()

    def set_parallelism(self, n_workers: int) -> None:
        """A pruned collection may be complete: finish it here, since every
        survivor may be waiting on the broadcast."""
        super().set_parallelism(n_workers)
        self._prune_retired(self._collected, n_workers)
        self._barrier_recheck()

    def _finish_round(self) -> None:
        self.global_params = np.stack(list(self._collected.values())).mean(axis=0)
        self._collected.clear()
        self._collecting = False
        self.rounds += 1
        self.note_round_release()
        self.count_shipped(self.global_params, n_dest=self.n_workers)
        self.broadcast(OP_UPDATE, self.global_params)
