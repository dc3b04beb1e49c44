"""Asynchronous parameter server -- the default protocol.

Counterpart of ``omldm_tpu/protocols/async_ps.py`` (the reference's
``AsynchronousWorker`` / ``AsynchronousParameterServer``,
MLNodeGenerator.scala:28,34-35,57,63-64): each worker pushes its model
whenever it reaches a sync point and immediately receives the current
global model; the PS folds pushes in arrival order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from omldm_tpu_torch.protocols.base import HubNode
from omldm_tpu_torch.protocols.common import SyncingWorker
from omldm_tpu_torch.runtime.messages import OP_PUSH, OP_UPDATE


class AsynchronousWorker(SyncingWorker):
    def on_sync_point(self) -> None:
        self.send_vector(OP_PUSH, "params", self.get_flat())

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        if op == OP_UPDATE:
            self.apply_shard(payload, hub_id)

    def final_push(self) -> None:
        self.on_sync_point()


class AsynchronousParameterServer(HubNode):
    """Running-average fold: each arriving model is mixed into the global
    with weight 1/n in arrival order; the pushing worker immediately
    receives the current global. Seeding from the first push keeps
    arbitrary initializations intact. The global model stays a float32
    numpy vector."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.global_params: Optional[np.ndarray] = None
        self._fitted_seen: Dict[int, int] = {}

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op != OP_PUSH:
            return
        self.count_received(payload)
        params = np.asarray(payload["params"], dtype=np.float32)
        if self.global_params is None:
            self.global_params = params.copy()
        else:
            w = 1.0 / float(self.n_workers)
            self.global_params = (
                (1.0 - w) * self.global_params + w * params
            ).astype(np.float32, copy=False)
        self.record_curve(payload["curve"])
        d = payload["fitted"] - self._fitted_seen.get(worker_id, 0)
        self._fitted_seen[worker_id] = payload["fitted"]
        self.stats.update_fitted(max(d, 0))
        self.count_shipped(
            self.global_params, models=1 if self.hub_id == 0 else 0
        )
        self.reply(worker_id, OP_UPDATE, self.global_params)
