"""Elastic Averaging SGD (EASGD).

Counterpart of ``omldm_tpu/protocols/easgd.py`` (Zhang, Choromanska &
LeCun 2015, the asynchronous variant): each worker explores with its local
params x_i; a center variable x_tilde lives on the PS; on each push

    x_i     <- x_i     - alpha * (x_i - x_tilde)
    x_tilde <- x_tilde + alpha * (x_i - x_tilde)

``alpha`` comes from the config extras (default 0.5/n).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from omldm_tpu_torch.protocols.base import HubNode
from omldm_tpu_torch.protocols.common import SyncingWorker, shard_slice
from omldm_tpu_torch.runtime.messages import OP_PUSH, OP_UPDATE


class EASGDWorker(SyncingWorker):
    def on_sync_point(self) -> None:
        self.send_vector(OP_PUSH, "params", self.get_flat())

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        if op == OP_UPDATE:
            # the payload is this hub shard's elastic difference
            # alpha * (x_i - x_tilde), subtracted from the local params
            current = self.get_flat()
            if self.n_hubs == 1:
                self.set_flat(current - payload)
            else:
                sl = shard_slice(hub_id, current.size, self.n_hubs)
                current[sl] = current[sl] - payload
                self.set_flat(current)

    def final_push(self) -> None:
        self.on_sync_point()


class EASGDParameterServer(HubNode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = float(self.config.extra.get("alpha", 0.5 / max(self.n_workers, 1)))
        self.center: Optional[np.ndarray] = None
        self._fitted_seen: Dict[int, int] = {}

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op != OP_PUSH:
            return
        self.count_received(payload)
        self.record_curve(payload["curve"])
        d = payload["fitted"] - self._fitted_seen.get(worker_id, 0)
        self._fitted_seen[worker_id] = payload["fitted"]
        self.stats.update_fitted(max(d, 0))

        x_i = payload["params"]
        if self.center is None:
            self.center = x_i.copy()
        elastic = self.alpha * (x_i - self.center)
        self.center = self.center + elastic
        self.count_shipped(elastic, models=1 if self.hub_id == 0 else 0)
        self.reply(worker_id, OP_UPDATE, elastic)

    @property
    def global_params(self) -> Optional[np.ndarray]:
        return self.center
