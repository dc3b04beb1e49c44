"""CentralizedTraining and SingleLearner protocols.

Counterpart of ``omldm_tpu/protocols/centralized.py``
(MLNodeGenerator.scala:20-76):

- ``CentralizedTraining`` -- ``SingleWorker`` / ``SimplePS``: the protocol
  every Create at parallelism 1 is forced onto. The single worker trains
  locally; the PS is a passive statistics/model mirror.
- ``SingleLearner`` -- ``ForwardingWorker`` / ``CentralizedMLServer``:
  workers forward raw batches; ONE model lives on the hub (the runtime
  attaches its pipeline, on the job's device); forced for HT and K-means.
  The hub ships the model back every ``syncEvery`` fits (default 8) so the
  workers serve predictions with it, and reports ``fitted`` and the
  learning curve. A host-side model (HT) ships as the tree object itself,
  shared in process.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from omldm_tpu_torch.protocols.base import HubNode, WorkerNode
from omldm_tpu_torch.runtime.messages import OP_PUSH, OP_UPDATE


class SingleWorker(WorkerNode):
    """Trains locally; ships params + curve slices to the PS every
    ``syncEvery`` batches (default 4) for statistics and query parity."""

    consumes_batch_synchronously = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.sync_every = int(self.config.extra.get("syncEvery", 4))
        self._batches = 0

    def _push_state(self) -> None:
        flat, _ = self.pipeline.get_flat_params()
        self.send(OP_PUSH, {
            "params": flat,
            "curve": self.pipeline.curve_slice(),
            "fitted": self.pipeline.fitted,
            "mean_buffer_size": 0.0,
        }, 0)

    def on_training_batch(self, x, y, mask) -> Optional[Any]:
        loss = self.pipeline.fit(x, y, mask)
        self._batches += 1
        if self._batches % self.sync_every == 0:
            # a staged cohort fit: push after the gang launch
            if not self.pipeline.defer_after_launch(self._push_state):
                self._push_state()
        return loss

    def on_flush(self) -> None:
        self._push_state()


class SimplePS(HubNode):
    """Passive PS: stores the latest model snapshot + accumulates stats."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.global_params: Optional[np.ndarray] = None
        # per-worker fitted watermark: pushes from different workers
        # interleave, so deltas are computed per source
        self._fitted_seen: Dict[int, int] = {}

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op != OP_PUSH:
            return
        self.count_received(payload)
        self.global_params = payload["params"]
        self.record_curve(payload["curve"])
        delta = payload["fitted"] - self._fitted_seen.get(worker_id, 0)
        self._fitted_seen[worker_id] = payload["fitted"]
        self.stats.update_fitted(max(delta, 0))


class ForwardingWorker(WorkerNode):
    """Forwards raw training batches to the central hub model; serves
    predictions with the last model the hub broadcast back."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._hub_fitted = 0
        self._hub_cum_loss = 0.0

    def on_training_batch(self, x, y, mask) -> Optional[Any]:
        # raw data, not a model exchange: the transport codec must never
        # quantize training batches, so this bypasses the encoding send
        self._send_raw(OP_PUSH, {"x": x, "y": y, "mask": mask}, 0)
        return None

    def receive(self, op: str, payload: Any, hub_id: int = 0) -> None:
        if op == OP_UPDATE:
            # a flat vector, or a host-side model's tree shared in process
            model = payload["model"]
            if isinstance(model, np.ndarray):
                self.pipeline.set_flat_params(model)
            else:
                self.pipeline.state["params"] = model
            self._hub_fitted = payload["fitted"]
            self._hub_cum_loss = payload["cum_loss"]

    def query_stats(self) -> dict:
        # the model lives on the hub; report the hub's counters
        return {
            "data_fitted": self._hub_fitted,
            "cumulative_loss": self._hub_cum_loss,
        }


class CentralizedMLServer(HubNode):
    """THE model lives here and trains on the forwarded batches. The
    runtime gives it a pipeline of its own (``attach_pipeline``) right
    after construction."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pipeline = None
        self.sync_every = int(self.config.extra.get("syncEvery", 8))
        self._batches = 0

    def attach_pipeline(self, pipeline) -> None:
        self.pipeline = pipeline

    def _ship_model(self) -> None:
        if self.pipeline.learner.host_side:
            model = self.pipeline.state["params"]  # in-process share
        else:
            model, _ = self.pipeline.get_flat_params()
        payload = {
            "model": model,
            "fitted": self.pipeline.fitted,
            "cum_loss": self.pipeline.cumulative_loss,
        }
        self.count_shipped(payload, n_dest=self.n_workers)
        self.broadcast(OP_UPDATE, payload)
        # drain the curve as it grows: holding it to terminate would pin
        # one lazy loss a fit
        self.record_curve(self.pipeline.curve_slice())
        self.stats.fitted = self.pipeline.fitted

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        if op != OP_PUSH:
            return
        self.count_received(payload)
        self.pipeline.fit(payload["x"], payload["y"], payload["mask"])
        self._batches += 1
        if self._batches % self.sync_every == 0:
            self._ship_model()

    def on_terminate(self) -> None:
        if self.pipeline is not None:
            self._ship_model()
