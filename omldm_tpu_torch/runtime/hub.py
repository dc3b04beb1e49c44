"""Hub: the parameter-server-side runtime.

Counterpart of ``omldm_tpu/runtime/hub.py`` (the reference's ``FlinkHub`` +
``HubLogic``, FlinkHub.scala:25-197) on its default route: one instance per
(networkId, hubId); worker messages arriving before hub creation are cached
(FlinkHub.scala:70-87) and drained after creation; each hub keeps its
pipeline's ``Statistics``. A SingleLearner hub holds the pipeline's one
model, on the job's device (FlinkHub.scala:128-153). With cohorts armed
(``JobConfig.cohort`` ``auto`` or ``on``) every shard gets the manager's
``GangAverager``, so same-protocol shards whose rounds complete in one
event window average in one stacked reduction. The reliable channel is not
ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from omldm_tpu_torch.api.requests import Request
from omldm_tpu_torch.api.stats import Statistics
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.protocols.centralized import CentralizedMLServer
from omldm_tpu_torch.protocols.registry import make_hub_node, resolve_protocol
from omldm_tpu_torch.runtime.cohort import GangAverager
from omldm_tpu_torch.runtime.databuffers import DataSet
from omldm_tpu_torch.runtime.messages import payload_size
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
        if isinstance(self.node, CentralizedMLServer):
            # SingleLearner: the central model, seeded from the request id
            # as the workers' replicas are
            self.node.attach_pipeline(create_pipeline(request, dim, device))
            # hub-side fits are program launches too
            stats = self.node.stats
            self.node.pipeline.on_launch = (
                lambda: stats.update_stats(program_launches=1)
            )

    def receive(self, worker_id: int, op: str, payload: Any) -> None:
        """Worker->hub receive boundary: count the bytes that crossed the
        wire, then hand the payload to the protocol node."""
        self.node.stats.update_stats(bytes_on_wire=payload_size(payload))
        self.node.receive(worker_id, op, payload)

    def statistics(self) -> Statistics:
        return self.node.stats

    def on_terminate(self) -> None:
        self.node.on_terminate()


class HubManager:
    """Routes worker->hub traffic; caches messages that beat hub creation
    (FlinkHub.scala:70-87)."""

    def __init__(self, config: JobConfig, reply_to_spoke: Callable, device):
        self.config = config
        self.device = device
        self.hubs: Dict[Tuple[int, int], Hub] = {}
        # (network_id, hub_id, worker_id, op, payload)
        self._reply_to_spoke = reply_to_spoke
        self._pre_creation: Dict[Tuple[int, int], DataSet] = {}
        # cohort gang averaging: same-cohort PS shards stage completed
        # rounds inside a job event window and average in one stacked
        # [M, W, P] reduction (the per-hub mean, bitwise)
        self.gang: Optional[GangAverager] = (
            GangAverager() if str(config.cohort).lower() in ("auto", "on") else None
        )

    def create_hub(self, request: Request, hub_id: int, dim: int) -> Hub:
        key = (request.id, hub_id)
        if key in self.hubs:
            return self.hubs[key]
        net_id = request.id

        def reply(worker_id: int, op: str, payload: Any) -> None:
            self._reply_to_spoke(net_id, hub_id, worker_id, op, payload)

        def broadcast(op: str, payload: Any) -> None:
            for w in range(self.config.parallelism):
                self._reply_to_spoke(net_id, hub_id, w, op, payload)

        hub = Hub(net_id, hub_id, request, dim, self.config, reply, broadcast,
                  self.device)
        hub.node.gang = self.gang
        self.hubs[key] = hub
        cached = self._pre_creation.pop(key, None)
        if cached is not None:
            for worker_id, op, payload in cached:
                hub.receive(worker_id, op, payload)
        return hub

    def delete_network(self, network_id: int) -> None:
        for key in [k for k in self.hubs if k[0] == network_id]:
            del self.hubs[key]
        for key in [k for k in self._pre_creation if k[0] == network_id]:
            del self._pre_creation[key]

    def route(self, network_id: int, hub_id: int, worker_id: int, op: str,
              payload: Any) -> None:
        hub = self.hubs.get((network_id, hub_id))
        if hub is None:
            cache = self._pre_creation.setdefault(
                (network_id, hub_id), DataSet(self.config.hub_cache_cap)
            )
            cache.append((worker_id, op, payload))
            return
        hub.receive(worker_id, op, payload)

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
