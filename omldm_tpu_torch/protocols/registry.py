"""Protocol registry: the 8 protocol keys -> (worker, hub) node classes.

Counterpart of ``omldm_tpu/protocols/registry.py``, with the reference's
forcing rules (MLNodeGenerator.scala:20-76, FlinkSpoke.scala:203-215):
HT and K-means force ``SingleLearner``, parallelism 1 forces
``CentralizedTraining``, and unknown keys fall back to ``Asynchronous``.
"""

from __future__ import annotations

from typing import Dict, Tuple, Type

from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.learners.registry import SINGLE_LEARNER_ONLY
from omldm_tpu_torch.protocols.async_ps import (
    AsynchronousParameterServer,
    AsynchronousWorker,
)
from omldm_tpu_torch.protocols.base import HubNode, WorkerNode
from omldm_tpu_torch.protocols.centralized import (
    CentralizedMLServer,
    ForwardingWorker,
    SimplePS,
    SingleWorker,
)
from omldm_tpu_torch.protocols.easgd import EASGDParameterServer, EASGDWorker
from omldm_tpu_torch.protocols.fgm import FGMParameterServer, FGMWorker
from omldm_tpu_torch.protocols.gm import GMParameterServer, GMWorker
from omldm_tpu_torch.protocols.sync import (
    SSPParameterServer,
    SSPWorker,
    SynchronousParameterServer,
    SynchronousWorker,
)

PROTOCOLS: Dict[str, Tuple[Type[WorkerNode], Type[HubNode]]] = {
    "CentralizedTraining": (SingleWorker, SimplePS),
    "SingleLearner": (ForwardingWorker, CentralizedMLServer),
    "Asynchronous": (AsynchronousWorker, AsynchronousParameterServer),
    "Synchronous": (SynchronousWorker, SynchronousParameterServer),
    "SSP": (SSPWorker, SSPParameterServer),
    "EASGD": (EASGDWorker, EASGDParameterServer),
    "GM": (GMWorker, GMParameterServer),
    "FGM": (FGMWorker, FGMParameterServer),
}


def resolve_protocol(requested: str, learner_name: str, parallelism: int) -> str:
    """Apply the reference's forcing rules, then fall back to Asynchronous
    for unknown keys."""
    if learner_name in SINGLE_LEARNER_ONLY:
        return "SingleLearner"
    if parallelism == 1 and requested != "SingleLearner":
        return "CentralizedTraining"
    if requested not in PROTOCOLS:
        return "Asynchronous"
    return requested


def make_worker_node(
    protocol: str, pipeline, worker_id: int, n_workers: int,
    config: TrainingConfiguration, send,
) -> WorkerNode:
    worker_cls, _ = PROTOCOLS[protocol]
    return worker_cls(pipeline, worker_id, n_workers, config, send)


def make_hub_node(
    protocol: str, network_id: int, hub_id: int, n_workers: int, n_hubs: int,
    config: TrainingConfiguration, reply, broadcast,
) -> HubNode:
    _, hub_cls = PROTOCOLS[protocol]
    return hub_cls(network_id, hub_id, n_workers, n_hubs, config, reply, broadcast)
