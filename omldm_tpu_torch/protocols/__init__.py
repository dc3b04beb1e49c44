"""Distributed-learning protocols (ported so far: Asynchronous)."""

from omldm_tpu_torch.protocols.base import HubNode, WorkerNode
from omldm_tpu_torch.protocols.registry import (
    PROTOCOLS,
    REFERENCE_PROTOCOLS,
    make_hub_node,
    make_worker_node,
    resolve_protocol,
)

__all__ = [
    "WorkerNode",
    "HubNode",
    "PROTOCOLS",
    "REFERENCE_PROTOCOLS",
    "make_worker_node",
    "make_hub_node",
    "resolve_protocol",
]
