"""Distributed-learning protocols: the reference's 8 worker/PS pairs."""

from omldm_tpu_torch.protocols.base import HubNode, WorkerNode
from omldm_tpu_torch.protocols.registry import (
    PROTOCOLS,
    make_hub_node,
    make_worker_node,
    resolve_protocol,
)

__all__ = [
    "WorkerNode",
    "HubNode",
    "PROTOCOLS",
    "make_worker_node",
    "make_hub_node",
    "resolve_protocol",
]
