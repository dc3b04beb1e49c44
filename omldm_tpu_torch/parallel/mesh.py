"""The ("dp", "hub") mesh of the SPMD engine.

Counterpart of ``omldm_tpu/parallel/mesh.py`` (``make_mesh``). The JAX
package lays the fleet over a ``jax.sharding.Mesh``: one data-parallel
worker a device on ``"dp"``, the parameter server's buckets on ``"hub"``.
The port holds the whole fleet on one device, the dp workers as the
leading axis of every state tensor; ``hub`` only buckets the flat
parameter vector, as the JAX package's hub shards do. A process offers as
many mesh slots as it has devices of the kind (``device_slots``), and
``make_mesh`` keeps the reference's rule over them. An explicit
``Mesh(dp, hub, device)`` may name more workers than slots: they share the
device as rows of the leading axis. The device is CUDA unless the caller
asks for the CPU.

A fleet of ``processes`` (``parallel.multihost``) spreads the ``dp``
workers over the processes of one ``torch.distributed`` group: process
``process_id`` holds the ``dp_local`` rows ``[process_id * dp_local,
(process_id + 1) * dp_local)`` of the ``dp_global = dp`` workers. A mesh of
one process is the whole fleet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from omldm_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    hub: int = 1
    device: Optional[torch.device] = None
    processes: int = 1
    process_id: int = 0
    # the fleet's process group (None: the default group)
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.dp < 1 or self.hub < 1:
            raise ValueError(f"mesh axes must be >= 1, got dp={self.dp}, hub={self.hub}")
        if self.processes < 1 or self.dp % self.processes:
            raise ValueError(f"dp={self.dp} workers do not split over {self.processes} "
                             "processes")
        if not 0 <= self.process_id < self.processes:
            raise ValueError(f"process id {self.process_id} outside [0, {self.processes})")
        object.__setattr__(self, "device", resolve_device(self.device, "Mesh"))

    @property
    def dp_global(self) -> int:
        """Workers of the whole fleet."""
        return self.dp

    @property
    def dp_local(self) -> int:
        """Workers this process holds (its rows of the leading axis)."""
        return self.dp // self.processes

    @property
    def fleet(self) -> bool:
        """Whether the workers span processes (reductions cross the group)."""
        return self.processes > 1

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {"dp": self.dp, "hub": self.hub}


def device_slots(device) -> int:
    """Mesh slots a process offers on ``device``'s kind: its CUDA device
    count for CUDA (1 on one card), 1 for the CPU. The count sets dp, and
    so the job's statistics, as the JAX package's device count does; but
    the fleet lives on one device, so on a host with N cards the N workers
    share the first card until multi-process dp is ported."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_mesh(dp: Optional[int] = None, hub: int = 1, device=None) -> Mesh:
    """A ("dp", "hub") mesh over the process's slots: with ``dp=None`` every
    slot joins dp (after dividing by hub); ``dp * hub`` must not exceed the
    slots. The device is CUDA unless the caller asks for the CPU."""
    device = resolve_device(device, "make_mesh")
    n = device_slots(device)
    if dp is None:
        dp = max(n // hub, 1)
    need = dp * hub
    if need > n:
        raise ValueError(f"mesh ({dp}x{hub}) needs {need} devices, have {n}")
    return Mesh(dp, hub, device)
