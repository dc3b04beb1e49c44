"""Host-side stream runtime (spokes, hubs, control plane, statistics)."""

from omldm_tpu_torch.runtime.job import StreamJob

__all__ = ["StreamJob"]
