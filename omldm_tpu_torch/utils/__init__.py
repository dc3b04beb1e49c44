"""Small shared utilities."""

from omldm_tpu_torch.utils.counting import batch_valid_counts
from omldm_tpu_torch.utils.device import resolve_device
from omldm_tpu_torch.utils.tracing import StepTimer

__all__ = ["batch_valid_counts", "resolve_device", "StepTimer"]
