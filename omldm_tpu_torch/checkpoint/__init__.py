"""Checkpoint / resume / rescale-merge."""

from omldm_tpu_torch.checkpoint.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
