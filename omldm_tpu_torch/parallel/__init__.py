"""Trainers and optimizers of the sequence-model family (single device)."""

from omldm_tpu_torch.parallel.optim import adam_update, init_adam_state
from omldm_tpu_torch.parallel.seq_trainer import SeqTrainer

__all__ = ["SeqTrainer", "adam_update", "init_adam_state"]
