"""Trainers: the sequence-model family's ``SeqTrainer`` here, and the SPMD
engine of the streaming job in ``parallel.spmd`` (``SPMDTrainer``, over a
``parallel.mesh.Mesh``; import it from there: it builds on the learners,
which build on ``parallel.optim``)."""

from omldm_tpu_torch.parallel.optim import adam_update, init_adam_state
from omldm_tpu_torch.parallel.seq_trainer import SeqTrainer

__all__ = ["SeqTrainer", "adam_update", "init_adam_state"]
