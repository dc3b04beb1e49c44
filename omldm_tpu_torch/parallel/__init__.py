"""Trainers: the sequence-model family's ``SeqTrainer`` (one device, or a
``("dp", "sp", "tp")`` mesh of processes: ``make_seq_mesh``) here, and the
SPMD engine of the streaming job in ``parallel.spmd`` (``SPMDTrainer``,
over a ``parallel.mesh.Mesh``; import it from there: it builds on the
learners, which build on ``parallel.optim``).

The names load on first use: the model imports this package's collectives
(``parallel.multihost``), and the trainer imports the model."""

__all__ = ["SeqTrainer", "make_seq_mesh", "adam_update", "init_adam_state"]


def __getattr__(name):
    if name in ("adam_update", "init_adam_state"):
        from omldm_tpu_torch.parallel import optim

        return getattr(optim, name)
    if name in ("SeqTrainer", "make_seq_mesh"):
        from omldm_tpu_torch.parallel import seq_trainer

        return getattr(seq_trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
