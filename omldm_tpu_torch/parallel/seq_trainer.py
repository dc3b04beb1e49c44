"""SeqTrainer: Adam-trained transformer on one device.

Counterpart of ``omldm_tpu/parallel/seq_trainer.py`` for its single-device
mesh: the same loss, the same Adam and the same parameter and optimizer
trees. Its attention runs the hand-written flash kernels on CUDA (forward,
dQ and dK/dV) and their plain twins on the CPU. A config with
``n_experts > 0`` trains switch-MoE blocks through the ``[E, C, D]``
dispatch buffer (the JAX trainer's expert-parallel block at one shard);
``remat=True`` recomputes each block in the backward pass, so the flash
forward runs twice a layer a step.

``save``/``load`` snapshot ``{params, opt, fitted}`` as a numpy tree
(``parallel.ckpt``): a trainer saved on the card loads on the CPU and the
other way round. Not ported yet: the ("dp", "sp", "tp") mesh and expert
parallelism over devices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from omldm_tpu_torch.models.transformer import (
    TransformerConfig,
    classify_loss,
    init_transformer,
    lm_loss,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_unflatten,
)
from omldm_tpu_torch.parallel.optim import adam_update, init_adam_state
from omldm_tpu_torch.utils import batch_valid_counts
from omldm_tpu_torch.utils.device import resolve_device


class SeqTrainer:
    """Batches arrive as host or device arrays ``tokens/targets/mask: [B, L]``
    (targets and mask pre-shifted for "lm"; ``labels: [B]`` for "classify").
    ``device=None`` means CUDA, and raises without a card."""

    def __init__(self, cfg: TransformerConfig, device=None, lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device, "SeqTrainer")
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        gen = torch.Generator().manual_seed(seed)
        self.params = init_transformer(cfg, gen, self.device)
        self.opt = init_adam_state(self.params)
        self._fitted = 0

    def load_numpy(self, params, opt: Optional[Dict[str, Any]] = None) -> None:
        """Start from a JAX trainer's state: its ``host_params()`` tree and,
        optionally, its optimizer tree ``{"mu", "nu", "count"}`` as numpy."""
        self.params = params_from_numpy(params, self.device)
        if opt is None:
            self.opt = init_adam_state(self.params)
        else:
            self.opt = {
                "mu": params_from_numpy(opt["mu"], self.device),
                "nu": params_from_numpy(opt["nu"], self.device),
                "count": torch.as_tensor(opt["count"], dtype=torch.int32).to(self.device),
            }

    def _as_device(self, a, dtype):
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _loss(self, params, tokens, targets, mask):
        if self.cfg.objective == "lm":
            return lm_loss(self.cfg, params, tokens, targets, mask)
        return classify_loss(self.cfg, params, tokens, targets)

    def _step_impl(self, tokens, targets, mask) -> torch.Tensor:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params)]
        params = tree_unflatten(self.params, leaves)
        loss = self._loss(params, tokens, targets, mask)
        grads = tree_unflatten(self.params, torch.autograd.grad(loss, leaves))
        self.params, self.opt = adam_update(
            tree_unflatten(self.params, [p.detach() for p in leaves]), grads,
            self.opt, self.lr, self.b1, self.b2, self.eps,
        )
        return loss.detach()

    def step(self, tokens, targets, mask=None) -> torch.Tensor:
        """One training step; returns the mean loss as a 0-d device tensor
        (not read back, so the host does not wait for the device)."""
        if mask is None:
            mask = torch.ones(tuple(torch.as_tensor(tokens).shape))
        count = int(torch.as_tensor(mask).sum())
        loss = self._step_impl(
            self._as_device(tokens, torch.long),
            self._as_device(targets, torch.long),
            self._as_device(mask, torch.float32),
        )
        self._fitted += count
        return loss

    def step_many(self, tokens_s, targets_s, masks_s=None, valid_counts=None) -> torch.Tensor:
        """T steps over batches stacked on a leading [T] axis; returns the
        [T] losses. The batches go to the device in one copy each, then a
        loop of steps runs on them without waiting for the device (the JAX
        package runs the loop as one ``lax.scan`` program). Pass
        ``valid_counts`` when ``masks_s`` is on the card."""
        if masks_s is None:
            masks_s = torch.ones(tuple(torch.as_tensor(tokens_s).shape))
        counts = batch_valid_counts(masks_s, valid_counts)
        tokens_s = self._as_device(tokens_s, torch.long)
        targets_s = self._as_device(targets_s, torch.long)
        masks_s = self._as_device(masks_s, torch.float32)
        losses = torch.stack([self._step_impl(t, g, m)
                              for t, g, m in zip(tokens_s, targets_s, masks_s)])
        self._fitted += sum(counts)
        return losses

    @property
    def fitted(self) -> int:
        return self._fitted

    def host_params(self):
        """The parameter tree as numpy arrays."""
        return params_to_numpy(self.params)

    def save(self, directory: str) -> None:
        """Snapshot ``{params, opt, fitted}`` into ``directory`` (the
        trainer-side checkpoint/resume path, SURVEY.md section 7 step 8)."""
        from omldm_tpu_torch.parallel.ckpt import save_trainer_state

        save_trainer_state(self, directory)

    def load(self, directory: str) -> None:
        """Restore a :meth:`save` snapshot onto this trainer's device (the
        same model config)."""
        from omldm_tpu_torch.parallel.ckpt import load_trainer_state

        load_trainer_state(self, directory)
