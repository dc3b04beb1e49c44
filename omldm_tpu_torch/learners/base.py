"""Learner interface: stateless online learners over explicit parameters.

Counterpart of ``omldm_tpu/learners/base.py``. A learner instance holds only
hyper-parameters; its parameters are a dict of tensors passed in and
returned, so the interface stays functional:
``update(params, x, y, mask) -> (params, loss)``. The unit of work is a
fixed-shape micro-batch ``(x[B, D], y[B], mask[B])``; masked-out rows
(padding of ragged batches) contribute nothing to the update or the loss.

- ``update`` is the mini-batch rule;
- ``update_per_record`` is the exact one-record-at-a-time pass, by default a
  Python loop of B=1 updates (the JAX package's ``lax.scan``).

Both leave their input ``params`` as they were, unless the caller passes
``donate=True``: it then gives them up, and a learner may write into them
(the pipeline's fit does, as the JAX package donates its state to every
fit). The sparse learners use that to scatter into ``w`` without a copy;
the others ignore it.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

# A learner's parameters: a dict of tensors.
Params = Any


class Learner:
    #: registry name, matching the reference allowlist
    name: str = ""
    #: "classification" | "regression" | "clustering"
    task: str = "classification"

    def __init__(self, hyper_parameters: Optional[Mapping[str, Any]] = None,
                 data_structure: Optional[Mapping[str, Any]] = None):
        self.hp = dict(hyper_parameters or {})
        self.ds = dict(data_structure or {})

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        raise NotImplementedError

    def predict(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Batched prediction: x[B, D] -> y_hat[B]."""
        raise NotImplementedError

    def update(self, params: Params, x, y, mask,
               donate: bool = False) -> Tuple[Params, torch.Tensor]:
        """Mini-batch update; returns (new_params, mean loss over valid rows)."""
        raise NotImplementedError

    def loss(self, params: Params, x, y, mask) -> torch.Tensor:
        """Mean loss over valid rows without updating."""
        raise NotImplementedError

    def update_per_record(self, params: Params, x, y, mask,
                          donate: bool = False) -> Tuple[Params, torch.Tensor]:
        """Exact per-record pass: the mini-batch rule on B=1 slices, in order."""
        losses = []
        for i in range(x.shape[0]):
            params, loss = self.update(params, x[i : i + 1], y[i : i + 1], mask[i : i + 1],
                                       donate)
            losses.append(loss)
        total = torch.clamp(mask.sum(), min=1.0)
        if not losses:
            return params, torch.zeros((), dtype=torch.float32, device=x.device)
        return params, (torch.stack(losses) * mask).sum() / total

    def score(self, params: Params, x, y, mask) -> torch.Tensor:
        """Accuracy for classification, negative RMSE for regression (higher
        is better for both)."""
        preds = self.predict(params, x)
        if self.task == "classification":
            correct = (preds == sign_labels(y)).to(torch.float32)
            return masked_mean(correct, mask)
        return -torch.sqrt(masked_mean((preds - y) ** 2, mask))

    def merge(self, params_list):
        """Average parameter dicts (the hub's model average)."""
        n = float(len(params_list))
        return {
            k: sum(p[k] for p in params_list) / n for k in params_list[0]
        }


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over rows where mask==1; 0 if no valid rows."""
    total = mask.sum()
    mean = (values * mask).sum() / torch.clamp(total, min=1.0)
    return torch.where(total > 0, mean, torch.zeros_like(mean))


def sign_labels(y: torch.Tensor) -> torch.Tensor:
    """Map {0,1} or {-1,+1} targets to signed labels in {-1,+1}."""
    return torch.where(y > 0, 1.0, -1.0).to(torch.float32)


def append_bias(x: torch.Tensor) -> torch.Tensor:
    """Append a constant-1 column: [B, D] -> [B, D+1] (the intercept is
    folded into the weight vector)."""
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=1)
