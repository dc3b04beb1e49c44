"""Learner interface: stateless online learners over explicit parameters.

Counterpart of ``omldm_tpu/learners/base.py``. A learner instance holds only
hyper-parameters; its parameters are a tree of tensors (dicts, lists and
tuples; most learners: one dict) passed in and returned, so the interface
stays functional:
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

from omldm_tpu_torch.models.transformer import tree_leaves, tree_unflatten

# A learner's parameters: a tree (dicts, lists, tuples) of tensors.
Params = Any


class Learner:
    #: registry name, matching the reference allowlist
    name: str = ""
    #: "classification" | "regression" | "clustering"
    task: str = "classification"
    #: True for a learner whose model is a mutable host structure (HT): the
    #: pipeline keeps its state and updates on the host
    host_side: bool = False

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
        """Average parameter trees leaf by leaf (the hub's model average);
        dicts, lists and tuples nest."""
        n = float(len(params_list))
        leaves = zip(*(tree_leaves(p) for p in params_list))
        return tree_unflatten(params_list[0], [sum(ls) / n for ls in leaves])


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over rows where mask==1; 0 if no valid rows."""
    total = mask.sum()
    mean = (values * mask).sum() / torch.clamp(total, min=1.0)
    return torch.where(total > 0, mean, torch.zeros_like(mean))


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: torch.sign, except that a NaN stays NaN (torch.sign
    gives it 0, so a model gone non-finite would answer 0 where the JAX
    package answers NaN)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def sign_labels(y: torch.Tensor) -> torch.Tensor:
    """Map {0,1} or {-1,+1} targets to signed labels in {-1,+1}."""
    return torch.where(y > 0, 1.0, -1.0).to(torch.float32)


def append_bias(x: torch.Tensor) -> torch.Tensor:
    """Append a constant-1 column: [B, D] -> [B, D+1] (the intercept is
    folded into the weight vector)."""
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=1)


# --- class-label helpers --------------------------------------------------
# A stream labelled {-1, +1} reaches the multiclass learners, and so can any
# label outside [0, K). torch's one_hot and gather raise on such labels (on
# the card, a device-side assert that ends the CUDA context), so these build
# the JAX package's values from comparisons and masked selects instead:
# ``jax.nn.one_hot`` gives a zero row, ``jnp.take_along_axis`` wraps
# [-K, -1] and fills NaN beyond, ``.at[i, y].set`` wraps [-K, -1] and drops
# beyond.


def class_ids(y: torch.Tensor) -> torch.Tensor:
    """Float targets as integer class ids, truncated toward zero (JAX's
    ``y.astype(jnp.int32)``)."""
    return y.to(torch.int64)


def one_hot(yi: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """[B, K] one-hot rows; an id outside [0, K) gives a zero row."""
    return (yi[:, None] == torch.arange(k, device=yi.device)).to(dtype)


def _wrapped(yi: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index clamped into [0, K), whether the id named a column): ids in
    [-K, -1] wrap to K + id, as JAX normalises negative indices."""
    idx = torch.where(yi < 0, yi + k, yi)
    valid = (idx >= 0) & (idx < k)
    return idx.clamp(0, k - 1), valid


def take_class(values: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """values[i, yi[i]] with ``jnp.take_along_axis``'s out-of-range rule:
    NaN where the id names no column."""
    idx, valid = _wrapped(yi, values.shape[1])
    taken = values.gather(1, idx[:, None])[:, 0]
    return torch.where(valid, taken, torch.full_like(taken, float("nan")))


def set_class(values: torch.Tensor, yi: torch.Tensor, fill: float) -> torch.Tensor:
    """``values.at[arange(B), yi].set(fill)``: an id that names no column
    leaves its row as it was."""
    idx, valid = _wrapped(yi, values.shape[1])
    hit = one_hot(idx, values.shape[1], torch.bool) & valid[:, None]
    return values.masked_fill(hit, fill)
