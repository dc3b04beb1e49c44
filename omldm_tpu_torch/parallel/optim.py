"""Optimizers in the JAX package's state layouts.

- ``adam_update``: the sequence trainers' Adam, counterpart of
  ``omldm_tpu/parallel/optim.py``: the same bias-corrected update and the
  same ``{"mu", "nu", "count"}`` tree (moments shaped like the parameters,
  an int32 step count), so a JAX optimizer state carries across.
- ``optax_adam_update`` and ``trace_update``: the NN learner's optimizers,
  a copy of the arithmetic of ``optax.adam`` (``scale_by_adam``, then the
  learning rate) and ``optax.sgd`` (``trace``, then the learning rate),
  operation for operation. Their states are optax's, as trees whose leaves
  come in optax's order: ``({"count", "mu", "nu"}, ())`` and
  ``({"trace"}, ())``, the ``()`` standing for optax's leafless
  ``EmptyState``. ``optax.sgd`` builds its trace even at momentum 0.

Step counts stay device tensors: a step never reads them back to the host.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from omldm_tpu_torch.models.transformer import tree_leaves, tree_map, tree_unflatten


def init_adam_state(params: Any) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` and a zero step count."""
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adam_update(params: Any, grads: Any, opt: Dict[str, Any], lr: float,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> Tuple[Any, Dict[str, Any]]:
    """One bias-corrected Adam step; returns new trees, the inputs are left
    as they were. The JAX package's formula and operation order, on all
    leaves at once (``torch._foreach_*``: a few launches, not a few per
    leaf)."""
    count = opt["count"] + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    p, g = tree_leaves(params), tree_leaves(grads)
    mu = torch._foreach_add(torch._foreach_mul(tree_leaves(opt["mu"]), b1),
                            torch._foreach_mul(g, 1.0 - b1))
    nu = torch._foreach_add(torch._foreach_mul(tree_leaves(opt["nu"]), b2),
                            torch._foreach_mul(torch._foreach_mul(g, 1.0 - b2), g))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
    step = torch._foreach_div(torch._foreach_mul(torch._foreach_div(mu, bc1), lr), denom)
    return tree_unflatten(params, torch._foreach_sub(p, step)), {
        "mu": tree_unflatten(params, mu),
        "nu": tree_unflatten(params, nu),
        "count": count,
    }


INT32_MAX = 2 ** 31 - 1


def optax_adam_init(params: Any) -> Tuple[Dict[str, Any], tuple]:
    """``optax.adam(lr).init(params)``: zero moments and a zero int32 count."""
    device = tree_leaves(params)[0].device
    return ({
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
    }, ())


@torch.no_grad()
def optax_adam_update(params: Any, grads: Any, state, lr: float, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8) -> Tuple[Any, tuple]:
    """One ``optax.adam`` step and ``optax.apply_updates``; returns (new
    params, new state), the inputs left as they were."""
    adam, empty = state
    p, g = tree_leaves(params), tree_leaves(grads)
    mu = [(1 - b1) * gi + b1 * m for gi, m in zip(g, tree_leaves(adam["mu"]))]
    nu = [(1 - b2) * (gi * gi) + b2 * v for gi, v in zip(g, tree_leaves(adam["nu"]))]
    count = adam["count"]
    count = torch.where(count < INT32_MAX, count + 1, count)  # safe_increment
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)
    new_p = [
        pi + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
        for pi, m, v in zip(p, mu, nu)
    ]
    return tree_unflatten(params, new_p), ({
        "count": count,
        "mu": tree_unflatten(params, mu),
        "nu": tree_unflatten(params, nu),
    }, empty)


def trace_init(params: Any) -> Tuple[Dict[str, Any], tuple]:
    """``optax.sgd(lr, momentum).init(params)``: a zero trace."""
    return ({"trace": tree_map(torch.zeros_like, params)}, ())


@torch.no_grad()
def trace_update(params: Any, grads: Any, state, lr: float,
                 decay: float) -> Tuple[Any, tuple]:
    """One ``optax.sgd(lr, momentum=decay)`` step and ``apply_updates``."""
    tr, empty = state
    p, g = tree_leaves(params), tree_leaves(grads)
    new_t = [gi + decay * t for gi, t in zip(g, tree_leaves(tr["trace"]))]
    new_p = [pi + (-lr) * t for pi, t in zip(p, new_t)]
    return tree_unflatten(params, new_p), ({"trace": tree_unflatten(params, new_t)}, empty)
