"""Adam for the sequence trainers, in the JAX package's state layout.

Counterpart of ``omldm_tpu/parallel/optim.py``: the same bias-corrected
update and the same ``{"mu", "nu", "count"}`` tree (moments shaped like the
parameters, an int32 step count), so a JAX optimizer state carries across.
The count stays a device tensor: the step never reads it back to the host.
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
