"""Multiclass Passive-Aggressive classifier (``MultiClassPA``).

Counterpart of ``omldm_tpu/learners/multiclass_pa.py``: multi-prototype PA
(Crammer et al. 2006 sec. 8), one weight vector per class; on error the
true-class prototype moves toward x and the highest-scoring wrong prototype
moves away, the full tau split across the two.

Labels outside [0, K) take the JAX package's values (``learners.base``'s
class-label helpers): the true score is NaN past K and wraps at -1, and
the rival search masks the wrapped column only. The rival is the first
index among tied scores, as ``jnp.argmax`` picks it.
"""

from __future__ import annotations

from typing import Optional

import torch

from omldm_tpu_torch.learners.base import (
    Learner,
    Params,
    append_bias,
    class_ids,
    masked_mean,
    one_hot,
    set_class,
    take_class,
)
from omldm_tpu_torch.learners.linear import _pa_tau


class MultiClassPA(Learner):
    """Hyper-parameters: ``C`` (default 0.01), ``variant`` in {PA, PA-I,
    PA-II}, ``nClasses`` (default from data_structure, else 3)."""

    name = "MultiClassPA"
    task = "classification"

    def _n_classes(self) -> int:
        return int(self.hp.get("nClasses", self.ds.get("nClasses", 3)))

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        return {"W": torch.zeros((self._n_classes(), dim + 1), dtype=torch.float32,
                                 device=device)}

    def predict(self, params, x):
        scores = append_bias(x) @ params["W"].T
        return torch.argmax(scores, dim=1).to(torch.float32)

    def _hinge(self, params, xb, yi):
        scores = xb @ params["W"].T  # [B, K]
        true_score = take_class(scores, yi)
        masked = set_class(scores, yi, float("-inf"))
        rival_score, rival = torch.max(masked, dim=1)
        # torch.maximum, not clamp: a NaN true score stays NaN, as in JAX
        hinge = torch.maximum(torch.zeros_like(true_score),
                              1.0 - (true_score - rival_score))
        return hinge, rival

    def loss(self, params, x, y, mask):
        hinge, _ = self._hinge(params, append_bias(x), class_ids(y))
        return masked_mean(hinge, mask)

    def update(self, params, x, y, mask, donate=False):
        C = float(self.hp.get("C", 0.01))
        variant = str(self.hp.get("variant", "PA-I"))
        xb = append_bias(x)
        yi = class_ids(y)
        hinge, rival = self._hinge(params, xb, yi)
        # the effective update direction's squared norm is 2*||x||^2 (one
        # prototype moves up, one down)
        tau = _pa_tau(hinge, 2.0 * (xb * xb).sum(dim=1), variant, C)
        coef = tau * mask
        k = params["W"].shape[0]
        up_down = one_hot(yi, k) - one_hot(rival, k)
        denom = torch.clamp(mask.sum(), min=1.0)
        delta = (up_down * coef[:, None]).T @ xb / denom  # [K, D+1]
        return {"W": params["W"] + delta}, masked_mean(hinge, mask)

    def score(self, params, x, y, mask):
        correct = (self.predict(params, x) == y).to(torch.float32)
        return masked_mean(correct, mask)
