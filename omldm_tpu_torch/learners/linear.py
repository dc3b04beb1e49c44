"""Linear-model learners. Ported so far: ``PA``, the binary
Passive-Aggressive classifier (Crammer et al. 2006), PA / PA-I / PA-II.

Counterpart of ``omldm_tpu/learners/linear.py``. The intercept is folded
into the weight vector through an appended bias column (``append_bias``).
"""

from __future__ import annotations

from typing import Optional

import torch

from omldm_tpu_torch.learners.base import (
    Learner,
    Params,
    append_bias,
    masked_mean,
    sign_labels,
)
from omldm_tpu_torch.ops.pa_scan import pa_scan_update


def _pa_tau(loss: torch.Tensor, sq_norm: torch.Tensor, variant: str, C: float) -> torch.Tensor:
    """PA step size for the three variants (Crammer et al. 2006, eqs. 4-6)."""
    sq_norm = torch.clamp(sq_norm, min=1e-12)
    if variant == "PA":
        return loss / sq_norm
    if variant == "PA-I":
        return torch.clamp(loss / sq_norm, max=C)
    return loss / (sq_norm + 1.0 / (2.0 * C))


class PAClassifier(Learner):
    """Binary Passive-Aggressive classifier.

    Hyper-parameters: ``C`` (aggressiveness, default 0.01), ``variant`` in
    {"PA", "PA-I", "PA-II"} (default "PA-I"). ``usePallas`` is accepted and
    ignored: the per-record pass always runs the CUDA kernel on a CUDA
    tensor and its plain version on a CPU tensor."""

    name = "PA"
    task = "classification"

    def _C(self) -> float:
        return float(self.hp.get("C", 0.01))

    def _variant(self) -> str:
        return str(self.hp.get("variant", "PA-I"))

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        return {"w": torch.zeros((dim + 1,), dtype=torch.float32, device=device)}

    def predict(self, params, x):
        # + 1e-30: a zero margin predicts +1, as the JAX package does
        # (torch.sign(0) is 0)
        return torch.sign(append_bias(x) @ params["w"] + 1e-30)

    def loss(self, params, x, y, mask):
        hinge = torch.clamp(
            1.0 - sign_labels(y) * (append_bias(x) @ params["w"]), min=0.0
        )
        return masked_mean(hinge, mask)

    def update(self, params, x, y, mask):
        """Mini-batch PA: per-row tau from the shared weights, masked mean of
        the per-row updates applied once."""
        xb = append_bias(x)
        ys = sign_labels(y)
        hinge = torch.clamp(1.0 - ys * (xb @ params["w"]), min=0.0)
        tau = _pa_tau(hinge, (xb * xb).sum(dim=1), self._variant(), self._C())
        coef = tau * ys * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        new_w = params["w"] + (coef @ xb) / denom
        return {"w": new_w}, masked_mean(hinge, mask)

    def update_per_record(self, params, x, y, mask):
        """Exact sequential pass through ``ops.pa_scan``."""
        new_w, loss = pa_scan_update(
            params["w"], append_bias(x).contiguous(), y.contiguous(),
            mask.contiguous(), variant=self._variant(), C=self._C(),
        )
        return {"w": new_w}, loss
