"""Streaming feature transforms. Ported so far: ``StandardScaler``.

Counterpart of ``omldm_tpu/preprocessors/transforms.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from omldm_tpu_torch.preprocessors.base import Preprocessor, State


class StandardScaler(Preprocessor):
    """z = (x - mean) / std with running statistics."""

    name = "StandardScaler"

    def init(self, dim: int, device: Optional[torch.device] = None) -> State:
        return {
            "count": torch.zeros((), dtype=torch.float32, device=device),
            "mean": torch.zeros((dim,), dtype=torch.float32, device=device),
            "m2": torch.zeros((dim,), dtype=torch.float32, device=device),
        }

    def update(self, state, x, mask):
        """Chan et al. parallel update: merge the batch's masked moments into
        the running moments."""
        n_b = mask.sum()
        safe_n = torch.clamp(n_b, min=1.0)
        mean_b = (x * mask[:, None]).sum(dim=0) / safe_n
        delta_b = (x - mean_b) * mask[:, None]
        m2_b = (delta_b * delta_b).sum(dim=0)
        n_a, mean_a, m2_a = state["count"], state["mean"], state["m2"]
        n = n_a + n_b
        safe_total = torch.clamp(n, min=1.0)
        delta = mean_b - mean_a
        new_mean = mean_a + delta * (n_b / safe_total)
        new_m2 = m2_a + m2_b + delta * delta * (n_a * n_b / safe_total)
        keep = n_b > 0
        return {
            "count": torch.where(keep, n, n_a),
            "mean": torch.where(keep, new_mean, mean_a),
            "m2": torch.where(keep, new_m2, m2_a),
        }

    def transform(self, state, x):
        count = state["count"]
        var = torch.where(
            count > 1, state["m2"] / torch.clamp(count - 1, min=1.0), 1.0
        )
        std = torch.sqrt(torch.clamp(var, min=1e-12))
        return torch.where(count > 0, (x - state["mean"]) / std, x)

    def merge(self, states):
        out = states[0]
        for s in states[1:]:
            n_a, n_b = out["count"], s["count"]
            n = n_a + n_b
            safe = torch.clamp(n, min=1.0)
            delta = s["mean"] - out["mean"]
            out = {
                "count": n,
                "mean": out["mean"] + delta * (n_b / safe),
                "m2": out["m2"] + s["m2"] + delta * delta * (n_a * n_b / safe),
            }
        return out
