"""The three reference preprocessors, streaming-native.

Counterpart of ``omldm_tpu/preprocessors/transforms.py``:

- ``StandardScaler``: running mean/variance via a batched Chan/Welford merge;
- ``MinMaxScaler``: running min/max (+-inf until a feature is seen);
- ``PolynomialFeatures``: degree-2/3 expansion, stateless.
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


class MinMaxScaler(Preprocessor):
    """z = (x - min) / (max - min) with running extrema. A feature not seen
    yet (its extrema still infinite) passes through unscaled."""

    name = "MinMaxScaler"

    def init(self, dim: int, device: Optional[torch.device] = None) -> State:
        return {
            "min": torch.full((dim,), float("inf"), dtype=torch.float32, device=device),
            "max": torch.full((dim,), float("-inf"), dtype=torch.float32, device=device),
        }

    def update(self, state, x, mask):
        valid = mask[:, None] > 0
        big = torch.where(valid, x, float("inf"))
        small = torch.where(valid, x, float("-inf"))
        return {
            "min": torch.minimum(state["min"], big.amin(dim=0)),
            "max": torch.maximum(state["max"], small.amax(dim=0)),
        }

    def transform(self, state, x):
        seen = torch.isfinite(state["min"]) & torch.isfinite(state["max"])
        span = torch.clamp(state["max"] - state["min"], min=1e-12)
        lo = torch.where(seen, state["min"], 0.0)
        scaled = (x - lo) / torch.where(seen, span, 1.0)
        return torch.where(seen, scaled, x)

    def merge(self, states):
        return {
            "min": torch.stack([s["min"] for s in states]).amin(dim=0),
            "max": torch.stack([s["max"] for s in states]).amax(dim=0),
        }


class PolynomialFeatures(Preprocessor):
    """Degree-2 (default) polynomial expansion, stateless.

    Output layout for degree 2: [x, upper triangle of x (x) x, squares
    included, row-major as ``jnp.triu_indices``]; degree 3 appends the
    x_i^3 terms alone (no cubic cross-terms, so the width stays O(d^2)).
    Hyper-parameter: ``degree`` (2 or 3, default 2)."""

    name = "PolynomialFeatures"

    def _degree(self) -> int:
        return int(self.hp.get("degree", 2))

    def out_dim(self, dim: int) -> int:
        out = dim + dim * (dim + 1) // 2
        if self._degree() >= 3:
            out += dim
        return out

    def transform(self, state, x):
        d = x.shape[1]
        iu, ju = torch.triu_indices(d, d, device=x.device)
        # each product is one multiply, as in the JAX package's outer product
        feats = [x, x[:, iu] * x[:, ju]]
        if self._degree() >= 3:
            feats.append(x * (x * x))  # lax.integer_pow's order
        return torch.cat(feats, dim=1)
