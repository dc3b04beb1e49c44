"""Online K-means clustering (``K-means``).

Counterpart of ``omldm_tpu/learners/kmeans.py``: mini-batch k-means
(Sculley 2010) -- one batched distance matrix ``[B, K]``, per-centroid
masked means, per-centroid learning rate batch_n / total_n. The reference
forces the ``SingleLearner`` protocol for it (one model, on the hub).

The initial centroids are a draw from the caller's ``torch.Generator``
(on the host, so every device gets the same draw); the JAX package draws
them with ``jax.random``, so a comparison loads its draw. The assignment
is the first index among tied distances, as ``jnp.argmin`` picks it.
"""

from __future__ import annotations

from typing import Optional

import torch

from omldm_tpu_torch.learners.base import Learner, Params, masked_mean, one_hot


class KMeans(Learner):
    """Hyper-parameters: ``k`` (default 2), ``initScale`` (random init spread,
    default 1.0)."""

    name = "K-means"
    task = "clustering"

    def _k(self) -> int:
        return int(self.hp.get("k", self.ds.get("k", 2)))

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        scale = float(self.hp.get("initScale", 1.0))
        centroids = scale * torch.randn((self._k(), dim), generator=generator)
        return {
            "centroids": centroids.to(device),
            "counts": torch.zeros((self._k(),), dtype=torch.float32, device=device),
        }

    def _dists(self, params, x):
        # [B, K] squared distances via one matmul: |x|^2 - 2 x.c + |c|^2
        c = params["centroids"]
        return (
            (x * x).sum(dim=1, keepdim=True)
            - 2.0 * x @ c.T
            + (c * c).sum(dim=1)[None, :]
        )

    def predict(self, params, x):
        return torch.argmin(self._dists(params, x), dim=1).to(torch.float32)

    def loss(self, params, x, y, mask):
        """Mean squared distance to the assigned centroid (inertia)."""
        return masked_mean(self._dists(params, x).min(dim=1).values, mask)

    def update(self, params, x, y, mask, donate=False):
        d = self._dists(params, x)
        centroids = params["centroids"]
        onehot = one_hot(torch.argmin(d, dim=1), centroids.shape[0]) * mask[:, None]
        batch_counts = onehot.sum(dim=0)  # [K]
        new_counts = params["counts"] + batch_counts
        batch_mean = (onehot.T @ x) / torch.clamp(batch_counts, min=1.0)[:, None]
        lr = (batch_counts / torch.clamp(new_counts, min=1.0))[:, None]
        moved = centroids + lr * (batch_mean - centroids)
        new_centroids = torch.where(batch_counts[:, None] > 0, moved, centroids)
        new_params = {"centroids": new_centroids, "counts": new_counts}
        return new_params, self.loss(params, x, y, mask)

    def score(self, params, x, y, mask):
        """Negative RMS distance to the assigned centroid (higher is better)."""
        return -torch.sqrt(torch.clamp(self.loss(params, x, y, mask), min=0.0))

    def merge(self, params_list):
        """Count-weighted centroid average."""
        counts = [p["counts"] for p in params_list]
        total = sum(counts)
        weighted = sum(
            p["centroids"] * torch.clamp(c, min=0.0)[:, None]
            for p, c in zip(params_list, counts)
        )
        safe_total = torch.clamp(total, min=1.0)[:, None]
        base = params_list[0]["centroids"]
        merged = torch.where(total[:, None] > 0, weighted / safe_total, base)
        return {"centroids": merged, "counts": total}
