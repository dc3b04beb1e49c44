"""Sparse-input linear learners: padded-COO batches over a dense device model.

Counterpart of ``omldm_tpu/learners/sparse_linear.py``. The sparse variants
are selected by ``dataStructure: {"sparse": true, "nFeatures": D}`` on the
standard learner names (registry.make_learner); the learner's ``x`` is the
pair ``(idx[B, K] int32, val[B, K] float32)`` instead of a dense ``[B, D]``.

The weights stay dense on the device (``w[D+1]``, the bias row at index D);
each record's forward is a K-row gather-dot and each update one scatter-add
(ops/sparse.py: the CUDA kernel on the card), into ``w`` itself when the
caller donates the parameters (the pipeline's fit). The SPMD engine
updates its dp workers at once (``fleet_update``): one scatter for all of
them. Update rules, hyper-parameters, and loss/score semantics are the JAX
package's.
"""

from __future__ import annotations

from typing import Optional

import torch

from omldm_tpu_torch.learners.base import Learner, Params, masked_mean, sign, sign_labels
from omldm_tpu_torch.learners.linear import _pa_tau
from omldm_tpu_torch.ops.sparse import (
    append_bias_sparse,
    sparse_matmat,
    sparse_matvec,
    sparse_scatter_add_auto,
    sparse_scatter_add_outer,
    sparse_sq_norm,
)


def _signs(margins: torch.Tensor) -> torch.Tensor:
    """+1 where the margin is >= 0, else -1 (as the JAX package predicts)."""
    return torch.where(margins >= 0, 1.0, -1.0).to(torch.float32)


class SparseLinear(Learner):
    """Shared plumbing: dense ``w[D+1]`` (bias row at index D), sparse x."""

    sparse = True
    #: the parameter leaf the update scatters into
    weight_key = "w"

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        return {"w": torch.zeros((dim + 1,), dtype=torch.float32, device=device)}

    def _margins(self, params, x):
        idx, val = append_bias_sparse(*x, params["w"].shape[0] - 1)
        return sparse_matvec(params["w"], idx, val), (idx, val)

    def _scatter(self, w, idx, coef, val, inplace):
        """Scatter dispatch, into ``w`` itself with ``inplace``;
        ``dataStructure.scatterImpl`` pins a formulation per pipeline (see
        ops/sparse._resolve_impl)."""
        return sparse_scatter_add_auto(
            w, idx, coef, val, impl=self.ds.get("scatterImpl"), inplace=inplace
        )

    def _update_terms(self, params, x, y, mask):
        """One mini-batch update up to its scatter: ``(params, idx, coef,
        val, loss, fresh)``. ``params`` holds the new leaves, the weight leaf
        (``weight_key``) as it stands before the scatter; ``fresh`` says that
        leaf is a new tensor the update owns, which the scatter may write
        into whatever the caller donated."""
        raise NotImplementedError

    def update(self, params, x, y, mask, donate=False):
        params, idx, coef, val, loss, fresh = self._update_terms(params, x, y, mask)
        key = self.weight_key
        params[key] = self._scatter(params[key], idx, coef, val, donate or fresh)
        return params, loss

    def fleet_update(self, params, x, y, mask):
        """The mini-batch update of dp workers at once, their scatters in ONE
        launch. ``params`` leaves are ``[dp, ...]`` and given up, as to
        :meth:`update` with ``donate``; ``x`` is ``(idx, val)`` of shape
        ``[dp, B, K]``, ``y`` and ``mask`` ``[dp, B]``. Returns the new
        ``[dp, ...]`` leaves and the ``[dp]`` losses.

        Each worker's terms come from its own rows, as in :meth:`update`.
        The dp weight leaves are then one ``[dp * R, ...]`` tensor, and
        worker i's indices are offset by ``i * R``. Every index lies in
        [0, R): the features inside the model's width (the control gate's
        ``validate_sparse`` keeps ``hashSpace`` inside ``nFeatures``) and
        the bias at R - 1. So no worker's update lands in another's rows,
        and the one scatter equals dp scatters."""
        key = self.weight_key
        dp = y.shape[0]
        rows_of = [{k: v[i] for k, v in params.items()} for i in range(dp)]
        terms = [
            self._update_terms(rows_of[i], (x[0][i], x[1][i]), y[i], mask[i])
            for i in range(dp)
        ]
        weights = params[key]
        if any(t[0][key] is not r[key] for t, r in zip(terms, rows_of)):
            weights = torch.stack([t[0][key] for t in terms])
        weights = weights.contiguous()
        rows = weights.shape[1]
        idx = torch.cat([t[1] + i * rows for i, t in enumerate(terms)])
        coef = torch.cat([t[2] for t in terms])
        val = torch.cat([t[3] for t in terms])
        self._scatter(weights.view(dp * rows, *weights.shape[2:]), idx, coef, val, True)
        new = {k: torch.stack([t[0][k] for t in terms]) for k in params if k != key}
        new[key] = weights
        return new, torch.stack([t[4] for t in terms])

    def update_per_record(self, params, x, y, mask, donate=False):
        """Exact per-record pass: the mini-batch rule on B=1 slices of each
        leaf of the COO pair, in order. Undonated, the first slice copies
        ``w`` and the others write into that copy."""
        idx, val = x
        losses = []
        for i in range(idx.shape[0]):
            params, loss = self.update(
                params, (idx[i : i + 1], val[i : i + 1]), y[i : i + 1], mask[i : i + 1],
                donate=donate or i > 0,
            )
            losses.append(loss)
        if not losses:
            return params, torch.zeros((), dtype=torch.float32, device=idx.device)
        total = torch.clamp(mask.sum(), min=1.0)
        return params, (torch.stack(losses) * mask).sum() / total


class SparsePAClassifier(SparseLinear):
    """Passive-Aggressive classifier on sparse inputs (PA / PA-I / PA-II)."""

    name = "PA"
    task = "classification"

    def predict(self, params, x):
        margins, _ = self._margins(params, x)
        return _signs(margins)

    def loss(self, params, x, y, mask):
        margins, _ = self._margins(params, x)
        hinge = torch.clamp(1.0 - sign_labels(y) * margins, min=0.0)
        return masked_mean(hinge, mask)

    def _update_terms(self, params, x, y, mask):
        variant = str(self.hp.get("variant", "PA-I"))
        C = float(self.hp.get("C", 0.01))
        margins, (idx, val) = self._margins(params, x)
        ys = sign_labels(y)
        hinge = torch.clamp(1.0 - ys * margins, min=0.0)
        tau = _pa_tau(hinge, sparse_sq_norm(val), variant, C)
        denom = torch.clamp(mask.sum(), min=1.0)
        coef = tau * ys * mask / denom
        return {"w": params["w"]}, idx, coef, val, masked_mean(hinge, mask), False


class SparsePARegressor(SparseLinear):
    """Epsilon-insensitive PA regressor on sparse inputs (RegressorPA)."""

    name = "RegressorPA"
    task = "regression"

    def predict(self, params, x):
        margins, _ = self._margins(params, x)
        return margins

    def loss(self, params, x, y, mask):
        eps = float(self.hp.get("epsilon", 0.1))
        margins, _ = self._margins(params, x)
        return masked_mean(torch.clamp((margins - y).abs() - eps, min=0.0), mask)

    def _update_terms(self, params, x, y, mask):
        variant = str(self.hp.get("variant", "PA-I"))
        C = float(self.hp.get("C", 0.01))
        eps = float(self.hp.get("epsilon", 0.1))
        margins, (idx, val) = self._margins(params, x)
        err = margins - y
        loss = torch.clamp(err.abs() - eps, min=0.0)
        tau = _pa_tau(loss, sparse_sq_norm(val), variant, C)
        denom = torch.clamp(mask.sum(), min=1.0)
        coef = -sign(err) * tau * mask / denom
        return {"w": params["w"]}, idx, coef, val, masked_mean(loss, mask), False


class SparseSVM(SparseLinear):
    """Pegasos SVM on raw sparse features (the standard linear pegasos on
    the hashed space; the dense twin's random Fourier features densify)."""

    name = "SVM"
    task = "classification"

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        return {
            "w": torch.zeros((dim + 1,), dtype=torch.float32, device=device),
            "t": torch.ones((), dtype=torch.float32, device=device),
        }

    def predict(self, params, x):
        margins, _ = self._margins(params, x)
        return _signs(margins)

    def loss(self, params, x, y, mask):
        margins, _ = self._margins(params, x)
        hinge = torch.clamp(1.0 - sign_labels(y) * margins, min=0.0)
        return masked_mean(hinge, mask)

    def _update_terms(self, params, x, y, mask):
        """Mini-batch pegasos: eta = 1/(lambda*t); w <- (1-eta*lambda)w +
        eta * mean_violators(y x). The decay is the only O(D) op."""
        lam = float(self.hp.get("lambda", 1e-4))
        margins, (idx, val) = self._margins(params, x)
        ys = sign_labels(y)
        hinge = torch.clamp(1.0 - ys * margins, min=0.0)
        viol = (hinge > 0).to(torch.float32) * mask
        eta = 1.0 / (lam * params["t"])
        denom = torch.clamp(mask.sum(), min=1.0)
        w = params["w"] * (1.0 - eta * lam)  # a new tensor: scatter into it
        new = {"w": w, "t": params["t"] + 1.0}
        return new, idx, eta * ys * viol / denom, val, masked_mean(hinge, mask), True


class SparseSoftmax(SparseLinear):
    """Multiclass softmax regression with SGD on sparse inputs (the JAX
    package's BASELINE config 5 at Avazu's hashed width)."""

    name = "Softmax"
    task = "classification"
    weight_key = "W"

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        k = int(self.hp.get("nClasses", 2))
        return {"W": torch.zeros((dim + 1, k), dtype=torch.float32, device=device)}

    def _logits(self, params, x):
        idx, val = append_bias_sparse(*x, params["W"].shape[0] - 1)
        return sparse_matmat(params["W"], idx, val), (idx, val)

    def _classes(self, y, k):
        return torch.clamp(y.to(torch.int64), 0, k - 1)

    def predict(self, params, x):
        logits, _ = self._logits(params, x)
        cls = torch.argmax(logits, dim=1).to(torch.float32)
        # binary models report signed labels like the other classifiers
        return cls * 2.0 - 1.0 if params["W"].shape[1] == 2 else cls

    def _xent(self, logits, y):
        yi = self._classes(y, logits.shape[1])
        logp = torch.log_softmax(logits, dim=1)
        return -logp.gather(1, yi[:, None])[:, 0]

    def loss(self, params, x, y, mask):
        logits, _ = self._logits(params, x)
        return masked_mean(self._xent(logits, y), mask)

    def _scatter(self, W, idx, coef, val, inplace):
        return sparse_scatter_add_outer(W, idx, coef, val, inplace=inplace)

    def _update_terms(self, params, x, y, mask):
        lr = float(self.hp.get("learningRate", 0.05))
        logits, (idx, val) = self._logits(params, x)
        k = logits.shape[1]
        probs = torch.softmax(logits, dim=1)
        grad = probs - torch.nn.functional.one_hot(self._classes(y, k), k).to(probs.dtype)
        denom = torch.clamp(mask.sum(), min=1.0)
        coef = -lr * grad * (mask / denom)[:, None]
        loss = masked_mean(self._xent(logits, y), mask)
        return {"W": params["W"]}, idx, coef, val, loss, False

    def score(self, params, x, y, mask):
        logits, _ = self._logits(params, x)
        yi = self._classes(y, logits.shape[1])
        correct = (torch.argmax(logits, dim=1) == yi).to(torch.float32)
        return masked_mean(correct, mask)


SPARSE_LEARNERS = {
    "PA": SparsePAClassifier,
    "RegressorPA": SparsePARegressor,
    "SVM": SparseSVM,
    "Softmax": SparseSoftmax,
}
