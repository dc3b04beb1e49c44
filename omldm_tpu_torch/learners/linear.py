"""Linear-model learners: PA, RegressorPA, ORR, SVM (+RFF), Softmax.

Counterpart of ``omldm_tpu/learners/linear.py``:

- ``PA``: the binary Passive-Aggressive classifier (Crammer et al. 2006),
  PA / PA-I / PA-II; its per-record pass runs the ``pa_scan`` kernel;
- ``RegressorPA``: the epsilon-insensitive PA regressor;
- ``ORR``: online ridge regression over the sufficient statistics
  ``A = lambda*I + sum x x^T``, ``b = sum y x``, solved by Cholesky;
- ``SVM``: pegasos, optionally on random Fourier features;
- ``Softmax``: multiclass logistic regression with SGD.

The intercept is folded into the weight vector through an appended bias
column (``append_bias``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from omldm_tpu_torch.learners.base import (
    Learner,
    Params,
    append_bias,
    class_ids,
    masked_mean,
    one_hot,
    sign,
    sign_labels,
    take_class,
)
from omldm_tpu_torch.ops.pa_scan import pa_scan_op, pa_scan_update


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
        return sign(append_bias(x) @ params["w"] + 1e-30)

    def loss(self, params, x, y, mask):
        hinge = torch.clamp(
            1.0 - sign_labels(y) * (append_bias(x) @ params["w"]), min=0.0
        )
        return masked_mean(hinge, mask)

    def update(self, params, x, y, mask, donate=False):
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

    def update_per_record(self, params, x, y, mask, donate=False):
        """Exact sequential pass through ``ops.pa_scan``. Under
        ``torch.func.vmap`` (a batched operand) it goes through the custom
        op, whose vmap rule makes the pipelines one batched launch; else
        through the wrapper itself, the op's own body: a custom op's first
        call imports ``torch._dynamo``, seconds in a fresh process."""
        args = (params["w"], append_bias(x).contiguous(), y.contiguous(), mask.contiguous())
        batched = any(torch._C._functorch.is_batchedtensor(a) for a in args)
        new_w, loss = (pa_scan_op if batched else pa_scan_update)(
            *args, self._variant(), self._C())
        return {"w": new_w}, loss


class PARegressor(Learner):
    """Epsilon-insensitive Passive-Aggressive regressor (``RegressorPA``).

    Hyper-parameters: ``C`` (default 0.01), ``epsilon`` (default 0.1),
    ``variant`` as in PA."""

    name = "RegressorPA"
    task = "regression"

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        return {"w": torch.zeros((dim + 1,), dtype=torch.float32, device=device)}

    def predict(self, params, x):
        return append_bias(x) @ params["w"]

    def loss(self, params, x, y, mask):
        eps = float(self.hp.get("epsilon", 0.1))
        err = (append_bias(x) @ params["w"] - y).abs()
        return masked_mean(torch.clamp(err - eps, min=0.0), mask)

    def update(self, params, x, y, mask, donate=False):
        C = float(self.hp.get("C", 0.01))
        eps = float(self.hp.get("epsilon", 0.1))
        variant = str(self.hp.get("variant", "PA-I"))
        xb = append_bias(x)
        resid = y - xb @ params["w"]
        loss = torch.clamp(resid.abs() - eps, min=0.0)
        tau = _pa_tau(loss, (xb * xb).sum(dim=1), variant, C)
        coef = tau * sign(resid) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        return {"w": params["w"] + (coef @ xb) / denom}, masked_mean(loss, mask)


class ORR(Learner):
    """Online ridge regression via sufficient statistics.

    Params: ``A[D+1, D+1] = lambda*I + sum_i x_i x_i^T``, ``b[D+1] = sum_i
    y_i x_i``; the batch update is one ``X^T X`` matmul. Prediction solves
    ``A w = b`` by Cholesky (the JAX package's ``solve(assume_a="pos")``).
    ``cholesky_ex`` does not read its info flag back, so a predict never
    waits for the card.

    Hyper-parameters: ``lambda`` (ridge regularizer, default 1.0)."""

    name = "ORR"
    task = "regression"

    def _lambda(self) -> float:
        return float(self.hp.get("lambda", 1.0))

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        d = dim + 1
        return {
            "A": self._lambda() * torch.eye(d, dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device),
        }

    def _solve(self, params):
        chol, _ = torch.linalg.cholesky_ex(params["A"])
        return torch.cholesky_solve(params["b"][:, None], chol)[:, 0]

    def predict(self, params, x):
        return append_bias(x) @ self._solve(params)

    def loss(self, params, x, y, mask):
        return masked_mean((self.predict(params, x) - y) ** 2, mask)

    def update(self, params, x, y, mask, donate=False):
        xb = append_bias(x)
        xm = xb * mask[:, None]
        new_params = {"A": params["A"] + xm.T @ xb, "b": params["b"] + xm.T @ y}
        return new_params, self.loss(new_params, x, y, mask)

    def update_per_record(self, params, x, y, mask, donate=False):
        # the statistics are order-independent: the batched matmul IS the
        # exact per-record result
        return self.update(params, x, y, mask)

    def merge(self, params_list):
        """Sufficient statistics merge by summation (minus the duplicated
        prior), not averaging."""
        A0 = params_list[0]["A"]
        n = len(params_list)
        eye = torch.eye(A0.shape[0], dtype=A0.dtype, device=A0.device)
        return {
            "A": sum(p["A"] for p in params_list) - (n - 1) * self._lambda() * eye,
            "b": sum(p["b"] for p in params_list),
        }


class RFFSVM(Learner):
    """Pegasos SVM, optionally on random-Fourier features (``SVM``).

    Hyper-parameters: ``lambda`` (regularizer, default 1e-4).
    Data-structure: ``rffDim`` (0 = linear SVM; > 0 enables RFF
    z(x) = sqrt(2/D) cos(x W + phi) approximating an RBF kernel with
    bandwidth ``gamma``, default 1.0). The projection is drawn once at init
    from the caller's ``torch.Generator`` (on the host, so every device
    gets the same draw) and is not trained."""

    name = "SVM"
    task = "classification"

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        rff_dim = int(self.ds.get("rffDim", 0))
        params = {"t": torch.ones((), dtype=torch.float32, device=device)}
        if rff_dim > 0:
            gamma = float(self.ds.get("gamma", 1.0))
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            rff_w = torch.randn((dim, rff_dim), generator=generator) * math.sqrt(2.0 * gamma)
            rff_phi = torch.rand((rff_dim,), generator=generator) * (2.0 * math.pi)
            params["rff_w"] = rff_w.to(device)
            params["rff_phi"] = rff_phi.to(device)
            params["w"] = torch.zeros((rff_dim + 1,), dtype=torch.float32, device=device)
        else:
            params["w"] = torch.zeros((dim + 1,), dtype=torch.float32, device=device)
        return params

    def _features(self, params, x):
        if "rff_w" in params:
            d_rff = params["rff_w"].shape[1]
            z = math.sqrt(2.0 / d_rff) * torch.cos(x @ params["rff_w"] + params["rff_phi"])
            return append_bias(z)
        return append_bias(x)

    def predict(self, params, x):
        # + 1e-30: a zero margin predicts +1, as in PA
        return sign(self._features(params, x) @ params["w"] + 1e-30)

    def loss(self, params, x, y, mask):
        z = self._features(params, x)
        hinge = torch.clamp(1.0 - sign_labels(y) * (z @ params["w"]), min=0.0)
        return masked_mean(hinge, mask)

    def update(self, params, x, y, mask, donate=False):
        """Mini-batch pegasos step: eta_t = 1/(lambda*t); w <- (1-eta*lambda)w
        + eta * mean_{violators} y_i z_i."""
        lam = float(self.hp.get("lambda", 1e-4))
        z = self._features(params, x)
        ys = sign_labels(y)
        hinge = torch.clamp(1.0 - ys * (z @ params["w"]), min=0.0)
        viol = (hinge > 0).to(torch.float32) * mask
        t = params["t"]
        eta = 1.0 / (lam * t)
        denom = torch.clamp(mask.sum(), min=1.0)
        grad = -((viol * ys) @ z) / denom
        new_params = dict(params)
        new_params["w"] = (1.0 - eta * lam) * params["w"] - eta * grad
        new_params["t"] = t + 1.0
        return new_params, masked_mean(hinge, mask)


class SoftmaxClassifier(Learner):
    """Multiclass softmax (multinomial logistic) regression with SGD.

    Hyper-parameters: ``learningRate`` (default 0.1), ``nClasses`` (default
    from data_structure, else 2). Targets are integer class ids; a target
    outside [0, K) trains as a zero one-hot row and gives the JAX package's
    loss (NaN past K, the last class at -1)."""

    name = "Softmax"
    task = "classification"

    def _n_classes(self) -> int:
        return int(self.hp.get("nClasses", self.ds.get("nClasses", 2)))

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        return {"W": torch.zeros((dim + 1, self._n_classes()), dtype=torch.float32,
                                 device=device)}

    def _logits(self, params, x):
        return append_bias(x) @ params["W"]

    def predict(self, params, x):
        return torch.argmax(self._logits(params, x), dim=1).to(torch.float32)

    def loss(self, params, x, y, mask):
        logp = torch.log_softmax(self._logits(params, x), dim=1)
        return masked_mean(-take_class(logp, class_ids(y)), mask)

    def update(self, params, x, y, mask, donate=False):
        lr = float(self.hp.get("learningRate", 0.1))
        xb = append_bias(x)
        probs = torch.softmax(xb @ params["W"], dim=1)
        onehot = one_hot(class_ids(y), probs.shape[1])
        denom = torch.clamp(mask.sum(), min=1.0)
        grad = xb.T @ ((probs - onehot) * mask[:, None]) / denom
        return {"W": params["W"] - lr * grad}, self.loss(params, x, y, mask)

    def score(self, params, x, y, mask):
        correct = (self.predict(params, x) == y).to(torch.float32)
        return masked_mean(correct, mask)
