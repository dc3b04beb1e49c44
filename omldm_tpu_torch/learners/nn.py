"""Neural-network learner (``NN``): an MLP trained online with mini-batches.

Counterpart of ``omldm_tpu/learners/nn.py``: the forward pass, its gradient
by ``torch.func.grad_and_value`` (a function transform, so a cohort's
``torch.func.vmap`` over pipelines composes with it), and optax's Adam or SGD arithmetic
(``parallel.optim``). The parameters are ``{"layers": [{"W", "b"}, ...],
"opt": <optimizer state>}``; the flat vector the protocols ship carries the
optimizer state too, in ``ravel_pytree``'s order: every layer's ``W`` and
``b``, then (Adam) the int32 ``count`` as a float, ``mu`` and ``nu``, or
(SGD) the ``trace``.

Data-structure config: ``hiddenLayers`` (list of widths, default [64, 64]),
``nClasses`` (default 2 => single-logit binary head), ``activation``
("relu" | "tanh", default "relu"). Hyper-parameters: ``learningRate``
(default 1e-2), ``optimizer`` ("sgd" | "adam", default "adam"),
``momentum`` (sgd only, default 0.0).

The initial weights are He-scaled normal draws from the caller's
``torch.Generator`` (on the host, so every device gets the same draw). A
multiclass label outside [0, K) gives optax's values: NaN loss past K,
the last class at -1, and a gradient through the normaliser alone.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from omldm_tpu_torch.learners.base import (
    Learner,
    Params,
    class_ids,
    masked_mean,
    take_class,
)
from omldm_tpu_torch.models.transformer import tree_leaves, tree_unflatten
from omldm_tpu_torch.parallel.optim import (
    optax_adam_init,
    optax_adam_update,
    trace_init,
    trace_update,
)


class NeuralNetwork(Learner):
    name = "NN"
    task = "classification"

    def _lr(self) -> float:
        return float(self.hp.get("learningRate", 1e-2))

    def _sgd(self) -> bool:
        return str(self.hp.get("optimizer", "adam")).lower() == "sgd"

    def _opt_init(self, layers):
        return trace_init(layers) if self._sgd() else optax_adam_init(layers)

    def _widths(self, dim: int) -> List[int]:
        hidden = [int(h) for h in self.ds.get("hiddenLayers", [64, 64])]
        n_out = int(self.ds.get("nClasses", 2))
        return [dim] + hidden + [1 if n_out == 2 else n_out]

    def _act(self, h):
        if str(self.ds.get("activation", "relu")) == "tanh":
            return torch.tanh(h)
        return torch.relu(h)

    def init(self, dim: int, generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None) -> Params:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        widths = self._widths(dim)
        layers = []
        for fan_in, fan_out in zip(widths[:-1], widths[1:]):
            w = math.sqrt(2.0 / fan_in) * torch.randn((fan_in, fan_out), generator=generator)
            layers.append({
                "W": w.to(device),
                "b": torch.zeros((fan_out,), dtype=torch.float32, device=device),
            })
        return {"layers": layers, "opt": self._opt_init(layers)}

    def _forward(self, layers, x):
        h = x
        for layer in layers[:-1]:
            h = self._act(h @ layer["W"] + layer["b"])
        return h @ layers[-1]["W"] + layers[-1]["b"]  # logits [B, out]

    def predict(self, params, x):
        logits = self._forward(params["layers"], x)
        if logits.shape[1] == 1:
            return (logits[:, 0] > 0).to(torch.float32)
        return torch.argmax(logits, dim=1).to(torch.float32)

    def _nll(self, layers, x, y, mask):
        logits = self._forward(layers, x)
        if logits.shape[1] == 1:
            # binary: optax.sigmoid_binary_cross_entropy on the single logit
            ys = torch.where(y > 0, 1.0, 0.0)
            z = logits[:, 0]
            nll = (-ys * torch.nn.functional.logsigmoid(z)
                   - (1.0 - ys) * torch.nn.functional.logsigmoid(-z))
        else:
            # optax.softmax_cross_entropy_with_integer_labels
            nll = torch.logsumexp(logits, dim=1) - take_class(logits, class_ids(y))
        return masked_mean(nll, mask)

    def loss(self, params, x, y, mask):
        return self._nll(params["layers"], x, y, mask)

    def update(self, params, x, y, mask, donate=False):
        layers = params["layers"]
        grads, loss = torch.func.grad_and_value(
            lambda live: self._nll(tree_unflatten(layers, live), x, y, mask)
        )(tree_leaves(layers))
        grads = tree_unflatten(layers, grads)
        if self._sgd():
            new_layers, opt = trace_update(layers, grads, params["opt"], self._lr(),
                                           float(self.hp.get("momentum", 0.0)))
        else:
            new_layers, opt = optax_adam_update(layers, grads, params["opt"], self._lr())
        return {"layers": new_layers, "opt": opt}, loss

    def score(self, params, x, y, mask):
        preds = self.predict(params, x)
        if int(self.ds.get("nClasses", 2)) == 2:
            y = torch.where(y > 0, 1.0, 0.0)
        return masked_mean((preds == y).to(torch.float32), mask)

    def merge(self, params_list):
        """Average the network weights; reset the optimizer state (moment
        buffers from different replicas do not average meaningfully)."""
        layers = super().merge([p["layers"] for p in params_list])
        return {"layers": layers, "opt": self._opt_init(layers)}
