"""MLPipeline: preprocessors + learner as one training step.

Counterpart of ``omldm_tpu/pipelines/pipeline.py`` (without cohort, guard
or lifecycle attachments). One fit runs, in order: each scaler's statistics
update, the transform with the UPDATED statistics, then the learner update
-- the reference's per-record ``MLPipeline.pipePoint`` order.

A sparse learner's input is the padded-COO pair ``(idx, val)``; the
pipeline moves idx to the device as int32 and refuses preprocessors for it.

The state ``{"preps": [...], "params": {...}, "fitted": int32,
"cum_loss": float32}`` lives on the pipeline's ``torch.device``. A fit
gives the old state up, as the JAX package donates it
(``jax.jit(fit_i, donate_argnums=0)``): the learner may write its new
parameters into the old ones' memory (the sparse learners' scatter does).
So nothing may hold a parameter tensor across a fit; what leaves the
pipeline (``get_flat_params``) is a copy. Losses stay
device tensors until a statistics poll reads them (``curve_slice``), so a
fit never waits for the device. ``on_launch`` is called once per program
the JAX package would launch (fit, fit_many, predict, evaluate), so
``Statistics.programLaunches`` counts the same thing in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec
from omldm_tpu_torch.learners.base import Learner
from omldm_tpu_torch.learners.registry import make_learner
from omldm_tpu_torch.preprocessors.base import Preprocessor
from omldm_tpu_torch.preprocessors.registry import make_preprocessor
from omldm_tpu_torch.utils import batch_valid_counts


def _leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves in ``jax.flatten_util.ravel_pytree`` order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves_iter):
    """The structure of ``tree`` with its leaves replaced from ``leaves_iter``
    (consumed in ``_leaves`` order)."""
    if isinstance(tree, dict):
        rebuilt = {k: _rebuild(tree[k], leaves_iter) for k in sorted(tree)}
        return {k: rebuilt[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves_iter) for v in tree)
    return next(leaves_iter)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def state_from_numpy(tree, device) -> dict:
    """A JAX pipeline state as numpy arrays -> the port's state on ``device``.
    Floating leaves become float32 (JAX keeps them float32 with x64 off)."""

    def to_tensor(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device)

    return _tree_map(to_tensor, tree)


def state_to_numpy(state) -> dict:
    """The port's pipeline state -> numpy arrays (the JAX state's layout)."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), state)


def _as_tensor(a, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Host->device boundary: everything the pipeline computes on is float32
    (numpy float64 would otherwise stay float64 in torch), sparse indices
    int32."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    np_dtype = np.int32 if dtype == torch.int32 else np.float32
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype)).to(device)


def _as_input(x, device: torch.device):
    """A learner input on the device: a dense float32 batch, or a sparse
    learner's padded-COO pair (idx int32, val float32)."""
    if isinstance(x, tuple):
        idx, val = x
        return _as_tensor(idx, device, torch.int32), _as_tensor(val, device)
    return _as_tensor(x, device)


class MLPipeline:
    """One online-ML pipeline: a chain of preprocessors and a learner."""

    def __init__(
        self,
        learner_spec: LearnerSpec,
        preprocessor_specs: Sequence[PreprocessorSpec] = (),
        dim: int = 0,
        generator: Optional[torch.Generator] = None,
        per_record: bool = False,
        device="cpu",
    ):
        self.device = torch.device(device)
        self.learner: Learner = make_learner(learner_spec)
        self.preps: List[Preprocessor] = [
            make_preprocessor(p) for p in preprocessor_specs
        ]
        if getattr(self.learner, "sparse", False) and self.preps:
            raise ValueError(
                "sparse learners consume raw (idx, val) batches; dense "
                "preprocessors cannot apply -- drop preProcessors or use "
                "the dense learner variant"
            )
        self.per_record = per_record
        # called once per program launch this pipeline dispatches; feeds the
        # Statistics `programLaunches` counter
        self.on_launch: Optional[Callable[[], None]] = None
        d = dim
        dims = [d]
        for p in self.preps:
            d = p.out_dim(d)
            dims.append(d)
        self.state = {
            "preps": [p.init(di, self.device) for p, di in zip(self.preps, dims)],
            "params": self.learner.init(d, generator, self.device),
            "fitted": torch.zeros((), dtype=torch.int32, device=self.device),
            "cum_loss": torch.zeros((), dtype=torch.float32, device=self.device),
        }
        # lazy learning curve: (loss tensor, fitted after) per fit, or
        # ([T] loss tensor, [T] fitted) per fit_many; fitted is host-side
        self._curve: List[Tuple[Any, Any]] = []
        self._fitted_host = 0

    # --- the step programs ---

    def _transform(self, prep_states, x):
        for prep, s in zip(self.preps, prep_states):
            x = prep.transform(s, x)
        return x

    def _fit_impl(self, state, x, y, mask):
        new_preps = []
        z = x
        for prep, s in zip(self.preps, state["preps"]):
            s = prep.update(s, z, mask)
            new_preps.append(s)
            z = prep.transform(s, z)
        update = (
            self.learner.update_per_record if self.per_record else self.learner.update
        )
        params, loss = update(state["params"], z, y, mask, donate=True)
        n = mask.sum().to(torch.int32)
        new_state = {
            "preps": new_preps,
            "params": params,
            "fitted": state["fitted"] + n,
            "cum_loss": state["cum_loss"] + loss * n.to(torch.float32),
        }
        return new_state, loss

    # --- public API ---

    def load_state(self, state) -> None:
        """Adopt a whole state (e.g. ``state_from_numpy`` of a JAX state),
        host-side fitted counter included. The pipeline takes it over: a
        later fit may write into its tensors."""
        self.state = state
        self._fitted_host = int(state["fitted"])

    def _count_launch(self) -> None:
        if self.on_launch is not None:
            self.on_launch()

    def fit(self, x, y, mask) -> torch.Tensor:
        """Train on one micro-batch; returns the (lazy) mean loss. ``mask``
        should be host-originated: its valid count feeds the host-side
        fitted counter without a device sync."""
        n = int(np.asarray(mask).sum())
        self._count_launch()
        self.state, loss = self._fit_impl(
            self.state, _as_input(x, self.device), _as_tensor(y, self.device),
            _as_tensor(mask, self.device),
        )
        self._fitted_host += n
        self._curve.append((loss, self._fitted_host))
        return loss

    def fit_many(self, xs, ys, masks, valid_counts=None) -> torch.Tensor:
        """Train on T staged micro-batches ``xs: [T, B, D]``, ``ys/masks:
        [T, B]``; returns the lazy [T] losses. Counted as ONE program launch,
        like the JAX package's single ``lax.scan`` program."""
        counts = batch_valid_counts(masks, valid_counts)
        xs = _as_tensor(xs, self.device)
        ys = _as_tensor(ys, self.device)
        masks = _as_tensor(masks, self.device)
        self._count_launch()
        losses = []
        for t in range(xs.shape[0]):
            self.state, loss = self._fit_impl(self.state, xs[t], ys[t], masks[t])
            losses.append(loss)
        losses = (
            torch.stack(losses) if losses
            else torch.zeros((0,), dtype=torch.float32, device=self.device)
        )
        fitted_after = []
        for c in counts:
            self._fitted_host += c
            fitted_after.append(self._fitted_host)
        self._curve.append((losses, fitted_after))
        return losses

    def predict(self, x) -> torch.Tensor:
        self._count_launch()
        st = self.state
        x = _as_input(x, self.device)
        return self.learner.predict(st["params"], self._transform(st["preps"], x))

    def evaluate(self, x, y, mask) -> Tuple[float, float]:
        """(mean loss, score) on a held-out set, without updating."""
        self._count_launch()
        st = self.state
        z = self._transform(st["preps"], _as_input(x, self.device))
        y = _as_tensor(y, self.device)
        mask = _as_tensor(mask, self.device)
        loss = self.learner.loss(st["params"], z, y, mask)
        score = self.learner.score(st["params"], z, y, mask)
        return float(loss), float(score)

    @property
    def fitted(self) -> int:
        return self._fitted_host

    @property
    def cumulative_loss(self) -> float:
        return float(self.state["cum_loss"])

    def curve_slice(self) -> List[Tuple[float, int]]:
        """Drain the learning-curve points accumulated since the last call.
        The lazy losses come to the host in ONE copy."""
        fresh = self._curve
        self._curve = []
        if not fresh:
            return []
        values = torch.cat([loss.reshape(-1) for loss, _ in fresh]).tolist()
        fitted: List[int] = []
        for _, f in fresh:
            fitted.extend(f if isinstance(f, list) else [f])
        return [(float(l), int(f)) for l, f in zip(values, fitted)]

    def _unravel_fn(self) -> Callable[[np.ndarray], dict]:
        """Inverse of the flattening in :meth:`get_flat_params` for the
        current parameter structure (one host->device copy per call)."""
        params = self.state["params"]
        specs = [(t.shape, t.dtype) for t in _leaves(params)]
        device = self.device

        def unravel(vec) -> dict:
            vec = torch.from_numpy(np.array(vec, dtype=np.float32)).to(device)
            out, pos = [], 0
            for shape, dtype in specs:
                size = int(np.prod(shape, dtype=np.int64))
                out.append(vec[pos : pos + size].reshape(shape).to(dtype))
                pos += size
            return _rebuild(params, iter(out))

        return unravel

    def get_flat_params(self) -> Tuple[np.ndarray, Callable[[np.ndarray], dict]]:
        """Learner params as one float32 vector in ``ravel_pytree`` order
        (hub messages and query responses carry it), plus its inverse. The
        vector is a writable host copy: protocol code mutates shards."""
        leaves = _leaves(self.state["params"])
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
        return np.array(flat.cpu().numpy()), self._unravel_fn()

    def set_flat_params(self, flat: np.ndarray) -> None:
        self.state["params"] = self._unravel_fn()(flat)

    def merge_from(self, others: Sequence["MLPipeline"]) -> None:
        """Merge parallel pipeline copies: learner params and scaler states."""
        self.state["params"] = self.learner.merge(
            [self.state["params"]] + [o.state["params"] for o in others]
        )
        for i, prep in enumerate(self.preps):
            self.state["preps"][i] = prep.merge(
                [self.state["preps"][i]] + [o.state["preps"][i] for o in others]
            )
        self.state["fitted"] = self.state["fitted"] + sum(
            o.state["fitted"] for o in others
        )
        self.state["cum_loss"] = self.state["cum_loss"] + sum(
            o.state["cum_loss"] for o in others
        )
        self._fitted_host += sum(o._fitted_host for o in others)

    def describe(self) -> dict:
        """Learner/preprocessor description for query responses."""
        return {
            "learner": {
                "name": self.learner.name,
                "hyperParameters": self.learner.hp,
                "dataStructure": self.learner.ds,
            },
            "preprocessors": [
                {"name": p.name, "hyperParameters": p.hp} for p in self.preps
            ],
        }
