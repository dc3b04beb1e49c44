"""MLPipeline: preprocessors + learner as one training step.

Counterpart of ``omldm_tpu/pipelines/pipeline.py``. One fit runs, in
order: each scaler's statistics update, the transform with the UPDATED
statistics, then the learner update -- the reference's per-record
``MLPipeline.pipePoint`` order. ``version`` is the model-lifecycle plane's
tag of the model version the pipeline holds.

A sparse learner's input is the padded-COO pair ``(idx, val)``; the
pipeline moves idx to the device as int32 and refuses preprocessors for it.

The state ``{"preps": [...], "params": {...}, "fitted": int32,
"cum_loss": float32}`` lives on the pipeline's ``torch.device``: CUDA
unless the caller asks for the CPU (without a card, CUDA raises). A fit
gives the old state up, as the JAX package donates it
(``jax.jit(fit_i, donate_argnums=0)``): the learner may write its new
parameters into the old ones' memory (the sparse learners' scatter does).
So nothing may hold a parameter tensor across a fit; what leaves the
pipeline (``get_flat_params``) is a copy. Losses stay
device tensors until a statistics poll reads them (``curve_slice``), so a
fit never waits for the device. ``on_launch`` is called once per program
the JAX package would launch (fit, fit_many, predict, evaluate), so
``Statistics.programLaunches`` counts the same thing in both packages.

A pipeline attached to a cohort (``runtime.cohort``, the multi-tenant
gang engine) hands its state to the cohort's stacked ``[C, ...]`` tree:
``fit``/``fit_many`` stage their batches for the cohort's next gang launch
and return a lazy loss, ``predict`` and ``evaluate`` read the member's
state after the pending launch, ``state`` reads and writes go through the
cohort's checkout, and the flat parameters are the member's row of the
cohort's one-launch ``[C, P]`` flat matrix. ``cache_key`` (the JAX key's
fields) decides which pipelines may share a cohort.

A host-side learner (HT: ``Learner.host_side``) keeps the whole state on
the host whatever the pipeline's device, as the JAX package runs it
un-jitted: its tree is a Python structure, and its preprocessors' states
stay CPU tensors. Its ``fit_many`` is a loop of fits, each counted as a
launch, as in the JAX package.

A pipeline built with ``guard`` (``trainingConfiguration.guard``, parsed
by ``guard.guard_config``) and a learner that is not host-side carries a
``ModelGuard``: each fit and ``fit_many`` ends with the squared norm of
the new parameters' float leaves (:func:`param_health`), a 0-d tensor on
the pipeline's device handed to ``ModelGuard.note`` unread. The JAX package
fuses it into the fit's program; here it is one more kernel a float leaf
(a ``dot``) and one add a leaf past the first, and the fit still counts as
one program launch. ``cache_key``'s last field says whether the pipeline
is guarded, so guarded and unguarded pipelines never share a cohort.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec
from omldm_tpu_torch.guard import GuardConfig, ModelGuard
from omldm_tpu_torch.learners.base import Learner
from omldm_tpu_torch.learners.registry import make_learner
from omldm_tpu_torch.preprocessors.base import Preprocessor
from omldm_tpu_torch.preprocessors.registry import make_preprocessor
from omldm_tpu_torch.utils import batch_valid_counts, resolve_device


def _freeze(obj):
    """Recursively hashable form of hyper-parameter structures."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


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
    """``fn`` over the leaves of a state tree. A NamedTuple (optax's
    ``ScaleByAdamState``, ``TraceState``, ``EmptyState``) maps to the
    port's layout for it: a dict of its fields, ``()`` when it has none.
    Sorted keys give ``_leaves``' order, so the fields must already come
    in sorted order for the leaf order to survive (optax's do)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    if isinstance(tree, tuple) and fields is not None:
        if list(fields) != sorted(fields):
            raise ValueError(f"{type(tree).__name__} fields {fields} are not in sorted order")
        return {f: _tree_map(fn, getattr(tree, f)) for f in fields} if fields else ()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def state_from_numpy(tree, device) -> dict:
    """A JAX pipeline state as numpy arrays -> the port's state on ``device``.
    Floating leaves become float32 (JAX keeps them float32 with x64 off);
    an NN's optax state takes the port's layout (``_tree_map``)."""

    def to_tensor(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device)

    return _tree_map(to_tensor, tree)


def fleet_state_from_numpy(tree, trainer) -> dict:
    """A JAX ``SPMDTrainer`` state as numpy arrays (``jax.device_get``;
    leaves ``[dp, hub, ...]``) -> the port's fleet state, leaves ``[dp,
    ...]`` on ``trainer``'s device: hub slot 0 is kept (the hub shards of a
    worker hold the same values), an NN's optax state takes the port's
    layout as in :func:`state_from_numpy`. A process of a fleet keeps its
    own rows of the ``dp`` workers, ``[dp_local, ...]``. Load it with
    ``trainer.load_state``."""
    dp, local = trainer.dp, trainer.dp_local
    lo = trainer.mesh.process_id * local

    def to_tensor(a):
        a = np.asarray(a)
        if a.shape[:1] != (dp,) or a.ndim < 2:
            raise ValueError(f"fleet leaf of shape {a.shape} is not [dp={dp}, hub, ...]")
        a = a[lo : lo + local, 0]
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(trainer.device)

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


def unravel_fn(params, device) -> Callable[[np.ndarray], dict]:
    """The inverse of flattening ``params`` (a tree shaped like one
    pipeline's parameters) in ``ravel_pytree`` order: a float32 vector ->
    a new tree on ``device``, each leaf cast back to its dtype."""
    specs = [(t.shape, t.dtype) for t in _leaves(params)]

    def unravel(vec) -> dict:
        vec = torch.from_numpy(np.array(vec, dtype=np.float32)).to(device)
        out, pos = [], 0
        for shape, dtype in specs:
            size = int(np.prod(shape, dtype=np.int64))
            out.append(vec[pos : pos + size].reshape(shape).to(dtype))
            pos += size
        return _rebuild(params, iter(out))

    return unravel


def param_health(params) -> torch.Tensor:
    """The squared L2 norm over the float leaves of ``params``, as a 0-d
    tensor: non-finite whenever any parameter is, so this one number
    carries both of the guard's signals (non-finite state, exploding norm).
    Integer leaves are skipped: corruption is a float phenomenon."""
    sq = None
    for leaf in _leaves(params):
        if not leaf.is_floating_point():
            continue
        flat = leaf.reshape(-1).to(torch.float32)
        term = torch.dot(flat, flat)
        sq = term if sq is None else sq + term
    return sq


class MLPipeline:
    """One online-ML pipeline: a chain of preprocessors and a learner."""

    def __init__(
        self,
        learner_spec: LearnerSpec,
        preprocessor_specs: Sequence[PreprocessorSpec] = (),
        dim: int = 0,
        generator: Optional[torch.Generator] = None,
        per_record: bool = False,
        device=None,
        guard: Optional[GuardConfig] = None,
    ):
        self.learner: Learner = make_learner(learner_spec)
        self.device = (torch.device("cpu") if self.learner.host_side
                       else resolve_device(device, "MLPipeline"))
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
        # the model-lifecycle plane's version tag (runtime/lifecycle.py): 0
        # is the Create-time model; the registry stamps a candidate with its
        # row id, which follows the pipeline through promotion and rollback.
        # Nothing in the pipeline's math reads it
        self.version = 0
        # the model-integrity guard (None: unarmed, and always for a
        # host-side learner, whose state the host already sees)
        self.guard: Optional[ModelGuard] = (
            ModelGuard(guard) if guard is not None and not self.learner.host_side else None
        )
        d = dim
        dims = [d]
        for p in self.preps:
            d = p.out_dim(d)
            dims.append(d)
        # cohort co-hosting (runtime.cohort): while attached, the cohort
        # owns the state (stacked with its same-spec siblings) and `_state`
        # is None; detached, `_state` is the state
        self._cohort = None
        self._slot = -1
        # pipelines with equal keys run the same step program, so they may
        # share a cohort (the JAX key, its last field whether it is guarded)
        self.cache_key = None if self.learner.host_side else (
            type(self.learner).__name__,
            _freeze(self.learner.hp),
            _freeze(self.learner.ds),
            tuple((type(p).__name__, _freeze(p.hp)) for p in self.preps),
            dim,
            per_record,
            self.guard is not None,
        )
        self._state = {
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
        if self.learner.host_side:
            loss = torch.as_tensor(loss, dtype=torch.float32)
        n = mask.sum().to(torch.int32)
        new_state = {
            "preps": new_preps,
            "params": params,
            "fitted": state["fitted"] + n,
            "cum_loss": state["cum_loss"] + loss * n.to(torch.float32),
        }
        return new_state, loss

    # --- public API ---

    @property
    def state(self):
        """The state tree. Detached: the pipeline's own. Attached to a
        cohort: the member's checked-out state -- the SAME dict until the
        next gang launch writes it back, so in-place edits (merge_from, a
        SingleLearner hub's model swap) land in the stacked tree."""
        if self._cohort is not None:
            return self._cohort.checkout(self._slot)
        return self._state

    @state.setter
    def state(self, value) -> None:
        if self._cohort is not None:
            self._cohort.set_member_state(self._slot, value)
        else:
            self._state = value

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
        if self._cohort is not None:
            # a guarded member's health comes from the gang launch
            loss = self._cohort.stage_fit(self._slot, x, y, mask)
        else:
            self._count_launch()
            self._state, loss = self._fit_impl(
                self._state, _as_input(x, self.device), _as_tensor(y, self.device),
                _as_tensor(mask, self.device),
            )
            if self.guard is not None:
                self.guard.note(param_health(self._state["params"]))
        self._fitted_host += n
        self._curve.append((loss, self._fitted_host))
        return loss

    def fit_many(self, xs, ys, masks, valid_counts=None) -> torch.Tensor:
        """Train on T staged micro-batches ``xs: [T, B, D]``, ``ys/masks:
        [T, B]``; returns the lazy [T] losses. Counted as ONE program launch,
        like the JAX package's single ``lax.scan`` program."""
        if self.learner.host_side:
            return torch.stack([self.fit(x, y, m) for x, y, m in zip(xs, ys, masks)])
        counts = batch_valid_counts(masks, valid_counts)
        if self._cohort is not None:
            losses = self._cohort.stage_fit_many(self._slot, xs, ys, masks)
        else:
            losses = self._fit_many_solo(xs, ys, masks)
        fitted_after = []
        for c in counts:
            self._fitted_host += c
            fitted_after.append(self._fitted_host)
        self._curve.append((losses, fitted_after))
        return losses

    def _fit_many_solo(self, xs, ys, masks) -> torch.Tensor:
        xs = _as_tensor(xs, self.device)
        ys = _as_tensor(ys, self.device)
        masks = _as_tensor(masks, self.device)
        self._count_launch()
        losses = []
        for t in range(xs.shape[0]):
            self._state, loss = self._fit_impl(self._state, xs[t], ys[t], masks[t])
            losses.append(loss)
        if not losses:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        if self.guard is not None:
            # the final state's health covers the chain: NaN sticks, and an
            # exploded norm does not shrink back
            self.guard.note(param_health(self._state["params"]), fits=len(losses))
        return torch.stack(losses)

    def _read_state(self):
        """The state a predict or evaluate reads: a cohort member's after
        its pending gang launch."""
        if self._cohort is not None:
            return self._cohort.peek_state(self._slot)
        return self._state

    def predict(self, x) -> torch.Tensor:
        st = self._read_state()
        self._count_launch()
        x = _as_input(x, self.device)
        preds = self.learner.predict(st["params"], self._transform(st["preps"], x))
        return torch.as_tensor(preds)  # a host-side learner answers in numpy

    def evaluate(self, x, y, mask) -> Tuple[float, float]:
        """(mean loss, score) on a held-out set, without updating."""
        st = self._read_state()
        self._count_launch()
        z = self._transform(st["preps"], _as_input(x, self.device))
        y = _as_tensor(y, self.device)
        mask = _as_tensor(mask, self.device)
        loss = self.learner.loss(st["params"], z, y, mask)
        score = self.learner.score(st["params"], z, y, mask)
        return float(loss), float(score)

    def settle_deferred(self) -> None:
        """Run this member's deferred post-launch protocol action now (it
        forces the pending gang launch). Blocking protocol workers call
        this before their ``waiting`` check, so a deferred sync point that
        sets ``waiting`` shows where the undeferred path would set it."""
        if self._cohort is not None and self._cohort.has_deferred(self._slot):
            self._cohort.launch()

    def defer_after_launch(self, cb: Callable[[], None]) -> bool:
        """Cohort hook for protocol sync points: with a staged gang fit
        pending, run ``cb`` right after the gang launch instead of now
        (which would force a launch for this member alone). Returns False
        -- act now -- when detached or nothing is staged."""
        if self._cohort is not None and self._cohort.has_staged(self._slot):
            self._cohort.after_launch(self._slot, cb)
            return True
        return False

    @property
    def fitted(self) -> int:
        return self._fitted_host

    @property
    def cumulative_loss(self) -> float:
        if self._cohort is not None:
            return self._cohort.member_cum_loss(self._slot)
        return float(self._state["cum_loss"])

    def curve_slice(self) -> List[Tuple[float, int]]:
        """Drain the learning-curve points accumulated since the last call.
        The lazy losses come to the host in ONE copy (a cohort member's
        staged losses: one copy a gang launch)."""
        fresh = self._curve
        self._curve = []
        if not fresh:
            return []
        parts = [
            loss.as_tensor() if hasattr(loss, "as_tensor") else loss
            for loss, _ in fresh
        ]
        if len({t.device for t in parts}) > 1:
            parts = [t.cpu() for t in parts]
        values = torch.cat([t.reshape(-1) for t in parts]).tolist()
        fitted: List[int] = []
        for _, f in fresh:
            fitted.extend(f if isinstance(f, list) else [f])
        return [(float(l), int(f)) for l, f in zip(values, fitted)]

    def _unravel_fn(self) -> Callable[[np.ndarray], dict]:
        """Inverse of the flattening in :meth:`get_flat_params` for the
        current parameter structure (one host->device copy per call)."""
        return unravel_fn(self.state["params"], self.device)

    def get_flat_params(self) -> Tuple[np.ndarray, Callable[[np.ndarray], dict]]:
        """Learner params as one float32 vector in ``ravel_pytree`` order
        (hub messages and query responses carry it), plus its inverse. The
        vector is a writable host copy: protocol code mutates shards. A
        cohort member reads its row of the cohort's flat matrix."""
        if self._cohort is not None:
            return self._cohort.member_flat(self._slot)
        leaves = _leaves(self._state["params"])
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
        return np.array(flat.cpu().numpy()), self._unravel_fn()

    def set_flat_params(self, flat: np.ndarray) -> None:
        if self._cohort is not None:
            self._cohort.set_member_flat(self._slot, flat)
            return
        self._state["params"] = self._unravel_fn()(flat)

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
