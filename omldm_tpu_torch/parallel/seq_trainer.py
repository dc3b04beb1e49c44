"""SeqTrainer: Adam-trained transformer on one device or a ("dp", "sp", "tp") mesh of processes.

Counterpart of ``omldm_tpu/parallel/seq_trainer.py``: the same loss, the
same Adam and the same parameter and optimizer trees. Its attention runs
the hand-written flash kernels on CUDA (forward, dQ and dK/dV) and their
plain twins on the CPU. A config with ``n_experts > 0`` trains switch-MoE
blocks through the ``[E, C, D]`` dispatch buffer; ``remat=True``
recomputes each block in the backward pass, so the flash forward runs
twice a layer a step.

A mesh position is a process of one ``torch.distributed`` group
(``parallel.multihost.initialize_multihost``, gloo on the CPU and for
processes that share a card): rank ``r`` sits at ``(d, s, t)`` with ``r =
(d * sp + s) * tp + t``, the order of the JAX grid's ``reshape(dp, sp,
tp)``, and each axis is a group of its own (:func:`make_seq_mesh`).

- the batch is split over ``dp`` and the sequence over ``sp`` (ring or
  Ulysses attention, ``cfg.seq_parallel``); heads and the dense MLP's
  hidden width over ``tp`` (Megatron's layout); MoE experts over ``dp``
  (expert parallelism, two ``all_to_all``s a block);
- every process receives the same GLOBAL batch, as the JAX ``step`` does,
  and takes its ``(dp, sp)`` block;
- parameters are placed by :func:`_param_specs` (``ckpt.Split`` leaves);
  ``load_numpy`` takes a global tree (a JAX trainer's ``host_params()``)
  and keeps this process's slices, ``host_params`` gathers it back;
- gradients: the JAX package's shard_map inserts the gradient sums; here
  they are explicit (:func:`_sum_axes`): a leaf's gradient is summed over
  dp and sp unless the leaf is split over that axis, never over tp (the
  Megatron pair already gives every tp process the whole gradient of a
  replicated leaf), and classify's head not over sp (its loss follows the
  pooled mean over sp, the same on every sp process).

``save``/``load`` snapshot the global ``{params, opt, fitted}`` as a numpy
tree (``parallel.ckpt``): a trainer saved on the card loads on the CPU and
the other way round, and on any mesh shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from omldm_tpu_torch.models.transformer import (
    AxisSpec,
    TransformerConfig,
    classify_loss,
    init_transformer,
    lm_loss,
    params_from_numpy,
    tree_leaves,
    tree_unflatten,
)
from omldm_tpu_torch.parallel import multihost
from omldm_tpu_torch.parallel.ckpt import Split, gather_tree, shard_tree
from omldm_tpu_torch.parallel.optim import adam_opt_specs, adam_update, init_adam_state
from omldm_tpu_torch.utils import batch_valid_counts
from omldm_tpu_torch.utils.device import resolve_device

AXES = ("dp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class SeqMesh:
    """The ``("dp", "sp", "tp")`` mesh as this process sees it: ``shape``
    (the JAX ``Mesh.shape``), its coordinates, one process group an axis
    (None for an axis of size 1), its rank and the mesh's process count."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any] = dataclasses.field(compare=False, repr=False)
    rank: int = 0
    world: int = 1


def _axis_ranks(dp: int, sp: int, tp: int, axis: str):
    """The rank lists of ``axis``'s groups, in one fixed order."""
    rank = lambda d, s, t: (d * sp + s) * tp + t  # noqa: E731
    if axis == "dp":
        return [[rank(d, s, t) for d in range(dp)] for s in range(sp) for t in range(tp)]
    if axis == "sp":
        return [[rank(d, s, t) for s in range(sp)] for d in range(dp) for t in range(tp)]
    return [[rank(d, s, t) for t in range(tp)] for d in range(dp) for s in range(sp)]


def make_seq_mesh(dp: int = 1, sp: int = 1, tp: int = 1) -> SeqMesh:
    """("dp", "sp", "tp") mesh over the joined process group, which must
    hold ``dp * sp * tp`` processes; (1, 1, 1) without a group is the one
    device. Every process forms every axis group in the same order (a
    process that skipped one would stall the others' join)."""
    shape = {"dp": dp, "sp": sp, "tp": tp}
    if min(shape.values()) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    need = dp * sp * tp
    joined = dist.is_available() and dist.is_initialized()
    have = dist.get_world_size() if joined else 1
    if need != have:
        raise ValueError(f"mesh ({dp}x{sp}x{tp}) needs {need} processes, have {have}")
    rank = dist.get_rank() if joined else 0
    coords = {"dp": rank // (sp * tp), "sp": rank // tp % sp, "tp": rank % tp}
    groups: Dict[str, Any] = {}
    for axis in AXES:
        groups[axis] = None
        if shape[axis] == 1:
            continue
        for ranks in _axis_ranks(dp, sp, tp, axis):
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return SeqMesh(shape, coords, groups, rank, need)


#: the one-device mesh: no group
SINGLE = SeqMesh({"dp": 1, "sp": 1, "tp": 1}, {"dp": 0, "sp": 0, "tp": 0},
                 {"dp": None, "sp": None, "tp": None})


def _param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """Where each leaf of ``init_transformer``'s tree is split (None:
    replicated), the JAX ``_param_specs``."""
    layer = {
        "ln1": {"g": None},
        "ln2": {"g": None},
        "wqkv": Split(2, "tp"),   # [D, 3, D]: heads over tp
        "wo": Split(0, "tp"),
    }
    if cfg.n_experts > 0:
        layer.update(router=None, w1=Split(0, "dp"), w2=Split(0, "dp"))  # experts over ep = dp
    else:
        layer.update(w1=Split(1, "tp"), w2=Split(0, "tp"))  # Megatron column / row halves
    return {
        "embed": None,
        "pos": None,
        "ln_f": {"g": None},
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "head": None,
    }


def _sum_axes(cfg: TransformerConfig, pspecs) -> Dict[str, Any]:
    """The axes each leaf's gradient is summed over: dp and sp, less the
    axis the leaf is split over; classify's head over dp only."""
    def axes(spec):
        return frozenset(a for a in ("dp", "sp") if spec is None or spec.axis != a)

    tree = tree_unflatten(pspecs, [axes(s) for s in tree_leaves(pspecs)])
    if cfg.objective == "classify":
        tree["head"] = frozenset(("dp",))
    return tree


class SeqTrainer:
    """Batches arrive as GLOBAL host or device arrays ``tokens/targets/mask:
    [B, L]`` (targets and mask pre-shifted for "lm"; ``labels: [B]`` for
    "classify"), the same on every process of the mesh. ``mesh=None`` is the
    one device. ``device=None`` means CUDA (on a mesh: card ``rank %
    device_count``), and raises without a card."""

    def __init__(self, cfg: TransformerConfig, mesh: Optional[SeqMesh] = None, device=None,
                 lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 seed: int = 0):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else SINGLE
        dp, sp, tp = (self.mesh.shape[a] for a in AXES)
        if cfg.n_heads % tp:
            raise ValueError(f"n_heads {cfg.n_heads} not divisible by tp {tp}")
        if cfg.n_experts == 0 and cfg.d_ff % tp:
            raise ValueError(f"d_ff {cfg.d_ff} not divisible by tp {tp}")
        if cfg.n_experts > 0 and cfg.n_experts % dp:
            raise ValueError(f"n_experts {cfg.n_experts} not divisible by dp {dp}")
        if cfg.seq_parallel not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_parallel must be 'ring' or 'ulysses', got {cfg.seq_parallel!r}")
        if cfg.seq_parallel == "ulysses" and sp > 1 and (cfg.n_heads // tp) % sp:
            raise ValueError(
                f"ulysses needs the per-tp-shard head count ({cfg.n_heads // tp}) "
                f"divisible by sp {sp}")
        if self.mesh.world > 1:
            self.device = multihost.process_device(device, self.mesh.rank)
        else:
            self.device = resolve_device(device, "SeqTrainer")
        groups = self.mesh.groups
        self.axes = AxisSpec(dp=groups["dp"], sp=groups["sp"], tp=groups["tp"],
                             ep=groups["dp"] if cfg.n_experts > 0 else None)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self._pspecs = _param_specs(cfg)
        self._ospecs = adam_opt_specs(self._pspecs)
        self._sum = tree_leaves(_sum_axes(cfg, self._pspecs))
        gen = torch.Generator().manual_seed(seed)
        self.params = self._local(init_transformer(cfg, gen, "cpu"))
        self.opt = init_adam_state(self.params)
        self._fitted = 0

    def _local(self, global_tree):
        """This process's slices of a global tree, as float32 tensors of
        their own on the trainer's device."""
        return params_from_numpy(shard_tree(global_tree, self._pspecs, self.mesh), self.device)

    def load_numpy(self, params, opt: Optional[Dict[str, Any]] = None) -> None:
        """Start from a JAX trainer's state: its global ``host_params()``
        tree and, optionally, its optimizer tree ``{"mu", "nu", "count"}``,
        as numpy; this process keeps its slices."""
        self.params = self._local(params)
        if opt is None:
            self.opt = init_adam_state(self.params)
        else:
            self.opt = {
                "mu": self._local(opt["mu"]),
                "nu": self._local(opt["nu"]),
                "count": torch.as_tensor(opt["count"], dtype=torch.int32).to(self.device),
            }

    def _block(self, a, dtype, seq=True):
        """This process's (dp, sp) block of a global [B, L] array (``seq``
        False: [B], classify's labels), with or without a leading [T] axis,
        on the trainer's device."""
        a = torch.as_tensor(a)
        cuts = [("dp", a.dim() - 1 - int(seq))] + ([("sp", a.dim() - 1)] if seq else [])
        for axis, dim in cuts:
            n = self.mesh.shape[axis]
            if a.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(a.shape)} not divisible by "
                                 f"{axis} {n}")
            a = a.narrow(dim, self.mesh.coords[axis] * (a.shape[dim] // n), a.shape[dim] // n)
        return a.to(device=self.device, dtype=dtype)

    def _loss(self, params, tokens, targets, mask):
        if self.cfg.objective == "lm":
            return lm_loss(self.cfg, params, tokens, targets, mask, self.axes)
        return classify_loss(self.cfg, params, tokens, targets, self.axes)

    def _sync(self, grads):
        """Sum each gradient over its axes: one all-reduce an axis, of every
        leaf summed over it, flattened into one buffer."""
        for axis in ("dp", "sp"):
            group = self.mesh.groups[axis]
            if group is None:
                continue
            idx = [i for i, axes in enumerate(self._sum) if axis in axes]
            flat = multihost.all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                                        group=group)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = part.view_as(grads[i])
        return grads

    def _step_impl(self, tokens, targets, mask) -> torch.Tensor:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params)]
        params = tree_unflatten(self.params, leaves)
        loss = self._loss(params, tokens, targets, mask)
        grads = self._sync(list(torch.autograd.grad(loss, leaves)))
        self.params, self.opt = adam_update(
            tree_unflatten(self.params, [p.detach() for p in leaves]),
            tree_unflatten(self.params, grads), self.opt, self.lr, self.b1, self.b2, self.eps,
        )
        return loss.detach()

    def _batch(self, tokens, targets, mask):
        """The local blocks of one global batch (or of T stacked ones)."""
        classify = self.cfg.objective == "classify"
        return (self._block(tokens, torch.long),
                self._block(targets, torch.long, seq=not classify),
                self._block(mask, torch.float32))

    def step(self, tokens, targets, mask=None, valid_count=None) -> torch.Tensor:
        """One global training step; returns the global mean loss as a 0-d
        device tensor (not read back, so the host does not wait for the
        device). Pass ``valid_count`` with a mask on the card: the mask is
        then not read back to count the fitted tokens."""
        if mask is None:
            mask = torch.ones(tuple(torch.as_tensor(tokens).shape))
        if valid_count is None:
            valid_count = torch.as_tensor(mask).sum()
        loss = self._step_impl(*self._batch(tokens, targets, mask))
        self._fitted += int(valid_count)
        return loss

    def step_many(self, tokens_s, targets_s, masks_s=None, valid_counts=None) -> torch.Tensor:
        """T steps over global batches stacked on a leading [T] axis; returns
        the [T] losses. Each process's blocks go to the device in one copy
        each, then a loop of steps runs on them without waiting for the
        device (the JAX package runs the loop as one ``lax.scan``
        program). Pass ``valid_counts`` when ``masks_s`` is on the card."""
        if masks_s is None:
            masks_s = torch.ones(tuple(torch.as_tensor(tokens_s).shape))
        counts = batch_valid_counts(masks_s, valid_counts)
        batches = self._batch(tokens_s, targets_s, masks_s)
        losses = torch.stack([self._step_impl(t, g, m) for t, g, m in zip(*batches)])
        self._fitted += sum(counts)
        return losses

    @property
    def fitted(self) -> int:
        """Valid tokens of every global batch stepped."""
        return self._fitted

    def host_params(self):
        """The global parameter tree as numpy arrays (gathered over the
        mesh: every process of it calls this)."""
        return gather_tree(self.params, self._pspecs, self.mesh)

    def save(self, directory: str) -> None:
        """Snapshot the global ``{params, opt, fitted}`` into ``directory``
        (the trainer-side checkpoint/resume path, SURVEY.md section 7 step
        8); every process of the mesh calls this, process 0 writes."""
        from omldm_tpu_torch.parallel.ckpt import save_trainer_state

        save_trainer_state(self, directory)

    def load(self, directory: str) -> None:
        """Restore a :meth:`save` snapshot onto this trainer's mesh and
        device (the same model config, any mesh shape)."""
        from omldm_tpu_torch.parallel.ckpt import load_trainer_state

        load_trainer_state(self, directory)
