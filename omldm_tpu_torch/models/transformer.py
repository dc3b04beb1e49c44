"""Transformer LM / classifier (dense MLP or switch-MoE blocks), on one device or a mesh.

Counterpart of ``omldm_tpu/models/transformer.py`` with the same parameter
tree (names, shapes, ``wqkv`` as [D, 3, D], MoE ``router`` [D, E], ``w1``
[E, D, F], ``w2`` [E, F, D]) held as a plain dict of tensors, so a JAX
parameter tree carries across with :func:`params_from_numpy`. The attention
runs through ``ops.attention.attention``: the hand-written flash kernels on
CUDA tensors (any head width up to 256, float32 or bfloat16), their plain
twins on CPU tensors. The projections, MLP, switch MoE and LM head are plain
products (``torch.matmul``/``einsum``), as the JAX package leaves them to
XLA.

``n_experts > 0`` makes every block's MLP a top-1 switch MoE with the JAX
package's capacity rule, run through a ``[E, C, D]`` dispatch buffer
(:func:`_moe_block`, the JAX ``_moe_block_ep`` at one expert shard). It
computes the same function as the JAX ``_moe_block_dense``, which the JAX
package runs with no mesh axes, so one form serves both.
``remat=True`` recomputes each block's activations in the backward pass
(``torch.utils.checkpoint``, the JAX ``jax.checkpoint(block)``).

Every function takes ``axes=AxisSpec(...)``, the process groups of the
``("dp", "sp", "tp")`` mesh it runs on (``parallel.seq_trainer``), with
this process's slices of the parameters; with no groups it is the
single-device model:

- ``sp``: tokens arrive as this process's sequence chunk; attention runs
  as ring attention (``ops.ring_attention``) or Ulysses (``ops.ulysses``)
  by ``cfg.seq_parallel``, positions are offset by the chunk's start, and
  classify pools with a mean over the group;
- ``tp``: attention heads and the dense MLP's hidden width are split
  (Megatron's layout); each block enters through ``EnterGroup`` and leaves
  through ``SumOverGroup``, so every process holds the whole gradient of a
  replicated weight;
- ``ep`` (= dp): each process owns ``n_experts / ep`` experts, and tokens
  reach them through two ``all_to_all``s (:func:`_moe_block` with a group);
- ``dp`` and ``sp``: the losses sum over them, so every process returns
  the global mean. Its backward gives each process the gradient of its own
  part; the trainer sums the parts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from omldm_tpu_torch.ops.attention import attention
from omldm_tpu_torch.ops.ring_attention import ring_attention
from omldm_tpu_torch.ops.ulysses import ulysses_attention
from omldm_tpu_torch.parallel.multihost import (
    AllToAll,
    EnterGroup,
    MeanOverGroup,
    SumOverGroup,
)
from omldm_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 2048
    n_classes: int = 2          # classify head width
    causal: bool = True
    objective: str = "lm"       # "lm" (token logits) | "classify" (pooled)
    # MoE: n_experts == 0 => dense MLP blocks; else top-1 switch blocks whose
    # experts take at most max(int(capacity_factor * T / n_experts), 1) tokens
    n_experts: int = 0
    capacity_factor: float = 1.25
    dtype: Any = torch.float32  # compute dtype: a torch dtype, "float32" or "bfloat16"
    # recompute each block's activations in the backward pass
    remat: bool = False
    # > 0: the LM loss in token chunks of this size, each chunk's logits
    # recomputed in the backward and never stored whole (see _lm_nll_fused)
    loss_chunk: int = 0
    # attention over an sp group: "ring" (K/V chunks around the ring, O(L/sp)
    # memory) or "ulysses" (all_to_all head/sequence re-shard; needs
    # (n_heads // tp) % sp == 0)
    seq_parallel: str = "ring"

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """The process groups a forward runs under (None: the axis is absent or
    of size 1). ``dp`` only enters the loss reductions (the batch is split
    over it); ``ep`` is the expert-parallel group (the trainer's dp)."""
    dp: Any = None
    sp: Any = None
    tp: Any = None
    ep: Any = None

    def __post_init__(self):
        for name in ("dp", "sp", "tp", "ep"):
            if isinstance(getattr(self, name), str):
                raise TypeError(f"AxisSpec.{name} takes a process group, not the JAX "
                                f"package's axis name {getattr(self, name)!r}")

    def loss_axes(self):
        return tuple(g for g in (self.dp, self.sp) if g is not None)


def group_size(group) -> int:
    """Processes in ``group``; 1 for an absent axis (None)."""
    return 1 if group is None else dist.get_world_size(group)


def group_index(group) -> int:
    """This process's rank in ``group``; 0 for an absent axis (None)."""
    return 0 if group is None else dist.get_rank(group)


def _axes(axes) -> AxisSpec:
    if not isinstance(axes, AxisSpec):
        raise TypeError(f"axes must be an AxisSpec of process groups, got {axes!r}")
    return axes


def _dense(gen, fan_in, fan_out, device):
    w = torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float32)
    return (float(np.sqrt(2.0 / fan_in)) * w).to(device)


def init_transformer(cfg: TransformerConfig, generator: torch.Generator,
                     device=None) -> Dict[str, Any]:
    """Float32 parameter tree with the JAX package's names, shapes and
    distributions (drawn from ``generator``, so not its values), on
    ``device``: CUDA unless the caller asks for the CPU (without a card,
    CUDA raises)."""
    device = resolve_device(device, "init_transformer")
    d = cfg.d_model
    assert d % cfg.n_heads == 0
    params: Dict[str, Any] = {
        "embed": _dense(generator, cfg.vocab_size, d, device),
        "pos": (0.02 * torch.randn((cfg.max_len, d), generator=generator)).to(device),
        "ln_f": {"g": torch.ones((d,), device=device)},
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": {"g": torch.ones((d,), device=device)},
            "ln2": {"g": torch.ones((d,), device=device)},
            "wqkv": _dense(generator, d, 3 * d, device).reshape(d, 3, d),
            "wo": _dense(generator, d, d, device),
        }
        if cfg.n_experts > 0:
            e = cfg.n_experts
            layer["router"] = _dense(generator, d, e, device)
            layer["w1"] = torch.stack([_dense(generator, d, cfg.d_ff, device) for _ in range(e)])
            layer["w2"] = torch.stack([_dense(generator, cfg.d_ff, d, device) for _ in range(e)])
        else:
            layer["w1"] = _dense(generator, d, cfg.d_ff, device)
            layer["w2"] = _dense(generator, cfg.d_ff, d, device)
        params["layers"].append(layer)
    width = cfg.n_classes if cfg.objective == "classify" else cfg.vocab_size
    params["head"] = _dense(generator, d, width, device)
    return params


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """Rebuild ``tree``'s structure from leaves in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def params_from_numpy(tree, device=None):
    """A JAX parameter tree (numpy leaves, as ``jax.device_get`` gives it)
    as float32 tensors on ``device``: CUDA unless the caller asks for the
    CPU."""
    device = resolve_device(device, "params_from_numpy")
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device), tree)


def params_to_numpy(params):
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)


def cast_params(params, dtype):
    """Master weights stay float32; the forward computes in ``dtype``. The
    cast is differentiable (its backward casts gradients back to float32)."""
    if dtype == torch.float32:
        return params
    return tree_map(lambda w: w.to(dtype) if w.is_floating_point() else w, params)


def _rms_norm(x, g):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return (x32 * scale).to(x.dtype) * g


def _enter(x, group):
    return x if group is None else EnterGroup.apply(x, group)


def _sum(x, group):
    return x if group is None else SumOverGroup.apply(x, group)


def _attention_block(cfg, layer, x, axes: AxisSpec):
    """x: [B, Lc, D]; ``wqkv`` [D, 3, h] and ``wo`` [h, D] hold this
    process's heads (h = heads_local * dh) when tp splits them."""
    b, lc, d = x.shape
    h = layer["wqkv"].shape[2]
    dh = d // cfg.n_heads
    # q, k, v stay strided views into the packed projection: the kernels
    # take them by strides, without a copy
    qkv = (_enter(x, axes.tp) @ layer["wqkv"].reshape(d, 3 * h)).view(b, lc, 3, h // dh, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if group_size(axes.sp) > 1:
        if cfg.seq_parallel == "ulysses":
            o = ulysses_attention(q, k, v, axes.sp, causal=cfg.causal)
        else:
            o = ring_attention(q, k, v, axes.sp, causal=cfg.causal)
    else:
        o = attention(q, k, v, causal=cfg.causal)
    # tp: each process projected its own heads: a part of the output
    return _sum(o.reshape(b, lc, h) @ layer["wo"], axes.tp)


def _mlp_block(layer, x, axes: AxisSpec):
    return _sum(torch.relu(_enter(x, axes.tp) @ layer["w1"]) @ layer["w2"], axes.tp)


def moe_route(layer, t, capacity_factor: float):
    """Top-1 switch routing of tokens t [T, D], the JAX package's rule:
    softmax gate in float32, the expert by argmax (ties to the lowest index,
    as ``jnp.argmax`` and ``torch.argmax`` both break them), each token's
    slot within its expert by an integer cumsum in token order, and
    ``keep = slot < cap`` with ``cap = max(int(capacity_factor * T / E), 1)``.
    ``E`` is the router's width: every expert of the model, wherever its
    weights are held. Returns (expert [T], slot [T], keep [T], gate value
    [T] float32, cap)."""
    n_tokens, n_experts = t.shape[0], layer["router"].shape[1]
    cap = max(int(capacity_factor * n_tokens / n_experts), 1)
    gate = torch.softmax((t @ layer["router"]).float(), dim=-1)        # [T, E]
    expert = torch.argmax(gate, dim=-1)                                 # [T]
    gval = gate.gather(-1, expert[:, None])[:, 0]                       # [T]
    onehot = torch.nn.functional.one_hot(expert, n_experts)             # [T, E] int64
    # the scan runs along the contiguous axis of the [E, T] transpose: a
    # cumsum down the T rows of [T, E] is one slow scan of T steps a column
    slot = (torch.cumsum(onehot.t(), dim=1).t() * onehot).sum(-1) - 1  # 0-based
    return expert, slot, slot < cap, gval, cap


def _moe_block(layer, x, capacity_factor: float, ep=None):
    """Switch MoE through a ``[E, C, D]`` dispatch buffer: the JAX
    ``_moe_block_ep``. With an ``ep`` group each process owns ``E / ep``
    experts (``w1``/``w2`` hold its slice); the buffer, as ``[ep, E_local,
    C, D]``, goes to the experts' owners through one ``all_to_all`` and the
    outputs come back through its inverse; with none both are identities.
    The capacity ``C`` is the rule of :func:`moe_route` over this process's
    tokens. Only kept tokens are written into the buffer, each into its own
    (expert, slot), so no two writes meet; the experts run on their C slots,
    and each kept token gathers its slot back, scaled by its gate value; a
    dropped token gives 0, as in the JAX ``_moe_block_dense``."""
    b, lc, d = x.shape
    t = x.reshape(-1, d)
    expert, slot, keep, gval, cap = moe_route(layer, t, capacity_factor)
    n_experts, e_local = layer["router"].shape[1], layer["w1"].shape[0]
    disp = t.new_zeros((n_experts, cap, d))
    disp = disp.index_put((expert[keep], slot[keep]), t[keep])
    if ep is not None:  # [ep, E_local, C, D] -> [ep (source), E_local, C, D]
        disp = AllToAll.apply(disp.reshape(n_experts // e_local, e_local, cap, d), 0, 0, ep)
    ht = torch.relu(torch.einsum("...ecd,edf->...ecf", disp, layer["w1"]))
    yt = torch.einsum("...ecf,efd->...ecd", ht, layer["w2"])
    if ep is not None:  # each source's outputs back to it: [ep (owner), E_local, C, D]
        yt = AllToAll.apply(yt, 0, 0, ep)
    # the combine: each token's (expert, slot) row of the flattened buffer
    # (a dropped token row 0, then masked, as the JAX block does);
    # index_select's backward adds each kept token's gradient into its own
    # row, where the backward of 2-d advanced indexing sorts the indices
    rows = torch.where(keep, expert * cap + slot, torch.zeros_like(slot))
    out = yt.reshape(-1, d).index_select(0, rows) * gval[:, None].to(x.dtype)
    out = torch.where(keep[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(b, lc, d)


def _block(cfg, layer, x, axes: AxisSpec):
    x = x + _attention_block(cfg, layer, _rms_norm(x, layer["ln1"]["g"]), axes)
    z = _rms_norm(x, layer["ln2"]["g"])
    if cfg.n_experts > 0:
        return x + _moe_block(layer, z, cfg.capacity_factor, axes.ep)
    return x + _mlp_block(layer, z, axes)


def transformer_hidden(cfg: TransformerConfig, params, tokens,
                       axes: AxisSpec = AxisSpec()) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Final-norm hidden states [B, Lc, D] (this process's sequence chunk
    under sp) plus the compute-dtype params."""
    axes = _axes(axes)
    params = cast_params(params, cfg.dtype)
    lc = tokens.shape[1]
    start = group_index(axes.sp) * lc  # the chunk's absolute position
    x = params["embed"][tokens] + params["pos"][start:start + lc]
    for layer in params["layers"]:
        if cfg.remat:
            # the block draws no random numbers, so no RNG state is kept
            x = checkpoint(_block, cfg, layer, x, axes, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(cfg, layer, x, axes)
    return _rms_norm(x, params["ln_f"]["g"]), params


def transformer_forward(cfg: TransformerConfig, params, tokens,
                        axes: AxisSpec = AxisSpec()) -> torch.Tensor:
    """Token logits [B, Lc, V] ("lm") or pooled class logits [B, n_classes]
    ("classify"), in the compute dtype."""
    x, params = transformer_hidden(cfg, params, tokens, axes)
    if cfg.objective == "classify":
        pooled = x.mean(1)
        if axes.sp is not None:
            # the whole sequence's mean is the mean of the chunks' means
            pooled = MeanOverGroup.apply(pooled, axes.sp)
        return pooled @ params["head"]
    return x @ params["head"]


def _chunk_nll(xc, head, tc, mc):
    # bf16 x bf16 -> f32 logits, as preferred_element_type=f32 gives in the
    # JAX package: the operands are widened to float32 (exactly) and
    # multiplied in full float32 -- TF32 must be off, which is PyTorch's
    # default (torch.backends.cuda.matmul.allow_tf32 = False)
    logits = xc.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, tc[:, None])[:, 0]
    return ((lse - tl) * mc).sum()


def _lm_nll_fused(head, x, targets, mask, chunk):
    """Masked NLL sum over all tokens without storing the [T, V] logits: a
    loop over token chunks, each under ``torch.utils.checkpoint``, so its
    f32 logits are dropped after its (lse, target logit) reduction and
    recomputed in the backward (it draws no random numbers, so the
    checkpoint keeps no RNG state)."""
    d = x.shape[-1]
    xs = x.reshape(-1, d)
    ts = targets.reshape(-1).long()
    ms = mask.reshape(-1).float()
    total = xs.new_zeros((), dtype=torch.float32)
    for start in range(0, xs.shape[0], chunk):
        sl = slice(start, start + chunk)
        total = total + checkpoint(_chunk_nll, xs[sl], head, ts[sl], ms[sl],
                                   use_reentrant=False, preserve_rng_state=False)
    return total


def _global_mean(num, den, groups):
    """num / den with both summed over ``groups`` in one reduction a group
    (den carries no gradient; num's backward is its own part's)."""
    if not groups:
        return num / torch.clamp(den, min=1.0)
    both = torch.stack((num, den.detach().to(num.dtype)))
    for group in groups:
        both = SumOverGroup.apply(both, group)
    return both[0] / torch.clamp(both[1], min=1.0)


def lm_loss(cfg, params, tokens, targets, mask, axes: AxisSpec = AxisSpec()):
    """The global mean next-token cross-entropy over the masked tokens
    (targets and mask pre-shifted by the caller, split like the tokens):
    the same scalar on every process of the mesh."""
    axes = _axes(axes)
    mask = mask.float()
    if cfg.loss_chunk > 0:
        x, cparams = transformer_hidden(cfg, params, tokens, axes)
        num = _lm_nll_fused(cparams["head"], x, targets, mask, cfg.loss_chunk)
    else:
        logits = transformer_forward(cfg, params, tokens, axes)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
        num = (nll * mask).sum()
    return _global_mean(num, mask.sum(), axes.loss_axes())


def classify_loss(cfg, params, tokens, labels, axes: AxisSpec = AxisSpec()):
    """The global mean class cross-entropy (labels [B], split over dp)."""
    axes = _axes(axes)
    logits = transformer_forward(cfg, params, tokens, axes)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    den = nll.new_full((), float(nll.shape[0]))  # a fill on the device, no copy
    return _global_mean(nll.sum(), den, () if axes.dp is None else (axes.dp,))
