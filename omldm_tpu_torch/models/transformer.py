"""Dense transformer LM / classifier, single device.

Counterpart of ``omldm_tpu/models/transformer.py`` with the same parameter
tree (names, shapes, ``wqkv`` as [D, 3, D]) held as a plain dict of tensors,
so a JAX parameter tree carries across with :func:`params_from_numpy`. The
attention runs through ``ops.attention.attention``: the hand-written flash
kernels on CUDA tensors, their plain twins on CPU tensors. The projections,
MLP and LM head are plain products (``torch.matmul``), as the JAX package
leaves them to XLA.

Not ported yet: mixture of experts (``n_experts > 0``) and ``remat`` raise
``NotImplementedError`` naming them; the functions take no mesh axes (the
JAX package's ``AxisSpec``: ring and Ulysses attention, Megatron and expert
parallelism), so passing one is a ``TypeError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from omldm_tpu_torch.ops.attention import attention
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
    n_experts: int = 0          # > 0 (MoE) is not ported yet
    dtype: Any = torch.float32  # compute dtype: a torch dtype, "float32" or "bfloat16"
    remat: bool = False         # True is not ported yet
    # > 0: the LM loss in token chunks of this size, each chunk's logits
    # recomputed in the backward and never stored whole (see _lm_nll_fused)
    loss_chunk: int = 0

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])


def check_ported(cfg: TransformerConfig) -> None:
    """Raise ``NotImplementedError`` naming any option the port lacks."""
    if cfg.n_experts > 0:
        raise NotImplementedError("n_experts > 0 (mixture of experts) is not ported yet")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet")


def _dense(gen, fan_in, fan_out, device):
    w = torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float32)
    return (float(np.sqrt(2.0 / fan_in)) * w).to(device)


def init_transformer(cfg: TransformerConfig, generator: torch.Generator,
                     device=None) -> Dict[str, Any]:
    """Float32 parameter tree with the JAX package's names, shapes and
    distributions (drawn from ``generator``, so not its values), on
    ``device``: CUDA unless the caller asks for the CPU (without a card,
    CUDA raises)."""
    check_ported(cfg)
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
        params["layers"].append({
            "ln1": {"g": torch.ones((d,), device=device)},
            "ln2": {"g": torch.ones((d,), device=device)},
            "wqkv": _dense(generator, d, 3 * d, device).reshape(d, 3, d),
            "wo": _dense(generator, d, d, device),
            "w1": _dense(generator, d, cfg.d_ff, device),
            "w2": _dense(generator, cfg.d_ff, d, device),
        })
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


def _attention_block(cfg, layer, x):
    b, lc, d = x.shape
    dh = d // cfg.n_heads
    # q, k, v stay strided views into the packed projection: the kernels
    # take them by strides, without a copy
    qkv = (x @ layer["wqkv"].reshape(d, 3 * d)).view(b, lc, 3, cfg.n_heads, dh)
    o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=cfg.causal)
    return o.reshape(b, lc, d) @ layer["wo"]


def _mlp_block(layer, x):
    return torch.relu(x @ layer["w1"]) @ layer["w2"]


def transformer_hidden(cfg: TransformerConfig, params,
                       tokens) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Final-norm hidden states [B, L, D] plus the compute-dtype params."""
    check_ported(cfg)
    params = cast_params(params, cfg.dtype)
    lc = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][:lc]
    for layer in params["layers"]:
        x = x + _attention_block(cfg, layer, _rms_norm(x, layer["ln1"]["g"]))
        x = x + _mlp_block(layer, _rms_norm(x, layer["ln2"]["g"]))
    return _rms_norm(x, params["ln_f"]["g"]), params


def transformer_forward(cfg: TransformerConfig, params, tokens) -> torch.Tensor:
    """Token logits [B, L, V] ("lm") or pooled class logits [B, n_classes]
    ("classify"), in the compute dtype."""
    x, params = transformer_hidden(cfg, params, tokens)
    if cfg.objective == "classify":
        return x.mean(1) @ params["head"]
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


def lm_loss(cfg, params, tokens, targets, mask):
    """Mean next-token cross-entropy over the masked tokens (targets and mask
    pre-shifted by the caller)."""
    mask = mask.float()
    if cfg.loss_chunk > 0:
        x, cparams = transformer_hidden(cfg, params, tokens)
        num = _lm_nll_fused(cparams["head"], x, targets, mask, cfg.loss_chunk)
    else:
        logits = transformer_forward(cfg, params, tokens)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
        num = (nll * mask).sum()
    return num / torch.clamp(mask.sum(), min=1.0)


def classify_loss(cfg, params, tokens, labels):
    """Mean class cross-entropy (labels [B])."""
    logits = transformer_forward(cfg, params, tokens)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return nll.sum() / nll.shape[0]
