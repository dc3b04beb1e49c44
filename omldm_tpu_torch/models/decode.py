"""Incremental decoding: the KV-cache serving path of the transformer family.

Counterpart of ``omldm_tpu/models/decode.py``: a prompt is prefilled once,
then tokens are generated one at a time against a preallocated KV cache.
Attention here is plain torch (``_cached_attention``), as in the JAX package:
no kernel runs on this path. Dense configs only: an MoE config
(``n_experts > 0``) raises the JAX package's ``ValueError``. Unlike the JAX
package, the cache is written in place (it is preallocated for that) and
its position is a host integer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from omldm_tpu_torch.models.transformer import (
    TransformerConfig,
    _rms_norm,
    cast_params,
    tree_leaves,
)
from omldm_tpu_torch.ops.attention import NEG_INF
from omldm_tpu_torch.utils.device import resolve_device


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: Optional[int] = None,
                  device=None) -> Dict[str, Any]:
    """Per-layer K/V buffers [B, max_len, H, Dh] and the current length, on
    ``device``: CUDA unless the caller asks for the CPU."""
    device = resolve_device(device, "init_kv_cache")
    max_len = max_len or cfg.max_len
    shape = (batch, max_len, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {
        "layers": [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                    "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
                   for _ in range(cfg.n_layers)],
        "pos": 0,
    }


def _cached_attention(q, kcache, vcache, q_pos0: int, n_valid: int):
    """q: [B, T, H, Dh] at absolute positions q_pos0 + [0, T); attends
    causally over cache rows [0, n_valid)."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kcache.float()) / math.sqrt(dh)
    k_pos = torch.arange(kcache.shape[1], device=q.device)
    q_pos = q_pos0 + torch.arange(q.shape[1], device=q.device)
    ok = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < n_valid)
    p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vcache.float()).to(q.dtype)


def forward_with_cache(cfg: TransformerConfig, params, tokens,
                       cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process T tokens starting at ``cache["pos"]``: writes their K/V into
    the cache (in place) and returns (logits [B, T, V], the cache advanced
    by T). A mixture-of-experts config is refused, as the JAX package
    refuses it."""
    if cfg.n_experts:
        raise ValueError("decode supports dense transformer configs")
    if cfg.objective != "lm" or not cfg.causal:
        raise ValueError(
            "decode requires a causal lm config (the KV cache is causal and "
            "the head must produce token logits)")
    params = cast_params(params, cfg.dtype)
    b, t = tokens.shape
    d = cfg.d_model
    dh = d // cfg.n_heads
    pos0 = cache["pos"]
    max_len = cache["layers"][0]["k"].shape[1]
    if pos0 + t > max_len:
        raise ValueError(f"cache overflow: pos {pos0} + {t} tokens > max_len {max_len}")
    x = params["embed"][tokens] + params["pos"][pos0:pos0 + t]
    for layer, kv in zip(params["layers"], cache["layers"]):
        z = _rms_norm(x, layer["ln1"]["g"])
        qkv = (z @ layer["wqkv"].reshape(d, 3 * d)).view(b, t, 3, cfg.n_heads, dh)
        kv["k"][:, pos0:pos0 + t] = qkv[:, :, 1]
        kv["v"][:, pos0:pos0 + t] = qkv[:, :, 2]
        o = _cached_attention(qkv[:, :, 0], kv["k"], kv["v"], pos0, pos0 + t)
        x = x + o.reshape(b, t, d) @ layer["wo"]
        z = _rms_norm(x, layer["ln2"]["g"])
        x = x + torch.relu(z @ layer["w1"]) @ layer["w2"]
    x = _rms_norm(x, params["ln_f"]["g"])
    return x @ params["head"], {"layers": cache["layers"], "pos": pos0 + t}


@torch.no_grad()
def generate(cfg: TransformerConfig, params, prompt, n_tokens: int,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Prefill, then ``n_tokens`` greedy (temperature 0) or sampled decode
    steps. Returns the generated tokens [B, n_tokens]. Sampling draws from
    ``generator`` (torch's stream, not JAX's)."""
    b, t_prompt = prompt.shape
    device = tree_leaves(params)[0].device
    if n_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.long, device=device)
    max_len = max_len or cfg.max_len
    if max_len > cfg.max_len:
        raise ValueError(
            f"max_len {max_len} exceeds the model's positional table "
            f"(cfg.max_len {cfg.max_len})")
    if t_prompt + n_tokens > max_len:
        raise ValueError(
            f"prompt ({t_prompt}) + n_tokens ({n_tokens}) exceeds max_len {max_len}")

    def pick(logits):
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(logits, dim=-1)

    cache = init_kv_cache(cfg, b, max_len, device)
    logits, cache = forward_with_cache(cfg, params, torch.as_tensor(prompt).to(device).long(),
                                       cache)
    out = [pick(logits[:, -1])]
    for _ in range(n_tokens - 1):
        logits, cache = forward_with_cache(cfg, params, out[-1][:, None], cache)
        out.append(pick(logits[:, 0]))
    return torch.stack(out, dim=1)
