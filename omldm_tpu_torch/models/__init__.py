"""Sequence-model family: the transformer (dense MLP or switch-MoE blocks,
optional remat) and its KV-cache decoding (dense configs), single device."""

from omldm_tpu_torch.models.decode import forward_with_cache, generate, init_kv_cache
from omldm_tpu_torch.models.transformer import (
    TransformerConfig,
    init_transformer,
    lm_loss,
    params_from_numpy,
    params_to_numpy,
    transformer_forward,
)

__all__ = [
    "TransformerConfig",
    "init_transformer",
    "transformer_forward",
    "lm_loss",
    "params_from_numpy",
    "params_to_numpy",
    "init_kv_cache",
    "forward_with_cache",
    "generate",
]
