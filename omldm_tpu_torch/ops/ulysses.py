"""Ulysses sequence parallelism: an all_to_all head/sequence re-shard around attention.

Counterpart of ``omldm_tpu/ops/ulysses.py``, the second long-context
strategy beside ring attention (``ops.ring_attention``). One
``all_to_all`` over the ``sp`` group turns the sequence-split ``[B, L/sp,
H, Dh]`` chunks into head-split ``[B, L, H/sp, Dh]`` ones, each process
runs ``ops.attention.attention`` (the flash kernels on CUDA tensors, their
plain twins on CPU tensors) over the whole sequence for its heads, and a
second ``all_to_all`` restores the sequence split. Both exchanges are
differentiable (``parallel.multihost.AllToAll``: the backward is the
inverse exchange). Needs ``n_heads % sp == 0``.
"""

from __future__ import annotations

import torch.distributed as dist

from omldm_tpu_torch.ops.attention import attention, flash_attention
from omldm_tpu_torch.parallel import multihost


def ulysses_attention(q, k, v, group, causal: bool = False):
    """Per-process Ulysses attention. q, k, v: this process's chunk [B, Lc,
    H, Dh]; returns its chunk of the output [B, Lc, H, Dh]."""
    n = dist.get_world_size(group)
    if n == 1:
        return attention(q, k, v, causal=causal)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"n_heads {h} not divisible by sp axis size {n}")
    # [B, Lc, H, Dh] -> [B, L, H/n, Dh]: heads out, sequence chunks in (in
    # rank order, which is sequence order)
    qg, kg, vg = (multihost.AllToAll.apply(x, 2, 1, group) for x in (q, k, v))
    out = attention(qg, kg, vg, causal=causal)
    return multihost.AllToAll.apply(out, 1, 2, group)  # back to [B, Lc, H, Dh]


def ulysses_attention_sharded(q, k, v, mesh, causal: bool = False):
    """Whole-array wrapper (testing): every process passes the global [B,
    L, H, Dh] inputs and gets the global output back (gathered over
    ``mesh``'s sp group, not differentiated)."""
    group = mesh.groups["sp"]
    if group is None:
        return flash_attention(q, k, v, causal)
    n, s = dist.get_world_size(group), dist.get_rank(group)
    lc = q.shape[1] // n
    out = ulysses_attention(*(x[:, s * lc:(s + 1) * lc] for x in (q, k, v)), group, causal)
    return multihost.all_gather(out.detach(), group, dim=1)
