"""Ring attention: exact attention over a sequence split across an ``sp`` process group.

Counterpart of ``omldm_tpu/ops/ring_attention.py``. Process ``s`` of the
group holds the contiguous chunk of queries, keys and values at absolute
positions ``[s * Lc, (s + 1) * Lc)``. The K/V chunks travel one hop a step
around the ring (``parallel.multihost.ring_shift``, the JAX ``ppermute``),
and each process attends its queries to every chunk as it passes:

- forward: each live chunk pair runs the flash forward kernel
  (``ops.attention.flash_attention`` with ``return_lse``) at ``q_offset = s
  * Lc`` and ``kv_offset = src * Lc``, and the pair's output joins the
  running one by their logsumexps, starting from the diagonal pair (every
  causal row keeps a key there, so no merge meets two empty rows);
- causal pairs with ``src > s`` are wholly masked and launch nothing (the
  JAX sweep computes them and adds zero: the same result);
- backward: ``delta = rowsum(dO * O)`` of the merged output and the merged
  logsumexp give every live pair's dQ and dK/dV kernels the global softmax;
  each chunk's dK/dV accumulators travel with it and take one more hop
  home, so every process ends with the gradients of its own chunk.

On CPU tensors the same schedule runs the kernels' plain twins, which is
this function's plain version. Memory stays O(Lc) a process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from omldm_tpu_torch.ops.attention import flash_attention, flash_attention_bwd, row_delta
from omldm_tpu_torch.parallel import multihost


def live_pairs(s: int, n: int, causal: bool):
    """The ring's steps at process ``s`` of ``n``: (step, source chunk,
    whether the pair launches a kernel). Under causal only ``src <= s``
    keeps a key, so ``s + 1`` pairs launch; without, all ``n``."""
    return [(t, (s - t) % n, not causal or (s - t) % n <= s) for t in range(n)]


def _rows(lse: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, Lc(, 1)] row statistics as [B, Lc, H, 1], beside an output."""
    return lse.reshape(b, h, -1).transpose(1, 2).unsqueeze(-1)


class RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool):
        b, lc, h, _ = q.shape
        n, s = dist.get_world_size(group), dist.get_rank(group)
        out = lse = None
        kv = torch.stack((k, v))
        for step, src, live in live_pairs(s, n, causal):
            if step:
                kv = multihost.ring_shift(kv, group)
            if not live:
                continue
            o_c, lse_c = flash_attention(q, kv[0], kv[1], causal, s * lc, src * lc,
                                         return_lse=True)
            lse_c = lse_c.reshape(b * h, lc)
            if out is None:  # the diagonal pair: step 0
                out, lse = o_c.float(), lse_c
                continue
            new = torch.logaddexp(lse, lse_c)
            out = (out * torch.exp(_rows(lse - new, b, h))
                   + o_c.float() * torch.exp(_rows(lse_c - new, b, h)))
            lse = new
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        b, lc, h, _ = q.shape
        n, s = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous()
        delta = row_delta(g, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = torch.stack((k, v))
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for step, src, live in live_pairs(s, n, causal):
            if step:
                kv = multihost.ring_shift(kv, group)
                dkv = multihost.ring_shift(dkv, group)
            if not live:
                continue
            dq_c, dk_c, dv_c = flash_attention_bwd(q, kv[0], kv[1], g, lse, delta, causal,
                                                   s * lc, src * lc)
            dq += dq_c.float()
            dkv[0] += dk_c.float()
            dkv[1] += dv_c.float()
        if n > 1:  # the accumulators' last hop: home to the chunk's owner
            dkv = multihost.ring_shift(dkv, group)
        return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype), None, None


def ring_attention(q, k, v, group, causal: bool = False) -> torch.Tensor:
    """Per-process ring attention. q, k, v: this process's chunk [B, Lc, H,
    Dh] of a sequence split over ``group`` in rank order; returns the chunk
    of the attention output, differentiable."""
    return RingAttention.apply(q, k, v, group, causal)


def _chunk(x: torch.Tensor, group) -> torch.Tensor:
    n, s = dist.get_world_size(group), dist.get_rank(group)
    lc = x.shape[1] // n
    return x[:, s * lc:(s + 1) * lc]


def ring_attention_sharded(q, k, v, mesh, causal: bool = False) -> torch.Tensor:
    """Whole-array wrapper (testing): every process passes the global [B,
    L, H, Dh] inputs, runs the ring on its chunk over ``mesh``'s sp group
    and gets the global output back (gathered over the group). The gather
    is not differentiated: take gradients through :func:`ring_attention` on
    the chunks."""
    group = mesh.groups["sp"]
    if group is None:
        return flash_attention(q, k, v, causal)
    out = ring_attention(_chunk(q, group), _chunk(k, group), _chunk(v, group), group, causal)
    return multihost.all_gather(out.detach(), group, dim=1)
