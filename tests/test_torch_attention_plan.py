"""What the Hopper flash kernels (forward, dQ, dK/dV) visit, and the TMA tensor maps they encode,
restated on the host (``sm90_tile_plan``, ``tensor_map_geometry`` in
omldm_tpu_torch.ops.attention) and held to the JAX package's
``_causal_block_needed`` and to the mask by brute force.

For every case, causal or not:
- the (outer, inner) tiles visited are exactly the pairs the JAX package's
  ``_causal_block_needed`` keeps at the sm90 tile sizes;
- a consumer warpgroup skips a tile exactly when the JAX rule drops the
  pair at its 64-row (64-key) granularity;
- a consumer masks a tile ("cut") exactly when some pair of it is masked
  (past Lk or above the diagonal in the forward, whose rows past Lq are
  never stored; past Lq or above the diagonal in dK/dV, whose keys past Lk
  are never stored);
- CTAs are ordered longest causal sweep first.
"""

import numpy as np
import pytest
import torch

from omldm_tpu.ops import attention as jatt
from omldm_tpu_torch.ops import attention as tatt

# (Lq, Lk, q_offset, kv_offset): the LM's shape, ragged Lq != Lk, a query
# offset (a later chunk), a key offset that leaves rows seeing no key, one
# short tile, and Lq past Lk
CASES = [(1024, 1024, 0, 0), (1000, 1100, 0, 0), (512, 768, 256, 0), (256, 256, 0, 100),
         (48, 48, 0, 0), (300, 200, 0, 0), (200, 600, 0, 300)]
IDS = ["lm", "ragged", "q_offset256", "kv_offset100", "short48", "lq_past_lk", "kv_offset300"]


def _masked(rows, cols, lq, lk, causal, qo, ko, check_rows, check_cols):
    r, c = np.meshgrid(rows, cols, indexing="ij")
    m = np.zeros(r.shape, bool)
    if check_rows:
        m |= r >= lq
    if check_cols:
        m |= c >= lk
    if causal:
        m |= qo + r < ko + c
    return m


def _check_query_major_plan(which, tile, case, causal):
    """The forward and dQ plans: CTAs over query tiles, sweeping key tiles."""
    lq, lk, qo, ko = case
    bq, bk = tile
    plan = tatt.sm90_tile_plan(which, lq, lk, causal, qo, ko)
    n_q, n_k = -(-lq // bq), -(-lk // bk)
    assert [o for o, _ in plan] == list(range(n_q - 1, -1, -1))
    for qt, tiles in plan:
        visited = [kt for kt, _ in tiles]
        needed = [kt for kt in range(n_k)
                  if not causal or jatt._causal_block_needed(qt, kt, bq, bk, qo, ko)]
        assert visited == needed
        for kt, states in tiles:
            for w, state in enumerate(states):
                r0 = qt * bq + w * (bq // 2)
                keep = not causal or jatt._causal_block_needed(r0 // (bq // 2), kt, bq // 2, bk, qo, ko)
                assert (state == "skip") == (not keep)
                if state != "skip":
                    m = _masked(np.arange(r0, r0 + bq // 2), np.arange(kt * bk, kt * bk + bk),
                                lq, lk, causal, qo, ko, check_rows=False, check_cols=True)
                    assert (state == "cut") == bool(m.any()), (qt, kt, w)
    if causal:
        lengths = [len(t) for _, t in plan]
        assert lengths == sorted(lengths, reverse=True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_plan(case, causal):
    _check_query_major_plan("fwd", tatt.SM90_FWD_TILE, case, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dq_plan(case, causal):
    """dQ: 128-row Q tiles sweeping 64-key tiles; its rows past Lq are never
    stored, so only keys past Lk and the diagonal cut a tile."""
    _check_query_major_plan("dq", tatt.SM90_DQ_TILE, case, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dkdv_plan(case, causal):
    lq, lk, qo, ko = case
    bk, bq = tatt.SM90_DKDV_TILE
    plan = tatt.sm90_tile_plan("dkdv", lq, lk, causal, qo, ko)
    n_q, n_k = -(-lq // bq), -(-lk // bk)
    assert [o for o, _ in plan] == list(range(n_k))
    for kt, tiles in plan:
        visited = [qt for qt, _ in tiles]
        needed = [qt for qt in range(n_q)
                  if not causal or jatt._causal_block_needed(qt, kt, bq, bk, qo, ko)]
        assert visited == needed
        for qt, states in tiles:
            for w, state in enumerate(states):
                kw0 = kt * bk + w * (bk // 2)
                keep = not causal or jatt._causal_block_needed(qt, kw0 // (bk // 2), bq, bk // 2, qo, ko)
                assert (state == "skip") == (not keep)
                if state != "skip":
                    m = _masked(np.arange(qt * bq, qt * bq + bq), np.arange(kw0, kw0 + bk // 2),
                                lq, lk, causal, qo, ko, check_rows=True, check_cols=False)
                    assert (state == "cut") == bool(m.any()), (kt, qt, w)
    if causal:
        lengths = [len(t) for _, t in plan]
        assert lengths == sorted(lengths, reverse=True)


def test_plan_counts_at_the_lm_shape():
    """(8, 1024, 4, 128) causal: 36 of the 64 (Q tile, key tile) pairs a head
    are visited by the forward, 8 of them cut by the diagonal; dK/dV visits
    72 (key tile, Q tile) pairs a head."""
    fwd = tatt.sm90_tile_plan("fwd", 1024, 1024, True)
    assert sum(len(t) for _, t in fwd) == 36
    assert sum(s == ("cut", "cut") for _, t in fwd for _, s in t) == 8
    dkdv = tatt.sm90_tile_plan("dkdv", 1024, 1024, True)
    assert sum(len(t) for _, t in dkdv) == 72


def test_dq_plan_counts_at_the_lm_shape():
    """(8, 1024, 4, 128) causal at the dQ tile (128 rows x 64 keys): 72 (Q
    tile, key tile) pairs a head; 8 Q tiles each cut by the diagonal on
    their last two key tiles, consumer 0 skipping the last one."""
    dq = tatt.sm90_tile_plan("dq", 1024, 1024, True)
    assert sum(len(t) for _, t in dq) == 72
    states = [s for _, t in dq for _, pair in t for s in pair]
    assert (states.count("full"), states.count("cut"), states.count("skip")) == (120, 16, 8)


def test_plan_refuses_unknown_pass():
    with pytest.raises(ValueError, match="fwd', 'dq' or 'dkdv"):
        tatt.sm90_tile_plan("bwd", 64, 64, True)


@pytest.mark.parametrize("dh", [64, 128])
def test_tensor_map_of_packed_qkv_views(dh):
    """transformer.py hands q, k and v over as views into [B, L, 3, H, Dh]:
    the maps see dimensions (Dh, H, L, B) and the projection's strides."""
    b, l, h = 2, 48, 4
    qkv = torch.zeros((b, l, 3, h, dh), dtype=torch.bfloat16)
    for i in range(3):
        dims, strides = tatt.tensor_map_geometry(qkv[:, :, i])
        assert dims == (dh, h, l, b)
        assert strides == (dh * 2, 3 * h * dh * 2, l * 3 * h * dh * 2)
    assert tatt._check_kernel_inputs("flash_attention", [("q", qkv[:, :, 0])]) == torch.bfloat16


def test_tensor_map_of_contiguous_and_transposed_views():
    t = torch.zeros((3, 40, 2, 64), dtype=torch.bfloat16)
    assert tatt.tensor_map_geometry(t) == ((64, 2, 40, 3), (128, 256, 40 * 256))
    u = torch.zeros((3, 2, 40, 64), dtype=torch.bfloat16).transpose(1, 2)  # heads outside rows
    assert tatt.tensor_map_geometry(u) == ((64, 2, 40, 3), (40 * 128, 128, 80 * 128))


@pytest.mark.parametrize("strides", [(2 ** 40, 64, 64, 1), (64 * 72, 72, 36, 1),
                                     (4096, 64, 64, 2)], ids=["huge", "not16", "dh_stride"])
def test_tensor_map_refuses(strides):
    t = torch.empty_strided((2, 1, 1, 64), strides, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="TMA tensor map"):
        tatt.tensor_map_geometry(t)
