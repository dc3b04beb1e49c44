"""chip_smoke.py's sequence-model phases (43-45 and 51), checked on the CPU
without a card: what they cover, how their bounds are counted, and the CPU
halves of their helpers (the batch-chunked twin, the route recorder, phase
51's processes at a small size).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omldm_tpu_torch.models import transformer as tt
from omldm_tpu_torch.ops import attention as tatt
from omldm_tpu_torch.parallel import SeqTrainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("phase", ["phase_flash_coverage", "phase_lm_moe",
                                   "phase_lm_f32_and_parity", "phase_sequence_family",
                                   "phase_seqpar"])
def test_sequence_phases_are_driven(cs, phase):
    """Each phase exists and main() reaches it (through
    phase_sequence_family, which main calls right after phase 10, and
    under --sequence-only)."""
    assert callable(getattr(cs, phase))
    src = (ROOT / "chip_smoke.py").read_text()
    main = src.split("def main")[1]
    family = src.split("def phase_sequence_family")[1].split("\ndef ")[0]
    assert "phase_sequence_family(" in main
    assert phase == "phase_sequence_family" or f"{phase}(" in family


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dh", [8, 12, 16, 36, 48, 80, 96, 100, 256])
def test_coverage_checks_every_new_width_square_and_ragged(cs, dtype, dh):
    cases = [c for c in cs.FLASH_COVERAGE_CHECKS
             if c[5] == dh and c[6] == dtype and not c[0].startswith("bh")]
    assert {(c[2], c[3]) for c in cases} == {(1024, 1024), (1000, 1100)}
    assert all(c[4] == (2 if dh == 256 else 4) for c in cases)


def test_coverage_checks_float32_128_and_wide_grid(cs):
    shapes = {c[0]: c[1:] for c in cs.FLASH_COVERAGE_CHECKS}
    assert shapes["f32_dh128"] == (8, 1024, 1024, 4, 128, "float32", 0, 0)
    assert shapes["f32_dh128_ragged"][1:3] == (1000, 1100)
    # every (dtype, built width, design) that run_dtype can reach is checked
    # on the card, and B * H past the grid's y limit on each design
    def triple(dt, dh):  # KERNEL_DESIGNS' design, at every width
        return (dt, tatt.kernel_width(dh), tatt.pass_design("fwd", dt, dh))

    reachable = {triple(dt, dh) for dt, dh in tatt.KERNEL_DESIGNS}
    assert len(reachable) == 12  # the cluster design past 256 in both dtypes included
    covered = {triple(getattr(torch, c[6]), c[5])
               for c in cs.FLASH_COVERAGE_CHECKS + cs.FLASH_WIDE_CHECKS}
    assert covered == reachable
    # pass by pass: the cluster design past 256 in all three passes and both dtypes
    def quad(which, dt, dh):
        return (which, dt, tatt.kernel_width(dh), tatt.pass_design(which, dt, dh))

    passes = ("fwd", "dq", "dkdv")
    reachable = {quad(w, dt, dh) for w in passes for dt, dh in tatt.KERNEL_DESIGNS}
    assert {q for q in reachable if q[3] == "cluster"} == {
        (w, dt, tatt.WIDE, "cluster") for w in passes
        for dt in (torch.bfloat16, torch.float32)}
    assert {quad(w, getattr(torch, c[6]), c[5]) for w in passes
            for c in cs.FLASH_COVERAGE_CHECKS + cs.FLASH_WIDE_CHECKS} == reachable
    # the Hopper instance at 64 with a width narrower than its TMA box
    assert any(tatt.KERNEL_DESIGNS[(getattr(torch, c[6]), c[5])] == "sm90" and c[5] % 64
               and tatt.kernel_width(c[5]) == 64 for c in cs.FLASH_COVERAGE_CHECKS)
    wide = {tatt.KERNEL_DESIGNS[(getattr(torch, c[6]), c[5])]
            for c in cs.FLASH_COVERAGE_CHECKS if c[1] * c[4] > 65_535}
    assert wide == {"sm90", "mma"}
    b, lq, lk, h = shapes["bh131072"][:4]
    assert b * h == 131_072 and shapes["bh131072"][4:6] == (64, "bfloat16")
    assert shapes["bh131072_mma"][:4] == (b, lq, lk, h)
    assert shapes["bh131072_mma"][4:6] == (8, "float32")


def test_coverage_time_shapes(cs):
    assert cs.FLASH_COVERAGE_TIME == [(8, 1024, 4, 128, "float32"), (2, 1024, 4, 8, "bfloat16"),
                                      (2, 1024, 4, 80, "bfloat16"), (2, 1024, 4, 256, "bfloat16"),
                                      (2, 1024, 4, 512, "bfloat16"), (2, 1024, 4, 512, "float32")]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dh", [320, 512])
def test_wide_checks_square_and_ragged(cs, dtype, dh):
    """The widths past 256 are checked at (2, 1024, 2, dh) and ragged
    1000/1100 in both dtypes; the earlier 40 cases (80 checks) are kept as
    they were."""
    cases = [c for c in cs.FLASH_WIDE_CHECKS if c[5] == dh and c[6] == dtype]
    assert {(c[1], c[2], c[3], c[4]) for c in cases} == {(2, 1024, 1024, 2), (2, 1000, 1100, 2)}
    assert tatt.kernel_width(dh) == tatt.WIDE
    assert len(cs.FLASH_COVERAGE_CHECKS) == 40


def test_wide_checks_rows_and_reach(cs):
    """Two more cases past 256: bf16 dh 300, whose rows are not whole
    16-byte groups (the cluster kernels' plain loads), at q_offset 100, and
    float32 dh 1100, past the cluster's reach (5 CTAs of 2 slices, each
    sweeping twice), at kv_offset 100 (masked rows, and clusters that sweep
    nothing); both at phase 43's (2, 1024, 2, dh) size."""
    rows = [c for c in cs.FLASH_WIDE_CHECKS if c[5] == 300]
    reach = [c for c in cs.FLASH_WIDE_CHECKS if c[5] == 1100]
    assert [c[1:] for c in rows] == [(2, 1024, 1024, 2, 300, "bfloat16", 100, 0)]
    assert [c[1:] for c in reach] == [(2, 1024, 1024, 2, 1100, "float32", 0, 100)]
    # kv_offset 100: the first 64-row query tile and the last 64-key tile
    # (keys 960-1023 need queries past 1059) have no tile to sweep
    lq, ko = reach[0][2], reach[0][8]
    assert ko > 64 and 960 + ko > lq - 1
    assert len(cs.FLASH_WIDE_CHECKS) == 11
    q = torch.zeros((2, 16, 2, 300), dtype=torch.bfloat16)
    assert not tatt._rows_of_16(q)
    assert tatt.kernel_design(q, q, q, q, which="dq") == "cluster"
    plan = tatt.wide_bwd_plan(torch.float32, 1100)
    assert (plan["slices"], plan["per_cta"], plan["cluster"]) == (9, 2, 5)
    assert plan["columns"][-1] == [(1024, 1100)]
    for dt, dh in ((torch.bfloat16, 320), (torch.float32, 512), (torch.float32, 1100)):
        assert tatt.wide_bwd_plan(dt, dh)["cluster"] <= tatt.CLUSTER_MAX


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_expected_kernels_by_pass(cs, dtype):
    """The kernel phase 8's and 43's timing checks each pass launched:
    past 256 the cluster design's forward, dQ and dK/dV."""
    names = ("flash_fwd", "flash_dq", "flash_dkdv")
    for dh in (320, 512, 1100):
        assert [cs.expected_kernel(tatt, n, dtype, dh) for n in names] == [
            "flash_fwd_cluster_kernel", "flash_dq_cluster_kernel", "flash_dkdv_cluster_kernel"]
    assert [cs.expected_kernel(tatt, n, dtype, 256) for n in names] == [
        "flash_fwd_kernel", "flash_dq_kernel", "flash_dkdv_kernel"]
    hopper = [f"{n}_sm90_kernel" for n in names] if dtype == torch.bfloat16 else \
        [f"{n}_kernel" for n in names]
    assert [cs.expected_kernel(tatt, n, dtype, 128) for n in names] == hopper


def test_phase43_runs_each_cluster_pass_twice(cs):
    """Phase 43 counts 12 cluster launches a case past 256: the forward,
    dQ and dK/dV each run twice (the second bitwise the first), causal and
    not. The ten such cases of FLASH_WIDE_CHECKS make 120."""
    wide = [c for c in cs.FLASH_WIDE_CHECKS if tatt.kernel_width(c[5]) == tatt.WIDE]
    per_case = [2 * 2 * sum(tatt.pass_design(w, getattr(torch, c[6]), c[5]) == "cluster"
                            for w in ("fwd", "dq", "dkdv")) for c in wide]
    assert len(wide) == 10 and per_case == [12] * 10
    assert 12 * len(wide) == sum(per_case) == 120
    coverage = (ROOT / "chip_smoke.py").read_text().split("def phase_flash_coverage")[1]
    coverage = coverage.split("\ndef ")[0]
    assert "check(ran == 12 * wide," in coverage
    checks = (ROOT / "chip_smoke.py").read_text().split("def run_flash_checks")[1].split("\ndef ")[0]
    assert "a second forward run differs from the first" in checks
    assert "a second backward run differs from the first" in checks

def test_misaligned_case_runs_mma_on_the_cpu_views(cs):
    """The misaligned case's views (built here on the CPU as chip_smoke
    builds them on the card) are one element off 16-byte alignment: a
    Hopper width (bf16 128) whose design is mma.sync."""
    [case] = [c for c in cs.FLASH_WIDE_CHECKS if c[0] in cs.FLASH_MISALIGNED]
    b, lq, lk, h, dh, dtype = case[1:7]
    assert (dh, dtype) == (128, "bfloat16")
    assert tatt.KERNEL_DESIGNS[(torch.bfloat16, dh)] == "sm90"
    flat = torch.zeros(b * lq * h * dh + 1, dtype=torch.bfloat16)
    view = flat[1:].view(b, lq, h, dh)
    assert view.data_ptr() % 16 == 2 and tatt.kernel_design(view, view, view, view) == "mma"


def test_float32_bound_uses_the_float32_peak_and_4_byte_elements(cs):
    pairs = 1024 * 1025 // 2
    ops_ms = 4 * 128 * pairs * 32 / 67e12 * 1e3
    ms, by = cs.flash_bound_ms("flash_fwd", 8, 1024, 1024, 4, 128, True, "float32")
    assert by == "operations" and ms == pytest.approx(ops_ms)
    bf16_ms, _ = cs.flash_bound_ms("flash_fwd", 8, 1024, 1024, 4, 128, True)
    assert ms > bf16_ms
    # dh 8 in bf16: the larger of its bf16 operations and its bytes
    ms8, _ = cs.flash_bound_ms("flash_dkdv", 2, 1024, 1024, 4, 8, True, "bfloat16")
    ops8 = 2 * 4 * 8 * pairs * 8 / 989e12 * 1e3
    bytes8 = (8 * 8 * 2 * 6 * 1024 + 2 * 8 * 1024 * 4) / 3.35e12 * 1e3
    assert ms8 == pytest.approx(max(ops8, bytes8))


def test_lm_moe_config_is_switch_base_8_on_the_lm(cs):
    assert cs.LM_MOE_CONFIG == dict(cs.LM_CONFIG, n_experts=8, capacity_factor=1.25, remat=True)
    assert cs.LM_MOE_PARITY_CONFIG == dict(cs.LM_PARITY_CONFIG, n_experts=4, remat=True)
    cfg = tt.TransformerConfig(**cs.LM_MOE_CONFIG)
    assert cfg.d_model // cfg.n_heads == 128 and cfg.dtype == torch.bfloat16


def test_graft_moe_config_is_the_jax_dry_run_width(cs):
    src = (ROOT / "__graft_entry__.py").read_text()
    moe = src.split("moe_cfg = TransformerConfig(")[1].split(")")[0]
    fields = dict(part.strip().split("=") for part in moe.replace("\n", " ").split(",")
                  if "=" in part)
    assert {k: int(v) for k, v in fields.items()} == cs.GRAFT_MOE_CONFIG
    assert cs.GRAFT_MOE_CONFIG["d_model"] // cs.GRAFT_MOE_CONFIG["n_heads"] == 8


def test_batch_chunked_twin_equals_the_whole_twin(cs):
    """The B*H = 131,072 case runs its twin over batch chunks; on the CPU
    the chunks reassemble the whole twin's out, lse and gradients
    bitwise."""
    g = torch.Generator().manual_seed(0)
    q, k, v, d = (torch.randn((12, 16, 3, 8), generator=g) for _ in range(4))
    out, lse = tatt.flash_attention_reference(q, k, v, True)
    c_out, c_lse = cs._batch_chunks(
        torch, lambda b0, b1, q, k, v: tatt.flash_attention_reference(q, k, v, True),
        q, k, v, heads=9)
    assert torch.equal(c_out, out) and torch.equal(c_lse, lse)
    delta = (d * out).sum(-1).transpose(1, 2).reshape(36, 16)
    lse2, delta2 = lse.reshape(12, 3, 16), delta.reshape(12, 3, 16)
    whole = tatt.flash_attention_bwd_reference(q, k, v, d, lse, delta, True)
    chunked = cs._batch_chunks(
        torch, lambda b0, b1, q, k, v, g: tatt.flash_attention_bwd_reference(
            q, k, v, g, lse2[b0:b1].reshape(-1, 16), delta2[b0:b1].reshape(-1, 16), True),
        q, k, v, d, heads=9)
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)


def test_route_recorder_reads_the_last_steps_forward(cs):
    """Phases 44-45 read each token's (expert, keep) from moe_route calls:
    the first n_layers calls of a step are its forward (remat's
    recomputation follows in the backward), and the recorder restores the
    module's function."""
    cfg = tt.TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                               max_len=16, n_experts=4, remat=True)
    tr = SeqTrainer(cfg, device="cpu", seed=0)
    tok = np.random.RandomState(0).randint(0, 32, size=(2, 8))
    orig = tt.moe_route
    with cs._moe_routes(tt) as routes:
        tr.step(tok, tok)
    assert tt.moe_route is orig
    assert len(routes) == 2 * cfg.n_layers
    for (e1, k1), (e2, k2) in zip(routes[:2], routes[:1:-1]):
        assert torch.equal(e1, e2) and torch.equal(k1, k2)
    assert routes[0][0].shape == (16,) and routes[0][1].dtype == torch.bool


@pytest.mark.parametrize("causal", [False, True])
def test_float32_cases_are_held_to_a_float64_twin(cs, causal):
    """A float32 case's twin takes float64 operands (reference_inputs) and
    then computes in float64, so the card's check reads the kernel's own
    rounding and no library's summation order; a bf16 case's operands pass
    as they are. The float64 twin agrees with the float32 one to float32
    rounding, and flash_errors compares in float64 against it."""
    g = torch.Generator().manual_seed(3)
    q, k, v, d = (torch.randn((2, 24, 2, 8), generator=g) for _ in range(4))
    rq, rk, rv, rd = cs.reference_inputs("float32", q, k, v, d)
    assert all(t.dtype == torch.float64 for t in (rq, rk, rv, rd))
    assert all(t is u for t, u in zip(cs.reference_inputs("bfloat16", q, k), (q, k)))
    out32, lse32 = tatt.flash_attention_reference(q, k, v, causal)
    out64, lse64 = tatt.flash_attention_reference(rq, rk, rv, causal)
    assert out64.dtype == lse64.dtype == torch.float64
    torch.testing.assert_close(out64, out32.double(), rtol=0, atol=1e-6)
    torch.testing.assert_close(lse64, lse32.double(), rtol=0, atol=1e-6)
    delta = (d * out32).sum(-1).transpose(1, 2).reshape(4, 24)
    grads32 = tatt.flash_attention_bwd_reference(q, k, v, d, lse32, delta, causal)
    grads64 = tatt.flash_attention_bwd_reference(rq, rk, rv, rd, lse32.double(),
                                                 delta.double(), causal)
    for a, b in zip(grads32, grads64):
        assert b.dtype == torch.float64
        err, l2, elem = cs.flash_errors(torch, a, b)
        assert 0 < err and l2 <= 2e-6 and elem <= 2e-5


def test_seqpar_legs_and_their_shapes(cs):
    """Phase 51's legs: (a) phase 43's bf16 shape (2, 4096, 4, 128) and the
    float32 (1, 1024, 4, 64) held to the JAX tests' 1e-5 / 1e-4; (b) phase
    44's Switch-Base-8 LM without remat at (2, 1, 1), capacity 8.0 for the
    parity; (c) the slice-2 LM at (1, 2, 2), and a float32 leg at 2 layers
    and context 256; every leg from --seed."""
    spec = cs.seqpar_spec(7)
    assert spec["seed"] == 7
    assert spec["kernel_cases"][0] == ("bfloat16", *cs.FLASH_TIME_SHAPES[1])
    assert spec["kernel_cases"][1] == ("float32", 1, 1024, 4, 64)
    assert cs.SEQPAR_F32_ATOL == (1e-5, 1e-4)
    assert spec["ep_config"] == dict(cs.LM_MOE_CONFIG, remat=False)
    assert spec["ep_config"]["n_experts"] == 8 and spec["ep_config"]["capacity_factor"] == 1.25
    # the JAX EP test's parity rule, capacity factor = experts (its 4.0 at 4):
    # every expert may take all of a process's tokens, so none drops
    assert spec["ep_capacity"] == 8.0 and spec["ep_mesh"] == (2, 1, 1)
    assert spec["lm_config"] == cs.LM_CONFIG and spec["lm_mesh"] == (1, 2, 2)
    assert (spec["batch"], spec["len"], spec["steps"]) == (cs.LM_BATCH, cs.LM_LEN, 3)
    assert spec["f32_config"] == dict(cs.LM_CONFIG, dtype="float32", n_layers=2)
    assert spec["f32_len"] == 256
    assert cs.SEQPAR_BF16_LOSS_ATOL == 0.15
    assert (cs.SEQPAR_F32_LOSS_ATOL, cs.SEQPAR_F32_PARAM_ATOL) == (1e-4, 2e-4)
    assert cs.SEQPAR_F32_FLOOR_FACTOR == 2
    # Ulysses at (1, 2, 2): 4 heads over tp 2 leave 2 a process, which sp 2 divides
    cfg = tt.TransformerConfig(**dict(cs.LM_CONFIG, seq_parallel="ulysses"))
    assert (cfg.n_heads // spec["lm_mesh"][2]) % spec["lm_mesh"][1] == 0


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_launch_rule(cs, sp):
    """The ring launches s + 1 forward kernels at sp index s under causal
    (sp without), as the port's schedule runs its live pairs; dQ and dK/dV
    as many; Ulysses one each (checked in phase 51 as ring_launches says)."""
    from omldm_tpu_torch.ops.ring_attention import live_pairs

    for s in range(sp):
        for causal in (True, False):
            live = sum(lv for *_, lv in live_pairs(s, sp, causal))
            assert cs.ring_launches(s, sp, causal) == live == (s + 1 if causal else sp)


@pytest.mark.parametrize("leg,mesh,calls", [
    (dict(seq_parallel="ring"), (1, 2, 2), 34),
    (dict(seq_parallel="ulysses"), (1, 2, 2), 50),
    (dict(n_experts=8), (2, 1, 1), 18),
    (dict(n_experts=8, remat=True), (2, 1, 1), 26),
    (dict(objective="classify"), (2, 2, 1), 20),
])
def test_group_calls_a_step(cs, leg, mesh, calls):
    """Group calls a step a process of the 4-layer LM: (1, 2, 2) ring, per
    layer the tp pair 2 + 2 and the ring 1 + 3, then the loss's sp sum and
    the sp gradient all-reduce; Ulysses 4 + 4 a layer for the ring's 1 + 3;
    the MoE at (2, 1, 1) 2 + 2 a layer (remat: the forward's twice), the
    loss over dp and the dp all-reduce; classify at (2, 2, 1) the sp mean
    and no loss sum over sp. tests/test_torch_seq_parallel.py holds the
    count to the processes' own on every mesh it runs."""
    assert cs.seqpar_group_calls(dict(cs.LM_CONFIG, **leg), *mesh) == calls


def test_kernel_leg_tolerances(cs):
    """Leg (a)'s checks: float32 by the JAX tests' absolute 1e-5 (output) and
    1e-4 (gradients); bf16 by phase 43's rel L2 and worst element."""
    ok = [(0.0, 0.0, 0.0)] * 4
    row = {"strategy": "ring", "dtype": "float32", "shape": [1, 1024, 4, 64], "sp_index": 1,
           "errors": {"single": ok, "plain_f32": [(9e-6, 0, 0)] + [(9e-5, 0, 0)] * 3}}
    cs._kernel_leg_checks(row)
    row["errors"]["plain_f32"] = [(2e-5, 0, 0)] + [(9e-5, 0, 0)] * 3
    with pytest.raises(cs.SmokeFailure, match="out against plain_f32"):
        cs._kernel_leg_checks(row)
    bf16 = dict(row, dtype="bfloat16", errors={"single": ok, "plain_f32": [(1.0, 9e-3, 9e-2)] * 4})
    cs._kernel_leg_checks(bf16)
    bf16["errors"]["single"] = ok[:3] + [(0.1, 2e-2, 1e-3)]
    with pytest.raises(cs.SmokeFailure, match="dv against single"):
        cs._kernel_leg_checks(bf16)


def test_f32_leg_held_a_leaf_and_a_step_at_a_time(cs):
    """The float32 LM leg's checks: a leaf may leave at most twice as many
    elements past 2e-4 as the single process on the CPU leaves in that same
    leaf, so the floor's count in a large leaf hides no fault in a small one
    (a 512-element gain); a step's loss within 1e-4, or twice the floor's
    distance at that step where that is larger."""
    import numpy as np

    def tree(head_past=0, gain_past=0, col=0):
        t = {"head": np.zeros((64, 32), np.float32),
             "layers": [{"ln1_g": np.ones(512, np.float32)}]}
        t["head"][:head_past, col] += 1e-3
        t["layers"][0]["ln1_g"][:gain_past] += 1e-3
        return t

    ref, floor = tree(), tree(head_past=10)
    losses, ref_l, floor_l = [[10.0, 7.00009, 7.0007]], [10.0, 7.0, 7.0], [10.0, 7.00005, 7.0004]
    got = cs._f32_leg_checks("f32_ring", losses, ref_l, floor_l, tree(20, col=1), ref, floor)
    assert got["past_by_leaf"] == {"head": [20, 10], "layers.0.ln1_g": [0, 0]}
    assert (got["params_past_atol"], got["cpu_floor_past_atol"]) == (20, 10)
    np.testing.assert_allclose(got["loss_limit_by_step"], [1e-4, 1e-4, 8e-4], rtol=1e-3)
    with pytest.raises(cs.SmokeFailure, match="1 elements of layers.0.ln1_g"):
        cs._f32_leg_checks("f32_ring", losses, ref_l, floor_l, tree(gain_past=1), ref, floor)
    with pytest.raises(cs.SmokeFailure, match="21 elements of head"):
        cs._f32_leg_checks("f32_ring", losses, ref_l, floor_l, tree(21, col=1), ref, floor)
    with pytest.raises(cs.SmokeFailure, match="step 1's loss"):
        cs._f32_leg_checks("f32_ring", [[10.0, 7.00015, 7.0]], ref_l, floor_l, ref, ref, floor)


def test_seqpar_phase_runs_on_the_cpu_at_a_small_size(cs, tmp_path):
    """Phase 51's processes and checks end to end on the CPU (the kernels'
    plain twins, so no launch is counted): 2 processes for legs (a)-(b), 4
    for (c), at a small width; every comparison and group-call count holds."""
    small = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=128,
                 dtype="bfloat16", loss_chunk=16)
    spec = {"seed": 0, "kernel_cases": [("bfloat16", 1, 64, 4, 16), ("float32", 1, 64, 4, 8)],
            "ep_config": dict(small, n_experts=4, capacity_factor=1.25, remat=False),
            "ep_capacity": 4.0, "ep_mesh": [2, 1, 1], "lm_config": small, "lm_mesh": [1, 2, 2],
            "batch": 4, "len": 32, "steps": 3, "f32_config": dict(small, dtype="float32"),
            "f32_len": 16}
    launched = cs.phase_seqpar(torch, tatt, 0, 1.0, "cpu", tmp_path, spec, device="cpu")
    assert launched == dict.fromkeys(tatt.launches, 0)
