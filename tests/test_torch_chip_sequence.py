"""chip_smoke.py's sequence-model phases (43-45), checked on the CPU without
a card: what they cover, how their bounds are counted, and the CPU halves
of their helpers (the batch-chunked twin, the route recorder).
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
                                   "phase_lm_f32_and_parity", "phase_sequence_family"])
def test_sequence_phases_are_driven(cs, phase):
    """Each phase exists and main() reaches it (through
    phase_sequence_family, which main calls right after phase 10)."""
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
    def triple(dt, dh):
        return (dt, tatt.kernel_width(dh), tatt.KERNEL_DESIGNS[(dt, dh)])

    reachable = {triple(dt, dh) for dt, dh in tatt.KERNEL_DESIGNS}
    assert len(reachable) == 12  # the wide instance in both dtypes included
    covered = {triple(getattr(torch, c[6]), c[5])
               for c in cs.FLASH_COVERAGE_CHECKS + cs.FLASH_WIDE_CHECKS}
    assert covered == reachable
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
    """The wide instance is checked at (2, 1024, 2, dh) and ragged
    1000/1100 in both dtypes; the earlier 40 cases (80 checks) are kept as
    they were."""
    cases = [c for c in cs.FLASH_WIDE_CHECKS if c[5] == dh and c[6] == dtype]
    assert {(c[1], c[2], c[3], c[4]) for c in cases} == {(2, 1024, 1024, 2), (2, 1000, 1100, 2)}
    assert tatt.kernel_width(dh) == tatt.WIDE
    assert len(cs.FLASH_COVERAGE_CHECKS) == 40


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
