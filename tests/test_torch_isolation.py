"""The port stands alone: it imports neither JAX nor the JAX package, runs on
CUDA unless asked for the CPU, and refuses what it has not ported yet."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.models.transformer import TransformerConfig
from omldm_tpu_torch.parallel import SeqTrainer
from omldm_tpu_torch.runtime import StreamJob

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "omldm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, omldm_tpu_torch, omldm_tpu_torch.runtime.job\n"
        "import omldm_tpu_torch.models, omldm_tpu_torch.parallel\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'omldm_tpu' or m.startswith('omldm_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "omldm_tpu"}, roots


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits nonzero and prints no result line when CUDA is
    unavailable (on a host with a card this would run the whole smoke)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_stream_shape():
    """The smoke's stream: one Create, every tenth record a forecast, a
    Query at the requested position, 28 features a record."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    events = chip_smoke.make_events(90, seed=0, query_at=45)
    streams = [s for s, _ in events]
    assert streams[0] == "requests" and streams.count("requests") == 2
    data = [s for s in streams if s != "requests"]
    assert data.count("trainingData") == 90 and data.count("forecastingData") == 10
    assert all(s == "forecastingData" for s in data[9::10])
    record = json.loads(events[1][1])
    assert len(record["numericalFeatures"]) == 28 and record["target"] in (0.0, 1.0)


def test_default_device_is_cuda():
    """No device means CUDA; without a usable card that raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        assert StreamJob().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamJob()
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamJob(device="cuda")


def test_seq_trainer_default_device_is_cuda():
    """SeqTrainer with no device wants CUDA and, without a card, raises
    instead of falling back to the CPU."""
    cfg = TransformerConfig(vocab_size=16, d_model=32, n_heads=1, n_layers=1, d_ff=32,
                            max_len=8)
    if torch.cuda.is_available():
        assert SeqTrainer(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SeqTrainer(cfg)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("phase", [
    "phase_build", "phase_flash_check", "phase_flash_time", "phase_lm",
    "phase_lm_parity", "phase_lm_profile",
])
def test_chip_smoke_has_the_lm_phases(phase):
    chip_smoke = _chip_smoke()
    assert callable(getattr(chip_smoke, phase))
    assert f"{phase}(" in (ROOT / "chip_smoke.py").read_text().split("def main")[1]


def test_chip_smoke_flash_checks_cover_the_slice_shapes():
    """The kernel checks cover the slice, the 4096-context LM, the flash
    benchmark's shape, ragged lengths, a query offset, fully masked rows
    and float32; the LM phase runs the benchmarked LM's full width."""
    chip_smoke = _chip_smoke()
    shapes = {c[0]: c[1:] for c in chip_smoke.FLASH_CHECKS}
    assert shapes["slice"] == (8, 1024, 1024, 4, 128, "bfloat16", 0, 0)
    assert shapes["lm4096"][:5] == (2, 4096, 4096, 4, 128)
    assert shapes["bench8192"][:5] == (4, 8192, 8192, 8, 64)
    assert shapes["ragged"][1:3] == (1000, 1100)
    assert shapes["q_offset256"][6] == 256
    assert shapes["masked_rows"][7] > shapes["masked_rows"][6]
    assert shapes["f32"][5] == "float32"
    assert chip_smoke.LM_CONFIG == dict(
        vocab_size=8192, d_model=512, n_heads=4, n_layers=4, d_ff=2048, max_len=2048,
        dtype="bfloat16", loss_chunk=1024)
    assert (chip_smoke.LM_BATCH, chip_smoke.LM_LEN) == (8, 1024)


def test_chip_smoke_flash_bound():
    """Bound of the causal forward at the slice's shape: 4 * Dh flops per
    kept (query, key) pair over 989 TFLOP/s against q, k, v, out and lse
    over 3.35 TB/s -- the bytes win at L = 1024."""
    chip_smoke = _chip_smoke()
    pairs = 1024 * 1025 // 2
    ops_ms = 4 * 128 * pairs * 32 / 989e12 * 1e3
    bytes_ms = (4 * 8 * 1024 * 4 * 128 * 2 + 32 * 1024 * 4) / 3.35e12 * 1e3
    ms, by = chip_smoke.flash_bound_ms("flash_fwd", 8, 1024, 1024, 4, 128, True)
    assert by == "bytes" and ms == pytest.approx(bytes_ms) and bytes_ms > ops_ms
    ms, by = chip_smoke.flash_bound_ms("flash_dkdv", 2, 4096, 4096, 4, 128, True)
    assert by == "operations"


@pytest.mark.parametrize("fault", ["rows", "element"])
@pytest.mark.parametrize("causal", [False, True])
def test_chip_smoke_flash_tolerance_catches_wrong_rows(causal, fault):
    """The card's kernel-vs-twin check passes bf16 rounding of the output,
    and fails an output 10% off on the later half of the rows (where a
    causal output is smallest), or one element off by a quarter of its own
    size plus the tensor's rms."""
    from omldm_tpu_torch.ops.attention import flash_attention_reference

    chip_smoke = _chip_smoke()
    l2_tol, elem_tol, _ = chip_smoke.FLASH_TOL["bfloat16"]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 256, 2, 32), generator=g) for _ in range(3))
    ref, _ = flash_attention_reference(q, k, v, causal)
    _, l2, elem = chip_smoke.flash_errors(torch, ref.to(torch.bfloat16), ref)
    assert l2 <= l2_tol / 2 and elem <= elem_tol / 2
    wrong = ref.clone()
    if fault == "rows":
        wrong[:, 128:] *= 1.1
    else:
        rms = ref.square().mean().sqrt()
        wrong[1, 200, 1, 7] += 0.25 * (ref[1, 200, 1, 7].abs() + rms)
    _, l2, elem = chip_smoke.flash_errors(torch, wrong.to(torch.bfloat16), ref)
    assert not (l2 <= l2_tol and elem <= elem_tol)


def test_chip_smoke_copy_task_stream():
    chip_smoke = _chip_smoke()
    tok, tgt, mask = chip_smoke.copy_task_batches(3, 4, 16, 100, seed=0)
    assert tok.shape == tgt.shape == mask.shape == (3, 4, 16)
    assert (tok[:, :, 4:] == tok[:, :, :-4]).all() and (tgt[:, :, :-1] == tok[:, :, 1:]).all()
    assert len({tuple(r[:4]) for r in tok.reshape(-1, 16)}) <= 16


@pytest.mark.parametrize("option", [
    {"serving": "on"}, {"overload": "on"}, {"lifecycle": "on"},
    {"telemetry": "on"}, {"events": "on"}, {"ingest": "on"},
    {"chaos": "seed=1,drop=0.1"}, {"checkpointing": True}, {"cohort": "on"},
    {"cohort_shards": "auto"},
])
def test_unported_job_plane_raises(option):
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        StreamJob(JobConfig(**option), device="cpu")


@pytest.mark.parametrize("option", [
    {"compute_dtype": "bfloat16"}, {"mesh_shape": {"dp": 2, "hub": 1}},
    {"cohort_min": 4}, {"checkpoint_dir": "ckpt"},
])
def test_jax_only_job_knobs_do_not_exist(option):
    """Knobs of the JAX JobConfig that the port has no use for are not
    silently accepted."""
    with pytest.raises(TypeError):
        JobConfig(**option)


def test_profile_functions_exist():
    """Every function chip_smoke.py --profile reports is defined where it
    says, so a rename cannot turn a row into a silent zero."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for label, suffix, name in chip_smoke.PROFILE_FUNCS:
        source = (ROOT / "omldm_tpu_torch" / suffix).read_text()
        assert f"def {name}(" in source, label


def _create(learner="PA", preps=("StandardScaler",), **tc):
    return json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": learner, "hyperParameters": {"C": 0.01}},
        "preProcessors": [{"name": p} for p in preps],
        "trainingConfiguration": dict({"protocol": "Asynchronous"}, **tc),
    })


@pytest.mark.parametrize("request_json,reason", [
    (_create(learner="ORR"), "learner 'ORR' is not yet ported"),
    (_create(learner="Nope"), "unknown learner"),
    (_create(preps=("MinMaxScaler",)), "preprocessor 'MinMaxScaler' is not yet ported"),
    (_create(protocol="Synchronous"), "protocol 'Synchronous' is not yet ported"),
    (_create(guard=True), "guard"),
    (_create(serving={"maxBatch": 8}), "serving"),
    (_create(comm={"codec": "topk"}), "codec"),
    (_create(comm={"reliable": True}), "reliable"),
    (_create(engine="spmd"), "spmd"),
])
def test_control_gate_rejects_unported(request_json, reason):
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", request_json)])
    [entry] = job.dead_letter.entries
    assert entry["reason"] == "rejected_request"
    assert reason in entry["detail"]
    assert job.pipeline_manager.live_pipelines == []


def test_parallelism_one_forces_an_unported_protocol():
    job = StreamJob(JobConfig(parallelism=1), device="cpu")
    job.run([("requests", _create())])
    assert "CentralizedTraining" in job.dead_letter.entries[0]["detail"]


def test_unknown_protocol_falls_back_to_asynchronous():
    """usePallas is accepted; unknown protocol keys fall back to
    Asynchronous, as in the reference."""
    create = json.loads(_create(protocol="NoSuchProtocol"))
    create["learner"]["hyperParameters"]["usePallas"] = False
    rows = [
        ("trainingData", json.dumps({"numericalFeatures": [float(i % 3), 1.0],
                                     "target": float(i % 2)}))
        for i in range(40)
    ]
    job = StreamJob(JobConfig(parallelism=2, batch_size=8), device="cpu")
    report = job.run([("requests", json.dumps(create))] + rows)
    assert not job.dead_letter.entries
    assert report.statistics[0].protocol == "Asynchronous"
    assert report.statistics[0].fitted > 0
