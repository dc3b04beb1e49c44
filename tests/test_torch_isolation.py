"""The port stands alone: it imports neither JAX nor the JAX package, runs on
CUDA unless asked for the CPU, and refuses what it has not ported yet."""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
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


PACKAGE_FILES = sorted((ROOT / "omldm_tpu_torch").rglob("*.py"))
# a path into the JAX package: "omldm_tpu" as a whole path component
JAX_PACKAGE_PATH = re.compile(r"(^|[/\\])omldm_tpu([/\\]|$)")


def _path_strings(path: Path):
    """String constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            yield node.value


@pytest.mark.parametrize("path", PACKAGE_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_package(path):
    """No port module names a file of the JAX package (its dispatch table
    in particular): the port keeps its own copy of what it reads."""
    bad = [s for s in _path_strings(path) if JAX_PACKAGE_PATH.search(s)]
    assert not bad, bad


def test_path_scan_catches_a_jax_package_path(tmp_path):
    module = tmp_path / "m.py"
    module.write_text('"""Reads omldm_tpu/ops/x.json."""\n'
                      'T = os.path.join(ROOT, "omldm_tpu", "ops", "sparse_dispatch.json")\n'
                      'U = "omldm_tpu_torch/ops/sparse_dispatch.json"\n')
    assert [s for s in _path_strings(module) if JAX_PACKAGE_PATH.search(s)] == ["omldm_tpu"]


def test_sparse_stream_opens_nothing_in_the_jax_package():
    """A sparse stream on the CPU, its scatter dispatched through the
    calibration table, under an audit hook that records every file opened:
    none lies under omldm_tpu/."""
    code = textwrap.dedent("""
        import json, os, sys
        opened = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
                opened.append(os.path.realpath(os.fsdecode(args[0])))
        sys.addaudithook(hook)
        from omldm_tpu_torch.config import JobConfig
        from omldm_tpu_torch.runtime import StreamJob
        create = {"id": 0, "request": "Create",
                  "learner": {"name": "PA", "dataStructure": {
                      "sparse": True, "nFeatures": 13 + 256, "hashSpace": 256, "maxNnz": 16}},
                  "trainingConfiguration": {"protocol": "Asynchronous"}}
        rows = [("trainingData", json.dumps({"numericalFeatures": [1.0] * 13,
                 "categoricalFeatures": ["a%d" % i], "target": float(i % 2)}))
                for i in range(64)]
        job = StreamJob(JobConfig(parallelism=2, batch_size=8), device="cpu")
        report = job.run([("requests", json.dumps(create))] + rows)
        assert report.statistics[0].fitted > 0
        assert any(p.endswith("sparse_dispatch.json") for p in opened), "table not read"
        jax_pkg = os.path.realpath("omldm_tpu") + os.sep
        bad = [p for p in opened if p.startswith(jax_pkg)]
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "OMLDM_SPARSE_SCATTER"}
    env.pop("OMLDM_SPARSE_SCATTER_TABLE", None)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=300)


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


@pytest.mark.parametrize("phase", [
    "phase_sparse_check", "phase_sparse_time", "phase_calibrate", "phase_sparse",
    "phase_avazu",
])
def test_chip_smoke_has_the_sparse_phases(phase):
    chip_smoke = _chip_smoke()
    assert callable(getattr(chip_smoke, phase))
    assert f"{phase}(" in (ROOT / "chip_smoke.py").read_text().split("def main")[1]


def test_chip_smoke_sparse_shapes():
    """The kernel checks cover one record and a micro-batch of the Criteo
    slice (K = maxNnz 40 + the bias slot), the experiment's 4096 x 39 and the
    outer entry point at Avazu's width; the stream's Create is the Criteo
    configuration."""
    chip_smoke = _chip_smoke()
    assert chip_smoke.CRITEO_DIM == 13 + 2 ** 18
    assert chip_smoke.SPARSE_CHECKS == [(1, 41), (256, 41), (4096, 39)]
    assert chip_smoke.OUTER_CHECK == (255, 22, 2 ** 20 + 1, 2)
    events = chip_smoke.criteo_events(40, seed=0, query_at=20)
    create = json.loads(events[0][1])
    assert create["learner"]["dataStructure"] == {
        "sparse": True, "nFeatures": 13 + 2 ** 18, "hashSpace": 2 ** 18, "maxNnz": 40}
    assert create["learner"]["hyperParameters"] == {"C": 0.1, "variant": "PA-II"}
    data = [(s, json.loads(p)) for s, p in events[1:] if s != "requests"]
    assert len(data) == 40 and [s for s, _ in data].count("forecastingData") == 4
    assert all(s == "forecastingData" for s, _ in data[9::10])
    rec = data[0][1]
    assert len(rec["numericalFeatures"]) == 13 and len(rec["categoricalFeatures"]) == 26
    assert rec["target"] in (0.0, 1.0) and rec["categoricalFeatures"][3].startswith("f3_v")
    avazu = chip_smoke.avazu_events(20, seed=0)
    assert json.loads(avazu[0][1])["learner"]["name"] == "Softmax"
    assert len(json.loads(avazu[1][1])["categoricalFeatures"]) == 21


def test_chip_smoke_scatter_bound():
    """idx, val and coef read once, w read and written once, over 3.35 TB/s."""
    chip_smoke = _chip_smoke()
    d = 13 + 2 ** 18
    ms, by = chip_smoke.scatter_bound_ms(4096, 39, d, 1)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 4096 * 39 + 4096 + 2 * d) * 4 / 3.35e12 * 1e3)


def test_chip_smoke_inplace_scatter_bound():
    """In place: idx, val and coef read once, and each distinct in-range row
    that a nonzero update lands on read and written once (C classes)."""
    chip_smoke = _chip_smoke()
    w, idx, coef, val = chip_smoke._scatter_inputs(torch, 64, 41, 13 + 2 ** 12 + 1, 1, "criteo",
                                                   seed=3, device="cpu")
    touched = chip_smoke._touched(torch, w, idx, coef, val)
    u = coef[:, None] * val
    live = (idx >= 0) & (idx < w.shape[0]) & (u != 0)
    assert touched == len(set(idx[live].tolist())) < 64 * 41
    assert 13 + 1 <= touched  # the numerics and the bias are touched
    ms, by = chip_smoke.scatter_inplace_bound_ms(64, 41, 1, touched)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 64 * 41 + 64 + 2 * touched) * 4 / 3.35e12 * 1e3)
    W, idx2, coef2, val2 = chip_smoke._scatter_inputs(torch, 16, 22, 4097, 2, "avazu", seed=3,
                                                      device="cpu")
    coef2[3] = 0.0
    assert chip_smoke._touched(torch, W, idx2, coef2, val2) == len(set(
        idx2[(coef2.abs().amax(1)[:, None] * val2 != 0) & (idx2 < 4097)].tolist()))


def test_chip_smoke_chunked_pa_scan_case():
    """The chunked pa_scan check lies past the kernel's 26,944-row limit."""
    chip_smoke = _chip_smoke()
    b, d = chip_smoke.CHUNKED_CHECK
    assert 26_944 < b < 2 * 26_944 and d == 29


@pytest.mark.parametrize("draw", ["uniform", "pool64", "criteo"])
def test_chip_smoke_scatter_tolerance(draw):
    """The kernel-vs-plain limit passes the plain version against itself
    with the updates summed in another order, and fails one update lost
    (the out-of-range update applied would fail as well)."""
    from omldm_tpu_torch.ops.sparse import sparse_scatter_add_reference

    chip_smoke = _chip_smoke()
    b, k, d = 64, 41, 13 + 2 ** 12 + 1
    w, idx, coef, val = chip_smoke._scatter_inputs(torch, b, k, d, 1, draw, seed=3, device="cpu")
    limit = chip_smoke.scatter_limit(torch, w, idx, coef, val)
    plain = sparse_scatter_add_reference(w, idx, coef, val)
    order = torch.randperm(b, generator=torch.Generator().manual_seed(0))
    shuffled = sparse_scatter_add_reference(w, idx[order], coef[order], val[order])
    assert ((shuffled - plain).abs() <= limit).all()
    lost = val.clone()
    row = int(torch.nonzero(coef)[1])  # a row the mask keeps, past row 0
    lost[row, 2] = 0.0
    dropped = sparse_scatter_add_reference(w, idx, coef, lost)
    assert not ((dropped - plain).abs() <= limit).all()
    wrapped = idx.clone()
    wrapped[0, 1] = d - 1  # the out-of-range update clamped onto the last row
    clamped = sparse_scatter_add_reference(w, wrapped, coef, val)
    assert not ((clamped - plain).abs() <= limit).all()
