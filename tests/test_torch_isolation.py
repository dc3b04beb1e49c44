"""The port stands alone: it imports neither JAX, optax nor the JAX package,
runs on CUDA unless asked for the CPU, and refuses what it has not ported
yet."""

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
        "import omldm_tpu_torch.__main__, omldm_tpu_torch.ops.native\n"
        "import omldm_tpu_torch.runtime.fast_ingest, omldm_tpu_torch.runtime.prefetch\n"
        "import omldm_tpu_torch.learners, omldm_tpu_torch.preprocessors\n"
        "import omldm_tpu_torch.protocols, omldm_tpu_torch.runtime.hub\n"
        "import omldm_tpu_torch.parallel.spmd, omldm_tpu_torch.parallel.mesh\n"
        "import omldm_tpu_torch.runtime.spmd_bridge, omldm_tpu_torch.ops.codec\n"
        "import omldm_tpu_torch.runtime.databuffers, omldm_tpu_torch.runtime.cohort\n"
        "import omldm_tpu_torch.runtime.codec, omldm_tpu_torch.guard\n"
        "import omldm_tpu_torch.runtime.supervisor, omldm_tpu_torch.runtime.messages\n"
        "import omldm_tpu_torch.checkpoint, omldm_tpu_torch.runtime.recovery\n"
        "import omldm_tpu_torch.runtime.selfheal, omldm_tpu_torch.utils.backoff\n"
        "import omldm_tpu_torch.parallel.ckpt, omldm_tpu_torch.runtime.overload\n"
        "import omldm_tpu_torch.runtime.lifecycle\n"
        "import omldm_tpu_torch.runtime.telemetry, omldm_tpu_torch.runtime.events\n"
        "import omldm_tpu_torch.utils.tracing, omldm_tpu_torch.runtime.ingest_shard\n"
        "import omldm_tpu_torch.runtime.kafka_io, omldm_tpu_torch.runtime.loadgen\n"
        "import omldm_tpu_torch.runtime.slo, omldm_tpu_torch.load_harness\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'omldm_tpu')]\n"
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
    assert not roots & {"jax", "jaxlib", "optax", "omldm_tpu"}, roots


@pytest.mark.parametrize("path", sorted((ROOT / "omldm_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_package_never_imports_the_test_broker(path):
    """tests/fskafka.py is a test fake: the package imports ``kafka`` (the
    real client) and never the fake, nor anything of the tests."""
    assert not set(_imported_roots(path)) & {"fskafka", "tests"}


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


def test_pipeline_default_device_is_cuda():
    """MLPipeline with no device wants CUDA and, without a card, raises as
    StreamJob() does; a host-side learner (HT) stays on the host."""
    from omldm_tpu_torch.api.requests import LearnerSpec
    from omldm_tpu_torch.pipelines import MLPipeline

    if torch.cuda.is_available():
        assert MLPipeline(LearnerSpec("PA"), dim=3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="MLPipeline: CUDA requested"):
            MLPipeline(LearnerSpec("PA"), dim=3)
    assert MLPipeline(LearnerSpec("PA"), dim=3, device="cpu").device.type == "cpu"
    assert MLPipeline(LearnerSpec("HT"), dim=3).device.type == "cpu"


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


def test_forked_ingest_worker_loads_no_jax(tmp_path):
    """The sharded ingest plane's parser worker, forked from a fresh
    interpreter that loaded the port's job, runs its real loop over a small
    file and reports the modules it holds at the end: nothing of JAX or of
    the JAX package."""
    path = tmp_path / "rows.jsonl"
    path.write_text("".join(json.dumps({"numericalFeatures": [float(i), 1.0],
                                        "target": float(i % 2)}) + "\n" for i in range(50)))
    code = textwrap.dedent(f"""
        import multiprocessing, sys
        import omldm_tpu_torch.runtime.job
        from omldm_tpu_torch.runtime import ingest_shard as ish

        def worker(out):
            ctx = multiprocessing.get_context("fork")
            ring = lambda kind, n: ctx.RawArray(kind, n)
            ready, free = ctx.Queue(), ctx.Queue()
            free.put(0)
            ish._worker_main(0, 1, {str(path)!r}, 2, 0, 1 << 20, 64, ring("f", 128),
                             ring("f", 64), ring("B", 64), ring("q", 4), ring("d", 4),
                             ready, free, ctx.Event())
            assert ready.get(timeout=10) == 0 and ready.get(timeout=10) == -1  # a block, EOS
            out.put(sorted({{m.split(".")[0] for m in sys.modules}}))

        ctx = multiprocessing.get_context("fork")
        out = ctx.Queue()
        p = ctx.Process(target=worker, args=(out,), daemon=True)  # never outlives a failure
        p.start()
        roots = out.get(timeout=60)
        p.join(timeout=30)
        assert p.exitcode == 0, p.exitcode
        bad = [r for r in roots if r in ("jax", "jaxlib", "optax", "omldm_tpu")]
        assert not bad, bad
        assert "omldm_tpu_torch" in roots
    """)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_profiler_trace_pulls_in_no_jax(tmp_path):
    """``--profileDir``'s torch.profiler path, run on the CPU in a fresh
    interpreter, loads nothing of JAX and writes a Chrome trace."""
    code = (
        "import sys, torch\n"
        "from omldm_tpu_torch.utils.tracing import trace, trace_path\n"
        f"with trace({str(tmp_path)!r}, 'cpu'):\n"
        "    torch.ones(8).sum()\n"
        f"assert trace_path({str(tmp_path)!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'omldm_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    assert [p.name for p in tmp_path.iterdir() if p.name.startswith("trace-")]


@pytest.mark.parametrize("option", [
    {"telemetry": "statsEvery=16,traceSample=2"}, {"events": "watchdogEvery=16,shedHigh=1"},
])
def test_telemetry_and_events_job_planes_run(option):
    """The telemetry plane and the flight recorder are ported: a job armed
    with either builds, runs, and holds its plane's object."""
    job = StreamJob(JobConfig(parallelism=2, batch_size=8, **option), device="cpu")
    rows = [("trainingData", json.dumps({"numericalFeatures": [float(i % 3), 1.0],
                                         "target": float(i % 2)})) for i in range(40)]
    report = job.run([("requests", _create())] + rows)
    assert report.statistics[0].fitted > 0
    assert (job.telemetry is not None) == ("telemetry" in option)
    assert (job.events is not None) == ("events" in option)


@pytest.mark.parametrize("option", [
    {"overload": "on"}, {"lifecycle": "on"},
    {"chaos": "seed=1,burst=4"}, {"chaos": "seed=1,hotTenant=3"},
])
def test_overload_and_lifecycle_job_planes_run(option):
    """The overload and lifecycle planes and the chaos spec's burst keys
    are ported: a job armed with any of them builds and runs."""
    job = StreamJob(JobConfig(parallelism=2, batch_size=8, **option), device="cpu")
    rows = [("trainingData", json.dumps({"numericalFeatures": [float(i % 3), 1.0],
                                         "target": float(i % 2)})) for i in range(40)]
    report = job.run([("requests", _create())] + rows)
    assert job.pipeline_manager.live_pipelines == [0] and report.statistics[0].fitted > 0
    net = job.spokes[0].nets[0]
    assert (net.overload is not None) == ("overload" in option)
    assert (net.lifecycle is not None) == ("lifecycle" in option)


@pytest.mark.parametrize("option", [
    {"cohort": "on"}, {"cohort_shards": "auto"}, {"cohort_min": 4},
    {"cohort_impl": "vmap"},
])
def test_cohort_options_admitted(option):
    """The cohort engine is ported: its knobs are JobConfig fields (the
    JAX package's cohort_impl is accepted and ignored: the device picks the
    member iteration), and a cohort_shards that resolves to one device (a
    CPU job) is admitted."""
    job = StreamJob(JobConfig(**option), device="cpu")
    assert all(s.cohorts is not None for s in job.spokes)
    assert job.tenant_topology()["cohort_shards"] == 1


@pytest.mark.parametrize("option", [
    {"compute_dtype": "bfloat16"}, {"mesh_shape": {"dp": 2, "hub": 1}},
    {"max_msg_params": 2000},
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
    (_create(overload={"shedHigh": 0.9}), "unknown overload knob(s): ['shedHigh']"),
    (_create(learner="Nope"), "unknown learner"),
    (_create(lifecycle={"rampTo": 2}), "lifecycle ramp must satisfy"),
    (_create(telemetry={"sloMs": 5}), "unknown telemetry knob(s): ['sloMs']"),
    (_create(events={"bogus": 1}), "unknown events knob(s): ['bogus']"),
    (_create(preps=("Whitener",)), "unknown preprocessor 'Whitener'"),
    (_create(serving={"maxBatch": 0}), "serving.maxBatch must be >= 1"),
    (_create(serving={"maxBatch": 8, "nope": 1}), "unknown serving knob"),
    (_create(comm={"codec": "zstd"}), "unknown comm codec 'zstd'"),
    (_create(engine="spmd", comm={"codec": "topk"}), "topk codec is host-plane only"),
    (_create(engine="spmd", feedDtype="float64"), "engine 'spmd': feedDtype"),
    (_create(engine="spmd", protocol="SSP", staleness=0), "SSP staleness must be >= 1"),
])
def test_control_gate_rejects_unported(request_json, reason):
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", request_json)])
    [entry] = job.dead_letter.entries
    assert entry["reason"] == "rejected_request"
    assert reason in entry["detail"]
    assert job.pipeline_manager.live_pipelines == []


@pytest.mark.parametrize("tc", [
    {"comm": {"quorum": 3}}, {"comm": {"workerTimeoutMs": 500}}, {"comm": {"windowSize": 8}},
    {"comm": {"stallAfter": 8}}, {"comm": {"reliable": True}}, {"guard": True},
    {"guard": {"normLimit": 1e3, "maxStrikes": 2}}, {"comm": {"codec": "topk"}},
    {"comm": {"codec": "fp16"}}, {"codec": "int8"},
    {"engine": "spmd", "comm": {"codec": "int8"}}, {"engine": "spmd", "comm": {"codec": "fp16"}},
])
def test_control_gate_admits_ported_planes(tc):
    """The guard, every codec (topk on the host plane only) and the reliable
    channel's keys deploy."""
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", _create(**tc))], terminate_on_end=False)
    assert job.pipeline_manager.live_pipelines == [0] and not job.dead_letter.entries


def test_serving_plane_is_ported():
    """A serving table and the job-wide serving default are admitted; a bad
    job-wide default fails at construction, as in the JAX package."""
    job = StreamJob(JobConfig(parallelism=2, serving="maxBatch=8"), device="cpu")
    job.run([("requests", _create(serving={"maxBatch": 4}))])
    assert job.pipeline_manager.live_pipelines == [0] and not job.dead_letter.entries
    with pytest.raises(ValueError, match="staleness"):
        StreamJob(JobConfig(serving="staleness=eventual"), device="cpu")


@pytest.mark.parametrize("argv,flag", [
    (["--meshShape", "dp=2,hub=1"], "meshShape"),
    (["--computeDtype", "bfloat16"], "computeDtype"),
    (["--maxMsgParams", "2000"], "maxMsgParams"),
    (["--requestBufferCap", "10"], "requestBufferCap"),
    (["--processes", "2"], "processes"),
    (["--processId", "0"], "processId"),
    (["--coordinator", "localhost:1234"], "coordinator"),
    (["--supervise"], "supervise"),
    (["--compileCache", "off"], "compileCache"),
    (["--compileCacheMinSecs", "1"], "compileCacheMinSecs"),
])
def test_cli_refuses_unported_flags(argv, flag, tmp_path):
    """A CLI flag whose route or knob the port lacks raises SystemExit
    naming it, before any job is built (the JAX CLI would honour it)."""
    from omldm_tpu_torch.__main__ import main

    train = tmp_path / "t.jsonl"
    train.write_text('{"numericalFeatures": [1.0], "target": 1.0}\n')
    with pytest.raises(SystemExit, match=flag):
        main(["--trainingData", str(train), "--device", "cpu", *argv])


@pytest.mark.parametrize("argv,flag", [
    (["--kafkaBrokers", "localhost:9092", "--timeout", "200"], "kafkaBrokers"),
    (["--profileSteps", "100"], "profileSteps"),
])
def test_cli_accepts_kafka_route_flags(argv, flag, tmp_path, monkeypatch):
    """The Kafka route and its profile window are ported: their flags are
    no longer refused. ``--kafkaBrokers`` runs the polling loop (here over a
    broker that never delivers, until the silence timer); ``--profileSteps``
    is accepted and, off the Kafka route, has no effect, as in the JAX
    CLI."""
    import omldm_tpu_torch.runtime.kafka_io as kafka_io
    from omldm_tpu_torch.__main__ import UNPORTED_ROUTE_FLAGS, main

    class Silent:
        def __next__(self):
            raise StopIteration

    monkeypatch.setattr(kafka_io, "connect_kafka", lambda brokers, **kw: (
        kafka_io.polling_events(Silent()), kafka_io.ProducerSinks(None)))
    assert flag not in UNPORTED_ROUTE_FLAGS
    train = tmp_path / "t.jsonl"
    train.write_text('{"numericalFeatures": [1.0], "target": 1.0}\n')
    sources = [] if flag == "kafkaBrokers" else ["--trainingData", str(train)]
    assert main([*sources, "--device", "cpu", *argv,
                 "--performanceOut", str(tmp_path / "perf.jsonl")]) == 0
    assert (tmp_path / "perf.jsonl").read_text().strip()


@pytest.mark.parametrize("argv", [
    ["--checkpointDir", "{tmp}/a"], ["--stateBackend", "{tmp}/b"],
    ["--checkInterval", "100"], ["--checkpointKeep", "2"],
    ["--restartAttempts", "2"], ["--restartAttempts", "1", "--restartDelayMs", "5"],
    ["--checkpointing", "true", "--stateBackend", "{tmp}/c", "--checkInterval", "0"],
])
def test_cli_accepts_recovery_flags(argv, tmp_path):
    """Checkpointing and supervised recovery are ported: their flags set the
    JobConfig fields (the JAX names) and the job runs."""
    from omldm_tpu_torch.__main__ import main

    argv = [a.format(tmp=tmp_path) for a in argv]
    train = tmp_path / "t.jsonl"
    train.write_text('{"numericalFeatures": [1.0], "target": 1.0}\n')
    assert main(["--trainingData", str(train), "--device", "cpu", *argv,
                 "--performanceOut", str(tmp_path / "perf.jsonl")]) == 0
    cfg = JobConfig.from_args({a[2:]: b for a, b in zip(argv[::2], argv[1::2])})
    if "--stateBackend" in argv:
        assert cfg.checkpoint_dir == argv[argv.index("--stateBackend") + 1]
    if "--checkpointing" in argv:
        assert cfg.checkpointing and cfg.check_interval_ms == 0
        assert any(f.startswith("ckpt_") for f in os.listdir(tmp_path / "c"))


def test_cli_accepts_zero_restart_attempts(tmp_path):
    from omldm_tpu_torch.__main__ import main

    train = tmp_path / "t.jsonl"
    train.write_text('{"numericalFeatures": [1.0], "target": 1.0}\n')
    assert main(["--trainingData", str(train), "--device", "cpu", "--restartAttempts", "0",
                 "--performanceOut", str(tmp_path / "perf.jsonl")]) == 0


@pytest.mark.parametrize("argv", [
    ["--cohortMin", "4"], ["--cohort", "on"], ["--cohortImpl", "vmap"],
])
def test_cli_accepts_cohort_flags(argv, tmp_path):
    """The cohort engine's flags reach the port's JobConfig (the JAX CLI
    takes the same spellings)."""
    from omldm_tpu_torch.__main__ import main

    train = tmp_path / "t.jsonl"
    train.write_text('{"numericalFeatures": [1.0], "target": 1.0}\n')
    assert main(["--trainingData", str(train), "--device", "cpu", *argv,
                 "--performanceOut", str(tmp_path / "perf.jsonl")]) == 0


def test_parallelism_one_forces_an_unported_protocol():
    """Parallelism 1 forces CentralizedTraining, which the port now runs."""
    rows = [
        ("trainingData", json.dumps({"numericalFeatures": [float(i % 3), 1.0],
                                     "target": float(i % 2)}))
        for i in range(40)
    ]
    job = StreamJob(JobConfig(parallelism=1, batch_size=8), device="cpu")
    report = job.run([("requests", _create(protocol="Synchronous"))] + rows)
    assert not job.dead_letter.entries
    assert report.statistics[0].protocol == "CentralizedTraining"
    assert report.statistics[0].fitted > 0


LEARNER_SPECS = [
    ("PA", {}), ("RegressorPA", {}), ("ORR", {}), ("SVM", {"rffDim": 8}),
    ("MultiClassPA", {}), ("K-means", {}), ("NN", {"hiddenLayers": [4]}), ("HT", {}),
    ("Softmax", {}),
]


@pytest.mark.parametrize("name,ds", LEARNER_SPECS, ids=[n for n, _ in LEARNER_SPECS])
@pytest.mark.parametrize("preps", [(), ("MinMaxScaler",), ("PolynomialFeatures",)],
                         ids=["none", "minmax", "poly"])
def test_control_gate_admits_every_learner_and_preprocessor(name, ds, preps):
    """Every learner of the JAX package's host engine, alone and behind each
    preprocessor, is admitted and trains on the CPU."""
    create = json.loads(_create(learner=name, preps=preps, protocol="Synchronous"))
    create["learner"]["dataStructure"] = ds
    rows = [
        ("trainingData", json.dumps({"numericalFeatures": [float(i % 3), 1.0, -0.5],
                                     "target": float(i % 2)}))
        for i in range(48)
    ]
    job = StreamJob(JobConfig(parallelism=2, batch_size=8), device="cpu")
    report = job.run([("requests", json.dumps(create))] + rows)
    assert not job.dead_letter.entries, job.dead_letter.entries
    expected = "SingleLearner" if name in ("HT", "K-means") else "Synchronous"
    assert report.statistics[0].protocol == expected
    assert report.statistics[0].fitted > 0


@pytest.mark.parametrize("protocol", ["CentralizedTraining", "SingleLearner", "Asynchronous",
                                      "Synchronous", "SSP", "EASGD", "GM", "FGM"])
def test_control_gate_admits_every_protocol(protocol):
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", _create(protocol=protocol))])
    assert not job.dead_letter.entries
    assert job.pipeline_manager.live_pipelines == [0]


@pytest.mark.parametrize("request_type", ["Shadow", "Promote", "Rollback"])
def test_control_gate_rejects_lifecycle_requests(request_type):
    """The lifecycle verbs are ported: aimed at a pipeline without the
    plane armed they are rejected by that reason (an armed pipeline takes
    them, tests/test_torch_lifecycle.py)."""
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", _create()),
             ("trainingData", json.dumps({"numericalFeatures": [1.0, 0.0], "target": 1.0})),
             ("requests", json.dumps({"id": 0, "request": request_type,
                                      "learner": {"name": "PA"}}))])
    [entry] = job.dead_letter.entries
    assert entry["detail"] == "lifecycle plane not armed for pipeline 0"


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


@pytest.mark.parametrize("phase", [
    "phase_cli", "phase_cli_parity", "phase_serving", "phase_cli_sparse", "phase_cli_profile",
])
def test_chip_smoke_has_the_cli_phases(phase):
    chip_smoke = _chip_smoke()
    assert callable(getattr(chip_smoke, phase))
    assert f"{phase}(" in (ROOT / "chip_smoke.py").read_text().split("def main")[1]


def test_cli_profile_functions_exist():
    """Every function the CLI profile reports is defined where it says."""
    chip_smoke = _chip_smoke()
    for label, suffix, name in chip_smoke.CLI_PROFILE_FUNCS:
        path = ROOT / suffix if suffix.startswith("omldm_tpu_torch/") else (
            ROOT / "omldm_tpu_torch" / suffix)
        assert f"def {name}(" in path.read_text(), label


def test_chip_smoke_stream_files(tmp_path):
    """Phase 17's files: requests in the requests file, every data record in
    stream order in the training file with the forecasts marked inline; the
    forecasts' workers follow the round-robin deal from row 0."""
    chip_smoke = _chip_smoke()
    events = chip_smoke.make_events(45, seed=0, query_at=20)
    train, reqs = chip_smoke.write_stream_files(events, tmp_path, "t")
    assert [json.loads(line)["request"] for line in reqs.read_text().splitlines()] == \
        ["Create", "Query"]
    rows = [json.loads(line) for line in train.read_text().splitlines()]
    data = [json.loads(p) for s, p in events if s != "requests"]
    assert len(rows) == len(data) == 50
    assert [r.get("operation", "training") for r in rows] == \
        ["forecasting" if i % 10 == 9 else "training" for i in range(50)]
    workers = chip_smoke.forecast_workers(events, 16)
    assert sorted(workers.values()) == sorted(i % 16 for i in range(9, 50, 10))


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


@pytest.mark.parametrize("phase", [
    "phase_learners", "phase_protocols", "phase_protocol_parity", "phase_host_plane_profile",
])
def test_chip_smoke_has_the_host_plane_phases(phase):
    chip_smoke = _chip_smoke()
    assert callable(getattr(chip_smoke, phase))
    assert f"{phase}(" in (ROOT / "chip_smoke.py").read_text().split("def main")[1]


def test_chip_smoke_host_plane_runs():
    """Phase 21 runs BASELINE configs 1, 2 and 4 at their published shapes
    and every learner and preprocessor; phase 22 runs the protocol
    comparison's host section on its stream; every learner run's data has
    the run's width and a forecast every tenth row."""
    from omldm_tpu_torch.learners.registry import LEARNERS
    from omldm_tpu_torch.preprocessors import PolynomialFeatures

    chip_smoke = _chip_smoke()
    runs = {r[0]: r[1:] for r in chip_smoke.LEARNER_RUNS}
    learner, preps, tc, par, batch, _, _, width = runs["config1_softmax"]
    assert (learner["hyperParameters"], preps, par, batch, width) == (
        {"learningRate": 0.05, "nClasses": 2}, ["StandardScaler"], 1, 4096, 28)
    assert runs["config2_orr"][0]["hyperParameters"] == {"lambda": 1.0}
    assert runs["config2_orr"][-1] == 90
    assert runs["config4_rff_svm"][0]["dataStructure"] == {"rffDim": 512, "gamma": 0.5}
    assert runs["config4_rff_svm"][-1] == 18
    assert runs["bench_softmax_sync"][2:5] == ({"protocol": "Synchronous"}, 16, 4096)
    assert PolynomialFeatures().out_dim(runs["poly2_pa"][-1]) == 434
    assert {r[1]["name"] for r in chip_smoke.LEARNER_RUNS} == set(LEARNERS)
    assert set(chip_smoke.PROTOCOL_ORDER) == {
        "CentralizedTraining", "SingleLearner", "Asynchronous", "Synchronous", "SSP", "EASGD",
        "GM", "FGM"}
    assert chip_smoke.PROTOCOL_RUN == dict(records=50_000, parallelism=16, batch=256,
                                           test_set_size=64, sync_every=4)
    x, y = chip_smoke.protocol_stream(10)
    assert x.shape == (10, 28) and set(y.tolist()) <= {0.0, 1.0}
    for name, (learner, preps, tc, par, batch, n, kind, width) in runs.items():
        x, y = chip_smoke.learner_data(kind, 20, width, seed=0)
        assert x.shape == (20, width) and y.shape == (20,), name
    assert chip_smoke._forecast_ops(20).tolist() == [0] * 9 + [1] + [0] * 9 + [1]


@pytest.mark.parametrize("phase", [
    "phase_bench", "phase_spmd_protocols", "phase_spmd_parity", "phase_bench_profile",
])
def test_chip_smoke_has_the_spmd_phases(phase):
    chip_smoke = _chip_smoke()
    assert callable(getattr(chip_smoke, phase))
    assert f"{phase}(" in (ROOT / "chip_smoke.py").read_text().split("def main")[1]


def test_chip_smoke_bench_stream_is_the_benchmarks(tmp_path):
    """Phase 24's file is byte for byte run_benchmarks.py's _gen_stream_file
    at the same seed (its pool formats the chunks that generator draws)."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        from run_benchmarks import _gen_stream_file
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    chip_smoke = _chip_smoke()
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    n = 20_000 + 37  # two chunks, the second one short
    assert chip_smoke.write_bench_stream(ours, n, seed=5) == _gen_stream_file(
        str(theirs), n, 28, seed=5)
    assert ours.read_bytes() == theirs.read_bytes()


def test_chip_smoke_spmd_shapes():
    """Phase 24 runs _make_e2e_job's job, phase 25 run_one(engine="spmd")'s,
    phase 26 the JAX engine's 8-worker mesh with hub 2; each phase-26
    learner is one the engine hosts, the sparse one at Criteo width with
    the scatter pinned, so the card's kernel meets index_add_ on the CPU."""
    from omldm_tpu_torch.parallel.spmd import SPMD_PROTOCOLS

    chip_smoke = _chip_smoke()
    assert chip_smoke.BENCH_RECORDS == 1_000_000
    assert chip_smoke.BENCH_JOB == dict(parallelism=1, batch=4096, chain=32, dim=28)
    assert chip_smoke.SPMD_RUN == dict(records=50_000, parallelism=16, batch=256,
                                       test_set_size=64, sync_every=4, chain=4)
    assert tuple(chip_smoke.SPMD_PROTOCOLS) == SPMD_PROTOCOLS
    assert chip_smoke.SPMD_MESH == (8, 2)
    create = chip_smoke._spmd_create("SSP", per_record=True)
    tc = create["trainingConfiguration"]
    assert (tc["engine"], tc["stageChain"], tc["syncEvery"], tc["perRecord"]) == ("spmd", 4, 4, True)
    ds = chip_smoke.SPMD_CHECK_LEARNERS["sparse_pa2"][0]["dataStructure"]
    assert (ds["nFeatures"], ds["scatterImpl"]) == (chip_smoke.CRITEO_DIM, "scatter")


@pytest.mark.parametrize("phase", [
    "phase_recovery", "phase_rescale", "phase_rescale_cohort", "phase_spmd_ckpt",
    "phase_lm_ckpt",
])
def test_chip_smoke_has_the_recovery_phases(phase):
    chip_smoke = _chip_smoke()
    assert callable(getattr(chip_smoke, phase))
    assert f"{phase}(" in (ROOT / "chip_smoke.py").read_text().split("def main")[1]


def test_chip_smoke_recovery_shapes():
    """Phases 34-38 run phase 5's stream over its first 20,000 records at 16
    workers (a crash at 9,000; rescales to 4 and 8; a snapshot at 10,000
    restored at 4), phase 28's tenants over 5,000 rows (2 -> 1 -> 2) and
    phase 26's Mesh(8, 2); what no snapshot carries is named, and nothing
    else escapes the recovered-against-unfaulted check."""
    chip_smoke = _chip_smoke()
    assert chip_smoke.RECOVERY_RUN == dict(records=20_000, snapshots=20, crash_at=9_000,
                                           worker=3, max_restarts=2)
    assert chip_smoke.RESCALE_RUN["schedule"] == ((7_000, 4), (14_000, 8))
    assert (chip_smoke.RESCALE_RUN["snapshot_at"],
            chip_smoke.RESCALE_RUN["restore_parallelism"]) == (10_000, 4)
    assert chip_smoke.COHORT_RESCALE == dict(records=5_000, schedule=((2_500, 1), (3_750, 2)))
    assert chip_smoke.SPMD_CKPT["rows"] == 20_000 and chip_smoke.SPMD_MESH == (8, 2)
    assert set(chip_smoke.UNSNAPSHOTTED_TALLIES) == {
        "programLaunches", "forecastsServed", "bytesShipped", "bytesOnWire"}
    assert (chip_smoke.REC_RTOL, chip_smoke.REC_ATOL) == (1e-5, 1e-6)
