"""The port's sharded ingest plane (omldm_tpu_torch.runtime.ingest_shard) and
device-resident stage (spmd_bridge._ResidentIngest), held against the JAX
package's on the same files (tests/test_ingest_shard.py's cases, each run
through both packages where both compute it).

- The sharded block stream is bitwise the single-process parse, for any
  shard count and chunk size, and bitwise the JAX plane's rows.
- A parser killed (or stopped) mid-stream degrades to in-process parsing
  from the exact row where the sharded stream stopped, reason-coded with
  the selfheal class (``crash``, ``hang``); the rows never change.
- Unarmed, ``run_file`` takes the fused route; armed, the sharded one.
- Packed, sharded and sharded ``device=on`` StreamJob runs are bitwise
  equal to each other and within the SPMD tolerance (rtol 2e-4, atol 2e-5:
  float32 sums in another order) of the JAX job, from the reference's
  initial parameters; the CLI's ``--ingest`` gives the JAX CLI's
  predictions and statistics.
- The resident stage is bitwise the host stage and refuses to arm where it
  cannot serve (SSP, mid-stream, a sparse bridge); the probes reach the
  overload plane's extra_signals and leave it.
"""

import json
import multiprocessing
import os
import signal
import threading

import jax
import numpy as np
import pytest

import omldm_tpu.__main__ as jax_cli
import omldm_tpu_torch.__main__ as port_cli
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import ingest_shard as jish
from omldm_tpu.runtime import selfheal as jselfheal
from omldm_tpu.runtime.fast_ingest import iter_file_batches as jax_iter_file_batches
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.pipelines import fleet_state_from_numpy
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import selfheal
from omldm_tpu_torch.runtime.fast_ingest import iter_file_batches
from omldm_tpu_torch.runtime.ingest_shard import (
    IngestConfig,
    ShardedIngest,
    chunk_span,
    n_chunks,
    parse_ingest_spec,
)
from omldm_tpu_torch.runtime.selfheal import CRASH, HANG
from test_torch_spmd_bridge import assert_same_stats, eight_slots  # noqa: F401 (a fixture)

W_RTOL, W_ATOL = 2e-4, 2e-5  # the SPMD parity tolerance: float32 sums in another order


def _write_stream(path, n, dim=6, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    x = rng.randn(n, dim)
    y = (x @ w > 0).astype(np.float64)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "numericalFeatures": list(np.round(x[i], 5)),
                "target": float(y[i]),
            }) + "\n")


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ingest") / "stream.jsonl"
    _write_stream(str(path), 3000, dim=6)
    return str(path), 6, 3000


def _reference_rows(path, dim, iter_batches=iter_file_batches):
    parts = list(iter_batches(path, dim, 8192))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(3))


def _sharded_rows(si):
    xs, ys, ops = [], [], []
    for x, y, op in si.blocks():
        xs.append(x)
        ys.append(y)
        ops.append(op)
    return (
        np.concatenate(xs) if xs else np.zeros((0, si.dim), np.float32),
        np.concatenate(ys) if ys else np.zeros((0,), np.float32),
        np.concatenate(ops) if ops else np.zeros((0,), np.uint8),
    )


def _assert_rows_equal(a, b):
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def _no_workers_left():
    return not [p for p in multiprocessing.active_children() if p.name.startswith("ingest-shard")]


# --- spec parsing --------------------------------------------------------


def test_spec_unarmed_forms():
    for spec in (None, "", False):
        assert parse_ingest_spec(spec) is None and jish.parse_ingest_spec(spec) is None


def test_spec_on_arms_default_shape():
    cfg = parse_ingest_spec("on")
    assert cfg is not None
    assert cfg.shards >= 1  # one parser a spare core
    assert cfg.device is False
    assert parse_ingest_spec(True) is not None
    assert cfg.shards == jish.parse_ingest_spec("on").shards


@pytest.mark.parametrize("spec", [
    "shards=2, chunkKb=256, ring=3, slotRows=500, device=on, waitMs=750",
    {"shards": 1, "device": "false"},
    "shards=0,device=true",
])
def test_spec_knobs(spec):
    cfg = parse_ingest_spec(spec)
    ref = jish.parse_ingest_spec(spec)
    fields = ("shards", "chunk_kb", "ring", "slot_rows", "device", "wait_ms")
    assert [getattr(cfg, f) for f in fields] == [getattr(ref, f) for f in fields]
    if isinstance(spec, str) and spec.startswith("shards=2"):
        assert (cfg.shards, cfg.chunk_kb, cfg.ring, cfg.slot_rows) == (2, 256, 3, 500)
        assert cfg.device is True and cfg.wait_ms == 750.0


@pytest.mark.parametrize("spec,match", [
    ("shards=2,bogus=1", "unknown ingest knob"),
    ("junk", "want k=v"),
    ("ring=0", "ring"),
    ("shards=-1", "shards"),
    (3.5, "table"),
])
def test_spec_validation_fails_fast(spec, match):
    with pytest.raises(ValueError, match=match):
        parse_ingest_spec(spec)
    with pytest.raises(ValueError, match=match):
        jish.parse_ingest_spec(spec)


def test_bad_spec_raises_at_job_construction():
    with pytest.raises(ValueError, match="unknown ingest knob"):
        StreamJob(JobConfig(parallelism=1, ingest="nope=1"), device="cpu")


@pytest.mark.parametrize("rc,silent,beat", [
    (None, False, None), (1, False, None), (-9, False, None), (19, False, None),
    (None, True, None), (1, False, False), (1, False, True), (0, True, False),
])
def test_classify_failure_matches_jax(rc, silent, beat):
    assert selfheal.HANG_EXIT == jselfheal.HANG_EXIT == 19
    assert selfheal.classify_failure(rc, silent, beat) == jselfheal.classify_failure(rc, silent, beat)


# --- deterministic chunk grid --------------------------------------------


def test_chunk_spans_partition_file(stream_file):
    path, _, _ = stream_file
    fsize = os.path.getsize(path)
    for chunk_kb in (1, 4, 64):
        cb = chunk_kb * 1024
        spans = []
        with open(path, "rb") as f:
            for k in range(n_chunks(fsize, cb)):
                span = chunk_span(f, k, cb, fsize)
                assert span is not None
                assert span == jish.chunk_span(f, k, cb, fsize)
                spans.append(span)
            assert chunk_span(f, n_chunks(fsize, cb), cb, fsize) is None
        # contiguous, non-overlapping, covering [0, fsize)
        assert spans[0][0] == 0
        assert spans[-1][1] == fsize
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 == b0
            assert a0 <= a1


def test_chunk_span_line_longer_than_chunk(tmp_path):
    """A line spanning several grid windows: interior chunks are empty
    spans, the line belongs to the chunk holding its first byte."""
    path = str(tmp_path / "long.jsonl")
    dim = 400  # one line is several KB, past the 1 KB chunk grid
    _write_stream(path, 12, dim=dim)
    ref = _reference_rows(path, dim)
    got = _sharded_rows(ShardedIngest(path, dim, IngestConfig(shards=2, chunk_kb=1)))
    _assert_rows_equal(ref, got)


# --- bit-identity --------------------------------------------------------


@pytest.mark.parametrize("shards,chunk_kb", [(1, 64), (2, 16), (3, 7)])
def test_sharded_stream_bitwise_single_process(stream_file, shards, chunk_kb):
    """The port's sharded rows equal its single-process parse and the JAX
    plane's sharded rows and single-process parse, bitwise."""
    path, dim, n = stream_file
    ref = _reference_rows(path, dim)
    assert ref[0].shape[0] == n
    _assert_rows_equal(ref, _reference_rows(path, dim, jax_iter_file_batches))
    si = ShardedIngest(path, dim, IngestConfig(shards=shards, chunk_kb=chunk_kb))
    got = _sharded_rows(si)
    _assert_rows_equal(ref, got)
    jax_si = jish.ShardedIngest(path, dim, jish.IngestConfig(shards=shards, chunk_kb=chunk_kb))
    _assert_rows_equal(_sharded_rows(jax_si), got)
    st = si.stats()
    assert st["rows"] == n
    assert st["workers"] == shards
    assert st["chunks"] == n_chunks(os.path.getsize(path), chunk_kb * 1024)
    assert {k: st[k] for k in ("rows", "workers", "chunks")} == \
        {k: jax_si.stats()[k] for k in ("rows", "workers", "chunks")}
    assert 0.0 <= si.starvation() <= 1.0
    assert si.degraded is None
    assert _no_workers_left()


def test_ring_smaller_than_chunks_still_exact(stream_file):
    """Workers block on full rings (bounded look-ahead) without changing
    the stream."""
    path, dim, _ = stream_file
    ref = _reference_rows(path, dim)
    si = ShardedIngest(path, dim, IngestConfig(shards=2, chunk_kb=4, ring=1, slot_rows=64))
    _assert_rows_equal(ref, _sharded_rows(si))
    assert si.stats()["worker_stall_s"] >= 0.0


# --- failure: degrade to in-process, reason-coded ------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_worker_kill_midstream_bit_identical(stream_file, seed):
    """Seeded chaos: SIGKILL one parser after a seeded number of blocks.
    The consumed rows are EXACTLY the rows of a run without the failure,
    and the degrade is reason-coded with the selfheal crash class."""
    path, dim, _ = stream_file
    ref = _reference_rows(path, dim)
    rng = np.random.RandomState(seed)
    kill_after = int(rng.randint(1, 12))
    degrades = []
    si = ShardedIngest(path, dim, IngestConfig(shards=2, chunk_kb=8, wait_ms=2000),
                       on_degrade=degrades.append)
    victim = si._procs[int(rng.randint(0, 2))]
    xs, ys, ops = [], [], []
    for i, (x, y, op) in enumerate(si.blocks()):
        if i == kill_after and victim.is_alive():
            os.kill(victim.pid, signal.SIGKILL)
            victim.join(timeout=5.0)
        xs.append(x)
        ys.append(y)
        ops.append(op)
    _assert_rows_equal(ref, (np.concatenate(xs), np.concatenate(ys), np.concatenate(ops)))
    assert si.degraded is not None
    assert si.degraded["class"] == CRASH
    assert degrades == [si.degraded]
    assert si.degraded["chunk"] >= 0
    assert _no_workers_left()


def test_wedged_worker_classified_hang(stream_file):
    """A SIGSTOP'd parser (alive but silent past waitMs) degrades with the
    hang class; the stream still completes bit-identically."""
    path, dim, _ = stream_file
    ref = _reference_rows(path, dim)
    si = ShardedIngest(path, dim, IngestConfig(shards=2, chunk_kb=16, wait_ms=250))
    victim = si._procs[1]
    os.kill(victim.pid, signal.SIGSTOP)
    # let the wedged worker go shortly after the degrade, so close() reaps it
    timer = threading.Timer(1.0, lambda: os.kill(victim.pid, signal.SIGCONT))
    timer.start()
    try:
        got = _sharded_rows(si)
    finally:
        timer.cancel()
        try:
            os.kill(victim.pid, signal.SIGCONT)
        except (ProcessLookupError, OSError):
            pass
        si.close()
    _assert_rows_equal(ref, got)
    assert si.degraded is not None
    assert si.degraded["class"] == HANG


# --- unarmed identity / job routing --------------------------------------


def test_unarmed_job_routes_to_fused(monkeypatch):
    assert JobConfig().ingest == ""
    job = StreamJob(JobConfig(parallelism=1), device="cpu")
    assert job.ingest_cfg is None
    calls = []
    monkeypatch.setattr(job, "run_file_fused", lambda *a, **k: calls.append("fused") or True)
    monkeypatch.setattr(job, "run_file_sharded", lambda *a, **k: calls.append("sharded") or True)
    assert job.run_file("/nonexistent.jsonl", dim=4)
    assert calls == ["fused"]


def test_armed_job_routes_to_sharded(monkeypatch):
    job = StreamJob(JobConfig(parallelism=1, ingest="shards=1"), device="cpu")
    assert job.ingest_cfg is not None and job.ingest_cfg.shards == 1
    calls = []
    monkeypatch.setattr(job, "run_file_fused", lambda *a, **k: calls.append("fused") or True)
    monkeypatch.setattr(job, "run_file_sharded", lambda *a, **k: calls.append("sharded") or True)
    assert job.run_file("/nonexistent.jsonl", dim=4)
    assert calls == ["sharded"]


def _pa_create(protocol="Synchronous"):
    return json.dumps({
        "id": 0,
        "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0}},
        "trainingConfiguration": {
            "protocol": protocol, "syncEvery": 2,
            "engine": "spmd", "stageChain": 2,
        },
    })


def _run_job(path, dim, mode, ingest="", jax_job=None, kill=False, events=""):
    """One StreamJob run of the file: ``packed`` (iter_file_batches blocks
    through process_packed_batch) or ``sharded`` (run_file_sharded). With
    ``jax_job`` (a deployed JAX job), the port's trainer starts from its
    initial state. ``kill`` SIGKILLs parser 1 after the first block."""
    job = StreamJob(JobConfig(parallelism=2, batch_size=64, test_set_size=64, ingest=ingest,
                              events=events), device="cpu")
    job.process_event("requests", _pa_create())
    job.ensure_deployed(dim)
    br = job.spmd_bridges[0]
    if jax_job is not None:
        tr = br.trainer
        tr.load_state(fleet_state_from_numpy(
            jax.device_get(jax_job.spmd_bridges[0].trainer.state), tr))
    if kill:
        real = job.process_packed_batch

        def process(*block):
            for p in multiprocessing.active_children():
                if p.name == "ingest-shard-1" and p.is_alive():
                    os.kill(p.pid, signal.SIGKILL)
                    p.join(timeout=5.0)
            return real(*block)

        job.process_packed_batch = process
    if mode == "sharded":
        assert job.run_file_sharded(path, dim=dim)
    else:
        for blk in iter_file_batches(path, dim, 4096):
            job.process_packed_batch(*blk)
    resident = br._resident is not None
    if resident:
        br._resident.sync_host()
    rep = job.terminate()
    st = rep.statistics[0]
    hx, hy = br.test_set.arrays()
    return {
        "params": br.trainer.global_flat_params().copy(),
        "fitted": st.fitted, "score": st.score,
        "hx": hx.copy(), "hy": hy.copy(),
        "stats": job._ingest_stats, "resident": resident, "job": job,
    }


def _run_jax_job(path, dim):
    job = JaxStreamJob(JaxJobConfig(parallelism=2, batch_size=64, test_set_size=64))
    job.process_event("requests", _pa_create())
    job.ensure_deployed(dim)
    return job


def test_streamjob_sharded_and_resident_bitwise_parity(stream_file, eight_slots):
    """The core pin: packed, sharded, and sharded+device runs of the SAME
    stream give bitwise-equal trained parameters, fitted counts, scores
    and holdout contents; and the JAX job's within the SPMD tolerance,
    from the JAX job's initial parameters."""
    path, dim, n = stream_file
    jax_job = _run_jax_job(path, dim)
    base = _run_job(path, dim, "packed", jax_job=jax_job)
    assert base["fitted"] > 0 and not base["resident"]
    for ingest in ("shards=2,chunkKb=16", "shards=2,chunkKb=16,device=on"):
        got = _run_job(path, dim, "sharded", ingest=ingest, jax_job=jax_job)
        assert got["resident"] == ingest.endswith("device=on"), ingest
        assert got["fitted"] == base["fitted"], ingest
        assert got["score"] == base["score"], ingest
        np.testing.assert_array_equal(got["params"], base["params"])
        np.testing.assert_array_equal(got["hx"], base["hx"])
        np.testing.assert_array_equal(got["hy"], base["hy"])
        # the phase table's inputs survive the run
        assert got["stats"]["rows"] == n and "degraded" not in got["stats"]
        assert got["stats"]["parse_s"] >= 0.0
    # the JAX job on the same file through its own sharded route
    jax_job = JaxStreamJob(JaxJobConfig(parallelism=2, batch_size=64, test_set_size=64,
                                        ingest="shards=2,chunkKb=16"))
    jax_job.process_event("requests", _pa_create())
    jax_job.ensure_deployed(dim)
    assert jax_job.run_file_sharded(path, dim=dim)
    jbr = jax_job.spmd_bridges[0]
    jrep = jax_job.terminate()
    jst = jrep.statistics[0]
    assert jst.fitted == base["fitted"]
    assert abs(jst.score - base["score"]) <= 1e-4
    np.testing.assert_allclose(base["params"], jbr.trainer.global_flat_params(),
                               rtol=W_RTOL, atol=W_ATOL)
    jhx, jhy = jbr.test_set.arrays()
    np.testing.assert_array_equal(base["hx"], jhx)
    np.testing.assert_array_equal(base["hy"], jhy)
    assert _no_workers_left()


def test_killed_parser_in_a_job_degrades_bitwise_and_is_journalled(stream_file, eight_slots):
    """A parser SIGKILLed during a device=on job run: the run degrades with
    the crash class, the flight recorder journals a DEGRADE
    ``ingest_worker_crash``, and the trained model is bitwise the clean
    run's."""
    path, dim, _ = stream_file
    clean = _run_job(path, dim, "sharded", ingest="shards=2,chunkKb=8,device=on,waitMs=2000")
    hurt = _run_job(path, dim, "sharded", ingest="shards=2,chunkKb=8,device=on,waitMs=2000",
                    kill=True, events="watchdogEvery=64")
    assert clean["stats"].get("degraded") is None
    assert hurt["stats"]["degraded"]["class"] == CRASH
    degrades = [e for e in hurt["job"].events.journal.tail() if e["kind"] == "degrade"]
    assert [e["cause"] for e in degrades] == ["ingest_worker_crash"]
    assert degrades[0]["worker"] == 1
    assert hurt["fitted"] == clean["fitted"] and hurt["score"] == clean["score"]
    np.testing.assert_array_equal(hurt["params"], clean["params"])
    np.testing.assert_array_equal(hurt["hx"], clean["hx"])


def test_sharded_run_folds_into_the_phase_table(stream_file):
    path, dim, _ = stream_file
    job = StreamJob(JobConfig(parallelism=1, batch_size=64, test_set_size=64,
                              ingest="shards=2,chunkKb=16", telemetry="statsEvery=1000"),
                    device="cpu")
    job.process_event("requests", _pa_create())
    assert job.run_file_sharded(path, dim=dim)
    st = job._ingest_stats
    table = job.phase_table()
    assert table["parse"]["seconds"] == round(st["parse_s"], 4) > 0.0
    if st["driver_wait_s"] > 0:
        assert table["read"]["count"] >= 1
    job.terminate()


def _cli_run(cli, tmp_path, tag, train, reqs, extra):
    out = tmp_path / tag
    out.mkdir()
    argv = ["--trainingData", str(train), "--requests", str(reqs), "--parallelism", "2",
            "--batchSize", "64", "--testSetSize", "64",
            "--predictionsOut", str(out / "pred.jsonl"),
            "--performanceOut", str(out / "perf.jsonl"), *extra]
    argv += ["--compileCache", "off"] if cli is jax_cli else ["--device", "cpu"]
    assert cli.main(argv) == 0
    preds = [json.loads(line) for line in (out / "pred.jsonl").read_text().splitlines()]
    [perf] = [json.loads(line) for line in (out / "perf.jsonl").read_text().splitlines()]
    return preds, perf


def test_cli_ingest_flag_matches_jax_cli(tmp_path, monkeypatch, eight_slots):
    """``--ingest shards=2,chunkKb=16`` takes the sharded route on both CLIs
    (a forecast every 97 lines: predictions at their stream positions)."""
    train = tmp_path / "train.jsonl"
    rng = np.random.RandomState(4)
    w = rng.randn(6)
    with open(train, "w") as f:
        for i in range(2500):
            x = [round(float(v), 5) for v in rng.randn(6)]
            rec = {"numericalFeatures": x, "target": float(np.dot(x, w) > 0)}
            if i % 97 == 50:
                rec = {"numericalFeatures": x, "operation": "forecasting"}
            f.write(json.dumps(rec) + "\n")
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text(_pa_create() + "\n")
    calls = []
    real = StreamJob.run_file_sharded

    def spy(self, *a, **k):
        calls.append(a[0])
        return real(self, *a, **k)

    monkeypatch.setattr(StreamJob, "run_file_sharded", spy)
    flags = ["--ingest", "shards=2,chunkKb=16"]
    jpreds, jperf = _cli_run(jax_cli, tmp_path, "jax", train, reqs, flags)
    tpreds, tperf = _cli_run(port_cli, tmp_path, "port", train, reqs, flags)
    assert calls == [str(train)]
    assert len(tpreds) == len(jpreds) == 2500 // 97 + 1
    for tp, jp in zip(tpreds, jpreds):
        assert abs(tp["value"] - jp["value"]) <= 1e-4
    [ts], [js] = tperf["statistics"], jperf["statistics"]
    assert_same_stats(ts, js)
    # the same run without --ingest takes the fused route to the same answer
    fpreds, fperf = _cli_run(port_cli, tmp_path, "fused", train, reqs, [])
    assert [p["value"] for p in fpreds] == [p["value"] for p in tpreds]
    assert fperf["statistics"][0]["fitted"] == ts["fitted"]


# --- device-resident hot loop --------------------------------------------


def _mk_bridge(preds, protocol="Synchronous", dim=6, sparse=False):
    from omldm_tpu_torch.api.requests import Request
    from omldm_tpu_torch.runtime.spmd_bridge import make_spmd_bridge

    req = json.loads(_pa_create(protocol))
    if sparse:
        req["learner"]["dataStructure"] = {"sparse": True, "nFeatures": dim, "maxNnz": 4}
    cfg = JobConfig(parallelism=2, batch_size=32, test_set_size=32)
    return make_spmd_bridge(Request.from_json(json.dumps(req)), dim, cfg,
                            lambda p: preds.append(p.value), lambda r: None, device="cpu")


def test_resident_bridge_bit_identical_to_host():
    rng = np.random.RandomState(0)
    dim, n = 6, 1500
    w = rng.randn(dim)
    X = rng.randn(n, dim).astype(np.float32)
    Y = (X @ w > 0).astype(np.float32)
    results = {}
    for mode in ("host", "resident"):
        preds = []
        br = _mk_bridge(preds)
        if mode == "resident":
            assert br.enable_resident_ingest()
            assert not br.supports_fused_ingest()
        i, sizes, s = 0, [1, 7, 150, 333, 64, 945], 0
        while i < n:
            m = min(sizes[s % len(sizes)], n - i)
            s += 1
            op = np.zeros(m, np.int64)
            if m > 10:
                op[m // 2] = 1  # a forecast mid-block
            br.handle_batch(X[i:i + m], Y[i:i + m], op)
            i += m
        snap = br.snapshot_buffers()
        br.flush()
        loss, score = br._evaluate()
        if mode == "resident":
            br._resident.sync_host()
        hx, hy = br.test_set.arrays()
        results[mode] = (
            br.trainer.global_flat_params().copy(), br.trainer.fitted,
            loss, score, hx.copy(), hy.copy(), list(preds),
            snap["test_x"].copy(), snap["stage_x"].copy(),
        )
    a, b = results["host"], results["resident"]
    assert a[1] == b[1]  # fitted
    assert (a[2], a[3]) == (b[2], b[3])  # loss, score
    np.testing.assert_array_equal(a[0], b[0])  # params
    np.testing.assert_array_equal(a[4], b[4])
    np.testing.assert_array_equal(a[5], b[5])
    assert a[6] == b[6] and len(a[6]) > 0  # forecasts
    np.testing.assert_array_equal(a[7], b[7])  # snapshot
    np.testing.assert_array_equal(a[8], b[8])


def test_resident_restore_roundtrip():
    rng = np.random.RandomState(3)
    dim = 6
    X = rng.randn(700, dim).astype(np.float32)
    Y = (X @ rng.randn(dim) > 0).astype(np.float32)
    preds = []
    src = _mk_bridge(preds)
    assert src.enable_resident_ingest()
    src.handle_batch(X, Y, np.zeros(len(X), np.int64))
    snap = src.snapshot_buffers()
    dst = _mk_bridge(preds)
    assert dst.enable_resident_ingest()
    dst.restore_buffers(snap)
    dst._resident.sync_host()
    src._resident.sync_host()
    for a, b in zip(src.test_set.arrays(), dst.test_set.arrays()):
        np.testing.assert_array_equal(a, b)
    assert len(dst.test_set) == len(src.test_set)
    assert dst._stage_n == src._stage_n
    # both go on to split and stage the same rows the same way
    for br in (src, dst):
        br.handle_batch(X[:300], Y[:300], np.zeros(300, np.int64))
        br._resident.sync_host()
    for a, b in zip(src.test_set.arrays(), dst.test_set.arrays()):
        np.testing.assert_array_equal(a, b)
    assert dst._stage_n == src._stage_n
    np.testing.assert_array_equal(src._stage.cols[0][:src._stage_n],
                                  dst._stage.cols[0][:dst._stage_n])


def test_resident_arming_refusals():
    preds = []
    # SSP pacing keeps per-row admission on the host: refused
    br = _mk_bridge(preds, protocol="SSP")
    assert not br.supports_resident_ingest()
    assert not br.enable_resident_ingest()
    # arming mid-stream (rows already buffered) is refused
    br2 = _mk_bridge(preds)
    br2.handle_batch(np.ones((20, 6), np.float32), np.ones(20, np.float32),
                     np.zeros(20, np.int64))
    assert not br2.enable_resident_ingest()
    # a padded-COO bridge stays on the host route
    sparse = _mk_bridge(preds, sparse=True)
    assert not sparse.supports_resident_ingest() and not sparse.enable_resident_ingest()
    # a fresh bridge arms, once
    br3 = _mk_bridge(preds)
    assert br3.enable_resident_ingest() and br3.enable_resident_ingest()


def test_resident_segments_keep_distinct_destinations():
    """_resident_seg_rows bounds a segment's test rows by the ring, in both
    packages, at every ring size and with the test split off."""
    from omldm_tpu.runtime.spmd_bridge import _resident_seg_rows as jax_seg
    from omldm_tpu_torch.runtime.spmd_bridge import _resident_seg_rows

    for cap in (1, 2, 3, 7, 32, 64, 256):
        m = _resident_seg_rows(cap, True)
        assert m == jax_seg(cap, True)
        assert 2 * (m // 10) + min(m % 10, 2) <= cap
    assert _resident_seg_rows(64, False) == jax_seg(64, False) == 4096


# --- backpressure probes --------------------------------------------------


def test_prefetcher_as_signal_reports_emptiness():
    from omldm_tpu_torch.runtime.prefetch import Prefetcher

    pf = Prefetcher(iter([1, 2, 3]), depth=2)
    probe = pf.as_signal()
    for _ in pf:
        pass
    value, high, critical = probe()
    assert (high, critical) == (0.75, 0.95)
    assert value == 1.0  # a drained ring: wholly parse-bound
    pf.close()


def test_spoke_probe_attach_detach():
    # overload unarmed: a no-op
    job = StreamJob(JobConfig(parallelism=1), device="cpu")
    job.process_event("requests", _pa_create())
    for spoke in job.spokes:
        spoke.attach_ingest_probe("x", lambda: (0.0, 1.0, 1.0))
        spoke.detach_ingest_probe("x")
    # overload armed (a host-plane net: the controller arms per net at
    # deploy): the probe lands in extra_signals and leaves it
    job2 = StreamJob(JobConfig(parallelism=1,
                               overload="window=8,share=2,hotHigh=6,hotCritical=12,cool=8"),
                     device="cpu")
    job2.process_event("requests", json.dumps({
        "id": 0,
        "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0}},
        "trainingConfiguration": {"protocol": "CentralizedTraining"},
    }))
    job2.ensure_deployed(6)
    probe = lambda: (0.0, 0.5, 0.9)  # noqa: E731
    armed = 0
    for spoke in job2.spokes:
        spoke.attach_ingest_probe("ingest_starvation", probe)
        if spoke.overload is not None:
            armed += 1
            assert spoke.overload.extra_signals["ingest_starvation"] is probe
        spoke.detach_ingest_probe("ingest_starvation")
        if spoke.overload is not None:
            assert "ingest_starvation" not in spoke.overload.extra_signals
    assert armed > 0


def test_sharded_run_detaches_its_probes(stream_file):
    """run_file_sharded attaches its two probes for the run and detaches
    them after, on a job whose overload plane is armed."""
    path, dim, _ = stream_file
    job = StreamJob(JobConfig(parallelism=1, batch_size=64, ingest="shards=2,chunkKb=16",
                              overload="window=8,share=2,hotHigh=6,hotCritical=12,cool=8"),
                    device="cpu")
    job.process_event("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0}},
        "trainingConfiguration": {"protocol": "CentralizedTraining"},
    }))
    job.ensure_deployed(dim)
    seen = []
    real = job.process_packed_batch

    def process(*block):
        seen.append(sorted(k for s in job.spokes if s.overload is not None
                           for k in s.overload.extra_signals))
        return real(*block)

    job.process_packed_batch = process
    assert job.run_file_sharded(path, dim=dim)
    assert seen and all(s == ["ingest_prefetch", "ingest_starvation"] for s in seen)
    assert all(not s.overload.extra_signals for s in job.spokes if s.overload is not None)
    job.terminate()
