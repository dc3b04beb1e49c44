"""The SPMD bridges' file routes in the port: the fused C parse -> holdout
-> stage loop, serial and double-buffered, and the CLI's fused half.

- Serial and overlapped ingest train the same launch sequence: parameters,
  fitted count, holdout ring, curve and predictions are bit-identical, with
  small chunks and a deep queue, dense and sparse.
- The fused route gives the JAX package's results on the same file, and
  ``python -m omldm_tpu_torch --device cpu`` gives the JAX CLI's
  predictions and statistics.
- SSP (paced launches), an fp16 feed and a host-plane job do not take the
  overlapped or the fused route; a dispatch-thread exception reaches the
  caller.
"""

import json

import numpy as np
import pytest

import omldm_tpu.__main__ as jax_cli
import omldm_tpu_torch.__main__ as port_cli
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from test_torch_spmd_bridge import assert_same_stats, eight_slots  # noqa: F401 (a fixture)

DIM, TEST_SET = 10, 32
SPARSE_DS = {"sparse": True, "nFeatures": 5 + 128, "hashSpace": 128, "maxNnz": 12}


def create(protocol="Synchronous", sparse=False, **extra):
    learner = {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
               "dataStructure": dict(SPARSE_DS) if sparse else {"nFeatures": DIM}}
    return {
        "id": 0, "request": "Create", "learner": learner, "preProcessors": [],
        "trainingConfiguration": {"protocol": protocol, "engine": "spmd", "syncEvery": 2,
                                  "extra": {"stageChain": 2, **extra}},
    }


def write_dense(path, n=6000, seed=0):
    """Training lines with a forecast every 613 lines and a line with a
    categorical feature (the Python codec's fallback) every 509."""
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    with open(path, "w") as f:
        for i in range(n):
            x = [round(float(v), 6) for v in rng.randn(DIM)]
            rec = {"numericalFeatures": x, "target": 1.0 if float(np.dot(x, w)) > 0 else 0.0}
            if i % 613 == 100:
                rec = {"numericalFeatures": x, "operation": "forecasting"}
            elif i % 509 == 77:
                rec["categoricalFeatures"] = ["blue"]
            f.write(json.dumps(rec) + "\n")


def write_sparse(path, n=5000, seed=3):
    """Criteo-like lines: 5 numerics, 6 categorical slots; forecasts and
    lines with escapes (the codec's fallback) in the mix."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            nums = [round(float(v), 6) for v in rng.randn(5)]
            cats = [f"c{j}_{rng.randint(50)}" for j in range(6)]
            rec = {"numericalFeatures": nums, "categoricalFeatures": cats,
                   "target": float(nums[0] > 0)}
            if i % 701 == 200:
                rec = {"numericalFeatures": nums, "categoricalFeatures": cats,
                       "operation": "forecasting"}
            elif i % 433 == 50:
                rec["categoricalFeatures"][0] = 'q"uote'
            f.write(json.dumps(rec) + "\n")


def make_job(request, parallelism=1, cls=StreamJob, cfg=JobConfig, **kw):
    job = cls(cfg(parallelism=parallelism, batch_size=64, test_set_size=TEST_SET), **kw)
    job.process_event("requests", json.dumps(request))
    return job


def bridge_state(bridge):
    tr = bridge.trainer
    ts = bridge.test_set
    arrays = [np.asarray(a) for a in ts.arrays()]
    return (tr.global_flat_params(), [p for p in tr.shard_params()], tr.fitted,
            tr.curve_slice(), arrays, bridge.holdout_count)


def assert_bitwise(a, b):
    flat_a, shards_a, fit_a, curve_a, hold_a, count_a = a
    flat_b, shards_b, fit_b, curve_b, hold_b, count_b = b
    np.testing.assert_array_equal(flat_a, flat_b)
    for sa, sb in zip(shards_a, shards_b):
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
    assert fit_a == fit_b and curve_a == curve_b and count_a == count_b
    for ha, hb in zip(hold_a, hold_b):
        np.testing.assert_array_equal(ha, hb)


# (sparse, sparseFusedIngest, parserThreads): the dense fused loop; the
# sparse fused line loop (one parse thread), the multithreaded block parse
# with the C stager, and the block parse with the numpy holdout and stage
ROUTES = {
    "dense": (False, "true", 1),
    "sparse-fused": (True, "true", 1),
    "sparse-blocks-c": (True, "true", 3),
    "sparse-blocks-numpy": (True, "false", 3),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_overlapped_matches_serial(tmp_path, eight_slots, route):
    """Small chunks (4 KB) and a queue four sets deep; specials quiesce the
    dispatch queue before they run inline."""
    sparse, fused_coo, threads = ROUTES[route]
    path = tmp_path / "s.jsonl"
    (write_sparse if sparse else write_dense)(str(path))
    request = create(sparse=sparse, sparseFusedIngest=fused_coo, parserThreads=threads)
    runs = []
    for overlapped in (False, True):
        job = make_job(request, parallelism=2, device="cpu")
        bridge = job.spmd_bridges[0]
        assert bridge.supports_overlapped_ingest()
        if overlapped:
            bridge.ingest_file_overlapped(str(path), chunk_bytes=4096, depth=4)
        else:
            bridge.ingest_file(str(path), chunk_bytes=4096)
        bridge.flush()
        runs.append((bridge_state(bridge), [p.value for p in job.predictions]))
    (serial, serial_preds), (over, over_preds) = runs
    assert serial_preds == over_preds and len(serial_preds) > 0
    assert serial[2] > 3000
    assert_bitwise(serial, over)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("protocol", ["Synchronous", "SSP"])
def test_fused_route_matches_jax(tmp_path, eight_slots, sparse, protocol):
    """StreamJob.run_file_fused in both packages on one file, at
    parallelism 4 (SSP takes the serial route, the others the overlapped)."""
    path = tmp_path / "s.jsonl"
    (write_sparse if sparse else write_dense)(str(path), n=3000)
    request = create(protocol=protocol, sparse=sparse)
    jax_job = make_job(request, 4, JaxStreamJob, JaxJobConfig)
    job = make_job(request, 4, device="cpu")
    assert job.spmd_bridges[0].supports_overlapped_ingest() == (protocol != "SSP")
    assert jax_job.run_file_fused(str(path)) and job.run_file_fused(str(path))
    jax_report, report = jax_job.terminate(), job.terminate()
    assert [p.value for p in job.predictions] == [p.value for p in jax_job.predictions]
    assert len(job.predictions) > 0
    [ts], [js] = report.statistics, jax_report.statistics
    assert ts.fitted > 2000
    assert_same_stats(ts.to_dict(), js.to_dict())


def test_routes_that_do_not_qualify(tmp_path):
    """SSP's paced launches keep the serial fused route; an fp16 feed keeps
    the packed route; a host-plane pipeline (or a second pipeline beside
    the bridge) keeps the event loop."""
    path = tmp_path / "s.jsonl"
    write_dense(str(path), n=200)
    ssp = make_job(create(protocol="SSP"), device="cpu").spmd_bridges[0]
    assert ssp.supports_fused_ingest() and not ssp.supports_overlapped_ingest()
    with pytest.raises(ValueError, match="chained launches"):
        ssp.ingest_file_overlapped(str(path))
    fp16 = make_job(create(feedDtype="float16"), device="cpu")
    assert not fp16.spmd_bridges[0].supports_fused_ingest()
    assert fp16.fused_file_bridge() is None and not fp16.run_file_fused(str(path))
    host = create()
    host["trainingConfiguration"]["engine"] = "host"
    host_job = make_job(host, device="cpu")
    assert not host_job.spmd_bridges and host_job.fused_file_bridge() is None
    two = make_job(create(), device="cpu")
    second = create()
    second["id"] = 1
    second["trainingConfiguration"]["engine"] = "host"
    two.process_event("requests", json.dumps(second))
    assert two.fused_file_bridge() is None
    off = make_job(create(overlappedIngest="false"), device="cpu")
    assert not off.spmd_bridges[0].supports_overlapped_ingest()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_worker_exception_propagates(tmp_path, sparse):
    path = tmp_path / "s.jsonl"
    (write_sparse if sparse else write_dense)(str(path), n=2000)
    bridge = make_job(create(sparse=sparse), device="cpu").spmd_bridges[0]

    def boom(*args):
        raise RuntimeError("device on fire")

    with pytest.raises(RuntimeError, match="device on fire"):
        bridge.ingest_file_overlapped(str(path), chunk_bytes=4096, train_fn=boom)


def run_cli(cli, tmp_path, tag, argv):
    out = tmp_path / tag
    out.mkdir()
    argv = list(argv) + ["--predictionsOut", str(out / "pred.jsonl"),
                         "--performanceOut", str(out / "perf.jsonl")]
    argv += ["--compileCache", "off"] if cli is jax_cli else ["--device", "cpu"]
    assert cli.main(argv) == 0
    preds = [json.loads(line) for line in (out / "pred.jsonl").read_text().splitlines()]
    [perf] = [json.loads(line) for line in (out / "perf.jsonl").read_text().splitlines()]
    return preds, perf


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_cli_fused_route_matches_jax(tmp_path, monkeypatch, eight_slots, sparse):
    """The requests replayed first, then the training file through the
    fused loop (the run goes through run_file_fused), on both CLIs."""
    train = tmp_path / "train.jsonl"
    (write_sparse if sparse else write_dense)(str(train), n=3000)
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text(json.dumps(create(sparse=sparse)) + "\n")
    fused_calls = []
    real = StreamJob.run_file_fused

    def spy(self, path):
        fused_calls.append(path)
        return real(self, path)

    monkeypatch.setattr(StreamJob, "run_file_fused", spy)
    argv = ["--trainingData", str(train), "--requests", str(reqs),
            "--parallelism", "4", "--batchSize", "64", "--testSetSize", str(TEST_SET)]
    jax_preds, jax_perf = run_cli(jax_cli, tmp_path, "jax", argv)
    preds, perf = run_cli(port_cli, tmp_path, "port", argv)
    assert fused_calls == [str(train)]
    assert [p["value"] for p in preds] == [p["value"] for p in jax_preds]
    assert len(preds) > 0
    [ts], [js] = perf["statistics"], jax_perf["statistics"]
    assert ts["fitted"] > 2000
    assert_same_stats(ts, js)


def test_cli_fused_opt_out_takes_the_packed_route(tmp_path, monkeypatch):
    """--fusedIngest false keeps the requests-then-packed route."""
    train = tmp_path / "train.jsonl"
    write_dense(str(train), n=500)
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text(json.dumps(create()) + "\n")
    monkeypatch.setattr(StreamJob, "run_file_fused",
                        lambda self, path: pytest.fail("fused route taken"))
    preds, perf = run_cli(port_cli, tmp_path, "port", [
        "--trainingData", str(train), "--requests", str(reqs), "--fusedIngest", "false"])
    assert perf["statistics"][0]["fitted"] > 300 and len(preds) > 0
