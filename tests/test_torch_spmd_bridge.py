"""StreamJob with ``engine: spmd`` in the port against the JAX package's job,
dense and sparse, on the same events.

Statistics must be equal (bytesShipped, modelsShipped, numOfBlocks, fitted
and every other counter), predictions equal, the score within 1e-4 and the
learning curve and query parameters within the parity tolerance.
"""

import json

import numpy as np
import pytest

from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob, spmd_bridge
from omldm_tpu_torch.runtime.spmd_bridge import SparseSPMDBridge, SPMDBridge

DIM = 6
BATCH, TEST_SET = 32, 32
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}
PROTOCOLS = ["Synchronous", "EASGD", "GM", "FGM", "Asynchronous", "SSP"]


@pytest.fixture
def eight_slots(monkeypatch):
    """The JAX job lays parallelism > 1 over the 8 virtual CPU devices that
    conftest.py gives it; the port's CPU offers one mesh slot, which would
    fold every worker into one. Give the port the same 8 slots, so both
    engines run the same dp workers (on the port, rows of one device)."""
    monkeypatch.setattr(spmd_bridge, "device_slots", lambda device: 8)


def create(net_id=0, protocol="Synchronous", engine="spmd", learner="PA", hp=None,
           ds=None, request="Create", **tc):
    return json.dumps({
        "id": net_id, "request": request,
        "learner": {"name": learner, "hyperParameters": hp or {"C": 1.0},
                    "dataStructure": ds or {}},
        "trainingConfiguration": {"protocol": protocol, "syncEvery": 2, "engine": engine,
                                  "threshold": 0.3, **tc},
    })


def dense_records(n, seed=0, forecast_every=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    x = np.round(rng.randn(n, DIM), 5)
    y = (x @ w > 0).astype(np.float64)
    out = []
    for i in range(n):
        if forecast_every and i % forecast_every == forecast_every - 1:
            out.append(("forecastingData", json.dumps(
                {"numericalFeatures": list(x[i])})))
        else:
            out.append(("trainingData", json.dumps(
                {"numericalFeatures": list(x[i]), "target": float(y[i])})))
    return out


SPARSE_DS = {"sparse": True, "nFeatures": 4 + 64, "hashSpace": 64, "maxNnz": 8}


def sparse_records(n, seed=0, forecast_every=0):
    """Criteo-like records, at a small width: 4 numerics and 3 categorical
    slots hashed into 64."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        nums = list(np.round(rng.randn(4), 4))
        cats = [f"c{rng.randint(5)}", f"d{rng.randint(7)}", f"e{rng.randint(3)}"]
        rec = {"numericalFeatures": nums, "categoricalFeatures": cats}
        if forecast_every and i % forecast_every == forecast_every - 1:
            out.append(("forecastingData", json.dumps(rec)))
        else:
            rec["target"] = float((nums[0] + (cats[0] == "c1")) > 0)
            out.append(("trainingData", json.dumps(rec)))
    return out


def run_pair(events, parallelism, batch=BATCH):
    cfg = dict(parallelism=parallelism, batch_size=batch, test_set_size=TEST_SET)
    jax_job = JaxStreamJob(JaxJobConfig(**cfg))
    job = StreamJob(JobConfig(**cfg), device="cpu")
    jax_report = jax_job.run(events)
    report = job.run(events)
    return jax_job, jax_report, job, report


def assert_same_stats(td, jd):
    """Two statistics reports' dicts: integers equal, floats (the score
    too) within 1e-4, lists within atol 1e-4; wall-clock fields left out."""
    assert set(td) == set(jd)
    for key, jv in jd.items():
        tv = td[key]
        if key in WALL_CLOCK_FIELDS:
            continue
        if isinstance(jv, list):
            assert len(tv) == len(jv), key
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=key)
        elif isinstance(jv, float):
            assert abs(tv - jv) <= 1e-4, (key, tv, jv)
        else:
            assert tv == jv, (key, tv, jv)


def assert_same_run(jax_job, jax_report, job, report):
    jp = [p.value for p in jax_job.predictions]
    tp = [p.value for p in job.predictions]
    assert tp == jp
    assert len(job.responses) == len(jax_job.responses)
    for tr, jr in zip(job.responses, jax_job.responses):
        assert (tr.response_id, tr.mlp_id, tr.data_fitted, tr.protocol) == (
            jr.response_id, jr.mlp_id, jr.data_fitted, jr.protocol)
        jv = (jr.learner.get("parameters") or {}).get("values")
        tv = (tr.learner.get("parameters") or {}).get("values")
        assert (tv is None) == (jv is None)
        if jv is not None:
            np.testing.assert_allclose(tv, jv, rtol=2e-4, atol=2e-5)
        assert abs((tr.score or 0.0) - (jr.score or 0.0)) <= 1e-4
    assert len(report.statistics) == len(jax_report.statistics)
    for ts, js in zip(sorted(report.statistics, key=lambda s: s.pipeline),
                      sorted(jax_report.statistics, key=lambda s: s.pipeline)):
        assert_same_stats(ts.to_dict(), js.to_dict())


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_dense_lifecycle_matches_jax(eight_slots, protocol):
    """Records one by one at parallelism 4 (4 SPMD workers), a forecast
    every 7th record, a Query halfway."""
    events = [("requests", create(protocol=protocol))]
    records = dense_records(1500, forecast_every=7)
    events += records[:750] + [("requests", json.dumps(
        {"id": 0, "request": "Query", "requestId": 9}))] + records[750:]
    jax_job, jax_report, job, report = run_pair(events, 4)
    assert isinstance(job.spmd_bridges[0], SPMDBridge)
    assert job.spmd_bridges[0].dp == 4
    assert [r.response_id for r in job.responses] == [9]
    assert report.statistics[0].fitted > 1000
    assert_same_run(jax_job, jax_report, job, report)


def run_packed_pair(protocol, **tc):
    """Blocks of packed rows (process_packed_batch, as the CLI's packed
    route and protocol_comparison.py feed a job), forecasts inside."""
    rng = np.random.RandomState(3)
    w = rng.randn(DIM)
    x = rng.randn(3000, DIM).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    op = np.zeros(3000, np.uint8)
    op[::50] = 1
    cfg = dict(parallelism=4, batch_size=BATCH, test_set_size=TEST_SET)
    jax_job = JaxStreamJob(JaxJobConfig(**cfg))
    job = StreamJob(JobConfig(**cfg), device="cpu")
    for j in (jax_job, job):
        j.process_event("requests", create(protocol=protocol, stageChain=3, **tc))
        for i in range(0, 3000, 1024):
            j.process_packed_batch(x[i : i + 1024], y[i : i + 1024], op[i : i + 1024])
    assert_same_run(jax_job, jax_job.terminate(), job, job.terminate())
    assert len(job.predictions) == 60
    return job


@pytest.mark.parametrize("protocol", ["Synchronous", "SSP"])
def test_packed_blocks_match_jax(eight_slots, protocol):
    run_packed_pair(protocol)


@pytest.mark.parametrize("protocol", ["Synchronous", "SSP"])
def test_fp16_feed_matches_jax(eight_slots, protocol):
    """feedDtype float16 stages the rows at half width (chained full
    stages, whole groups and the striped tail, SSP's requeue); both engines
    round them the same way before the float32 step."""
    job = run_packed_pair(protocol, feedDtype="float16")
    assert job.spmd_bridges[0].feed_dtype == np.float16


@pytest.mark.parametrize("parallelism", [1, 4])
@pytest.mark.parametrize("protocol", ["Synchronous", "Asynchronous"])
def test_sparse_matches_jax(eight_slots, protocol, parallelism):
    events = [("requests", create(protocol=protocol, hp={"C": 0.1, "variant": "PA-II"},
                                  ds=SPARSE_DS))]
    records = sparse_records(1200, forecast_every=9)
    events += records[:600] + [("requests", json.dumps(
        {"id": 0, "request": "Query", "requestId": 4}))] + records[600:]
    jax_job, jax_report, job, report = run_pair(events, parallelism)
    assert isinstance(job.spmd_bridges[0], SparseSPMDBridge)
    assert_same_run(jax_job, jax_report, job, report)


def test_the_bench_job_at_parallelism_one():
    """The bench job's shape (Softmax, 2 classes, Synchronous, one worker,
    chained stages) with no slot patch: one worker on the CPU."""
    hp = {"learningRate": 0.05, "nClasses": 2}
    events = [("requests", create(learner="Softmax", hp=hp, stageChain=4))]
    events += dense_records(2500, seed=2)
    jax_job, jax_report, job, report = run_pair(events, 1, batch=64)
    assert job.spmd_bridges[0].dp == 1
    assert_same_run(jax_job, jax_report, job, report)


def test_delete_and_update_across_planes(eight_slots):
    """Delete drops the bridge; an Update moves a pipeline from the SPMD
    engine to the host plane and back, tearing down the old deployment."""
    records = dense_records(1800, seed=4, forecast_every=11)
    events = (
        [("requests", create(net_id=0)), ("requests", create(net_id=1))]
        + records[:600]
        + [("requests", json.dumps({"id": 1, "request": "Delete"})),
           ("requests", create(net_id=0, engine="", protocol="Asynchronous",
                               request="Update"))]
        + records[600:1200]
        + [("requests", create(net_id=0, protocol="GM", request="Update"))]
        + records[1200:]
    )
    jax_job, jax_report, job, report = run_pair(events, 2)
    assert set(job.spmd_bridges) == {0} and 1 not in job.pipeline_manager.node_map
    assert not any(0 in spoke.nets for spoke in job.spokes)
    assert_same_run(jax_job, jax_report, job, report)


@pytest.mark.parametrize("protocol,learner,ds", [
    ("SingleLearner", "PA", {}),
    ("CentralizedTraining", "PA", {}),
    ("Synchronous", "HT", {"nClasses": 2}),
])
def test_unhosted_pipelines_fall_back_to_the_host_plane(eight_slots, protocol, learner, ds):
    """engine: spmd with a protocol or learner the engine does not host
    deploys on the host plane, as in the JAX package."""
    events = [("requests", create(protocol=protocol, learner=learner, ds=ds))]
    events += dense_records(600, seed=5, forecast_every=13)
    jax_job, jax_report, job, report = run_pair(events, 2)
    assert not job.spmd_bridges and not jax_job.spmd_bridges
    assert_same_run(jax_job, jax_report, job, report)


def test_gate_admits_the_engine():
    """The gate admits engine: spmd (no dead letter) and the Create
    deploys on a bridge."""
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", create())] + dense_records(50), terminate_on_end=False)
    assert not job.dead_letter.entries
    assert isinstance(job.spmd_bridges[0], SPMDBridge)
