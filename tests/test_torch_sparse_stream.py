"""The sparse (padded-COO) streaming path: the same JSON event stream through
the JAX StreamJob and the port's StreamJob(device="cpu") -- a sparse Create
(D = 13 + 2^12, Criteo-shaped records: 13 numerics and 26 hashed
categoricals), training records with 10% forecasts, a Query mid-stream,
termination -- plus the vectorizer, the batcher and the control gate.

Tolerances, as for the dense stream (tests/test_torch_stream_job.py): a
classifier's prediction is a sign and a margin near zero may flip under
float32 sums in another order, so at least 99% of predictions must be equal
(the regressor's within rtol=2e-4, atol=2e-5); Query parameters within
rtol=2e-4, atol=2e-5; every integer field of the final JobStatistics
equal, float fields within 1e-4, the holdout score within one holdout row
(1/testSetSize); wall-clock fields excluded by name."""

import json

import numpy as np
import pytest
import torch

from omldm_tpu.api.data import DataInstance as JaxDataInstance
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime.vectorizer import SparseMicroBatcher as JaxSparseMicroBatcher
from omldm_tpu.runtime.vectorizer import SparseVectorizer as JaxSparseVectorizer
from omldm_tpu_torch.api.data import DataInstance
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime.vectorizer import SparseMicroBatcher, SparseVectorizer

HASH_SPACE = 1 << 12
DIM = 13 + HASH_SPACE
BATCH, N_TRAIN, TEST_SET = 64, 2000, 128
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}
LEARNERS = {
    "PA": {"C": 0.1, "variant": "PA-II"},
    "RegressorPA": {"C": 0.1, "epsilon": 0.1},
    "SVM": {"lambda": 1e-3},
    "Softmax": {"learningRate": 0.05, "nClasses": 2},
}


def _record(rng, w, forecast=False):
    x = np.round(rng.randn(13), 6)
    cats = rng.randint(0, 1000, size=26)
    rec = {"numericalFeatures": x.tolist(),
           "categoricalFeatures": [f"f{j}_v{c}" for j, c in enumerate(cats)]}
    if not forecast:
        rec["target"] = float(x @ w > 0)
    return json.dumps(rec)


def make_events(learner, per_record, seed=0, n_train=N_TRAIN):
    rng = np.random.RandomState(seed)
    w = rng.randn(13)
    events = [("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": learner, "hyperParameters": LEARNERS[learner],
                    "dataStructure": {"sparse": True, "nFeatures": DIM,
                                      "hashSpace": HASH_SPACE, "maxNnz": 40}},
        "trainingConfiguration": {"protocol": "Asynchronous", "perRecord": per_record},
    }))]
    for i in range(n_train):
        events.append(("trainingData", _record(rng, w)))
        if i % 9 == 8:
            events.append(("forecastingData", _record(rng, w, forecast=True)))
        if i == n_train // 2:
            events.append(("requests", json.dumps(
                {"id": 0, "request": "Query", "requestId": 7})))
    return events


@pytest.mark.parametrize("learner,per_record", [
    ("PA", False), ("PA", True), ("RegressorPA", False), ("SVM", False),
    ("Softmax", False),
])
def test_sparse_stream_job_matches_jax(learner, per_record):
    events = make_events(learner, per_record, seed=len(learner))
    n_forecasts = sum(1 for s, _ in events if s == "forecastingData")
    config = dict(parallelism=4, batch_size=BATCH, test_set_size=TEST_SET)
    jax_job = JaxStreamJob(JaxJobConfig(**config))
    jax_report = jax_job.run(events)
    job = StreamJob(JobConfig(**config), device="cpu")
    report = job.run(events)
    assert not job.dead_letter.entries

    jp = np.array([p.value for p in jax_job.predictions])
    tp = np.array([p.value for p in job.predictions])
    assert len(tp) == len(jp) == n_forecasts
    if learner == "RegressorPA":
        np.testing.assert_allclose(tp, jp, rtol=2e-4, atol=2e-5)
    else:
        mismatches = int((tp != jp).sum())
        print(f"prediction mismatches: {mismatches}/{len(tp)}")
        assert mismatches <= 0.01 * len(tp)

    [jr] = jax_job.responses
    [tr] = job.responses
    assert tr.response_id == jr.response_id == 7
    assert tr.data_fitted == jr.data_fitted
    assert tr.learner["dataStructure"] == jr.learner["dataStructure"]
    values = tr.learner["parameters"]["values"]
    width = 2 * (DIM + 1) if learner == "Softmax" else DIM + 1 + (learner == "SVM")
    assert len(values) == width
    np.testing.assert_allclose(values, jr.learner["parameters"]["values"], rtol=2e-4, atol=2e-5)
    assert abs(tr.loss - jr.loss) <= 1e-4
    assert abs(tr.score - jr.score) <= 1.0 / TEST_SET + 1e-9

    [ts] = report.statistics
    [js] = jax_report.statistics
    td, jd = ts.to_dict(), js.to_dict()
    assert set(td) == set(jd)
    assert td["fitted"] > 0 and td["forecastsServed"] == n_forecasts
    for key, jv in jd.items():
        tv = td[key]
        if key in WALL_CLOCK_FIELDS:
            continue
        if key == "score":
            assert abs(tv - jv) <= 1.0 / TEST_SET + 1e-9, key
        elif isinstance(jv, list):
            assert len(tv) == len(jv), key
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=key)
        elif isinstance(jv, float):
            assert abs(tv - jv) <= 1e-4, (key, tv, jv)
        else:
            assert tv == jv, (key, tv, jv)
    if learner == "PA":
        assert ts.score > 0.6


def test_sparse_state_stays_on_the_device_and_wide():
    job = StreamJob(JobConfig(parallelism=2, batch_size=BATCH), device="cpu")
    job.run(make_events("PA", False, n_train=300))
    for spoke in job.spokes:
        net = spoke.nets[0]
        assert net.sparse
        params = net.pipeline.state["params"]
        assert params["w"].shape == (DIM + 1,) and params["w"].device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_vectorizer_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ours = SparseVectorizer(DIM, HASH_SPACE, 40)
    theirs = JaxSparseVectorizer(DIM, HASH_SPACE, 40)
    w = rng.randn(13)
    for _ in range(50):
        line = _record(rng, w)
        payload = json.loads(line)
        payload["numericalFeatures"][3] = 0.0  # a zero numeric takes no slot
        line = json.dumps(payload)
        ti, tv = ours.vectorize(DataInstance.parse(line)[0])
        ji, jv = theirs.vectorize(JaxDataInstance.parse(line)[0])
        assert ti.dtype == np.int32 and tv.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        assert (ti < DIM).all() and int((tv != 0).sum()) == 38


def test_sparse_vectorizer_respects_the_budget():
    inst = DataInstance.parse(json.dumps({
        "numericalFeatures": [1.0, 2.0, 3.0], "categoricalFeatures": ["a", "b", "c"],
        "target": 1.0}))[0]
    idx, val = SparseVectorizer(3 + 16, 16, 4).vectorize(inst)
    assert list(idx[:3]) == [0, 1, 2] and list(val[:3]) == [1.0, 2.0, 3.0]
    assert 3 <= idx[3] < 19 and abs(val[3]) == 1.0


def test_sparse_micro_batcher_matches_jax():
    rng = np.random.RandomState(3)
    ours, theirs = SparseMicroBatcher(5, 4), JaxSparseMicroBatcher(5, 4)
    for _ in range(3):
        idx = rng.randint(0, 50, 5).astype(np.int32)
        val = rng.randn(5).astype(np.float32)
        y = float(rng.randint(0, 2))
        ours.add((idx, val), y)
        theirs.add(idx, val, y)
    assert not ours.full
    (ti, tv), ty, tm = ours.flush()
    (ji, jv), jy, jm = theirs.flush()
    for a, b in ((ti, ji), (tv, jv), (ty, jy), (tm, jm)):
        np.testing.assert_array_equal(a, b)
    assert list(tm) == [1.0, 1.0, 1.0, 0.0] and ours.flush() is None


def _create(learner="PA", ds=None, preps=()):
    return json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": learner, "hyperParameters": {},
                    "dataStructure": {"sparse": True, "nFeatures": DIM}
                    if ds is None else ds},
        "preProcessors": [{"name": p} for p in preps],
        "trainingConfiguration": {"protocol": "Asynchronous"},
    })


@pytest.mark.parametrize("request_json,reason", [
    (_create(ds={"sparse": True}), "require dataStructure.nFeatures"),
    (_create(preps=("StandardScaler",)), "do not take preprocessors"),
    (_create(learner="ORR"), "learner 'ORR' has no sparse variant"),
    (_create(learner="K-means"), "learner 'K-means' has no sparse variant"),
    (_create(learner="Nope"), "unknown learner 'Nope'"),
    (_create(learner="NN"), "learner 'NN' has no sparse variant"),
    (_create(learner="MultiClassPA"), "learner 'MultiClassPA' has no sparse variant"),
    (_create(preps=("PolynomialFeatures",)), "do not take preprocessors"),
    (_create(ds={"sparse": True, "nFeatures": 13, "hashSpace": 4096}),
     "hashSpace 4096 must lie in [0, nFeatures 13]"),
    (_create(ds={"sparse": True, "nFeatures": DIM, "hashSpace": -1}),
     f"hashSpace -1 must lie in [0, nFeatures {DIM}]"),
    (_create(ds={"sparse": True, "nFeatures": "wide", "hashSpace": 16}),
     "must be integers"),
])
def test_gate_refuses(request_json, reason):
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", request_json)])
    [entry] = job.dead_letter.entries
    assert entry["reason"] == "rejected_request"
    assert reason in entry["detail"]
    assert job.pipeline_manager.live_pipelines == []


@pytest.mark.parametrize("learner", sorted(LEARNERS))
def test_gate_admits_every_sparse_variant(learner):
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.run([("requests", _create(learner))], terminate_on_end=False)
    assert not job.dead_letter.entries
    assert job.pipeline_manager.live_pipelines == [0]
    assert job._dims[0] == DIM  # the exact sparse width, hashDims not added


def test_sparse_create_wants_cuda_without_a_device():
    """StreamJob() with no device wants CUDA; on a host without a card it
    raises before any sparse Create can be routed."""
    if torch.cuda.is_available():
        job = StreamJob(JobConfig(parallelism=2))
        assert job.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamJob(JobConfig(parallelism=2)).run([("requests", _create())])


def test_too_wide_hash_space_is_refused_and_the_stream_runs_on():
    """A sparse Create whose hashSpace (4096) exceeds its nFeatures (13)
    goes to the dead-letter sink, its reason naming both numbers, while a
    valid sparse pipeline in the same stream keeps its parity with the JAX
    StreamJob. The JAX package admits the wide Create and trains a model of
    NaN margins beside the valid one (``jnp.take`` out of range); the port
    refuses it on purpose, so only pipeline 0 is compared."""
    events = make_events("PA", False, seed=5, n_train=600)
    bad = json.loads(_create(ds={"sparse": True, "nFeatures": 13, "hashSpace": 4096,
                                 "maxNnz": 40}))
    bad["id"] = 1
    events.insert(1, ("requests", json.dumps(bad)))
    config = dict(parallelism=2, batch_size=BATCH, test_set_size=TEST_SET)
    jax_job = JaxStreamJob(JaxJobConfig(**config))
    jax_report = jax_job.run(events)
    job = StreamJob(JobConfig(**config), device="cpu")
    report = job.run(events)

    [entry] = job.dead_letter.entries
    assert entry["reason"] == "rejected_request"
    assert "hashSpace 4096" in entry["detail"] and "nFeatures 13" in entry["detail"]
    assert job.pipeline_manager.live_pipelines == [0]
    assert sorted(s.pipeline for s in jax_report.statistics) == [0, 1]

    jp = np.array([p.value for p in jax_job.predictions if p.mlp_id == 0])
    tp = np.array([p.value for p in job.predictions])
    assert all(p.mlp_id == 0 for p in job.predictions)
    assert len(tp) == len(jp) == sum(1 for s, _ in events if s == "forecastingData")
    assert int((tp != jp).sum()) <= 0.01 * len(tp)
    [jr] = jax_job.responses  # the Query names pipeline 0
    [tr] = job.responses
    assert tr.mlp_id == jr.mlp_id == 0
    np.testing.assert_allclose(tr.learner["parameters"]["values"],
                               jr.learner["parameters"]["values"], rtol=2e-4, atol=2e-5)
    [ts] = report.statistics
    [js] = [s for s in jax_report.statistics if s.pipeline == 0]
    assert ts.fitted == js.fitted and ts.forecasts_served == js.forecasts_served
    assert abs(ts.score - js.score) <= 1.0 / TEST_SET + 1e-9
    np.testing.assert_allclose(ts.learning_curve, js.learning_curve, rtol=0, atol=1e-4)
