"""The port's adaptive-batching serving plane (runtime/serving.py) on the
CPU: spec parsing against the JAX package's, exact-mode identity with the
unarmed port, armed port against armed JAX (exact and relaxed), and the
flush triggers (fill, deadline on an injected clock, fit and hub fences,
query, Delete, terminate).

Exact mode flushes a queue before any change to its net's model, so every
answer uses the parameters the immediate path would have used: the armed
job must emit the unarmed job's predictions -- each record's value exactly,
each worker's forecasts in the same order. (The port's smallest job has two
workers: parallelism 1 forces a protocol it does not have yet. Across
workers a queue may flush after another worker's forecasts, so the global
interleaving may move, as in the JAX package.) Against the JAX package the
stream tolerances of tests/test_torch_stream_job.py apply: >= 99% of
predictions equal, in count and order."""

import dataclasses
import json

import numpy as np
import pytest

import omldm_tpu.runtime.serving as jax_serving
from omldm_tpu.api.requests import TrainingConfiguration as JaxTC
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import serving
from omldm_tpu_torch.utils.clock import ManualClock

DIM = 8
SPARSE_DENSE, SPARSE_HASH = 4, 64
EXACT = {"staleness": "exact", "maxBatch": 16, "maxDelayMs": 1e9}
RELAXED = {"staleness": "relaxed", "staleChunks": 4, "maxBatch": 64, "maxDelayMs": 1e9}
QUIET = {"maxBatch": 1000, "maxDelayMs": 1e9}

GOOD_SPECS = [
    None, False, "", True, "on", "exact", "relaxed", "maxBatch=16,maxDelayMs=2.5",
    "maxBatch=8, staleness=relaxed, staleChunks=0", {},
    {"maxBatch": 32, "maxDelayMs": 9, "staleness": "relaxed", "staleChunks": 2},
    {"maxBatch": "4", "staleness": "EXACT"},
]
BAD_SPECS = [
    {"staleness": "sloppy"}, {"maxBatch": 0}, {"maxDelayMs": -1}, {"staleChunks": -2},
    "maxBatch", 7, {"maxbatch": 4}, "maxBatch=x", [1],
]


@pytest.mark.parametrize("spec", GOOD_SPECS, ids=repr)
def test_parse_serving_spec_matches_reference(spec):
    port, ref = serving.parse_serving_spec(spec), jax_serving.parse_serving_spec(spec)
    if ref is None:
        assert port is None
    else:
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert serving.validate_serving(TrainingConfiguration(extra={"serving": spec})) is None


@pytest.mark.parametrize("spec", BAD_SPECS, ids=repr)
def test_bad_serving_spec_raises_like_reference(spec):
    with pytest.raises((ValueError, TypeError)) as port_exc:
        serving.parse_serving_spec(spec)
    with pytest.raises((ValueError, TypeError)) as ref_exc:
        jax_serving.parse_serving_spec(spec)
    assert type(port_exc.value) is type(ref_exc.value)
    assert str(port_exc.value) == str(ref_exc.value)
    port_err = serving.validate_serving(TrainingConfiguration(extra={"serving": spec}))
    assert port_err is not None
    assert port_err == jax_serving.validate_serving(JaxTC(extra={"serving": spec}))


def test_job_default_and_pipeline_override():
    assert serving.serving_config(TrainingConfiguration(), "maxBatch=16").max_batch == 16
    assert serving.serving_config(TrainingConfiguration(extra={"serving": False}),
                                  "maxBatch=16") is None
    own = TrainingConfiguration(extra={"serving": {"maxBatch": 8}})
    assert serving.serving_config(own, "maxBatch=16").max_batch == 8


def test_note_many_matches_note():
    """The bulk latency-ring write equals one note() a sample, across the
    ring's wrap and past its capacity."""
    one, many = serving.ServeStats(cap=8), serving.ServeStats(cap=8)
    rng = np.random.RandomState(0)
    for k in (3, 6, 11, 1):
        lat = rng.rand(k)
        for v in lat:
            one.note(float(v))
        many.note_many(lat)
        assert one.count == many.count
        assert one.percentiles() == many.percentiles()


# --- the job harness -----------------------------------------------------------


def _create(pid, serve, sparse=False, per_record=False, protocol="Asynchronous"):
    tc = {"protocol": protocol, "perRecord": per_record}
    if serve is not None:
        tc["serving"] = serve
    if sparse:
        learner = {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                   "dataStructure": {"sparse": True, "nFeatures": SPARSE_DENSE + SPARSE_HASH,
                                     "hashSpace": SPARSE_HASH, "maxNnz": 8}}
    else:
        learner = {"name": "PA", "hyperParameters": {"C": 1.0},
                   "dataStructure": {"nFeatures": DIM}}
    return json.dumps({"id": pid, "request": "Create", "learner": learner,
                       "trainingConfiguration": tc})


def _job(serve, parallelism=2, n_pipe=1, sparse=False, jax=False, job_serving="", **kw):
    cfg = dict(parallelism=parallelism, batch_size=16, test_set_size=16, serving=job_serving)
    job = JaxStreamJob(JaxJobConfig(**cfg)) if jax else StreamJob(JobConfig(**cfg), device="cpu")
    for pid in range(n_pipe):
        job.process_event("requests", _create(pid, serve, sparse, **kw))
    return job


def _packed_rows(records=900, forecast_every=9, seed=3, width=DIM):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(5).randn(width)
    x = rng.randn(records, width).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    op = np.zeros(records, np.uint8)
    op[::forecast_every] = 1
    return x, y, op


def _feed_packed(job, rows, chunk=128):
    x, y, op = rows
    for i in range(0, x.shape[0], chunk):
        job.process_packed_batch(x[i : i + chunk], y[i : i + chunk], op[i : i + chunk])
    return job.terminate()


def _record_events(records=500, sparse=False, seed=2):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(5).randn(SPARSE_DENSE if sparse else DIM)
    events = []
    for i in range(records):
        f = np.round(rng.randn(len(w)), 6)
        rec = {"numericalFeatures": f.tolist()}
        if sparse:
            rec["categoricalFeatures"] = [f"a{rng.randint(6)}", f"b{rng.randint(6)}"]
        if i % 7 == 0:
            events.append(("forecastingData", json.dumps(rec)))
        else:
            rec["target"] = float(f @ w > 0)
            events.append(("trainingData", json.dumps(rec)))
    return events


def _digest(job, report):
    """Per-net ordered (features, value) prediction streams + scores."""
    ordered = {}
    for p in job.predictions:
        feats = tuple(np.asarray(p.data_instance.numerical_features, np.float64).tolist())
        ordered.setdefault(p.mlp_id, []).append((feats, p.value))
    return ordered, {s.pipeline: s.score for s in report.statistics}


def _run(serve, route, sparse=False, **kw):
    job = _job(serve, sparse=sparse, **kw)
    if route == "packed":
        report = _feed_packed(job, _packed_rows(width=SPARSE_DENSE + SPARSE_HASH if sparse
                                                else DIM))
    else:
        report = job.run(_record_events(sparse=sparse))
    return job, report


# --- exact mode: the unarmed port's predictions ------------------------------------


@pytest.mark.parametrize("per_record", [False, True], ids=["batch", "perRecord"])
@pytest.mark.parametrize("route", ["packed", "records"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_exact_mode_emits_the_unarmed_predictions(sparse, route, per_record):
    """Parallelism 2 (the port's smallest Asynchronous job), one pipeline
    per worker: every worker's forecasts come out with the same values in
    the same order, and the scores are equal."""
    off = _digest(*_run(None, route, sparse, per_record=per_record))
    on_job, on_report = _run(EXACT, route, sparse, per_record=per_record)
    on = _digest(on_job, on_report)
    assert on[1] == off[1]
    for pid in off[0]:
        assert dict(on[0][pid]) == dict(off[0][pid])
        assert len(on[0][pid]) == len(off[0][pid]) > 0
    assert all(s.serving_plane is not None for s in on_job.spokes)
    assert sum(s.forecasts_served for s in on_report.statistics) == \
        sum(len(v) for v in off[0].values())


@pytest.mark.parametrize("route", ["packed", "records"])
def test_exact_mode_keeps_each_workers_order(route):
    """Each worker's own forecasts leave in stream order and with the
    unarmed values: the emission order restricted to one worker equals the
    unarmed job's (only the interleaving across workers may move)."""
    def run(serve):
        job = _job(serve, n_pipe=2)
        emitted = []
        for spoke in job.spokes:
            wid = spoke.worker_id
            single, many = spoke._emit_prediction, spoke._emit_predictions

            def one(p, wid=wid, single=single):
                emitted.append((wid, p.mlp_id, p.value,
                                tuple(np.asarray(p.data_instance.numerical_features).tolist())))
                single(p)

            def bulk(ps, wid=wid, many=many):
                for p in ps:
                    emitted.append((wid, p.mlp_id, p.value,
                                    tuple(np.asarray(p.data_instance.numerical_features).tolist())))
                many(ps)

            spoke._emit_prediction = one
            spoke._emit_predictions = bulk
            if spoke.serving_plane is not None:
                spoke.serving_plane._emit, spoke.serving_plane._emit_many = one, bulk
        if route == "packed":
            _feed_packed(job, _packed_rows())
        else:
            job.run(_record_events())
        return emitted

    off, on = run(None), run(EXACT)
    assert len(on) == len(off) > 0
    for w in (0, 1):
        for pid in (0, 1):
            sel = lambda e: [x[2:] for x in e if x[0] == w and x[1] == pid]  # noqa: E731
            assert sel(on) == sel(off)


def test_job_default_arms_every_pipeline():
    job, report = _run(None, "packed", job_serving="exact", n_pipe=2)
    for spoke in job.spokes:
        assert spoke.serving_plane is not None
        assert all(net.serving is not None for net in spoke.nets.values())
    assert sum(s.forecasts_served for s in report.statistics) == 2 * 100


def test_no_plane_objects_when_unset():
    job, _ = _run(None, "packed")
    for spoke in job.spokes:
        assert spoke.serving_plane is None and not spoke._any_serving
        assert all(net.serving is None for net in spoke.nets.values())


# --- against the JAX package ------------------------------------------------------


def _assert_close_to_jax(port, ref, min_count):
    (po, ps), (ro, rs) = port, ref
    assert set(po) == set(ro)
    for pid in ro:
        pv, rv = po[pid], ro[pid]
        assert len(pv) == len(rv) >= min_count
        assert [f for f, _ in pv] == [f for f, _ in rv]
        mismatches = sum(a != b for (_, a), (_, b) in zip(pv, rv))
        print(f"pipeline {pid}: prediction mismatches {mismatches}/{len(pv)}")
        assert mismatches <= 0.01 * len(pv)
    for pid in rs:
        assert abs(ps[pid] - rs[pid]) <= 1.0 / 16 + 1e-9


@pytest.mark.parametrize("mode", ["exact", "relaxed"])
@pytest.mark.parametrize("route", ["packed", "records"])
def test_armed_port_matches_armed_jax(route, mode):
    """The same stream through the armed port and the armed JAX job. The
    deadline is out of reach, so flushes fall at fills, fences and
    terminate alone, the same points in both packages; in relaxed mode
    answers may lag the model by up to staleChunks fits, the same lag in
    both."""
    spec = EXACT if mode == "exact" else RELAXED
    port = _digest(*_run(spec, route))
    ref = _digest(*_run(spec, route, jax=True))
    _assert_close_to_jax(port, ref, min_count=40)


def test_armed_sparse_port_matches_armed_jax():
    port = _digest(*_run(EXACT, "records", sparse=True))
    ref = _digest(*_run(EXACT, "records", sparse=True, jax=True))
    _assert_close_to_jax(port, ref, min_count=30)


def test_relaxed_mode_serves_every_forecast_in_order():
    """Relaxed answers may lag the model, but every forecast is answered,
    each net's in stream order, and the score stays within 0.05."""
    off_job, off_report = _run(None, "packed", n_pipe=2)
    on_job, on_report = _run(RELAXED, "packed", n_pipe=2)
    (oo, os_), (no, ns) = _digest(off_job, off_report), _digest(on_job, on_report)
    for pid in oo:
        assert sorted(f for f, _ in no[pid]) == sorted(f for f, _ in oo[pid])
        assert abs(ns[pid] - os_[pid]) <= 0.05


# --- flush triggers ---------------------------------------------------------------


def _one_net(serve, parallelism=2):
    job = _job(serve, parallelism=parallelism)
    return job, job.spokes[0], job.spokes[0].nets[0]


def _forecasts(job, n, seed=0):
    """``n`` forecast rows, all dealt to worker 0 (one block a row)."""
    x = np.random.RandomState(seed).randn(n, DIM).astype(np.float32)
    p = len(job.spokes)
    for i in range(n):
        pad = np.zeros((p, DIM), np.float32)
        pad[0] = x[i]
        op = np.zeros(p, np.uint8)
        op[0] = 1
        job._rr = 0
        job.process_packed_batch(pad[:1], np.zeros(1, np.float32), op[:1])


def test_fill_trigger():
    job, spoke, net = _one_net({"maxBatch": 4, "maxDelayMs": 1e9})
    _forecasts(job, 3)
    assert len(job.predictions) == 0 and net.serve_queue.n_rows == 3
    _forecasts(job, 1, seed=1)
    assert len(job.predictions) == 4 and net.serve_queue.n_rows == 0


def test_deadline_fires_on_an_injected_clock():
    job, spoke, net = _one_net({"maxBatch": 1000, "maxDelayMs": 50})
    clock = ManualClock(100.0)
    spoke.serving_plane._clock = clock
    _forecasts(job, 2)
    assert len(job.predictions) == 0
    clock.advance(0.049)
    job.check_silence(now=0.0)
    assert len(job.predictions) == 0      # under the deadline
    clock.advance(0.002)
    job.check_silence(now=0.0)
    assert len(job.predictions) == 2      # deadline elapsed
    assert net.serve_stats.count == 2
    assert net.serve_stats.percentiles()[0] == pytest.approx(51.0)


def test_fit_fence_flushes_before_the_model_changes():
    job, spoke, net = _one_net(QUIET)
    _forecasts(job, 2)
    assert len(job.predictions) == 0
    before = net.pipeline.get_flat_params()[0]
    served = []
    job._on_prediction = lambda p: served.append(net.pipeline.get_flat_params()[0])
    # enough training rows for worker 0 to fill its batch (16, of which
    # test mode keeps 8 in 10) and fit: the fence serves the queue first
    rng = np.random.RandomState(1)
    xt = rng.randn(64, DIM).astype(np.float32)
    job.process_packed_batch(xt, np.ones(64, np.float32), np.zeros(64, np.uint8))
    assert len(served) == 2
    assert all(np.array_equal(f, before) for f in served)
    assert not np.array_equal(net.pipeline.get_flat_params()[0], before)


def test_hub_delivery_fences_the_queue():
    job, spoke, net = _one_net(QUIET)
    _forecasts(job, 1)
    assert len(job.predictions) == 0
    flat, _ = net.pipeline.get_flat_params()
    spoke.receive_from_hub(0, 0, "noop", flat)
    assert len(job.predictions) == 1


def test_queue_flushes_before_a_query_response():
    job, spoke, net = _one_net(QUIET)
    order = []
    job._on_prediction = lambda p: order.append("prediction")
    job._on_response = lambda r: order.append("response")
    _forecasts(job, 3)
    assert order == []
    job.process_event("requests", json.dumps({"id": 0, "request": "Query", "requestId": 4}))
    assert order == ["prediction"] * 3 + ["response"]


def test_delete_flushes():
    job, spoke, net = _one_net(QUIET)
    _forecasts(job, 3)
    job.process_event("requests", json.dumps({"id": 0, "request": "Delete"}))
    assert len(job.predictions) == 3


def test_terminate_flushes():
    job, spoke, net = _one_net(QUIET)
    _forecasts(job, 3)
    report = job.terminate()
    assert len(job.predictions) == 3 and report.statistics[0].forecasts_served == 3
    assert spoke.serving_plane.queued() == 0


def test_bad_serving_table_goes_to_the_dead_letter_sink():
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    job.process_event("requests", _create(0, {"staleness": "sloppy"}))
    assert job.pipeline_manager.live_pipelines == []
    [entry] = job.dead_letter.entries
    assert entry["reason"] == "rejected_request" and "staleness" in entry["detail"]
    ref = JaxStreamJob(JaxJobConfig(parallelism=2))
    ref.process_event("requests", _create(0, {"staleness": "sloppy"}))
    assert [e["reason"] for e in ref.dead_letter.entries] == ["rejected_request"]


def test_bad_job_default_fails_fast():
    with pytest.raises(ValueError):
        StreamJob(JobConfig(serving="staleness=sloppy"), device="cpu")
