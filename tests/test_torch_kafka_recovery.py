"""The Kafka route of the port's CLI (``python -m omldm_tpu_torch
--kafkaBrokers ...``): the live polling loop, supervised recovery with
source offsets in checkpoints, the bounded profile window, and the route
held against the JAX package's on the same topic logs.

The three CLI cases of tests/test_kafka_recovery.py run through the port's
``main`` with ``--device cpu`` (the checkpoint-offset seek with ``fitted ==
400``, the fresh restart from the live position, exhausted restarts
raising), beside tests/test_cli_kafka_loop.py's (silence termination, sink
precedence, a profile window that stops once). The route-parity case
preloads one set of file-backed topic logs (tests/fskafka.py, installed as
``kafka`` with ``monkeypatch.setitem`` and ``FSKAFKA_DIR`` under
``tmp_path``) and consumes them in assign mode from offset 0 through the
JAX job and the port's job on the CPU. Tolerances (the streams' rule,
PERF.md section 2): ``fitted`` and every integer statistic equal; >= 99%
of predictions equal, in count and order exactly; final parameters within
rtol=2e-4, atol=2e-5."""

import json
import os
import sys

import numpy as np
import pytest

import omldm_tpu_torch.runtime.kafka_io as kafka_io
from omldm_tpu_torch.__main__ import main
from omldm_tpu_torch.runtime.kafka_io import ProducerSinks, polling_events
from omldm_tpu_torch.runtime.spoke import Spoke
from tests.test_kafka_io import FakePollingConsumer, FakeProducer, FakeRecord
from tests.test_torch_cli import WALL_CLOCK_FIELDS

CPU = ["--device", "cpu"]


def _records(n=500, dim=4, seed=0, forecasts=0):
    """One partition per topic, offsets assigned in stream order."""
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    recs = [FakeRecord("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0}},
        "trainingConfiguration": {"protocol": "CentralizedTraining"},
    }).encode(), offset=0)]
    for i in range(n):
        x = rng.randn(dim)
        recs.append(FakeRecord("trainingData", json.dumps({
            "numericalFeatures": list(np.round(x, 4)), "target": float(x @ w > 0),
        }).encode(), offset=i))
    for i in range(forecasts):
        recs.append(FakeRecord("forecastingData", json.dumps({
            "numericalFeatures": list(np.round(rng.randn(dim), 4))}).encode(), offset=i))
    return recs


class SeekableFakeBroker:
    """connect_kafka stand-in whose consumers honour ``position``: a rebuilt
    consumer replays exactly the records at or after the sought offsets."""

    def __init__(self, records):
        self.records = records
        self.connects = []  # the position passed to each connect
        self.producer = FakeProducer()

    def connect(self, brokers, **kw):
        position = kw.get("position")
        self.connects.append(None if position is None else dict(position))
        recs = [r for r in self.records
                if position is None or r.offset >= position.get((r.topic, r.partition), 0)]
        return (polling_events(FakePollingConsumer([recs]), tracker=kw.get("tracker")),
                ProducerSinks(self.producer))


def _crash_once(monkeypatch, after_records):
    """A transient fault: the first spoke record past the threshold raises,
    once, across every job incarnation."""
    orig = Spoke.handle_data
    state = {"n": 0, "fired": False}

    def crashing(self, inst):
        state["n"] += 1
        if not state["fired"] and state["n"] > after_records:
            state["fired"] = True
            raise RuntimeError("injected kafka-path crash")
        return orig(self, inst)

    monkeypatch.setattr(Spoke, "handle_data", crashing)
    return state


def test_supervised_kafka_recovery_seeks_checkpoint_offsets(tmp_path, monkeypatch):
    broker = SeekableFakeBroker(_records())
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)
    state = _crash_once(monkeypatch, after_records=200)
    perf = tmp_path / "perf.jsonl"
    rc = main(CPU + [
        "--kafkaBrokers", "fake:9092", "--performanceOut", str(perf),
        "--parallelism", "2", "--timeout", "2500", "--checkpointing",
        "--checkpointDir", str(tmp_path / "ck"), "--checkInterval", "0",
        "--restartAttempts", "2",
    ])
    assert rc == 0 and state["fired"]
    # reconnected exactly once, sought to the checkpoint's offsets
    assert len(broker.connects) == 2 and broker.connects[0] is None
    assert broker.connects[1][("trainingData", 0)] > 0
    # the checkpoint matched the crash point (saved every event), so every
    # record was handled exactly once: 20% of 500 hold out, 400 train
    [s] = json.loads(perf.read_text())["statistics"]
    assert s["fitted"] == 400
    assert s["score"] > 0.8


def test_fresh_restart_resumes_from_live_position(tmp_path, monkeypatch):
    """No checkpointing: the next incarnation starts fresh but does NOT
    rewind the data stream (live-source semantics)."""
    broker = SeekableFakeBroker(_records())
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)
    state = _crash_once(monkeypatch, after_records=200)
    perf = tmp_path / "perf.jsonl"
    rc = main(CPU + ["--kafkaBrokers", "fake:9092", "--performanceOut", str(perf),
                     "--parallelism", "2", "--timeout", "2500", "--restartAttempts", "1"])
    assert rc == 0 and state["fired"]
    assert len(broker.connects) == 2
    # resumed at the live position (about the crash record), not offset 0;
    # the request partition's key dropped, so it rewinds
    assert broker.connects[1][("trainingData", 0)] >= 190
    assert ("requests", 0) not in broker.connects[1]
    [s] = json.loads(perf.read_text())["statistics"]
    assert 0 < s["fitted"] < 400  # only the post-crash tail trained


def test_restarts_exhausted_raises(tmp_path, monkeypatch):
    broker = SeekableFakeBroker(_records())
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)

    def always_crash(self, inst):
        raise RuntimeError("poison")

    monkeypatch.setattr(Spoke, "handle_data", always_crash)
    with pytest.raises(RuntimeError, match="poison"):
        main(CPU + ["--kafkaBrokers", "fake:9092", "--performanceOut",
                    str(tmp_path / "p.jsonl"), "--parallelism", "1", "--timeout", "2500",
                    "--restartAttempts", "2"])
    assert len(broker.connects) == 3  # the first connect + 2 restarts


def test_trains_and_terminates_on_silence(tmp_path, monkeypatch):
    broker = SeekableFakeBroker(_records(forecasts=5))
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)
    preds = tmp_path / "preds.jsonl"
    rc = main(CPU + ["--kafkaBrokers", "fake:9092", "--predictionsOut", str(preds),
                     "--parallelism", "2", "--timeout", "2500"])
    assert rc == 0
    # predictions went to the FILE (its flag wins); performance, with no
    # file flag, egressed through the producer
    assert len(preds.read_text().splitlines()) == 5
    sent = broker.producer.sent
    assert not [t for t, _ in sent if t == "predictions"]
    [perf] = [json.loads(v) for t, v in sent if t == "performance"]
    [s] = perf["statistics"]
    assert s["fitted"] > 300 and s["score"] > 0.8


def test_profile_window_stops_once(tmp_path, monkeypatch):
    """--profileSteps bounds the trace: it starts at the loop's entry and
    stops once, after that many events, while the job runs on to its
    silence timer; the Chrome trace is written."""
    import omldm_tpu_torch.__main__ as cli
    from omldm_tpu_torch.utils.tracing import trace_path

    broker = SeekableFakeBroker(_records(n=120))
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)
    calls = {"start": 0, "stop": 0, "events_at_stop": None}
    real_start, real_stop = cli.ProfileWindow.start, cli.ProfileWindow.stop

    def start(self):
        calls["start"] += 1
        return real_start(self)

    def stop(self, write=True):
        if self.active:
            calls["stop"] += 1
            calls["events_at_stop"] = n_events()
        return real_stop(self, write)

    seen = {"n": 0}
    real_process = cli.StreamJob.process_event

    def process_event(self, stream, payload):
        seen["n"] += 1
        return real_process(self, stream, payload)

    def n_events():
        return seen["n"]

    monkeypatch.setattr(cli.ProfileWindow, "start", start)
    monkeypatch.setattr(cli.ProfileWindow, "stop", stop)
    monkeypatch.setattr(cli.StreamJob, "process_event", process_event)
    perf = tmp_path / "p.jsonl"
    prof = tmp_path / "trace"
    rc = main(CPU + ["--kafkaBrokers", "fake:9092", "--performanceOut", str(perf),
                     "--profileDir", str(prof), "--profileSteps", "10",
                     "--parallelism", "1", "--timeout", "2500"])
    assert rc == 0
    assert calls["start"] == 1 and calls["stop"] == 1
    assert calls["events_at_stop"] == 10  # stopped at the window's bound
    assert seen["n"] == 121  # ... and the job consumed the rest afterwards
    assert json.loads(perf.read_text())["statistics"][0]["fitted"] > 0
    doc = json.loads(open(trace_path(str(prof))).read())
    assert doc["traceEvents"]


def test_profile_window_short_stream_stops_at_end(tmp_path, monkeypatch):
    """A stream shorter than the window: the trace stops once, at the end."""
    from omldm_tpu_torch.utils.tracing import trace_path

    broker = SeekableFakeBroker(_records(n=30))
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)
    prof = tmp_path / "trace"
    rc = main(CPU + ["--kafkaBrokers", "fake:9092", "--performanceOut",
                     str(tmp_path / "p.jsonl"), "--profileDir", str(prof),
                     "--parallelism", "1", "--timeout", "1500"])
    assert rc == 0
    assert json.loads(open(trace_path(str(prof))).read())["traceEvents"]


def test_failed_run_stops_the_window_and_writes_no_trace(tmp_path, monkeypatch):
    """A run that fails inside the window (restarts exhausted) stops the
    trace once and writes none, as the port's ``trace`` does for a failed
    block (the JAX route writes its XLA profile either way); the failure
    propagates."""
    import omldm_tpu_torch.__main__ as cli
    from omldm_tpu_torch.utils.tracing import trace_path

    broker = SeekableFakeBroker(_records(n=50))
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)

    def always_crash(self, inst):
        raise RuntimeError("poison")

    monkeypatch.setattr(Spoke, "handle_data", always_crash)
    stops = []
    real_stop = cli.ProfileWindow.stop

    def stop(self, write=True):
        if self.active:
            stops.append(write)
        return real_stop(self, write)

    monkeypatch.setattr(cli.ProfileWindow, "stop", stop)
    prof = tmp_path / "trace"
    with pytest.raises(RuntimeError, match="poison"):
        main(CPU + ["--kafkaBrokers", "fake:9092", "--profileDir", str(prof),
                    "--performanceOut", str(tmp_path / "p.jsonl"), "--parallelism", "1",
                    "--timeout", "1500"])
    assert stops == [False]
    assert not os.path.exists(trace_path(str(prof)))


def test_profile_fault_is_not_a_job_failure(tmp_path, monkeypatch):
    """A trace that fails to stop inside the window (a CUDA job that
    recorded no device activity, a failed export) is not taken for a job
    failure: no restart under --restartAttempts, the job runs to its
    silence timer, and the profiling error propagates once the run ends."""
    import omldm_tpu_torch.__main__ as cli

    broker = SeekableFakeBroker(_records(n=120))
    connects = []

    def connect(*a, **kw):
        connects.append(kw.get("position"))
        return broker.connect(*a, **kw)

    monkeypatch.setattr(kafka_io, "connect_kafka", connect)
    real_stop = cli.ProfileWindow.stop
    stops = []

    def stop(self, write=True):
        if self.active:
            stops.append(write)
            real_stop(self, False)
            if write:
                raise RuntimeError("trace export failed")

    seen = {"n": 0}
    real_process = cli.StreamJob.process_event

    def process_event(self, stream, payload):
        seen["n"] += 1
        return real_process(self, stream, payload)

    monkeypatch.setattr(cli.ProfileWindow, "stop", stop)
    monkeypatch.setattr(cli.StreamJob, "process_event", process_event)
    perf = tmp_path / "p.jsonl"
    with pytest.raises(RuntimeError, match="trace export failed"):
        main(CPU + ["--kafkaBrokers", "fake:9092", "--performanceOut", str(perf),
                    "--profileDir", str(tmp_path / "trace"), "--profileSteps", "10",
                    "--restartAttempts", "2", "--parallelism", "1", "--timeout", "1500"])
    assert stops == [True]
    assert connects == [None]  # one connect: no restart
    assert seen["n"] == 121
    assert json.loads(perf.read_text())["statistics"][0]["fitted"] > 0


def test_kafka_flags_no_longer_refused():
    import omldm_tpu_torch.__main__ as cli

    assert "kafkaBrokers" not in cli.UNPORTED_ROUTE_FLAGS
    assert "profileSteps" not in cli.UNPORTED_ROUTE_FLAGS
    assert set(cli.UNPORTED_ROUTE_FLAGS) == {
        "supervise", "compileCache", "compileCacheMinSecs"}


def test_no_sources_message_names_kafka(tmp_path):
    with pytest.raises(SystemExit, match="--kafkaBrokers"):
        main(CPU + ["--performanceOut", str(tmp_path / "p.jsonl")])


def test_kafka_route_wants_cuda_without_device(monkeypatch):
    """No --device: the job wants CUDA, and raises on a host without a card
    before any connect."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    broker = SeekableFakeBroker(_records(n=5))
    monkeypatch.setattr(kafka_io, "connect_kafka", broker.connect)
    with pytest.raises(Exception):
        main(["--kafkaBrokers", "fake:9092"])
    assert broker.connects == []


# --- route parity: one set of topic logs through both packages ---------------


PARITY_DIM, PARITY_TEST_SET = 6, 32


def _preload(fskafka, n=900, seed=3):
    """The Create (and a Query) on ``requests``, training records on two
    ``trainingData`` partitions, forecasts on ``forecastingData``."""
    rng = np.random.RandomState(seed)
    w = rng.randn(PARITY_DIM)
    fskafka.append("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.01, "variant": "PA-I"},
                    "dataStructure": {"nFeatures": PARITY_DIM}},
        "preProcessors": [{"name": "StandardScaler"}],
        "trainingConfiguration": {"protocol": "Asynchronous"},
    }))
    for i in range(n):
        x = np.round(rng.randn(PARITY_DIM) * 2.0 + 1.0, 6)
        if i % 10 == 9:
            fskafka.append("forecastingData", json.dumps({"numericalFeatures": x.tolist()}))
        else:
            y = float((x - 1.0) @ w + 0.3 * rng.randn() > 0)
            fskafka.append("trainingData", json.dumps(
                {"numericalFeatures": x.tolist(), "target": y}), partition=i % 2)
    fskafka.append("requests", json.dumps({"id": 0, "request": "Query", "requestId": 4}))


def _drain_job(kio, job):
    """Assign mode from offset 0 on every partition; consume until the logs
    run dry (two idle polls in a row), then terminate."""
    import os

    root = os.environ["FSKAFKA_DIR"]
    position = {}
    for name in os.listdir(root):
        topic, part = name[:-4].split("--")
        if topic in kio.DEFAULT_TOPICS:
            position[(topic, int(part))] = 0
    tracker = dict(position)
    events, sinks = kio.connect_kafka("fs://local", position=position, tracker=tracker)
    idle = 0
    for event in events:
        if event is None:
            idle += 1
            if idle >= 2:
                break
            continue
        idle = 0
        job.process_event(*event)
    job.terminate()
    sinks.close()
    return tracker


def test_route_parity_with_jax_over_fskafka(tmp_path, monkeypatch):
    import fskafka

    import omldm_tpu.config as jax_config
    import omldm_tpu.runtime.job as jax_job
    import omldm_tpu.runtime.kafka_io as jax_kio
    import omldm_tpu_torch.config as port_config
    import omldm_tpu_torch.runtime.job as port_job

    monkeypatch.setenv("FSKAFKA_DIR", str(tmp_path / "broker"))
    monkeypatch.setitem(sys.modules, "kafka", fskafka)
    _preload(fskafka)
    jobs, trackers = [], []
    for kio, cfg, jmod, kw in ((kafka_io, port_config, port_job, {"device": "cpu"}),
                               (jax_kio, jax_config, jax_job, {})):
        job = jmod.StreamJob(cfg.JobConfig(parallelism=2, batch_size=16,
                                           test_set_size=PARITY_TEST_SET), **kw)
        trackers.append(_drain_job(kio, job))
        jobs.append(job)
    port, ref = jobs
    assert trackers[0] == trackers[1]
    assert trackers[0][("trainingData", 0)] + trackers[0][("trainingData", 1)] == 810
    # predictions: count and order exactly, >= 99% of values
    pf = [p.data_instance.numerical_features for p in port.predictions]
    assert len(pf) == 90 and pf == [p.data_instance.numerical_features
                                    for p in ref.predictions]
    pv = np.array([p.value for p in port.predictions])
    rv = np.array([p.value for p in ref.predictions])
    assert (pv != rv).sum() <= 0.01 * len(pv)
    # the Query answered in both
    assert [r.response_id for r in port.responses] == [r.response_id for r in ref.responses]
    # statistics: integers equal, floats close, the score within one row
    [ts] = port.performance[-1].to_dict()["statistics"]
    [js] = ref.performance[-1].to_dict()["statistics"]
    assert ts["fitted"] == js["fitted"] > 0
    for key, jv in js.items():
        if key in WALL_CLOCK_FIELDS:
            continue
        tv = ts[key]
        if key == "score":
            assert abs(tv - jv) <= 1.0 / PARITY_TEST_SET + 1e-9
        elif isinstance(jv, bool) or isinstance(jv, int):
            assert tv == jv, key
        elif isinstance(jv, float):
            assert abs(tv - jv) <= 1e-4, (key, tv, jv)
    for ps, js_ in zip(port.spokes, ref.spokes):
        for net_id in js_.nets:
            a = ps.nets[net_id].pipeline.get_flat_params()[0]
            b = js_.nets[net_id].pipeline.get_flat_params()[0]
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5)
