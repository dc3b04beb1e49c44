"""The port's Kafka adapters (omldm_tpu_torch/runtime/kafka_io.py) with fake
clients (no broker), held against the JAX package's on the same record
lists.

The cases of tests/test_kafka_io.py: a full job over fake records (the
port's job on the CPU beside the JAX job: the same topics published, the
same ``fitted``), the gate's ImportError, the sinks degrading when the
broker dies, the breaker, a transient send that recovers, metadata retry,
and idle markers. Added: ``polling_events``' offset tracker and its
``pause_when`` valve, checked event for event against the JAX function.
Tolerances: every adapter here is host code on the same inputs, so events,
trackers, sends and drop counts are compared exactly; the two jobs'
``fitted`` are equal exactly (the same records reach the same holdout)."""

import dataclasses
import json
import sys

import numpy as np
import pytest

import omldm_tpu.runtime.kafka_io as jax_kio
import omldm_tpu_torch.runtime.kafka_io as port_kio
from omldm_tpu_torch.utils.backoff import BackoffPolicy
# the JAX suite's fakes: a ConsumerRecord shape, a recording producer and
# a poll-style consumer whose idle windows raise StopIteration
from tests.test_kafka_io import FakePollingConsumer, FakeProducer, FakeRecord


def job_records(seed=0, n=600):
    rng = np.random.RandomState(seed)
    w = rng.randn(4)
    records = [FakeRecord("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0}},
        "trainingConfiguration": {"protocol": "CentralizedTraining"},
    }).encode())]
    for _ in range(n):
        x = rng.randn(4)
        records.append(FakeRecord("trainingData", json.dumps(
            {"numericalFeatures": list(np.round(x, 4)), "target": float(x @ w > 0)}).encode()))
    records.append(FakeRecord("ignoredTopic", b"junk"))
    for i in range(5):
        x = rng.randn(4)
        records.append(FakeRecord("forecastingData", json.dumps(
            {"id": i, "numericalFeatures": list(np.round(x, 4))}).encode()))
    return records


def run_job(kio, config_mod, job_mod, records, **job_kw):
    producer = FakeProducer()
    sinks = kio.ProducerSinks(producer)
    job = job_mod.StreamJob(
        config_mod.JobConfig(parallelism=1, batch_size=32, test_set_size=32),
        on_prediction=sinks.on_prediction, on_response=sinks.on_response,
        on_performance=sinks.on_performance, **job_kw)
    job.run(kio.consumer_events(iter(records)))
    return producer


def test_full_job_over_fake_kafka_matches_jax():
    import omldm_tpu.config as jax_config
    import omldm_tpu.runtime.job as jax_job
    import omldm_tpu_torch.config as port_config
    import omldm_tpu_torch.runtime.job as port_job

    port = run_job(port_kio, port_config, port_job, job_records(), device="cpu")
    ref = run_job(jax_kio, jax_config, jax_job, job_records())
    topics = [t for t, _ in port.sent]
    assert topics == [t for t, _ in ref.sent]
    assert topics.count("predictions") == 5 and topics.count("performance") == 1
    perf = json.loads([v for t, v in port.sent if t == "performance"][0])
    ref_perf = json.loads([v for t, v in ref.sent if t == "performance"][0])
    assert perf["statistics"][0]["fitted"] == ref_perf["statistics"][0]["fitted"] > 300
    preds = [json.loads(v)["dataInstance"] for t, v in port.sent if t == "predictions"]
    assert preds == [json.loads(v)["dataInstance"] for t, v in ref.sent if t == "predictions"]


def test_connect_kafka_gated(monkeypatch):
    """No ``kafka`` module: ImportError naming kafka-python (no fallback)."""
    monkeypatch.setitem(sys.modules, "kafka", None)  # an import of it fails
    with pytest.raises(ImportError, match="kafka-python"):
        port_kio.connect_kafka("localhost:9092")


def test_topic_defaults_match_jax():
    assert port_kio.DEFAULT_TOPICS == jax_kio.DEFAULT_TOPICS
    assert port_kio.DEFAULT_OUT_TOPICS == jax_kio.DEFAULT_OUT_TOPICS
    assert "deadLetters" in port_kio.DEFAULT_OUT_TOPICS
    for name in ("CONNECT_RETRY", "SEND_RETRY"):
        assert (dataclasses.asdict(getattr(port_kio, name))
                == dataclasses.asdict(getattr(jax_kio, name)))


class DeadProducer:
    """Broker gone mid-run: every send raises, and so does close()."""

    def __init__(self):
        self.calls = 0

    def send(self, topic, value):
        self.calls += 1
        raise ConnectionError("broker gone")

    def close(self):
        raise RuntimeError("already dead")


def test_producer_sinks_degrade_when_broker_dies(capsys):
    """A producer that fails mid-run downgrades topic publication to
    warnings and drop counting; it never raises out of the pump loop."""
    sinks = port_kio.ProducerSinks(DeadProducer(),
                                   retry=BackoffPolicy(attempts=2, base_delay=0.0))
    for i in range(5):
        sinks.on_performance({"i": i})
    sinks.on_dead_letter({"reason": "x"})
    assert sinks.dropped == 6
    assert sinks._drops_by_topic == {"performance": 5, "deadLetters": 1}
    sinks.close()  # a dead client's close() must not mask shutdown either
    err = capsys.readouterr().err
    assert "dropping record" in err
    assert "6 output record(s) dropped" in err


class HealableProducer:
    def __init__(self):
        self.calls = 0
        self.dead = True
        self.sent = []

    def send(self, topic, value):
        self.calls += 1
        if self.dead:
            raise ConnectionError("broker gone")
        self.sent.append((topic, value))


def breaker_trace(kio):
    """Send counts through a trip, probes, a heal and a new failure."""
    producer = HealableProducer()
    sinks = kio.ProducerSinks(producer, retry=kio.SEND_RETRY.__class__(attempts=2,
                                                                       base_delay=0.0))
    trace = []
    for i in range(sinks._BREAKER_AFTER + 10):
        sinks.on_performance({"i": i})
        trace.append((producer.calls, sinks.dropped))
    producer.dead = False
    sinks.on_performance({"ok": 1})
    trace.append((producer.calls, sinks.dropped, sinks._consecutive_failures))
    producer.dead = True
    sinks.on_performance({"i": -1})
    trace.append((producer.calls, sinks.dropped))
    return trace, producer.sent, sinks._BREAKER_AFTER


def test_producer_sinks_breaker_matches_jax():
    """After _BREAKER_AFTER consecutive exhausted sends the sink stops
    retrying (one probe a record, no backoff); a healed broker closes the
    breaker through the probe, and the full retry budget is back."""
    port, ref = breaker_trace(port_kio), breaker_trace(jax_kio)
    assert port == ref
    trace, sent, trip = port
    assert trace[trip + 9][0] == trip * 2 + 10  # first `trip` paid 2 calls each
    assert len(sent) == 1 and trace[-2][2] == 0
    assert trace[-1][0] == trace[-2][0] + 2


def test_producer_sinks_retry_recovers_transient_send():
    class FlakyProducer:
        def __init__(self):
            self.calls = 0
            self.sent = []

        def send(self, topic, value):
            self.calls += 1
            if self.calls <= 2:
                raise ConnectionError("transient")
            self.sent.append((topic, value))

    producer = FlakyProducer()
    sinks = port_kio.ProducerSinks(producer, retry=BackoffPolicy(attempts=3, base_delay=0.0))
    sinks.on_performance({"ok": 1})
    assert sinks.dropped == 0
    assert producer.sent == [("performance", b'{"ok": 1}')]


class LaggingMetadata:
    def __init__(self, ready_after):
        self.calls = 0
        self.ready_after = ready_after

    def partitions_for_topic(self, topic):
        self.calls += 1
        return {0, 2, 1} if self.calls >= self.ready_after else None


@pytest.mark.parametrize("ready_after,attempts", [(3, 5), (99, 2), (1, 1), (5, 5)])
def test_partitions_with_retry_matches_jax(ready_after, attempts):
    """partitions_for_topic returning None transiently retries under the
    shared policy; still empty after the budget, None comes back."""
    out = []
    for kio in (port_kio, jax_kio):
        meta = LaggingMetadata(ready_after)
        policy = kio.SEND_RETRY.__class__(attempts=attempts, base_delay=0.0)
        out.append((kio._partitions_with_retry(meta, "t", policy), meta.calls))
    assert out[0] == out[1]
    assert out[0] == (({0, 1, 2}, ready_after) if ready_after <= attempts else (None, attempts))


def windows_fixture():
    return [
        [FakeRecord("trainingData", b"{}")],
        [],  # a pure idle window
        [FakeRecord("requests", b"{}"), FakeRecord("unknownTopic", b"x")],
    ]


def test_polling_events_yields_idle_markers():
    """The polling adapter never ends: quiet windows come out as None so the
    driver can run the silence-timer termination check."""
    events = port_kio.polling_events(FakePollingConsumer(windows_fixture()))
    seen = [next(events) for _ in range(6)]
    assert seen == [("trainingData", "{}"), None, None, ("requests", "{}"), None, None]
    ref = jax_kio.polling_events(FakePollingConsumer(windows_fixture()))
    assert seen == [next(ref) for _ in range(6)]


def tracked_records(seed=0, n=60):
    rng = np.random.RandomState(seed)
    out, offsets = [], {}
    for i in range(n):
        topic = ("trainingData", "forecastingData", "requests", "junk")[int(rng.randint(4))]
        part = int(rng.randint(3))
        if rng.rand() < 0.2:
            off = None  # no offset attribute value: the counter fallback
        else:
            off = offsets.get((topic, part), int(rng.randint(5))) + int(rng.randint(1, 3))
            offsets[(topic, part)] = off
        out.append(FakeRecord(topic, json.dumps({"i": i}).encode(), part, off))
    return out


def drain(kio, windows, steps, **kw):
    tracker = kw.pop("tracker", {})
    events = kio.polling_events(FakePollingConsumer(windows), tracker=tracker, **kw)
    return [next(events) for _ in range(steps)], tracker


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polling_events_tracker_matches_jax(seed):
    recs = tracked_records(seed)
    windows = [recs[:20], [], recs[20:45], recs[45:]]
    seeded = {("trainingData", 0): 3, ("requests", 2): 0}
    port = drain(port_kio, windows, 70, tracker=dict(seeded))
    ref = drain(jax_kio, windows, 70, tracker=dict(seeded))
    assert port == ref
    events, tracker = port
    assert sum(1 for e in events if e is not None) == sum(1 for r in recs if r.topic != "junk")
    assert ("junk", 0) in tracker or ("junk", 1) in tracker or ("junk", 2) in tracker


def test_polling_events_pause_when_matches_jax(monkeypatch):
    """While ``pause_when`` holds no record is consumed (its offset is
    never tracked, so paused traffic replays): idle markers come out, and
    consumption resumes where it stopped."""
    import time

    monkeypatch.setattr(time, "sleep", lambda s: None)
    recs = [r for r in tracked_records(4, 40) if r.topic != "junk"]
    out = []
    for kio in (port_kio, jax_kio):
        polls = {"n": 0}

        def pause_when():
            polls["n"] += 1
            return 5 <= polls["n"] < 12 or 20 <= polls["n"] < 23

        consumer = FakePollingConsumer([recs])
        tracker = {}
        events = kio.polling_events(consumer, tracker=tracker, pause_when=pause_when,
                                    pause_sleep_s=0.0)
        seen, snapshots = [], []
        for _ in range(45):
            seen.append(next(events))
            snapshots.append(dict(tracker))
        out.append((seen, snapshots, polls["n"]))
    assert out[0] == out[1]
    seen, snapshots, _ = out[0]
    # one poll an event: polls 5-11 and 20-22 paused, consumed nothing (the
    # tracker stood still) and came out as idle markers
    assert seen[4:11] == [None] * 7 and seen[19:22] == [None] * 3
    assert snapshots[3] == snapshots[10] and snapshots[18] == snapshots[21]
    assert [e for e in seen if e is not None] == [
        (r.topic, r.value.decode()) for r in recs][:45 - 10]
