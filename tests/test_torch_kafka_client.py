"""The port's REAL ``connect_kafka`` body against a loopback fake broker,
held against the JAX package's on the same broker contents.

tests/test_kafka_client.py's fake ``kafka`` module (kafka-python's client
surface bound to an in-memory broker) is installed into ``sys.modules``
with ``monkeypatch.setitem``, so the production wiring -- topic mapping,
tracker seeding, metadata retry, the recovery seek split (tracked offset /
request rewind / data live-end) -- runs for real in both packages. Each
case builds the same broker twice, connects the port and the JAX package
to one each, and compares: the consumer's assignment and positions, every
explicit seek, the tracker, the events a poll sequence yields, what the
sinks publish, and the warnings on stderr. The tolerance is zero: host
code on the same inputs."""

import sys

import pytest

import omldm_tpu.runtime.kafka_io as jax_kio
import omldm_tpu_torch.runtime.kafka_io as port_kio
from tests.test_kafka_client import FakeBroker, TopicPartition, _module_for

TRAIN_REC = b'{"numericalFeatures": [1.0, 2.0], "target": 1.0, "operation": "training"}'


def connect(kio, monkeypatch, broker, capsys, **kw):
    """connect_kafka through the fake module bound to ``broker``; returns
    (events, sinks, tracker, warnings printed while connecting)."""
    monkeypatch.setitem(sys.modules, "kafka", _module_for(broker))
    capsys.readouterr()
    tracker = kw.pop("tracker", None)
    events, sinks = kio.connect_kafka("fake:9092", tracker=tracker, **kw)
    return events, sinks, tracker, capsys.readouterr().err


def consumer_state(sinks):
    c = sinks.consumer
    return dict(sorted(c._positions.items())), dict(sorted(c.seeks.items()))


def poll(events, broker, script):
    """Run a poll script: ("next", n) polls n times, ("append", topic,
    value[, partition]) publishes to the broker."""
    out = []
    for step in script:
        if step[0] == "next":
            out.extend(next(events) for _ in range(step[1]))
        else:
            broker.append(*step[1:])
    return out


def fresh_two_old():
    b = FakeBroker()
    b.append("trainingData", b"old-1")
    b.append("trainingData", b"old-2")
    return b


def fresh_parted():
    b = FakeBroker(partitions_per_topic={"forecastingData": 2})
    for _ in range(5):
        b.append("forecastingData", b"ancient")
    return b


def six_records():
    b = FakeBroker()
    for i in range(6):
        b.append("trainingData", b"rec-%d" % i)
    return b


def stale_forecasts():
    b = FakeBroker(partitions_per_topic={"forecastingData": 1})
    for i in range(8):
        b.append("forecastingData", b"stale-%d" % i)
    return b


def one_request():
    b = FakeBroker()
    b.append("requests", b'{"id": 0, "request": "Create"}')
    return b


def snapshot_only_partition():
    b = FakeBroker()
    b.append("trainingData", b"a", partition=0)
    b.logs.setdefault(("trainingData", 3), []).extend([b"x", b"y"])
    return b


def lagging(failures):
    def build():
        b = FakeBroker(metadata_failures=failures)
        b.append("trainingData", b"r0")
        return b
    return build


# (case, broker builder, connect kwargs, poll script)
CASES = [
    ("subscribe_live_end", fresh_two_old, dict(tracker={}),
     [("append", "trainingData", TRAIN_REC), ("next", 2)]),
    ("tracker_seeded", fresh_parted, dict(tracker={}), [("next", 1)]),
    ("tracker_advances", FakeBroker, dict(tracker={}),
     [("append", "trainingData", TRAIN_REC), ("append", "trainingData", TRAIN_REC),
      ("next", 3)]),
    ("resume_at_offset", six_records, dict(position={("trainingData", 0): 4}), [("next", 3)]),
    ("untracked_data_live_end", stale_forecasts,
     dict(position={("trainingData", 0): 0}, tracker={}),
     [("next", 1), ("append", "forecastingData", b"fresh"), ("next", 2)]),
    ("request_rewind", one_request, dict(position={("trainingData", 0): 0}, tracker={}),
     [("next", 2)]),
    ("snapshot_only_partition", snapshot_only_partition,
     dict(position={("trainingData", 0): 1, ("trainingData", 3): 1}), [("next", 2)]),
    ("metadata_retry", lagging(2), dict(position={("trainingData", 0): 0}), [("next", 2)]),
    ("metadata_fallback_warns", lagging(99), dict(position={("trainingData", 0): 0}),
     [("next", 2)]),
]


@pytest.mark.parametrize("case,build,kw,script", CASES, ids=[c[0] for c in CASES])
def test_connect_kafka_matches_jax(monkeypatch, capsys, case, build, kw, script):
    results = []
    for kio in (port_kio, jax_kio):
        broker = build()
        call_kw = {k: (dict(v) if isinstance(v, dict) else v) for k, v in kw.items()}
        if case.startswith("metadata"):
            # CONNECT_RETRY's attempts without its sleeps
            call_kw["retry"] = kio.CONNECT_RETRY.__class__(attempts=5, base_delay=0.0)
        events, sinks, tracker, warnings = connect(kio, monkeypatch, broker, capsys, **call_kw)
        seen = poll(events, broker, script)
        results.append((seen, consumer_state(sinks), tracker, warnings))
    assert results[0] == results[1]
    seen, (positions, seeks), tracker, warnings = results[0]
    # the JAX tests' own pins, on the port
    if case == "subscribe_live_end":
        assert seen == [("trainingData", TRAIN_REC.decode()), None]
    elif case == "tracker_seeded":
        assert tracker[("forecastingData", 0)] == 5 and tracker[("forecastingData", 1)] == 0
        assert tracker[("trainingData", 0)] == 0 and tracker[("requests", 0)] == 0
    elif case == "tracker_advances":
        assert tracker[("trainingData", 0)] == 2
    elif case == "resume_at_offset":
        assert seen == [("trainingData", "rec-4"), ("trainingData", "rec-5"), None]
    elif case == "untracked_data_live_end":
        assert seeks[TopicPartition("forecastingData", 0)] == ("end", 8)
        assert seen == [None, ("forecastingData", "fresh"), None]
        assert "no snapshot offset" in warnings
    elif case == "request_rewind":
        assert seeks[TopicPartition("requests", 0)] == ("beginning", 0)
        assert seen[0] == ("requests", '{"id": 0, "request": "Create"}')
    elif case == "snapshot_only_partition":
        assert seen[0] == ("trainingData", "y")
    elif case == "metadata_retry":
        assert seen[0] == ("trainingData", "r0") and "no partition metadata" not in warnings
    elif case == "metadata_fallback_warns":
        assert seen[0] == ("trainingData", "r0") and "no partition metadata" in warnings


def test_producer_sinks_publish_matches_jax(monkeypatch, capsys):
    logs = []
    for kio in (port_kio, jax_kio):
        broker = FakeBroker()
        _, sinks, _, _ = connect(kio, monkeypatch, broker, capsys)
        sinks.on_performance({"fitted": 7})
        sinks.on_dead_letter({"reason": "malformed", "stream": "trainingData"})
        logs.append(dict(broker.logs))
    assert logs[0] == logs[1]
    assert logs[0][("performance", 0)] == [b'{"fitted": 7}']
    assert ("deadLetters", 0) in logs[0]


def test_crash_resume_round_trip_matches_jax(monkeypatch, capsys):
    """Consume some records, 'crash' (close the clients), reconnect with the
    tracker as the position: the stream continues exactly where it left
    off, in both packages."""
    out = []
    for kio in (port_kio, jax_kio):
        broker = FakeBroker()
        tracker = {}
        events, sinks, _, _ = connect(kio, monkeypatch, broker, capsys, tracker=tracker)
        for i in range(10):
            broker.append("trainingData", b"rec-%d" % i)
        first = [next(events)[1] for _ in range(4)]
        sinks.close()
        assert sinks.consumer.closed and sinks.producer.closed
        events2, _, _, _ = connect(kio, monkeypatch, broker, capsys,
                                   position=dict(tracker), tracker=tracker)
        rest = []
        while True:
            ev = next(events2)
            if ev is None:
                break
            rest.append(ev[1])
        out.append((first, rest, dict(tracker)))
    assert out[0] == out[1]
    first, rest, _ = out[0]
    assert first == ["rec-0", "rec-1", "rec-2", "rec-3"]
    assert rest == ["rec-%d" % i for i in range(4, 10)]


def test_chaos_armed_connect_matches_jax(monkeypatch, capsys):
    """OMLDM_CHAOS_KAFKA wraps the consumer in ChaosConsumer in both: the
    same delivered sequence and tracker over the same broker."""
    monkeypatch.setenv("OMLDM_CHAOS_KAFKA", "seed=3,drop=0.2,dup=0.2,reorder=0.2")
    out = []
    for kio in (port_kio, jax_kio):
        broker = FakeBroker()
        tracker = {}
        events, _, _, warnings = connect(kio, monkeypatch, broker, capsys, tracker=tracker)
        for i in range(40):
            broker.append("trainingData" if i % 3 else "forecastingData", b"r-%d" % i)
        out.append(([next(events) for _ in range(60)], dict(tracker), "chaos" in warnings))
    assert out[0] == out[1]
    assert out[0][2]
