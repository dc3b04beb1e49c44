"""chip_smoke.py's phase 47 (the Kafka route and the in-process storm),
checked on the CPU without a card: the phase is driven around the
telemetry phases, its fake broker leaves ``sys.modules`` and the
environment as it found them, its topic logs hold the stream as the
CLI's files do, the route's breakdown reads its windows whole, and the
residue guard catches a thread left alive."""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_phase_47_is_driven_around_the_telemetry_phases(cs):
    """main() runs phase 47d after phase 40 and before phase 41 (its
    profile window needs torch.profiler's device records), and the rest of
    phase 47 after phase 42 (the reference smokes' timed gates run first);
    --kafka-only runs phase 17 and phase 47 alone."""
    main = (ROOT / "chip_smoke.py").read_text().split("def main")[1]
    full = main.split('lap("pa_scan check and time")')[1]
    assert full.index("phase_lifecycle(") < full.index("phase_kafka_profile(") \
        < full.index("phase_telemetry(") < full.index("phase_flight_recorder(") \
        < full.index("phase_kafka(") < full.index("phase_storm(")
    only = main.split("if args.kafka_only:")[1].split("return 0")[0]
    for phase in ("phase_cli(", "phase_kafka_profile(", "phase_kafka(", "phase_storm("):
        assert phase in only


def test_fake_broker_is_restored(cs, tmp_path, monkeypatch):
    """The phase installs tests/fskafka.py as ``kafka`` and points
    FSKAFKA_DIR at its broker; afterwards ``sys.modules["kafka"]``,
    ``sys.path`` and the environment are what they were."""
    sentinel = object()
    monkeypatch.setitem(sys.modules, "kafka", sentinel)  # undone at teardown
    monkeypatch.setenv("FSKAFKA_DIR", "/elsewhere")
    monkeypatch.setenv("OMLDM_CHAOS_KAFKA", "seed=1")
    path = list(sys.path)
    with cs._fskafka(tmp_path / "broker") as fsk:
        assert sys.modules["kafka"] is fsk
        assert os.environ["FSKAFKA_DIR"] == str(tmp_path / "broker")
        assert "OMLDM_CHAOS_KAFKA" not in os.environ
        fsk.append("trainingData", "x")
    assert sys.modules["kafka"] is sentinel
    assert sys.path == path
    assert os.environ["FSKAFKA_DIR"] == "/elsewhere"
    assert os.environ["OMLDM_CHAOS_KAFKA"] == "seed=1"
    assert (tmp_path / "broker" / "trainingData--0.log").read_text() == "x\n"


def test_fake_broker_restores_absence(cs, tmp_path, monkeypatch):
    monkeypatch.delitem(sys.modules, "kafka", raising=False)
    monkeypatch.delenv("FSKAFKA_DIR", raising=False)
    with cs._fskafka(tmp_path / "broker"):
        assert "kafka" in sys.modules
    assert "kafka" not in sys.modules and "FSKAFKA_DIR" not in os.environ


@pytest.mark.parametrize("inline", [False, True], ids=["topics", "inline"])
def test_topic_lines_hold_the_stream(cs, inline):
    events = cs.make_events(60, 0, query_at=30)
    lines = cs._topic_lines(events, inline_forecasts=inline)
    [create, query] = [json.loads(r) for r in lines["requests"]]
    assert create["learner"]["dataStructure"] == {"nFeatures": cs.N_FEATURES}
    assert query["request"] == "Query"
    n_fore = sum(1 for s, _ in events if s == "forecastingData")
    n_train = sum(1 for s, _ in events if s == "trainingData")
    forecasts = cs._forecast_keys(lines["trainingData"] + lines["forecastingData"])
    assert len(forecasts) == n_fore > 0
    if inline:
        # the CLI file's order: each forecast at its position, marked
        assert not lines["forecastingData"]
        assert len(lines["trainingData"]) == n_train + n_fore
        data = [p for s, p in events if s != "requests"]
        assert [json.loads(x)["numericalFeatures"] for x in lines["trainingData"]] == \
            [json.loads(x)["numericalFeatures"] for x in data]
    else:
        assert len(lines["trainingData"]) == n_train


def test_publish_replaces_a_log_whole(cs, tmp_path):
    cs._publish(tmp_path, "requests", ["a", "b"])
    assert (tmp_path / "requests--0.log").read_text() == "a\nb\n"
    assert sorted(os.listdir(tmp_path)) == ["requests--0.log"]


def test_kafka_breakdown_reads_both_windows(cs, tmp_path, monkeypatch):
    """The breakdown's consumer and polling legs each read a whole window
    of the logs (the head from offset 0, the tail from the middle of
    trainingData), the CLI-built job takes both windows on the CPU, and
    its outputs go to scratch topics that are removed after."""
    import torch

    monkeypatch.setitem(cs.KAFKA_RUN, "breakdown_records", 40)
    monkeypatch.setattr(cs, "SLICE_CONFIG", dict(parallelism=2, batch_size=16))
    events = cs.make_events(200, 0, query_at=100)
    lines = cs._topic_lines(events)
    broker = tmp_path / "broker"
    with cs._fskafka(broker):
        for topic in cs.KAFKA_TOPICS:
            cs._publish(broker, topic, lines[topic])
        cs._publish(broker, "predictions", ['{"p": 1}'] * 5)
        row = cs._kafka_breakdown(torch, broker, lines, 1_000.0, 0.1, device="cpu")
    assert set(row["us_per_record"]) == {"head", "tail"}
    for leg in row["us_per_record"].values():
        assert all(v > 0 for v in leg.values())
        assert leg["sum"] == pytest.approx(leg["polling_events"] + leg["job"])
    assert row["route_us"] == pytest.approx(1_000.0)
    # the scratch topics are gone; the route's own logs are untouched
    assert sorted(p.name for p in broker.iterdir()) == sorted(
        f"{t}--0.log" for t in cs.KAFKA_TOPICS + ("predictions",))
    assert len((broker / "predictions--0.log").read_text().splitlines()) == 5


def test_no_residue_catches_a_live_thread(cs):
    import threading

    import torch

    stop = threading.Event()
    with pytest.raises(cs.SmokeFailure, match="still alive"):
        with cs._no_residue(torch, "t"):
            threading.Thread(target=stop.wait, name="left-behind", daemon=True).start()
    stop.set()
    with cs._no_residue(torch, "t"):
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join()
