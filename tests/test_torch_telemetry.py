"""The telemetry plane (``runtime/telemetry.py``): the port against the JAX
package.

The classes mirror the JAX suite's (tests/test_telemetry.py). Unit cases
feed the same values to the JAX registry, phase profile, span log and
plane and to the port's; job cases run the JAX job and the port's job
(``device="cpu"``) on the same numpy-seeded stream. Tolerance: the
heartbeat schedule (each beat's seq and event position), the registry's
counters, every heartbeat's and the final report's integer statistics and
the span records' stamps are equal; percentiles, seconds and rtt are
wall-clock values, compared by key only; predictions >= 99% equal, and an
armed port job is bitwise its unarmed twin (the plane only adds
performance entries).

``TestHeartbeatFrames`` keeps the StreamJob frame's case; the JAX class's
other cases and ``TestAutoscaleHostSignal`` drive the multi-process fleet's
supervisor, which the port does not have yet (ROADMAP queue 1, item 4):
they are left out here and arrive with it.
"""

import json

import numpy as np
import pytest

from omldm_tpu.api.requests import TrainingConfiguration as JTrainingConfiguration
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import telemetry as jtel
from omldm_tpu.utils import tracing as jtracing
from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import telemetry as ttel
from omldm_tpu_torch.utils import tracing as ttracing

DIM = 6
SIDES = ("jax", "port")
# Statistics keys whose values are wall-clock (compared by key only)
WALL_CLOCK = {"serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
              "shedLatencyMs", "codecEncodeSeconds", "codecDecodeSeconds",
              "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms"}


def _create_line(nid=0, protocol="CentralizedTraining", tc_extra=None):
    tc = {"protocol": protocol, "syncEvery": 2}
    tc.update(tc_extra or {})
    return json.dumps({
        "id": nid, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                    "dataStructure": {"nFeatures": DIM}},
        "trainingConfiguration": tc,
    })


def _stream(n, fore_every=5, seed=0):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(1).randn(DIM)
    events = []
    for i in range(n):
        x = np.round(rng.randn(DIM), 6)
        feats = [float(v) for v in x]
        if i % fore_every == 4:
            events.append(("forecastingData", json.dumps({"numericalFeatures": feats})))
        else:
            events.append(("trainingData", json.dumps(
                {"numericalFeatures": feats, "target": float(x @ w > 0)})))
    return events


def _job(side, **cfg):
    if side == "jax":
        return JaxStreamJob(JaxJobConfig(**cfg))
    return StreamJob(JobConfig(**cfg), device="cpu")


def _run_job(side, telemetry="", n=200, protocol="CentralizedTraining", parallelism=1,
             creates=(0,), tc_extra=None, **cfg_kw):
    job = _job(side, parallelism=parallelism, batch_size=16, test_set_size=16,
               telemetry=telemetry, **cfg_kw)
    for nid in creates:
        job.process_event("requests", _create_line(nid, protocol, tc_extra))
    for stream, line in _stream(n):
        job.process_event(stream, line)
    return job, job.terminate()


def _both(**kw):
    return {side: _run_job(side, **kw) for side in SIDES}


def _int_stats(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if isinstance(v, int) and not isinstance(v, bool) and k not in WALL_CLOCK}


def _beats(job):
    return [p for p in job.performance if p.kind == "heartbeat"]


def _beat_view(beat) -> dict:
    """A heartbeat without its wall-clock values: the schedule, the
    registry's counters, the gauges' and histograms' names, the queues,
    the phase rows' names and each pipeline's integer statistics."""
    d = beat.to_dict()
    return {
        "seq": d["seq"], "eventsProcessed": d["eventsProcessed"],
        "counters": d["telemetry"]["counters"],
        "gauges": sorted(d["telemetry"]["gauges"]),
        "histograms": sorted(d["telemetry"]["histograms"]),
        "queues": d["queues"], "phases": sorted(d["phases"]),
        "statistics": [_int_stats(s) for s in d["statistics"]],
        "statKeys": [sorted(s) for s in d["statistics"]],
    }


def _preds_equal_share(a, b) -> float:
    assert len(a) == len(b)
    if not a:
        return 1.0
    return sum(1 for p, q in zip(a, b) if p.value == q.value and p.mlp_id == q.mlp_id) / len(a)


# --- spec parsing ---


class TestSpecParsing:
    @pytest.mark.parametrize("spec", [
        "", None, False, True, "on", "statsEvery=64,idleMs=500,traceSample=8,spanPath=s.jsonl",
        {"statsEvery": 32, "phases": "false"}, {"traceSample": 4, "spanCap": 8},
    ])
    def test_parses_as_in_jax(self, spec):
        j, t = jtel.parse_telemetry_spec(spec), ttel.parse_telemetry_spec(spec)
        assert (j is None) == (t is None)
        if j is not None:
            assert vars(t) == vars(j)

    def test_on_defaults(self):
        cfg = ttel.parse_telemetry_spec("on")
        assert cfg.stats_every == 10_000 and cfg.trace_sample == 0

    @pytest.mark.parametrize("bad", [
        "statEvery=64", "statsEvery=0,idleMs=0,traceSample=0", "statsEvery=-1",
        "idleMs=-1", "spanCap=0", "statsEvery", 3.5,
    ])
    def test_bad_specs_raise_as_in_jax(self, bad):
        with pytest.raises(ValueError) as jerr:
            jtel.parse_telemetry_spec(bad)
        with pytest.raises(ValueError) as terr:
            ttel.parse_telemetry_spec(bad)
        assert str(terr.value) == str(jerr.value)

    def test_pipeline_override_wins(self):
        for tc_cls, mod in ((JTrainingConfiguration, jtel), (TrainingConfiguration, ttel)):
            tc = tc_cls(protocol="Synchronous", extra={"telemetry": False})
            assert mod.telemetry_config(tc, "statsEvery=64") is None
            tc2 = tc_cls(protocol="Synchronous", extra={"telemetry": "statsEvery=32"})
            assert mod.telemetry_config(tc2, "").stats_every == 32

    def test_gate_drops_bad_table(self):
        entries = {}
        for side in SIDES:
            job = _job(side, parallelism=1)
            job.process_event("requests", _create_line(0, tc_extra={"telemetry": "bogusKnob=1"}))
            assert 0 not in job.pipeline_manager.node_map
            entries[side] = job.dead_letter.entries[-1]
        assert entries["port"]["reason"] == entries["jax"]["reason"] == "rejected_request"
        assert entries["port"]["detail"] == entries["jax"]["detail"]

    def test_bad_job_spec_fails_fast(self):
        with pytest.raises(ValueError):
            StreamJob(JobConfig(telemetry="nope=1"), device="cpu")


# --- the registry ---


def _registry_ops(mod):
    r = mod.MetricsRegistry()
    r.counter("a")
    r.counter("a", 4)
    r.gauge("v", 3)
    r.gauge("v", 1)
    r.gauge_max("peak", 3)
    r.gauge_max("peak", 1)
    for v in range(100):
        r.observe("lat", float(v))
    state = {"v": 1.0}
    r.probe("live", lambda: state["v"])
    r.probe("dead", lambda: 1 / 0)
    first = r.snapshot()
    state["v"] = 7.0
    other = mod.MetricsRegistry()
    other.counter("a", 3)
    other.gauge_max("peak", 5)
    other.observe("lat", 2.0)
    r.merge(other)
    return first, r.snapshot()


class TestMetricsRegistry:
    def test_snapshots_equal_jax(self):
        assert _registry_ops(ttel) == _registry_ops(jtel)

    def test_semantics(self):
        first, merged = _registry_ops(ttel)
        assert first["counters"]["a"] == 5
        assert first["gauges"]["v"] == 1 and first["gauges"]["peak"] == 3
        assert first["histograms"]["lat"]["count"] == 100
        assert first["histograms"]["lat"]["p50"] == pytest.approx(49.5)
        assert first["gauges"]["live"] == 1.0 and "dead" not in first["gauges"]
        assert merged["gauges"]["live"] == 7.0  # read at snapshot time
        assert merged["counters"]["a"] == 8 and merged["gauges"]["peak"] == 5
        assert merged["histograms"]["lat"]["count"] == 101


class TestPercentiles:
    @pytest.mark.parametrize("n", [1, 2, 3, 7, 256, 1000, 4096])
    def test_linear_percentiles_equal_numpy(self, n):
        rng = np.random.RandomState(n)
        # ties and a heavy tail, as latency rings hold
        vals = np.round(rng.lognormal(size=n), 2 if n % 2 else 6)
        qs = (0.0, 1.0, 25.0, 50.0, 75.0, 99.0, 99.9, 100.0)
        got = ttracing.linear_percentiles(np.sort(vals), qs)
        assert got == tuple(float(v) for v in np.percentile(vals, qs))
        assert all(type(v) is float for v in got)

    def test_step_timer_recent_p99_equals_jax(self):
        rng = np.random.RandomState(3)
        timers = (ttracing.StepTimer("t", cap=300), jtracing.StepTimer("t", cap=300))
        for d in rng.exponential(size=700):
            for t in timers:
                t.record(float(d))
            if rng.rand() < 0.05:
                assert timers[0].recent_p99() == timers[1].recent_p99()
        assert timers[0].recent_p99(window=17) == timers[1].recent_p99(window=17)
        assert timers[0].summary() == timers[1].summary()


class TestPhaseProfile:
    def test_table_shares_and_coverage(self):
        tables = []
        for mod in (jtel, ttel):
            p = mod.PhaseProfile()
            p.note("parse", 0.25)
            p.note("stage", 0.25)
            tables.append(p.table(1.0, extra={"fit": 0.4}))
        assert tables[1] == tables[0]
        assert tables[1]["_coverage"] == pytest.approx(0.9)

    def test_ctx_manager_accumulates(self):
        p = ttel.PhaseProfile()
        with p.phase("fit"):
            pass
        with p.phase("fit"):
            pass
        assert p.table()["fit"]["count"] == 2 and p.seconds("fit") >= 0.0


def _span_ops(mod, path=""):
    ticks = iter(range(100))
    log = mod.SpanLog(sample=2, path=path, clock=lambda: float(next(ticks)))
    log.maybe_open(0, 0, 0, "push", 0)   # sampled (send 0)
    log.maybe_open(0, 0, 0, "push", 1)   # not sampled (send 1)
    log.maybe_open(0, 0, 0, "push", 2)   # sampled but outstanding
    log.maybe_close(0, 0, 0, "release")
    log.maybe_close(0, 0, 0, "release")  # nothing outstanding: no-op
    log.maybe_open(3, 0, 1, "push", 17)
    log.maybe_close(3, 0, 1, "release")
    log.close()
    return log.opened, log.completed, log.spans


class TestSpanLog:
    def test_sampling_and_one_outstanding(self):
        assert _span_ops(ttel) == _span_ops(jtel)
        opened, completed, spans = _span_ops(ttel)
        assert (opened, completed) == (2, 2) and spans[0]["seq"] == 0

    def test_jsonl_file(self, tmp_path):
        paths = {side: str(tmp_path / f"{side}.jsonl") for side in SIDES}
        _span_ops(jtel, paths["jax"])
        _span_ops(ttel, paths["port"])
        lines = {side: open(p).read().splitlines() for side, p in paths.items()}
        assert lines["port"] == lines["jax"]
        span = json.loads(lines["port"][-1])
        assert span["networkId"] == 3 and span["seq"] == 17 and span["workerId"] == 1


# --- heartbeats ---


class TestHeartbeatCadence:
    def test_count_clocked_deterministic(self):
        runs = _both(telemetry="statsEvery=64", n=200)
        views = {side: [_beat_view(b) for b in _beats(job)] for side, (job, _) in runs.items()}
        # 201 events (1 create + 200 records) / 64 -> 3 beats
        assert len(views["port"]) == 3
        assert views["port"] == views["jax"]
        again, _ = _run_job("port", telemetry="statsEvery=64", n=200)
        assert [_beat_view(b) for b in _beats(again)] == views["port"]
        for job, report in runs.values():
            assert report is job.performance[-1] and report.kind is None
        assert _preds_equal_share(runs["port"][0].predictions, runs["jax"][0].predictions) >= 0.99

    def test_packed_route_ticks_rows(self):
        rng = np.random.RandomState(0)
        x = rng.randn(350, DIM).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.float32)
        op = np.zeros((350,), np.uint8)
        beats = {}
        for side in SIDES:
            job = _job(side, parallelism=1, batch_size=16, test_set_size=16,
                       telemetry="statsEvery=100")
            job.process_event("requests", _create_line(0))
            for i in range(0, 350, 50):
                job.process_packed_batch(x[i:i + 50], y[i:i + 50], op[i:i + 50])
            job.terminate()
            beats[side] = [_beat_view(b) for b in _beats(job)]
        # 1 create event + 350 rows = 351 ticks -> beats at 100/200/300
        assert len(beats["port"]) == 3
        assert beats["port"] == beats["jax"]

    def test_heartbeat_payload_schema(self):
        runs = _both(telemetry="statsEvery=64", n=200)
        docs = {side: next(b for b in _beats(job)).to_dict() for side, (job, _) in runs.items()}
        d = docs["port"]
        assert set(d) == set(docs["jax"])
        assert d["kind"] == "heartbeat" and d["seq"] == 1
        assert d["telemetry"]["counters"] == docs["jax"]["telemetry"]["counters"]
        assert d["telemetry"]["counters"]["records"] >= 64
        [row] = d["statistics"]
        assert row["fitted"] > 0 and row["programLaunches"] > 0
        assert row["score"] == 0.0  # heartbeats never score the holdout
        assert set(row) == set(docs["jax"]["statistics"][0])

    def test_heartbeat_statistics_are_detached_copies(self):
        runs = _both(telemetry="statsEvery=64", n=200, protocol="Synchronous", parallelism=2)
        job = runs["port"][0]
        [snap] = job.heartbeat_statistics()
        [jsnap] = runs["jax"][0].heartbeat_statistics()
        assert _int_stats(snap.to_dict()) == _int_stats(jsnap.to_dict())
        assert len(snap.lcx) == len(jsnap.lcx) > 0
        merged = job.hub_manager.network_statistics(0)
        curve, lcx = list(merged.learning_curve), list(merged.lcx)
        snap.learning_curve.append(-1.0)
        snap.lcx.clear()
        snap.update_stats(models_shipped=1_000)
        assert merged.learning_curve == curve and merged.lcx == lcx
        [again] = job.heartbeat_statistics()
        assert again.learning_curve == curve and again.lcx == lcx
        assert again.models_shipped == snap.models_shipped - 1_000

    def test_final_report_schema_unchanged(self):
        runs = _both(telemetry="statsEvery=64", n=200)
        for _, report in runs.values():
            assert set(report.to_dict()) == {"jobName", "parallelism", "durationMs",
                                             "statistics"}
        assert (_int_stats(runs["port"][1].statistics[0].to_dict())
                == _int_stats(runs["jax"][1].statistics[0].to_dict()))

    def test_idle_tick(self):
        seqs = {}
        for side, mod in (("jax", jtel), ("port", ttel)):
            wall = {"t": 1000.0}
            plane = mod.TelemetryPlane(mod.TelemetryConfig(stats_every=1000, idle_ms=500),
                                       wall=lambda w=wall: w["t"])
            out = [plane.idle_due()]          # nothing pending
            plane.note_records(3)
            out.append(plane.idle_due())      # the first pending check arms it
            wall["t"] += 0.4
            out.append(plane.idle_due())
            wall["t"] += 0.2
            out.append(plane.idle_due())      # 600 ms of pending silence
            out.append(plane.mark_beat())
            out.append(plane.idle_due())      # clock reset, nothing pending
            seqs[side] = out
        assert seqs["port"] == seqs["jax"] == [False, False, False, True, 1, False]

    def test_job_idle_tick_emits(self):
        """The idle tick with an injected ``now``: no beat at the first
        pending check, one once ``idleMs`` passed."""
        counts = {}
        for side in SIDES:
            job = _job(side, parallelism=1, batch_size=16, test_set_size=16,
                       telemetry="statsEvery=100000,idleMs=1", timeout_ms=10_000_000)
            job.process_event("requests", _create_line(0))
            for stream, line in _stream(20):
                job.process_event(stream, line)
            t0 = job.stats.last_activity
            out = [job.telemetry.heartbeats_emitted]
            job.check_silence(now=t0)
            out.append(job.telemetry.heartbeats_emitted)
            job.check_silence(now=t0 + 0.01)
            out.append(job.telemetry.heartbeats_emitted)
            counts[side] = out
        assert counts["port"] == counts["jax"] == [0, 0, 1]


# --- unarmed identity ---


COMPOSE = [
    ({}, None),
    ({"cohort": "on", "cohort_min": 2, "serving": "maxBatch=8,maxDelayMs=1000000"}, None),
    ({"cohort": "on", "cohort_min": 2, "serving": "maxBatch=8,maxDelayMs=1000000",
      "overload": "window=64", "lifecycle": "on"},
     {"comm": {"codec": "int8"}, "guard": True}),
]


class TestUnarmedIdentity:
    def test_unarmed_no_objects(self):
        job, _ = _run_job("port", telemetry="", n=50)
        assert job.telemetry is None
        for spoke in job.spokes:
            assert spoke.telemetry is None and spoke._phases is None

    @pytest.mark.parametrize("compose,tc_extra", COMPOSE)
    def test_armed_bitwise_identical(self, compose, tc_extra):
        creates = (0, 1) if compose else (0,)
        kw = dict(n=240, protocol="Synchronous", parallelism=2, creates=creates,
                  tc_extra=tc_extra, **compose)
        base_job, base = _run_job("port", telemetry="", **kw)
        tel_job, tel = _run_job("port", telemetry="statsEvery=64,traceSample=4", **kw)
        assert [(p.mlp_id, p.value) for p in base_job.predictions] == [
            (p.mlp_id, p.value) for p in tel_job.predictions]
        for sb, st in zip(base.statistics, tel.statistics):
            assert (sb.score, sb.fitted, sb.models_shipped, sb.bytes_on_wire) == (
                st.score, st.fitted, st.models_shipped, st.bytes_on_wire)
        # the armed run ADDED heartbeats, nothing else
        assert len(tel_job.performance) > len(base_job.performance)
        # ... on the JAX job's schedule
        jax_job, _ = _run_job("jax", telemetry="statsEvery=64,traceSample=4", **kw)
        assert [(b.seq, b.extra["eventsProcessed"]) for b in _beats(tel_job)] == [
            (b.seq, b.extra["eventsProcessed"]) for b in _beats(jax_job)]


# --- spans in the job ---


class TestSpansInJob:
    def test_protocol_rounds_traced(self, tmp_path):
        spans = {}
        for side in SIDES:
            path = str(tmp_path / f"{side}.jsonl")
            job, _ = _run_job(side, telemetry=f"statsEvery=100000,traceSample=1,spanPath={path}",
                              n=200, protocol="Synchronous", parallelism=2)
            log = job.telemetry.spans
            lines = [json.loads(line) for line in open(path).read().splitlines()]
            assert len(lines) == log.completed
            spans[side] = (log.opened, log.completed,
                           [{k: v for k, v in s.items() if k != "rttMs"} for s in lines])
            assert all(s["rttMs"] >= 0.0 and s["networkId"] == 0 and s["op"] for s in lines)
        assert spans["port"][1] > 0
        assert spans["port"] == spans["jax"]

    def test_pipeline_opt_out_excluded(self):
        job = StreamJob(JobConfig(parallelism=2, batch_size=16, test_set_size=16,
                                  telemetry="statsEvery=100000,traceSample=1"), device="cpu")
        job.process_event("requests", _create_line(0, "Synchronous",
                                                   tc_extra={"telemetry": False}))
        for stream, line in _stream(100):
            job.process_event(stream, line)
        job.terminate()
        assert job.telemetry.spans.opened == 0


# --- codec seconds and launch percentiles in Statistics ---


class TestStatisticsSurfacing:
    def test_codec_seconds_and_launch_gauges(self):
        runs = _both(telemetry="statsEvery=100000", n=240, protocol="Synchronous",
                     parallelism=2, tc_extra={"comm": {"codec": "int8"}})
        [stats] = runs["port"][1].statistics
        assert stats.codec_encode_seconds > 0.0 and stats.codec_decode_seconds > 0.0
        assert stats.launch_p99_ms >= stats.launch_p50_ms > 0.0
        d = stats.to_dict()
        assert d["launchP50Ms"] == stats.launch_p50_ms
        assert d["serveLaunchP99Ms"] >= d["serveLaunchP50Ms"]
        jd = runs["jax"][1].statistics[0].to_dict()
        assert set(d) == set(jd) and _int_stats(d) == _int_stats(jd)

    def test_serve_launch_gauge_engages_on_forecasts(self):
        _, report = _run_job("port", telemetry="statsEvery=100000", n=200)
        [stats] = report.statistics
        assert stats.forecasts_served > 0 and stats.serve_launch_p99_ms > 0.0

    def test_launch_gauges_stay_zero_unarmed(self):
        _, report = _run_job("port", telemetry="", n=200)
        [stats] = report.statistics
        assert stats.launch_p50_ms == 0.0 and stats.serve_launch_p99_ms == 0.0

    def test_query_terminate_never_double_counts(self):
        job = StreamJob(JobConfig(parallelism=2, batch_size=16, test_set_size=16),
                        device="cpu")
        job.process_event("requests", _create_line(
            0, "Synchronous", tc_extra={"comm": {"codec": "int8"}}))
        events = _stream(240)
        for stream, line in events[:120]:
            job.process_event(stream, line)
        job.process_event("requests", json.dumps({"id": 0, "request": "Query",
                                                  "requestId": 7}))
        for stream, line in events[120:]:
            job.process_event(stream, line)
        [stats] = job.terminate().statistics
        live_enc, live_dec = job.codec_seconds()
        assert 0.0 < stats.codec_encode_seconds <= live_enc + 1e-9
        assert 0.0 < stats.codec_decode_seconds <= live_dec + 1e-9


# --- phase attribution ---


class TestPhaseAttribution:
    def test_job_phase_table_covers_packed_run(self):
        import time

        rng = np.random.RandomState(0)
        x = rng.randn(4096, DIM).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.float32)
        op = np.zeros((4096,), np.uint8)
        tables = {}
        for side in SIDES:
            job = _job(side, parallelism=1, batch_size=64, test_set_size=32,
                       telemetry="statsEvery=100000")
            job.process_event("requests", _create_line(0))
            t0 = time.perf_counter()
            for i in range(0, 4096, 512):
                job.process_packed_batch(x[i:i + 512], y[i:i + 512], op[i:i + 512])
            tables[side] = job.phase_table(time.perf_counter() - t0)
            job.terminate()
        table = tables["port"]
        assert set(table) == set(tables["jax"])
        for name in ("stage", "holdout", "fit"):
            assert table[name]["seconds"] > 0.0
            assert table[name]["count"] == tables["jax"][name]["count"] or name == "fit"
        assert 0.0 < table["_coverage"] <= 1.05  # attributed, no nesting

    def test_overload_p99_signal_via_telemetry(self):
        job_t, _ = _run_job("port", telemetry="statsEvery=100000", n=60,
                            tc_extra={"overload": "window=16"})
        assert "p99_ms" in job_t.spokes[0].overload.signals()
        job_u, _ = _run_job("port", telemetry="", n=60, tc_extra={"overload": "window=16"})
        assert "p99_ms" not in job_u.spokes[0].overload.signals()


# --- heartbeat frames ---


class TestHeartbeatFrames:
    @pytest.mark.parametrize("events", ["", "on"])
    def test_streamjob_frame_keys(self, events):
        frames = {side: _run_job(side, n=60, events=events, tc_extra={"guard": True})[0]
                  .heartbeat_frame() for side in SIDES}
        frame = frames["port"]
        assert set(frame) == set(frames["jax"]) == {
            "level", "serveP99", "imbalance", "backlog", "events", "alerts"}
        assert frame["level"] == 0 and frame["serveP99"] >= 0.0
        assert (frame["events"], frame["alerts"]) == (frames["jax"]["events"],
                                                      frames["jax"]["alerts"])
        if not events:
            assert frame["events"] == 0 and frame["alerts"] == 0
        else:
            assert frame["events"] >= 1  # the terminate event at least
