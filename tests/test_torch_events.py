"""The flight recorder (``runtime/events.py``): the port against the JAX
package.

The classes mirror the JAX suite's (tests/test_events.py). Unit cases feed
the same calls to the JAX journal, timeline merge, bundle writer and
watchdog and to the port's; job cases run the JAX job and the port's job
(``device="cpu"``) on the same numpy-seeded stream, faults and chaos spec
(the overload and lifecycle planes' own recording sites among them).
Tolerance: the journal without its wall times (ids, kinds, causes, count
clock, stamps and every field), the bundle's ``byKind`` and the order of
its timeline, ``eventsRecorded``, ``alertsRaised`` and every other integer
statistic are equal; predictions >= 99% equal; an armed port job is
bitwise its unarmed twin; parameters within rtol 2e-4, atol 2e-5. A last
case renders a bundle the port wrote with ``benchmarks/incident_report.py``
(standard library only) in a subprocess.

The JAX suite's ``test_distributed_supervisor_gather`` drives the
multi-process fleet's supervisor, which the port does not have yet
(ROADMAP queue 1, item 4): it is left out here and arrives with it.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from omldm_tpu.api.requests import TrainingConfiguration as JTrainingConfiguration
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import events as jev
from omldm_tpu.runtime.recovery import FaultInjector as JFaultInjector
from omldm_tpu.runtime.recovery import JobSupervisor as JJobSupervisor
from omldm_tpu.runtime.recovery import replayable as jreplayable
from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.api.responses import QueryResponse
from omldm_tpu_torch.api.stats import Statistics
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import events as tev
from omldm_tpu_torch.runtime.recovery import FaultInjector, JobSupervisor, replayable
from omldm_tpu_torch.runtime.responses import ResponseMerger

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
DIM = 6
SIDES = ("jax", "port")
WALL_CLOCK = {"serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
              "shedLatencyMs", "codecEncodeSeconds", "codecDecodeSeconds",
              "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms"}


def _create_line(nid=0, protocol="Asynchronous", tc_extra=None):
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


def _job(side, on_performance=None, **cfg):
    if side == "jax":
        return JaxStreamJob(JaxJobConfig(**cfg), on_performance=on_performance)
    return StreamJob(JobConfig(**cfg), on_performance=on_performance, device="cpu")


def _run_job(side, events="", n=200, protocol="Asynchronous", parallelism=1, creates=(0,),
             tc_extra=None, **cfg_kw):
    job = _job(side, parallelism=parallelism, batch_size=16, test_set_size=16,
               events=events, **cfg_kw)
    for nid in creates:
        job.process_event("requests", _create_line(nid, protocol, tc_extra))
    for s, line in _stream(n):
        job.process_event(s, line)
    return job, job.terminate()


def _strip_wall(events):
    return [{k: v for k, v in e.items() if k != "wall"} for e in events]


def _journal(job):
    return _strip_wall(job.events.journal.tail())


def _int_stats(stats) -> dict:
    return {k: v for k, v in stats.to_dict().items()
            if isinstance(v, int) and not isinstance(v, bool) and k not in WALL_CLOCK}


def _preds_equal_share(a, b) -> float:
    assert len(a) == len(b)
    if not a:
        return 1.0
    return sum(1 for p, q in zip(a, b) if p.value == q.value and p.mlp_id == q.mlp_id) / len(a)


def _flats_close(jjob, tjob):
    for js, ts in zip(jjob.spokes, tjob.spokes):
        for nid, jnet in js.nets.items():
            jf, _ = jnet.pipeline.get_flat_params()
            tf, _ = ts.nets[nid].pipeline.get_flat_params()
            np.testing.assert_allclose(np.asarray(tf), np.asarray(jf), rtol=RTOL, atol=ATOL)


# --- spec parsing ---


class TestSpecParsing:
    @pytest.mark.parametrize("spec", [
        "", None, False, True, "on", "cap=128,watchdogEvery=64,shedHigh=2,blackboxPath=bb",
        {"p99BudgetMs": 250, "clearAfter": 3}, {"collapseFrac": 0.5, "silenceMs": 100},
    ])
    def test_parses_as_in_jax(self, spec):
        j, t = jev.parse_events_spec(spec), tev.parse_events_spec(spec)
        assert (j is None) == (t is None)
        if j is not None:
            assert vars(t) == vars(j)
            assert t.any_rule_armed() == j.any_rule_armed()

    @pytest.mark.parametrize("bad", ["nope=1", "cap=0", "collapseFrac=1.5", "cap", 3.14,
                                     "tail=-1", "clearAfter=0", "shedHigh=-1"])
    def test_bad_specs_raise(self, bad):
        with pytest.raises(ValueError) as jerr:
            jev.parse_events_spec(bad)
        with pytest.raises(ValueError) as terr:
            tev.parse_events_spec(bad)
        assert str(terr.value) == str(jerr.value)

    def test_pipeline_override_wins(self):
        for tc_cls, mod in ((JTrainingConfiguration, jev), (TrainingConfiguration, tev)):
            assert mod.events_config(tc_cls.from_dict({"events": {"cap": 7}}), "cap=99").cap == 7
            assert mod.events_config(tc_cls.from_dict({"events": False}), "cap=99") is None
            assert mod.events_config(tc_cls.from_dict({}), "cap=99").cap == 99
            assert mod.events_config(tc_cls.from_dict({}), "") is None

    def test_validate_events_gate(self):
        for tc_cls, mod in ((JTrainingConfiguration, jev), (TrainingConfiguration, tev)):
            assert mod.validate_events(tc_cls.from_dict({"events": {"bogus": 1}})) is not None
            assert mod.validate_events(tc_cls.from_dict({"events": True})) is None

    def test_bad_table_drops_request_not_job(self):
        details = {}
        for side in SIDES:
            job = _job(side, parallelism=1)
            job.process_event("requests", _create_line(0, tc_extra={"events": {"bogus": 1}}))
            assert 0 not in job.pipeline_manager.node_map
            assert job.dead_letter.by_reason.get("rejected_request") == 1
            details[side] = job.dead_letter.entries[-1]["detail"]
        assert details["port"] == details["jax"]

    def test_bad_job_spec_fails_fast(self):
        with pytest.raises(ValueError):
            StreamJob(JobConfig(parallelism=1, events="bogus=1"), device="cpu")

    def test_cli_flag_separation(self):
        # the bare --events flag is the combined replay FILE, not the spec
        for cfg_cls in (JaxJobConfig, JobConfig):
            assert cfg_cls.from_args({"events": "replay.jsonl"}).events == ""
            assert cfg_cls.from_args({"events": "replay.jsonl",
                                      "flightRecorder": "cap=64"}).events == "cap=64"
            assert cfg_cls.from_args({"blackboxPath": "bb"}).blackbox_path == "bb"


# --- the journal ---


def _journal_ops(mod, path=""):
    j = mod.EventJournal(cap=4, pid=3, path=path, clock=lambda: 1.0,
                         position=lambda: 42, tail_len=2)
    out = [j.record(mod.GUARD_TRIP, "non_finite", pipeline=0, worker=1),
           j.record(mod.ALERT, "shed_rate", delta=5),
           j.record(mod.DELTA_REJECTED, "non_finite", stamp=(2, 9)),
           j.record(mod.DELTA_REJECTED, "non_finite", stamp=None),
           j.record(mod.DELTA_REJECTED, "non_finite", stamp=(2, None))]
    for i in range(6):
        j.record("k", f"c{i}", pipeline=i % 2)
    j.bump_epoch()
    out.append(j.record(mod.DELTA_REJECTED, "x", pipeline=0, worker=1, stamp=(0, 1), hub=0))
    dirty = j.dirty
    dumped = j.dump()
    inc = j.incident("guard_trip", pipeline=0)
    return {"records": out, "events": j.tail(), "tail0": j.tail_for(0),
            "tail0_1": j.tail_for(0, 1), "tail7": j.tail_for(7), "total": j.total,
            "alerts": j.alerts, "hw": j.high_water, "by_kind": j.by_kind, "dirty": dirty,
            "dumped": dumped is not None, "inc": inc is not None,
            "dumps": j.dumps_written, "still_dirty": j.dirty}


class TestJournal:
    def test_ops_equal_jax(self, tmp_path):
        t = _journal_ops(tev, str(tmp_path / "port"))
        j = _journal_ops(jev, str(tmp_path / "jax"))
        assert t == j
        assert t["total"] == 13 and t["alerts"] == 1 and t["hw"] == 13
        assert [e["id"] for e in t["events"]] == [10, 11, 12, 13]
        assert t["records"][2]["stamp"] == [2, 9] and "stamp" not in t["records"][3]
        assert t["records"][-1]["epoch"] == 1

    def test_dump_roundtrip(self, tmp_path):
        lines = {}
        for side, mod in (("jax", jev), ("port", tev)):
            d = tmp_path / side
            j = mod.EventJournal(cap=10, pid=7, path=str(d), clock=lambda: 1.0)
            j.record("k", "a")
            j.record("k", "b", pipeline=1)
            path = j.dump()
            assert path == str(d / "blackbox-proc7.jsonl") and not j.dirty
            lines[side] = open(path).read()
        assert lines["port"] == lines["jax"]

    def test_dump_never_raises(self):
        j = tev.EventJournal(path="/proc/definitely/not/writable")
        j.record("k", "a")
        assert j.dump() is None and j.write_errors == 1

    def test_incident_records_and_dumps(self, tmp_path):
        j = tev.EventJournal(path=str(tmp_path))
        j.record("k", "a")
        path = j.incident("guard_trip", pipeline=0)
        lines = [json.loads(line) for line in open(path).read().splitlines()]
        assert lines[-1]["kind"] == "incident_dump" and lines[-1]["cause"] == "guard_trip"


# --- bundle merge ordering ---


def _ev(i, kind, wall, pid=0, **kw):
    return {"id": i, "kind": kind, "cause": "c", "wall": wall, "pid": pid, "clock": 0, **kw}


MERGE_CASES = [
    # a chaos reorder: one sender stream reads in send order
    [[_ev(1, "delta_rejected", 10.0, worker=1, stamp=[0, 7]),
      _ev(2, "delta_rejected", 10.1, worker=1, stamp=[0, 5]),
      _ev(3, "worker_retired", 10.2, worker=1, stamp=[0, 7])]],
    # independent workers' and rings' seq counters are never cross-sorted
    [[_ev(1, "delta_rejected", 1.0, worker=0, stamp=[0, 400]),
      _ev(2, "delta_rejected", 2.0, worker=5, stamp=[0, 3])],
     [_ev(1, "delta_rejected", 50.0, worker=0, stamp=[0, 2])]],
    # same stamp: the causal rank
    [[_ev(1, "worker_readmitted", 1.0, stamp=[0, 4]), _ev(2, "delta_rejected", 2.0,
                                                          stamp=[0, 4]),
      _ev(3, "resync", 3.0, stamp=[0, 4])]],
    # unstamped events interleave by wall time
    [[_ev(1, "restart", 5.0, pid="sup")],
     [_ev(1, "guard_trip", 1.0), _ev(2, "terminate", 9.0)]],
    # a garbled stamp degrades to unstamped
    [[_ev(1, "delta_rejected", 1.0, stamp="garbled"), _ev(2, "terminate", 2.0)]],
]


class TestMergeTimeline:
    @pytest.mark.parametrize("streams", MERGE_CASES)
    def test_merge_equals_jax(self, streams):
        assert tev.merge_timeline(streams) == jev.merge_timeline(streams)

    def test_stamps_beat_reordered_receives(self):
        merged = tev.merge_timeline(MERGE_CASES[0])
        assert [e["stamp"][1] for e in merged] == [5, 7, 7]
        merged = tev.merge_timeline(MERGE_CASES[2])
        assert [e["kind"] for e in merged] == ["delta_rejected", "resync", "worker_readmitted"]

    def test_rescale_epoch_separates_streams(self):
        j = tev.EventJournal()
        j.record(tev.DELTA_REJECTED, "x", pipeline=0, worker=1, stamp=(0, 40), hub=0)
        j.bump_epoch()
        j.record(tev.DELTA_REJECTED, "x", pipeline=0, worker=1, stamp=(0, 1), hub=0)
        assert [ev["stamp"][1] for ev in tev.merge_timeline([j.tail()])] == [40, 1]

    def test_bundle_write_read_and_gather(self, tmp_path):
        bundles = {}
        for side, mod in (("jax", jev), ("port", tev)):
            d = tmp_path / side
            j0 = mod.EventJournal(pid=0, path=str(d), clock=lambda: 1.0)
            j0.record("guard_trip", "norm_exploded", pipeline=0)
            j0.dump()
            j1 = mod.EventJournal(pid=1, path=str(d), clock=lambda: 2.0)
            j1.record("rescale", "agreed")
            j1.dump()
            (d / "blackbox-procX.jsonl").write_text("{torn json\n")  # skipped
            streams = mod.gather_blackbox(str(d))
            assert len(streams) == 2
            path = mod.write_bundle(str(d / "incident-0.json"), streams,
                                    meta={"reason": "test"})
            bundles[side] = json.load(open(path))
        assert bundles["port"] == bundles["jax"]
        assert bundles["port"]["byKind"] == {"guard_trip": 1, "rescale": 1}
        assert tev.write_bundle(str(tmp_path / "b.json"), [MERGE_CASES[4][0]]) is not None


# --- watchdog rules ---


def _watchdog_script(mod, **knobs):
    """The JAX suite's watchdog cases as one script: every fired event,
    the journal and the alert count."""
    knobs.setdefault("watchdog_every", 10)
    fired = []
    journal = mod.EventJournal(clock=lambda: 0.0)
    wd = mod.Watchdog(mod.EventsConfig(**knobs), journal, on_alert=fired.append,
                      clock=lambda: 0.0)
    return wd, journal, fired


WATCHDOG_CASES = {
    "count_clock": ({"shed_high": 1}, lambda wd: [
        wd.note_records(4), wd.note_records(5), wd.note_records(1), wd.evaluate({"shed": 0}),
        wd.note_records(9)]),
    "shed_rate": ({"shed_high": 5, "clear_after": 2}, lambda wd: [
        wd.evaluate({"shed": s}, now=float(t)) for t, s in
        enumerate([0, 10, 20, 20, 20, 40])]),
    "p99_budget": ({"p99_budget_ms": 100}, lambda wd: [
        wd.evaluate({"serve_p99_ms": 50}, now=0.0), wd.evaluate({"serve_p99_ms": 150}, now=1.0)]),
    "collapse": ({"collapse_frac": 0.5, "collapse_windows": 2}, lambda wd: [
        wd.evaluate({"records": r}, now=t) for t, r in
        [(1.0, 100), (2.0, 200), (3.0, 300), (4.0, 310)]]),
    "curve": ({"curve_slope": 0.5}, lambda wd: [
        wd.evaluate({"loss": v}, now=float(t)) for t, v in enumerate([1.0, 1.2, 1.8])]),
    "silence": ({"silence_ms": 1000}, lambda wd: [
        wd.poll_silence(10.0, now=10.5), wd.poll_silence(10.0, now=11.5),
        wd.poll_silence(11.4, now=11.6), wd.poll_silence(11.5, now=11.7)]),
}


class TestWatchdog:
    @pytest.mark.parametrize("case", sorted(WATCHDOG_CASES))
    def test_rules_equal_jax(self, case):
        knobs, script = WATCHDOG_CASES[case]
        runs = {}
        for side, mod in (("jax", jev), ("port", tev)):
            wd, journal, fired = _watchdog_script(mod, **knobs)
            runs[side] = (script(wd), journal.tail(), fired, journal.alerts, wd.evaluations)
        assert runs["port"] == runs["jax"]
        if case != "count_clock":
            assert runs["port"][3] >= 1  # every case fires its rule once at least

    def test_shed_rate_fire_and_clear(self):
        wd, journal, fired = _watchdog_script(tev, shed_high=5, clear_after=2)
        WATCHDOG_CASES["shed_rate"][1](wd)
        assert len(fired) == 2 and journal.alerts == 2
        assert journal.by_kind.get(tev.ALERT_CLEAR) == 1

    def test_broken_on_alert_never_raises(self):
        def boom(_e):
            raise RuntimeError("sink died")

        j = tev.EventJournal(clock=lambda: 0.0)
        wd = tev.Watchdog(tev.EventsConfig(p99_budget_ms=1), j, on_alert=boom)
        wd.evaluate({"serve_p99_ms": 5}, now=0.0)
        assert j.alerts == 1

    def test_recorder_arms_watchdog_only_with_rules(self):
        for spec, armed in (("on", False), ("shedHigh=1", True),
                            ("shedHigh=1,watchdogEvery=0", False)):
            assert (tev.FlightRecorder(tev.parse_events_spec(spec)).watchdog is not None) == armed


# --- unarmed identity ---


COMPOSE = [
    ({}, None),
    ({"cohort": "on", "cohort_min": 2, "serving": "maxBatch=8,maxDelayMs=1000000"}, None),
    ({"cohort": "on", "cohort_min": 2, "serving": "maxBatch=8,maxDelayMs=1000000",
      "overload": "window=64", "lifecycle": "on", "telemetry": "statsEvery=64"},
     {"comm": {"codec": "int8"}, "guard": True}),
]


class TestUnarmedIdentity:
    def test_unarmed_no_objects(self):
        job, _ = _run_job("port", events="", n=60)
        assert job.events is None and job.dead_letter.event_ring is None
        assert all(spoke.events is None for spoke in job.spokes)
        assert all(hub.node.events is None for hub in job.hub_manager.hubs.values())

    @pytest.mark.parametrize("compose,tc_extra", COMPOSE)
    def test_armed_bitwise_identical(self, compose, tc_extra):
        creates = (0, 1) if compose else (0,)
        kw = dict(n=240, protocol="Synchronous", parallelism=2, creates=creates,
                  tc_extra=tc_extra, **compose)
        base_job, base = _run_job("port", events="", **kw)
        ev_job, ev = _run_job("port", events="watchdogEvery=64,shedHigh=10000", **kw)
        assert [(p.mlp_id, p.value) for p in base_job.predictions] == [
            (p.mlp_id, p.value) for p in ev_job.predictions]
        for sb, se in zip(base.statistics, ev.statistics):
            assert (sb.score, sb.fitted, sb.models_shipped, sb.bytes_on_wire) == (
                se.score, se.fitted, se.models_shipped, se.bytes_on_wire)
            assert sb.events_recorded == 0 and se.events_recorded >= 1
        jax_job, jax_rep = _run_job("jax", events="watchdogEvery=64,shedHigh=10000", **kw)
        assert _journal(ev_job) == _journal(jax_job)
        assert [s.events_recorded for s in ev.statistics] == [
            s.events_recorded for s in jax_rep.statistics]

    def test_pipeline_false_opts_out_under_job_default(self):
        job = StreamJob(JobConfig(parallelism=1, batch_size=16, test_set_size=16, events="on"),
                        device="cpu")
        job.process_event("requests", _create_line(0, "Asynchronous", {"guard": True}))
        job.process_event("requests", _create_line(1, "Asynchronous",
                                                   {"guard": True, "events": False}))
        assert job.spokes[0].nets[0].events_cfg is not None
        assert job.spokes[0].nets[1].events_cfg is None
        for (nid, _h), hub in job.hub_manager.hubs.items():
            assert hub.node.events is (job.events.journal if nid == 0 else None)
        for s, line in _stream(40):
            job.process_event(s, line)
        for nid, rid in ((0, 3), (1, 4)):
            job.process_event("requests", json.dumps(
                {"id": nid, "request": "Query", "requestId": rid}))
        [r0] = [r for r in job.responses if r.response_id == 3]
        [r1] = [r for r in job.responses if r.response_id == 4]
        assert r0.events is not None and r1.events is None
        job.terminate()
        assert not any(e.get("pipeline") == 1 for e in job.events.journal.tail())

    def test_lazy_arming_by_pipeline_table(self):
        job = StreamJob(JobConfig(parallelism=1), device="cpu")
        assert job.events is None
        job.process_event("requests", _create_line(0, tc_extra={"events": {"cap": 64}}))
        assert job.events is not None and job.events.cfg.cap == 64
        assert job.spokes[0].events is job.events.journal
        assert all(hub.node.events is job.events.journal
                   for hub in job.hub_manager.hubs.values())


# --- the planes' own recording sites ---


LIFECYCLE = {"rampFrom": 0.0, "rampTo": 0.5, "rampEvery": 8, "rampStep": 0.25,
             "promoteAfter": 1000, "shadowEvery": 4, "minShadowEvals": 1,
             "scoreEnvelope": 0.05, "seed": 7}


class TestPlaneHooks:
    def test_lifecycle_transitions_recorded_as_in_jax(self):
        """A Shadow candidate canaried, then blown up: the canary rolls back;
        the LIFECYCLE events (and the whole journal) equal the JAX job's."""
        journals = {}
        for side in SIDES:
            job = _job(side, parallelism=1, batch_size=16, test_set_size=16, events="on")
            job.process_event("requests", _create_line(0, "Asynchronous",
                                                       {"lifecycle": LIFECYCLE}))
            job.process_event("requests", json.dumps({
                "id": 0, "request": "Shadow",
                "learner": {"name": "PA", "hyperParameters": {"C": 0.5},
                            "dataStructure": {"nFeatures": DIM}}}))
            job.process_event("requests", json.dumps({"id": 0, "request": "Promote"}))
            for i, (s, line) in enumerate(_stream(300)):
                if i == 150:
                    entry = job.spokes[0].nets[0].lifecycle.candidate_entry
                    flat, _ = entry.pipeline.get_flat_params()
                    entry.pipeline.set_flat_params(np.full_like(np.asarray(flat), 1.0e9))
                job.process_event(s, line)
            job.terminate()
            journals[side] = _journal(job)
        causes = [e["cause"] for e in journals["port"] if e["kind"] == tev.LIFECYCLE]
        assert causes[:2] == ["shadow_armed", "canary_started"]
        assert "canary_rolled_back" in causes
        assert journals["port"] == journals["jax"]

    def test_overload_ladder_recorded_as_in_jax(self):
        """A seeded burst at tenant 0: the pressure transitions (and the
        whole journal) equal the JAX job's."""
        journals = {}
        for side in SIDES:
            job = _job(side, parallelism=1, batch_size=16, test_set_size=16, events="on",
                       overload="window=8,share=2,hotHigh=6,hotCritical=12,cool=8",
                       chaos="seed=7,burst=8,burstFrom=20,burstLen=100,hotTenant=0")
            for nid in (0, 1):
                job.process_event("requests", _create_line(nid))
            for s, line in _stream(300):
                job.process_event(s, line)
            job.terminate()
            journals[side] = _journal(job)
        assert [e["cause"] for e in journals["port"] if e["kind"] == tev.PRESSURE]
        assert journals["port"] == journals["jax"]


# --- chaos-replay determinism ---


class TestDeterminism:
    def test_same_seed_same_event_stream(self):
        def run(side):
            return _run_job(side, events="on", n=400, protocol="Asynchronous", parallelism=2,
                            tc_extra={"guard": True, "syncEvery": 1},
                            chaos="seed=7,drop=0.2,dup=0.2,reorder=0.2,window=2,up.nan=0.3")[0]

        p1, p2, j1 = run("port"), run("port"), run("jax")
        assert _journal(p1) == _journal(p2)
        assert _journal(p1) == _journal(j1)
        _flats_close(j1, p1)
        assert p1.events.journal.total == j1.events.journal.total > 1


# --- the in-process decision chain ---


def _run_poisoned(side, tmp_path=None, events="on", parallelism=2, n=400, poison_at=200):
    cfg = dict(parallelism=parallelism, batch_size=16, test_set_size=16, events=events)
    if tmp_path is not None:
        cfg["blackbox_path"] = str(tmp_path)
    job = _job(side, **cfg)
    job.process_event("requests", _create_line(0, "Asynchronous", {
        "guard": {"maxStrikes": 1}, "comm": {"reliable": True}, "syncEvery": 1}))
    for i, (s, line) in enumerate(_stream(n)):
        if i == poison_at:
            net = job.spokes[1].nets[0]
            flat, _ = net.pipeline.get_flat_params()
            net.pipeline.set_flat_params(np.full_like(np.asarray(flat), 1.0e9))
        job.process_event(s, line)
    return job, job.terminate()


class TestDecisionChain:
    def test_rejection_retire_rollback_readmit_in_order(self, tmp_path):
        runs = {side: _run_poisoned(side, tmp_path / side) for side in SIDES}
        (tjob, trep), (jjob, jrep) = runs["port"], runs["jax"]
        assert _journal(tjob) == _journal(jjob)
        kinds = [e["kind"] for e in tjob.events.journal.tail()]
        for kind in (tev.DELTA_REJECTED, tev.WORKER_RETIRED, tev.GUARD_TRIP,
                     tev.GUARD_ROLLBACK, tev.WORKER_READMITTED):
            assert kind in kinds, f"missing {kind} in {kinds}"
        assert kinds.index(tev.DELTA_REJECTED) < kinds.index(tev.WORKER_RETIRED)
        assert kinds.index(tev.WORKER_RETIRED) < kinds.index(tev.WORKER_READMITTED)
        assert kinds.index(tev.GUARD_TRIP) < kinds.index(tev.GUARD_ROLLBACK)
        rej = next(e for e in tjob.events.journal.tail() if e["kind"] == tev.DELTA_REJECTED)
        assert rej["stamp"][0] == 0 and rej["strikes"] == 1 and rej["worker"] == 1
        [ts], [js] = trep.statistics, jrep.statistics
        assert _int_stats(ts) == _int_stats(js)
        assert ts.deltas_rejected >= 1 and ts.events_recorded == tjob.events.journal.total
        dumps = {side: [json.loads(line) for line in
                        open(tmp_path / side / "blackbox-proc0.jsonl").read().splitlines()]
                 for side in SIDES}
        assert _strip_wall(dumps["port"]) == _strip_wall(dumps["jax"])
        assert dumps["port"][-1]["kind"] == "terminate"
        assert _preds_equal_share(tjob.predictions, jjob.predictions) >= 0.99
        _flats_close(jjob, tjob)

    def test_guard_trip_without_blackbox_stays_in_memory(self):
        job, _ = _run_poisoned("port", tmp_path=None)
        assert job.events.journal.dumps_written == 0
        assert job.events.journal.by_kind.get("incident_dump", 0) >= 1

    def test_query_response_carries_event_tail(self):
        job, _ = _run_poisoned("port")
        frags = []
        merger = ResponseMerger(frags.append)
        merger.expect(9, 1)
        merger.add_fragment(QueryResponse(response_id=9, mlp_id=0,
                                          events=job.events.journal.tail_for(0)))
        [out] = frags
        assert out.events and all(e.get("pipeline") == 0 for e in out.events)
        assert "events" in out.to_dict()

    def test_live_query_rides_tail(self):
        tails = {}
        for side in SIDES:
            job = _job(side, parallelism=1, batch_size=16, test_set_size=16, events="on")
            job.process_event("requests", _create_line(0, "Asynchronous",
                                                       {"guard": {"maxStrikes": 1}}))
            for s, line in _stream(60):
                job.process_event(s, line)
            job.process_event("requests", json.dumps(
                {"id": 0, "request": "Query", "requestId": 5}))
            [resp] = [r for r in job.responses if r.response_id == 5]
            assert resp.events is not None  # armed: a list, maybe empty
            tails[side] = _strip_wall(resp.events)
        assert tails["port"] == tails["jax"]

    def test_dead_letter_cross_references_high_water(self):
        job = StreamJob(JobConfig(parallelism=1, events="on"), device="cpu")
        job.process_event("requests", _create_line(0))
        job.events.journal.record("k", "marker")
        hw = job.events.journal.high_water
        job.process_event("trainingData", "{torn")
        assert job.dead_letter.entries[-1]["eventId"] == hw
        job.terminate()

    def test_unarmed_dead_letter_shape_unchanged(self):
        job = StreamJob(JobConfig(parallelism=1), device="cpu")
        job.process_event("requests", _create_line(0))
        job.process_event("trainingData", "{torn")
        assert "eventId" not in job.dead_letter.entries[-1]
        job.terminate()

    def test_dead_letter_publisher_failures_counted(self):
        from omldm_tpu_torch.runtime.deadletter import DeadLetterSink

        published = []
        sink = DeadLetterSink(publish=published.append)
        sink.quarantine("trainingData", "{torn", "malformed_json")
        assert published == [sink.entries[-1]]

        def dead(_entry):
            raise OSError("topic gone")

        sink = DeadLetterSink(publish=dead)
        sink.quarantine("trainingData", "{torn", "malformed_json")
        sink.quarantine("trainingData", "{torn", "malformed_json")
        assert sink.publish is None and sink.publish_errors == 1 and sink.total == 2


# --- alerts on the performance sink ---


class TestAlertRecords:
    def test_alert_rides_sink_as_kind_alert(self):
        runs = {}
        for side in SIDES:
            perf = []
            job = _job(side, on_performance=perf.append, parallelism=2, batch_size=16,
                       test_set_size=16, events="watchdogEvery=64,shedHigh=1")
            job.process_event("requests", _create_line(0, "Asynchronous", {
                "guard": {"maxStrikes": 1}, "comm": {"reliable": True}, "syncEvery": 1}))
            for i, (s, line) in enumerate(_stream(400)):
                if i == 100:
                    net = job.spokes[1].nets[0]
                    flat, _ = net.pipeline.get_flat_params()
                    net.pipeline.set_flat_params(np.full_like(np.asarray(flat), 1.0e9))
                job.process_event(s, line)
            runs[side] = (job, job.terminate(), perf)
        (tjob, trep, tperf), (jjob, jrep, jperf) = runs["port"], runs["jax"]
        alerts = [p for p in tperf if p.kind == "alert"]
        assert alerts, "no kind=alert record reached the sink"
        payload = alerts[0].to_dict()
        assert payload["kind"] == "alert" and payload["alert"]["cause"] == "shed_rate"
        assert payload["statistics"] == []
        assert [_strip_wall([p.extra["alert"]]) for p in alerts] == [
            _strip_wall([p.extra["alert"]]) for p in jperf if p.kind == "alert"]
        assert trep.kind is None
        [ts], [js] = trep.statistics, jrep.statistics
        assert ts.alerts_raised == js.alerts_raised >= 1
        assert _journal(tjob) == _journal(jjob)


# --- supervised bundles ---


def _supervised(side, tmp_path, events="on"):
    stream = _stream(300)
    job = _job(side, parallelism=2, batch_size=16, test_set_size=16, events=events,
               blackbox_path=str(tmp_path) if tmp_path is not None else "")
    job.process_event("requests", _create_line(0))
    fault, sup_cls, rep = ((JFaultInjector, JJobSupervisor, jreplayable) if side == "jax"
                           else (FaultInjector, JobSupervisor, replayable))
    injector = fault()
    injector.arm(job, worker_id=0, after_records=80)
    sup = sup_cls(job, rep(lambda: list(stream)), max_restarts=1)
    report = sup.run()
    return sup, injector, report


class TestSupervisedBundle:
    def test_worker_death_bundle(self, tmp_path):
        runs = {side: _supervised(side, tmp_path / side) for side in SIDES}
        sup, injector, report = runs["port"]
        jsup, _, jreport = runs["jax"]
        assert report is not None and injector.fired == 1 and len(sup.failures) == 1
        assert sup.journal.by_kind.get(tev.RESTART) == 1
        bundle = json.load(open(sup.bundle_path))
        jbundle = json.load(open(jsup.bundle_path))
        assert bundle["byKind"] == jbundle["byKind"]
        assert [(e["pid"], e["kind"], e["cause"]) for e in bundle["timeline"]] == [
            (e["pid"], e["kind"], e["cause"]) for e in jbundle["timeline"]]
        assert bundle["meta"] == jbundle["meta"]
        kinds = [e["kind"] for e in bundle["timeline"]]
        assert "incident_dump" in kinds and tev.RESTART in kinds and "terminate" in kinds
        assert "sup" in {str(e["pid"]) for e in bundle["timeline"]}
        assert (tmp_path / "port" / "blackbox-proc0.jsonl").exists()
        assert [_int_stats(s) for s in report.statistics] == [
            _int_stats(s) for s in jreport.statistics]

    def test_unarmed_supervisor_zero_objects(self):
        job = StreamJob(JobConfig(parallelism=1, batch_size=16, test_set_size=16), device="cpu")
        job.process_event("requests", _create_line(0))
        sup = JobSupervisor(job, replayable(lambda: _stream(40)))
        sup.run()
        assert sup.journal is None and sup.bundle_path is None


# --- checkpoint composition ---


class TestCheckpointComposition:
    def test_snapshot_excludes_journal_and_restores_rewired(self, tmp_path):
        job = StreamJob(JobConfig(parallelism=2, batch_size=16, test_set_size=16, events="on",
                                  checkpointing=True, checkpoint_dir=str(tmp_path),
                                  check_interval_ms=0), device="cpu")
        job.process_event("requests", _create_line(0, "Asynchronous", {"guard": True}))
        for s, line in _stream(80):
            job.process_event(s, line)
        job.events.journal.record("k", "marker", pipeline=0)
        path = job.checkpoint_manager.save(job)
        restored = job.checkpoint_manager.restore(path=path)
        assert restored.events is not None
        assert all(sp.events is restored.events.journal for sp in restored.spokes)
        assert all(h.node.events is restored.events.journal
                   for h in restored.hub_manager.hubs.values())
        # a fresh incarnation, a fresh ring
        assert restored.events.journal.total == 0


# --- statistics plumbing ---


class TestStatsPlumbing:
    def test_update_merge_to_dict(self):
        a = Statistics(pipeline=0)
        a.update_stats(events_recorded=10, alerts_raised=2)
        a.update_stats(events_recorded=12, alerts_raised=2)
        assert a.events_recorded == 12  # a job-level mirror: max, not sum
        b = Statistics(pipeline=0)
        b.update_stats(events_recorded=5, alerts_raised=7)
        m = a.merge(b)
        assert (m.events_recorded, m.alerts_raised) == (12, 7)
        d = m.to_dict()
        assert d["eventsRecorded"] == 12 and d["alertsRaised"] == 7

    def test_unarmed_report_zero(self):
        _, report = _run_job("port", events="", n=60)
        [stats] = report.statistics
        assert stats.events_recorded == 0 and stats.alerts_raised == 0


# --- the bundle renders ---


def test_incident_report_renders_a_port_bundle(tmp_path):
    """``benchmarks/incident_report.py`` (standard library only) renders the
    bundle a supervised port run wrote."""
    sup, _, _ = _supervised("port", tmp_path)
    out = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "incident_report.py"),
                          sup.bundle_path], capture_output=True, text=True, check=True,
                         timeout=120)
    assert "incident bundle" in out.stdout and "restart" in out.stdout
    assert "reason: supervised_run" in out.stdout
