"""The model-lifecycle plane (``runtime/lifecycle.py``): the port against
the JAX package.

Unit cases hold the port's spec parser, ``canary_hash`` (value for value)
and ``LifecycleState`` to the JAX ones; job cases run the JAX job and the
port's job (``device="cpu"``) on the same seeded numpy stream with the same
Shadow / Promote / Rollback requests. Tolerance: every decision (the
registry's ``describe()``, shadow scores aside, which must agree within
rtol 2e-4, atol 2e-5), every prediction's version tag and the
``Statistics`` integer counters are equal; predictions equal within rtol
2e-4, atol 2e-5; an armed idle registry is bitwise the unarmed job. The
cases are the JAX suite's (tests/test_lifecycle.py): the healthy, hold
and poisoned legs (a plain and a perRecord learner, whose fits go through
the ``pa_scan`` wrapper), armed-idle identity at parallelism 1 and 2,
the operator verbs and the gate's refusals, checkpoint round trips
mid-canary and after a promotion (the guard's ring included), and a grow
and a shrink mid-canary.
"""

import dataclasses
import json

import numpy as np
import pytest

from omldm_tpu.api.requests import Request as JRequest
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import lifecycle as jlc
from omldm_tpu_torch.api.data import Prediction
from omldm_tpu_torch.api.requests import Request
from omldm_tpu_torch.api.responses import QueryResponse
from omldm_tpu_torch.api.stats import Statistics
from omldm_tpu_torch.checkpoint import CheckpointManager
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import lifecycle as tlc

RTOL, ATOL = 2e-4, 2e-5
DIM = 8
SIDES = ("jax", "port")
# a ramp a ~320-record (160-forecast) stream completes: full ramp at clock
# 16, promotion after 16 serves at it and one shadow eval
LC = {"rampFrom": 0.0, "rampTo": 0.5, "rampEvery": 8, "rampStep": 0.25,
      "promoteAfter": 16, "shadowEvery": 4, "minShadowEvals": 1,
      "scoreEnvelope": 0.05, "seed": 7}
HOLD = {**LC, "promoteAfter": 100_000}
COUNTERS = ("shadowScored", "canaryPromotions", "canaryRollbacks", "activeVersion",
            "programLaunches", "forecastsServed", "fitted", "modelsShipped")


# --- specs, the gate, the hash ---

@pytest.mark.parametrize("spec", [
    None, False, "", True, "on", "rampTo=0.25,rampEvery=4,seed=3", LC,
    {"minShadowEvals": 0, "maxVersions": 2, "scoreEnvelope": 0.0},
])
def test_spec_parses_as_in_jax(spec):
    j, t = jlc.parse_lifecycle_spec(spec), tlc.parse_lifecycle_spec(spec)
    assert (j is None) == (t is None)
    if j is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _create_dict(lifecycle, **ds):
    return {"id": 0, "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                        "dataStructure": {"nFeatures": DIM, **ds}},
            "trainingConfiguration": {"lifecycle": lifecycle}}


@pytest.mark.parametrize("bad", [
    {"rampTo": 1.5}, {"rampFrom": 0.6, "rampTo": 0.5}, {"rampEvery": 0}, {"rampStep": 0},
    {"promoteAfter": 0}, {"shadowEvery": 0}, {"minShadowEvals": -1},
    {"scoreEnvelope": -0.1}, {"maxVersions": 1}, {"nope": 1}, "rampTo", 7,
])
def test_bad_specs_refused_as_in_jax(bad):
    j = jlc.validate_lifecycle(JRequest.from_dict(_create_dict(bad)))
    t = tlc.validate_lifecycle(Request.from_dict(_create_dict(bad)))
    assert j is not None and t == j


def test_sparse_and_spmd_refused_as_in_jax():
    sparse = _create_dict(LC, sparse=True, maxNnz=4)
    spmd = _create_dict(LC)
    spmd["trainingConfiguration"]["engine"] = "spmd"
    for d in (sparse, spmd):
        assert tlc.validate_lifecycle(Request.from_dict(d)) == jlc.validate_lifecycle(
            JRequest.from_dict(d))
        assert tlc.validate_lifecycle(Request.from_dict(d)) is not None
    with pytest.raises(ValueError):
        StreamJob(JobConfig(parallelism=1, lifecycle="rampTo=2"), device="cpu")


def test_canary_hash_value_for_value():
    for seed in (0, 1, 7, 99, 2 ** 31 - 1, 2 ** 40 + 3):
        for n in list(range(512)) + [2 ** 32, 2 ** 63 - 5]:
            assert tlc.canary_hash(seed, n) == jlc.canary_hash(seed, n)


class _FakePipe:
    """A registry row's stand-in: flat params and a version slot."""

    def __init__(self, val=1.0):
        self._flat = np.full((4,), val, np.float32)
        self.version = 0
        self.guard = None

    def get_flat_params(self):
        return self._flat.copy(), None


def _states(**kw):
    spec = {**LC, **kw}
    return (jlc.LifecycleState(jlc.parse_lifecycle_spec(spec)),
            tlc.LifecycleState(tlc.parse_lifecycle_spec(spec)))


@pytest.mark.parametrize("kw", [{}, {"rampFrom": 0.5, "rampTo": 0.5}, {"seed": 99}])
def test_route_clock_matches_jax(kw):
    """The count-clocked split, the ramp steps and the serve counters walk
    the same schedule as the JAX registry's; an untrained candidate takes
    nothing while the clock ticks."""
    states = _states(**kw)
    for lc in states:
        lc.arm_shadow(_FakePipe(), {})
        assert lc.start_canary() and not lc.start_canary()
    for i in range(300):
        if i == 40:
            for lc in states:
                lc.candidate_entry.fits = 1
        takes = [lc.route_candidate() for lc in states]
        assert takes[0] == takes[1]
        assert states[0].canary_pct == states[1].canary_pct
    assert states[1].describe() == states[0].describe()
    assert states[1].candidate_entry.canary_served > 0


def test_registry_trim_and_counters_drain_once():
    j, t = _states(maxVersions=3)
    for lc in (j, t):
        for _ in range(6):
            lc.arm_shadow(_FakePipe(), {})
            lc.demote_candidate(None, to_state=tlc.REGISTERED)
        lc.arm_shadow(_FakePipe(2.0), {})
        entry = lc.demote_candidate("operator")
        assert entry.pipeline is None and entry.flat[0] == 2.0
    assert sorted(t.versions) == sorted(j.versions) and 0 in t.versions
    assert t.describe() == j.describe()
    assert t.take_counters() == {"canary_rollbacks": 1}
    assert t.take_counters() == {}
    assert t.totals["canary_rollbacks"] == 1


# --- job harness ---

def new_job(side, **kw):
    if side == "jax":
        return JaxStreamJob(JaxJobConfig(**kw))
    return StreamJob(JobConfig(**kw), device="cpu")


def build(side, lifecycle, n_pipe=1, parallelism=1, per_record=False, serving=None,
          guard=False, protocol="Asynchronous", **kw):
    cfg = dict(parallelism=parallelism, batch_size=16, test_set_size=16, cohort="off")
    cfg.update(kw)
    job = new_job(side, **cfg)
    for pid in range(n_pipe):
        tc = {"protocol": protocol, "syncEvery": 4, "perRecord": per_record}
        if lifecycle is not None:
            tc["lifecycle"] = lifecycle
        if serving is not None:
            tc["serving"] = serving
        if guard:
            tc["guard"] = True
        job.process_event("requests", json.dumps({
            "id": pid, "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                        "dataStructure": {"nFeatures": DIM}},
            "trainingConfiguration": tc,
        }))
    return job


def verb(kind, pid=0, C=0.5, **extra):
    d = {"id": pid, "request": kind, **extra}
    if kind == "Shadow":
        d.setdefault("learner", {"name": "PA", "hyperParameters": {"C": C},
                                 "dataStructure": {"nFeatures": DIM}})
    return ("requests", json.dumps(d))


def stream(records, seed=3, start=0, cycle=2):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(5).randn(DIM)
    out = []
    for i in range(start + records):
        f = rng.randn(DIM).astype(np.float32)
        if i < start:
            continue
        if i % cycle == 0:
            out.append(("forecastingData", json.dumps({"numericalFeatures": f.tolist()})))
        else:
            out.append(("trainingData", json.dumps({"numericalFeatures": f.tolist(),
                                                    "target": float(f @ w > 0)})))
    return out


def poison(job, pid=0):
    """Blow the candidate's parameters up (its guard trips at the next tick)."""
    entry = job.spokes[0].nets[pid].lifecycle.candidate_entry
    flat, _ = entry.pipeline.get_flat_params()
    entry.pipeline.set_flat_params(np.full_like(flat, 1.0e9))


def play(job, events, terminate=True):
    for event in events:
        if event == "poison":
            poison(job)
        elif event[0] == "rescale":
            job.rescale(event[1])
        else:
            job.process_event(*event)
    return job.terminate() if terminate else None


def both(events, terminate=True, **kw):
    return {side: (lambda j: (j, play(j, events, terminate)))(build(side, **kw))
            for side in SIDES}


def _strip(desc):
    out = dict(desc)
    out["versions"] = [{k: v for k, v in e.items() if k not in ("shadowScore", "baselineScore")}
                       for e in desc["versions"]]
    return out


def assert_match(runs, net_ids=(0,)):
    (jj, jr), (tj, tr) = runs["jax"], runs["port"]
    assert [(p.mlp_id, p.version) for p in tj.predictions] == [
        (p.mlp_id, p.version) for p in jj.predictions]
    np.testing.assert_allclose([p.value for p in tj.predictions],
                               [p.value for p in jj.predictions], rtol=RTOL, atol=ATOL)
    for js, ts in zip(jj.spokes, tj.spokes):
        for nid in net_ids:
            jl, tl = js.nets[nid].lifecycle, ts.nets[nid].lifecycle
            if jl is None:
                assert tl is None
                continue
            jd, td = jl.describe(), tl.describe()
            assert _strip(td) == _strip(jd)
            for je, te in zip(jd["versions"], td["versions"]):
                for key in ("shadowScore", "baselineScore"):
                    if je[key] is None:
                        assert te[key] is None
                    else:
                        assert te[key] == pytest.approx(je[key], rel=RTOL, abs=ATOL)
    if jr is not None:
        for js, ts in zip(jr.statistics, tr.statistics):
            jd, td = js.to_dict(), ts.to_dict()
            assert {k: td[k] for k in COUNTERS} == {k: jd[k] for k in COUNTERS}
    return tj


# --- the legs against the JAX job ---

LEGS = {
    "healthy": (LC, [verb("Shadow"), verb("Promote")] + stream(400)),
    "hold": (HOLD, [verb("Shadow"), verb("Promote")] + stream(400)),
    "poison": (LC, [verb("Shadow"), verb("Promote")] + stream(120) + ["poison"]
               + stream(280, start=120)),
    "regress": (LC, [verb("Shadow", C=1e-6)] + stream(480)),
}


@pytest.mark.parametrize("per_record", [False, True])
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_matches_jax(leg, per_record):
    lc, events = LEGS[leg]
    tj = assert_match(both(events, lifecycle=lc, per_record=per_record))
    lc_state = tj.spokes[0].nets[0].lifecycle
    tags = [p.version for p in tj.predictions]
    if leg == "healthy":
        assert lc_state.active_version == 1 and tj.spokes[0].nets[0].pipeline.version == 1
        assert lc_state.totals["canary_promotions"] == 1 and 1 in tags
    elif leg == "hold":
        assert lc_state.canary_active and lc_state.totals["canary_promotions"] == 0
    elif leg == "poison":
        entry = lc_state.versions[1]
        assert entry.state == tlc.ROLLED_BACK
        assert entry.trip_reason in ("non_finite", "norm_exploded")
        assert lc_state.active_version == 0
        last = max(i for i, v in enumerate(tags) if v is not None)
        assert all(v is None for v in tags[last + 1:])
    else:
        assert lc_state.versions[1].trip_reason == tlc.REASON_SCORE_REGRESSED
    assert len(tags) == (240 if leg == "regress" else 200)


@pytest.mark.parametrize("leg", ["hold", "poison"])
def test_baseline_predictions_bitwise_the_unarmed_job(leg):
    """Every untagged prediction is bitwise the unarmed run's at the same
    stream position, and no forecast is lost."""
    lc, events = LEGS[leg]
    off = build("port", None, per_record=True)
    play(off, [e for e in events if e != "poison" and json.loads(e[1]).get("request") is None])
    on = build("port", lc, per_record=True)
    play(on, events)
    assert len(on.predictions) == len(off.predictions)
    assert any(p.version is not None for p in on.predictions)
    for a, b in zip(off.predictions, on.predictions):
        if b.version is None:
            assert a.value == b.value


@pytest.mark.parametrize("parallelism,protocol", [(1, "Asynchronous"), (2, "Synchronous")])
def test_armed_idle_bitwise_unarmed(parallelism, protocol):
    events = stream(320)
    runs = {}
    for lc in (None, LC):
        job = build("port", lc, parallelism=parallelism, protocol=protocol,
                    serving={"maxBatch": 8, "maxDelayMs": 1.0e9})
        runs[lc is not None] = (job, play(job, events))
    assert [(p.mlp_id, p.value, p.version) for p in runs[True][0].predictions] == [
        (p.mlp_id, p.value, p.version) for p in runs[False][0].predictions]
    for spoke in runs[True][0].spokes:
        assert spoke.nets[0].lifecycle.describe()["counters"] == {
            "shadow_scored": 0, "canary_promotions": 0, "canary_rollbacks": 0}
    jax_on = build("jax", LC, parallelism=parallelism, protocol=protocol,
                   serving={"maxBatch": 8, "maxDelayMs": 1.0e9})
    assert_match({"jax": (jax_on, play(jax_on, events)), "port": runs[True]})


def test_job_default_arms_every_pipeline():
    job = StreamJob(JobConfig(parallelism=1, lifecycle="rampTo=0.25"), device="cpu")
    for pid in range(3):
        job.process_event("requests", json.dumps({
            "id": pid, "request": "Create",
            "learner": {"name": "PA", "dataStructure": {"nFeatures": DIM}},
            "trainingConfiguration": {"protocol": "Asynchronous"}}))
    assert all(n.lifecycle.cfg.ramp_to == 0.25 for n in job.spokes[0].nets.values())


# --- operator verbs and the gate ---

def test_rollback_after_promotion_matches_jax():
    events = [verb("Shadow"), verb("Promote")] + stream(320) + [verb("Rollback")] + [
        ("forecastingData", json.dumps({"numericalFeatures": [0.1] * DIM}))]
    tj = assert_match(both(events, lifecycle=LC))
    lc = tj.spokes[0].nets[0].lifecycle
    assert lc.active_version == 0 and tj.spokes[0].nets[0].pipeline.version == 0
    assert {v.version: v.state for v in lc.versions.values()} == {
        0: tlc.ACTIVE, 1: tlc.ROLLED_BACK}


def test_operator_rollback_and_forced_promote_match_jax():
    events = [verb("Shadow")] + stream(64) + [verb("Rollback"), verb("Shadow", C=0.25),
                                              verb("Promote")] + stream(160, start=64) + [
        verb("Promote")] + stream(40, start=224)
    tj = assert_match(both(events, lifecycle=HOLD))
    lc = tj.spokes[0].nets[0].lifecycle
    assert lc.versions[1].trip_reason == "operator" and lc.active_version == 2


@pytest.mark.parametrize("request_dict,detail", [
    ({"id": 0, "request": "Shadow", "learner": {
        "name": "PA", "dataStructure": {"nFeatures": DIM, "sparse": True}}},
     "lifecycle candidates must be dense learners"),
    ({"id": 0, "request": "Shadow"}, "Shadow request without a candidate learner"),
    ({"id": 9, "request": "Promote"}, "pipeline 9 does not exist"),
    ({"id": 0, "request": "Shadow", "learner": {"name": "PA"},
      "preProcessors": [{"name": "PolynomialFeatures", "hyperParameters": {"degree": 2}}]},
     "lifecycle candidate changes the parameter shape"),
])
def test_refused_verbs_match_jax(request_dict, detail):
    out = []
    for side in SIDES:
        job = build(side, LC)
        job.process_event("requests", json.dumps(request_dict))
        assert job.spokes[0].nets[0].lifecycle.candidate is None
        out.append([(e["reason"], e.get("detail")) for e in job.dead_letter.entries])
    assert out[0] == out[1] and detail in out[1][0][1]


def test_verbs_on_unarmed_pipelines_quarantined():
    """A verb at an unarmed pipeline, or at a sparse one under a job-wide
    default (which does not arm sparse nets), is quarantined by name."""
    job = build("port", None)
    job.process_event(*verb("Shadow"))
    sparse = StreamJob(JobConfig(parallelism=1, lifecycle="on"), device="cpu")
    sparse.process_event("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "dataStructure": {"nFeatures": 64, "sparse": True,
                                                    "maxNnz": 8}},
        "trainingConfiguration": {"protocol": "Asynchronous"}}))
    sparse.process_event(*verb("Promote"))
    for j in (job, sparse):
        assert j.spokes[0].nets[0].lifecycle is None
        [entry] = j.dead_letter.entries
        assert entry["detail"] == "lifecycle plane not armed for pipeline 0"


# --- observability ---

def test_registry_view_on_the_wire_matches_jax():
    events = [verb("Shadow")] + stream(160) + [
        ("requests", json.dumps({"id": 0, "request": "Query", "requestId": 1}))]
    runs = both(events, terminate=False, lifecycle=LC)
    [jresp], [tresp] = runs["jax"][0].responses, runs["port"][0].responses
    assert _strip(tresp.lifecycle) == _strip(jresp.lifecycle)
    again = QueryResponse.from_dict(json.loads(tresp.to_json()))
    assert again.lifecycle["candidateVersion"] == 1
    plain = build("port", None)
    play(plain, stream(32) + [("requests", json.dumps({"id": 0, "request": "Query"}))], False)
    assert plain.responses[0].lifecycle is None and "lifecycle" not in plain.responses[0].to_dict()
    assert "version" not in Prediction(0, None, 1.0).to_dict()
    assert Prediction(0, None, 1.0, version=3).to_dict()["version"] == 3
    topo = runs["port"][0].tenant_topology()
    assert topo["lifecycle"][0]["candidateVersion"] == 1


def test_counters_fold_once_and_gauge_tracks_rollback():
    a, b = Statistics(0), Statistics(0)
    a.update_stats(shadow_scored=2, canary_promotions=1, active_version=1)
    b.update_stats(shadow_scored=1, canary_rollbacks=2, active_version=3)
    m = a.merge(b)
    assert (m.shadow_scored, m.canary_promotions, m.canary_rollbacks, m.active_version) == (
        3, 1, 2, 3)
    events = [verb("Shadow"), verb("Promote")] + stream(320) + [
        ("requests", json.dumps({"id": 0, "request": "Query", "requestId": 1})),
        verb("Rollback")]
    runs = both(events, lifecycle=LC)
    tj, tr = runs["port"]
    assert tr.statistics[0].active_version == 0
    assert tr.statistics[0].shadow_scored == tj.spokes[0].nets[0].lifecycle.totals["shadow_scored"]
    assert_match(runs)


# --- checkpoints ---

def _ckpt_job(tmp_path, side="port"):
    return new_job(side, parallelism=1, batch_size=16, test_set_size=16, cohort="off",
                   checkpointing=True, checkpoint_dir=str(tmp_path), check_interval_ms=10 ** 9)


def test_snapshot_roundtrip_mid_canary(tmp_path):
    """A snapshot taken mid-canary restores the registry, the clocks and
    the candidate (its guard included), and the restored job reaches the
    uninterrupted run's decision at the same forecast."""
    head = [("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                    "dataStructure": {"nFeatures": DIM}},
        "trainingConfiguration": {"protocol": "Asynchronous", "syncEvery": 4,
                                  "perRecord": True, "lifecycle": {**LC, "promoteAfter": 48}}})),
        verb("Shadow"), verb("Promote")]
    first, rest = stream(120), stream(400, start=120)
    job = _ckpt_job(tmp_path)
    for event in head + first:
        job.process_event(*event)
    lc = job.spokes[0].nets[0].lifecycle
    assert lc.canary_active
    view = lc.describe()
    flat = lc.candidate_entry.pipeline.get_flat_params()[0]
    path = job.checkpoint_manager.save(job)
    restored = CheckpointManager(str(tmp_path), device="cpu").restore(path=path)
    rlc = restored.spokes[0].nets[0].lifecycle
    assert rlc.describe() == view
    np.testing.assert_array_equal(rlc.candidate_entry.pipeline.get_flat_params()[0], flat)
    assert rlc.candidate_entry.pipeline.guard is not None
    n0 = len(job.predictions)
    play(job, rest)
    play(restored, rest)
    assert [(p.value, p.version) for p in restored.predictions] == [
        (p.value, p.version) for p in job.predictions[n0:]]
    assert restored.spokes[0].nets[0].lifecycle.describe() == (
        job.spokes[0].nets[0].lifecycle.describe())
    assert job.spokes[0].nets[0].lifecycle.active_version == 1


def test_restore_after_promotion_installs_promoted_pipeline(tmp_path):
    """Restored after a promotion, the net runs the promoted-spec pipeline
    with the promoted parameters, and version 0 stays reactivatable; the
    JAX package restores the same snapshot schema to the same registry."""
    events = [verb("Shadow"), verb("Promote")] + stream(600)
    flats, views = {}, {}
    for side in SIDES:
        job = build(side, LC, checkpointing=True, checkpoint_dir=str(tmp_path / side),
                    check_interval_ms=10 ** 9)
        play(job, events, terminate=False)
        net = job.spokes[0].nets[0]
        assert net.lifecycle.active_version == 1
        flats[side] = net.pipeline.get_flat_params()[0]
        views[side] = _strip(net.lifecycle.describe())
        path = job.checkpoint_manager.save(job)
    assert views["port"] == views["jax"]
    np.testing.assert_allclose(flats["port"], flats["jax"], rtol=RTOL, atol=ATOL)
    rnet = CheckpointManager(str(tmp_path / "port"), device="cpu").restore(
        path=path).spokes[0].nets[0]
    assert rnet.lifecycle.active_version == 1 and rnet.pipeline.version == 1
    assert rnet.pipeline.learner.hp["C"] == 0.5
    np.testing.assert_array_equal(rnet.pipeline.get_flat_params()[0], flats["port"])
    assert rnet.lifecycle.previous is not None


def test_guard_lkg_ring_survives_restart(tmp_path):
    job = build("port", None, guard=True, checkpointing=True,
                checkpoint_dir=str(tmp_path), check_interval_ms=10 ** 9)
    play(job, stream(160), terminate=False)
    ring = [np.array(r) for r in job.spokes[0].nets[0].pipeline.guard._ring]
    assert ring
    path = job.checkpoint_manager.save(job)
    rring = CheckpointManager(str(tmp_path), device="cpu").restore(
        path=path).spokes[0].nets[0].pipeline.guard._ring
    assert len(rring) == len(ring)
    for a, b in zip(ring, rring):
        np.testing.assert_array_equal(np.array(b), a)


# --- rescale mid-canary ---

@pytest.mark.parametrize("rescale_to,parallelism,records_pre,records_post,cycle", [
    (2, 1, 160, 160, 2), (1, 2, 160, 160, 2), (2, 1, 64, 420, 3),
])
def test_rescale_mid_canary_matches_jax(rescale_to, parallelism, records_pre, records_post,
                                        cycle):
    """A grow replicates the live registry onto the new spoke, a shrink
    retires the leaving replica's candidate silently; a healthy co-tenant
    serves what it serves without a canary."""
    events = ([verb("Shadow"), verb("Promote")] + stream(records_pre)
              + [("rescale", rescale_to)]
              + stream(records_post, start=records_pre, cycle=cycle))
    runs = both(events, lifecycle=LC, n_pipe=2, parallelism=parallelism)
    tj = assert_match(runs, net_ids=(0, 1))
    tr = runs["port"][1]
    by = {s.pipeline: s for s in tr.statistics}
    assert by[0].canary_rollbacks == 0 and by[0].rescales_performed == 1
    plain = build("port", None, n_pipe=2, parallelism=parallelism)
    pr = play(plain, [e for e in events if e[0] != "requests"])
    assert {s.pipeline: s.forecasts_served for s in pr.statistics}[1] == by[1].forecasts_served
    if cycle == 3:
        assert by[0].canary_promotions >= 1
        assert all(s.nets[0].lifecycle.describe()["versions"][-1]["fits"] > 1
                   for s in tj.spokes)


# --- the CLI's flags ---

@pytest.mark.parametrize("flag,spec", [
    ("--lifecycle", "rampTo=0.5,rampEvery=8,rampStep=0.25,promoteAfter=16,shadowEvery=4,"
                    "minShadowEvals=1,seed=7"),
    ("--overload", "window=8,share=2,hotHigh=6,hotCritical=12,cool=8"),
])
def test_cli_flag_arms_the_plane_as_in_jax(tmp_path, monkeypatch, flag, spec):
    """``--lifecycle`` and ``--overload`` arm the job-wide default spec
    through the CLI's packed file route; with a Shadow and a Promote in the
    requests file, the port's CLI writes the JAX CLI's predictions (version
    tags included) and statistics."""
    import omldm_tpu.__main__ as jax_cli
    import omldm_tpu_torch.__main__ as port_cli

    reqs = tmp_path / "requests.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in [
        {"id": 0, "request": "Create",
         "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                     "dataStructure": {"nFeatures": DIM}},
         "trainingConfiguration": {"protocol": "Asynchronous", "syncEvery": 4}},
        json.loads(verb("Shadow")[1]), json.loads(verb("Promote")[1])]) + "\n")
    train = tmp_path / "train.jsonl"
    lines = []
    for name, payload in stream(640):
        rec = json.loads(payload)
        if name == "forecastingData":
            rec["operation"] = "forecasting"
        lines.append(json.dumps(rec))
    train.write_text("\n".join(lines) + "\n")
    out = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / side
        d.mkdir()
        argv = ["--parallelism", "1", "--batchSize", "16", "--testSetSize", "16",
                "--trainingData", str(train), "--requests", str(reqs), flag, spec,
                "--predictionsOut", str(d / "pred.jsonl"), "--performanceOut",
                str(d / "perf.jsonl")]
        argv += ["--compileCache", "off"] if side == "jax" else ["--device", "cpu"]
        assert cli.main(argv) == 0
        preds = [json.loads(x) for x in (d / "pred.jsonl").read_text().splitlines()]
        [perf] = [json.loads(x) for x in (d / "perf.jsonl").read_text().splitlines()]
        out[side] = (preds, perf["statistics"][0])
    (jp, js), (tp, ts) = out["jax"], out["port"]
    assert [p.get("version") for p in tp] == [p.get("version") for p in jp]
    np.testing.assert_allclose([p["value"] for p in tp], [p["value"] for p in jp],
                               rtol=RTOL, atol=ATOL)
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    if flag == "--lifecycle":
        assert ts["canaryPromotions"] == 1 and any(p.get("version") for p in tp)
    else:
        # the Shadow names a pipeline the flag did not arm for the lifecycle
        assert ts["canaryPromotions"] == 0 and not any(p.get("version") for p in tp)
        assert ts["recordsQuarantined"] == js["recordsQuarantined"]


def test_heartbeat_carries_the_live_version():
    events = [verb("Shadow"), verb("Promote")] + stream(400)
    runs = both(events, terminate=False, lifecycle=LC)
    (jj, _), (tj, _) = runs["jax"], runs["port"]
    [js], [ts] = jj.heartbeat_statistics(), tj.heartbeat_statistics()
    assert ts.active_version == js.active_version == 1
    assert ts.to_dict()["fitted"] == js.to_dict()["fitted"]
