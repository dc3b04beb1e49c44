"""The overload-control plane (``runtime/overload.py``): the port against
the JAX package.

Unit cases feed the same admissions to the JAX ``OverloadController`` and
the port's and compare every level, flag and counter; job cases run the
JAX job and the port's job (``device="cpu"``) on the same seeded numpy
stream and compare what comes out. Tolerance: per-tenant shed, throttle
and served counts, the shed schedule (``shed_log``) and the dead letters
are equal; predictions equal within rtol 2e-4, atol 2e-5, in the same
order (against the JAX job with cohorts on, >= 99% of the sign
predictions equal, the rule of the earlier slices' cohort parity: the
JAX gang fit is not bitwise its solo fit); an armed job under uniform
traffic is bitwise the unarmed one.
The cases are the JAX suite's (tests/test_overload.py): specs and gate
refusals, uniform traffic never flags, hysteresis, the degraded serving
limits, a seeded hot-tenant burst on the record route and then on packed
blocks with cohorts on, armed-idle identity at parallelism 1 and 2, idle
ticks clearing a CRITICAL level, the queue depths, and a controller on a
grown and a shrunk job.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

from omldm_tpu.api.requests import TrainingConfiguration as JTrainingConfiguration
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import overload as jov
from omldm_tpu.runtime.serving import ServingConfig as JServingConfig
from omldm_tpu.runtime.supervisor import BurstInjector as JBurstInjector
from omldm_tpu.runtime.supervisor import parse_chaos_spec as jparse_chaos
from omldm_tpu_torch.api.data import FORECASTING, DataInstance
from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import overload as tov
from omldm_tpu_torch.runtime.prefetch import prefetch
from omldm_tpu_torch.runtime.serving import ServingConfig
from omldm_tpu_torch.runtime.supervisor import BurstInjector, parse_chaos_spec
from omldm_tpu_torch.runtime.vectorizer import MicroBatcher

RTOL, ATOL = 2e-4, 2e-5
DIM = 8
SIDES = ("jax", "port")
# a controller small enough that a few hundred records climb the whole
# ladder (ELEVATED throttling, CRITICAL shedding) and decay back
OVR = "window=8,share=2,hotHigh=6,hotCritical=12,cool=8"
# the JAX suite's maxBatch; its 200 ms deadline is wall-clock, and a JAX
# compile inside a run would fire it where the port's run does not, so the
# parity runs flush on fill and on the model fences only
SRV = {"maxBatch": 8, "maxDelayMs": 1.0e9}
# tenant 0 flooded with 8x forecasts through the middle of the stream
BURST = "seed=7,burst=8,burstFrom=20,burstLen=100,hotTenant=0"
WALL_CLOCK = {"serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
              "shedLatencyMs", "codecEncodeSeconds", "codecDecodeSeconds"}


# --- spec parsing and the gate ---

@pytest.mark.parametrize("spec", [
    None, False, "", True, "on", "window=16,share=3,relax=false",
    {"hotHigh": 2, "hotCritical": 4, "shed": "no", "deferCap": 100},
    {"queueHigh": 100, "queueCritical": 200, "p99HighMs": 5, "widen": 2},
])
def test_spec_parses_as_in_jax(spec):
    j, t = jov.parse_overload_spec(spec), tov.parse_overload_spec(spec)
    assert (j is None) == (t is None)
    if j is not None:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("bad", [
    {"window": 0}, {"share": 0}, {"widen": 0.5}, {"cool": 0},
    {"hotHigh": 10, "hotCritical": 5}, {"deferCap": 0}, {"notAKnob": 1}, "window", 7,
])
def test_bad_specs_refused_as_in_jax(bad):
    j = jov.validate_overload(JTrainingConfiguration(extra={"overload": bad}))
    t = tov.validate_overload(TrainingConfiguration(extra={"overload": bad}))
    assert j is not None and t == j
    with pytest.raises((ValueError, TypeError)):
        tov.parse_overload_spec(bad)


def test_job_default_and_pipeline_override():
    assert tov.overload_config(TrainingConfiguration(), "window=16").window == 16
    assert tov.overload_config(TrainingConfiguration(extra={"overload": False}),
                               "window=16") is None
    own = TrainingConfiguration(extra={"overload": {"window": 4}})
    assert tov.overload_config(own, "window=16").window == 4


def test_bad_request_dropped_and_bad_job_default_raises():
    create = json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                    "dataStructure": {"nFeatures": DIM}},
        "trainingConfiguration": {"overload": {"window": 0}},
    })
    details = []
    for side in SIDES:
        job = new_job(side, parallelism=1)
        job.process_event("requests", create)
        assert 0 not in job.pipeline_manager.node_map
        [entry] = job.dead_letter.entries
        details.append((entry["reason"], entry["detail"]))
    assert details[0] == details[1]
    with pytest.raises(ValueError):
        StreamJob(JobConfig(parallelism=1, overload="window=0"), device="cpu")


# --- the controller, unit by unit against the JAX one ---

def _stub(mod, serving_cls, n_tenants=4, **knobs):
    spec = dict(window=8, share=2.0, hot_high=6.0, hot_critical=12.0, cool=4)
    spec.update(knobs)
    cfg = mod.OverloadConfig(**spec)
    spoke = types.SimpleNamespace(serving_plane=None, serve_timer=None)
    ctl = mod.OverloadController(spoke, clock=lambda: 0.0)
    nets = []
    for nid in range(n_tenants):
        net = types.SimpleNamespace(request=types.SimpleNamespace(id=nid), overload=cfg,
                                    serving=serving_cls(max_batch=8, max_delay_ms=100.0))
        ctl.arm(net)
        nets.append(net)
    return ctl, nets


def _stubs(**knobs):
    return (_stub(jov, JServingConfig, **knobs), _stub(tov, ServingConfig, **knobs))


def _state(ctl):
    return (ctl.level, ctl.level_peak, sorted(ctl._over), round(ctl._hot, 9), ctl.clock)


def test_uniform_traffic_never_flags():
    (jc, jn), (tc, tn) = _stubs()
    for _ in range(200):
        for a, b in zip(jn, tn):
            jc.spend(a, 1)
            tc.spend(b, 1)
        assert tc.tick(force=True) == jc.tick(force=True)
    assert _state(tc) == _state(jc)
    assert tc.level == tov.OK and tc._hot == 0.0 and not tc._over


@pytest.mark.parametrize("knobs", [{}, {"tenant_rate": 1.5}, {"cool": 8}])
def test_flood_then_cool_down_matches_jax(knobs):
    """Tenant 0 floods, then traffic turns uniform: the level climbs to
    CRITICAL at once and steps down only after ``cool`` ticks below every
    threshold, at the same ticks in both packages; the budgets agree."""
    (jc, jn), (tc, tn) = _stubs(**knobs)
    seen = set()
    for step in range(160):
        flood = step < 40
        for i, (a, b) in enumerate(zip(jn, tn)):
            rows = 6 if (flood and i == 0) else 1
            assert tc.spend(b, rows) == jc.spend(a, rows)
        assert tc.tick() == jc.tick()
        assert _state(tc) == _state(jc)
        assert [tc.budget(i) for i in range(4)] == pytest.approx(
            [jc.budget(i) for i in range(4)])
        seen.add(tc.level)
    assert tov.CRITICAL in seen and tc.level == tov.OK and tc.level_peak == tov.CRITICAL


def test_degraded_serving_over_limit_tenant_only():
    (jc, jn), (tc, tn) = _stubs()
    for _ in range(8):
        for ctl, nets in ((jc, jn), (tc, tn)):
            ctl.spend(nets[0], 30)
            ctl.tick(force=True)
    assert tc.level == jc.level >= tov.ELEVATED
    for a, b in zip(jn, tn):
        assert dataclasses.asdict(tc.degraded_serving(b)) == dataclasses.asdict(
            jc.degraded_serving(a))
    hot = tc.degraded_serving(tn[0])
    assert (hot.max_batch, hot.max_delay_ms, hot.staleness) == (32, 400.0, "relaxed")
    assert tc.degraded_serving(tn[1]) is tn[1].serving


def test_external_probe_and_counters_fold_once():
    ctl, _ = _stub(tov, ServingConfig)
    ctl.extra_signals["prefetch"] = lambda: (0.99, 0.75, 0.95)
    ctl.tick(force=True)
    assert ctl.level == tov.CRITICAL
    ctl.note_shed(0, 3, latency_ms=7.5)
    ctl.note_shed(0, 2)
    ctl.note_throttled(1, 4)
    assert ctl.shed_log == [(ctl.clock, 0, 3), (ctl.clock, 0, 2)]
    assert ctl.take_shed(0) == 5 and ctl.take_shed(0) == 0
    assert ctl.take_throttled(1) == 4 and ctl.take_throttled(1) == 0
    assert ctl.shed_latency_p99(0) == 7.5 and ctl.total_shed == 5


def test_burst_injector_matches_jax():
    spec = "seed=3,burst=4,burstFrom=1,burstLen=2,hotTenant=9"
    jinj = JBurstInjector.from_spec(jparse_chaos(spec))
    tinj = BurstInjector.from_spec(parse_chaos_spec(spec))
    train = DataInstance(numerical_features=[1.0], target=0.0)
    fore = DataInstance(numerical_features=[1.0], operation=FORECASTING)
    from omldm_tpu.api.data import FORECASTING as JF, DataInstance as JDI

    jtrain, jfore = JDI(numerical_features=[1.0], target=0.0), JDI(numerical_features=[1.0],
                                                                   operation=JF)
    for t_inst, j_inst in [(train, jtrain)] + [(fore, jfore)] * 4:
        t_out, j_out = tinj.clones(t_inst), jinj.clones(j_inst)
        assert len(t_out) == len(j_out)
        assert all(c.metadata == {"tenant": 9, "burst": True} for c in t_out)
    assert tinj.injected == jinj.injected == 6
    assert tinj._rng.randint(1 << 30) == jinj._rng.randint(1 << 30)
    assert BurstInjector.from_spec(parse_chaos_spec("drop=0.1")) is None


# --- job harness ---

def new_job(side, **kw):
    if side == "jax":
        return JaxStreamJob(JaxJobConfig(**kw))
    return StreamJob(JobConfig(**kw), device="cpu")


def build(side, overload, n_pipe=4, serving=SRV, chaos="", cohort="off", parallelism=1,
          per_record=False, job_overload="", protocol="Asynchronous", **kw):
    cfg = dict(parallelism=parallelism, batch_size=16, test_set_size=16, cohort=cohort,
               cohort_min=2, chaos=chaos, overload=job_overload, **kw)
    job = new_job(side, **cfg)
    for pid in range(n_pipe):
        tc = {"protocol": protocol, "syncEvery": 4, "perRecord": per_record}
        if serving is not None:
            tc["serving"] = serving
        if overload is not None:
            tc["overload"] = overload
        job.process_event("requests", json.dumps({
            "id": pid, "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                        "dataStructure": {"nFeatures": DIM}},
            "trainingConfiguration": tc,
        }))
    return job


def stream(records, seed=3):
    """The JAX suite's 50/50 forecast/train stream, as (stream, json)."""
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(5).randn(DIM)
    out = []
    for i in range(records):
        f = rng.randn(DIM).astype(np.float32)
        if i % 2 == 0:
            out.append(("forecastingData", json.dumps({"numericalFeatures": f.tolist()})))
        else:
            out.append(("trainingData", json.dumps({"numericalFeatures": f.tolist(),
                                                    "target": float(f @ w > 0)})))
    return out


def packed(n, seed=11):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(5).randn(DIM)
    x = rng.randn(n, DIM).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    op = (np.arange(n) % 2 == 0).astype(np.uint8)
    return x, y, op


def play(job, events, blocks=()):
    for stream_name, payload in events:
        job.process_event(stream_name, payload)
    for x, y, op in blocks:
        job.process_packed_batch(x, y, op)
    return job.terminate()


def both(events, blocks=(), **kw):
    return {side: (lambda j: (j, play(j, events, blocks)))(build(side, **kw))
            for side in SIDES}


def letters(job):
    return [(e["reason"], e.get("tenant"), e.get("queueDepth"), e["stream"], e["payload"])
            for e in job.dead_letter.entries]


def shed_log(job):
    return [entry for s in job.spokes if s.overload is not None for entry in s.overload.shed_log]


def assert_match(runs, min_equal=None):
    """``min_equal``: hold the PA sign predictions to that share equal
    instead of the tolerance (against the JAX cohort engine, whose gang
    fits are not bitwise its solo fits, so a margin near zero may flip)."""
    (jj, jr), (tj, tr) = runs["jax"], runs["port"]
    assert [p.mlp_id for p in tj.predictions] == [p.mlp_id for p in jj.predictions]
    tv, jv = [p.value for p in tj.predictions], [p.value for p in jj.predictions]
    if min_equal is None:
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    else:
        assert np.mean(np.asarray(tv) == np.asarray(jv)) >= min_equal
    assert letters(tj) == letters(jj)
    assert tj.dead_letter.by_reason == jj.dead_letter.by_reason
    assert shed_log(tj) == shed_log(jj)
    for js, ts in zip(jr.statistics, tr.statistics):
        jd, td = js.to_dict(), ts.to_dict()
        for key, jv in jd.items():
            if key in WALL_CLOCK or key in ("score", "cumulativeLoss", "learningCurve"):
                continue
            assert td[key] == jv, key
    assert tj.queue_depths() == jj.queue_depths()
    return jr, tr


# --- the job against the JAX job ---

def test_hot_tenant_burst_matches_jax():
    """8 tenants, 640 records, the seeded burst at tenant 0: the hot tenant
    sheds and throttles, the healthy ones serve every forecast, the level
    peaks at CRITICAL and returns to OK, and nothing is stranded."""
    runs = both(stream(640), n_pipe=8, overload=OVR, chaos=BURST)
    jr, tr = assert_match(runs)
    by = {s.pipeline: s for s in tr.statistics}
    assert by[0].forecasts_shed > 0 and by[0].records_throttled > 0
    assert by[0].pressure_level == tov.CRITICAL
    assert all(by[p].forecasts_shed == 0 and by[p].forecasts_served == 320 for p in range(1, 8))
    tj = runs["port"][0]
    assert tj.overload_level() == tov.OK
    assert all(v == 0 for v in tj.terminate_accounting.values())
    sheds = [e for e in tj.dead_letter.entries if e["reason"] == "shed_overload"]
    assert sheds and all(e["tenant"] == 0 and e["stream"] == "forecastingData" for e in sheds)


@pytest.mark.parametrize("extra", [",deferCap=4", ",shed=false"])
def test_defer_cap_and_shed_off_match_jax(extra):
    runs = both(stream(320), overload=OVR + extra, chaos=BURST)
    assert_match(runs)
    tj = runs["port"][0]
    if extra == ",deferCap=4":
        assert tj.dead_letter.by_reason.get("throttled", 0) > 0
    else:
        assert tj.dead_letter.by_reason.get("shed_overload", 0) == 0


def test_burst_then_packed_blocks_match_jax():
    """The burst leaves tenant 0 over its limit under pressure; the packed
    blocks after it are admitted block by block before the cohort's gang
    walk, so tenant 0 leaves the gang while it is over (its forecast rows
    shed or serve, its training rows defer)."""
    blocks = [packed(64, seed=s) for s in range(6)]
    runs = both(stream(200), blocks, n_pipe=6, overload=OVR, chaos=BURST, cohort="on")
    assert_match(runs, min_equal=0.99)
    assert runs["port"][0].spokes[0].overload.total_throttled > 0


@pytest.mark.parametrize("parallelism,protocol", [(1, "Asynchronous"), (2, "Synchronous")])
def test_armed_uniform_traffic_bitwise_unarmed(parallelism, protocol):
    """Fair-share admission never flags uniform fan-out, so an armed job
    is bitwise the unarmed one (and the JAX armed job within tolerance)."""
    def run(side, overload):
        job = build(side, overload, parallelism=parallelism, protocol=protocol)
        return job, play(job, stream(320))

    off, on = run("port", None), run("port", "on")
    assert [(p.mlp_id, p.value) for p in on[0].predictions] == [
        (p.mlp_id, p.value) for p in off[0].predictions]
    assert all(s.overload.level_peak == tov.OK and s.overload.total_shed == 0
               for s in on[0].spokes)
    assert_match({"jax": run("jax", "on"), "port": on})


def test_armed_packed_cohort_bitwise_unarmed():
    """Quiet armed block admission (cohorts on, perRecord PA): every
    prediction bitwise the unarmed run's."""
    blocks = [packed(96, seed=s) for s in range(4)]
    runs = {}
    for overload in (None, "on"):
        job = build("port", overload, n_pipe=6, cohort="on", per_record=True)
        runs[overload] = (job, play(job, [], blocks))
    assert [p.value for p in runs["on"][0].predictions] == [
        p.value for p in runs[None][0].predictions]


def test_tenant_routing_rules():
    """A tenant-addressed record goes to that tenant alone with the plane
    armed, and broadcasts with neither the plane nor the burst armed; a
    non-dict metadata value never routes."""
    rec = json.dumps({"numericalFeatures": [0.0] * DIM, "metadata": {"tenant": 1}})
    for overload, want in ((OVR, {0: 0, 1: 1, 2: 0}), (None, {0: 1, 1: 1, 2: 1})):
        job = build("port", overload, n_pipe=3)
        report = play(job, [("forecastingData", rec)])
        assert {s.pipeline: s.forecasts_served for s in report.statistics} == want
    job = build("port", "on", n_pipe=2)
    report = play(job, [("forecastingData", json.dumps(
        {"numericalFeatures": [0.0] * DIM, "metadata": m})) for m in ("a", ["x"], 7)])
    assert all(s.forecasts_served == 3 for s in report.statistics)


def test_idle_ticks_clear_a_critical_level():
    job = build("port", OVR, chaos=BURST)
    for i, (name, payload) in enumerate(stream(320)):
        job.process_event(name, payload)
        if job.overload_level() >= tov.CRITICAL:
            break
    assert job.overload_level() == tov.CRITICAL
    for _ in range(400):
        job.overload_idle_tick()
        if job.overload_level() == tov.OK:
            break
    assert job.overload_level() == tov.OK
    job.terminate()


def test_queue_depths_mid_stream_and_after_terminate():
    jobs = {side: build(side, OVR, chaos=BURST) for side in SIDES}
    for side, job in jobs.items():
        for name, payload in stream(84):
            job.process_event(name, payload)
    tj, jj = jobs["port"], jobs["jax"]
    assert tj.queue_depths() == jj.queue_depths()
    assert tj.queue_depths()["batcher"] > 0
    assert tj.tenant_topology()["queues"] == tj.queue_depths()
    for job in jobs.values():
        job.terminate()
    assert tj.terminate_accounting == jj.terminate_accounting
    queues = ("serving", "batcher", "throttled", "paused", "pre_create", "backlog")
    assert all(tj.terminate_accounting[k] == 0 for k in queues)


def _tenant_records(n=2):
    return [("forecastingData", json.dumps({"numericalFeatures": [0.0] * DIM,
                                            "metadata": {"tenant": 1}}))] * n


@pytest.mark.parametrize("overload,chaos", [(OVR, ""), (None, BURST)])
def test_armed_controller_routes_on_grown_spoke(overload, chaos):
    """A spoke a grow adds routes tenant-addressed records as an original
    does, whether the controller or the burst injector arms the route."""
    for side in SIDES:
        job = build(side, overload, n_pipe=3, chaos=chaos)
        job.rescale(2)
        assert (job.spokes[1].overload is not None) == (overload is not None)
        assert job.spokes[1].tenant_routing == bool(chaos)
        report = play(job, _tenant_records())
        assert {s.pipeline: s.forecasts_served for s in report.statistics} == {0: 0, 1: 2, 2: 0}


def test_job_level_flag_survives_grow():
    job = build("port", None, n_pipe=3, chaos=BURST)
    assert job._burst is not None
    job.rescale(3)
    assert all(s.tenant_routing for s in job.spokes)
    job = build("port", None, n_pipe=3)
    job.rescale(2)
    assert job.spokes[1].overload is None and not job.spokes[1].tenant_routing


def test_shrink_under_burst_matches_jax():
    """A shrink mid-burst drains the retiring spoke's throttled rows into
    its replicas before the merge and carries its unfolded counters over."""
    events = stream(400)
    runs = {}
    for side in SIDES:
        job = build(side, OVR, chaos=BURST, parallelism=2)
        for name, payload in events[:240]:
            job.process_event(name, payload)
        job.rescale(1)
        runs[side] = (job, play(job, events[240:]))
    jr, tr = assert_match(runs)
    assert sum(s.forecasts_shed for s in tr.statistics) > 0


def test_queue_accessors():
    b = MicroBatcher(DIM, 8)
    b.add(np.zeros(DIM, np.float32), 1.0)
    b.add(np.zeros(DIM, np.float32), 0.0)
    assert b.queued() == 2 == len(b)
    b.flush()
    assert b.queued() == 0
    pf = prefetch(iter(range(3)), depth=2)
    assert list(pf) == [0, 1, 2]
    value, high, critical = pf.as_signal()()
    assert (value, high, critical) == (1.0, 0.75, 0.95)


def test_heartbeat_folds_match_jax():
    """Mid-burst, the read-only heartbeat snapshot carries the overload
    counters the terminate fold will take (peeked, not taken), and the
    heartbeat frame the level, imbalance and backlog, as the JAX job's."""
    events = stream(200)
    jobs = {side: build(side, OVR, chaos=BURST) for side in SIDES}
    for job in jobs.values():
        for name, payload in events:
            job.process_event(name, payload)
    jj, tj = jobs["jax"], jobs["port"]
    keys = ("forecastsShed", "recordsThrottled", "pressureLevel", "programLaunches",
            "forecastsServed", "fitted", "recordsQuarantined", "activeVersion")
    for js, ts in zip(jj.heartbeat_statistics(), tj.heartbeat_statistics()):
        jd, td = js.to_dict(), ts.to_dict()
        assert {k: td[k] for k in keys} == {k: jd[k] for k in keys}
    assert sum(s.forecasts_shed for s in tj.heartbeat_statistics()) > 0
    jf, tf = jj.heartbeat_frame(), tj.heartbeat_frame()
    for k in ("level", "imbalance", "backlog", "events", "alerts"):
        assert tf[k] == jf[k], k
    report = tj.terminate()
    jr = jj.terminate()
    assert [s.forecasts_shed for s in report.statistics] == [
        s.forecasts_shed for s in jr.statistics]


class _LimitsNet:
    """A serving-armed net as the serving plane sees it: its static config
    and the limits in force (``serving_limits``), widened under pressure."""

    def __init__(self, queue_cls, nid, static, in_force):
        self.request = types.SimpleNamespace(id=nid)
        self.pipeline = types.SimpleNamespace()
        self.serving = static
        self.serve_queue = queue_cls()
        self._in_force = in_force

    def serving_limits(self):
        return self._in_force


@pytest.mark.parametrize("widen", [1.0, 4.0])
def test_flush_points_under_widened_limits_match_jax(widen):
    """The port skips the lookup of the limits in force while a queue is
    short of its static maxBatch and maxDelayMs (the plane only widens
    them); the fill flag and the deadline flushes stay the JAX plane's,
    admission for admission."""
    from omldm_tpu.runtime import serving as jsv
    from omldm_tpu_torch.runtime import serving as tsv

    def drive(mod, cfg_cls):
        static = cfg_cls(max_batch=4, max_delay_ms=10.0)
        in_force = cfg_cls(max_batch=int(4 * widen), max_delay_ms=10.0 * widen)
        now = [0.0]
        plane = mod.ServingPlane(lambda p: None, clock=lambda: now[0])
        flushed = []
        plane.flush_group = lambda nets: [
            (flushed.append((now[0], n.request.id, n.serve_queue.n_rows)),
             plane.take_queue(n)) for n in nets]
        nets = [_LimitsNet(mod.ServeQueue, i, static, in_force if i == 0 else static)
                for i in range(2)]
        fills = []
        for step in range(40):
            now[0] = step * 0.002
            for net in nets[: 1 + step % 2]:
                plane.admit(net, None, np.zeros(2, np.float32))
            fills.append(plane._fill)
            plane.maybe_fill_flush()
            plane.poll()
        return fills, flushed

    port, ref = drive(tsv, ServingConfig), drive(jsv, JServingConfig)
    assert port == ref
    fills, flushed = port
    # the widened net's queue first fills at its widened maxBatch
    first = next(n for _, nid, n in flushed if nid == 0)
    assert first == int(4 * widen)
    assert any(fills)
