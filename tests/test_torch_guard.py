"""The model-integrity guard: the port against the JAX package.

- ``guard_config``, ``admission_reason`` and the health scalar on the same
  inputs; ``ModelGuard``'s trip, snapshot ring and rollback on a port
  pipeline.
- Whole ``StreamJob`` runs (dim 12, parallelism 2, PA C 1.0, syncEvery 2,
  packed blocks of 512 rows: tests/test_guard.py's template) under the
  chaos specs of tests/test_guard.py: ``seed=7,up.nan=0.05,up.explode=0.05``
  on the four protocols that push every sync, ``seed=3,up.nan=0.3,
  up.explode=0.3`` on GM and FGM, ``seed=11,up.nan=0.04`` on top-k
  Asynchronous, and the first spec on both directions (so the workers'
  own guards trip). Rejections, rollbacks, the hubs' retired workers, the
  dead-letter reason counts and every other integer counter equal the JAX
  job's; parameters at rtol 2e-4, atol 2e-5; the holdout score within one
  holdout row.
- A NaN poked into a worker's parameters mid-stream (CentralizedTraining,
  Synchronous, Asynchronous under int8): the same rollbacks and
  rejections as the JAX job, and finite parameters after.
- Guarded cohorts (cohorts on, one worker): a poisoned member is evicted,
  rolled back and its siblings' parameters stay bitwise those of the
  clean run, in both member iterations (``map``, and ``vmap`` as on the
  card); held to the JAX solo job (cohorts off), as the cohort tests hold
  the port to the solo reference.
"""

import json

import jax
import numpy as np
import pytest
import torch

from omldm_tpu import guard as jguard
from omldm_tpu.api.requests import LearnerSpec as JLearnerSpec
from omldm_tpu.api.requests import TrainingConfiguration as JTrainingConfiguration
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.pipelines import MLPipeline as JMLPipeline
from omldm_tpu.pipelines.pipeline import _param_health as jax_param_health
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch import guard as tguard
from omldm_tpu_torch.api.requests import LearnerSpec, Request, RequestType, TrainingConfiguration
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.pipelines.pipeline import param_health
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime.hub import Hub

DIM = 12
RTOL, ATOL = 2e-4, 2e-5
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}
CHAOS = "seed=7,up.nan=0.05,up.explode=0.05"
CHAOS_RARE_PUSH = "seed=3,up.nan=0.3,up.explode=0.3"
CHAOS_TOPK = "seed=11,up.nan=0.04"


def make_stream(records, dim=DIM, seed=11):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(42).randn(dim)
    x = rng.randn(records, dim).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    return x, y


def create_request(pid=0, protocol="Asynchronous", dim=DIM, guard=True, codec=None,
                   extra=None):
    tc = {"protocol": protocol, "syncEvery": 2}
    if guard is not None:
        tc["guard"] = guard
    if codec is not None:
        tc["comm"] = {"codec": codec}
    tc.update(extra or {})
    return json.dumps({
        "id": pid, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                    "dataStructure": {"nFeatures": dim}},
        "trainingConfiguration": tc,
    })


def run_job(job, x, y, requests, chunk=512, poke=None):
    for req in requests:
        job.process_event("requests", req)
    op = np.zeros((x.shape[0],), np.uint8)
    for i in range(0, x.shape[0], chunk):
        job.process_packed_batch(x[i:i + chunk], y[i:i + chunk], op[i:i + chunk])
        if poke is not None and i == 2 * chunk:
            poke(job)
    return job.terminate(), job


def port_job(vmap=False, **kw):
    """A port job on the CPU; ``vmap`` makes its cohorts iterate members as
    they do on the card."""
    job = StreamJob(JobConfig(**kw), device="cpu")
    for spoke in job.spokes:
        if spoke.cohorts is not None:
            spoke.cohorts.use_vmap = vmap
    return job


def job_pair(x, y, requests, parallelism=2, chaos="", cohort="off", poke=None,
             port_cohort=None, vmap=False):
    kw = dict(parallelism=parallelism, batch_size=32, test_set_size=64, chaos=chaos,
              cohort_min=2)
    jr, jj = run_job(JaxStreamJob(JaxJobConfig(cohort=cohort, **kw)), x, y, requests,
                     poke=poke)
    tr, tj = run_job(port_job(vmap, cohort=port_cohort or cohort, **kw),
                     x, y, requests, poke=poke)
    return jr, jj, tr, tj


def nan_poke(spoke_idx=0, net_id=0):
    def poke(job):
        net = job.spokes[spoke_idx].nets[net_id]
        flat, _ = net.pipeline.get_flat_params()
        net.pipeline.set_flat_params(np.full_like(flat, np.nan))
    return poke


def assert_stats_match(jr, tr, skip=()):
    for js, ts in zip(jr.statistics, tr.statistics):
        jd, td = js.to_dict(), ts.to_dict()
        assert set(td) == set(jd)
        for key, jv in jd.items():
            tv = td[key]
            if key in WALL_CLOCK_FIELDS or key in skip:
                continue
            if key == "score":
                assert abs(tv - jv) <= 1.0 / 64 + 1e-9, key
            elif isinstance(jv, list):
                np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=key)
            elif isinstance(jv, float):
                assert abs(tv - jv) <= 1e-4, (key, tv, jv)
            else:
                assert tv == jv, (key, tv, jv)


def assert_flats_match(jj, tj, nets=None):
    for js, ts in zip(jj.spokes, tj.spokes):
        for nid, jnet in js.nets.items():
            if nets is not None and nid not in nets:
                continue
            tflat = ts.nets[nid].pipeline.get_flat_params()[0]
            assert np.isfinite(tflat).all()
            np.testing.assert_allclose(tflat, jnet.pipeline.get_flat_params()[0],
                                       rtol=RTOL, atol=ATOL)


# --- units ---


@pytest.mark.parametrize("guard", [None, False, True, "on",
                                   {"normLimit": 10.0, "maxStrikes": 3, "lkgDepth": 2,
                                    "snapshotEvery": 5},
                                   {"maxStrikes": 0, "lkgDepth": -1}])
def test_guard_config_matches_jax(guard):
    extra = {} if guard is None else {"guard": guard}
    t = tguard.guard_config(TrainingConfiguration(extra=extra))
    j = jguard.guard_config(JTrainingConfiguration(extra=extra))
    assert (t is None) == (j is None)
    if j is not None:
        assert (t.norm_limit, t.max_strikes, t.lkg_depth, t.snapshot_every) == (
            j.norm_limit, j.max_strikes, j.lkg_depth, j.snapshot_every)


def _payloads():
    ok = np.ones(8, np.float32)
    nan = ok.copy()
    nan[3] = np.nan
    inf = ok.copy()
    inf[2] = -np.inf
    big = np.full(8, 1e9, np.float32)
    huge = np.full(8, 3e38, np.float32)  # finite, its squared sum overflows
    return [
        {"params": ok, "fitted": 3}, ok, {"inc": 2, "curve": []}, {"gap": True},
        {"params": nan}, inf, {"params": big}, {"params": huge},
        {"phi": float("nan")}, {"params": ok, "curve": [(float("nan"), 3)]},
        {"params": np.zeros((0,), np.float32)}, {"params": np.ones(4, np.int32)},
    ]


@pytest.mark.parametrize("limit", [1e6, 1e12])
def test_admission_reason_matches_jax(limit):
    for payload in _payloads():
        assert tguard.admission_reason(payload, limit) == jguard.admission_reason(payload, limit)
        assert tguard.payload_non_finite(payload) == jguard.payload_non_finite(payload)
        assert (tguard._payload_vector(payload) is None) == (
            jguard._payload_vector(payload) is None)


def test_param_health_matches_jax():
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(13).astype(np.float32), "b": rng.randn(3, 4).astype(np.float32),
              "count": np.int32(7)}
    t = param_health({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    j = jax_param_health(params)
    assert t.dim() == 0
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    params["w"][4] = np.nan
    assert np.isnan(float(param_health({"w": torch.from_numpy(params["w"])})))


def _pipelines(cfg):
    spec = dict(hyper_parameters={"C": 1.0})
    jcfg = jguard.GuardConfig(cfg.norm_limit, cfg.max_strikes, cfg.lkg_depth,
                              cfg.snapshot_every)
    return (MLPipeline(LearnerSpec("PA", **spec), dim=4, guard=cfg, device="cpu"),
            JMLPipeline(JLearnerSpec("PA", **spec), dim=4, guard=jcfg))


def test_model_guard_trips_snapshots_and_rolls_back_as_jax():
    """Fits, a NaN poke, an exploded norm: the same check verdicts, the
    same snapshot ring and the same rolled-back parameters; a non-finite
    cum_loss resets to zero on the pipeline's device."""
    t, j = _pipelines(tguard.GuardConfig(norm_limit=50.0, lkg_depth=2, snapshot_every=2))
    assert t.cache_key[-1] is True and t.guard is not None
    rng = np.random.RandomState(0)
    verdicts = []
    for step in range(10):
        x = rng.randn(8, 4).astype(np.float32)
        y = np.sign(rng.randn(8)).astype(np.float32)
        m = np.ones(8, np.float32)
        if step == 6:
            for p in (t, j):
                flat, _ = p.get_flat_params()
                p.set_flat_params(np.full_like(flat, np.nan))
        if step == 8:
            for p in (t, j):
                p.set_flat_params(np.full(5, 1e3, np.float32))
        for p in (t, j):
            p.fit(x, y, m)
        vt, vj = t.guard.check(), j.guard.check()
        verdicts.append(vt)
        assert vt == vj
        for p, v in ((t, vt), (j, vj)):
            if v is None:
                p.guard.maybe_snapshot(p)
            else:
                assert p.guard.rollback(p)
        assert t.guard.lkg_depth == j.guard.lkg_depth
        np.testing.assert_allclose(t.get_flat_params()[0], j.get_flat_params()[0],
                                   rtol=RTOL, atol=ATOL)
    assert verdicts.count("non_finite") == 1 and verdicts.count("norm_exploded") == 1
    assert t.guard.trips == j.guard.trips == 2
    assert np.isfinite(t.cumulative_loss) and t.state["cum_loss"].device.type == "cpu"


def test_guarded_fit_is_one_launch():
    """The health dot products ride the fit: programLaunches counts one
    launch a fit or fit_many, guarded or not."""
    counts = []
    for cfg in (None, tguard.GuardConfig()):
        p = MLPipeline(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=4, guard=cfg,
                       device="cpu", per_record=True)
        n = [0]
        p.on_launch = lambda: n.__setitem__(0, n[0] + 1)
        x = np.random.RandomState(1).randn(3, 8, 4).astype(np.float32)
        y = np.ones((3, 8), np.float32)
        m = np.ones((3, 8), np.float32)
        p.fit(x[0], y[0], m[0])
        p.fit_many(x, y, m)
        counts.append(n[0])
        if cfg is not None:
            assert p.guard._fits_since_snapshot == 4
            assert p.guard._pending.dim() == 0  # unread, on the device
    assert counts == [2, 2]


# --- whole jobs ---


def test_guarded_clean_stream_matches_unguarded_and_jax():
    x, y = make_stream(3072)
    jr, jj, tr, tj = job_pair(x, y, [create_request(guard=True)])
    assert_stats_match(jr, tr)
    assert_flats_match(jj, tj)
    _, tj_off = run_job(StreamJob(JobConfig(parallelism=2, batch_size=32, test_set_size=64),
                                  device="cpu"), x, y, [create_request(guard=None)])
    for sp, sp_off in zip(tj.spokes, tj_off.spokes):
        np.testing.assert_array_equal(sp.nets[0].pipeline.get_flat_params()[0],
                                      sp_off.nets[0].pipeline.get_flat_params()[0])


GUARD_CASES = [
    ("Asynchronous", CHAOS, None, {}),
    ("Synchronous", CHAOS, None, {}),
    ("SSP", CHAOS, None, {}),
    ("EASGD", CHAOS, None, {}),
    ("GM", CHAOS_RARE_PUSH, None, {"threshold": 0.3}),
    ("FGM", CHAOS_RARE_PUSH, None, {"threshold": 0.3}),
    ("Asynchronous", CHAOS_TOPK, "topk", {}),
    ("Asynchronous", "seed=7,nan=0.05,explode=0.05", None, {}),
]


@pytest.mark.parametrize("protocol,chaos,codec,extra", GUARD_CASES,
                         ids=[f"{p}-{c}-{k}" for p, c, k, _ in GUARD_CASES])
def test_guard_under_chaos_matches_jax(protocol, chaos, codec, extra):
    dim = 32 if codec else DIM
    x, y = make_stream(4096, dim=dim)
    req = create_request(protocol=protocol, dim=dim, codec=codec, extra=extra)
    jr, jj, tr, tj = job_pair(x, y, [req], chaos=chaos)
    assert_stats_match(jr, tr)
    assert_flats_match(jj, tj)
    [s] = tr.statistics
    assert s.deltas_rejected > 0  # the corruption reached the admission boundary
    if chaos.startswith("seed=7,nan"):
        assert s.rollbacks_performed > 0  # down corruption trips the workers
    th, jh = tj.hub_manager.hubs[(0, 0)].node, jj.hub_manager.hubs[(0, 0)].node
    assert th._guard_retired == jh._guard_retired
    assert th._guard_strikes == jh._guard_strikes
    assert tj.dead_letter.by_reason == jj.dead_letter.by_reason
    for direction in ("_chaos_up", "_chaos_down"):
        assert getattr(tj, direction).counters() == getattr(jj, direction).counters()
    trips = [sp.nets[0].pipeline.guard.trips for sp in tj.spokes]
    assert trips == [sp.nets[0].pipeline.guard.trips for sp in jj.spokes]
    assert sum(trips) == s.rollbacks_performed


@pytest.mark.parametrize("protocol,parallelism,codec", [
    ("CentralizedTraining", 1, None), ("Synchronous", 2, None), ("Asynchronous", 2, "int8"),
])
def test_nan_poke_rolls_back_as_jax(protocol, parallelism, codec):
    dim = 32 if codec else DIM
    x, y = make_stream(4096, dim=dim)
    req = create_request(protocol=protocol, dim=dim, codec=codec)
    jr, jj, tr, tj = job_pair(x, y, [req], parallelism=parallelism, poke=nan_poke())
    assert_stats_match(jr, tr)
    assert_flats_match(jj, tj)
    [s] = tr.statistics
    assert s.rollbacks_performed + s.deltas_rejected >= 1


@pytest.mark.parametrize("use_vmap", [False, True])
def test_guarded_cohort_evicts_the_poisoned_member(use_vmap):
    """4 guarded nets on one worker with cohorts on; net 2 is poisoned
    mid-stream. It trips, is evicted to solo and rolled back; its siblings
    stay attached with parameters bitwise those of the clean cohort run.
    Every net is held to the JAX job with cohorts off (the solo reference),
    counters included but for members_evicted (a solo job evicts none)."""
    x, y = make_stream(3072)
    reqs = [create_request(pid) for pid in range(4)]
    _, clean = run_job(port_job(use_vmap, parallelism=1, batch_size=32, test_set_size=64,
                                cohort="on"), x, y, reqs)
    jr, jj, tr, tj = job_pair(x, y, reqs, parallelism=1, cohort="off",
                              port_cohort="on", poke=nan_poke(net_id=2), vmap=use_vmap)
    spoke = tj.spokes[0]
    cohort = next(iter(spoke.cohorts.cohorts.values()))
    assert cohort.guarded and cohort.use_vmap is use_vmap
    assert spoke.nets[2].pipeline._cohort is None
    assert all(spoke.nets[p].pipeline._cohort is cohort for p in (0, 1, 3))
    by_pid = {s.pipeline: s for s in tr.statistics}
    assert by_pid[2].members_evicted == 1 and by_pid[2].rollbacks_performed == 1
    assert sum(s.members_evicted for s in tr.statistics) == 1
    for pid in (0, 1, 3):
        np.testing.assert_array_equal(spoke.nets[pid].pipeline.get_flat_params()[0],
                                      clean.spokes[0].nets[pid].pipeline.get_flat_params()[0])
    # a gang launch counts on the member that caused it (ROADMAP queue 3)
    assert_stats_match(jr, tr, skip=("membersEvicted", "programLaunches"))
    assert_flats_match(jj, tj)


def _hub(protocol="Asynchronous", max_strikes=1, workers=3, quorum=None):
    sent = []
    extra = {"guard": {"maxStrikes": max_strikes}}
    if quorum is not None:
        extra["comm"] = {"quorum": quorum}
    request = Request(
        id=0, request=RequestType.CREATE,
        learner=LearnerSpec("PA", hyper_parameters={"C": 1.0},
                            data_structure={"nFeatures": 8}),
        training_configuration=TrainingConfiguration(protocol=protocol, extra=extra),
    )
    hub = Hub(0, 0, request, 8, JobConfig(parallelism=workers),
              reply=lambda w, op, payload: sent.append((w, op)),
              broadcast=lambda op, payload: sent.append(("*", op)), device="cpu")
    return hub, sent


def _push(vec, fitted=1):
    return {"params": vec, "curve": [], "fitted": fitted}


def test_hub_admission_rejects_retires_and_readmits():
    hub, sent = _hub()
    good = np.ones(13, np.float32)
    bad = good.copy()
    bad[0] = np.nan
    hub.receive(0, "push", _push(good))
    hub.receive(1, "push", _push(bad))
    assert hub.node.stats.deltas_rejected == 1
    assert hub.node._guard_retired == {1} and hub.node.round_target() == 2
    assert (1, "resync") in sent
    hub.receive(1, "push", _push(good, fitted=2))
    assert not hub.node._guard_retired and hub.node.round_target() == 3
    # the strike budget, and the quorum floor
    hub, _ = _hub(max_strikes=2)
    hub.receive(1, "push", _push(bad))
    assert not hub.node._guard_retired
    hub.receive(1, "push", _push(bad))
    assert hub.node._guard_retired == {1}
    hub, _ = _hub(workers=2, quorum=2)
    hub.receive(1, "push", _push(bad))
    assert not hub.node._guard_retired


def test_sync_barrier_releases_without_the_poisoned_worker():
    hub, sent = _hub(protocol="Synchronous", workers=2)
    hub.receive(0, "push", _push(np.ones(13, np.float32)))
    assert not any(op == "update" for _, op in sent)
    hub.receive(1, "push", _push(np.full(13, np.inf, np.float32)))
    assert any(op == "update" for _, op in sent)
    assert hub.node.stats.fitted == 1


def test_poisoned_release_answers_nan_as_jax():
    """A worker whose release arrives poisoned (both directions corrupted)
    serves NaN until its guard's next check rolls it back; the JAX package
    answers NaN there too (jnp.sign keeps a NaN margin, where torch.sign
    gives 0). The predictions are equal, NaN for NaN."""
    rng = np.random.RandomState(0)
    w = rng.randn(6)
    events = [("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                    "dataStructure": {"nFeatures": 6}},
        "trainingConfiguration": {"protocol": "Asynchronous", "syncEvery": 2,
                                  "perRecord": True, "guard": True},
    }))]
    for i in range(3000):
        x = np.round(rng.randn(6), 5).tolist()
        events.append(("trainingData", json.dumps({"numericalFeatures": x,
                                                   "target": float(np.dot(x, w) > 0)})))
        if i % 9 == 8:
            events.append(("forecastingData", json.dumps({"numericalFeatures": x})))
    kw = dict(parallelism=4, batch_size=32, test_set_size=32,
              chaos="seed=7,nan=0.05,explode=0.05")
    jax_job, job = JaxStreamJob(JaxJobConfig(**kw)), StreamJob(JobConfig(**kw), device="cpu")
    jax_job.run(events)
    job.run(events)
    jp = np.array([p.value for p in jax_job.predictions])
    tp = np.array([p.value for p in job.predictions])
    assert np.isnan(tp).sum() > 0
    np.testing.assert_array_equal(tp, jp)
    assert job.performance[-1].statistics[0].rollbacks_performed > 0
