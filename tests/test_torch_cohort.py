"""The port's cohort engine (omldm_tpu_torch.runtime.cohort) against the
port's solo path and the JAX package's solo path, on the same numpy inputs.

- ``map`` (what the CPU runs) runs the solo ``_fit_impl`` on views of the
  stacked state, so a cohort member equals a solo pipeline BITWISE:
  losses, state, predictions, flat parameters and fitted counts.
- ``map`` and ``vmap`` (what the card runs: ``torch.func.vmap`` over the
  members; the CPU tests set ``CohortEngine.use_vmap`` to run it here)
  are each held to the JAX SOLO pipeline fed the same initial
  parameters: parameters within rtol=2e-4, atol=2e-5 and losses within
  rtol=1e-4, atol=1e-5 (float32 sums in another order; the JAX cohort's own
  bitwise claim fails on the reference, see ROADMAP "Known differences").
- The multi-tenant ``StreamJob`` (8 same-spec Creates, Synchronous at
  parallelism 2) forms a cohort on each spoke and is held to the JAX job
  with cohorts off and with its default cohorts (see the test for what
  each comparison covers): every prediction within 1e-6 of the JAX one (a
  sign equal), Query parameters within rtol=2e-4, atol=2e-5, every integer
  statistic but programLaunches equal (gang launches are fewer), float
  statistics within 1e-4, the holdout score within one holdout row.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import LearnerSpec as JaxSpec
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.pipelines import MLPipeline as JaxPipeline
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch.api.requests import LearnerSpec
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.pipelines.pipeline import _leaves, state_from_numpy
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import cohort as cohort_mod
from omldm_tpu_torch.runtime.cohort import (
    Cohort,
    CohortEngine,
    GangAverager,
    resolve_cohort_shards,
)
from omldm_tpu_torch.runtime.spoke import Spoke

DIM = 8
RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5

# every dense learner spec of the reference's cohort tests
# (tests/test_cohort.py DENSE_LEARNERS): HT is host-side and K-means is
# SingleLearner-only, so both stay solo
DENSE_LEARNERS = [
    ("PA", {"C": 1.0}, False),
    ("PA", {"C": 1.0}, True),
    ("RegressorPA", {"C": 0.1, "epsilon": 0.1}, False),
    ("ORR", {"lambda": 1.0}, False),
    ("SVM", {}, False),
    ("MultiClassPA", {"C": 1.0, "nClasses": 3}, False),
    ("NN", {"hidden": 8}, False),
    ("Softmax", {"learningRate": 0.05, "nClasses": 2}, False),
]
SPEC_IDS = [f"{n}{'-perRecord' if r else ''}" for n, _, r in DENSE_LEARNERS]


class _Cfg:
    def __init__(self, cohort="on", cohort_min=1, cohort_shards="off"):
        self.cohort = cohort
        self.cohort_min = cohort_min
        self.cohort_shards = cohort_shards


def _engine(impl="map", **kw):
    """A CPU engine; ``impl="vmap"`` makes it run the card's member
    iteration on the CPU."""
    engine = CohortEngine(_Cfg(**kw), "cpu")
    engine.use_vmap = impl == "vmap"
    return engine


def _job_impl(job, impl):
    """Make a CPU job's cohort engines iterate members as ``impl`` says."""
    for spoke in job.spokes:
        if spoke.cohorts is not None:
            spoke.cohorts.use_vmap = impl == "vmap"
    return job


def _jax_pipes(name, hp, per_record, n):
    return [JaxPipeline(JaxSpec(name, hyper_parameters=hp), dim=DIM,
                        rng=jax.random.PRNGKey(11 + i), per_record=per_record)
            for i in range(n)]


def _port_pipes(jpipes, name, hp, per_record):
    """Port pipelines holding the JAX pipelines' initial states."""
    out = []
    for jp in jpipes:
        p = MLPipeline(LearnerSpec(name, hyper_parameters=hp), dim=DIM,
                       per_record=per_record, device="cpu")
        p.load_state(state_from_numpy(jax.tree_util.tree_map(np.asarray, jp.state), "cpu"))
        out.append(p)
    return out


def _batches(n, t, b, seed=0):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(1).randn(DIM)
    xs = rng.randn(n, t, b, DIM).astype(np.float32)
    ys = (xs @ w > 0).astype(np.float32)
    ms = np.ones((n, t, b), np.float32)
    ms[:, :, -3:] = 0.0  # a ragged tail in every batch
    return xs, ys, ms


def _flat(p):
    return p.get_flat_params()[0]


def _assert_tree_equal(a, b, msg=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y), msg


# --- gang fit against the port's and the JAX package's solo paths ----------


@pytest.mark.parametrize("impl", ["map", "vmap"])
@pytest.mark.parametrize("name,hp,per_record", DENSE_LEARNERS, ids=SPEC_IDS)
def test_gang_fit_matches_solo(name, hp, per_record, impl):
    """N attached pipelines staged and launched against N detached ones fit
    directly (the last member at a ragged staging depth): ``map`` equal to
    the port's solo path bitwise, both forms within tolerance of the JAX
    solo pipelines."""
    n, t, b = 3, 2, 16
    jsolo = _jax_pipes(name, hp, per_record, n)
    solo = _port_pipes(jsolo, name, hp, per_record)
    gang = _port_pipes(jsolo, name, hp, per_record)
    engine = _engine(impl=impl)
    for p in gang:
        engine.consider(p)
    cohort = gang[0]._cohort
    assert cohort is not None and all(p._cohort is cohort for p in gang)
    assert cohort.use_vmap == (impl == "vmap")

    xs, ys, ms = _batches(n, t, b)
    depth = [t] * (n - 1) + [1]
    jl, sl, gl = [], [], []
    for i in range(n):
        for ti in range(depth[i]):
            jl.append(float(jsolo[i].fit(xs[i, ti], ys[i, ti], ms[i, ti])))
            sl.append(float(solo[i].fit(xs[i, ti], ys[i, ti], ms[i, ti])))
            gl.append(gang[i].fit(xs[i, ti], ys[i, ti], ms[i, ti]))
    assert cohort.has_staged(0)
    engine.flush()
    gl = [float(l) for l in gl]
    xq = np.random.RandomState(9).randn(8, DIM).astype(np.float32)
    np.testing.assert_allclose(gl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for i in range(n):
        np.testing.assert_allclose(_flat(gang[i]), np.asarray(jsolo[i].get_flat_params()[0]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"member {i}")
        np.testing.assert_allclose(gang[i].predict(xq).numpy(),
                                   np.asarray(jsolo[i].predict(xq)), rtol=RTOL, atol=ATOL)
        assert gang[i].fitted == solo[i].fitted == jsolo[i].fitted
        assert abs(gang[i].cumulative_loss - jsolo[i].cumulative_loss) <= 1e-4 * max(
            1.0, abs(jsolo[i].cumulative_loss))
    if impl == "map":
        assert gl == sl
        for i in range(n):
            _assert_tree_equal(solo[i].state, gang[i].state, f"member {i}")
            assert torch.equal(solo[i].predict(xq), gang[i].predict(xq))
            np.testing.assert_array_equal(_flat(solo[i]), _flat(gang[i]))
            assert solo[i].cumulative_loss == gang[i].cumulative_loss
        # the learning curves drain the same points
        for s, g in zip(solo, gang):
            assert s.curve_slice() == g.curve_slice()


@pytest.mark.parametrize("impl", ["map", "vmap"])
def test_fit_many_stages_a_chain(impl):
    """``fit_many`` on a member stages T steps at once; the chain equals T
    solo fits (map: bitwise)."""
    jp = _jax_pipes("Softmax", {"learningRate": 0.05, "nClasses": 2}, False, 2)
    solo = _port_pipes(jp, "Softmax", {"learningRate": 0.05, "nClasses": 2}, False)
    gang = _port_pipes(jp, "Softmax", {"learningRate": 0.05, "nClasses": 2}, False)
    engine = _engine(impl=impl)
    for p in gang:
        engine.consider(p)
    xs, ys, ms = _batches(2, 3, 8)
    for i in range(2):
        ls = solo[i].fit_many(xs[i], ys[i], ms[i])
        lg = gang[i].fit_many(xs[i], ys[i], ms[i])
        engine.flush()
        np.testing.assert_allclose(np.asarray(lg), ls.numpy(), rtol=LOSS_RTOL, atol=LOSS_ATOL)
        if impl == "map":
            np.testing.assert_array_equal(np.asarray(lg), ls.numpy())
        np.testing.assert_allclose(_flat(gang[i]), _flat(solo[i]), rtol=RTOL, atol=ATOL)
        assert gang[i].fitted == solo[i].fitted


@pytest.mark.parametrize("impl", ["map", "vmap"])
def test_all_zero_mask_step_keeps_the_state(impl):
    """A staged step whose mask is all zero keeps its member's state
    bitwise (the JAX gang's select), even where a solo fit would move it
    (SVM's step counter, NN's Adam count)."""
    for name, hp in (("SVM", {}), ("NN", {"hidden": 8}), ("PA", {"C": 1.0})):
        jp = _jax_pipes(name, hp, name == "PA", 2)
        gang = _port_pipes(jp, name, hp, name == "PA")
        engine = _engine(impl=impl)
        for p in gang:
            engine.consider(p)
        before = [[t.clone() for t in _leaves(p.state)] for p in gang]
        xs, ys, ms = _batches(2, 1, 8)
        ms[1] = 0.0
        for i, p in enumerate(gang):
            p.fit(xs[i, 0], ys[i, 0], ms[i, 0])
        engine.flush()
        after = [_leaves(p.state) for p in gang]
        assert all(torch.equal(a, b) for a, b in zip(before[1], after[1])), name
        assert not all(torch.equal(a, b) for a, b in zip(before[0], after[0])), name


# --- membership churn ----------------------------------------------------------


def _pa(n, seed0=0):
    return [MLPipeline(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=DIM,
                       generator=torch.Generator().manual_seed(seed0 + i), device="cpu")
            for i in range(n)]


def test_detach_keeps_survivors_bitwise():
    n = 5
    gang, solo = _pa(n), _pa(n)
    engine = _engine()
    for p in gang:
        engine.consider(p)
    cohort = gang[0]._cohort
    xs, ys, ms = _batches(n, 4, 16)
    for t in range(2):
        for i in range(n):
            gang[i].fit(xs[i, t], ys[i, t], ms[i, t])
            solo[i].fit(xs[i, t], ys[i, t], ms[i, t])
        engine.flush()
    engine.retire(gang[2])  # leaves mid-stream; its slot frees
    assert gang[2]._cohort is None and gang[2]._state is not None
    _assert_tree_equal(gang[2].state, solo[2].state)
    active = cohort.n_active
    late = _pa(1, 50)[0]
    engine.consider(late)
    assert cohort.n_active == active + 1 and late._slot == 2
    for t in range(2, 4):
        for i in range(n):
            gang[i].fit(xs[i, t], ys[i, t], ms[i, t])
            solo[i].fit(xs[i, t], ys[i, t], ms[i, t])
        engine.flush()
    for i in range(n):
        _assert_tree_equal(solo[i].state, gang[i].state, f"member {i}")


def test_capacity_buckets_and_slot_reuse():
    engine = _engine()
    pipes = _pa(5)
    for p in pipes:
        engine.consider(p)
    cohort = pipes[0]._cohort
    assert cohort.capacity == 8  # a power of two
    assert all(t.shape[0] == 8 for t in _leaves(cohort.stacked))
    engine.retire(pipes[1])
    engine.retire(pipes[3])
    assert cohort.n_active == 3
    p6 = _pa(1, 60)[0]
    engine.consider(p6)
    assert cohort.capacity == 8 and p6._slot == 1  # the lowest free slot
    for p in list(cohort.members):
        if p is not None:
            engine.retire(p)
    assert not engine.cohorts  # an empty cohort is dropped


# --- engine rules --------------------------------------------------------------


def test_auto_threshold_and_on():
    engine = _engine(cohort="auto", cohort_min=3)
    pipes = _pa(3)
    engine.consider(pipes[0])
    engine.consider(pipes[1])
    assert pipes[0]._cohort is None  # pooled below the threshold
    engine.consider(pipes[2])
    assert all(p._cohort is not None for p in pipes)
    on = _engine(cohort="on", cohort_min=8)
    lone = _pa(1)[0]
    on.consider(lone)
    assert lone._cohort is not None  # "on": from one pipeline
    off = _engine(cohort="off")
    assert not off.enabled


def test_member_iteration_follows_the_device():
    """The device picks the member iteration: map on the CPU, vmap on the
    card; the JAX package's ``cohort_impl`` is accepted and ignored."""
    assert not CohortEngine(_Cfg(), "cpu").use_vmap
    assert CohortEngine(_Cfg(), "cuda").use_vmap
    assert not CohortEngine(JobConfig(cohort_impl="vmap"), "cpu").use_vmap
    assert CohortEngine(JobConfig(cohort_impl="map"), "cuda").use_vmap


def test_ineligible_learners_stay_solo():
    engine = _engine()
    ht = MLPipeline(LearnerSpec("HT"), dim=DIM, device="cpu")
    km = MLPipeline(LearnerSpec("K-means", hyper_parameters={"k": 2}), dim=DIM, device="cpu")
    sparse = MLPipeline(LearnerSpec("PA", data_structure={"sparse": True, "nFeatures": 20,
                                                          "maxNnz": 4}), dim=20, device="cpu")
    for p in (ht, km, sparse):
        engine.consider(p)
        assert p._cohort is None
    assert not engine.cohorts


def test_cohort_keys_split_specs():
    """Different hyper-parameters, dims or per-record modes never share a
    cohort (the JAX cache key's fields)."""
    engine = _engine()
    a = MLPipeline(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=DIM, device="cpu")
    b = MLPipeline(LearnerSpec("PA", hyper_parameters={"C": 0.5}), dim=DIM, device="cpu")
    c = MLPipeline(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=DIM + 1, device="cpu")
    d = MLPipeline(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=DIM, per_record=True,
                   device="cpu")
    for p in (a, b, c, d):
        engine.consider(p)
    assert len({id(p._cohort) for p in (a, b, c, d)}) == 4


def test_cohort_shards(monkeypatch):
    """A cohort_shards that resolves to one device is the single-device
    path; more than one card raises until the port places cohorts on
    several devices."""
    assert resolve_cohort_shards(_Cfg(cohort_shards="auto"), "cpu") == 1
    assert resolve_cohort_shards(_Cfg(cohort_shards="4"), "cpu") == 1
    assert resolve_cohort_shards(_Cfg(cohort_shards="bogus"), "cuda") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_cohort_shards(_Cfg(cohort_shards="auto"), "cuda") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="cohort_shards"):
        resolve_cohort_shards(_Cfg(cohort_shards="auto"), "cuda")
    assert resolve_cohort_shards(_Cfg(cohort_shards="off"), "cuda") == 1


# --- flat matrix, checkouts, deferred actions --------------------------------


@pytest.mark.parametrize("impl", ["map", "vmap"])
def test_flat_roundtrip_and_writes(impl):
    """member_flat reads the one [C, P] matrix; set_flat_params writes land
    in the state the next fit consumes, as on solo pipelines."""
    pipes = _pa(4)
    engine = _engine(impl=impl)
    for p in pipes:
        engine.consider(p)
    cohort = pipes[0]._cohort
    new = [np.arange(DIM + 1, dtype=np.float32) * (i + 1) * 0.1 for i in range(4)]
    for p, r in zip(pipes, new):
        p.set_flat_params(r)
    for p, r in zip(pipes, new):
        np.testing.assert_array_equal(_flat(p), r)
    assert cohort.flat_matrix(0).shape == (4, DIM + 1)
    xs, ys, ms = _batches(4, 1, 16)
    for i, p in enumerate(pipes):
        p.fit(xs[i, 0], ys[i, 0], ms[i, 0])
    engine.flush()
    solo = _pa(4)
    for i, p in enumerate(solo):
        p.set_flat_params(new[i])
        p.fit(xs[i, 0], ys[i, 0], ms[i, 0])
        np.testing.assert_allclose(_flat(p), _flat(pipes[i]), rtol=RTOL, atol=ATOL)
        if impl == "map":
            np.testing.assert_array_equal(_flat(p), _flat(pipes[i]))


def test_state_checkout_edits_land():
    """In-place edits of ``pipeline.state`` (a SingleLearner hub's model
    swap, merge_from) reach the stacked tree; the sibling is untouched."""
    pipes = _pa(2)
    engine = _engine()
    for p in pipes:
        engine.consider(p)
    xs, ys, ms = _batches(2, 1, 16)
    for i, p in enumerate(pipes):
        p.fit(xs[i, 0], ys[i, 0], ms[i, 0])
    engine.flush()
    sib = _flat(pipes[1])
    st = pipes[0].state
    st["params"] = {"w": st["params"]["w"] * 0.0}
    np.testing.assert_array_equal(_flat(pipes[0]), np.zeros(DIM + 1, np.float32))
    np.testing.assert_array_equal(_flat(pipes[1]), sib)
    assert np.any(sib != 0.0)


def test_deferred_action_runs_after_the_launch():
    pipes = _pa(2)
    engine = _engine()
    for p in pipes:
        engine.consider(p)
    seen = []
    assert not pipes[0].defer_after_launch(lambda: seen.append("now"))  # nothing staged
    xs, ys, ms = _batches(2, 1, 16)
    pipes[0].fit(xs[0, 0], ys[0, 0], ms[0, 0])
    assert pipes[0].defer_after_launch(lambda: seen.append(_flat(pipes[0])))
    assert not seen
    pipes[0].settle_deferred()
    assert len(seen) == 1 and np.any(seen[0] != 0.0)


def test_stage_depth_forces_a_launch():
    pipes = _pa(1)
    engine = _engine()
    engine.consider(pipes[0])
    cohort = pipes[0]._cohort
    xs, ys, ms = _batches(1, cohort_mod.MAX_STAGE_DEPTH + 1, 4)
    for t in range(cohort_mod.MAX_STAGE_DEPTH + 1):
        pipes[0].fit(xs[0, t], ys[0, t], ms[0, t])
    assert cohort._counts == {0: 1}  # the 33rd step opened a new group


@pytest.mark.parametrize("impl", ["map", "vmap"])
def test_predict_rows_matches_member_predicts(impl):
    jp = _jax_pipes("MultiClassPA", {"C": 1.0, "nClasses": 3}, False, 3)
    pipes = _port_pipes(jp, "MultiClassPA", {"C": 1.0, "nClasses": 3}, False)
    engine = _engine(impl=impl)
    for p in pipes:
        engine.consider(p)
    xs, ys, ms = _batches(3, 1, 16)
    ys = (np.abs(xs[..., 0]) * 2).astype(np.int64).clip(0, 2).astype(np.float32)
    for i, p in enumerate(pipes):
        p.fit(xs[i, 0], ys[i, 0], ms[i, 0])
    xq = np.random.RandomState(3).randn(3, 16, DIM).astype(np.float32)
    cohort = pipes[0]._cohort
    out = cohort.predict_rows([(p._slot, xq[i]) for i, p in enumerate(pipes)])
    assert out.shape == (cohort.capacity, 16)
    for i, p in enumerate(pipes):
        np.testing.assert_array_equal(out[p._slot], p.predict(xq[i]).numpy())


def test_gang_averager_equals_the_per_hub_mean():
    class Node:
        def __init__(self):
            self.got = None

        def _finish_round(self, avg):
            self.got = avg

    rng = np.random.RandomState(0)
    mats = [rng.randn(3, 11).astype(np.float32) for _ in range(4)] + [
        rng.randn(2, 5).astype(np.float32)]
    nodes = [Node() for _ in mats]
    gang = GangAverager()
    assert not gang.active
    with gang.window():
        with gang.window():
            for node, mat in zip(nodes, mats):
                gang.stage(node, mat)
        assert gang.active and all(n.got is None for n in nodes)  # the outer exit flushes
    for node, mat in zip(nodes, mats):
        np.testing.assert_array_equal(node.got, mat.mean(axis=0))


# --- the multi-tenant StreamJob against the JAX job with cohorts off ---------

N_NETS, PAR, BATCH, TEST_SET = 8, 2, 16, 16
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}


def _mt_events(serving, n=900, seed=4):
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    events = []
    for pid in range(N_NETS):
        tc = {"protocol": "Synchronous", "syncEvery": 2}
        if serving:
            tc["serving"] = {"maxBatch": 8, "maxDelayMs": 1e6}
        events.append(("requests", json.dumps({
            "id": pid, "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 0.5},
                        "dataStructure": {"nFeatures": DIM}},
            "trainingConfiguration": tc,
        })))
    for i in range(n):
        x = np.round(rng.randn(DIM), 5)
        if i % 10 == 9:
            events.append(("forecastingData", json.dumps({"numericalFeatures": x.tolist()})))
        else:
            events.append(("trainingData", json.dumps(
                {"numericalFeatures": x.tolist(), "target": float(x @ w > 0)})))
        if i == n - 40:
            events.append(("requests", json.dumps({"id": 3, "request": "Query",
                                                   "requestId": 7})))
    return events


def _assert_stats_close(ts, js, skip=()):
    """Every statistic of the port's report against the JAX one:
    integers equal, floats within 1e-4, the score within one holdout row."""
    for key, jv in js.items():
        tv = ts[key]
        if key in WALL_CLOCK_FIELDS or key in skip:
            continue
        if key == "score":
            assert abs(tv - jv) <= 1.0 / TEST_SET + 1e-9, key
        elif isinstance(jv, list):
            assert len(tv) == len(jv), key
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=key)
        elif isinstance(jv, float):
            assert abs(tv - jv) <= 1e-4, (key, tv, jv)
        else:
            assert tv == jv, (key, tv, jv)


_JAX_RUNS = {}


def _jax_run(serving, cohort):
    """The JAX job on the same events (cached: both impls compare to it)."""
    key = (serving, cohort)
    if key not in _JAX_RUNS:
        job = JaxStreamJob(JaxJobConfig(parallelism=PAR, batch_size=BATCH,
                                        test_set_size=TEST_SET, cohort=cohort))
        report = job.run(_mt_events(serving))
        _JAX_RUNS[key] = (
            [(p.mlp_id, p.value) for p in job.predictions], job.responses,
            {s.pipeline: s.to_dict() for s in report.statistics},
        )
    return _JAX_RUNS[key]


@pytest.mark.parametrize("impl", ["map", "vmap"])
@pytest.mark.parametrize("serving", [False, True], ids=["unarmed", "serving"])
def test_multi_tenant_job_matches_jax(serving, impl):
    """Eight same-spec Creates at parallelism 2 form one cohort a spoke
    (the default ``auto`` threshold); one gang launch carries all eight.

    Against the JAX job with cohorts OFF: each net's predictions, in its
    stream order, and the statistics of every net the mid-stream Query
    did not touch. (With cohorts off, a hub reply pauses the spoke's other
    nets -- the cooperative toggle -- and an attached net is exempt, so the
    Query, which flushes its net's batch, lands at another point of that
    net's stream: its learning curve moves, in the JAX package as well.)
    Against the JAX job with its default cohorts (``auto``, which gangs the
    same nets): the predictions in emission order, the Query response and
    every statistic. programLaunches sums below the cohort-off job's (gang
    launches are shared; a gang launch counts on one of its members) and
    is at most the JAX cohort job's: the port reads the flat parameters
    once fewer at a sync point (ROADMAP "Known differences")."""
    events = _mt_events(serving)
    job = _job_impl(StreamJob(JobConfig(parallelism=PAR, batch_size=BATCH,
                                        test_set_size=TEST_SET), device="cpu"), impl)
    for stream, payload in events[:N_NETS]:
        job.process_event(stream, payload)
    for spoke in job.spokes:
        [cohort] = spoke.cohorts.cohorts.values()
        assert cohort.n_active == N_NETS and cohort.use_vmap == (impl == "vmap")
    launches = []
    real_launch = Cohort._run_staged

    def counted(self):
        launches.append(len(self._counts))
        real_launch(self)

    Cohort._run_staged = counted
    try:
        report = job.run(events[N_NETS:])
    finally:
        Cohort._run_staged = real_launch
    assert max(launches) == N_NETS  # a gang launch carried every member
    tp = [(p.mlp_id, p.value) for p in job.predictions]
    ts = {s.pipeline: s.to_dict() for s in report.statistics}
    assert set(ts) == set(range(N_NETS))

    off_preds, _, off_stats = _jax_run(serving, "off")
    for pid in range(N_NETS):
        np.testing.assert_allclose([v for i, v in tp if i == pid],
                                   [v for i, v in off_preds if i == pid], rtol=0, atol=1e-6)
        assert ts[pid]["programLaunches"] > 0
        if pid != 3:
            _assert_stats_close(ts[pid], off_stats[pid], skip=("programLaunches",))

    assert (sum(t["programLaunches"] for t in ts.values())
            < sum(o["programLaunches"] for o in off_stats.values()))

    auto_preds, [jr], auto_stats = _jax_run(serving, "auto")
    if serving:  # emission order moves across workers (ROADMAP): per net
        tp, auto_preds = sorted(tp, key=lambda t: t[0]), sorted(auto_preds, key=lambda t: t[0])
    assert [i for i, _ in tp] == [i for i, _ in auto_preds]
    np.testing.assert_allclose([v for _, v in tp], [v for _, v in auto_preds], rtol=0, atol=1e-6)
    [tr] = job.responses
    assert tr.data_fitted == jr.data_fitted
    np.testing.assert_allclose(tr.learner["parameters"]["values"],
                               jr.learner["parameters"]["values"], rtol=RTOL, atol=ATOL)
    for pid in range(N_NETS):
        assert ts[pid]["programLaunches"] <= auto_stats[pid]["programLaunches"]
        _assert_stats_close(ts[pid], auto_stats[pid], skip=("programLaunches",))


def _frames() -> int:
    f, n = sys._getframe(), 0
    while f is not None:
        n, f = n + 1, f.f_back
    return n


def test_cohort_off_toggle_nesting_fits_the_stack():
    """With cohorts off, a hub reply toggles the spoke's other nets, and a
    resumed net's drained block reaches its sync point, whose reply resumes
    the next: the nesting grows about 18 Python frames a net (the JAX
    package stops with RecursionError at 64 such nets). The job raises the
    interpreter's recursion limit with the nets it hosts while it handles
    an event, and restores it: 24 nets finish under a limit 300 frames
    above the caller, where the nesting needs more."""
    rng = np.random.RandomState(2)
    w = np.random.RandomState(4).randn(DIM)
    x = rng.randn(3000, DIM).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    op = np.zeros((3000,), np.uint8)
    op[::10] = 1
    job = StreamJob(JobConfig(parallelism=2, batch_size=64, test_set_size=16, cohort="off"),
                    device="cpu")
    for pid in range(24):
        job.process_event("requests", json.dumps({
            "id": pid, "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 0.01, "variant": "PA-I"},
                        "dataStructure": {"nFeatures": DIM}},
            "trainingConfiguration": {"protocol": "Synchronous", "perRecord": True},
        }))
    deepest = [0]
    real = Spoke.receive_from_hub

    def spy(self, *a, **k):
        deepest[0] = max(deepest[0], _frames())
        return real(self, *a, **k)

    old = sys.getrecursionlimit()
    base = _frames()
    Spoke.receive_from_hub = spy
    sys.setrecursionlimit(base + 300)
    try:
        for i in range(0, 3000, 1000):
            job.process_packed_batch(x[i:i + 1000], y[i:i + 1000], op[i:i + 1000])
        report = job.terminate()
        assert sys.getrecursionlimit() == base + 300  # restored after each event
    finally:
        sys.setrecursionlimit(old)
        Spoke.receive_from_hub = real
    assert deepest[0] - base > 300  # the nesting passed the caller's limit
    assert len(report.statistics) == 24 and all(s.fitted > 0 for s in report.statistics)
    assert len(job.predictions) == 300 * 24
