"""All 8 protocols: whole StreamJob runs of the JAX package and of the port
(device="cpu") on the same JSON stream -- dim 6, parallelism 4, batch 32
(tests/test_protocols.py's template), every tenth record a forecast, a
Query near the end, termination.

CentralizedTraining runs at parallelism 1 (the protocol every such Create
is forced onto), SingleLearner with PA, and with K-means and HT (both
forced onto it); NN runs under Synchronous, its optimizer state averaged
with its weights. Where the initial model is a random draw (K-means, NN),
the JAX job's initial parameters are loaded into the port's pipelines,
the hub's included, before the first record.

Tolerances, as tests/test_torch_stream_job.py: every integer field of the
final JobStatistics equal (fitted, bytesShipped, modelsShipped,
numOfBlocks, programLaunches among them); float fields within 1e-4, except
the holdout score, which may differ by one holdout row per worker
(1/testSetSize); at least 99% of predictions equal (a sign, class id or
centroid id can flip where a margin sits at zero); Query parameters within
rtol=2e-4, atol=2e-5.
"""

import json

import jax
import numpy as np
import pytest

from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.pipelines.pipeline import state_from_numpy
from omldm_tpu_torch.runtime import StreamJob

DIM, BATCH, TEST_SET = 6, 32, 32
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}

# (id, protocol, learner, hyper-parameters, data structure, extra config,
# parallelism, records)
CASES = [
    ("async", "Asynchronous", "PA", {"C": 1.0}, {}, {}, 4, 2000),
    ("sync", "Synchronous", "PA", {"C": 1.0}, {}, {}, 4, 2000),
    ("ssp", "SSP", "PA", {"C": 1.0}, {}, {"staleness": 1}, 4, 2000),
    ("easgd", "EASGD", "PA", {"C": 1.0}, {}, {"alpha": 0.2}, 4, 2000),
    ("gm", "GM", "PA", {"C": 1.0}, {}, {"threshold": 0.7}, 4, 2000),
    ("fgm", "FGM", "PA", {"C": 1.0}, {}, {"threshold": 0.7}, 4, 2000),
    ("centralized_par1", "CentralizedTraining", "PA", {"C": 1.0}, {}, {}, 1, 1000),
    ("single_learner_pa", "SingleLearner", "PA", {"C": 1.0}, {}, {}, 4, 2000),
    ("single_learner_kmeans", "Asynchronous", "K-means", {"k": 3}, {}, {}, 4, 1500),
    ("single_learner_ht", "Synchronous", "HT", {"gracePeriod": 50, "delta": 0.05}, {}, {},
     4, 1500),
    ("nn_sync", "Synchronous", "NN", {"learningRate": 0.02}, {"hiddenLayers": [8]}, {}, 4,
     1500),
]
IDS = [c[0] for c in CASES]
EXPECTED_PROTOCOL = {"single_learner_kmeans": "SingleLearner",
                     "single_learner_ht": "SingleLearner"}


def make_events(protocol, learner, hp, ds, extra, n, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    tc = dict({"protocol": protocol, "syncEvery": 2}, **extra)
    events = [("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": learner, "hyperParameters": hp,
                    "dataStructure": dict(ds, nFeatures=DIM)},
        "trainingConfiguration": tc,
    }))]
    for i in range(n):
        x = np.round(rng.randn(DIM), 5)
        events.append(("trainingData", json.dumps(
            {"numericalFeatures": x.tolist(), "target": float(x @ w > 0)})))
        if i % 9 == 8:
            xf = np.round(rng.randn(DIM), 5)
            events.append(("forecastingData", json.dumps({"numericalFeatures": xf.tolist()})))
        if i == n - 50:
            events.append(("requests", json.dumps({"id": 0, "request": "Query", "requestId": 3})))
    return events


def _pipelines(job):
    pipes = [net.pipeline for spoke in job.spokes for net in spoke.nets.values()]
    pipes += [h.node.pipeline for h in job.hub_manager.hubs.values()
              if getattr(h.node, "pipeline", None) is not None]
    return pipes


def run_pair(protocol, learner, hp, ds, extra, parallelism, n):
    events = make_events(protocol, learner, hp, ds, extra, n)
    jax_job = JaxStreamJob(JaxJobConfig(parallelism=parallelism, batch_size=BATCH,
                                        test_set_size=TEST_SET))
    job = StreamJob(JobConfig(parallelism=parallelism, batch_size=BATCH,
                              test_set_size=TEST_SET), device="cpu")
    # the Create names its width, so it deploys before the first record
    jax_job.process_event(*events[0])
    job.process_event(*events[0])
    jpipes, tpipes = _pipelines(jax_job), _pipelines(job)
    assert len(jpipes) == len(tpipes) > 0
    if learner in ("K-means", "NN"):
        for jp, tp in zip(jpipes, tpipes):
            tp.load_state(state_from_numpy(jax.tree_util.tree_map(np.asarray, jp.state), "cpu"))
        for spoke in job.spokes:
            for net in spoke.nets.values():
                net.node.on_model_seeded()
    jax_report = jax_job.run(events[1:])
    report = job.run(events[1:])
    return events, jax_job, jax_report, job, report


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_protocol_stream_matches_jax(case):
    name, protocol, learner, hp, ds, extra, parallelism, n = case
    events, jax_job, jax_report, job, report = run_pair(
        protocol, learner, hp, ds, extra, parallelism, n)
    n_forecasts = sum(1 for s, _ in events if s == "forecastingData")

    jp = np.array([p.value for p in jax_job.predictions])
    tp = np.array([p.value for p in job.predictions])
    assert len(tp) == len(jp) == n_forecasts
    mismatches = int((tp != jp).sum())
    print(f"{name}: prediction mismatches {mismatches}/{len(tp)}")
    assert mismatches <= 0.01 * len(tp)

    [jr] = jax_job.responses
    [tr] = job.responses
    assert tr.data_fitted == jr.data_fitted
    assert tr.protocol == jr.protocol == EXPECTED_PROTOCOL.get(name, protocol)
    jparams = (jr.learner.get("parameters") or {}).get("values")
    tparams = (tr.learner.get("parameters") or {}).get("values")
    assert (tparams is None) == (jparams is None) == (learner == "HT")
    if jparams is not None:
        np.testing.assert_allclose(tparams, jparams, rtol=2e-4, atol=2e-5)

    [ts] = report.statistics
    [js] = jax_report.statistics
    td, jd = ts.to_dict(), js.to_dict()
    assert set(td) == set(jd)
    assert td["fitted"] > 0 and td["protocol"] == jd["protocol"]
    for key, jv in jd.items():
        tv = td[key]
        if key in WALL_CLOCK_FIELDS:
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


def test_protocol_counters_are_live():
    """The comparison above is not vacuous: the safe-zone protocols ran
    rounds, Synchronous shipped a model a worker a round, and
    SingleLearner's hub fitted every batch itself."""
    _, protocol, learner, hp, ds, extra, par, n = CASES[IDS.index("fgm")]
    _, _, _, job, report = run_pair(protocol, learner, hp, ds, extra, par, n)
    fgm = job.hub_manager.hubs[(0, 0)].node
    assert fgm.rounds + fgm.subrounds > 0
    _, protocol, learner, hp, ds, extra, par, n = CASES[IDS.index("gm")]
    _, _, _, job, _ = run_pair(protocol, learner, hp, ds, extra, par, n)
    assert job.hub_manager.hubs[(0, 0)].node.rounds > 0
    _, protocol, learner, hp, ds, extra, par, n = CASES[IDS.index("single_learner_kmeans")]
    _, _, _, job, report = run_pair(protocol, learner, hp, ds, extra, par, n)
    hub = job.hub_manager.hubs[(0, 0)].node
    [stats] = report.statistics
    assert hub.pipeline.fitted == stats.fitted > 0
    assert all(net.pipeline.fitted == 0 for s in job.spokes for net in s.nets.values())


def test_ht_tree_stays_on_the_host():
    """SingleLearner's HT model is the hub pipeline's tree, shared with the
    workers in process: no tensor holds any of it."""
    _, protocol, learner, hp, ds, extra, par, n = CASES[IDS.index("single_learner_ht")]
    _, _, _, job, _ = run_pair(protocol, learner, hp, ds, extra, par, 600)
    hub = job.hub_manager.hubs[(0, 0)].node
    assert hub.pipeline.learner.host_side and hub.pipeline.device.type == "cpu"
    tree = hub.pipeline.state["params"]
    assert all(net.pipeline.state["params"] is tree for s in job.spokes
               for net in s.nets.values())
