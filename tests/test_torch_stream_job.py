"""The whole slice: the same JSON event stream through the JAX StreamJob and
the port's StreamJob(device="cpu") -- Create (StandardScaler -> PA-I,
Asynchronous), training records with 10% forecasts, a Query mid-stream,
termination.

Tolerances: a PA prediction is a sign, and float32 reductions summed in
another order can flip a margin that sits near zero, so at least 99% of
predictions must be equal (the mismatch count is reported). Query
parameters within rtol=2e-4, atol=2e-5. Every integer field of the final
JobStatistics equal; float fields within 1e-4, except the holdout accuracy
``score``, which may differ by one holdout row (1/testSetSize) for the same
reason; wall-clock fields are excluded by name."""

import json

import numpy as np
import pytest

from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob

DIM, BATCH, N_TRAIN, TEST_SET = 8, 16, 1200, 256
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}


def make_events(per_record, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    hp = {"C": 0.01, "variant": "PA-I"}
    if per_record:
        hp["usePallas"] = True  # the JAX side runs its kernel in interpret mode
    events = [("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": hp},
        "preProcessors": [{"name": "StandardScaler"}],
        "trainingConfiguration": {"protocol": "Asynchronous", "perRecord": per_record},
    }))]
    for i in range(N_TRAIN):
        x = rng.randn(DIM) * 2.0 + 1.0
        y = float((x - 1.0) @ w + 0.3 * rng.randn() > 0)
        events.append(("trainingData", json.dumps(
            {"numericalFeatures": np.round(x, 6).tolist(), "target": y}
        )))
        if i % 9 == 8:
            xf = rng.randn(DIM) * 2.0 + 1.0
            events.append(("forecastingData", json.dumps(
                {"numericalFeatures": np.round(xf, 6).tolist()}
            )))
        if i == N_TRAIN // 2:
            events.append(("requests", json.dumps(
                {"id": 0, "request": "Query", "requestId": 7}
            )))
    return events


@pytest.mark.parametrize("per_record", [True, False])
@pytest.mark.parametrize("parallelism", [2, 3])
def test_stream_job_matches_jax(parallelism, per_record):
    events = make_events(per_record, seed=parallelism)
    n_forecasts = sum(1 for s, _ in events if s == "forecastingData")
    jax_job = JaxStreamJob(JaxJobConfig(
        parallelism=parallelism, batch_size=BATCH, test_set_size=TEST_SET
    ))
    jax_report = jax_job.run(events)
    job = StreamJob(
        JobConfig(parallelism=parallelism, batch_size=BATCH, test_set_size=TEST_SET),
        device="cpu",
    )
    report = job.run(events)

    # predictions: one per forecasting record, >= 99% equal
    jp = np.array([p.value for p in jax_job.predictions])
    tp = np.array([p.value for p in job.predictions])
    assert len(tp) == len(jp) == n_forecasts
    mismatches = int((tp != jp).sum())
    print(f"prediction mismatches: {mismatches}/{len(tp)}")
    assert mismatches <= 0.01 * len(tp)

    # the mid-stream Query
    [jr] = jax_job.responses
    [tr] = job.responses
    assert tr.response_id == jr.response_id == 7
    assert tr.data_fitted == jr.data_fitted
    assert tr.protocol == jr.protocol == "Asynchronous"
    assert tr.preprocessors == jr.preprocessors
    np.testing.assert_allclose(
        tr.learner["parameters"]["values"], jr.learner["parameters"]["values"],
        rtol=2e-4, atol=2e-5,
    )
    assert abs(tr.loss - jr.loss) <= 1e-4
    assert abs(tr.score - jr.score) <= 1.0 / TEST_SET + 1e-9

    # the final JobStatistics
    assert report.parallelism == jax_report.parallelism
    assert report.job_name == jax_report.job_name
    [ts] = report.statistics
    [js] = jax_report.statistics
    td, jd = ts.to_dict(), js.to_dict()
    assert set(td) == set(jd)
    assert td["fitted"] > 0 and td["forecastsServed"] == n_forecasts
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
