"""The load harness's in-process leg in the port
(omldm_tpu_torch/load_harness.py) against the JAX package's
(benchmarks/load_harness.py) on the same storms.

On tests/test_load_harness.py's small composed storm (churn + diurnal +
bursts + addressed traffic through the armed plane matrix), the port's
``run_inprocess_storm(device="cpu")`` must give the JAX leg's per-tenant
forecast counts and shed counts exactly, the same SLO report (every
deterministic check, verdict and detail: equal core digests), and each
tenant's predictions for the same records with >= 99% of values equal (the
streams' rule: a PA prediction is a sign, and float32 sums in another
order can flip a margin near zero; the armed serving plane's wall-clock
deadline may move the interleaving of a tenant's workers, in either
package, so a tenant's answers are matched by record). Its replay gives
an identical core, another seed a different one, and the unarmed plane
matrix is bit-transparent at 256 tenants. Without a device the leg wants CUDA."""

import pytest

from benchmarks import load_harness as jax_harness
from omldm_tpu.runtime.loadgen import LoadStorm as JaxLoadStorm
from omldm_tpu.runtime.slo import SLOBudgets as JaxSLOBudgets
from omldm_tpu_torch import load_harness as port_harness
from omldm_tpu_torch.runtime.loadgen import LoadStorm, StormSpec
from omldm_tpu_torch.runtime.slo import SLOBudgets


def _small(mod_storm, harness, seed=11, **kw):
    spec = harness.default_storm_spec(seed=seed, tenants=6, records=256, chunk_rows=32, **kw)
    return mod_storm(spec)


def _budgets(cls, storm):
    return cls(allow_shed_tenants=storm.hot_tenant_ids(), max_stranded_rows=0)


def _tallies(job):
    counts, shed = {}, {}
    for p in job.predictions:
        counts[p.mlp_id] = counts.get(p.mlp_id, 0) + 1
    report = job.performance[-1]
    for s in report.statistics:
        shed[s.pipeline] = s.forecasts_shed
    return counts, shed


@pytest.mark.parametrize("extra", [{}, {"perRecord": True}], ids=["batched", "perRecord"])
def test_inprocess_leg_matches_jax(extra):
    storm = _small(LoadStorm, port_harness, training_extra=extra)
    jstorm = _small(JaxLoadStorm, jax_harness, training_extra=extra)
    assert storm.fingerprint() == jstorm.fingerprint()
    report, job = port_harness.run_inprocess_storm(storm, _budgets(SLOBudgets, storm),
                                                   device="cpu")
    jreport, jjob = jax_harness.run_inprocess_storm(jstorm, _budgets(JaxSLOBudgets, jstorm))
    assert report.passed, [c.to_dict() for c in report.failing()]
    assert jreport.passed
    assert report.to_dict() == jreport.to_dict()
    assert report.core_digest() == jreport.core_digest()
    assert _tallies(job) == _tallies(jjob)
    # the scheduled churn ran: churned-in tenants answered
    assert any(p.mlp_id >= storm.spec.tenants for p in job.predictions)
    digest = port_harness.prediction_digest(job)
    jdigest = jax_harness.prediction_digest(jjob)
    assert sorted(digest) == sorted(jdigest)
    total = mismatches = 0
    for tenant, rows in digest.items():
        # the armed serving plane flushes on a wall-clock deadline
        # (maxDelayMs 50), so the interleaving of a tenant's workers may
        # move: each tenant's answers are compared record by record
        rows, jrows = sorted(rows), sorted(jdigest[tenant])
        assert [f for f, _ in rows] == [f for f, _ in jrows], tenant
        total += len(rows)
        mismatches += sum(a != b for (_, a), (_, b) in zip(rows, jrows))
    print(f"prediction mismatches: {mismatches}/{total}")
    assert total > 0 and mismatches <= 0.01 * total


def test_replay_identical_core():
    budgets = SLOBudgets(allow_shed_tenants=[], max_stranded_rows=0)
    a, _ = port_harness.run_inprocess_storm(_small(LoadStorm, port_harness), budgets,
                                            device="cpu")
    b, _ = port_harness.run_inprocess_storm(_small(LoadStorm, port_harness), budgets,
                                            device="cpu")
    c, _ = port_harness.run_inprocess_storm(_small(LoadStorm, port_harness, seed=12), budgets,
                                            device="cpu")
    assert a.core_digest() == b.core_digest() != c.core_digest()


def test_unarmed_leg_matches_jax():
    """armed=False (cohorts alone, fan-out accounting) in both packages."""
    storm = _small(LoadStorm, port_harness)
    jstorm = _small(JaxLoadStorm, jax_harness)
    report, job = port_harness.run_inprocess_storm(storm, armed=False, device="cpu")
    jreport, jjob = jax_harness.run_inprocess_storm(jstorm, armed=False)
    assert report.core_digest() == jreport.core_digest()
    assert _tallies(job) == _tallies(jjob)


def test_unarmed_matrix_is_bit_identical_at_256_tenants():
    """Uniform broadcast traffic (no addressing, no bursts): every plane
    configured but unarmed is transparent, bit for bit."""
    storm = LoadStorm(StormSpec(seed=5, tenants=256, records=128, chunk_rows=64,
                                n_features=4, forecast_ratio=0.4))
    bare, composed = port_harness.run_composition_identity(storm, device="cpu")
    assert bare == composed
    assert len(bare) == 256


def test_matrix_and_spec_match_jax():
    assert port_harness.UNARMED_MATRIX_KW == jax_harness.UNARMED_MATRIX_KW
    for kw in ({}, dict(seed=3, tenants=10, records=200, churn=False,
                        training_extra={"perRecord": True}, protocol="Synchronous")):
        assert vars(port_harness.default_storm_spec(**kw)) == \
            vars(jax_harness.default_storm_spec(**kw))


def test_leg_wants_cuda_without_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    storm = _small(LoadStorm, port_harness)
    with pytest.raises(Exception):
        port_harness.run_inprocess_storm(storm)
    with pytest.raises(Exception):
        port_harness.run_composition_identity(storm)
