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

import json

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


# --- the supervised leg ---------------------------------------------------------
#
# tests/test_load_harness.py's TestSupervisedLeg on the port: the composed
# fault storm (a refused launch, then a mid-stream crash) through the
# supervised fleet, the port's workers on the CPU. The 6-tenant storm runs
# unmarked (the JAX suite marks it slow, and its CI's --slo-smoke gate runs
# it as a hard failure); it runs beside the JAX leg on the same storm, and
# the two report cores are equal. The replay and 2-process cases stay slow,
# as in the JAX suite.


def _supervised_budgets(cls, storm):
    return cls(heal_after_fault_s=120.0,
               # the launch refusal + the crash (which fires again in each
               # fresh incarnation until its record position is past the
               # restore cursor): at least two observed heals
               expected_heals=2, allow_shed_tenants=storm.hot_tenant_ids(),
               max_stranded_rows=0)


def _port_storm(tmp, seed=3, processes=1):
    storm = port_harness.build_composed_storm(seed, tenants=6, records=192, chunk_rows=32,
                                              processes=processes)
    return port_harness.run_supervised_storm(storm, str(tmp), _supervised_budgets(
        SLOBudgets, storm), processes=processes, device="cpu")


def _jax_storm(tmp, seed=3):
    storm = jax_harness.build_composed_storm(seed, tenants=6, records=192, chunk_rows=32,
                                             processes=1)
    return jax_harness.run_supervised_storm(storm, str(tmp), _supervised_budgets(
        JaxSLOBudgets, storm), processes=1)


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    import concurrent.futures

    tmp = tmp_path_factory.mktemp("supervised_storm")
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        port_f = pool.submit(_port_storm, tmp / "port")
        jax_f = pool.submit(_jax_storm, tmp / "jax")
        return {"port": port_f.result(), "jax": jax_f.result(), "dir": tmp / "port"}


def test_composed_fault_storm_passes_slo(supervised):
    report, merged, stderr = supervised["port"]
    storm = port_harness.build_composed_storm(3, tenants=6, records=192, chunk_rows=32,
                                              processes=1)
    assert {f.kind for f in storm.spec.faults} == {"launch", "crash"}
    assert report.passed, [c.to_dict() for c in report.failing()]
    # restarts really happened (the faults fired)
    assert merged is not None
    assert "refused launch" in stderr and "injected crash" in stderr
    heal = next(c for c in report.checks if c.name == "heal_after_fault")
    assert heal.detail["heals"] >= 2
    # every forecast answered exactly once across the incarnations
    assert {c.name: c.ok for c in report.checks}["exactly_once_outputs"]


def test_supervised_core_digest_equals_jax(supervised):
    report, merged, _ = supervised["port"]
    jreport, jmerged, _ = supervised["jax"]
    assert jreport.passed
    assert report.core_digest() == jreport.core_digest()
    assert report.to_dict()["deterministic"] == jreport.to_dict()["deterministic"]
    for key in ("fitted", "numOfBlocks", "modelsShipped", "bytesShipped"):
        assert ([s[key] for s in merged["statistics"]]
                == [s[key] for s in jmerged["statistics"]]), key


def test_supervised_worker_command_names_the_port(tmp_path):
    storm = port_harness.build_composed_storm(3, tenants=6, records=64, chunk_rows=32,
                                              processes=2)
    cmd = port_harness.supervised_storm_argv(storm, str(tmp_path), processes=2, device="cpu")
    assert cmd[1:3] == ["-m", "omldm_tpu_torch.runtime.distributed_job"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--processes") + 1] == "2"
    assert "--supervise" in cmd and not any(a.startswith("omldm_tpu.") for a in cmd)
    # the card unless the caller asks for the CPU: no --device by default
    assert "--device" not in port_harness.supervised_storm_argv(storm, str(tmp_path))


def test_harness_cli_gates_on_the_report(supervised, monkeypatch, tmp_path, capsys):
    """``python -m omldm_tpu_torch.load_harness``: the composed storm's
    budgets, the report as JSON, exit 0 when it passes and 1 when not."""
    seen = {}

    def fake(storm, out_dir, budgets, processes, device):
        seen.update(out_dir=out_dir, budgets=budgets, processes=processes, device=device,
                    tenants=storm.spec.tenants)
        return supervised["port"]

    monkeypatch.setattr(port_harness, "run_supervised_storm", fake)
    assert port_harness.main(["--tenants", "6", "--records", "192", "--chunk-rows", "32",
                              "--seed", "3", "--out", str(tmp_path), "--device", "cpu",
                              "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["passed"] and out["coreDigest"] == supervised["port"][0].core_digest()
    assert seen["device"] == "cpu" and seen["tenants"] == 6
    assert seen["budgets"].expected_heals == 2 and seen["budgets"].max_stranded_rows == 0


@pytest.mark.slow
def test_supervised_replay_identical_core(supervised, tmp_path):
    report, _, _ = _port_storm(tmp_path / "b")
    assert report.passed
    assert report.core_digest() == supervised["port"][0].core_digest()


@pytest.mark.slow
def test_two_process_storm_passes_slo(tmp_path):
    report, merged, _ = _port_storm(tmp_path, seed=9, processes=2)
    assert report.passed, [c.to_dict() for c in report.failing()]
    assert merged["fleetProcesses"] == 2
