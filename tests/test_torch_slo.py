"""The port's SLO evaluator (omldm_tpu_torch/runtime/slo.py) against the JAX
package's on the same inputs.

Each case of tests/test_slo.py -- the clean baseline, every breach
(HEALTHY_LOSS, DUPLICATE_OUTPUT, STRANDED_ROWS, SHED_SCOPE, HEAL_TIMEOUT,
P99_BUDGET), the capped offender list, the measured/deterministic split --
runs through both ``evaluate``s; the report dicts (every check, its
verdict, reason code and detail, the deterministic core and its digest)
must be equal exactly: the evaluator does integer tallies and one rounding
in the same order, so the tolerance is zero. The artifact readers and the
heal-time extraction give equal results on the same artifacts."""

import json

import pytest

import omldm_tpu.runtime.slo as jax_slo
import omldm_tpu_torch.runtime.slo as port_slo

EXPECTED = {0: 10, 1: 10, 2: 5}
ACTUAL = {0: 10, 1: 10, 2: 5}
HEALTHY = [0, 1]
RESTART_HEAL = [{"pid": "sup", "kind": "restart", "wall": 100.0},
                {"pid": "sup", "kind": "heal", "wall": 105.0}]

# (case, budgets kwargs, evaluate overrides)
CASES = [
    ("baseline", {}, {}),
    ("other_fingerprint", {}, dict(fingerprint="0" * 64)),
    ("healthy_loss", {}, dict(actual={0: 9, 1: 10, 2: 5})),
    ("unhealthy_loss_passes", {}, dict(actual={0: 10, 1: 10, 2: 3})),
    ("duplicate_output", {}, dict(actual={0: 10, 1: 11, 2: 5})),
    ("unknown_tenant", {}, dict(actual={**ACTUAL, 99: 1})),
    ("stranded_rows", {}, dict(stranded_rows=3)),
    ("stranded_slack", dict(max_stranded_rows=4), dict(stranded_rows=3)),
    ("shed_scope", {}, dict(shed_by_tenant={0: 2})),
    ("shed_inside_scope", {}, dict(shed_by_tenant={2: 100})),
    ("heal_slow", dict(heal_after_fault_s=1.0, expected_heals=1), dict(events=RESTART_HEAL)),
    ("heal_missing", dict(heal_after_fault_s=60.0, expected_heals=2),
     dict(events=[{"pid": "sup", "kind": "restart", "wall": 100.0},
                  {"pid": "sup", "kind": "heal", "wall": 100.5}])),
    ("p99_budget", dict(serve_p99_ms=10.0),
     dict(report={"statistics": [{"pipeline": 0, "serveLatencyP99Ms": 3.0},
                                 {"pipeline": 1, "serveLatencyP99Ms": 25.0}]})),
    ("p99_inside", dict(serve_p99_ms=10.0),
     dict(report={"statistics": [{"pipeline": 0, "serveLatencyP99Ms": 0.5}]})),
    ("offender_cap", {}, dict(expected={t: 1 for t in range(20)},
                              actual={t: 0 for t in range(20)}, healthy=list(range(20)))),
    ("measured_split", dict(serve_p99_ms=10.0, heal_after_fault_s=60.0, expected_heals=0),
     dict(report={"statistics": []}, events=[])),
    ("report_supplies_all",
     dict(serve_p99_ms=5.0),
     dict(stranded_rows=None, shed_by_tenant=None,
          report={"statistics": [{"pipeline": 0, "forecastsShed": 3, "serveLatencyP99Ms": 6.0},
                                 {"pipeline": 2, "forecastsShed": 1}],
                  "terminateAccounting": {"serving": 1, "paused": 2, "pressure_level": 9}})),
    ("no_shed_gate", dict(allow_shed_tenants=None), dict(shed_by_tenant={0: 5})),
    ("scenario", {}, dict(seed=None, scenario={"leg": "inprocess", "armed": True,
                                               "tenants": 3, "records": 64})),
]


def evaluate(mod, budgets_kw, overrides):
    base = dict(expected=dict(EXPECTED), actual=dict(ACTUAL), healthy=list(HEALTHY),
                stranded_rows=0, shed_by_tenant={}, fingerprint="f" * 64, seed=7)
    base.update(overrides)
    kw = dict(allow_shed_tenants=[2], max_stranded_rows=0)
    kw.update(budgets_kw)
    return mod.evaluate(mod.SLOBudgets(**kw), **base)


@pytest.mark.parametrize("case,budgets_kw,overrides", CASES, ids=[c[0] for c in CASES])
def test_evaluate_matches_jax(case, budgets_kw, overrides):
    port = evaluate(port_slo, budgets_kw, overrides)
    ref = evaluate(jax_slo, budgets_kw, overrides)
    assert port.to_dict() == ref.to_dict()
    assert port.core_digest() == ref.core_digest()
    assert [c.to_dict() for c in port.checks] == [c.to_dict() for c in ref.checks]
    assert port.passed == ref.passed
    assert {c.reason for c in port.failing()} == {c.reason for c in ref.failing()}


def test_breaches_fail_with_their_codes():
    """The port flags what the JAX tests pin, case by case."""
    expect = {
        "healthy_loss": {port_slo.HEALTHY_LOSS},
        "duplicate_output": {port_slo.DUPLICATE_OUTPUT},
        "unknown_tenant": {port_slo.DUPLICATE_OUTPUT},
        "stranded_rows": {port_slo.STRANDED_ROWS},
        "shed_scope": {port_slo.SHED_SCOPE},
        "heal_slow": {port_slo.HEAL_TIMEOUT},
        "heal_missing": {port_slo.HEAL_TIMEOUT},
        "p99_budget": {port_slo.P99_BUDGET},
        "offender_cap": {port_slo.HEALTHY_LOSS},
        # the report's rows: p99 6.0 over 5.0, tenant 0 shed outside [2],
        # three rows stranded
        "report_supplies_all": {port_slo.P99_BUDGET, port_slo.SHED_SCOPE,
                                port_slo.STRANDED_ROWS},
    }
    for case, budgets_kw, overrides in CASES:
        rep = evaluate(port_slo, budgets_kw, overrides)
        assert {c.reason for c in rep.failing()} == expect.get(case, set()), case


def test_budgets_to_dict_matches_jax():
    for kw in ({}, dict(serve_p99_ms=3.5, heal_after_fault_s=9.0, expected_heals=2,
                        allow_shed_tenants=[5, 1], max_stranded_rows=2)):
        assert port_slo.SLOBudgets(**kw).to_dict() == jax_slo.SLOBudgets(**kw).to_dict()


def test_prediction_file_tally_matches_jax(tmp_path):
    paths = []
    for k in range(3):
        path = tmp_path / f"preds.jsonl.p{k}"
        path.write_text("\n".join(json.dumps({"mlpId": (i * (k + 1)) % 5, "value": 1.0})
                                  for i in range(17 + k)) + "\n\n")
        paths.append(str(path))
    assert port_slo.count_prediction_files(paths) == jax_slo.count_prediction_files(paths)


@pytest.mark.parametrize("report", [
    {},
    {"statistics": [{"pipeline": 0, "serveLatencyP99Ms": 0.0}, {"pipeline": 1}]},
    {"statistics": [{"pipeline": 0, "serveLatencyP99Ms": 2.0, "forecastsShed": 0},
                    {"pipeline": 1, "serveLatencyP99Ms": 7.0, "forecastsShed": 4}]},
    {"terminateAccounting": {"backlogRows": 2}},
    {"terminateAccounting": {"serving": 1, "paused": 2, "pressure_level": 9}},
])
def test_report_readers_match_jax(report):
    for name in ("p99_from_report", "shed_from_report", "stranded_from_report"):
        assert getattr(port_slo, name)(report) == getattr(jax_slo, name)(report), name


@pytest.mark.parametrize("events", [
    [{"pid": "sup", "kind": "restart", "wall": 10.0}, {"pid": "sup", "kind": "heal", "wall": 11.5},
     {"pid": "sup", "kind": "restart", "wall": 20.0},
     {"pid": "sup", "kind": "heal", "wall": 20.25}],
    [{"pid": "sup", "kind": "restart", "wall": 10.0}, {"pid": 0, "kind": "strike", "wall": 12.0}],
    [{"pid": "sup", "kind": "restart", "wall": 10.0}, {"pid": "sup", "kind": "restart", "wall": 30.0},
     {"pid": "sup", "kind": "heal", "wall": 31.0}],
    [{"pid": "sup", "kind": "restart", "wall": 10.0}, {"pid": "sup", "kind": "rescale", "wall": 11.0},
     {"pid": "sup", "kind": "heal", "wall": 12.0}],
])
def test_heal_times_match_jax(events):
    assert port_slo.heal_times_from_events(events) == jax_slo.heal_times_from_events(events)


def test_bundle_events_match_jax(tmp_path):
    bundle = tmp_path / "incident-1.json"
    bundle.write_text(json.dumps({"timeline": RESTART_HEAL}))
    assert port_slo.load_bundle_events(str(bundle)) == jax_slo.load_bundle_events(str(bundle))
