"""SLO budgets and the evaluator the load harness gates on.

Counterpart of ``omldm_tpu/runtime/slo.py``: a copy, byte for byte in
what it generates and reports (the port never imports the JAX package).

Asserts service-level budgets from the artifacts the runtime already
produces -- merged job reports (api/stats.JobStatistics dicts), prediction
output files, terminate-time queue accounting, and flight-recorder
journals/bundles (runtime/events.py) -- never from bespoke counters wired
into the hot path. Six gates, each with a machine-readable reason code:

========================  ==============================================
``P99_BUDGET``            serve p99 over budget (measured -- wall clock)
``HEALTHY_LOSS``          a healthy tenant produced fewer forecasts than
                          the storm's exact accounting demands
``DUPLICATE_OUTPUT``      any tenant produced MORE outputs than expected
                          (exactly-once across restarts violated), or
                          outputs appeared for a tenant that never
                          existed
``STRANDED_ROWS``         pause-buffer/serving-queue rows left behind at
                          terminate
``HEAL_TIMEOUT``          a supervised restart took longer than the
                          heal-after-fault budget (measured), or fewer
                          heals happened than the fault storm scheduled
``SHED_SCOPE``            shed charged to a tenant outside the allowed
                          over-limit set
========================  ==============================================

Reports split into a **deterministic core** (count-derived verdicts,
expected/actual tallies, the storm fingerprint -- byte-identical across
replays of the same seed, the thing the reproducibility gate hashes) and
a **measured** section (wall-clock latencies and heal times plus their
verdicts -- real but run-dependent). The overall ``passed`` flag covers
both. No reference counterpart: the reference has no tests and no SLO
machinery at all (PAPER.md §0).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

# reason codes (stable, machine-readable; CI greps these)
P99_BUDGET = "P99_BUDGET"
HEALTHY_LOSS = "HEALTHY_LOSS"
DUPLICATE_OUTPUT = "DUPLICATE_OUTPUT"
STRANDED_ROWS = "STRANDED_ROWS"
HEAL_TIMEOUT = "HEAL_TIMEOUT"
SHED_SCOPE = "SHED_SCOPE"

# how many offending tenants a breach detail lists before truncating
# (the full count always rides in the detail's "offenders" tally)
_DETAIL_CAP = 8


@dataclasses.dataclass
class SLOBudgets:
    """The budget knobs. ``None`` disables a gate entirely (e.g. p99 on
    a 1-core CI host where throughput gates only report)."""

    # serve p99 ceiling, ms (measured gate)
    serve_p99_ms: Optional[float] = None
    # wall-time ceiling for one supervised heal: RESTART decision ->
    # first event from the relaunched fleet (measured gate)
    heal_after_fault_s: Optional[float] = None
    # restarts the fault storm scheduled; fewer observed heals = breach
    # (a fault that never fired proves nothing)
    expected_heals: int = 0
    # tenants allowed to carry shed (the storm's over-limit set); any
    # other tenant shedding is a scope breach. None disables the gate.
    allow_shed_tenants: Optional[Sequence[int]] = None
    # stranded-row ceiling at terminate (0 = nothing may remain)
    max_stranded_rows: int = 0

    def to_dict(self) -> dict:
        return {
            "serveP99Ms": self.serve_p99_ms,
            "healAfterFaultS": self.heal_after_fault_s,
            "expectedHeals": self.expected_heals,
            "allowShedTenants": (
                sorted(self.allow_shed_tenants)
                if self.allow_shed_tenants is not None
                else None
            ),
            "maxStrandedRows": self.max_stranded_rows,
        }


@dataclasses.dataclass
class SLOCheck:
    """One gate's verdict: pass/fail + reason code + detail payload.
    ``measured`` marks wall-clock-derived gates, excluded from the
    deterministic core."""

    name: str
    ok: bool
    reason: str
    detail: dict
    measured: bool = False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "reason": self.reason,
            "detail": self.detail,
            "measured": self.measured,
        }


@dataclasses.dataclass
class SLOReport:
    """The harness' verdict sheet. ``fingerprint`` is the storm's byte
    stream identity; ``core_digest()`` hashes the deterministic core so
    a replay gate is one string comparison."""

    checks: List[SLOCheck]
    fingerprint: str = ""
    seed: Optional[int] = None
    scenario: Optional[dict] = None

    @property
    def passed(self) -> bool:
        return all(c.ok for c in self.checks)

    def failing(self) -> List[SLOCheck]:
        return [c for c in self.checks if not c.ok]

    def deterministic_core(self) -> dict:
        """Replay-identical subset: count-derived verdicts + identity."""
        return {
            "fingerprint": self.fingerprint,
            "seed": self.seed,
            "scenario": self.scenario,
            "checks": [
                c.to_dict() for c in self.checks if not c.measured
            ],
        }

    def core_digest(self) -> str:
        return hashlib.sha256(
            json.dumps(self.deterministic_core(), sort_keys=True).encode()
        ).hexdigest()

    def to_dict(self) -> dict:
        return {
            "passed": self.passed,
            "deterministic": self.deterministic_core(),
            "coreDigest": self.core_digest(),
            "measured": [
                c.to_dict() for c in self.checks if c.measured
            ],
        }


# --- artifact extraction -------------------------------------------------


def count_prediction_lines(lines: Iterable[str]) -> Dict[int, int]:
    """Per-tenant output tally from prediction JSONL (``{"mlpId": id,
    "value": v}``)."""
    counts: Dict[int, int] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        t = int(obj["mlpId"])
        counts[t] = counts.get(t, 0) + 1
    return counts


def count_prediction_files(paths: Sequence[str]) -> Dict[int, int]:
    """Union tally over per-process prediction files (``.pN`` suffixed on
    multi-process runs; restarts truncate-rewrite, so the files ARE the
    exactly-once evidence)."""
    counts: Dict[int, int] = {}
    for path in paths:
        with open(path) as f:
            for t, n in count_prediction_lines(f).items():
                counts[t] = counts.get(t, 0) + n
    return counts


def p99_from_report(report: Mapping) -> Optional[float]:
    """Worst per-pipeline serve p99 in a merged job report, or None when
    no pipeline measured one."""
    worst: Optional[float] = None
    for entry in report.get("statistics") or []:
        v = entry.get("serveLatencyP99Ms")
        if v is None or v <= 0:
            continue
        worst = v if worst is None else max(worst, v)
    return worst


def shed_from_report(report: Mapping) -> Dict[int, int]:
    """Per-tenant shed tally from the merged report's statistics rows."""
    out: Dict[int, int] = {}
    for entry in report.get("statistics") or []:
        shed = int(entry.get("forecastsShed") or 0)
        if shed > 0:
            out[int(entry.get("pipeline", -1))] = shed
    return out


def stranded_from_report(report: Mapping) -> Optional[int]:
    """Stranded rows at terminate: the distributed engine's
    ``terminateAccounting.backlogRows``, or the in-process engine's
    queue-depth snapshot (serving + batcher + paused + throttled +
    pre_create + backlog) -- pressure_level is a level, not a row count,
    and is excluded."""
    acct = report.get("terminateAccounting")
    if acct is None:
        return None
    if "backlogRows" in acct:
        return int(acct["backlogRows"])
    return sum(
        int(acct.get(k, 0))
        for k in (
            "serving", "batcher", "throttled", "paused", "pre_create",
            "backlog",
        )
    )


def heal_times_from_events(events: Sequence[Mapping]) -> List[float]:
    """Heal-after-fault wall times from a merged flight-recorder
    timeline: each supervisor RESTART decision (pid="sup") to the
    relaunched fleet's first recorded breath -- a supervisor HEAL event
    (first heartbeat of the new incarnation) or, failing that, the first
    subsequent event from any worker (pid != "sup")."""
    out: List[float] = []
    restart_at: Optional[float] = None
    for ev in events:
        pid = ev.get("pid")
        if pid == "sup" and ev.get("kind") == "restart":
            # a later restart before any worker spoke supersedes: the
            # heal we time is decision -> the fleet that actually rose
            restart_at = float(ev.get("wall", 0.0))
        elif restart_at is not None and (
            pid != "sup" or ev.get("kind") == "heal"
        ):
            out.append(max(float(ev.get("wall", 0.0)) - restart_at, 0.0))
            restart_at = None
    return out


def load_bundle_events(bundle_path: str) -> List[Mapping]:
    """The merged fleet timeline from an incident bundle
    (runtime/events.write_bundle JSON)."""
    with open(bundle_path) as f:
        bundle = json.load(f)
    return bundle.get("timeline") or bundle.get("events") or []


# --- the evaluator -------------------------------------------------------


def _offenders(items: List[dict]) -> dict:
    """Detail payload: capped offender list + full tally."""
    return {"offenders": len(items), "first": items[:_DETAIL_CAP]}


def evaluate(
    budgets: SLOBudgets,
    *,
    expected: Mapping[int, int],
    actual: Mapping[int, int],
    healthy: Sequence[int],
    report: Optional[Mapping] = None,
    events: Optional[Sequence[Mapping]] = None,
    stranded_rows: Optional[int] = None,
    shed_by_tenant: Optional[Mapping[int, int]] = None,
    fingerprint: str = "",
    seed: Optional[int] = None,
    scenario: Optional[dict] = None,
) -> SLOReport:
    """Run every armed gate; returns the verdict sheet.

    ``expected`` is the storm's exact per-tenant accounting
    (loadgen.LoadStorm.expected_forecasts), ``actual`` the output tally
    (count_prediction_files), ``healthy`` the zero-loss subjects.
    ``report`` supplies p99/shed/stranded when the dedicated arguments
    are not passed; ``events`` is a merged flight-recorder timeline for
    the heal gate."""
    checks: List[SLOCheck] = []

    # 1. zero healthy-tenant forecast loss (deterministic)
    lost = [
        {
            "tenant": t,
            "expected": int(expected.get(t, 0)),
            "actual": int(actual.get(t, 0)),
        }
        for t in sorted(healthy)
        if actual.get(t, 0) < expected.get(t, 0)
    ]
    checks.append(SLOCheck(
        "healthy_forecast_loss", not lost, HEALTHY_LOSS, _offenders(lost)
    ))

    # 2. exactly-once outputs (deterministic): no tenant over-produces,
    # no output for a tenant the storm never created
    dup = [
        {
            "tenant": int(t),
            "expected": int(expected.get(t, 0)),
            "actual": int(n),
        }
        for t, n in sorted(actual.items())
        if n > expected.get(t, 0)
    ]
    checks.append(SLOCheck(
        "exactly_once_outputs", not dup, DUPLICATE_OUTPUT, _offenders(dup)
    ))

    # 3. stranded rows at terminate (deterministic)
    if stranded_rows is None and report is not None:
        stranded_rows = stranded_from_report(report)
    if stranded_rows is not None:
        ok = stranded_rows <= budgets.max_stranded_rows
        checks.append(SLOCheck(
            "stranded_rows", ok, STRANDED_ROWS,
            {
                "strandedRows": int(stranded_rows),
                "budget": budgets.max_stranded_rows,
            },
        ))

    # 4. bounded shed scoped to over-limit tenants only (deterministic)
    if budgets.allow_shed_tenants is not None:
        if shed_by_tenant is None:
            shed_by_tenant = (
                shed_from_report(report) if report is not None else {}
            )
        allowed = set(budgets.allow_shed_tenants)
        out_of_scope = [
            {"tenant": int(t), "shed": int(n)}
            for t, n in sorted(shed_by_tenant.items())
            if n > 0 and t not in allowed
        ]
        checks.append(SLOCheck(
            "shed_scope", not out_of_scope, SHED_SCOPE,
            _offenders(out_of_scope),
        ))

    # 5. serve p99 within budget (measured)
    if budgets.serve_p99_ms is not None and report is not None:
        p99 = p99_from_report(report)
        ok = p99 is None or p99 <= budgets.serve_p99_ms
        checks.append(SLOCheck(
            "serve_p99", ok, P99_BUDGET,
            {"p99Ms": p99, "budgetMs": budgets.serve_p99_ms},
            measured=True,
        ))

    # 6. heal-after-fault within budget (measured)
    if budgets.heal_after_fault_s is not None and events is not None:
        heals = heal_times_from_events(events)
        slow = [h for h in heals if h > budgets.heal_after_fault_s]
        ok = not slow and len(heals) >= budgets.expected_heals
        checks.append(SLOCheck(
            "heal_after_fault", ok, HEAL_TIMEOUT,
            {
                "heals": len(heals),
                "expectedHeals": budgets.expected_heals,
                "healSeconds": [round(h, 3) for h in heals],
                "budgetS": budgets.heal_after_fault_s,
            },
            measured=True,
        ))

    return SLOReport(
        checks=checks,
        fingerprint=fingerprint,
        seed=seed,
        scenario=scenario,
    )
