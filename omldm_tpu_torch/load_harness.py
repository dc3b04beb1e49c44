"""The load harness's in-process leg: seeded storms through the port's
StreamJob with the host planes armed, gated on SLO budgets.

Counterpart of the in-process half of ``benchmarks/load_harness.py``
(its ``:64-230``; the port never imports the JAX package):

- :func:`run_inprocess_storm` -- the in-process StreamJob with the host
  planes armed (cohort, serving, overload, lifecycle, telemetry, flight
  recorder), the storm's churn interleaved at exact record positions;
- :func:`run_composition_identity` -- the same storm through a bare job
  and through every plane configured but unarmed
  (:data:`UNARMED_MATRIX_KW`): equal prediction digests iff the unarmed
  matrix is bit-transparent.

Both evaluate as the JAX harness does: the storm's exact per-tenant
accounting (``runtime.loadgen``) against what the run produced, through
the SLO gates (``runtime.slo``). Replays of one seed give byte-identical
deterministic report cores, and on one storm the card's core equals the
CPU's. Each entry point takes ``device``: CUDA unless the caller asks for
``"cpu"``.

The supervised fleet leg (``run_supervised_storm``,
``build_composed_storm`` and the harness's CLI) drives the multi-process
fleet, which the port does not have yet: it waits for the fleet (ROADMAP
queue 1, item 4).

Use::

    from omldm_tpu_torch.load_harness import default_storm_spec, run_inprocess_storm
    from omldm_tpu_torch.runtime.loadgen import LoadStorm
    from omldm_tpu_torch.runtime.slo import SLOBudgets

    storm = LoadStorm(default_storm_spec())
    report, job = run_inprocess_storm(
        storm, SLOBudgets(allow_shed_tenants=storm.hot_tenant_ids()), device="cpu")
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from omldm_tpu_torch.runtime import slo as slomod
from omldm_tpu_torch.runtime.loadgen import FaultSpec, LoadStorm, StormSpec
from omldm_tpu_torch.runtime.slo import SLOBudgets, SLOReport

# the in-process engine's terminate-time queues a stranded row can sit in
_STRANDED_QUEUES = ("serving", "batcher", "throttled", "paused", "pre_create", "backlog")


def default_storm_spec(
    seed: int = 7,
    tenants: int = 256,
    records: int = 1024,
    chunk_rows: int = 64,
    *,
    faults: Sequence[FaultSpec] = (),
    training_extra: Optional[dict] = None,
    churn: bool = True,
    protocol: str = "CentralizedTraining",
) -> StormSpec:
    """The canonical composed storm: churn waves + diurnal curve +
    hot-tenant bursts + mixed traffic, scaled by tenant/record count."""
    return StormSpec(
        seed=seed,
        tenants=tenants,
        records=records,
        chunk_rows=chunk_rows,
        n_features=4,
        forecast_ratio=0.3,
        diurnal_amplitude=0.5,
        diurnal_period=max(records // 4, 1),
        hot_tenants=min(2, tenants),
        burst_every=max(records // 8, 1),
        burst_len=max(records // 64, 1),
        addressed_fraction=0.1,
        churn_waves=3 if churn else 0,
        churn_tenants_per_wave=4 if churn else 0,
        churn_updates_per_wave=1 if churn else 0,
        protocol=protocol,
        training_extra=dict(training_extra or {}),
        faults=tuple(faults),
    )


# every plane CONFIGURED (objects constructed, code paths installed) in a
# state that must not alter the data path: overload thresholds uniform
# broadcast traffic can never trip, serving at immediate emission
# (maxBatch=1 -- armed batching defers forecasts past training records,
# which legitimately changes values), lifecycle/telemetry/events
# observe-only. The composition-identity leg pins a bare run
# bit-identical to all of this at once.
UNARMED_MATRIX_KW = dict(
    cohort="auto",
    cohort_min=8,
    overload="window=64,share=4,hotHigh=192,hotCritical=512",
    serving="maxBatch=1,maxDelayMs=0",
    lifecycle="on",
    telemetry="statsEvery=256",
    events="cap=256,watchdogEvery=256",
)


def prediction_digest(job) -> Dict[int, list]:
    """Bit-identity evidence: per-tenant ordered (features, value) pairs
    over the complete output stream."""
    out: Dict[int, list] = {}
    for p in job.predictions:
        feats = tuple(p.data_instance.numerical_features)
        out.setdefault(p.mlp_id, []).append((feats, p.value))
    return out


def _drive(storm: LoadStorm, job) -> object:
    """The initial Create wave, then the storm's events (churn interleaved
    at exact record positions), then termination: the job's report."""
    for line in storm.request_lines():
        job.process_event("requests", line)
    for stream, line in storm.events():
        job.process_event(stream, line)
    return job.terminate()


def run_composition_identity(storm: LoadStorm, device=None) -> Tuple[dict, dict]:
    """The full-composition identity leg: the storm through a bare
    StreamJob and through every plane configured-but-unarmed
    (:data:`UNARMED_MATRIX_KW`), both on ``device``. Returns both
    prediction digests -- equal iff the unarmed matrix is
    bit-transparent."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime.job import StreamJob

    digests = []
    for kw in ({}, UNARMED_MATRIX_KW):
        job = StreamJob(JobConfig(batch_size=16, test_set_size=16, **kw), device=device)
        _drive(storm, job)
        digests.append(prediction_digest(job))
    return digests[0], digests[1]


def run_inprocess_storm(
    storm: LoadStorm,
    budgets: Optional[SLOBudgets] = None,
    *,
    armed: bool = True,
    blackbox_dir: Optional[str] = None,
    device=None,
) -> Tuple[SLOReport, object]:
    """Drive the storm through the in-process StreamJob on ``device`` with
    the host planes armed (or, ``armed=False``, with cohorts alone).
    Returns (slo_report, job) -- callers needing raw artifacts read the
    job."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime.job import StreamJob

    spec = storm.spec
    kw: Dict[str, object] = dict(batch_size=32, test_set_size=16, cohort="auto", cohort_min=8)
    if armed:
        kw.update(
            overload="window=64,share=4,hotHigh=192,hotCritical=512",
            serving="maxBatch=32,maxDelayMs=50",
            lifecycle="on",
            telemetry="statsEvery=256",
            events="cap=256,watchdogEvery=256",
        )
        if blackbox_dir:
            kw["blackbox_path"] = blackbox_dir
    job = StreamJob(JobConfig(**kw), device=device)
    job_report = _drive(storm, job)
    actual: Dict[int, int] = {}
    for p in job.predictions:
        actual[p.mlp_id] = actual.get(p.mlp_id, 0) + 1
    report_dict = None
    shed: Dict[int, int] = {}
    if job_report is not None:
        report_dict = {"statistics": [s.to_dict() for s in job_report.statistics]}
        for s in job_report.statistics:
            if s.forecasts_shed:
                shed[s.pipeline] = s.forecasts_shed
    stranded = None
    if job.terminate_accounting is not None:
        stranded = sum(int(job.terminate_accounting.get(k, 0)) for k in _STRANDED_QUEUES)
    slo_report = slomod.evaluate(
        budgets or SLOBudgets(),
        # the in-process engine emits predictions live: outputs of a
        # window an Update closed survive
        expected=storm.expected_forecasts(routed=armed, update_discards=False),
        actual=actual,
        healthy=storm.healthy_tenants(),
        report=report_dict,
        stranded_rows=stranded,
        shed_by_tenant=shed,
        fingerprint=storm.fingerprint(),
        seed=spec.seed,
        scenario={"leg": "inprocess", "armed": armed,
                  "tenants": spec.tenants, "records": spec.records},
    )
    return slo_report, job


__all__ = [
    "UNARMED_MATRIX_KW",
    "default_storm_spec",
    "prediction_digest",
    "run_composition_identity",
    "run_inprocess_storm",
]
