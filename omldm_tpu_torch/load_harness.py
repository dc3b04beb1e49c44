"""The load harness: seeded storms through the port's planes, gated on SLO
budgets.

Counterpart of ``benchmarks/load_harness.py`` (the port never imports the
JAX package):

- :func:`run_inprocess_storm` -- the in-process StreamJob with the host
  planes armed (cohort, serving, overload, lifecycle, telemetry, flight
  recorder), the storm's churn interleaved at exact record positions;
- :func:`run_composition_identity` -- the same storm through a bare job
  and through every plane configured but unarmed
  (:data:`UNARMED_MATRIX_KW`): equal prediction digests iff the unarmed
  matrix is bit-transparent;
- :func:`run_supervised_storm` -- the supervised fleet (the port's worker
  processes, ``python -m omldm_tpu_torch.runtime.distributed_job`` under
  ``--supervise``) with a composed fault storm (:func:`build_composed_storm`:
  a refused launch, then a mid-stream crash), checkpoint and restore, the
  count-clocked ``--requestSchedule`` churn, flight-recorder incident
  bundles and exactly-once prediction files.

All evaluate as the JAX harness does: the storm's exact per-tenant
accounting (``runtime.loadgen``) against what the run produced, through
the SLO gates (``runtime.slo``). Replays of one seed give byte-identical
deterministic report cores, and on one storm the card's core equals the
CPU's. Each entry point takes ``device``: CUDA unless the caller asks for
``"cpu"`` (the supervised leg's workers then get ``--device cpu``).

Use::

    from omldm_tpu_torch.load_harness import default_storm_spec, run_inprocess_storm
    from omldm_tpu_torch.runtime.loadgen import LoadStorm
    from omldm_tpu_torch.runtime.slo import SLOBudgets

    storm = LoadStorm(default_storm_spec())
    report, job = run_inprocess_storm(
        storm, SLOBudgets(allow_shed_tenants=storm.hot_tenant_ids()), device="cpu")

CLI (the supervised leg on the composed storm)::

    python -m omldm_tpu_torch.load_harness --tenants 16 --records 192 \\
        --chunk-rows 32 --seed 3 --processes 1 --out /tmp/storm [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from omldm_tpu_torch.runtime import slo as slomod
from omldm_tpu_torch.runtime.loadgen import FaultSpec, LoadStorm, StormSpec
from omldm_tpu_torch.runtime.slo import SLOBudgets, SLOReport

# the checkout's root: the supervised leg's workers import the port from it
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


# --- supervised fleet leg ------------------------------------------------


def supervised_storm_argv(storm: LoadStorm, out_dir: str, *, processes: int = 1,
                          restart_attempts: int = 3, checkpoint_every: int = 2,
                          batch_size: int = 32, test_set_size: int = 16,
                          extra_flags: Sequence[str] = (), device=None) -> List[str]:
    """The command of the supervised leg: ``python -m
    omldm_tpu_torch.runtime.distributed_job --supervise true ...`` with the
    storm's files, fault storm and plane arming (the JAX harness's flags),
    and ``--device`` when the caller names one (else the workers' default,
    CUDA)."""
    blackbox = os.path.join(out_dir, "blackbox")
    args = storm.worker_args(out_dir, checkpoint_every=checkpoint_every)
    args += [
        "--supervise", "true",
        "--processes", str(processes),
        "--restartAttempts", str(restart_attempts),
        "--restartDelayMs", "50",
        "--batchSize", str(batch_size),
        "--testSetSize", str(test_set_size),
        "--predictionsOut", os.path.join(out_dir, "preds.jsonl"),
        "--performanceOut", os.path.join(out_dir, "perf.jsonl"),
        "--flightRecorder", "on",
        "--blackboxPath", blackbox,
        # heartbeats let the supervisor stamp a HEAL event at the relaunched
        # fleet's first beat (the heal-after-fault endpoint); the timeout
        # scales with the fleet's size (workers beat mid-deploy)
        "--heartbeatTimeoutMs", str(max(120_000, storm.spec.tenants * 100)),
        # the fleet's plane arming: overload backpressure here; the codec
        # rides the request lines, events and checkpoints above
        "--overload", "window=64,share=4,hotHigh=192,hotCritical=512",
    ]
    if device is not None:
        args += ["--device", str(device)]
    args += list(extra_flags)
    return [sys.executable, "-m", "omldm_tpu_torch.runtime.distributed_job"] + args


def run_supervised_storm(
    storm: LoadStorm,
    out_dir: str,
    budgets: Optional[SLOBudgets] = None,
    *,
    processes: int = 1,
    restart_attempts: int = 3,
    checkpoint_every: int = 2,
    batch_size: int = 32,
    test_set_size: int = 16,
    timeout_s: int = 600,
    extra_flags: Sequence[str] = (),
    env_extra: Optional[Dict[str, str]] = None,
    device=None,
) -> Tuple[SLOReport, Optional[dict], str]:
    """Drive the storm through the supervised fleet on ``device``: worker
    subprocesses with the fault storm armed, checkpoint and restore, the
    count-clocked churn schedule, flight-recorder bundles. Reads what the
    JAX leg reads: the prediction files, the merged report and the last
    incident bundle. Returns (slo_report, merged_job_report, stderr); a
    fleet that does not end 0 raises."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = supervised_storm_argv(
        storm, out_dir, processes=processes, restart_attempts=restart_attempts,
        checkpoint_every=checkpoint_every, batch_size=batch_size,
        test_set_size=test_set_size, extra_flags=extra_flags, device=device)
    env = dict(os.environ)
    env.update(env_extra or {})
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=timeout_s)
    stderr = out.stderr
    if out.returncode != 0:
        raise RuntimeError(f"supervised storm run failed rc={out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{stderr[-4000:]}")
    preds = os.path.join(out_dir, "preds.jsonl")
    perf = os.path.join(out_dir, "perf.jsonl")
    report: Optional[dict] = None
    if os.path.exists(perf):
        with open(perf) as f:
            lines = [line for line in f.read().splitlines() if line.strip()]
        if lines:
            report = json.loads(lines[-1])
    # prediction outputs: the bare path at one process, .p<i> otherwise
    pred_paths = [preds] if os.path.exists(preds) else sorted(glob.glob(preds + ".p*"))
    actual = slomod.count_prediction_files(pred_paths)
    # the last incident bundle carries the merged fleet history
    # (supervisor decisions + worker rings)
    events: List[dict] = []
    bundles = sorted(glob.glob(os.path.join(out_dir, "blackbox", "incident-*.json")),
                     key=lambda p: int(os.path.basename(p).split("-")[1].split(".")[0]))
    if bundles:
        events = slomod.load_bundle_events(bundles[-1])
    slo_report = slomod.evaluate(
        budgets or SLOBudgets(),
        expected=storm.expected_forecasts(routed=False),
        actual=actual,
        healthy=storm.healthy_tenants(),
        report=report,
        events=events,
        fingerprint=storm.fingerprint(),
        seed=storm.spec.seed,
        scenario={"leg": "supervised", "tenants": storm.spec.tenants,
                  "records": storm.spec.records, "processes": processes,
                  "faults": [f.kind for f in storm.spec.faults]},
    )
    return slo_report, report, stderr


def build_composed_storm(seed: int, tenants: int, records: int, chunk_rows: int,
                         processes: int) -> LoadStorm:
    """The acceptance storm: churn + diurnal + bursts + two fault classes (a
    refused launch, then a mid-stream crash), sized so the crash lands past
    the first checkpoint."""
    faults = [
        FaultSpec(kind="launch", process=max(processes - 1, 0), count=1),
        FaultSpec(kind="crash", process=0, at_records=records // 2),
    ]
    spec = default_storm_spec(
        seed=seed, tenants=tenants, records=records, chunk_rows=chunk_rows, faults=faults,
        # the fleet hosts the collective protocols only; CentralizedTraining
        # is the in-process leg's
        protocol="Synchronous",
        training_extra={"syncEvery": 1, "comm": {"codec": "int8"}},
    )
    return LoadStorm(spec)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="The supervised leg of the load harness on "
                                             "the composed fault storm.")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tenants", type=int, default=256)
    ap.add_argument("--records", type=int, default=1024)
    ap.add_argument("--chunk-rows", type=int, default=64)
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--out", default="omldm-storm")
    ap.add_argument("--device", default=None,
                    help="the workers' device (default: the card)")
    ap.add_argument("--heal-budget-s", type=float, default=120.0,
                    help="heal-after-fault wall budget (measured gate)")
    ap.add_argument("--p99-budget-ms", type=float, default=0.0,
                    help="serve p99 budget, 0 disables (measured gate)")
    ap.add_argument("--replay", action="store_true",
                    help="run the storm twice and assert identical report cores")
    ap.add_argument("--json", action="store_true", help="one-line JSON")
    args = ap.parse_args(argv)

    def storm():
        return build_composed_storm(args.seed, args.tenants, args.records, args.chunk_rows,
                                    args.processes)

    first = storm()
    budgets = SLOBudgets(
        serve_p99_ms=args.p99_budget_ms or None,
        heal_after_fault_s=args.heal_budget_s,
        expected_heals=2,  # the launch refusal and the crash, both restarted
        allow_shed_tenants=first.hot_tenant_ids(),
        max_stranded_rows=0,
    )
    slo_report, _, _ = run_supervised_storm(first, os.path.join(args.out, "run1"), budgets,
                                            processes=args.processes, device=args.device)
    result = slo_report.to_dict()
    if args.replay:
        slo2, _, _ = run_supervised_storm(storm(), os.path.join(args.out, "run2"), budgets,
                                          processes=args.processes, device=args.device)
        result["replayIdentical"] = slo_report.core_digest() == slo2.core_digest()
        if not result["replayIdentical"]:
            result["passed"] = False
    print(json.dumps(result) if args.json else json.dumps(result, indent=2))
    return 0 if result["passed"] else 1


__all__ = [
    "UNARMED_MATRIX_KW",
    "build_composed_storm",
    "default_storm_spec",
    "main",
    "prediction_digest",
    "run_composition_identity",
    "run_inprocess_storm",
    "run_supervised_storm",
    "supervised_storm_argv",
]


if __name__ == "__main__":
    sys.exit(main())
