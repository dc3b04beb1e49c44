"""Job-level configuration.

The port's copy of ``omldm_tpu/config.py``'s ``JobConfig``, keeping the
fields the port reads. Per-pipeline configuration arrives at runtime inside
``Request.training_configuration`` (see omldm_tpu_torch.api.requests).

``JobConfig.from_args`` builds a config from CLI flags as the JAX package
does, with one difference: a flag naming a field of the JAX ``JobConfig``
that the port does not have (``--meshShape``, ``--computeDtype``, ...)
raises ``SystemExit`` naming it, where the JAX package would honour it. The
port must not quietly run without a knob the reference obeys.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Mapping

# fields of the JAX package's JobConfig that the port does not have (a
# literal copy: the port never imports that package)
JAX_ONLY_FIELDS = (
    "max_msg_params", "request_buffer_cap", "compute_dtype", "mesh_shape",
)


@dataclasses.dataclass
class JobConfig:
    """Global job configuration.

    Defaults replicate the reference's ``DefaultJobParameters``
    (DefaultJobParameters.scala:4-11): parallelism 16, timeout 30_000 ms,
    testSetSize 256, test mode on.
    """

    job_name: str = "OMLDM"
    # Number of logical workers (spokes). Reference default 16
    # (DefaultJobParameters.scala:5).
    parallelism: int = 16
    # Silence timeout (ms) after which the statistics operator fires the
    # termination probe (DefaultJobParameters.scala:10,
    # StatisticsOperator.scala:91).
    timeout_ms: int = 30_000
    # Per-worker holdout test-set size (DefaultJobParameters.scala:11).
    test_set_size: int = 256
    # Test mode: holdout sampling, poll markers, stats harness
    # (DefaultJobParameters.scala:9, FlinkLearning.scala:43).
    test: bool = True
    # Micro-batch size per training step (the learner update's row count).
    batch_size: int = 256
    # Checkpointing (opt-in in the reference: Job.scala:120,
    # Checkpointing.scala:9-25; 5000 ms default interval). The directory
    # defaults to omldm_tpu_checkpoints under the temporary directory.
    checkpointing: bool = False
    check_interval_ms: int = 5_000
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "omldm_tpu_checkpoints"))
    # snapshots retained on disk (oldest pruned after each save); <= 0
    # keeps everything
    checkpoint_keep: int = 3

    # --- capacity limits (host-side buffering) ---
    # Spoke training-record buffer cap (SpokeLogic.scala:32).
    record_buffer_cap: int = 100_000
    # Hub pre-creation message cache cap (StateAccumulators.scala:128-146).
    hub_cache_cap: int = 20_000
    # PS model-state bucket size in #parameters (FlinkNetwork.scala:50).
    max_param_bucket_size: int = 10_000
    # Poll/progress marker cadence in #training records (FlinkSpoke.scala:83-89).
    poll_every: int = 100
    # Dead-letter JSONL file for malformed / rejected records and requests
    # ("" = bounded in-memory quarantine only; runtime.deadletter).
    dead_letter_path: str = ""
    # In-memory quarantine ring size (oldest entries evict).
    dead_letter_cap: int = 10_000
    # With a prediction/response sink attached, the in-memory lists are
    # mirrors trimmed (oldest first) beyond this many entries; <= 0 keeps all.
    emission_buffer_cap: int = 100_000
    # Job-wide DEFAULT adaptive-batching serving spec (runtime/serving.py)
    # for pipelines whose trainingConfiguration carries no "serving" table,
    # e.g. "maxBatch=64,maxDelayMs=5", "relaxed" or "on". Empty: every
    # forecast takes the immediate per-record predict.
    serving: str = ""

    # --- cohort execution engine (runtime/cohort.py) ---
    # "off" | "auto" (gang same-spec dense pipelines once cohort_min are
    # live on a spoke) | "on" (from one pipeline).
    cohort: str = "auto"
    cohort_min: int = 8
    # the JAX package's choice of member iteration: accepted so its configs
    # and flags construct here, and ignored -- the port's cohorts vmap on
    # the card and map on the CPU (runtime.cohort.CohortEngine)
    cohort_impl: str = "auto"
    # tenant-axis device sharding; a value that resolves to one device is
    # admitted, more than one raises (runtime.cohort.resolve_cohort_shards)
    cohort_shards: str = "off"

    # --- the reliable channel (runtime/hub.py) ---
    # Hub liveness walk stride on the record path: with a quorum armed, the
    # every-hub check_liveness walk runs every N events (or when a quarter
    # of the tightest worker timeout passed).
    liveness_stride: int = 16
    # Seeded chaos channel on the in-process hub<->spoke bridge
    # (runtime/supervisor.py), e.g. "seed=7,drop=0.05,dup=0.05"; the
    # OMLDM_CHAOS environment variable is read when this is empty. Any
    # spec arms the reliable channel of every pipeline; its burst keys
    # (burst, burstFrom, burstLen, hotTenant) arm the overload plane's
    # seeded hot-tenant flood (runtime.supervisor.BurstInjector).
    chaos: str = ""

    # --- the overload and lifecycle planes ---
    # Job-wide DEFAULT specs for pipelines whose trainingConfiguration
    # carries no "lifecycle" / "overload" table (runtime/lifecycle.py,
    # runtime/overload.py), e.g. "rampTo=0.5,promoteAfter=128,seed=7" or
    # "window=32,share=2"; "on" takes the defaults, "" leaves them unarmed.
    lifecycle: str = ""
    overload: str = ""

    # --- the telemetry plane and the flight recorder ---
    # Job-wide DEFAULT specs for pipelines whose trainingConfiguration
    # carries no "telemetry" / "events" table (runtime/telemetry.py,
    # runtime/events.py), e.g. "statsEvery=10000,traceSample=64" or
    # "watchdogEvery=10000,shedHigh=1"; "on" takes the defaults, "" leaves
    # them unarmed. On the CLI the events spec rides --flightRecorder: the
    # bare --events flag names the combined replay file.
    telemetry: str = ""
    events: str = ""
    # Directory for the flight recorder's ring dumps (blackbox-proc<N>.jsonl)
    # and the supervisor's incident bundles; "" keeps the ring in memory.
    # The events spec's own blackboxPath knob wins when set.
    blackbox_path: str = ""

    # --- the ingest plane (runtime/ingest_shard.py) ---
    # The sharded multi-process ingest and the device-resident stage for
    # file runs (StreamJob.run_file / run_file_sharded, the CLI's
    # --ingest): "shards=N,chunkKb=C,ring=R,slotRows=S,device=on,waitMs=W"
    # or "on" (one parser a spare core). "" (the default) arms nothing: no
    # ingest object exists and run_file takes the fused C route. The rows
    # reach the job in file order, bit-identical to ingest in one process;
    # device=on keeps the SPMD bridges' stage and holdout ring on the
    # device (SPMDBridge.enable_resident_ingest). A dead parser process
    # degrades to in-process parsing, reason-coded with the selfheal class.
    ingest: str = ""

    # Aliases mapping the reference's exact CLI flag names to the fields
    # (FlinkLearning.scala:43-48, Job.scala:120, Checkpointing.scala:15-22).
    _FLAG_ALIASES = {
        "timeout": "timeout_ms",
        "checkInterval": "check_interval_ms",
        "stateBackend": "checkpoint_dir",
        "jobName": "job_name",
    }

    @classmethod
    def from_args(cls, args: Mapping[str, Any]) -> "JobConfig":
        """Build a config from a flat string map (CLI-style), mirroring
        ``ParameterTool.fromArgs`` (Job.scala:114). Accepts snake_case,
        camelCase and the reference's own flag names (e.g. ``timeout``).
        Keys that name no field are ignored, as in the JAX package; a key
        naming a JAX-only field raises ``SystemExit``."""
        cfg = cls()
        args = dict(args)
        # the bare --events CLI flag names the combined replay FILE
        # (__main__.py), not the flight-recorder spec, which rides
        # --flightRecorder
        args.pop("events", None)
        if "flightRecorder" in args:
            args["events"] = args.pop("flightRecorder")
        for name in JAX_ONLY_FIELDS:
            aliases = [a for a, f in cls._FLAG_ALIASES.items() if f == name]
            for key in (name, _camel(name), *aliases):
                if key in args:
                    raise SystemExit(
                        f"--{key}: the JAX package's JobConfig.{name} is not "
                        "ported to omldm_tpu_torch"
                    )
        for alias, field_name in cls._FLAG_ALIASES.items():
            if alias in args and field_name not in args:
                args[field_name] = args.pop(alias)
        for field in dataclasses.fields(cls):
            for key in (field.name, _camel(field.name)):
                if key in args:
                    raw = args[key]
                    current = getattr(cfg, field.name)
                    if isinstance(current, bool):
                        value = str(raw).lower() in ("1", "true", "yes", "on")
                    elif isinstance(current, int):
                        value = int(raw)
                    else:
                        value = str(raw)
                    setattr(cfg, field.name, value)
        return cfg


def _camel(snake: str) -> str:
    head, *tail = snake.split("_")
    return head + "".join(t.capitalize() for t in tail)
