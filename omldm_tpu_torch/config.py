"""Job-level configuration.

The port's copy of ``omldm_tpu/config.py``'s ``JobConfig``, keeping the
fields the port reads. Per-pipeline configuration arrives at runtime inside
``Request.training_configuration`` (see omldm_tpu_torch.api.requests).
"""

from __future__ import annotations

import dataclasses


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

    # --- planes of the JAX package the port does not have yet ---
    # Kept so a config written for omldm_tpu constructs here; arming any of
    # them makes StreamJob raise NotImplementedError naming the option
    # (runtime.job.unported_job_options). "auto" cohort runs per pipeline,
    # which the JAX package pins as bit-identical to "off".
    checkpointing: bool = False
    chaos: str = ""
    cohort: str = "auto"
    cohort_shards: str = "off"
    serving: str = ""
    lifecycle: str = ""
    overload: str = ""
    ingest: str = ""
    telemetry: str = ""
    events: str = ""
