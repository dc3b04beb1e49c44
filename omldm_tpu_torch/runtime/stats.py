"""Statistics collection + silence-timer-driven termination.

Reference counterpart: ``StatisticsOperator`` (StatisticsOperator.scala:21-150)
+ the termination path of SURVEY.md section 3.5: poll markers keep an
event-time timer fresh; after ``timeout`` ms of silence a termination probe is
broadcast; each worker answers with a responseId -1 fragment per pipeline;
once ``parallelism x #pipelines`` answers arrive the operator normalizes
score/mean-buffer-size, stamps the wall-clock duration, and emits the final
``JobStatistics`` — whose appearance on the performance stream kills the job
(``JobTerminator`` throws by design, JobTerminator.scala:6-10).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from omldm_tpu_torch.api.responses import QueryResponse
from omldm_tpu_torch.api.stats import JobStatistics, Statistics
from omldm_tpu_torch.config import JobConfig


class StatisticsCollector:
    def __init__(
        self,
        config: JobConfig,
        emit_performance: Callable[[JobStatistics], None],
    ):
        self.config = config
        self._emit_performance = emit_performance
        self.job_start: Optional[float] = None
        self.job_end: Optional[float] = None
        self.last_activity: Optional[float] = None
        self._terminate_fragments: Dict[int, list] = {}
        self._hub_stats: Dict[int, Statistics] = {}
        self.terminated = False
        self.probe_fired = False

    # --- activity tracking (poll markers / records keep the timer fresh,
    # StatisticsOperator.scala:77-91) ---

    def mark_activity(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        if self.job_start is None:
            self.job_start = now
        self.last_activity = now
        self.job_end = now

    def silence_exceeded(self, now: Optional[float] = None) -> bool:
        """True when the silence timeout elapsed and the termination probe
        should fire (StatisticsOperator.onTimer:135-142)."""
        if self.last_activity is None or self.probe_fired:
            return False
        now = time.time() if now is None else now
        return (now - self.last_activity) * 1000.0 >= self.config.timeout_ms

    # --- termination accounting (StatisticsOperator.scala:93-129) ---

    def add_hub_statistics(self, network_id: int, stats: Statistics) -> None:
        self._hub_stats[network_id] = stats

    def add_terminate_fragment(self, fragment: QueryResponse) -> None:
        """One responseId -1 fragment per (worker, pipeline)."""
        self._terminate_fragments.setdefault(fragment.mlp_id, []).append(fragment)

    def try_finalize(self, n_pipelines: int) -> Optional[JobStatistics]:
        """Emit JobStatistics once every worker reported for every pipeline
        (count reaches parallelism x #pipelines, StatisticsOperator.scala:109)."""
        if self.terminated:
            return None
        # a probe over ZERO live pipelines is immediately satisfied (the
        # parallelism x #pipelines countdown is 0): finalize with empty
        # statistics instead of leaving the job unterminatable — a live
        # loop would otherwise spin forever on a pipeline-less job
        total = sum(len(v) for v in self._terminate_fragments.values())
        if total < self.config.parallelism * n_pipelines:
            return None
        stats_out = []
        for net_id, frags in sorted(self._terminate_fragments.items()):
            s = self._hub_stats.get(net_id, Statistics(pipeline=net_id))
            n = max(len(frags), 1)
            # per-worker holdout scores average over parallelism
            # (StatisticsOperator.scala:100-125)
            s.update_score(sum((f.score or 0.0) for f in frags) / n)
            s.update_mean_buffer_size(0.0)
            if s.fitted == 0:
                s.fitted = sum(f.data_fitted for f in frags)
            stats_out.append(s)
        duration_ms = (
            ((self.job_end or 0.0) - (self.job_start or 0.0)) * 1000.0
            if self.job_start is not None
            else 0.0
        )
        report = JobStatistics(
            job_name=self.config.job_name,
            parallelism=self.config.parallelism,
            duration_ms=duration_ms,
            statistics=stats_out,
        )
        self._emit_performance(report)
        # JobTerminator semantics: first record on the performance stream
        # stops the world (JobTerminator.scala:6-10)
        self.terminated = True
        return report
