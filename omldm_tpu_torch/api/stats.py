"""Training statistics and the final job report.

Reference counterpart: ControlAPI's ``Statistics`` ``{pipeline, protocol,
modelsShipped, bytesShipped, numOfBlocks, fitted, learningCurve, LCX,
meanBufferSize, score}`` with ``updateStats/updateFitted/updateScore/
updateMeanBufferSize`` (reference:
src/main/scala/omldm/operators/hub/FlinkHub.scala:118-153,
src/main/scala/omldm/utils/statistics/StatisticsOperator.scala:96-125,
src/main/scala/omldm/state/StateAccumulators.scala:62-124) and
``JobStatistics(jobName, parallelism, durationMs, Statistics[])``
(StatisticsOperator.scala:110-127).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Statistics:
    """Per-pipeline protocol + accuracy statistics.

    ``learning_curve`` is a list of (loss, #fitted) points — the reference
    slices it incrementally out of the PS on each stats poll
    (FlinkHub.scala:101-116,131-142); ``lcx`` is the matching x-axis
    (#records-fitted checkpoints)."""

    pipeline: int
    protocol: str = ""
    models_shipped: int = 0
    bytes_shipped: int = 0
    # The fields below keep the wire report's schema equal to
    # omldm_tpu.api.stats.Statistics, where each is documented (codec,
    # reliable channel, guard, cohorts, overload, lifecycle, rescale,
    # fleet, flight recorder, telemetry); the fleet's, a plane the port
    # lacks, stay zero. The launch percentiles fold only with the
    # telemetry plane armed (wall-clock values would make an unarmed
    # report irreproducible).
    bytes_on_wire: int = 0
    num_of_blocks: int = 0
    duplicates_dropped: int = 0
    gaps_resynced: int = 0
    quorum_releases: int = 0
    # learner program dispatches on this pipeline's behalf (fit / fit_many /
    # predict / evaluate), counted spoke-side and folded in at
    # query/terminate
    program_launches: int = 0
    cohort_shards: int = 0
    deltas_rejected: int = 0
    rollbacks_performed: int = 0
    members_evicted: int = 0
    # malformed / rejected records routed to the dead-letter sink
    # (runtime.deadletter): a JOB-level count mirrored into each
    # pipeline's statistics at terminate
    records_quarantined: int = 0
    # forecasts emitted on this pipeline's behalf and the per-forecast
    # latency percentiles (ms) folded from the spokes' serving clocks;
    # percentiles max-combine across contributors
    forecasts_served: int = 0
    serve_latency_p50_ms: float = 0.0
    serve_latency_p99_ms: float = 0.0
    serve_latency_p999_ms: float = 0.0
    forecasts_shed: int = 0
    records_throttled: int = 0
    pressure_level: int = 0
    shed_latency_ms: float = 0.0
    shadow_scored: int = 0
    canary_promotions: int = 0
    canary_rollbacks: int = 0
    active_version: int = 0
    rescales_performed: int = 0
    fleet_processes: int = 0
    fleet_degraded: int = 0
    blackbox_write_errors: int = 0
    events_recorded: int = 0
    alerts_raised: int = 0
    codec_encode_seconds: float = 0.0
    codec_decode_seconds: float = 0.0
    launch_p50_ms: float = 0.0
    launch_p99_ms: float = 0.0
    serve_launch_p50_ms: float = 0.0
    serve_launch_p99_ms: float = 0.0
    fitted: int = 0
    learning_curve: List[float] = dataclasses.field(default_factory=list)
    lcx: List[int] = dataclasses.field(default_factory=list)
    mean_buffer_size: float = 0.0
    score: float = 0.0

    def update_stats(
        self,
        models_shipped: int = 0,
        bytes_shipped: int = 0,
        num_of_blocks: int = 0,
        bytes_on_wire: int = 0,
        duplicates_dropped: int = 0,
        gaps_resynced: int = 0,
        quorum_releases: int = 0,
        program_launches: int = 0,
        deltas_rejected: int = 0,
        rollbacks_performed: int = 0,
        members_evicted: int = 0,
        records_quarantined: int = 0,
        forecasts_served: int = 0,
        cohort_shards: int = 0,
        forecasts_shed: int = 0,
        records_throttled: int = 0,
        pressure_level: int = 0,
        shadow_scored: int = 0,
        canary_promotions: int = 0,
        canary_rollbacks: int = 0,
        active_version: Optional[int] = None,
        rescales_performed: int = 0,
        fleet_processes: int = 0,
        fleet_degraded: int = 0,
        blackbox_write_errors: int = 0,
        codec_encode_seconds: float = 0.0,
        codec_decode_seconds: float = 0.0,
        events_recorded: int = 0,
        alerts_raised: int = 0,
    ) -> None:
        """Accumulate communication counters (FlinkHub.scala:118-127).
        Gauges max-combine instead of summing, and ``active_version`` is
        last-write, as in omldm_tpu.api.stats."""
        self.models_shipped += models_shipped
        self.bytes_shipped += bytes_shipped
        self.num_of_blocks += num_of_blocks
        self.bytes_on_wire += bytes_on_wire
        self.duplicates_dropped += duplicates_dropped
        self.gaps_resynced += gaps_resynced
        self.quorum_releases += quorum_releases
        self.program_launches += program_launches
        self.deltas_rejected += deltas_rejected
        self.rollbacks_performed += rollbacks_performed
        self.members_evicted += members_evicted
        self.records_quarantined += records_quarantined
        self.forecasts_served += forecasts_served
        self.cohort_shards = max(self.cohort_shards, cohort_shards)
        self.forecasts_shed += forecasts_shed
        self.records_throttled += records_throttled
        self.pressure_level = max(self.pressure_level, pressure_level)
        self.shadow_scored += shadow_scored
        self.canary_promotions += canary_promotions
        self.canary_rollbacks += canary_rollbacks
        if active_version is not None:
            self.active_version = active_version
        self.rescales_performed += rescales_performed
        self.fleet_processes = max(self.fleet_processes, fleet_processes)
        self.fleet_degraded = max(self.fleet_degraded, fleet_degraded)
        self.blackbox_write_errors = max(
            self.blackbox_write_errors, blackbox_write_errors
        )
        self.codec_encode_seconds += codec_encode_seconds
        self.codec_decode_seconds += codec_decode_seconds
        # job-level mirrors: max, not sum
        self.events_recorded = max(self.events_recorded, events_recorded)
        self.alerts_raised = max(self.alerts_raised, alerts_raised)

    def note_launch_ms(self, p50: float, p99: float) -> None:
        """Fold one contributor's fit-flush launch percentile window in
        (max-combine, as the serve-latency percentiles)."""
        self.launch_p50_ms = max(self.launch_p50_ms, p50)
        self.launch_p99_ms = max(self.launch_p99_ms, p99)

    def note_serve_launch_ms(self, p50: float, p99: float) -> None:
        """Fold one contributor's serving-launch percentile window in."""
        self.serve_launch_p50_ms = max(self.serve_launch_p50_ms, p50)
        self.serve_launch_p99_ms = max(self.serve_launch_p99_ms, p99)

    def note_serve_latency(self, p50: float, p99: float, p999: float) -> None:
        """Fold one contributor's serving-latency percentile window in
        (max-combine: the report carries the worst observed percentiles
        across spokes; percentiles are not additive)."""
        self.serve_latency_p50_ms = max(self.serve_latency_p50_ms, p50)
        self.serve_latency_p99_ms = max(self.serve_latency_p99_ms, p99)
        self.serve_latency_p999_ms = max(self.serve_latency_p999_ms, p999)

    def note_shed_latency(self, p99: float) -> None:
        """Fold one contributor's enqueue->shed p99 in (max-combine, as the
        serve-latency percentiles)."""
        self.shed_latency_ms = max(self.shed_latency_ms, p99)

    def update_fitted(self, fitted: int) -> None:
        self.fitted += fitted

    def update_score(self, score: float) -> None:
        self.score = score

    def update_mean_buffer_size(self, mbs: float) -> None:
        self.mean_buffer_size = mbs

    def extend_curve(self, points: List[Tuple[float, int]]) -> None:
        """Append incremental learning-curve slices (FlinkHub.scala:101-116)."""
        for loss, fitted in points:
            self.learning_curve.append(float(loss))
            self.lcx.append(int(fitted))

    def normalize(self, count: int) -> None:
        """Divide accumulated score / mean-buffer-size by the number of
        contributors, mirroring the statistics operator's end-of-job
        normalization over parallelism (StatisticsOperator.scala:100-125)."""
        if count > 0:
            self.score /= count
            self.mean_buffer_size /= count

    def merge(self, other: "Statistics") -> "Statistics":
        """Cross-hub merge: sums counters, concatenates learning curves in
        x order (StateAccumulators.scala:54-126).

        ``score`` and ``mean_buffer_size`` are *accumulated* here and must be
        normalized by the contributor count before reporting — the reference
        does the same accumulate-then-normalize over parallelism
        (StatisticsOperator.scala:109-125); call :meth:`normalize`."""
        assert self.pipeline == other.pipeline
        merged = Statistics(
            pipeline=self.pipeline,
            protocol=self.protocol or other.protocol,
            models_shipped=self.models_shipped + other.models_shipped,
            bytes_shipped=self.bytes_shipped + other.bytes_shipped,
            bytes_on_wire=self.bytes_on_wire + other.bytes_on_wire,
            num_of_blocks=self.num_of_blocks + other.num_of_blocks,
            duplicates_dropped=self.duplicates_dropped + other.duplicates_dropped,
            gaps_resynced=self.gaps_resynced + other.gaps_resynced,
            quorum_releases=self.quorum_releases + other.quorum_releases,
            program_launches=self.program_launches + other.program_launches,
            cohort_shards=max(self.cohort_shards, other.cohort_shards),
            deltas_rejected=self.deltas_rejected + other.deltas_rejected,
            rollbacks_performed=self.rollbacks_performed
            + other.rollbacks_performed,
            members_evicted=self.members_evicted + other.members_evicted,
            records_quarantined=self.records_quarantined
            + other.records_quarantined,
            forecasts_served=self.forecasts_served + other.forecasts_served,
            forecasts_shed=self.forecasts_shed + other.forecasts_shed,
            records_throttled=self.records_throttled
            + other.records_throttled,
            pressure_level=max(self.pressure_level, other.pressure_level),
            shed_latency_ms=max(self.shed_latency_ms, other.shed_latency_ms),
            shadow_scored=self.shadow_scored + other.shadow_scored,
            canary_promotions=self.canary_promotions
            + other.canary_promotions,
            canary_rollbacks=self.canary_rollbacks + other.canary_rollbacks,
            active_version=max(self.active_version, other.active_version),
            # a job-level mirror (every contributor reports the same
            # value): max-combine, not sum, so cross-hub merges do not
            # multiply the count
            rescales_performed=max(
                self.rescales_performed, other.rescales_performed
            ),
            fleet_processes=max(self.fleet_processes, other.fleet_processes),
            fleet_degraded=max(self.fleet_degraded, other.fleet_degraded),
            blackbox_write_errors=max(
                self.blackbox_write_errors, other.blackbox_write_errors
            ),
            events_recorded=max(
                self.events_recorded, other.events_recorded
            ),
            alerts_raised=max(self.alerts_raised, other.alerts_raised),
            codec_encode_seconds=self.codec_encode_seconds
            + other.codec_encode_seconds,
            codec_decode_seconds=self.codec_decode_seconds
            + other.codec_decode_seconds,
            launch_p50_ms=max(self.launch_p50_ms, other.launch_p50_ms),
            launch_p99_ms=max(self.launch_p99_ms, other.launch_p99_ms),
            serve_launch_p50_ms=max(
                self.serve_launch_p50_ms, other.serve_launch_p50_ms
            ),
            serve_launch_p99_ms=max(
                self.serve_launch_p99_ms, other.serve_launch_p99_ms
            ),
            serve_latency_p50_ms=max(
                self.serve_latency_p50_ms, other.serve_latency_p50_ms
            ),
            serve_latency_p99_ms=max(
                self.serve_latency_p99_ms, other.serve_latency_p99_ms
            ),
            serve_latency_p999_ms=max(
                self.serve_latency_p999_ms, other.serve_latency_p999_ms
            ),
            fitted=self.fitted + other.fitted,
            mean_buffer_size=self.mean_buffer_size + other.mean_buffer_size,
            score=self.score + other.score,
        )
        pairs = sorted(
            list(zip(self.lcx, self.learning_curve))
            + list(zip(other.lcx, other.learning_curve)),
            key=lambda p: p[0],
        )
        merged.lcx = [x for x, _ in pairs]
        merged.learning_curve = [y for _, y in pairs]
        return merged

    def to_dict(self) -> dict:
        return {
            "pipeline": self.pipeline,
            "protocol": self.protocol,
            "modelsShipped": self.models_shipped,
            "bytesShipped": self.bytes_shipped,
            "bytesOnWire": self.bytes_on_wire,
            "duplicatesDropped": self.duplicates_dropped,
            "gapsResynced": self.gaps_resynced,
            "quorumReleases": self.quorum_releases,
            "programLaunches": self.program_launches,
            "cohortShards": self.cohort_shards,
            "deltasRejected": self.deltas_rejected,
            "rollbacksPerformed": self.rollbacks_performed,
            "membersEvicted": self.members_evicted,
            "recordsQuarantined": self.records_quarantined,
            "forecastsServed": self.forecasts_served,
            "forecastsShed": self.forecasts_shed,
            "recordsThrottled": self.records_throttled,
            "pressureLevel": self.pressure_level,
            "shedLatencyMs": self.shed_latency_ms,
            "shadowScored": self.shadow_scored,
            "canaryPromotions": self.canary_promotions,
            "canaryRollbacks": self.canary_rollbacks,
            "activeVersion": self.active_version,
            "rescalesPerformed": self.rescales_performed,
            "fleetProcesses": self.fleet_processes,
            "fleetDegraded": self.fleet_degraded,
            "blackboxWriteErrors": self.blackbox_write_errors,
            "eventsRecorded": self.events_recorded,
            "alertsRaised": self.alerts_raised,
            "codecEncodeSeconds": self.codec_encode_seconds,
            "codecDecodeSeconds": self.codec_decode_seconds,
            "launchP50Ms": self.launch_p50_ms,
            "launchP99Ms": self.launch_p99_ms,
            "serveLaunchP50Ms": self.serve_launch_p50_ms,
            "serveLaunchP99Ms": self.serve_launch_p99_ms,
            "serveLatencyP50Ms": self.serve_latency_p50_ms,
            "serveLatencyP99Ms": self.serve_latency_p99_ms,
            "serveLatencyP999Ms": self.serve_latency_p999_ms,
            "numOfBlocks": self.num_of_blocks,
            "fitted": self.fitted,
            "learningCurve": self.learning_curve,
            "LCX": self.lcx,
            "meanBufferSize": self.mean_buffer_size,
            "score": self.score,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


@dataclasses.dataclass
class JobStatistics:
    """Final job report shipped to the performance stream
    (StatisticsOperator.scala:110-127, PerformanceWriter.scala:6-8)."""

    job_name: str
    parallelism: int
    duration_ms: float
    statistics: List[Statistics] = dataclasses.field(default_factory=list)
    # the telemetry plane's extensions (runtime/telemetry.py): ``kind`` is
    # None on the terminate-time final report, whose wire shape then stays
    # the plain schema, "heartbeat" on the snapshots the armed plane emits
    # mid-stream and "alert" on the flight recorder's watchdog alerts; they
    # carry their ``seq`` and extras merged top-level into to_dict
    kind: Optional[str] = None
    seq: Optional[int] = None
    extra: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {
            "jobName": self.job_name,
            "parallelism": self.parallelism,
            "durationMs": self.duration_ms,
            "statistics": [s.to_dict() for s in self.statistics],
        }
        if self.kind is not None:
            d["kind"] = self.kind
            d["seq"] = self.seq
            for k, v in (self.extra or {}).items():
                d.setdefault(k, v)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def __str__(self) -> str:  # PerformanceWriter stringification
        return self.to_json()
