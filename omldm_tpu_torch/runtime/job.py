"""StreamJob: assembles spokes, hubs, control plane, statistics and sinks.

Counterpart of ``omldm_tpu/runtime/job.py`` (the reference's ``Job`` +
``FlinkLearning``, Job.scala:28-171): training and forecasting records and
requests in; predictions, merged query responses and the final
``JobStatistics`` out. The job consumes an ordered event iterable of
``(stream, payload)`` pairs and runs the termination protocol at stream
end. A ``PACKED_STREAM`` event carries a block of rows the native parser
vectorized (``runtime.fast_ingest``), dealt to the spokes exactly as
per-record events would be.

A pipeline deploys on the host plane (spokes and hubs) or, when its
``trainingConfiguration`` sets ``{"engine": "spmd"}`` with a protocol and
learner the engine hosts, on an ``SPMDBridge`` (``runtime.spmd_bridge``),
which sees every record. A job whose one pipeline is on that engine can
take a training file through the fused C ingest (``run_file_fused``).

The sharded ingest plane (``JobConfig.ingest``, ``runtime.ingest_shard``)
stripes a training file across parser processes and replays their row
blocks in file order through the packed route (``run_file_sharded``; with
``device=on`` the SPMD bridges keep their stage and holdout ring on the
device). ``run_file`` takes that route when the plane is armed, else the
fused one.

With cohorts armed (``JobConfig.cohort``), each event is processed inside
the hubs' gang-averaging window (``runtime.cohort.GangAverager``), so the
Synchronous rounds of a cohort's pipelines that complete on one event
average in one stacked reduction at its end.

With a chaos spec (``JobConfig.chaos``, else ``OMLDM_CHAOS``) both
directions of the in-process hub<->spoke bridge run through a seeded
``ChaosChannel`` (``runtime.supervisor``), and every pipeline's reliable
channel arms itself to survive it. At stream end the channels quiesce and
the receive windows hand back what they hold before the termination probe.

The spec's burst keys arm a ``runtime.supervisor.BurstInjector``: each
forecasting record inside its window gains tenant-addressed copies that
flood one pipeline, and every spoke then routes ``metadata.tenant``
records to that tenant alone.

The overload plane (``JobConfig.overload`` or a pipeline's
``trainingConfiguration.overload``, ``runtime.overload``) folds into
``overload_level()`` (the peak of the spokes' pressure levels) and
``queue_depths()``; ``overload_idle_tick()`` advances the controllers'
count clocks while a source is idle. The lifecycle plane
(``JobConfig.lifecycle`` or ``trainingConfiguration.lifecycle``,
``runtime.lifecycle``) takes the Shadow, Promote and Rollback requests: a
verb aimed at an SPMD pipeline or at a pipeline without the plane armed is
quarantined, any other goes to every spoke, and ``tenant_topology()``
carries each armed pipeline's registry view.

With ``JobConfig.checkpointing`` the job snapshots itself every
``check_interval_ms`` between events (``checkpoint.CheckpointManager``; a
``runtime.recovery.JobSupervisor`` restores the newest snapshot and resumes
at its event offset, ``events_processed``). ``rescale(n)`` changes the
worker count mid-stream: a grow seeds the new replicas from spoke 0's
model, a shrink merges each retiring spoke into a survivor
(``Spoke.absorb``). A live lifecycle registry (a candidate in flight, or a
promoted active version) replicates onto a grown spoke.

The telemetry plane (``JobConfig.telemetry`` or a pipeline's
``trainingConfiguration.telemetry``, ``runtime.telemetry``) emits a
heartbeat (a ``JobStatistics`` with ``kind="heartbeat"``) every
``statsEvery`` records through the performance sink, keeps the phase table
(``phase_table``) and samples round spans. The flight recorder
(``JobConfig.events`` or ``trainingConfiguration.events``,
``runtime.events``) journals every plane's decisions, dumps its ring to
``blackbox_path`` at incidents and terminate, and runs the watchdog every
``watchdogEvery`` records: a fired rule reaches the performance sink as a
``kind="alert"`` record. Both are count-clocked (a packed block ticks by its
rows), read host values only, and unarmed leave no object behind.

Every pipeline's state lives on the job's ``torch.device``: CUDA unless the
caller asks for the CPU. There is no fallback -- a job asked for CUDA on a
host without a card raises.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.data import FORECASTING, DataInstance, Prediction
from omldm_tpu_torch.api.requests import LIFECYCLE_REQUESTS, Request, RequestType
from omldm_tpu_torch.api.responses import TERMINATION_RESPONSE_ID, QueryResponse
from omldm_tpu_torch.api.stats import JobStatistics, Statistics
from omldm_tpu_torch.checkpoint import CheckpointManager
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime.cohort import resolve_cohort_shards
from omldm_tpu_torch.runtime.control import PipelineManager
from omldm_tpu_torch.runtime.deadletter import DeadLetterSink
from omldm_tpu_torch.runtime.events import (
    DEGRADE,
    RESCALE,
    TERMINATE,
    FlightRecorder,
    events_armed_for,
    events_config,
    parse_events_spec,
)
from omldm_tpu_torch.runtime.hub import HubManager
from omldm_tpu_torch.runtime.ingest_shard import IngestConfig, ShardedIngest, parse_ingest_spec
from omldm_tpu_torch.runtime.lifecycle import lifecycle_config, parse_lifecycle_spec
from omldm_tpu_torch.runtime.messages import channel_chaos_spec
from omldm_tpu_torch.runtime.overload import parse_overload_spec
from omldm_tpu_torch.runtime.prefetch import Prefetcher
from omldm_tpu_torch.runtime.responses import ResponseMerger
from omldm_tpu_torch.runtime.serving import parse_serving_spec
from omldm_tpu_torch.runtime.spmd_bridge import (
    make_spmd_bridge,
    spmd_engine_requested,
    spmd_engine_supported,
)
from omldm_tpu_torch.runtime.spoke import PACKED, Spoke, _PauseBuffer
from omldm_tpu_torch.runtime.stats import StatisticsCollector
from omldm_tpu_torch.runtime.supervisor import BurstInjector, ChaosChannel, parse_chaos_spec
from omldm_tpu_torch.runtime.telemetry import (
    PhaseProfile,
    TelemetryPlane,
    parse_telemetry_spec,
    telemetry_config,
)
from omldm_tpu_torch.runtime.vectorizer import Vectorizer
from omldm_tpu_torch.utils.device import resolve_device
from omldm_tpu_torch.utils.tracing import StepTimer

# event stream names (the reference's Kafka topics)
TRAINING_STREAM = "trainingData"
FORECASTING_STREAM = "forecastingData"
REQUEST_STREAM = "requests"
# pre-vectorized (x, y, op) blocks from the bulk parser (fast_ingest)
PACKED_STREAM = PACKED

# rows held for pipelines that have not been created yet, before the FIRST
# deploy (the reference's recordBuffer cap, SpokeLogic.scala:31-35)
PRE_CREATE_BACKLOG_CAP = 100_000

# Python frames the cooperative pause toggle may nest a net of a spoke: a
# hub reply resumes a paused net, whose drained records reach a sync point
# whose reply resumes the next, about 18 frames a net (Synchronous, 8 to
# 64 nets), so the interpreter's default limit of 1,000 stops a spoke of
# ~56 nets that do not gang. The JAX package nests the same way and stops
# there; the job lets the limit grow with the nets it hosts instead.
TOGGLE_FRAMES_PER_NET = 64


class StreamJob:
    def __init__(
        self,
        config: Optional[JobConfig] = None,
        on_prediction: Optional[Callable[[Prediction], None]] = None,
        on_response: Optional[Callable[[QueryResponse], None]] = None,
        on_performance: Optional[Callable[[JobStatistics], None]] = None,
        device=None,
    ):
        self.config = config or JobConfig()
        # fail fast on a malformed job-wide serving default (a per-pipeline
        # serving table is checked at the control gate and drops only its
        # own request)
        parse_serving_spec(self.config.serving)
        # ... and on malformed job-wide overload and lifecycle defaults
        parse_overload_spec(self.config.overload)
        parse_lifecycle_spec(self.config.lifecycle)
        # the ingest plane, armed by the job-wide spec (a malformed one
        # fails here). Unarmed, no ingest object exists and run_file takes
        # the fused route
        self.ingest_cfg: Optional[IngestConfig] = parse_ingest_spec(self.config.ingest)
        # the last sharded run's worker and driver accounting
        self._ingest_stats: Optional[dict] = None
        # the telemetry plane and the flight recorder: armed by a job-wide
        # spec after the spokes exist (a malformed one fails here), or
        # lazily by the first pipeline whose table arms them (_deploy).
        # Unarmed, both stay None and no object of theirs exists
        tel_cfg = parse_telemetry_spec(self.config.telemetry)
        ev_cfg = parse_events_spec(self.config.events)
        self.telemetry: Optional[TelemetryPlane] = None
        self.events: Optional[FlightRecorder] = None
        self.device = resolve_device(device, "StreamJob")
        # a cohort_shards past one device raises here, before any spoke
        resolve_cohort_shards(self.config, self.device)
        self.predictions: List[Prediction] = []
        self.responses: List[QueryResponse] = []
        self.performance: List[JobStatistics] = []
        self._on_prediction = on_prediction
        self._on_response = on_response
        self._on_performance = on_performance
        self.pipeline_manager = PipelineManager()
        self.stats = StatisticsCollector(self.config, self._emit_performance)
        self.dead_letter = DeadLetterSink(
            path=self.config.dead_letter_path,
            cap=self.config.dead_letter_cap,
            request_stream=REQUEST_STREAM,
        )
        self.response_merger = ResponseMerger(self._emit_response)
        self.hub_manager = HubManager(self.config, self._ship_to_spoke, self.device)
        # the seeded chaos channel on both directions of the bridge (None:
        # no spec, the plain route); a malformed spec raises here
        self._chaos_up: Optional[ChaosChannel] = None
        self._chaos_down: Optional[ChaosChannel] = None
        # the seeded hot-tenant flood (the overload plane's fault injector),
        # armed by the same spec's burst keys; None otherwise
        self._burst: Optional[BurstInjector] = None
        spec = parse_chaos_spec(channel_chaos_spec(self.config))
        if spec is not None:
            self._chaos_up = ChaosChannel.from_spec(
                self.hub_manager.route, spec, "up", name="spoke>hub")
            self._chaos_down = ChaosChannel.from_spec(
                self._reply_to_spoke, spec, "down", name="hub>spoke")
            self._burst = BurstInjector.from_spec(spec)
        self.spokes: List[Spoke] = [
            self._spawn_spoke(i) for i in range(self.config.parallelism)
        ]
        if tel_cfg is not None:
            self._arm_telemetry(tel_cfg)
        if ev_cfg is not None:
            self._arm_events(ev_cfg)
        self.predictions_trimmed = 0
        self.responses_trimmed = 0
        self._rr = 0  # round-robin data partitioner (the reference rebalances)
        self._pending_creates: List[Request] = []  # awaiting dim inference
        self._dims: dict = {}  # network_id -> feature dim
        # data that arrives before ANY pipeline is deployed, replayed through
        # the normal routing on the first deploy
        self._backlog = _PauseBuffer(PRE_CREATE_BACKLOG_CAP)
        # pipelines deployed on the SPMD engine instead of the host plane
        self.spmd_bridges: Dict[int, Any] = {}
        self._in_event = False  # inside _toggle_stack
        # live rescales so far (StreamJob.rescale, or a restore at another
        # parallelism): every pipeline's report carries the count
        self.rescales_performed = 0
        # stream position: events consumed so far. Checkpoints record it so
        # a supervisor can resume a replayable source at the exact event the
        # snapshot covers (the role of Flink's source offsets in a
        # checkpoint barrier; runtime.recovery.JobSupervisor)
        self.events_processed = 0
        # an external source's position (e.g. Kafka (topic, partition) ->
        # next offset): a source that sets it has checkpoints carry it
        self.source_position: Optional[dict] = None
        # opt-in periodic checkpointing (Job.scala:120, Checkpointing.scala)
        self.checkpoint_manager = None
        if self.config.checkpointing:
            self.checkpoint_manager = CheckpointManager(
                self.config.checkpoint_dir, keep=self.config.checkpoint_keep,
                device=self.device,
            )
        # queue_depths() at terminate, after the drain cascade (None until
        # then): the overload gates read it to find stranded rows
        self.terminate_accounting: Optional[dict] = None

    def _spawn_spoke(self, worker_id: int) -> Spoke:
        """The one spoke recipe: construction at job init and the spokes a
        live :meth:`rescale` grow adds share it, so every wiring decision
        (the chaos route, the quarantine, tenant routing) follows the same
        rule on both paths. The job-level tenant routing is the burst
        injector's; an armed overload controller routes on its own spoke,
        which a grown spoke arms when the live pipelines deploy on it."""
        send_to_hub = (self._chaos_up.send if self._chaos_up is not None
                       else self.hub_manager.route)
        return Spoke(
            worker_id=worker_id,
            config=self.config,
            send_to_hub=send_to_hub,
            emit_prediction=self._emit_prediction,
            emit_response=self._route_response_fragment,
            on_poll=self.stats.mark_activity,
            device=self.device,
            note_wire=self._note_wire,
            emit_predictions=self._emit_predictions,
            quarantine=self.dead_letter.quarantine,
            tenant_routing=self._burst is not None,
            telemetry=self.telemetry,
            events=self.events.journal if self.events is not None else None,
        )

    # --- sinks ---

    def set_sinks(
        self,
        on_prediction: Optional[Callable[[Prediction], None]] = None,
        on_response: Optional[Callable[[QueryResponse], None]] = None,
        on_performance: Optional[Callable[[JobStatistics], None]] = None,
    ) -> None:
        """Replace output sinks after construction; only the callbacks
        passed (not None) are replaced."""
        if on_prediction is not None:
            self._on_prediction = on_prediction
        if on_response is not None:
            self._on_response = on_response
        if on_performance is not None:
            self._on_performance = on_performance

    def _trim_emission(self, buf: list, counter: str) -> None:
        """With a sink attached the in-memory lists are mirrors: beyond
        ``emission_buffer_cap`` the oldest entries drop."""
        cap = self.config.emission_buffer_cap
        if cap > 0 and len(buf) > cap:
            drop = len(buf) - cap
            del buf[:drop]
            setattr(self, counter, getattr(self, counter) + drop)

    def _emit_prediction(self, pred: Prediction) -> None:
        self.predictions.append(pred)
        if self._on_prediction:
            self._on_prediction(pred)
            self._trim_emission(self.predictions, "predictions_trimmed")

    def _emit_predictions(self, preds: List[Prediction]) -> None:
        """Bulk twin of :meth:`_emit_prediction` for the serving plane's
        flushes: one extend per flush; sink callbacks still fire per
        prediction, in order."""
        self.predictions.extend(preds)
        if self._on_prediction:
            for pred in preds:
                self._on_prediction(pred)
            self._trim_emission(self.predictions, "predictions_trimmed")

    def _emit_response(self, resp: QueryResponse) -> None:
        self.responses.append(resp)
        if self._on_response:
            self._on_response(resp)
            self._trim_emission(self.responses, "responses_trimmed")

    def _emit_performance(self, report: JobStatistics) -> None:
        self.performance.append(report)
        if self._on_performance:
            self._on_performance(report)

    def _route_response_fragment(self, frag: QueryResponse) -> None:
        """responseId -1 fragments are termination stats, everything else is
        a user query fragment (FlinkLearning.scala:115-133)."""
        if frag.response_id == TERMINATION_RESPONSE_ID:
            self.stats.add_terminate_fragment(frag)
        else:
            self.response_merger.add_fragment(frag)

    def _ship_to_spoke(self, network_id: int, hub_id: int, worker_id: int,
                       op: str, payload: Any, seq=None) -> None:
        """Hub->spoke ship boundary: through the chaos channel when armed."""
        if self._chaos_down is not None:
            self._chaos_down.send(network_id, hub_id, worker_id, op, payload, seq)
        else:
            self._reply_to_spoke(network_id, hub_id, worker_id, op, payload, seq)

    def _reply_to_spoke(self, network_id: int, hub_id: int, worker_id: int,
                        op: str, payload: Any, seq=None) -> None:
        if worker_id >= len(self.spokes):
            return
        self.spokes[worker_id].receive_from_hub(network_id, hub_id, op, payload, seq)

    def _note_wire(self, network_id: int, hub_id: int, counter: str, n) -> None:
        """Spoke-side tallies (program launches, serving telemetry, the
        channel's repairs, guard rollbacks, codec seconds) fold into the
        pipeline's hub statistics so one report carries both sides."""
        hub = self.hub_manager.hubs.get((network_id, hub_id))
        if hub is None:
            return
        if counter == "serve_latency_ms":
            hub.node.stats.note_serve_latency(*n)
        elif counter == "shed_latency_ms":
            hub.node.stats.note_shed_latency(n)
        elif counter == "codec_seconds":
            hub.node.stats.update_stats(
                codec_encode_seconds=n[0], codec_decode_seconds=n[1])
        elif counter == "launch_ms":
            hub.node.stats.note_launch_ms(*n)
        elif counter == "serve_launch_ms":
            hub.node.stats.note_serve_launch_ms(*n)
        else:
            hub.node.stats.update_stats(**{counter: n})

    # --- the telemetry plane (runtime/telemetry.py) ---

    def _arm_telemetry(self, cfg) -> None:
        """Create the job's TelemetryPlane (once) and hand every spoke the
        reference: from __init__ for the job-wide spec, or from _deploy for
        the first pipeline's table. The standing probes read host values
        only (StepTimer rings, queue lengths, the pressure level), never a
        CUDA tensor, so a snapshot adds no device sync; the serve p99 is
        also the overload ladder's latency signal once the plane is armed
        (``OverloadController.signals``)."""
        plane = TelemetryPlane(cfg)
        plane.registry.probe("serve_launch_p99_ms", self._serve_p99)
        plane.registry.probe("flush_launch_p99_ms", lambda: max(
            (s.step_timer.recent_p99() for s in self.spokes), default=0.0))
        plane.registry.probe("pressure_level", self.overload_level)
        plane.registry.probe("queued_rows", lambda: float(sum(
            v for k, v in self.queue_depths().items() if k != "pressure_level")))
        self.telemetry = plane
        for spoke in self.spokes:
            spoke.attach_telemetry(plane)

    # --- the flight recorder (runtime/events.py) ---

    def _arm_events(self, cfg) -> None:
        """Create the job's FlightRecorder (once) and hand every spoke, hub
        shard and the dead-letter sink the journal: from __init__ for the
        job-wide spec, or from _deploy for the first pipeline's table. A
        pipeline whose table opts out keeps its shards unarmed."""
        rec = FlightRecorder(
            cfg, pid=0, position=lambda: self.events_processed,
            on_alert=self._emit_alert_record,
            blackbox_default=self.config.blackbox_path,
        )
        self.events = rec
        for spoke in self.spokes:
            spoke.attach_events(rec.journal)
        self.hub_manager.events = rec.journal
        for (nid, _h), hub in self.hub_manager.hubs.items():
            req = self.pipeline_manager.node_map.get(nid)
            if req is not None and events_armed_for(req.training_configuration,
                                                    self.config.events):
                hub.node.events = rec.journal
        # each quarantine entry then carries the journal's high-water id,
        # pointing at the events that explain it
        self.dead_letter.event_ring = rec.journal

    def _serve_p99(self) -> float:
        """The spokes' worst recent serve-launch p99 (ms)."""
        return max((s.serve_timer.recent_p99() for s in self.spokes), default=0.0)

    def _emit_live_report(self, kind: str, seq: int, statistics: list, extra: dict,
                          now: Optional[float] = None) -> None:
        """A mid-stream ``JobStatistics`` of ``kind`` through the
        performance sink (the final report's ``kind`` stays None)."""
        start = self.stats.job_start
        now = time.time() if now is None else now
        self._emit_performance(JobStatistics(
            job_name=self.config.job_name, parallelism=self.config.parallelism,
            duration_ms=(now - start) * 1000.0 if start is not None else 0.0,
            statistics=statistics, kind=kind, seq=seq, extra=extra,
        ))

    def _emit_alert_record(self, event: dict) -> None:
        """One watchdog alert onto the performance sink as a ``kind="alert"``
        record (no statistics: an alert points into the journal)."""
        self._emit_live_report("alert", event["id"], [], {"alert": event})

    def _watchdog_signals(self) -> dict:
        """The signals one watchdog pass evaluates: the telemetry registry's
        serve p99 probe when the plane is armed, the same accessor
        otherwise; all host values, peeked and never folded."""
        tel = self.telemetry
        p99 = (tel.registry.read_probe("serve_launch_p99_ms") if tel is not None
               else self._serve_p99())
        shed = 0
        for spoke in self.spokes:
            ctl = spoke.overload
            if ctl is not None:
                shed += ctl.total_shed + ctl.total_throttled
        hubs = list(self.hub_manager.hubs.values())
        shed += sum(h.node.stats.deltas_rejected for h in hubs)
        losses = [h.node.stats.learning_curve[-1] for h in hubs
                  if h.node.stats.learning_curve]
        return {
            "records": self.events.records_seen,
            "serve_p99_ms": p99,
            "shed": shed,
            "loss": sum(losses) / len(losses) if losses else None,
            "last_activity": self.stats.last_activity,
        }

    def _watchdog_eval(self, now: Optional[float] = None) -> None:
        rec = self.events
        if rec is not None and rec.watchdog is not None:
            rec.watchdog.evaluate(self._watchdog_signals(), now)

    def _blackbox_write_errors(self) -> int:
        """Writes the disk refused (black-box dumps and dead-letter file
        appends), mirrored job-wide like events_recorded (max-combined, so
        the heartbeat peek and the terminate fold cannot count twice)."""
        n = self.dead_letter.write_errors
        if self.events is not None:
            n += self.events.journal.write_errors
        return n

    def _emit_heartbeat(self, now: Optional[float] = None) -> None:
        """One incremental ``JobStatistics`` snapshot (``kind="heartbeat"``)
        through the performance sink, carrying the registry snapshot, the
        queue depths and the phase table."""
        tel = self.telemetry
        seq = tel.mark_beat(now)
        self._emit_live_report("heartbeat", seq, self.heartbeat_statistics(), {
            "eventsProcessed": self.events_processed,
            "telemetry": tel.registry.snapshot(),
            "queues": self.queue_depths(),
            "phases": self.phase_table(),
        }, now)

    def phase_table(self, e2e_s: Optional[float] = None) -> dict:
        """The phase-attributed breakdown: the telemetry plane's measured
        read/parse/stage/holdout rings plus the phases clocked elsewhere --
        fit (the spokes' flush StepTimers), serve (their serving
        StepTimers) and ship (the codec's seconds). On a CUDA job fit and
        serve time the host's dispatch and the syncs inside it, not the
        kernels. With ``e2e_s`` each row carries its share of it and
        ``_coverage`` is the attributed fraction."""
        tel = self.telemetry
        profile = tel.phases if tel is not None and tel.phases is not None else PhaseProfile()
        enc, dec = self.codec_seconds()
        extra = {
            "fit": sum(s.step_timer.total_ms for s in self.spokes) / 1e3,
            "serve": sum(s.serve_timer.total_ms for s in self.spokes) / 1e3,
            "ship": enc + dec,
        }
        return profile.table(e2e_s, extra={k: v for k, v in extra.items() if v > 0.0})

    def launch_timing(self) -> dict:
        """The spokes' StepTimers pooled: the fit flush path's per-launch ms
        percentiles (p50, p99) and launches a second, and the serving
        launches' (``serve_*``); the counts are the true totals, the
        percentiles the bounded windows'."""
        pooled = StepTimer("spoke_flush")
        serve = StepTimer("serve_flush")
        for spoke in self.spokes:
            for d in spoke.step_timer._durations_ms:
                pooled.record(d)
            for d in spoke.serve_timer._durations_ms:
                serve.record(d)
        out = pooled.summary()
        ssum = serve.summary()
        out["count"] = sum(s.step_timer.count for s in self.spokes)
        out["serve_count"] = sum(s.serve_timer.count for s in self.spokes)
        out["serve_p50_ms"] = ssum["p50_ms"]
        out["serve_p99_ms"] = ssum["p99_ms"]
        return out

    def codec_seconds(self) -> Tuple[float, float]:
        """(encode, decode) transport-codec seconds summed over every live
        hub and spoke node."""
        enc = dec = 0.0
        nodes = [hub.node for hub in self.hub_manager.hubs.values()]
        nodes += [net.node for spoke in self.spokes for net in spoke.nets.values()]
        for node in nodes:
            if node.codec is not None:
                enc += node.codec.encode_seconds
                dec += node.codec.decode_seconds
        return enc, dec

    # --- event handling ---

    @contextlib.contextmanager
    def _toggle_stack(self):
        """Raise the interpreter's recursion limit by TOGGLE_FRAMES_PER_NET
        frames a net of the fullest spoke while the job handles an event
        (the toggle's nesting), and restore it after."""
        nets = max((len(s.nets) for s in self.spokes), default=0)
        if self._in_event or nets < 2:
            yield
            return
        old = sys.getrecursionlimit()
        self._in_event = True
        sys.setrecursionlimit(old + TOGGLE_FRAMES_PER_NET * nets)
        try:
            yield
        finally:
            sys.setrecursionlimit(old)
            self._in_event = False

    def process_event(self, stream: str, payload: Any) -> None:
        if self.stats.terminated:
            return
        gang = self.hub_manager.gang
        with self._toggle_stack():
            if gang is None or not self._any_cohorts():
                # no live cohort: rounds average inline
                self._process_event_inner(stream, payload)
            else:
                # gang-averaging window: the PS rounds that complete while
                # this event is processed average together at its exit
                with gang.window():
                    self._process_event_inner(stream, payload)
        # the heartbeat and watchdog count clocks: one tick an event (a
        # packed block ticks its rows in process_packed_batch), acting at
        # the event boundary, after the event's own work settled
        if stream != PACKED_STREAM:
            tel = self.telemetry
            if tel is not None and tel.note_records(1):
                self._emit_heartbeat()
            rec = self.events
            if rec is not None and rec.note_records(1):
                self._watchdog_eval()

    def _any_cohorts(self) -> bool:
        return any(s.cohorts is not None and s.cohorts.cohorts for s in self.spokes)

    # --- overload control (runtime/overload.py) ---

    def overload_level(self) -> int:
        """The job's pressure level: the peak over the spokes' overload
        controllers (0, OK, when none is armed). A source loop pauses on it
        while any spoke is CRITICAL, leaving its offsets uncommitted (Flink's
        credit-based backpressure, moved into the runtime)."""
        level = 0
        for spoke in self.spokes:
            if spoke.overload is not None and spoke.overload.level > level:
                level = spoke.overload.level
        return level

    def overload_idle_tick(self) -> None:
        """Advance every controller's count clock while the source is idle
        or paused: nothing admits then, so without these ticks the buckets
        would never refill and a CRITICAL pause could never clear
        (``OverloadController.idle_tick``)."""
        for spoke in self.spokes:
            if spoke.overload is not None:
                spoke.overload.idle_tick()
                # idle capacity drains deferred rows and settles sheds too
                spoke._overload_tick()

    def heartbeat_statistics(self) -> list:
        """Read-only per-pipeline ``Statistics`` snapshots mid-stream: copies
        of the merged hub statistics plus the spoke-side tallies that fold
        at query and terminate (launches, serving, the overload counters,
        the live version), peeked and never taken, so the terminate fold
        still counts each delta once. No score is evaluated (that would
        launch holdout predicts on the hot path); SPMD pipelines report at
        terminate only. Every value is a host counter: no tensor is read."""
        out = []
        for net_id in self.pipeline_manager.live_pipelines:
            if net_id in self.spmd_bridges:
                continue
            merged = self.hub_manager.network_statistics(net_id)
            # every field but the two curve lists is a scalar, so copying the
            # lists makes a deep copy (deepcopy walks the curve point by
            # point, a cost that grows with the stream, on every beat)
            s = (dataclasses.replace(merged, learning_curve=list(merged.learning_curve),
                                     lcx=list(merged.lcx))
                 if merged is not None else Statistics(pipeline=net_id))
            fitted = 0
            for spoke in self.spokes:
                net = spoke.nets.get(net_id)
                if net is None:
                    continue
                s.update_stats(program_launches=net.program_launches,
                               forecasts_served=net.serve_stats.count)
                if net.serve_stats.count:
                    s.note_serve_latency(*net.serve_stats.percentiles())
                # the host-side counter: query_stats() would read the
                # cumulative loss, which checks a cohort member's state out
                # and launches its staged gang fits early
                fitted += int(net.pipeline.fitted)
                ctl = spoke.overload
                if ctl is not None:
                    s.update_stats(forecasts_shed=ctl._shed.get(net_id, 0),
                                   records_throttled=ctl._throttled.get(net_id, 0),
                                   pressure_level=ctl.level_peak)
                if net.lifecycle is not None:
                    s.update_stats(active_version=net.lifecycle.active_version)
                c = net.node.codec
                if c is not None:
                    # live totals less what already folded hub-side
                    s.update_stats(
                        codec_encode_seconds=c.encode_seconds - net._codec_folded[0],
                        codec_decode_seconds=c.decode_seconds - net._codec_folded[1])
            for (nid, _h), hub in self.hub_manager.hubs.items():
                c = getattr(hub.node, "codec", None) if nid == net_id else None
                if c is not None:
                    # hub shards fold at terminate only: the live totals
                    s.update_stats(codec_encode_seconds=c.encode_seconds,
                                   codec_decode_seconds=c.decode_seconds)
            if s.fitted == 0:
                s.fitted = fitted
            if self.dead_letter.record_count:
                s.update_stats(records_quarantined=self.dead_letter.record_count)
            if self.rescales_performed:
                s.update_stats(rescales_performed=self.rescales_performed)
            if self.events is not None and self.events.journal.total:
                s.update_stats(events_recorded=self.events.journal.total,
                               alerts_raised=self.events.journal.alerts)
            nw = self._blackbox_write_errors()
            if nw:
                s.update_stats(blackbox_write_errors=nw)
            out.append(s)
        return out

    def heartbeat_frame(self) -> dict:
        """The compact metrics frame a worker's heartbeat carries to an
        autoscaling supervisor: the pressure level and the host-plane
        signals a staging backlog cannot show (the serve-launch p99, the
        hottest tenant's excess over its fair share, the queued rows), and
        the flight recorder's high-water event id and alert count (0
        unarmed), so a supervisor sees the journal advance without reading
        the black box."""
        p99 = self._serve_p99()
        imbalance = 0.0
        backlog = 0
        for spoke in self.spokes:
            if spoke.overload is not None:
                imbalance = max(imbalance, spoke.overload._hot)
            depths = spoke.queue_depths()
            backlog += depths["serving"] + depths["batcher"] + depths["throttled"]
        journal = self.events.journal if self.events is not None else None
        return {"level": self.overload_level(), "serveP99": round(p99, 3),
                "imbalance": round(imbalance, 3), "backlog": int(backlog),
                "events": journal.high_water if journal is not None else 0,
                "alerts": journal.alerts if journal is not None else 0}

    def queue_depths(self) -> dict:
        """The spokes' queue depths summed (``Spoke.queue_depths``), the
        job's pre-deploy backlog and the pressure level."""
        agg = {"serving": 0, "batcher": 0, "throttled": 0, "paused": 0, "pre_create": 0}
        for spoke in self.spokes:
            for k, v in spoke.queue_depths().items():
                agg[k] += v
        agg["backlog"] = len(self._backlog)
        agg["pressure_level"] = self.overload_level()
        return agg

    def tenant_topology(self) -> dict:
        """Where the co-hosted tenants run: the device count, the widest
        tenant-mesh shard count (1: the port runs a cohort on one device),
        each live cohort's active members a shard, the live queue depths
        and each lifecycle-armed pipeline's registry view (worker 0's
        replica: the canary clocks are per spoke)."""
        topo = {
            "devices": torch.cuda.device_count() if self.device.type == "cuda" else 1,
            "cohort_shards": 1,
            "placement": [],
            "queues": self.queue_depths(),
            "lifecycle": {},
        }
        for spoke in self.spokes:
            for net_id, net in spoke.nets.items():
                if net.lifecycle is not None:
                    topo["lifecycle"].setdefault(net_id, net.lifecycle.describe())
        for spoke in self.spokes:
            if spoke.cohorts is None:
                continue
            for cohort in spoke.cohorts.cohorts.values():
                topo["cohort_shards"] = max(topo["cohort_shards"], cohort.n_shards)
                topo["placement"].append(cohort.shard_placement())
        return topo

    def _process_event_inner(self, stream: str, payload: Any) -> None:
        self.events_processed += 1
        if stream == REQUEST_STREAM:
            if isinstance(payload, Request):
                request = payload
            else:
                request = Request.from_json(payload)
                if request is None:
                    self.dead_letter.quarantine(stream, payload, "malformed_request")
            if request is not None:
                self._handle_request(request)
        elif stream in (TRAINING_STREAM, FORECASTING_STREAM):
            if isinstance(payload, DataInstance):
                inst = payload
            else:
                ph = self.telemetry.phases if self.telemetry is not None else None
                if ph is None:
                    inst, reason = DataInstance.parse(payload)
                else:
                    with ph.phase("parse"):
                        inst, reason = DataInstance.parse(payload)
                if reason is not None:
                    # EOS markers / blank lines return (None, None)
                    self.dead_letter.quarantine(stream, payload, reason)
            if inst is not None:
                if stream == FORECASTING_STREAM:
                    inst.operation = FORECASTING
                self._handle_data(inst)
                if self._burst is not None:
                    # the seeded burst: tenant-addressed copies of this
                    # forecast flood the hot tenant
                    for clone in self._burst.clones(inst):
                        self._handle_data(clone)
        elif stream == PACKED_STREAM:
            self.process_packed_batch(*payload)

    def _handle_request(self, request: Request) -> None:
        self.stats.mark_activity()
        err = self.pipeline_manager.validate(request)
        if err is not None:
            self.dead_letter.quarantine(
                REQUEST_STREAM, request.to_json(), "rejected_request", detail=err,
            )
            return
        self.pipeline_manager.apply(request)
        if request.request in (RequestType.CREATE, RequestType.UPDATE):
            dim = self._request_dim(request)
            if dim is None:
                # an Update reuses the live pipeline's dim
                dim = self._dims.get(request.id)
            if dim is None:
                # a record already buffered can pin the dim
                dim = self._infer_dim_from_buffers(request)
            if dim is None:
                self._pending_creates.append(request)
                return
            self._deploy(request, dim)
        elif request.request == RequestType.DELETE:
            for spoke in self.spokes:
                spoke.handle_request(request, 0)
            self.hub_manager.delete_network(request.id)
            self.spmd_bridges.pop(request.id, None)
            self._dims.pop(request.id, None)
            self._pending_creates = [
                r for r in self._pending_creates if r.id != request.id
            ]
        elif request.request in LIFECYCLE_REQUESTS:
            # Shadow / Promote / Rollback passed the gate's structural
            # check; the ARMING check needs the job-wide default spec, so it
            # lives here: a verb aimed at an SPMD pipeline or an unarmed one
            # is quarantined instead of vanishing
            if request.id in self.spmd_bridges:
                self.dead_letter.quarantine(
                    REQUEST_STREAM, request.to_json(), "rejected_request",
                    detail="lifecycle verbs are host-plane only")
                return
            if request.id not in self._dims:
                # admitted but not deployed yet: no worker hosts it (an
                # early Query's rule)
                return
            live = self.pipeline_manager.node_map.get(request.id)
            armed = live is not None and lifecycle_config(
                live.training_configuration, self.config.lifecycle) is not None
            if armed and live.learner is not None and (
                    (live.learner.data_structure or {}).get("sparse")):
                # a job-wide default does not arm a sparse net (its
                # SpokeNet keeps lifecycle None)
                armed = False
            if not armed:
                self.dead_letter.quarantine(
                    REQUEST_STREAM, request.to_json(), "rejected_request",
                    detail=f"lifecycle plane not armed for pipeline {request.id}")
                return
            for spoke in self.spokes:
                spoke.handle_request(request, self._dims.get(request.id, 0))
        elif request.request == RequestType.QUERY:
            if request.id not in self._dims:
                # admitted but not deployed yet: no worker hosts it
                return
            rid = request.request_id if request.request_id is not None else 0
            bridge = self.spmd_bridges.get(request.id)
            if bridge is not None:
                # the fleet is one logical model: a single fragment set
                self.response_merger.expect(rid, 1)
                bridge.emit_query_response(rid)
                return
            targets = self.pipeline_manager.query_targets(
                request, self.config.parallelism
            )
            self.response_merger.expect(rid, len(targets))
            for w in targets:
                self.spokes[w].handle_request(request, self._dims[request.id])

    def _infer_dim_from_buffers(self, request: Request) -> Optional[int]:
        hash_dims = int(request.training_configuration.extra.get("hashDims", 0))
        head = self._backlog.peek()  # oldest pre-create entry
        if head is not None:
            if head[0] == "inst":
                return Vectorizer.infer_dim(head[1], hash_dims)
            # packed rows already include any hashed-categorical region
            return int(head[1][0].shape[1])
        for spoke in self.spokes:
            for inst in spoke.record_buffer:
                return Vectorizer.infer_dim(inst, hash_dims)
            packed_dim = spoke.buffered_packed_dim()
            if packed_dim is not None:
                return packed_dim
        return None

    def _replay_backlog(self) -> None:
        for entry in self._backlog.drain():
            if entry[0] == "inst":
                self._handle_data(entry[1])
            else:
                self.process_packed_batch(*entry[1])

    def _request_dim(self, request: Request) -> Optional[int]:
        """Feature dim from the request's dataStructure (nFeatures), else
        None: deferred until the first data record arrives."""
        ds = request.learner.data_structure if request.learner else None
        if ds and "nFeatures" in ds:
            if ds.get("sparse"):
                # sparse widths are exact: hashSpace lives inside nFeatures
                # and the dense hashDims knob does not apply to the COO path
                return int(ds["nFeatures"])
            return int(ds["nFeatures"]) + int(
                request.training_configuration.extra.get("hashDims", 0)
            )
        return None

    def _deploy(self, request: Request, dim: int) -> None:
        """Create the pipeline on every worker and its hub shard(s)
        (PipelineMap.scala:54-57, FlinkSpoke.scala:220-222), or on the SPMD
        engine when the request asks for it and the engine hosts it. The
        first pipeline whose table arms the telemetry plane or the flight
        recorder arms it for the job (the gate validated the table)."""
        if self.telemetry is None:
            tel_cfg = telemetry_config(request.training_configuration,
                                       self.config.telemetry)
            if tel_cfg is not None:
                self._arm_telemetry(tel_cfg)
        if self.events is None:
            ev_cfg = events_config(request.training_configuration, self.config.events)
            if ev_cfg is not None:
                self._arm_events(ev_cfg)
        use_spmd = spmd_engine_requested(request) and spmd_engine_supported(request)
        if request.id in self._dims:
            # an Update tears down the previous deployment, on either plane
            self.hub_manager.delete_network(request.id)
            self.spmd_bridges.pop(request.id, None)
            if use_spmd:
                # clear the stale host-plane nets when switching planes
                delete = dataclasses.replace(request, request=RequestType.DELETE)
                for spoke in self.spokes:
                    spoke.handle_request(delete, 0)
        self._dims[request.id] = dim
        if use_spmd:
            self.spmd_bridges[request.id] = make_spmd_bridge(
                request, dim, self.config, self._emit_prediction,
                self._route_response_fragment, self.device,
            )
            self._replay_backlog()
            return
        for spoke in self.spokes:
            spoke.handle_request(request, dim)
        for h in range(request.training_configuration.hub_parallelism):
            self.hub_manager.create_hub(request, h, dim)
        self._replay_backlog()

    def rescale(self, n_new: int) -> None:
        """Live parallelism change, mid-stream, without a restart -- the
        runtime analogue of the reference's elastic rescale
        (spokeParallelism bump, wrapper merge and mergingDataBuffers,
        FlinkSpoke.scala:345-348, SpokeLogic.scala:37-50):

        - grow: new spokes spawn and every live host-plane pipeline deploys
          on them, each new replica seeded from spoke 0's model;
        - shrink: retiring spokes merge into survivor ``id % n_new``
          (``Spoke.absorb``);
        - every spoke and hub shard learns the new worker count (barrier
          counts, the termination countdown and score normalization follow
          ``config.parallelism``).

        SPMD-engine pipelines keep their mesh (dp is bound to the devices,
        not to the virtual worker count). With the flight recorder armed the
        rescale is an incident: recorded, the ring dumped, and the journal's
        transport epoch bumped (reused worker slots restart their sequence
        counters, which the bundle merge must not compare with older ones)."""
        p = len(self.spokes)
        if n_new == p:
            return
        if n_new < 1:
            raise ValueError(f"parallelism must be >= 1, got {n_new}")
        self.rescales_performed += 1
        if self.events is not None:
            self.events.journal.record(RESCALE, "live_rescale", from_procs=p,
                                       to_procs=n_new)
            self.events.journal.incident("rescale")
            self.events.journal.bump_epoch()
        if n_new > p:
            for w in range(p, n_new):
                self.spokes.append(self._spawn_spoke(w))
            self.config.parallelism = n_new
            for net_id, request in self.pipeline_manager.node_map.items():
                if net_id in self.spmd_bridges:
                    continue
                dim = self._dims.get(net_id)
                if dim is None:
                    continue
                src = self.spokes[0].nets.get(net_id)
                deploy = request
                if src is not None:
                    # pin the RESOLVED protocol: a pipeline created at
                    # parallelism 1 was forced to CentralizedTraining
                    # (FlinkSpoke.scala:213-215); re-resolving at the new
                    # parallelism would hand the new workers a protocol the
                    # live hub does not speak
                    deploy = dataclasses.replace(
                        request,
                        training_configuration=dataclasses.replace(
                            request.training_configuration, protocol=src.protocol),
                    )
                for w in range(p, n_new):
                    self.spokes[w].handle_request(deploy, dim)
                    dst = self.spokes[w].nets.get(net_id)
                    if src is None or dst is None:
                        continue
                    # seed the new replica from the fleet's current model (a
                    # fresh init would drag the next average back toward
                    # it); the deep copy gives it buffers of its own, since
                    # a fit gives its state up
                    state = copy.deepcopy(src.pipeline.state)
                    state["fitted"] = dst.pipeline.state["fitted"]
                    state["cum_loss"] = dst.pipeline.state["cum_loss"]
                    dst.pipeline.state = state
                    # drift baselines, codec streams and the guard's ring
                    # restart at the seeded model
                    dst.node.on_model_seeded()
                    if dst.node.codec is not None:
                        dst.node.codec.reset_streams()
                    if dst.pipeline.guard is not None:
                        dst.pipeline.guard.reseed(dst.pipeline)
                    self._replicate_lifecycle(src, dst)
        else:
            survivors, retired = self.spokes[:n_new], self.spokes[n_new:]
            self.config.parallelism = n_new
            for r in retired:
                survivors[r.worker_id % n_new].absorb(r)
            self.spokes = survivors
        for spoke in self.spokes:
            spoke.set_parallelism(n_new)
        self.hub_manager.set_parallelism(n_new)

    @staticmethod
    def _replicate_lifecycle(src, dst) -> None:
        """Replicate a live lifecycle registry (a candidate in flight, or a
        promoted active version) onto a grown spoke's net through the
        checkpoint's restore recipe; otherwise the new spoke would train no
        candidate, and a canary whose training rows land there would stall."""
        if src.lifecycle is None or dst.lifecycle is None or (
                src.lifecycle.candidate is None and src.lifecycle.active_version == 0):
            return
        from omldm_tpu_torch.checkpoint.checkpoint import _pipeline_snapshot

        fresh_fitted = dst.pipeline.state["fitted"]
        fresh_loss = dst.pipeline.state["cum_loss"]
        swapped = dst.lifecycle.restore(dst, src.lifecycle.snapshot(),
                                        _pipeline_snapshot(src.pipeline))
        # the replica's statistics start fresh: the source spoke keeps its
        # unfolded counter deltas (copying them would count them twice)
        for k in dst.lifecycle._pending:
            dst.lifecycle._pending[k] = 0
            dst.lifecycle.totals[k] = 0
        if swapped:
            # restore installed the PROMOTED-spec pipeline with src's whole
            # state: seed it as a fresh replica again (own counters zero,
            # drift baseline, codec streams and guard ring at the seed)
            state = dst.pipeline.state
            state["fitted"] = fresh_fitted
            state["cum_loss"] = fresh_loss
            dst.pipeline.state = state
            dst.node.on_model_seeded()
            if dst.node.codec is not None:
                dst.node.codec.reset_streams()
            if dst.pipeline.guard is not None:
                dst.pipeline.guard.reseed(dst.pipeline)

    def _handle_data(self, inst: DataInstance) -> None:
        self.stats.mark_activity()
        # records are the liveness clock: a silent worker that blocks the
        # fleet on a barrier stops every protocol message (one flag read
        # when no pipeline armed a quorum)
        self.hub_manager.check_liveness()
        if self._pending_creates:
            pending, self._pending_creates = self._pending_creates, []
            for request in pending:
                hash_dims = int(
                    request.training_configuration.extra.get("hashDims", 0)
                )
                self._deploy(request, Vectorizer.infer_dim(inst, hash_dims))
        if not self._dims:
            # nothing deployed yet: hold for replay on the first deploy
            self._backlog.append(("inst", inst))
            return
        spoke = self.spokes[self._rr % len(self.spokes)]
        self._rr += 1
        spoke.handle_data(inst)
        # SPMD-engine pipelines see every record (the bridge spreads them
        # across its workers)
        for bridge in self.spmd_bridges.values():
            bridge.handle_data(inst)

    def process_packed_batch(self, x: np.ndarray, y: np.ndarray, op: np.ndarray) -> None:
        """Bulk data path: pre-vectorized rows from the native parser
        (``runtime.fast_ingest.PackedBatcher``). Rows are dealt exactly as
        per-record events would be: a strided round-robin share a spoke,
        continuing the ``_rr`` cycle, so packed and per-record events can
        interleave. Callers may call this directly, not only through
        :meth:`process_event`, so the gang-averaging window opens here too
        (it counts its depth: nested, it flushes at the outer exit). The
        heartbeat and watchdog clocks tick by the block's rows, so their
        cadence is the record sequence's whichever route carried it (and a
        cadence below the block size acts once a block)."""
        gang = self.hub_manager.gang
        with self._toggle_stack():
            if gang is None or not self._any_cohorts():
                self._process_packed_inner(x, y, op)
            else:
                with gang.window():
                    self._process_packed_inner(x, y, op)
        if self.stats.terminated:
            return
        tel = self.telemetry
        if tel is not None and tel.note_records(int(x.shape[0])):
            self._emit_heartbeat()
        rec = self.events
        if rec is not None and rec.note_records(int(x.shape[0])):
            self._watchdog_eval()

    def _process_packed_inner(self, x: np.ndarray, y: np.ndarray, op: np.ndarray) -> None:
        n = x.shape[0]
        if n == 0 or self.stats.terminated:
            return
        self.stats.mark_activity()
        self.hub_manager.check_liveness()
        if self._pending_creates:
            pending, self._pending_creates = self._pending_creates, []
            for request in pending:
                self._deploy(request, int(x.shape[1]))
        if not self._dims:
            self._backlog.append((PACKED, (x, y, op), None, None))
            return
        p = len(self.spokes)
        for w in range(p):
            start = (w - self._rr) % p
            if start < n:
                self.spokes[w].handle_packed(x[start::p], y[start::p], op[start::p])
        self._rr += n
        for bridge in self.spmd_bridges.values():
            bridge.handle_batch(x, y, op)

    def ensure_deployed(self, dim: int) -> None:
        """Deploy any Create still waiting on a feature width: the CLI's
        file route knows the width up front (flags, the Create, or the
        file's first record) instead of from the first data record."""
        if self._pending_creates:
            pending, self._pending_creates = self._pending_creates, []
            for request in pending:
                self._deploy(request, dim)

    def fused_file_bridge(self):
        """The single SPMD bridge qualifying for the fused C file ingest, or
        None. The fused route bypasses the per-event loop, so it is taken
        only when that loop would have nothing else to do: exactly one
        deployed pipeline, on the SPMD engine, and no pending work."""
        if self._pending_creates or self._backlog or self.stats.terminated:
            return None
        if len(self.spmd_bridges) != 1:
            return None
        if any(net_id not in self.spmd_bridges for net_id in self._dims):
            return None  # host-plane pipelines also consume the stream
        bridge = next(iter(self.spmd_bridges.values()))
        return bridge if bridge.supports_fused_ingest() else None

    def run_file_fused(self, path: str) -> bool:
        """Consume a JSON-lines training file through the fused C ingest.
        Returns False when the job does not qualify (callers fall back to
        the packed event route). A pipeline that is not SSP-paced takes the
        double-buffered route: the parse thread fills stage k+1 while the
        dispatch thread trains stage k, with results bit-identical to the
        serial loop."""
        bridge = self.fused_file_bridge()
        if bridge is None:
            return False
        if bridge.supports_overlapped_ingest():
            bridge.ingest_file_overlapped(path, on_chunk=self.stats.mark_activity)
        else:
            bridge.ingest_file(path, on_chunk=self.stats.mark_activity)
        return True

    def run_file(self, path: str, dim: Optional[int] = None, hash_dims: int = 0) -> bool:
        """The file router: the sharded ingest plane when ``JobConfig.ingest``
        is armed, else the fused C route. False when no route qualifies:
        callers fall back to the packed or per-record event loops."""
        if self.ingest_cfg is not None:
            return self.run_file_sharded(path, dim=dim, hash_dims=hash_dims)
        return self.run_file_fused(path)

    def run_file_sharded(self, path: str, dim: Optional[int] = None, hash_dims: int = 0) -> bool:
        """Consume a JSON-lines training file through the sharded ingest
        plane: N parser processes stripe the file's byte-grid chunks and
        hand row blocks back through shared-memory rings; the driver
        replays them in ascending chunk order through
        ``process_packed_batch``, so the row order -- and every fitted,
        holdout and prediction sequence -- is bit-identical to ingest in
        one process. With ``device=on``, the SPMD bridges that can keep
        their stage and holdout ring on the device do so.

        A dead or wedged parser degrades to in-process parsing from the
        wounded chunk on (reason-coded with the selfheal class, and
        journalled as a DEGRADE when the flight recorder is armed) instead
        of wedging the driver. While the run is live, the driver's
        starvation and the prefetch ring's emptiness feed every armed
        overload controller as ``extra_signals`` probes."""
        if self.ingest_cfg is None:
            return False
        if dim is None:
            if not self._dims:
                return False
            dim = next(iter(self._dims.values()))
        self.ensure_deployed(dim)
        if self.ingest_cfg.device:
            for bridge in self.spmd_bridges.values():
                bridge.enable_resident_ingest()  # a bridge it cannot serve stays on the host

        def on_degrade(info: dict) -> None:
            if self.events is not None:
                self.events.journal.record(
                    DEGRADE, f"ingest_worker_{info['class']}", worker=info["worker"],
                    returncode=info["returncode"], chunk=info["chunk"],
                )

        si = ShardedIngest(path, dim, self.ingest_cfg, hash_dims=hash_dims,
                           on_degrade=on_degrade)
        pf = Prefetcher(si.blocks(), depth=2)
        probes = {
            "ingest_starvation": lambda: (si.starvation(), 0.5, 0.9),
            "ingest_prefetch": pf.as_signal(),
        }
        for name, fn in probes.items():
            for spoke in self.spokes:
                spoke.attach_ingest_probe(name, fn)
        try:
            for x, y, op in pf:
                self.process_packed_batch(x, y, op)
        finally:
            pf.close()
            si.close()
            for name in probes:
                for spoke in self.spokes:
                    spoke.detach_ingest_probe(name)
            st = si.stats()
            st["starvation"] = si.starvation()
            if si.degraded is not None:
                st["degraded"] = dict(si.degraded)
            self._ingest_stats = st
            # the phase table: the shards' parse seconds into "parse" (summed
            # across the worker processes: on a host of many cores they
            # overlap in wall time) and the driver's ring wait into "read"
            tel = self.telemetry
            if tel is not None and tel.phases is not None:
                if st["parse_s"] > 0:
                    tel.phases.note("parse", st["parse_s"])
                if st["driver_wait_s"] > 0:
                    tel.phases.note("read", st["driver_wait_s"])
        return True

    # --- run loop ---

    def run(
        self,
        events: Iterable[Tuple[str, Any]],
        terminate_on_end: bool = True,
    ) -> Optional[JobStatistics]:
        """Replay an ordered event stream; fires the termination protocol at
        stream end (the deterministic equivalent of the silence timer)."""
        for stream, payload in events:
            if self.stats.terminated:
                break
            self.process_event(stream, payload)
            if self.checkpoint_manager is not None:
                self.checkpoint_manager.maybe_save(self)
        if terminate_on_end and not self.stats.terminated:
            return self.terminate()
        return self.performance[-1] if self.performance else None

    def check_silence(self, now: Optional[float] = None) -> Optional[JobStatistics]:
        """Live-mode hook: the serving plane's deadline clock (a queued
        forecast whose maxDelayMs elapses while the stream is silent must
        not wait for the next record), then the termination probe once the
        silence timeout elapsed (StatisticsOperator.scala:135-142). With the
        telemetry plane armed, a stream with records pending since the last
        heartbeat reports after ``idleMs``; with a silence rule armed, the
        watchdog polls it (both wall-clocked: the count clocks cannot move
        while nothing flows)."""
        for spoke in self.spokes:
            spoke.poll_serving()
        tel = self.telemetry
        if tel is not None and not self.stats.terminated and tel.idle_due(now):
            self._emit_heartbeat(now)
        rec = self.events
        if rec is not None and rec.watchdog is not None and not self.stats.terminated:
            rec.watchdog.poll_silence(self.stats.last_activity, now)
        if self.stats.silence_exceeded(now):
            return self.terminate()
        return None

    def terminate(self) -> Optional[JobStatistics]:
        """The termination protocol: probe every worker, fold hub state,
        count fragments, normalize, emit JobStatistics."""
        if self.stats.terminated:
            return self.performance[-1] if self.performance else None
        with self._toggle_stack():
            # the fault window ends with the stream: the chaos channels
            # quiesce (held traffic flushes, later sends pass through) and
            # the receive windows hand back what a never-filled gap held
            for chaos in (self._chaos_up, self._chaos_down):
                if chaos is not None:
                    chaos.quiesce()
            for spoke in self.spokes:
                spoke.flush_rx_windows()
            self.hub_manager.flush_windows()
            self.stats.probe_fired = True
            for spoke in self.spokes:
                spoke.handle_terminate_probe()
        # the quarantined-record, rescale and flight-recorder counts are
        # job-level, mirrored into every pipeline's report
        nq = self.dead_letter.record_count
        nr = self.rescales_performed
        ne = na = 0
        if self.events is not None:
            self.events.journal.record(TERMINATE, "termination_protocol")
            ne = self.events.journal.total
            na = self.events.journal.alerts
        nw = self._blackbox_write_errors()
        folds = {}
        if nq:
            folds["records_quarantined"] = nq
        if nr:
            folds["rescales_performed"] = nr
        if ne:
            folds.update(events_recorded=ne, alerts_raised=na)
        if nw:
            folds["blackbox_write_errors"] = nw
        for bridge in self.spmd_bridges.values():
            bridge.handle_terminate_probe()
            bridge_stats = bridge.network_statistics()
            if folds:
                bridge_stats.update_stats(**folds)
            self.stats.add_hub_statistics(bridge.request.id, bridge_stats)
        self.hub_manager.on_terminate()
        for net_id in self.pipeline_manager.live_pipelines:
            merged = self.hub_manager.network_statistics(net_id)
            if merged is not None:
                if folds:
                    merged.update_stats(**folds)
                merged.normalize(
                    max(len([k for k in self.hub_manager.hubs if k[0] == net_id]), 1)
                )
                self.stats.add_hub_statistics(net_id, merged)
        # every queue must be empty after the probe's drain cascade: the
        # overload gates read this snapshot for stranded rows
        self.terminate_accounting = self.queue_depths()
        report = self.stats.try_finalize(len(self.pipeline_manager.live_pipelines))
        self.dead_letter.close()
        # the span file closes; the final report above is the plain
        # terminate-time JobStatistics (heartbeats only add entries)
        if self.telemetry is not None:
            self.telemetry.close()
        # the final black-box dump: this process's last word in a bundle
        if self.events is not None:
            self.events.journal.dump()
        return report
