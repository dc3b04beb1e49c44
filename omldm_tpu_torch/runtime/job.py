"""StreamJob: assembles spokes, hubs, control plane, statistics and sinks.

Counterpart of ``omldm_tpu/runtime/job.py`` (the reference's ``Job`` +
``FlinkLearning``, Job.scala:28-171) on its host-plane route: training and
forecasting records and requests in; predictions, merged query responses
and the final ``JobStatistics`` out. The job consumes an ordered event
iterable of ``(stream, payload)`` pairs and runs the termination protocol
at stream end.

Every pipeline's state lives on the job's ``torch.device``: CUDA unless the
caller asks for the CPU. There is no fallback -- a job asked for CUDA on a
host without a card raises. A ``JobConfig`` that arms a plane the port does
not have yet raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, List, Optional, Tuple

from omldm_tpu_torch.api.data import FORECASTING, DataInstance, Prediction
from omldm_tpu_torch.api.requests import Request, RequestType
from omldm_tpu_torch.api.responses import TERMINATION_RESPONSE_ID, QueryResponse
from omldm_tpu_torch.api.stats import JobStatistics
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime.control import PipelineManager
from omldm_tpu_torch.runtime.deadletter import DeadLetterSink
from omldm_tpu_torch.runtime.hub import HubManager
from omldm_tpu_torch.runtime.responses import ResponseMerger
from omldm_tpu_torch.runtime.spoke import Spoke, _PauseBuffer
from omldm_tpu_torch.runtime.stats import StatisticsCollector
from omldm_tpu_torch.runtime.vectorizer import Vectorizer
from omldm_tpu_torch.utils.device import resolve_device

# event stream names (the reference's Kafka topics)
TRAINING_STREAM = "trainingData"
FORECASTING_STREAM = "forecastingData"
REQUEST_STREAM = "requests"

# rows held for pipelines that have not been created yet, before the FIRST
# deploy (the reference's recordBuffer cap, SpokeLogic.scala:31-35)
PRE_CREATE_BACKLOG_CAP = 100_000


def unported_job_options(config: JobConfig) -> List[str]:
    """The JobConfig options that arm a plane the port does not have yet."""
    names = [
        name for name in ("serving", "overload", "lifecycle", "telemetry",
                          "events", "ingest", "chaos")
        if getattr(config, name)
    ]
    if os.environ.get("OMLDM_CHAOS"):
        names.append("chaos (OMLDM_CHAOS)")
    if config.checkpointing:
        names.append("checkpointing")
    if str(config.cohort).lower() == "on":
        names.append("cohort='on'")
    if str(config.cohort_shards).lower() != "off":
        names.append(f"cohort_shards={config.cohort_shards!r}")
    return names


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
        missing = unported_job_options(self.config)
        if missing:
            raise NotImplementedError(
                "omldm_tpu_torch does not port these JobConfig options yet: "
                + ", ".join(missing)
            )
        self.device = resolve_device(device, "StreamJob")
        self.predictions: List[Prediction] = []
        self.responses: List[QueryResponse] = []
        self.performance: List[JobStatistics] = []
        self._on_prediction = on_prediction
        self._on_response = on_response
        self._on_performance = on_performance
        self.pipeline_manager = PipelineManager(self.config.parallelism)
        self.stats = StatisticsCollector(self.config, self._emit_performance)
        self.dead_letter = DeadLetterSink(
            path=self.config.dead_letter_path,
            cap=self.config.dead_letter_cap,
            request_stream=REQUEST_STREAM,
        )
        self.response_merger = ResponseMerger(self._emit_response)
        self.hub_manager = HubManager(self.config, self._reply_to_spoke)
        self.spokes: List[Spoke] = [
            Spoke(
                worker_id=i,
                config=self.config,
                send_to_hub=self.hub_manager.route,
                emit_prediction=self._emit_prediction,
                emit_response=self._route_response_fragment,
                on_poll=self.stats.mark_activity,
                device=self.device,
                note_wire=self._note_wire,
            )
            for i in range(self.config.parallelism)
        ]
        self.predictions_trimmed = 0
        self.responses_trimmed = 0
        self._rr = 0  # round-robin data partitioner (the reference rebalances)
        self._pending_creates: List[Request] = []  # awaiting dim inference
        self._dims: dict = {}  # network_id -> feature dim
        # data that arrives before ANY pipeline is deployed, replayed through
        # the normal routing on the first deploy
        self._backlog = _PauseBuffer(PRE_CREATE_BACKLOG_CAP)

    # --- sinks ---

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

    def _reply_to_spoke(self, network_id: int, hub_id: int, worker_id: int,
                        op: str, payload: Any) -> None:
        if worker_id >= len(self.spokes):
            return
        self.spokes[worker_id].receive_from_hub(network_id, hub_id, op, payload)

    def _note_wire(self, network_id: int, hub_id: int, counter: str, n) -> None:
        """Spoke-side tallies (program launches, serving telemetry) fold into
        the pipeline's hub statistics so one report carries both sides."""
        hub = self.hub_manager.hubs.get((network_id, hub_id))
        if hub is None:
            return
        if counter == "serve_latency_ms":
            hub.node.stats.note_serve_latency(*n)
        else:
            hub.node.stats.update_stats(**{counter: n})

    # --- event handling ---

    def process_event(self, stream: str, payload: Any) -> None:
        if self.stats.terminated:
            return
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
                inst, reason = DataInstance.parse(payload)
                if reason is not None:
                    # EOS markers / blank lines return (None, None)
                    self.dead_letter.quarantine(stream, payload, reason)
            if inst is not None:
                if stream == FORECASTING_STREAM:
                    inst.operation = FORECASTING
                self._handle_data(inst)

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
            self._dims.pop(request.id, None)
            self._pending_creates = [
                r for r in self._pending_creates if r.id != request.id
            ]
        elif request.request == RequestType.QUERY:
            if request.id not in self._dims:
                # admitted but not deployed yet: no worker hosts it
                return
            rid = request.request_id if request.request_id is not None else 0
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
            return Vectorizer.infer_dim(head[1], hash_dims)
        for spoke in self.spokes:
            for inst in spoke.record_buffer:
                return Vectorizer.infer_dim(inst, hash_dims)
        return None

    def _replay_backlog(self) -> None:
        for _, inst in self._backlog.drain():
            self._handle_data(inst)

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
        (PipelineMap.scala:54-57, FlinkSpoke.scala:220-222)."""
        if request.id in self._dims:
            # an Update tears down the previous deployment
            self.hub_manager.delete_network(request.id)
        self._dims[request.id] = dim
        for spoke in self.spokes:
            spoke.handle_request(request, dim)
        for h in range(request.training_configuration.hub_parallelism):
            self.hub_manager.create_hub(request, h)
        self._replay_backlog()

    def _handle_data(self, inst: DataInstance) -> None:
        self.stats.mark_activity()
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
        if terminate_on_end and not self.stats.terminated:
            return self.terminate()
        return self.performance[-1] if self.performance else None

    def terminate(self) -> Optional[JobStatistics]:
        """The termination protocol: probe every worker, fold hub state,
        count fragments, normalize, emit JobStatistics."""
        if self.stats.terminated:
            return self.performance[-1] if self.performance else None
        self.stats.probe_fired = True
        for spoke in self.spokes:
            spoke.handle_terminate_probe()
        # quarantined-record count, mirrored into every pipeline's report
        nq = self.dead_letter.record_count
        for net_id in self.pipeline_manager.live_pipelines:
            merged = self.hub_manager.network_statistics(net_id)
            if merged is not None:
                if nq:
                    merged.update_stats(records_quarantined=nq)
                merged.normalize(
                    max(len([k for k in self.hub_manager.hubs if k[0] == net_id]), 1)
                )
                self.stats.add_hub_statistics(net_id, merged)
        report = self.stats.try_finalize(len(self.pipeline_manager.live_pipelines))
        self.dead_letter.close()
        return report
