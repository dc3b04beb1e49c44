"""Spoke: the worker-side runtime hosting pipeline replicas.

Counterpart of ``omldm_tpu/runtime/spoke.py`` (the reference's
``FlinkSpoke`` + ``SpokeLogic``, FlinkSpoke.scala:28-356) on its bare
per-record route: one node per pipeline, every record fanned out to all
hosted pipelines, the 20% holdout (counts 8 and 9 of each 0-9 cycle go to
a sliding test set whose evicted points are trained,
FlinkSpoke.scala:94-104), a poll marker every 100 training records,
forecasts answered immediately, and records arriving before any pipeline
buffered (SpokeLogic.scala:31-35). The serving, overload, lifecycle,
cohort, guard, telemetry, events, reliable-channel and packed-ingest
branches are not ported.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.data import FORECASTING, DataInstance, Prediction
from omldm_tpu_torch.api.requests import Request, RequestType
from omldm_tpu_torch.api.responses import TERMINATION_RESPONSE_ID, QueryResponse
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.protocols.registry import make_worker_node, resolve_protocol
from omldm_tpu_torch.runtime.databuffers import DataSet
from omldm_tpu_torch.runtime.serving import ServeStats
from omldm_tpu_torch.runtime.vectorizer import F32_MAX, MicroBatcher, Vectorizer
from omldm_tpu_torch.utils.tracing import StepTimer


def create_pipeline(request: Request, dim: int, device) -> MLPipeline:
    """The Create-request pipeline recipe: a generator seeded from the
    request id (where the JAX package keys ``jax.random.PRNGKey(request.id)``)
    and the per-record mode."""
    tc = request.training_configuration
    return MLPipeline(
        request.learner,
        request.preprocessors,
        dim=dim,
        generator=torch.Generator().manual_seed(request.id),
        per_record=tc.per_record,
        device=device,
    )


class _PauseBuffer:
    """Bounded hold buffer for records of a PAUSED net (cooperative toggle)
    and the job's pre-create backlog: beyond the cap the OLDEST entries drop
    (keep-newest eviction, SpokeLogic.scala:31-35)."""

    def __init__(self, cap: int):
        self.cap = cap
        self._entries: Deque[tuple] = collections.deque()

    def append(self, entry: tuple) -> None:
        self._entries.append(entry)
        while len(self._entries) > self.cap:
            self._entries.popleft()

    def peek(self):
        """Oldest held entry, or None."""
        return self._entries[0] if self._entries else None

    def drain(self) -> List[tuple]:
        entries, self._entries = list(self._entries), collections.deque()
        return entries


class SpokeNet:
    """Per-(spoke, networkId) state: worker node + batcher + holdout set."""

    def __init__(self, request: Request, worker_id: int, n_workers: int,
                 dim: int, config: JobConfig, send, device,
                 timer: Optional[StepTimer] = None):
        self.request = request
        self._timer = timer
        tc = request.training_configuration
        self.protocol = resolve_protocol(
            tc.protocol, request.learner.name, n_workers
        )
        batch = int(tc.mini_batch_size or config.batch_size)
        self.vectorizer = Vectorizer(dim, int(tc.extra.get("hashDims", 0)))
        self.batcher = MicroBatcher(dim, batch)
        pipeline = create_pipeline(request, dim, device)
        self.node = make_worker_node(
            self.protocol, pipeline, worker_id, n_workers, tc, send
        )
        # program-launch accounting (Statistics.programLaunches), folded into
        # the pipeline's hub statistics at query/terminate
        self.program_launches = 0
        pipeline.on_launch = self._note_launch
        self.serve_stats = ServeStats()
        self.test_set: DataSet[Tuple[np.ndarray, float]] = DataSet(
            config.test_set_size
        )
        self.holdout_count = 0
        # records arriving while this net is PAUSED (cooperative toggle,
        # FlinkSpoke.scala:127-131) buffer here and drain on resume
        self.pause_buffer = _PauseBuffer(config.record_buffer_cap)

    @property
    def pipeline(self) -> MLPipeline:
        return self.node.pipeline

    def _note_launch(self) -> None:
        self.program_launches += 1

    def flush_batch(self) -> None:
        flushed = self.batcher.flush()
        if flushed is None:
            return
        if self._timer is not None:
            with self._timer:
                self.node.on_training_batch(*flushed)
        else:
            self.node.on_training_batch(*flushed)

    def test_arrays(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        if self.test_set.is_empty:
            return None
        pts = self.test_set.to_list()
        x = np.stack([p[0] for p in pts])
        y = np.asarray([p[1] for p in pts], np.float32)
        return x, y, np.ones((len(pts),), np.float32)


class Spoke:
    """One logical worker (a Flink subtask in the reference)."""

    def __init__(
        self,
        worker_id: int,
        config: JobConfig,
        send_to_hub: Callable,   # (network_id, hub_id, worker_id, op, payload)
        emit_prediction: Callable[[Prediction], None],
        emit_response: Callable[[QueryResponse], None],
        on_poll: Callable[[], None],
        device,
        # (network_id, hub_id, counter, value): an int for the additive
        # counters, a (p50, p99, p999) triple for serve_latency_ms
        note_wire: Optional[Callable[[int, int, str, Any], None]] = None,
    ):
        self.worker_id = worker_id
        self.config = config
        self.device = device
        self.nets: Dict[int, SpokeNet] = {}
        # per-launch ms of the fit flush path and of forecast predicts
        self.step_timer = StepTimer("spoke_flush", cap=65536)
        self.serve_timer = StepTimer("serve_flush", cap=65536)
        self._send_to_hub = send_to_hub
        self._emit_prediction = emit_prediction
        self._emit_response = emit_response
        self._on_poll = on_poll
        self._note_wire = note_wire
        # pre-creation buffering (SpokeLogic.scala:31-35)
        self.record_buffer: DataSet[DataInstance] = DataSet(config.record_buffer_cap)
        self._poll_counter = 0

    # --- control path (FlinkSpoke.processElement2) ---

    def handle_request(self, request: Request, dim: int) -> None:
        if request.request == RequestType.CREATE:
            self._create(request, dim)
        elif request.request == RequestType.UPDATE:
            self._delete(request.id)
            self._create(request, dim)
        elif request.request == RequestType.DELETE:
            self._delete(request.id)
        elif request.request == RequestType.QUERY:
            self._query(request)

    def _create(self, request: Request, dim: int) -> None:
        if request.id in self.nets:
            return
        net = SpokeNet(
            request, self.worker_id, self.config.parallelism, dim, self.config,
            self._make_send(request.id), self.device, timer=self.step_timer,
        )
        self.nets[request.id] = net
        # drain buffered records (FlinkSpoke.scala:69-80)
        if len(self.record_buffer):
            buffered = self.record_buffer.to_list()
            self.record_buffer.clear()
            for inst in buffered:
                self.handle_data(inst)

    def _delete(self, network_id: int) -> None:
        self.nets.pop(network_id, None)
        # a deleted net can no longer generate the hub RPCs that toggle its
        # siblings: resume + drain any survivor left paused
        for net in self.nets.values():
            if net.node.paused:
                net.node.paused = False
                self._drain_pause_buffer(net)

    def _make_send(self, network_id: int):
        def send(op: str, payload: Any, hub_id: int = 0) -> None:
            self._send_to_hub(network_id, hub_id, self.worker_id, op, payload)

        return send

    # --- data path (FlinkSpoke.processElement1 / handleData) ---

    def handle_data(self, inst: DataInstance) -> None:
        if not self.nets:
            self.record_buffer.append(inst)
            return
        for net in list(self.nets.values()):
            x = net.vectorizer.vectorize(inst)
            if net.node.paused:
                # hold, don't drop: the net resumes on the next toggle
                held_inst = inst if inst.operation == FORECASTING else None
                net.pause_buffer.append((inst.operation, x, inst.target, held_inst))
            elif inst.operation == FORECASTING:
                self._serve(net, inst, x)
            else:
                self._train(net, x, 0.0 if inst.target is None else inst.target)
        if inst.operation != FORECASTING:
            # poll marker every 100 training records -- once per record, not
            # per hosted pipeline (FlinkSpoke.scala:83-89)
            self._poll_counter += 1
            if self.config.test and self._poll_counter % self.config.poll_every == 0:
                self._on_poll()

    def _train(self, net: SpokeNet, x: np.ndarray, y: float) -> None:
        # float32 boundary clamp for the target (the features are clamped
        # by the vectorizer)
        y = min(max(float(y), -F32_MAX), F32_MAX)
        # 20% holdout: counts 8,9 of each 0-9 cycle (FlinkSpoke.scala:94-104)
        c = net.holdout_count % 10
        net.holdout_count += 1
        if self.config.test and c >= 8:
            evicted = net.test_set.append((x, y))
            if evicted is None:
                return
            x, y = evicted
        net.batcher.add(x, y)
        if net.batcher.full:
            net.flush_batch()

    def _serve(self, net: SpokeNet, inst: DataInstance, x: np.ndarray) -> None:
        """One forecast as a one-row predict; reading the value back waits
        for the device (one sync per forecast)."""
        t0 = time.perf_counter()
        with self.serve_timer:
            preds = net.node.on_forecast_batch(x[None])
        self._emit_prediction(Prediction(net.request.id, inst, float(preds[0])))
        net.serve_stats.note((time.perf_counter() - t0) * 1000.0)

    # --- query / termination (FlinkSpoke.scala:136-171) ---

    def _query(self, request: Request) -> None:
        net = self.nets.get(request.id)
        if net is None:
            return
        self.emit_query_response(
            net, request.request_id if request.request_id is not None else 0
        )

    def emit_query_response(self, net: SpokeNet, response_id: int) -> None:
        """Evaluate on the holdout set and emit QueryResponse fragments --
        one per <= max_param_bucket_size model-parameter bucket
        (FlinkNetwork.scala:48-149,151-240)."""
        net.flush_batch()
        test = net.test_arrays()
        if test is not None:
            loss, score = net.pipeline.evaluate(*test)
        else:
            loss, score = 0.0, 0.0
        # fold the spoke-side tallies into the pipeline's hub statistics
        if self._note_wire is not None and net.program_launches:
            self._note_wire(
                net.request.id, 0, "program_launches", net.program_launches
            )
            net.program_launches = 0
        if self._note_wire is not None and net.serve_stats.count:
            self._note_wire(
                net.request.id, 0, "forecasts_served", net.serve_stats.count
            )
            self._note_wire(
                net.request.id, 0, "serve_latency_ms",
                net.serve_stats.percentiles(),
            )
            net.serve_stats.reset()
        desc = net.pipeline.describe()
        qstats = net.node.query_stats()

        # model parameter buckets (termination probes skip the payload:
        # responseId -1 fragments only feed statistics)
        chunks: List[Optional[np.ndarray]] = [None]
        if response_id != TERMINATION_RESPONSE_ID:
            flat, _ = net.pipeline.get_flat_params()
            bucket = self.config.max_param_bucket_size
            chunks = [
                flat[i : i + bucket] for i in range(0, max(flat.size, 1), bucket)
            ] or [None]
        n_buckets = len(chunks)

        for i, chunk in enumerate(chunks):
            learner = dict(desc["learner"]) if i == 0 else {"name": desc["learner"]["name"]}
            if chunk is not None:
                learner["parameters"] = {"bucketValues": chunk.tolist()}
            self._emit_response(
                QueryResponse(
                    response_id=response_id,
                    mlp_id=net.request.id,
                    bucket=i,
                    num_buckets=n_buckets,
                    preprocessors=desc["preprocessors"] if i == 0 else None,
                    learner=learner,
                    protocol=net.protocol if i == 0 else None,
                    data_fitted=qstats["data_fitted"] if i == 0 else 0,
                    loss=loss if i == 0 else None,
                    cumulative_loss=qstats["cumulative_loss"] if i == 0 else None,
                    score=score if i == 0 else None,
                    source_worker=self.worker_id,
                )
            )

    def handle_terminate_probe(self) -> None:
        """Termination probe: flush + evaluate every net, emit responseId -1
        fragments (FlinkSpoke.scala:136-138) and let worker nodes push final
        state. Paused nets resume and drain first."""
        for net in list(self.nets.values()):
            if net.node.paused:
                net.node.paused = False
            self._drain_pause_buffer(net)
            net.flush_batch()
            net.node.on_flush()
            self.emit_query_response(net, TERMINATION_RESPONSE_ID)

    def receive_from_hub(self, network_id: int, hub_id: int, op: str,
                         payload: Any) -> None:
        net = self.nets.get(network_id)
        if net is None:
            return
        net.node.deliver(op, payload, hub_id)
        # cooperative multi-pipeline fairness: every hub RPC for one net
        # TOGGLES the others (FlinkSpoke.scala:127-131); a net that just
        # resumed drains the records buffered while paused
        for other_id, other in list(self.nets.items()):
            if other_id == network_id:
                continue
            other.node.toggle()
            if not other.node.paused:
                self._drain_pause_buffer(other)

    def _drain_pause_buffer(self, net: SpokeNet) -> None:
        for operation, x, target, inst in net.pause_buffer.drain():
            if operation == FORECASTING:
                self._serve(net, inst, x)
            else:
                self._train(net, x, 0.0 if target is None else target)
