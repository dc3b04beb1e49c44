"""Spoke: the worker-side runtime hosting pipeline replicas.

Counterpart of ``omldm_tpu/runtime/spoke.py`` (the reference's
``FlinkSpoke`` + ``SpokeLogic``, FlinkSpoke.scala:28-356) on its bare
per-record route: one node per pipeline, every record fanned out to all
hosted pipelines, the 20% holdout (counts 8 and 9 of each 0-9 cycle go to
a sliding test set whose evicted points are trained,
FlinkSpoke.scala:94-104), a poll marker every 100 training records,
forecasts answered immediately, and records arriving before any pipeline
buffered (SpokeLogic.scala:31-35). A sparse net (``dataStructure.sparse``)
vectorizes each record into a padded-COO pair and batches pairs.

Two bulk routes sit beside the per-record one. ``handle_packed`` takes rows
the native parser already vectorized (``runtime.fast_ingest``) and produces
the same per-net state as feeding them one at a time: the same holdout
cycle, batcher fill order and poll markers, each forecast served at its
stream position. A serving-armed net (``trainingConfiguration.serving`` or
``JobConfig.serving``) queues its forecasts in the adaptive-batching plane
(``runtime.serving``) and answers them in batched predicts; in the default
exact mode a queue flushes before any change to the net's model, so every
answer equals the per-record path's.

With cohorts armed (``JobConfig.cohort``, ``runtime.cohort``) the spoke's
``CohortEngine`` gangs its same-spec dense nets: their fits stage and
launch together at the end of each record and each packed block (the gang
barrier), packed blocks walk the members in lockstep, and forecasts to
several members are answered by one gang predict. Attached nets are
exempt from the cooperative pause toggle: gang lockstep is their fairness.

A guarded net (``trainingConfiguration.guard``) seeds its last-known-good
snapshot at deploy; after each record, each packed block and before a
Query the spoke checks every guard's newest health value
(``_guard_tick_all``: one read a net that launched) and, on a trip,
evicts a cohort member, rolls the parameters back, resets the codec's
streams and asks the hubs for a resync (``_guard_trip``). With the
reliable channel armed, each net stamps its sends with a per-hub sequence
number and passes hub messages through a receive window
(``receive_from_hub``); duplicates and gaps fold into the hub's
statistics. A live shrink merges a retiring spoke into a survivor
(``absorb``: models through the learner's merge, pending rows re-fed,
holdout and pause buffers merged).

With the overload plane armed (``trainingConfiguration.overload`` or
``JobConfig.overload``, ``runtime.overload``) the spoke's
``OverloadController`` accounts every tenant row it admits: a record whose
``metadata.tenant`` names a hosted pipeline goes to that pipeline alone, and
an over-limit tenant under pressure defers its training rows and, at
CRITICAL, sheds its forecasts as ``shed_overload`` dead letters. A packed
block is admitted whole before the cohort's gang walk, so an over-limit
member leaves that block's gang. With the lifecycle plane armed
(``runtime.lifecycle``) a net's Shadow candidate fits beside the active
model on every flushed batch, a canary split routes forecasts to it at
serve admission, and the spoke executes the registry's promote and rollback
decisions after each record, block and query.

With the telemetry plane armed (``runtime.telemetry``, attached by the job)
the spoke times its ``stage`` (featurization, batcher fill) and ``holdout``
phases, opens a sampled span at a send and closes it at the next reply on
that stream, and folds its launch percentiles into the statistics. With
the flight recorder armed (``runtime.events``) it records its decisions:
guard trips, rollbacks and cohort evictions, receive-window gaps and
accepted resyncs, and wires the overload controller's and the lifecycle
registries' journals. A net whose ``trainingConfiguration`` sets
``telemetry`` or ``events`` to false opts out of spans or events.
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
from omldm_tpu_torch.guard import guard_config
from omldm_tpu_torch.pipelines import MLPipeline
from omldm_tpu_torch.protocols.base import WorkerNode
from omldm_tpu_torch.protocols.registry import make_worker_node, resolve_protocol
from omldm_tpu_torch.runtime.cohort import CohortEngine
from omldm_tpu_torch.runtime.databuffers import DataSet
from omldm_tpu_torch.runtime.events import (
    CHANNEL_RESYNC,
    GAP_RESYNC,
    GUARD_EVICT,
    GUARD_ROLLBACK,
    GUARD_TRIP,
    events_config,
)
from omldm_tpu_torch.runtime.lifecycle import (
    CANARY,
    REASON_OPERATOR,
    SHADOW,
    LifecycleState,
    build_candidate,
    lifecycle_config,
)
from omldm_tpu_torch.runtime.messages import (
    OP_NACK,
    OP_RESYNC,
    ReceiveWindow,
    StreamSequencer,
    channel_chaos_spec,
    channel_window_size,
    reliability_armed,
)
from omldm_tpu_torch.runtime.overload import (
    CRITICAL,
    ELEVATED,
    OverloadController,
    overload_config,
)
from omldm_tpu_torch.runtime.serving import (
    ServeQueue,
    ServeStats,
    ServingPlane,
    _entry_rows,
    serving_config,
)
from omldm_tpu_torch.runtime.telemetry import telemetry_config
from omldm_tpu_torch.runtime.vectorizer import (
    F32_MAX,
    MicroBatcher,
    SparseMicroBatcher,
    SparseVectorizer,
    Vectorizer,
)
from omldm_tpu_torch.utils.tracing import StepTimer

# width of the immediate-serving predict batch: a forecast is padded into
# this many rows, and a serving flush into the power of two at or above its
# queue (the JAX package fixes the shapes so its predict never recompiles)
PREDICT_BATCH = 16
# the pause and pre-create buffers' entry tag for a whole packed block
PACKED = "__packed__"


def create_pipeline(request: Request, dim: int, device, guarded: bool = True) -> MLPipeline:
    """The Create-request pipeline recipe: a generator seeded from the
    request id (where the JAX package keys ``jax.random.PRNGKey(request.id)``),
    the per-record mode and, unless ``guarded`` is False, the guard. The
    lifecycle plane rebuilds a retained version 0 through it too, so the
    two cannot drift."""
    tc = request.training_configuration
    return MLPipeline(
        request.learner,
        request.preprocessors,
        dim=dim,
        generator=torch.Generator().manual_seed(request.id),
        per_record=tc.per_record,
        device=device,
        guard=guard_config(tc) if guarded else None,
    )


class _PauseBuffer:
    """Bounded ROW-accounted hold buffer: records held while a net is
    paused (cooperative toggle), the spoke's pre-creation packed buffer and
    the job's pre-create backlog. Beyond the cap the OLDEST rows drop
    (keep-newest eviction, SpokeLogic.scala:31-35); a packed block
    (``entry[0] == PACKED``) counts and trims by its rows, any other entry
    counts as one row."""

    def __init__(self, cap: int):
        self.cap = cap
        self._entries: Deque[tuple] = collections.deque()
        self._rows = 0

    def __len__(self) -> int:
        return self._rows

    @property
    def is_empty(self) -> bool:
        return not self._entries

    @staticmethod
    def _entry_rows(entry) -> int:
        if entry[0] == PACKED:
            return int(entry[1][0].shape[0])
        return 1

    def append(self, entry: tuple) -> None:
        self._entries.append(entry)
        self._rows += self._entry_rows(entry)
        while self._entries and self._rows > self.cap:
            excess = self._rows - self.cap
            head = self._entries[0]
            n = self._entry_rows(head)
            if n <= excess:
                self._entries.popleft()
                self._rows -= n
            else:
                px, py, pop = head[1]
                self._entries[0] = (
                    PACKED,
                    (px[excess:].copy(), py[excess:].copy(), pop[excess:].copy()),
                    None, None,
                )
                self._rows -= excess

    def peek(self):
        """Oldest held entry, or None."""
        return self._entries[0] if self._entries else None

    def drain(self) -> List[tuple]:
        entries, self._entries = list(self._entries), collections.deque()
        self._rows = 0
        return entries

    def merge(self, others) -> None:
        """Take over other buffers' entries, oldest first, under this
        buffer's cap (a shrink rescale)."""
        for other in others:
            for entry in other.drain():
                self.append(entry)


class SpokeNet:
    """Per-(spoke, networkId) state: worker node + batcher + holdout set."""

    def __init__(self, request: Request, worker_id: int, n_workers: int,
                 dim: int, config: JobConfig, send, device,
                 timer: Optional[StepTimer] = None):
        self.request = request
        self.dim = dim
        self.device = device
        self._timer = timer
        tc = request.training_configuration
        self.protocol = resolve_protocol(
            tc.protocol, request.learner.name, n_workers
        )
        batch = int(tc.mini_batch_size or config.batch_size)
        ds = request.learner.data_structure or {}
        self.sparse = bool(ds.get("sparse"))
        if self.sparse:
            # padded-COO featurization: dense slots + hashed categoricals in
            # a wide index space (SparseVector parity,
            # DataPointParser.scala:4,20-47)
            self.max_nnz = int(ds.get("maxNnz", 64))
            self.vectorizer = SparseVectorizer(
                dim, int(ds.get("hashSpace", 0)), self.max_nnz
            )
            self.batcher = SparseMicroBatcher(self.max_nnz, batch)
        else:
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
        # adaptive-batching serving (runtime/serving.py): when armed, this
        # net's forecasts queue here and serve in batched predicts; None
        # keeps the immediate per-record predict. The hosting Spoke attaches
        # its plane at create time.
        self.serving = serving_config(tc, config.serving)
        self.serve_queue = ServeQueue()
        self._plane: Optional[ServingPlane] = None
        # the overload plane (runtime/overload.py): armed, this tenant's
        # admissions run through the spoke's OverloadController (attached
        # at create time); None keeps the plain routes
        self.overload = overload_config(tc, config.overload)
        self._octl: Optional[OverloadController] = None
        # the telemetry plane's and the flight recorder's per-net switches:
        # an explicit false keeps this pipeline's rounds out of the sampled
        # spans, or its decisions out of the journal and its Query responses
        # without an event tail, even when another pipeline or the job-wide
        # spec armed the job's plane (which lives on the job)
        self.telemetry_cfg = telemetry_config(tc, config.telemetry)
        self.events_cfg = events_config(tc, config.events)
        # the model-lifecycle plane (runtime/lifecycle.py): the net's
        # version registry. None (unarmed, and always for a sparse net: the
        # candidate's predict and flat-parameter paths are dense) keeps the
        # plain routes
        lc_cfg = lifecycle_config(tc, config.lifecycle) if not self.sparse else None
        self.lifecycle: Optional[LifecycleState] = (
            LifecycleState(lc_cfg) if lc_cfg is not None else None
        )
        # padded predict scratch, reused by every serve path
        self._scratch = None
        self._scratch_dirty = 0
        # (x, y) points; x is a dense row or a sparse (idx, val) pair
        self.test_set: DataSet[Tuple[Any, float]] = DataSet(config.test_set_size)
        self.holdout_count = 0
        # records arriving while this net is PAUSED (cooperative toggle,
        # FlinkSpoke.scala:127-131) buffer here and drain on resume
        self.pause_buffer = _PauseBuffer(config.record_buffer_cap)
        # codec seconds already folded into the hub statistics (each fold
        # adds the delta since the last, so query and terminate never count
        # a second twice)
        self._codec_folded = (0.0, 0.0)
        # the reliable channel: per-hub outgoing sequence numbers and
        # per-hub receive windows (not armed: nothing stamped or windowed)
        self.channel_armed = reliability_armed(tc, channel_chaos_spec(config))
        self.node.channel_armed = self.channel_armed
        self._window_size = channel_window_size(tc)
        self._tx_seq = StreamSequencer() if self.channel_armed else None
        self._rx_windows: Dict[int, ReceiveWindow] = {}
        self._quiesced = False

    def next_seq(self, hub_id: int) -> Optional[int]:
        if self._tx_seq is None:
            return None
        return self._tx_seq.next(hub_id)

    def rx_window(self, hub_id: int) -> ReceiveWindow:
        window = self._rx_windows.get(hub_id)
        if window is None:
            # a window born after the quiesce passes through: the first
            # message from this hub may arrive during termination
            window = self._rx_windows[hub_id] = ReceiveWindow(
                self._window_size, passthrough=self._quiesced
            )
        return window

    @property
    def pipeline(self) -> MLPipeline:
        return self.node.pipeline

    def _note_launch(self) -> None:
        self.program_launches += 1

    def serving_limits(self):
        """The serving config the flush triggers compare against: the
        static one, or its degraded variant (widened maxBatch and
        maxDelayMs, relaxed staleness) while the spoke's overload
        controller reports pressure."""
        ctl = self._octl
        if ctl is None or ctl.level == 0:
            return self.serving
        return ctl.degraded_serving(self)

    def gang_predict_ok(self) -> bool:
        """Gang serving bypasses ``node.on_forecast_batch`` with the same
        predict batched over the cohort: only for attached dense nets whose
        node keeps the base behaviour (predict with the local model)."""
        return (
            not self.sparse
            and self.pipeline._cohort is not None
            and type(self.node).on_forecast_batch is WorkerNode.on_forecast_batch
        )

    def predict_pad(self, n: int):
        """A zeroed padded predict batch with >= ``n`` writable rows from
        the net's scratch: ``[B', dim]`` (a sparse net: an ``(idx, val)``
        pair), ``B'`` the power of two at or above ``n`` and at least
        PREDICT_BATCH. Only the rows the previous use dirtied are zeroed
        again; the caller fills rows ``[0, n)``. A predict is done reading
        it when it returns (a synchronous host-to-device copy on a card),
        so reuse is safe."""
        b = PREDICT_BATCH
        while b < n:
            b <<= 1
        if self.sparse:
            if self._scratch is None or self._scratch[0].shape[0] < b:
                self._scratch = (
                    np.zeros((b, self.max_nnz), np.int32),
                    np.zeros((b, self.max_nnz), np.float32),
                )
                self._scratch_dirty = 0
            ib, vb = self._scratch
            if self._scratch_dirty:
                ib[: self._scratch_dirty] = 0
                vb[: self._scratch_dirty] = 0.0
            self._scratch_dirty = n
            return ib[:b], vb[:b]
        if self._scratch is None or self._scratch.shape[0] < b:
            self._scratch = np.zeros((b, self.dim), np.float32)
            self._scratch_dirty = 0
        if self._scratch_dirty:
            self._scratch[: self._scratch_dirty] = 0.0
        self._scratch_dirty = n
        return self._scratch[:b]

    def flush_batch(self) -> None:
        if self.serving is not None and self.serve_queue.entries and len(self.batcher):
            # this net's model is about to change (the pending rows will
            # dispatch a fit): exact-mode serving drains the queue NOW with
            # the pre-fit parameters; relaxed mode counts the chunk
            self._plane.fence(self)
        if self.pipeline._cohort is not None:
            # a deferred sync point may set `waiting`: settle it before the
            # view-or-copy choice, or a blocking node could hold VIEWS
            self.pipeline.settle_deferred()
            if self.node.consumes_batch_synchronously and not getattr(
                    self.node, "waiting", False):
                # the staged fit copies the rows into the gang buffers at
                # once, so the batcher may hand out views; the gang launch
                # times itself (Cohort._run_staged)
                flushed = self.batcher.flush_views()
                if flushed is not None:
                    self.node.on_training_batch(*flushed)
                    if self.lifecycle is not None and self.lifecycle.training_active:
                        # the candidate trains on the same batch; the views
                        # alias batcher buffers that later adds reuse, so
                        # it gets copies
                        x, y, m = flushed
                        self.lifecycle.fit_candidate(x.copy(), y.copy(), m)
                return
        flushed = self.batcher.flush()
        if flushed is None:
            return
        if self._timer is not None and self.pipeline._cohort is None:
            with self._timer:
                self.node.on_training_batch(*flushed)
        else:
            self.node.on_training_batch(*flushed)
        if self.lifecycle is not None and self.lifecycle.training_active:
            # a shadow or canary candidate trains on the same micro-batch
            # (its own solo launch; the active model is untouched)
            self.lifecycle.fit_candidate(*flushed)

    def test_arrays(self) -> Optional[Tuple[Any, np.ndarray, np.ndarray]]:
        if self.test_set.is_empty:
            return None
        pts = self.test_set.to_list()
        if self.sparse:
            x = (np.stack([p[0][0] for p in pts]), np.stack([p[0][1] for p in pts]))
        else:
            x = np.stack([p[0] for p in pts])
        y = np.asarray([p[1] for p in pts], np.float32)
        return x, y, np.ones((len(pts),), np.float32)


def _vectorize(net: SpokeNet, inst: DataInstance, vecs: Dict[Any, Any]):
    """``net.vectorizer.vectorize(inst)``, memoized in ``vecs`` by the
    vectorizer's value for the one record being routed."""
    x = vecs.get(net.vectorizer)
    if x is None:
        x = vecs[net.vectorizer] = net.vectorizer.vectorize(inst)
    return x


class Spoke:
    """One logical worker (a Flink subtask in the reference)."""

    def __init__(
        self,
        worker_id: int,
        config: JobConfig,
        send_to_hub: Callable,   # (network_id, hub_id, worker_id, op, payload, seq)
        emit_prediction: Callable[[Prediction], None],
        emit_response: Callable[[QueryResponse], None],
        on_poll: Callable[[], None],
        device,
        # (network_id, hub_id, counter, value): an int for the additive
        # counters, a (p50, p99, p999) triple for serve_latency_ms
        note_wire: Optional[Callable[[int, int, str, Any], None]] = None,
        # bulk twin of emit_prediction, one call per serving flush
        emit_predictions: Optional[Callable[[List[Prediction]], None]] = None,
        # dead-letter hook (stream, payload, reason, detail=, extra=): the
        # overload plane's shed and throttle records quarantine through it
        quarantine: Optional[Callable] = None,
        # metadata.tenant addressing with the overload plane unarmed (the
        # job sets it when the chaos burst injector is armed: its copies
        # are tenant-addressed); False broadcasts every record
        tenant_routing: bool = False,
        # the job's telemetry plane (runtime/telemetry.TelemetryPlane) and
        # flight-recorder journal (runtime/events.EventJournal), or None:
        # one attribute read a hook when unarmed
        telemetry=None,
        events=None,
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
        self._emit_predictions = emit_predictions
        self._emit_response = emit_response
        self._on_poll = on_poll
        self._note_wire = note_wire
        # the serving plane, created with the first serving-armed net; the
        # flag gates every hot-path hook (one attribute read when unarmed)
        self.serving_plane: Optional[ServingPlane] = None
        self._any_serving = False
        # True once a hosted net is guarded: gates the per-event guard walk
        self._any_guard = False
        # True once a hosted net is lifecycle-armed: gates the per-event
        # candidate tick and the canary split at serve admission
        self._any_lifecycle = False
        # the overload controller, created with the first overload-armed
        # net; None: no admission accounting, ladder or shedding
        self.overload: Optional[OverloadController] = None
        self._quarantine = quarantine
        self.tenant_routing = tenant_routing
        # the telemetry plane and its phase profile (split so a hot path
        # reads one attribute), set here or later by attach_telemetry (lazy
        # arming), and the flight recorder's journal (attach_events)
        self.telemetry = telemetry
        self._phases = telemetry.phases if telemetry is not None else None
        self.events = events
        # cached (count, (p50, p99)) a timer: the terminate probe folds the
        # launch percentiles a net, and re-sorting the ring a tenant would
        # make a many-tenant terminate quadratic in the ring's length
        self._tp_cache: Dict[str, Tuple[int, Tuple[float, float]]] = {}
        # pre-creation buffering (SpokeLogic.scala:31-35): records, and
        # whole packed blocks under the same row cap
        self.record_buffer: DataSet[DataInstance] = DataSet(config.record_buffer_cap)
        self._packed_buffer = _PauseBuffer(config.record_buffer_cap)
        self._poll_counter = 0
        # the cohort engine (JobConfig.cohort); None when off, and every
        # route below then takes the solo path
        engine = CohortEngine(config, device, timer=self.step_timer,
                              serve_timer=self.serve_timer)
        self.cohorts: Optional[CohortEngine] = engine if engine.enabled else None

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
        elif request.request == RequestType.SHADOW:
            self._lifecycle_shadow(request)
        elif request.request == RequestType.PROMOTE:
            self._lifecycle_promote_request(request)
        elif request.request == RequestType.ROLLBACK:
            self._lifecycle_rollback_request(request)

    def _create(self, request: Request, dim: int) -> None:
        if request.id in self.nets:
            return
        net = SpokeNet(
            request, self.worker_id, self.config.parallelism, dim, self.config,
            self._make_send(request.id), self.device, timer=self.step_timer,
        )
        self.nets[request.id] = net
        net.node.on_start()
        if net.serving is not None:
            net._plane = self._ensure_serving_plane()
        if net.overload is not None:
            if self.overload is None:
                self.overload = OverloadController(self)
            self.overload.arm(net)
        if net.pipeline.guard is not None:
            self._any_guard = True
            # the first last-known-good snapshot, at the initial params: a
            # trip before the first cadence snapshot has a target too
            net.pipeline.guard.maybe_snapshot(net.pipeline)
        if net.lifecycle is not None:
            self._any_lifecycle = True
        self._wire_events(net)
        if self.cohorts is not None:
            self.cohorts.consider(net.pipeline)
            # pooled pipelines may attach on a LATER create (the auto
            # threshold); attached nets are exempt from the pause toggle,
            # so one caught paused would never resume: release it now
            for other in self.nets.values():
                if other.pipeline._cohort is not None and other.node.paused:
                    other.node.paused = False
                    self._drain_pause_buffer(other)
        # drain buffered records (FlinkSpoke.scala:69-80)
        if len(self.record_buffer):
            buffered = self.record_buffer.to_list()
            self.record_buffer.clear()
            for inst in buffered:
                self.handle_data(inst)
        if not self._packed_buffer.is_empty:
            for _op, block, _t, _i in self._packed_buffer.drain():
                self.handle_packed(*block)

    def _ensure_serving_plane(self) -> ServingPlane:
        if self.serving_plane is None:
            self.serving_plane = ServingPlane(
                self._emit_prediction,
                emit_predictions=self._emit_predictions,
                timer=self.serve_timer,
            )
        self._any_serving = True
        return self.serving_plane

    def poll_serving(self) -> None:
        """Serving-plane boundary tick: fill-triggered flushes and the
        maxDelayMs deadline. Runs after every data event and from the job's
        silence check; one flag read when no hosted net is armed."""
        if self._any_serving:
            self.serving_plane.maybe_fill_flush()
            self.serving_plane.poll()

    def _delete(self, network_id: int) -> None:
        net = self.nets.pop(network_id, None)
        if net is not None and net.serving is not None and net.serve_queue.entries:
            # pending forecasts serve through the departing model first --
            # the per-record path would have answered them already
            self.serving_plane.flush_net(net)
        if net is not None and self.cohorts is not None:
            # cohort churn: the member's slot frees for reuse; the
            # survivors keep their slots
            self.cohorts.retire(net.pipeline)
        if net is not None and self.overload is not None:
            # the tenant's accounting and deferred rows go with it, as the
            # net's pause buffer does
            self.overload.retire(network_id)
        # a deleted net can no longer generate the hub RPCs that toggle its
        # siblings: resume + drain any survivor left paused
        for net in self.nets.values():
            if net.node.paused:
                net.node.paused = False
                self._drain_pause_buffer(net)

    def attach_telemetry(self, plane) -> None:
        """Hand this spoke the job's telemetry plane (lazy arming by a
        pipeline's table)."""
        self.telemetry = plane
        self._phases = plane.phases

    def attach_events(self, journal) -> None:
        """Hand this spoke the job's flight-recorder journal (lazy arming by
        a pipeline's table) and wire the hosted planes that record their own
        transitions."""
        self.events = journal
        for net in self.nets.values():
            self._wire_events(net)

    def _wire_events(self, net: SpokeNet) -> None:
        """Hand a recording net's planes the journal: its lifecycle registry,
        and the spoke's overload controller (whose ladder events are
        spoke-scoped: any recording overload tenant arms them)."""
        if self.events is None or net.events_cfg is None:
            return
        if net.overload is not None:
            self.overload.events = self.events
        if net.lifecycle is not None:
            net.lifecycle.events = self.events
            net.lifecycle.net_id = net.request.id

    def attach_ingest_probe(self, name: str, probe) -> None:
        """Register an ingest-plane pressure probe (a callable of no
        arguments returning (value, high, critical)) on this spoke's
        overload controller -- the sharded ingest driver's starvation or
        the prefetch ring's emptiness (``OverloadController.extra_signals``).
        A no-op while the overload plane is unarmed: the signal has no
        ladder to raise."""
        if self.overload is not None:
            self.overload.extra_signals[name] = probe

    def detach_ingest_probe(self, name: str) -> None:
        """Remove a probe ``attach_ingest_probe`` registered (the sharded
        ingest driver detaches its probes when the file run ends: a closed
        ``ShardedIngest`` must not go on reporting stale pressure)."""
        if self.overload is not None:
            self.overload.extra_signals.pop(name, None)

    def _timer_percentiles(self, timer: StepTimer) -> Tuple[float, float]:
        """(p50, p99) ms of a StepTimer's window, cached by the timer's
        count so a many-tenant terminate sorts each ring once."""
        cached = self._tp_cache.get(timer.name)
        if cached is not None and cached[0] == timer.count:
            return cached[1]
        sm = timer.summary()
        out = (sm["p50_ms"], sm["p99_ms"])
        self._tp_cache[timer.name] = (timer.count, out)
        return out

    def _make_send(self, network_id: int):
        def send(op: str, payload: Any, hub_id: int = 0) -> None:
            # the reliable channel stamps its sequence number here, at the
            # ship boundary: below the codec, above the (lossy) router
            net = self.nets.get(network_id)
            seq = net.next_seq(hub_id) if net is not None else None
            # sampled round tracing: 1/traceSample sends open a span keyed
            # by the stamp; the next hub delivery on the stream closes it
            tel = self.telemetry
            if (tel is not None and tel.spans.active and net is not None
                    and net.telemetry_cfg is not None):
                tel.spans.maybe_open(network_id, hub_id, self.worker_id, op, seq)
            self._send_to_hub(network_id, hub_id, self.worker_id, op, payload, seq)

        return send

    # --- data path (FlinkSpoke.processElement1 / handleData) ---

    def handle_data(self, inst: DataInstance) -> None:
        if not self.nets:
            self.record_buffer.append(inst)
            return
        nets = list(self.nets.values())
        meta = inst.metadata
        if isinstance(meta, dict) and (self.overload is not None or self.tenant_routing):
            # a tenant-ADDRESSED record: ``metadata.tenant`` names a hosted
            # pipeline and the record goes to it alone, the traffic shape
            # the overload plane's fair-share accounting (and the burst
            # injector) exercise. Only an armed controller or the burst
            # injector turns this on, so a stream whose metadata happens to
            # carry a "tenant" key keeps the broadcast; an unknown tenant
            # broadcasts too
            target = self.nets.get(meta.get("tenant"))
            if target is not None:
                nets = [target]
        ctl = self.overload
        serve_entries: List[Tuple[SpokeNet, Any]] = []
        # False only when every admission of this record was shed: nothing
        # entered a queue, so the boundary walks wait for the next admitted
        # record (shedding must stay far cheaper than serving)
        touched = ctl is None
        # one featurization per vectorizer shape: a broadcast record reaches
        # every hosted net, and nets of one width share its vector (nothing
        # downstream writes into a staged row)
        vecs: Dict[Any, Any] = {}
        for net in nets:
            if ctl is not None and net.overload is not None and not net.node.paused:
                # fair-share admission, before featurization: the counter
                # accounts every row, the LEVEL decides what an over-limit
                # verdict does (defer training at ELEVATED and up, shed
                # forecasts at CRITICAL)
                over = ctl.spend(net, 1)
                if over and ctl.level >= ELEVATED:
                    if inst.operation == FORECASTING:
                        if ctl.level >= CRITICAL and net.overload.shed:
                            self._shed_forecast(net, inst)
                            continue
                    else:
                        self._defer_training(
                            net, (inst.operation, _vectorize(net, inst, vecs),
                                  inst.target, None), 1)
                        touched = True
                        continue
            ph = self._phases
            if ph is None:
                x = _vectorize(net, inst, vecs)
            else:
                # per-record featurization is the record route's share of
                # the ``stage`` phase
                with ph.phase("stage"):
                    x = _vectorize(net, inst, vecs)
            if net.node.paused:
                # hold, don't drop: the net resumes on the next toggle
                held_inst = inst if inst.operation == FORECASTING else None
                net.pause_buffer.append((inst.operation, x, inst.target, held_inst))
                touched = True
            elif inst.operation == FORECASTING:
                serve_entries.append((net, x))
            else:
                self._train(net, x, 0.0 if inst.target is None else inst.target)
                touched = True
        if serve_entries:
            touched = True
            self._serve_many(inst, serve_entries)
        # gang barrier: launch every cohort's staged fits for this record
        self._flush_cohorts()
        # guard: check the health values this record's launches noted
        self._guard_tick_all()
        # lifecycle: the candidates' guard, score and ramp decisions
        self._lifecycle_tick_all()
        if touched:
            # overload: re-derive the level from the queues this record
            # left, before the serving poll so degraded limits apply at
            # this boundary. A fully shed record skips both walks (its
            # spends already advanced the count clock)
            if ctl is not None:
                self._overload_tick()
            self.poll_serving()
        if inst.operation != FORECASTING:
            # poll marker every 100 training records -- once per record, not
            # per hosted pipeline (FlinkSpoke.scala:83-89)
            self._poll_counter += 1
            if self.config.test and self._poll_counter % self.config.poll_every == 0:
                self._on_poll()

    # --- packed data path (bulk ingest: the native parser's rows, no
    # per-record Python objects; semantics of handle_data on the same rows) ---

    def handle_packed(self, x: np.ndarray, y: np.ndarray, op: np.ndarray) -> None:
        """Bulk equivalent of handle_data for pre-vectorized rows.

        ``x`` [n, W] float32, ``y`` [n] float32, ``op`` [n] uint8
        (0 training, 1 forecasting). Produces the same per-net state as
        feeding the rows one at a time (same holdout cycle, same batcher
        fill order, same poll markers, forecasts served at their stream
        position); pause (toggle) is honored at block granularity, and so
        is cross-spoke protocol interleaving (the reference's Flink
        rebalance gives no per-record cross-worker order either,
        FlinkLearning.scala:83-88)."""
        n = x.shape[0]
        if n == 0:
            return
        if not self.nets:
            # same keep-newest eviction as the per-record buffer
            # (SpokeLogic.scala:31-35), row-accounted
            self._packed_buffer.append((PACKED, (x, y, op), None, None))
            return
        f_idx = np.nonzero(op != 0)[0]
        ctl = self.overload
        gang_nets: List[SpokeNet] = []
        for net in list(self.nets.values()):
            if net.node.paused:
                # hold the whole block; drains via _drain_pause_buffer
                net.pause_buffer.append((PACKED, (x, y, op), None, None))
                continue
            if ctl is not None and net.overload is not None:
                # block-granular admission, before the gang walk: an
                # over-limit tenant under pressure sheds or serves its
                # forecast rows and defers its training rows for the whole
                # block, and so leaves this block's gang
                over = ctl.spend(net, n)
                if over and ctl.level >= ELEVATED:
                    self._overload_packed(net, x, y, op, f_idx)
                    continue
            if net.pipeline._cohort is not None:
                # cohort members advance in LOCKSTEP below, so same-cohort
                # flushes stage into shared gang launches (each net's row
                # order, holdout cycle and flush points are its solo ones)
                gang_nets.append(net)
                continue
            self._process_packed_for_net(net, x, y, f_idx)
        if len(gang_nets) == 1:
            self._process_packed_for_net(gang_nets[0], x, y, f_idx)
        elif gang_nets:
            self._process_packed_gang(gang_nets, x, y, f_idx)
        self._flush_cohorts()
        self._guard_tick_all()
        self._lifecycle_tick_all()
        if ctl is not None:
            self._overload_tick()
        self.poll_serving()
        nt = n - int(f_idx.size)
        if nt:
            pc = self._poll_counter
            self._poll_counter += nt
            if self.config.test:
                pe = self.config.poll_every
                for _ in range(self._poll_counter // pe - pc // pe):
                    self._on_poll()

    def buffered_packed_dim(self) -> Optional[int]:
        """Feature width of buffered pre-creation packed rows, if any."""
        head = self._packed_buffer.peek()
        if head is not None:
            return int(head[1][0].shape[1])
        return None

    def _process_packed_for_net(self, net: SpokeNet, x, y, f_idx) -> None:
        """One net's share of a packed block: serve each forecast at its
        stream position (train the rows before it first), matching the
        per-record order. A serving-armed dense net takes the bulk
        span-admission walker instead."""
        if self._process_packed_serving_bulk([net], x, y, f_idx):
            return
        n = x.shape[0]
        prev = 0
        for f in f_idx:
            f = int(f)
            if f > prev:
                self._train_packed(net, x[prev:f], y[prev:f])
            self._serve_packed(net, x, np.asarray([f]))
            if self._any_serving:
                self.serving_plane.maybe_fill_flush()
            prev = f + 1
        if prev < n:
            self._train_packed(net, x[prev:], y[prev:])

    def _process_packed_serving_bulk(self, nets: List[SpokeNet], x, y, f_idx) -> bool:
        """Serving-plane fast path for a packed block when EVERY net is
        dense and serving-armed, with equal batch size and fill (lockstep):
        the per-position serve loop collapses into span-wise bulk admission
        between batcher-fill boundaries.

        Exactness: a queued forecast's answer depends only on the
        parameters at its flush, and the fence flushes the queue before any
        fit dispatches, so admission order relative to the TRAINING rows
        between two fills does not matter. The walker feeds training rows
        in fill-sized chunks and, before each chunk, admits every forecast
        positioned before the row that would complete the fill: a fence
        the chunk triggers then flushes exactly the forecasts the
        per-record path would have served before that fit. (With holdout
        sampling the real fill lands at or after the chunk end: the bound
        is conservative, never early.) Returns False when the nets do not
        qualify; the caller walks position by position."""
        if f_idx.size == 0 or not nets:
            return False
        b0 = nets[0].batcher.batch_size
        fill0 = len(nets[0].batcher)
        for net in nets:
            if (net.serving is None or net.sparse or net.batcher.batch_size != b0
                    or len(net.batcher) != fill0
                    # an active canary needs the per-position walk: its
                    # count-clocked split is per forecast row
                    or (net.lifecycle is not None and net.lifecycle.canary_active)):
                return False
        plane = self.serving_plane
        n = x.shape[0]
        t_mask = np.ones((n,), bool)
        t_mask[f_idx] = False
        t_idx = np.nonzero(t_mask)[0]
        rows_cache: Dict[int, np.ndarray] = {}

        def admit(lo: int, hi: int) -> None:
            # one enqueue clock per span (every row of it becomes servable
            # now), then flush at once if a queue filled: flushing EARLIER
            # than the fence is always exact
            now = plane._clock()
            for net in nets:
                rows = rows_cache.get(net.dim)
                if rows is None:
                    rows = rows_cache[net.dim] = self._adapt_width(x[f_idx], net.dim)
                plane.admit_rows(net, rows[lo:hi], now)
            plane.maybe_fill_flush()

        fi = 0  # forecasts admitted so far (index into f_idx)
        ti = 0  # training rows fed so far (index into t_idx)
        while ti < t_idx.size:
            room = max(b0 - len(nets[0].batcher), 1)
            chunk = t_idx[ti : ti + room]
            ti += chunk.size
            hi = fi + int(np.searchsorted(f_idx[fi:], int(chunk[-1])))
            if hi > fi:
                admit(fi, hi)
                fi = hi
            if len(nets) == 1:
                self._train_packed(nets[0], x[chunk], y[chunk])
            else:
                self._train_packed_gang(nets, x[chunk], y[chunk])
        if fi < f_idx.size:
            admit(fi, f_idx.size)
        return True

    @staticmethod
    def _adapt_width(rows: np.ndarray, dim: int) -> np.ndarray:
        """Pad/truncate packed rows to a net's feature width (nets created
        with a different dim than the packed stream still train)."""
        w = rows.shape[1]
        if w == dim:
            return rows
        if w > dim:
            return rows[:, :dim]
        out = np.zeros((rows.shape[0], dim), np.float32)
        out[:, :w] = rows
        return out

    @staticmethod
    def _dense_rows_to_coo(rows: np.ndarray, max_nnz: int):
        """Dense packed rows -> per-row padded COO (for sparse nets fed by
        the dense bulk-ingest route; nonzeros beyond the budget truncate)."""
        n = rows.shape[0]
        idx = np.zeros((n, max_nnz), np.int32)
        val = np.zeros((n, max_nnz), np.float32)
        for i in range(n):
            nz = np.nonzero(rows[i])[0][:max_nnz]
            idx[i, : nz.size] = nz
            val[i, : nz.size] = rows[i, nz]
        return idx, val

    def _holdout_filter(
        self, net: SpokeNet, tx: np.ndarray, ty: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized 8-of-10 holdout split over a packed segment; evicted
        test points re-enter the training flow at the slot of the row that
        evicted them. Identity when test mode is off. Timed as the
        ``holdout`` phase when the telemetry plane is armed."""
        ph = self._phases
        if ph is None:
            return self._holdout_filter_inner(net, tx, ty)
        with ph.phase("holdout"):
            return self._holdout_filter_inner(net, tx, ty)

    def _holdout_filter_inner(
        self, net: SpokeNet, tx: np.ndarray, ty: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        if not self.config.test:
            return tx, ty
        n = tx.shape[0]
        c = (net.holdout_count + np.arange(n)) % 10
        net.holdout_count += n
        test_mask = c >= 8
        keep_idx = np.nonzero(~test_mask)[0]
        ev_x: List[np.ndarray] = []
        ev_y: List[float] = []
        ev_pos: List[int] = []
        for i in np.nonzero(test_mask)[0]:
            evicted = net.test_set.append((tx[i].copy(), float(ty[i])))
            if evicted is not None:
                ev_x.append(evicted[0])
                ev_y.append(evicted[1])
                ev_pos.append(int(i))
        if ev_pos:
            pos = np.concatenate([keep_idx, np.asarray(ev_pos)])
            order = np.argsort(pos, kind="stable")
            tx = np.concatenate([tx[keep_idx], np.stack(ev_x)])[order]
            ty = np.concatenate([ty[keep_idx], np.asarray(ev_y, np.float32)])[order]
        else:
            tx = tx[keep_idx]
            ty = ty[keep_idx]
        return tx, ty

    def _train_packed(self, net: SpokeNet, tx: np.ndarray, ty: np.ndarray) -> None:
        n = tx.shape[0]
        if n == 0:
            return
        if net.sparse:
            # the packed stream is dense-featured; sparse nets re-sparsify
            # row by row (categorical-rich streams take the per-record
            # route upstream, __main__._packed_training_source)
            sidx, sval = self._dense_rows_to_coo(tx, net.max_nnz)
            for i in range(n):
                self._train(net, (sidx[i], sval[i]), float(ty[i]))
            return
        tx = self._adapt_width(tx, net.dim)
        tx, ty = self._holdout_filter(net, tx, ty)
        i = 0
        total = tx.shape[0]
        while i < total:
            i += self._staged_add(net.batcher, tx, ty, i)
            if net.batcher.full:
                net.flush_batch()

    def _staged_add(self, batcher, tx, ty, i: int) -> int:
        """``batcher.add_many(tx[i:], ty[i:])``, timed as the ``stage``
        phase when the telemetry plane is armed (the fit a full batcher
        triggers times itself into the flush StepTimer: the two never
        nest)."""
        ph = self._phases
        if ph is None:
            return batcher.add_many(tx[i:], ty[i:])
        with ph.phase("stage"):
            return batcher.add_many(tx[i:], ty[i:])

    def _serve_packed(self, net: SpokeNet, x: np.ndarray, f_idx: np.ndarray) -> None:
        if net.serving is not None:
            self._queue_packed(net, x, f_idx)
            return
        f_idx = self._route_packed_candidates(net, x, f_idx)
        if f_idx.size == 0:
            return
        self._serve_packed_baseline(net, x, f_idx)

    def _serve_packed_baseline(
        self, net: SpokeNet, x: np.ndarray, f_idx: np.ndarray
    ) -> None:
        """Immediate packed-route serving through the active model,
        PREDICT_BATCH rows a predict (an armed canary split ran first)."""
        if net.sparse:
            sidx, sval = self._dense_rows_to_coo(x[f_idx], net.max_nnz)
            for j in range(f_idx.size):
                inst = DataInstance(
                    numerical_features=x[int(f_idx[j])].tolist(),
                    operation=FORECASTING,
                )
                self._serve(net, inst, (sidx[j], sval[j]))
            return
        rows = self._adapt_width(x[f_idx], net.dim)
        self._drain_staged_fits(net)
        for s in range(0, f_idx.size, PREDICT_BATCH):
            chunk = rows[s : s + PREDICT_BATCH]
            t0 = time.perf_counter()
            xb = net.predict_pad(chunk.shape[0])
            xb[: chunk.shape[0]] = chunk
            with self.serve_timer:
                preds = net.node.on_forecast_batch(xb)
            for j in range(chunk.shape[0]):
                inst = DataInstance(
                    numerical_features=chunk[j].tolist(), operation=FORECASTING,
                )
                self._emit_prediction(Prediction(net.request.id, inst, float(preds[j])))
            lat = (time.perf_counter() - t0) * 1000.0
            for _ in range(chunk.shape[0]):
                net.serve_stats.note(lat)

    def _queue_packed(self, net: SpokeNet, x: np.ndarray, f_idx: np.ndarray) -> None:
        """Admit packed-route forecast rows into the net's serving queue.
        Dense rows defer the DataInstance to emission; sparse rows carry it
        (its features are the pre-COO dense row). An active canary takes its
        share of the rows first."""
        f_idx = self._route_packed_candidates(net, x, f_idx)
        if f_idx.size == 0:
            return
        plane = self.serving_plane
        if net.sparse:
            sidx, sval = self._dense_rows_to_coo(x[f_idx], net.max_nnz)
            for j in range(f_idx.size):
                inst = DataInstance(
                    numerical_features=x[int(f_idx[j])].tolist(),
                    operation=FORECASTING,
                )
                plane.admit(net, inst, (sidx[j], sval[j]))
            return
        rows = self._adapt_width(x[f_idx], net.dim)
        for j in range(rows.shape[0]):
            plane.admit(net, None, rows[j])

    def _train(self, net: SpokeNet, x, y: float) -> None:
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

    def _serve(self, net: SpokeNet, inst: DataInstance, x) -> None:
        """One forecast as a padded predict (a sparse record as an
        ``(idx, val)`` pair); reading the value back waits for the device
        (one sync per forecast)."""
        t0 = time.perf_counter()
        if net.sparse:
            ib, vb = net.predict_pad(1)
            ib[0], vb[0] = x
            xb = (ib, vb)
        else:
            xb = net.predict_pad(1)
            xb[0] = x
        self._drain_staged_fits(net)
        with self.serve_timer:
            preds = net.node.on_forecast_batch(xb)
        self._emit_prediction(Prediction(net.request.id, inst, float(preds[0])))
        net.serve_stats.note((time.perf_counter() - t0) * 1000.0)

    @staticmethod
    def _drain_staged_fits(net: SpokeNet) -> None:
        """Launch a cohort member's staged gang fits BEFORE a serve-timed
        predict: the predict would otherwise launch them inside the serving
        timer, counting the fit's time there too."""
        cohort = net.pipeline._cohort
        if cohort is not None:
            cohort.launch()

    def _serve_many(self, inst: DataInstance, entries) -> None:
        """Serve one forecast record to many nets: canary-routed forecasts
        serve through their candidate, serving-armed nets queue the rest,
        cohort members answer through ONE gang predict a cohort, the
        others at once; emission keeps the nets' order."""
        if self._any_lifecycle:
            # the canary split at the serve-admission boundary
            kept = []
            for net, x in entries:
                lc = net.lifecycle
                if lc is not None and lc.route_candidate():
                    self._serve_candidate(net, inst, x)
                else:
                    kept.append((net, x))
            entries = kept
        gang_in = []
        t0 = time.perf_counter()
        for net, x in entries:
            if net.serving is not None:
                self.serving_plane.admit(net, inst, x)
            elif net.gang_predict_ok():
                xb = net.predict_pad(1)
                xb[0] = x
                gang_in.append((net, xb))
        ganged = self._gang_predictions(gang_in) if gang_in else {}
        for net, x in entries:
            if net.serving is not None:
                continue
            pred = ganged.get(id(net))
            if pred is None:
                self._serve(net, inst, x)
            else:
                self._emit_prediction(Prediction(net.request.id, inst, pred))
                net.serve_stats.note((time.perf_counter() - t0) * 1000.0)
        if self._any_serving:
            self.serving_plane.maybe_fill_flush()

    def _gang_predictions(self, entries: List[Tuple[SpokeNet, np.ndarray]]) -> Dict[int, float]:
        """One padded predict a cohort with two or more participants;
        returns {id(net): prediction} for the nets a gang served."""
        groups: Dict[Any, List[Tuple[SpokeNet, np.ndarray]]] = {}
        for net, xb in entries:
            groups.setdefault(net.pipeline._cohort, []).append((net, xb))
        out: Dict[int, float] = {}
        for cohort, items in groups.items():
            if len(items) < 2:
                continue
            rows = [(net.pipeline._slot, xb) for net, xb in items]
            preds = cohort.predict_rows(rows)
            for (net, _), (slot, _) in zip(items, rows):
                out[id(net)] = float(preds[slot, 0])
        return out

    # --- cohort gang dispatch (runtime.cohort) ---

    def _flush_cohorts(self) -> None:
        if self.cohorts is not None:
            self.cohorts.flush()

    def _process_packed_gang(self, nets: List[SpokeNet], x, y, f_idx) -> None:
        """Lockstep twin of ``_process_packed_for_net`` over several nets:
        segments between forecasts gang-train, forecasts gang-serve at
        their stream position."""
        if self._process_packed_serving_bulk(nets, x, y, f_idx):
            return
        n = x.shape[0]
        prev = 0
        for f in f_idx:
            f = int(f)
            if f > prev:
                self._train_packed_gang(nets, x[prev:f], y[prev:f])
            self._serve_packed_gang(nets, x, f)
            prev = f + 1
        if prev < n:
            self._train_packed_gang(nets, x[prev:], y[prev:])

    def _train_packed_gang(self, nets: List[SpokeNet], tx: np.ndarray, ty: np.ndarray) -> None:
        """Feed a training segment to every net in batch-size strides: each
        net's row order, holdout cycle and flush points are its solo ones,
        only the flush ORDER across nets interleaves, so same-cohort
        flushes stage into one gang launch (forced by the members' own
        sync points, or at the block's gang barrier)."""
        if tx.shape[0] == 0:
            return
        # cohort members are dense: each takes its own holdout split
        feeds = [[net, *self._holdout_filter(net, self._adapt_width(tx, net.dim), ty), 0]
                 for net in nets]
        pending = True
        while pending:
            pending = False
            for feed in feeds:
                net, ftx, fty, cur = feed
                if cur >= ftx.shape[0]:
                    continue
                cur += self._staged_add(net.batcher, ftx, fty, cur)
                feed[3] = cur
                if net.batcher.full:
                    net.flush_batch()
                if cur < ftx.shape[0]:
                    pending = True

    def _serve_packed_gang(self, nets: List[SpokeNet], x: np.ndarray, f: int) -> None:
        """Serve packed-row forecast ``f`` to every net at its stream
        position: a gang predict for cohort members, the serving queue for
        armed nets, the solo path otherwise."""
        gang_in = []
        rows: Dict[int, np.ndarray] = {}
        routed: set = set()
        t0 = time.perf_counter()
        for net in nets:
            if net.serving is not None:
                # _queue_packed runs the canary split itself
                self._queue_packed(net, x, np.asarray([f]))
                continue
            lc = net.lifecycle
            if lc is not None and lc.canary_active and lc.route_candidate():
                row = self._adapt_width(x[f : f + 1], net.dim)[0]
                self._serve_candidate(net, DataInstance.forecast_payload(row), row)
                routed.add(id(net))
            elif net.gang_predict_ok():
                row = rows.get(net.dim)
                if row is None:
                    row = rows[net.dim] = self._adapt_width(x[f : f + 1], net.dim)[0]
                xb = net.predict_pad(1)
                xb[0] = row
                gang_in.append((net, xb))
        ganged = self._gang_predictions(gang_in) if gang_in else {}
        for net in nets:
            if net.serving is not None or id(net) in routed:
                continue
            pred = ganged.get(id(net))
            if pred is None:
                self._serve_packed_baseline(net, x, np.asarray([f]))
            else:
                inst = DataInstance(numerical_features=rows[net.dim].tolist(),
                                    operation=FORECASTING)
                self._emit_prediction(Prediction(net.request.id, inst, pred))
                net.serve_stats.note((time.perf_counter() - t0) * 1000.0)
        if self._any_serving:
            self.serving_plane.maybe_fill_flush()

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
        if net.serving is not None and net.serve_queue.entries:
            # pending forecasts emit BEFORE the response, as the
            # per-record path would have
            self.serving_plane.flush_net(net)
        net.flush_batch()
        self._flush_cohorts()
        # settle a pending guard trip first: a query never reports a score
        # off the parameters the guard is about to roll back
        self._guard_tick_all()
        # ... and a pending lifecycle decision, so the registry view (and
        # its counters) this response carries is settled too
        self._lifecycle_tick_all()
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
        # the overload plane's shed and throttle counts fold once (as the
        # launch tally), the pressure level is a peak gauge, and the
        # shed-wait p99 max-combines as the serve latency does
        if self._note_wire is not None and self.overload is not None:
            ctl = self.overload
            nid = net.request.id
            shed = ctl.take_shed(nid)
            if shed:
                self._note_wire(nid, 0, "forecasts_shed", shed)
                p99 = ctl.shed_latency_p99(nid)
                if p99:
                    self._note_wire(nid, 0, "shed_latency_ms", p99)
            throttled = ctl.take_throttled(nid)
            if throttled:
                self._note_wire(nid, 0, "records_throttled", throttled)
            if ctl.level_peak:
                self._note_wire(nid, 0, "pressure_level", ctl.level_peak)
        # the codec's seconds fold as a delta since the last fold
        if self._note_wire is not None and net.node.codec is not None:
            c = net.node.codec
            enc = c.encode_seconds - net._codec_folded[0]
            dec = c.decode_seconds - net._codec_folded[1]
            if enc > 0.0 or dec > 0.0:
                self._note_wire(net.request.id, 0, "codec_seconds", (enc, dec))
                net._codec_folded = (c.encode_seconds, c.decode_seconds)
        # the launch percentiles of the fit flush and the serving paths,
        # max-combined hub-side; folded only with the telemetry plane armed
        # (they are wall-clock values, which would make every unarmed
        # report irreproducible)
        if self._note_wire is not None and self.telemetry is not None:
            if self.step_timer.count:
                self._note_wire(net.request.id, 0, "launch_ms",
                                self._timer_percentiles(self.step_timer))
            if self.serve_timer.count:
                self._note_wire(net.request.id, 0, "serve_launch_ms",
                                self._timer_percentiles(self.serve_timer))
        # the lifecycle counters fold once; the live version is a
        # last-write gauge, folded every time (0 after an operator rollback
        # to the Create model included)
        if self._note_wire is not None and net.lifecycle is not None:
            for counter, n in net.lifecycle.take_counters().items():
                self._note_wire(net.request.id, 0, counter, n)
            self._note_wire(net.request.id, 0, "active_version",
                            net.lifecycle.active_version)
        desc = net.pipeline.describe()
        qstats = net.node.query_stats()

        # model parameter buckets (termination probes skip the payload:
        # responseId -1 fragments only feed statistics; a host-side model
        # has no flat vector)
        chunks: List[Optional[np.ndarray]] = [None]
        if response_id != TERMINATION_RESPONSE_ID and not net.pipeline.learner.host_side:
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
                    # the worker's registry view rides the bucket-0
                    # fragment of a lifecycle-armed pipeline
                    lifecycle=(net.lifecycle.describe()
                               if i == 0 and net.lifecycle is not None else None),
                    # the tail of the pipeline's event ring rides the
                    # bucket-0 fragment when the flight recorder is armed
                    events=(self.events.tail_for(net.request.id)
                            if i == 0 and self.events is not None
                            and net.events_cfg is not None else None),
                    source_worker=self.worker_id,
                )
            )

    def handle_terminate_probe(self) -> None:
        """Termination probe: flush + evaluate every net, emit responseId -1
        fragments (FlinkSpoke.scala:136-138) and let worker nodes push final
        state. Paused nets resume and drain first; the serving plane's
        queues are empty afterwards."""
        for net in list(self.nets.values()):
            if net.node.paused:
                net.node.paused = False
            self._drain_pause_buffer(net)
            if self.overload is not None:
                # deferred (throttled) rows train before the final
                # evaluation: deprioritized work is late, never lost
                self._drain_throttled(net)
            net.flush_batch()
            self._flush_cohorts()
            net.node.on_flush()
            self.emit_query_response(net, TERMINATION_RESPONSE_ID)
        if self.serving_plane is not None:
            self.serving_plane.flush_all()

    def receive_from_hub(self, network_id: int, hub_id: int, op: str,
                         payload: Any, seq: Optional[int] = None) -> None:
        net = self.nets.get(network_id)
        if net is None:
            return
        if seq is None or not net.channel_armed:
            self._deliver_from_hub(net, network_id, hub_id, op, payload)
            return
        # the reliable channel: dedupe and reorder through the hub's window;
        # a gap past it drops the codec's receive bases of this hub's
        # streams (the lost deltas desynced them) and NACKs the hub for a
        # resync
        res = net.rx_window(hub_id).offer(seq, op, payload)
        if res.duplicates and self._note_wire is not None:
            self._note_wire(network_id, hub_id, "duplicates_dropped", res.duplicates)
        if res.gap:
            if self._note_wire is not None:
                self._note_wire(network_id, hub_id, "gaps_resynced", 1)
            if self.events is not None and net.events_cfg is not None:
                self.events.record(
                    GAP_RESYNC, "window_gap", pipeline=network_id,
                    worker=self.worker_id, stamp=(network_id, seq), side="worker",
                    hub=hub_id, expected=res.gap_from, got=res.gap_to)
            if net.node.codec is not None:
                net.node.codec.reset_rx_stream(f"h{hub_id}>w{self.worker_id}")
                net.node.codec.reset_rx_stream(f"h{hub_id}>*")
            net.node.send(OP_NACK, {"gap": True}, hub_id)
        for d_op, d_payload in res.deliver:
            self._deliver_from_hub(net, network_id, hub_id, d_op, d_payload)

    def _deliver_from_hub(self, net: SpokeNet, network_id: int, hub_id: int,
                          op: str, payload: Any) -> None:
        # sampled round tracing: an open span on this stream completes
        tel = self.telemetry
        if tel is not None and tel.spans.active:
            tel.spans.maybe_close(network_id, hub_id, self.worker_id, op)
        if self.events is not None and op == OP_RESYNC and net.events_cfg is not None:
            # the worker accepted an authoritative re-ship: the recovery
            # half of a NACK or rejection chain
            self.events.record(CHANNEL_RESYNC, "authoritative_reship",
                               pipeline=network_id, worker=self.worker_id, hub=hub_id)
        if net.serving is not None and net.serve_queue.entries:
            # a hub payload may replace this net's model: exact-mode
            # serving drains the queue with the parameters before it
            self.serving_plane.fence(net)
        # deliver() is the worker's decode boundary (the transport codec)
        net.node.deliver(op, payload, hub_id)
        # cooperative multi-pipeline fairness: every hub RPC for one net
        # TOGGLES the others (FlinkSpoke.scala:127-131); a net that just
        # resumed drains the records buffered while paused. Cohort-attached
        # nets are exempt: gang lockstep gives the fairness the toggle
        # approximates (and a toggle storm across a 64-member cohort would
        # send every member through its pause buffer on each sync reply)
        for other_id, other in list(self.nets.items()):
            if other_id == network_id:
                continue
            if other.pipeline._cohort is not None:
                continue
            other.node.toggle()
            if not other.node.paused:
                self._drain_pause_buffer(other)

    def flush_rx_windows(self) -> None:
        """Stream end: deliver what the receive windows still hold (their
        gaps will never fill). Both dicts are iterated over snapshots: a
        delivered release may drain, push, and make the hub reply into a
        window or net not yet visited."""
        for network_id, net in list(self.nets.items()):
            net._quiesced = True
            for hub_id, window in list(net._rx_windows.items()):
                for op, payload in window.flush():
                    self._deliver_from_hub(net, network_id, hub_id, op, payload)

    # --- the model-integrity guard (omldm_tpu_torch.guard) ---

    def _guard_tick_all(self) -> None:
        """Check every guarded net's newest health value (noted by the
        launches since the last tick: one read a net that launched) and run
        the recovery for any that tripped. One flag read when no hosted
        net is guarded."""
        if not self._any_guard:
            return
        for net in list(self.nets.values()):
            guard = net.pipeline.guard
            if guard is None:
                continue
            reason = guard.check()
            if reason is None:
                guard.maybe_snapshot(net.pipeline)
            else:
                self._guard_trip(net, reason)

    def _guard_trip(self, net: SpokeNet, reason: str) -> None:
        """Divergence on one net: a cohort member is evicted to solo
        execution first (its state leaves the stack, siblings untouched),
        the parameters roll back to the last-known-good snapshot, the
        codec's streams reset, and the worker asks its hubs for a resync
        (OP_NACK -> OP_RESYNC) to catch up with the fleet."""
        nid = net.request.id
        journal = self.events if net.events_cfg is not None else None
        if journal is not None:
            # the trip is the incident: record the chain and dump the ring
            # (the post-mortem must not depend on the stream reaching its end)
            journal.record(GUARD_TRIP, reason, pipeline=nid, worker=self.worker_id)
        if net.pipeline._cohort is not None and self.cohorts is not None:
            self.cohorts.retire(net.pipeline)
            if self._note_wire is not None:
                self._note_wire(nid, 0, "members_evicted", 1)
            if journal is not None:
                journal.record(GUARD_EVICT, reason, pipeline=nid, worker=self.worker_id)
        net.pipeline.guard.rollback(net.pipeline)
        if self._note_wire is not None:
            self._note_wire(nid, 0, "rollbacks_performed", 1)
        if journal is not None:
            journal.record(GUARD_ROLLBACK, reason, pipeline=nid, worker=self.worker_id)
            journal.incident("guard_trip", pipeline=nid)
        if net.serving is not None and net.serve_queue.entries:
            # queued forecasts flush through the rolled-back model, never
            # through the parameters the guard condemned
            self.serving_plane.flush_net(net)
        if net.node.codec is not None:
            # the model was replaced wholesale and corrupt state may have
            # shipped: residuals and top-k bases are stale on both ends
            net.node.codec.reset_streams()
        net.node.request_resync()
        if getattr(net.node, "waiting", False):
            # a blocking worker whose poisoned push was suppressed or
            # rejected may wait on a barrier with nothing in flight, and a
            # hub with no state yet ships no resync: re-push the healthy
            # state so the round completes (barrier entries are
            # worker-keyed, so this is idempotent)
            net.node.resend_state()

    # --- the overload-control plane (runtime.overload) ---

    def _overload_tick(self) -> None:
        """Re-derive the pressure level and act on the transition: entering
        CRITICAL sheds the over-limit tenants' QUEUED forecasts (they would
        otherwise serve through a saturated plane after waiting out the
        episode); recovered tenants, and every tenant at OK, drain their
        deferred training rows back into the stream."""
        ctl = self.overload
        old, new = ctl.tick()
        if new >= CRITICAL and old < CRITICAL and self.serving_plane is not None:
            for net in list(self.nets.values()):
                if (net.overload is not None and net.overload.shed
                        and net.serving is not None and net.serve_queue.entries
                        and ctl.is_over(net.request.id)):
                    self._shed_queued(net)
        for nid in ctl.drainable():
            net = self.nets.get(nid)
            if net is not None and not net.node.paused:
                self._drain_throttled(net)

    def _quarantine_shed(self, net: SpokeNet, payload, depth: int) -> None:
        if self._quarantine is not None:
            # an explicit, reason-coded SHED record carrying the tenant and
            # its queue depth instead of a silent timeout (the stream name
            # is the job's forecasting stream, so it counts as a record)
            self._quarantine("forecastingData", payload, "shed_overload",
                             extra={"tenant": net.request.id, "queueDepth": depth})

    def _shed_forecast(self, net: SpokeNet, inst: DataInstance) -> None:
        """Admission-time shed of one forecasting record (CRITICAL, an
        over-limit tenant): refused before it queues, so it adds no
        shed-latency sample. The payload stays a compact row count, not the
        feature vector: shedding must be far cheaper than serving."""
        self.overload.note_shed(net.request.id, 1)
        self._quarantine_shed(net, "rows=1 source=admission", net.serve_queue.n_rows)

    def _shed_packed(self, net: SpokeNet, f_idx: np.ndarray) -> None:
        """Admission-time shed of a packed block's forecast rows."""
        rows = int(f_idx.size)
        self.overload.note_shed(net.request.id, rows)
        self._quarantine_shed(net, {"rows": rows, "source": "packed"}, net.serve_queue.n_rows)

    def _shed_queued(self, net: SpokeNet) -> None:
        """CRITICAL-entry shed of a tenant's queued forecasts; each entry's
        enqueue-to-shed wait feeds the shedLatencyMs percentile."""
        depth = net.serve_queue.n_rows
        entries, n_rows = self.serving_plane.take_queue(net)
        if not entries:
            return
        ctl = self.overload
        now = ctl.now()
        for inst, x, t0 in entries:
            k = 1 if inst is not None else _entry_rows(x)
            ctl.note_shed(net.request.id, k, (now - t0) * 1000.0)
        self._quarantine_shed(net, {"rows": n_rows, "source": "queue"}, depth)

    def _overload_packed(self, net: SpokeNet, x, y, op, f_idx: np.ndarray) -> None:
        """An over-limit tenant's share of a packed block under pressure:
        its forecasts shed at CRITICAL (and serve at ELEVATED, where only
        training is deprioritized), its training rows defer behind the
        healthy tenants' work."""
        ctl = self.overload
        if f_idx.size:
            if ctl.level >= CRITICAL and net.overload.shed:
                self._shed_packed(net, f_idx)
            else:
                self._serve_packed(net, x, f_idx)
        t_idx = np.nonzero(op == 0)[0]
        if t_idx.size:
            entry = (PACKED, (x[t_idx], y[t_idx], np.zeros((t_idx.size,), np.uint8)),
                     None, None)
            self._defer_training(net, entry, int(t_idx.size))

    def _defer_training(self, net: SpokeNet, entry: tuple, rows: int) -> None:
        """Put an over-limit tenant's training rows in its bounded deferral
        ring (drained when the tenant recovers, pressure clears or the
        terminate probe fires); the oldest rows an overflow drops are
        quarantined with reason ``throttled`` rather than lost silently."""
        ctl = self.overload
        nid = net.request.id
        buf = ctl.deferred.get(nid)
        if buf is None:
            buf = ctl.deferred[nid] = _PauseBuffer(net.overload.defer_cap)
        before = len(buf)
        buf.append(entry)
        ctl.note_throttled(nid, rows)
        evicted = before + rows - len(buf)
        if evicted > 0 and self._quarantine is not None:
            self._quarantine("trainingData", {"rows": evicted}, "throttled",
                             extra={"tenant": nid, "queueDepth": len(buf)})

    def _drain_throttled(self, net: SpokeNet) -> None:
        """Re-admit a tenant's deferred training rows (no second spend: the
        rows were accounted when they arrived)."""
        ctl = self.overload
        if ctl is None:
            return
        buf = ctl.deferred.get(net.request.id)
        if buf is None or buf.is_empty:
            return
        for operation, x, target, _inst in buf.drain():
            if operation == PACKED:
                px, py, pop = x
                self._process_packed_for_net(net, px, py, np.nonzero(pop != 0)[0])
            else:
                self._train(net, x, 0.0 if target is None else target)

    def queue_depths(self) -> Dict[str, int]:
        """This spoke's queue depths: the serving queues, the batchers'
        pending rows, the deferred (throttled) rows, the pause buffers and
        the pre-creation buffers. The overload controller reads some of
        them as pressure signals; after the terminate probe every one must
        be 0 (no stranded rows)."""
        return {
            "serving": self.serving_plane.queued() if self.serving_plane is not None else 0,
            "batcher": int(sum(net.batcher.queued() for net in self.nets.values())),
            "throttled": self.overload.backlog_rows() if self.overload is not None else 0,
            "paused": int(sum(len(net.pause_buffer) for net in self.nets.values())),
            "pre_create": len(self.record_buffer) + len(self._packed_buffer),
        }

    # --- the model-lifecycle plane (runtime.lifecycle) ---

    def _lifecycle_shadow(self, request: Request) -> None:
        """Shadow: register the request's candidate configuration in
        shadow mode. It trains on the same flushed micro-batches and scores
        on the same holdout window while serving stays on the active
        version. The candidate must keep the baseline's flat-parameter SIZE
        (a promotion swaps the protocol node's pipeline and the hub keeps
        its state): a size-changing candidate is quarantined instead (an
        architecture change stays the destructive Update, as in the
        reference)."""
        net = self.nets.get(request.id)
        if net is None or net.lifecycle is None:
            return
        pipe, spec = build_candidate(net, request, net.lifecycle.next_version)
        try:
            cand_size = pipe.get_flat_params()[0].size
            base_size = net.pipeline.get_flat_params()[0].size
        except Exception:
            cand_size = base_size = None  # host-side: no flat contract
        if cand_size != base_size:
            if self._quarantine is not None:
                self._quarantine(
                    "requests", request.to_json(), "rejected_request",
                    detail=("lifecycle candidate changes the parameter shape "
                            f"({cand_size} vs {base_size}); use Update for "
                            "architecture changes"),
                )
            return
        pipe.on_launch = net._note_launch
        net.lifecycle.arm_shadow(pipe, spec)

    def _lifecycle_promote_request(self, request: Request) -> None:
        """Promote: a shadow candidate starts its canary ramp; a canarying
        one completes at once (the operator overrides the rest of the ramp;
        the swap is the same)."""
        net = self.nets.get(request.id)
        if net is None or net.lifecycle is None:
            return
        entry = net.lifecycle.candidate_entry
        if entry is None:
            return
        if entry.state == SHADOW:
            net.lifecycle.start_canary()
        elif entry.state == CANARY:
            self._lifecycle_promote(net)

    def _lifecycle_rollback_request(self, request: Request) -> None:
        """Rollback: demote a live candidate (routing snaps back to the
        baseline, which never moved) or, with no candidate in flight,
        reactivate the retained pre-promotion version."""
        net = self.nets.get(request.id)
        if net is None or net.lifecycle is None:
            return
        lc = net.lifecycle
        if lc.candidate_entry is not None:
            lc.demote_candidate(REASON_OPERATOR)
            return
        entry = lc.previous
        if entry is None:
            return
        if net.serving is not None and net.serve_queue.entries:
            # queued forecasts drain through the outgoing model first
            self.serving_plane.flush_net(net)
        if net.pipeline._cohort is not None and self.cohorts is not None:
            self.cohorts.retire(net.pipeline)
        net.node.pipeline = lc.reactivate(entry, net)
        self._lifecycle_post_swap(net)

    def _lifecycle_tick_all(self) -> None:
        """The decision pass for every net with a live candidate (next to
        the guard tick): a candidate guard trip or shadow-score regression
        rolls the candidate back, a completed ramp promotes it. One flag
        read when no hosted net is lifecycle-armed."""
        if not self._any_lifecycle:
            return
        for net in list(self.nets.values()):
            lc = net.lifecycle
            if lc is None or lc.candidate is None:
                continue
            action = lc.tick(net)
            if action is None:
                continue
            if action[0] == "rollback":
                lc.demote_candidate(action[1])
            else:
                self._lifecycle_promote(net)

    def _lifecycle_promote(self, net: SpokeNet) -> None:
        """The runtime half of a promotion: drain the serving queue through
        the outgoing model, detach it from its cohort (the registry keeps a
        live pipeline for an operator Rollback), install the candidate as
        the protocol node's pipeline and re-anchor the transport and
        protocol state, as a rescale's model seed does."""
        if net.serving is not None and net.serve_queue.entries:
            self.serving_plane.flush_net(net)
        if net.pipeline._cohort is not None and self.cohorts is not None:
            self.cohorts.retire(net.pipeline)
        net.node.pipeline = net.lifecycle.promote(net)
        self._lifecycle_post_swap(net)

    def _lifecycle_post_swap(self, net: SpokeNet) -> None:
        """The shared tail of promote and reactivate: codec residuals and
        top-k bases computed against the replaced model are stale, drift
        baselines re-anchor, and the new active model's guard (a candidate
        always carries one) reseeds its ring at the promoted parameters."""
        if net.node.codec is not None:
            net.node.codec.reset_streams()
        net.node.on_model_seeded()
        if net.pipeline.guard is not None:
            self._any_guard = True
            net.pipeline.guard.reseed(net.pipeline)

    def _serve_candidate(self, net: SpokeNet, inst, row) -> None:
        """Serve one canary-routed forecast through the candidate, at once
        and never queued (the candidate is outside the serving plane's
        staleness contract), tagged with the candidate's version."""
        lc = net.lifecycle
        entry = lc.candidate_entry
        t0 = time.perf_counter()
        rows = np.asarray(row, np.float32).reshape(1, -1)
        with self.serve_timer:
            val = float(lc.predict_candidate(rows)[0])
        self._emit_prediction(Prediction(net.request.id, inst, val, version=entry.version))
        net.serve_stats.note((time.perf_counter() - t0) * 1000.0)

    def _route_packed_candidates(self, net: SpokeNet, x: np.ndarray,
                                 f_idx: np.ndarray) -> np.ndarray:
        """The packed route's canary split: walk the block's forecast rows
        through the count-clocked router; candidate-routed rows serve at
        once, the rest return for the baseline path. The identity (no
        clock tick) without an active canary."""
        lc = net.lifecycle
        if lc is None or not lc.canary_active:
            return f_idx
        keep: List[int] = []
        for f in f_idx:
            f = int(f)
            if lc.route_candidate():
                row = self._adapt_width(x[f : f + 1], net.dim)[0]
                self._serve_candidate(net, DataInstance.forecast_payload(row), row)
            else:
                keep.append(f)
        return np.asarray(keep, np.int64)

    # --- live rescale (FlinkSpoke.scala:345-348, SpokeLogic.scala:37-50) ---

    def set_parallelism(self, n_workers: int) -> None:
        """Propagate a live parallelism change to every hosted node."""
        for net in self.nets.values():
            net.node.set_parallelism(n_workers)

    def absorb(self, retired: "Spoke") -> None:
        """Merge a retiring spoke's state into this one (shrink rescale):
        model replicas merge through the learner's merge, pending batcher
        rows re-enter this spoke's batchers, holdout sets interleave, and
        pre-creation buffers concatenate -- the mergingDataBuffers and
        wrapper-merge semantics of the reference's rescale path
        (SpokeLogic.scala:37-50, FlinkSpoke.scala:289-330)."""
        # pending forecasts on both sides serve before any model merges:
        # the retiring replicas' models are about to go and the survivors'
        # to change
        if retired.serving_plane is not None:
            retired.serving_plane.flush_all()
        if self.serving_plane is not None:
            self.serving_plane.flush_all()
        if retired.overload is not None:
            # throttled rows train into the retiring replicas before the
            # merge (deprioritized work must not vanish with its spoke),
            # and the unfolded shed and throttle counters carry over
            for rnet in retired.nets.values():
                retired._drain_throttled(rnet)
            if self.overload is not None:
                rctl, sctl = retired.overload, self.overload
                for nid in list(rctl._shed):
                    sctl._shed[nid] = sctl._shed.get(nid, 0) + rctl.take_shed(nid)
                for nid in list(rctl._throttled):
                    sctl._throttled[nid] = sctl._throttled.get(nid, 0) + rctl.take_throttled(nid)
                sctl.level_peak = max(sctl.level_peak, rctl.level_peak)
                sctl.total_shed += rctl.total_shed
                sctl.total_throttled += rctl.total_throttled
        # the retiring spoke's cohorts dissolve (members take their state
        # back for the merge); the survivors keep theirs, and merge_from
        # edits flow through the member checkout
        if retired.cohorts is not None:
            retired.cohorts.detach_all()
        self._flush_cohorts()
        for net_id, rnet in retired.nets.items():
            snet = self.nets.get(net_id)
            if snet is None:
                # this spoke never hosted the pipeline (not the case in a
                # job-managed rescale): adopt the retiring replica whole
                self.nets[net_id] = rnet
                if rnet.pipeline.guard is not None:
                    self._any_guard = True
                if rnet.lifecycle is not None:
                    self._any_lifecycle = True
                if rnet.serving is not None:
                    # the retired spoke's plane (flushed above) goes with it
                    rnet._plane = self._ensure_serving_plane()
                if rnet.overload is not None:
                    # and so does its admission accounting
                    if self.overload is None:
                        self.overload = OverloadController(self)
                    self.overload.arm(rnet)
                continue
            # pending rows train into the surviving replica: the batcher's
            # partial fill and any batches a blocking worker held while
            # waiting on a protocol sync (SyncingWorker._blocked)
            pending = [rnet.batcher.drain()]
            for bx, by, bm in getattr(rnet.node, "_blocked", []):
                valid = np.asarray(bm) > 0.0
                if rnet.sparse:
                    bi, bv = bx
                    pending.append(((np.asarray(bi)[valid], np.asarray(bv)[valid]),
                                    np.asarray(by)[valid]))
                else:
                    pending.append((np.asarray(bx)[valid], np.asarray(by)[valid]))
            for entry in pending:
                if entry is None:
                    continue
                px, py = entry
                if rnet.sparse:
                    for i in range(py.shape[0]):
                        snet.batcher.add((px[0][i], px[1][i]), float(py[i]))
                        if snet.batcher.full:
                            snet.flush_batch()
                else:
                    i = 0
                    while i < px.shape[0]:
                        i += snet.batcher.add_many(px[i:], py[i:])
                        if snet.batcher.full:
                            snet.flush_batch()
            snet.pipeline.merge_from([rnet.pipeline])
            # the merge replaced the model wholesale: residuals and top-k
            # bases computed against the pre-merge model are stale, and a
            # guard rollback must not undo the absorbed replica
            if snet.node.codec is not None:
                snet.node.codec.reset_streams()
            if snet.pipeline.guard is not None:
                snet.pipeline.guard.reseed(snet.pipeline)
            # the retiring replica's candidate retires with its spoke
            # (released silently, not counted as a rollback) and its
            # unfolded counters carry over, as the overload counters do
            if rnet.lifecycle is not None:
                rnet.lifecycle.demote_candidate(None)
                if snet.lifecycle is not None:
                    for k, v in rnet.lifecycle.take_counters().items():
                        snet.lifecycle._bump(k, v)
            # holdout windows interleave, keeping the newest
            # (CommonUtils.scala:36-48)
            snet.test_set.merge([rnet.test_set])
            snet.holdout_count += rnet.holdout_count
            # records held under a cooperative pause carry over, and drain
            # at once if the survivor is running
            snet.pause_buffer.merge([rnet.pause_buffer])
            if not snet.node.paused:
                self._drain_pause_buffer(snet)
        self.record_buffer.merge([retired.record_buffer])
        self._packed_buffer.merge([retired._packed_buffer])
        self._poll_counter += retired._poll_counter

    def _drain_pause_buffer(self, net: SpokeNet) -> None:
        if net.pause_buffer.is_empty:
            return
        for operation, x, target, inst in net.pause_buffer.drain():
            if operation == PACKED:
                px, py, pop = x
                self._process_packed_for_net(net, px, py, np.nonzero(pop != 0)[0])
            elif operation == FORECASTING:
                if net.lifecycle is not None and net.lifecycle.route_candidate():
                    self._serve_candidate(net, inst, x)
                elif net.serving is not None:
                    self.serving_plane.admit(net, inst, x)
                else:
                    self._serve(net, inst, x)
            else:
                self._train(net, x, 0.0 if target is None else target)
        if self._any_serving:
            self.serving_plane.maybe_fill_flush()
