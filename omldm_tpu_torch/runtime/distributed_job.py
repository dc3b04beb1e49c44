"""Multi-process streaming deployment: N ingest partitions, one fleet.

Counterpart of ``omldm_tpu/runtime/distributed_job.py``, its core and its
file route. The reference's Flink job runs N parallel subtasks fed by
partitioned topics (README.md:21-29); the deployment here is one Python
process a card (or a share of one), joined in one ``torch.distributed``
process group (``parallel.multihost``):

- each process owns an ingest partition -- row ``i`` of a shared JSON-lines
  file belongs to process ``i % N`` -- and stages its rows as its
  ``[dp_local, B, D]`` rows of the fleet's micro-batch, trained by the
  port's :class:`~omldm_tpu_torch.parallel.spmd.SPMDTrainer` on a fleet
  mesh: the protocol's reductions cross processes through the group;
- the CONTROL PLANE lives on process 0: request lines are broadcast to
  every process as fixed-size uint8 frames over the group. Every process
  hosts the same pipeline map (keyed by networkId); Create/Update deploy,
  Delete tears down, Query answers collectively (the union-holdout
  evaluation with worker 0's model) and process 0 emits the bucketed
  QueryResponse;
- statistics reduce across the group into the reference's JobStatistics
  schema (StatisticsOperator.scala:110-127) and process 0 writes the report.

Every method that reaches the group must be called by every process at the
same point with the same arguments (the broadcast request lines guarantee
it): a process with no rows still enters every agreed round with masked
batches, and every process stages forecasts. In one process nothing
reaches a group and the same code runs alone.

Not here yet (the fleet's later half): checkpoints, restore and rescale,
heartbeats, the hang watchdog, the journal, overload backpressure, the
fault injector, the Kafka drive and the supervisor; the CLI refuses their
flags by name (``FLEET_LATER_FLAGS``).

CLI (the flags of ``python -m omldm_tpu_torch``'s fleet mode)::

    python -m omldm_tpu_torch.runtime.distributed_job \\
        --coordinator 127.0.0.1:9876 --processes 2 --processId 0 \\
        --requests reqs.jsonl --trainingData train.jsonl \\
        --performanceOut perf.jsonl [--device cpu]
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.requests import Request, RequestType, TrainingConfiguration
from omldm_tpu_torch.api.responses import QueryResponse
from omldm_tpu_torch.api.stats import JobStatistics, Statistics
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.parallel import multihost
from omldm_tpu_torch.runtime.control import PipelineManager
from omldm_tpu_torch.runtime.databuffers import ArrayHoldout, SparseHoldout
from omldm_tpu_torch.runtime.responses import ResponseMerger
from omldm_tpu_torch.utils.device import resolve_device

CONTROL_CAP = 1 << 16  # fixed broadcast buffer: 64 KiB of request lines

# rows read from the source between synchronized pump points
CHUNK_ROWS = 4096

# flags of the JAX fleet whose part is not ported yet: flag -> what it arms
FLEET_LATER_FLAGS = {
    **{k: "the fleet checkpoint and restore" for k in (
        "checkpointDir", "restore", "checkpointEvery")},
    **{k: "the fleet's rescale-restore" for k in (
        "rescaleRestore", "rescaleCount", "rescaleSignalDir")},
    "fleetDegraded": "the self-healing fleet supervisor",
    **{k: "the fleet's Kafka drive" for k in (
        "kafkaBrokers", "kafkaTrainTopic", "kafkaForecastTopic", "kafkaRequestTopic",
        "kafkaPollMs", "idleWindows", "startupIdleWindows")},
    "heartbeatDir": "the fleet's heartbeats",
    **{k: "the fleet's collective hang watchdog" for k in (
        "collectiveTimeoutMs", "collectiveWarmupMs")},
    **{k: "the fleet's flight recorder" for k in ("flightRecorder", "blackboxPath")},
    "overload": "the fleet's overload backpressure",
    "profileDir": "the fleet's profiler trace",
    **{k: "the fleet's fault injector (DistributedFaultInjector)" for k in (
        "failProcess", "failAfterRecords", "failAfterChunks", "corruptShardProcess",
        "corruptShardSeq", "corruptShardMode", "severBrokerAfterChunks", "hangProcess",
        "hangAfterChunks", "refuseLaunchProcess", "refuseLaunchCount", "faultStateDir")},
}


def _mesh_and_procs(coordinator, num_processes, process_id, device):
    """Join the process group (if any) and build the fleet's dp mesh. The
    device is checked first: a fleet that asks for CUDA on a host without
    a card raises before it joins."""
    device = resolve_device(device, "DistributedStreamJob")
    if num_processes is not None:
        device = multihost.process_device(device, process_id)
    pid, nproc = multihost.initialize_multihost(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        device=device,
    )
    return multihost.make_multihost_mesh(device), pid, nproc


class _DistPipeline:
    """One pipeline's state on THIS process -- the per-subtask wrapper map
    entry (SpokeLogic.scala:28-29): the fleet's trainer plus this
    partition's holdout split, pending and forecast buffers and
    predictions."""

    def __init__(self, request: Request, dim: int, trainer, test_cap: int, stage_cap: int,
                 sparse: bool = False, max_nnz: int = 0):
        self.request = request
        self.dim = dim
        self.trainer = trainer
        self.stage_cap = stage_cap
        # sparse (padded-COO) pipelines buffer (idx, val) row pairs
        self.sparse = sparse
        self.max_nnz = max_nnz
        self.test_set = SparseHoldout(test_cap, max_nnz) if sparse else ArrayHoldout(test_cap, dim)
        self.holdout_count = 0
        self.pend_x: List[np.ndarray] = []   # dense rows, or COO idx
        self.pend_v: List[np.ndarray] = []   # COO val (sparse only)
        self.pend_y: List[np.ndarray] = []
        self.pend_n = 0
        self.fore_x: List[np.ndarray] = []   # dense rows, or COO idx
        self.fore_v: List[np.ndarray] = []   # COO val (sparse only)
        self.fore_n = 0
        self.predictions: List[float] = []
        self.steps_run = 0
        # pump-granularity learning curve: (fleet-mean loss of the pump's
        # last step, rows staged by every process so far)
        self.curve: List[Tuple[float, int]] = []
        self.global_rows = 0

    @property
    def width(self) -> int:
        return self.max_nnz if self.sparse else self.dim


class DistributedStreamJob:
    """Streaming pipelines trained across every process of the group.

    The training contract mirrors the in-process SPMD bridge: 8-of-10
    holdout split per partition, staged ``[dp_local, B, D]`` micro-batches,
    one fleet step per full stage across ALL processes in lockstep. The
    device is CUDA unless the caller asks for the CPU."""

    def __init__(
        self,
        config: JobConfig,
        coordinator: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        device=None,
    ):
        self.config = config
        self.mesh, self.pid, self.nproc = _mesh_and_procs(
            coordinator, num_processes, process_id, device)
        self.device = self.mesh.device
        self.dp_global = self.mesh.dp_global
        self.dp_local = self.mesh.dp_local
        self.pipeline_manager = PipelineManager()
        self.pipelines: Dict[int, _DistPipeline] = {}
        self.dim: Optional[int] = None  # stream width, set by the first deploy
        self.hash_dims = 0  # trailing hashed-categorical slots within dim
        self.stream_mode: Optional[str] = None  # "dense" | "sparse", pinned
        self.sparse_hash_space = 0  # COO hashed tail width (sparse mode)
        self.responses: List[QueryResponse] = []
        self.response_merger = ResponseMerger(self.responses.append)
        self.orphan_predictions: List[Tuple[int, float]] = []
        self.start_time = time.time()

    def _warn(self, msg: str) -> None:
        print(f"[distributed p{self.pid}] {msg}", file=sys.stderr)

    def backlog_rows(self) -> int:
        """Host-side staging backlog on THIS process: rows buffered ahead of
        the fleet step plus rows the SSP bound refused and requeued."""
        return int(sum(p.pend_n + p.fore_n + p.trainer.requeued_rows
                       for p in self.pipelines.values()))

    # --- fabric primitives ---

    def _collective_reduce(self, values: Sequence[float], op: str) -> np.ndarray:
        """Elementwise sum/max of a small per-process float vector over the
        group; returns the reduced vector (identical on every process)."""
        vec = np.asarray(list(values), np.float64)
        if self.nproc == 1:
            return vec
        out = multihost.all_reduce(torch.from_numpy(vec.copy()), op, self.mesh.group)
        return out.numpy()

    def _agree_rounds(self, local_rounds: int) -> int:
        """All processes take the MAX of their desired round counts, so every
        one of them enters the same number of fleet steps (short partitions
        contribute masked batches)."""
        return int(self._collective_reduce([float(local_rounds)], "max")[0])

    def barrier(self) -> None:
        """Fabric barrier (a one-scalar reduction): nobody returns until
        every process reached this point."""
        self._collective_reduce([0.0], "max")

    def _gather_rows(self, rows: np.ndarray) -> np.ndarray:
        """Every process's ``[dp_local, ...]`` rows as the fleet's ``[dp,
        ...]``, in process order (the JAX package's global array)."""
        if self.nproc == 1:
            return rows
        return multihost.all_gather(torch.from_numpy(rows), self.mesh.group).numpy()

    # --- control plane: process-0 broadcast over the group ---

    # frame header: 4-byte payload length + 1-byte continuation flag
    _FRAME_HEADER = 5

    def _frame_batches(self, lines: List[str]) -> List[List[str]]:
        """Greedy-pack request lines into frames that fit the fixed
        broadcast buffer (a fleet-scale Create wave is far larger than one
        frame)."""
        cap = CONTROL_CAP - self._FRAME_HEADER
        batches: List[List[str]] = [[]]
        size = 0
        for line in lines:
            n = len(line.encode("utf-8"))
            if n > cap:
                raise ValueError(
                    f"request line too large for the control broadcast ({n} bytes > {cap})")
            if batches[-1] and size + 1 + n > cap:
                batches.append([])
                size = 0
            size += n + (1 if len(batches[-1]) else 0)
            batches[-1].append(line)
        return batches

    def _broadcast_lines(self, lines: List[str]) -> List[str]:
        """Every process receives process 0's request lines, frame by frame;
        a continuation flag in each header paces the frames, so every
        process loops until process 0's flag clears without knowing the
        total up front."""
        out: List[str] = []
        batches = self._frame_batches(lines) if self.pid == 0 else [[]]
        i = 0
        while True:
            batch = batches[i] if i < len(batches) else []
            more = self.pid == 0 and i + 1 < len(batches)
            received, more = self._broadcast_frame(batch, more)
            out.extend(received)
            i += 1
            if not more:
                return out

    def _broadcast_frame(self, lines: List[str], more: bool) -> Tuple[List[str], bool]:
        """One fixed-size group broadcast from process 0 of a CONTROL_CAP
        uint8 host tensor; returns (lines, more) as decoded from it."""
        payload = "\n".join(lines).encode("utf-8") if self.pid == 0 else b""
        hdr = self._FRAME_HEADER
        if len(payload) > CONTROL_CAP - hdr:
            raise ValueError(
                f"control broadcast overflow ({len(payload)} bytes > {CONTROL_CAP - hdr}); "
                "split the request batch")
        row = np.zeros((CONTROL_CAP,), np.uint8)
        row[:4] = np.frombuffer(np.uint32(len(payload)).tobytes(), np.uint8)
        row[4] = 1 if more else 0
        row[hdr : hdr + len(payload)] = np.frombuffer(payload, np.uint8)
        if self.nproc > 1:
            row = multihost.broadcast(torch.from_numpy(row), 0, self.mesh.group).numpy()
        n = int(np.frombuffer(row[:4].tobytes(), np.uint32)[0])
        text = row[hdr : hdr + n].tobytes().decode("utf-8")
        return [line for line in text.split("\n") if line], bool(row[4])

    def sync_requests(self, lines: Optional[List[str]] = None) -> None:
        """Process 0 passes its pending request lines; every process runs
        the SAME control-plane transitions afterwards (the broadcast makes
        the lines identical, so the group calls a Query or a Create makes
        stay in step). Anything invalid or unsupported is LOGGED and
        dropped, never silently ignored (PipelineMap.scala:34,46)."""
        for line in self._broadcast_lines(list(lines or [])):
            request = Request.from_json(line)
            if request is None:
                self._warn(f"dropping unparseable request line: {line[:120]!r}")
                continue
            err = self.pipeline_manager.validate(request)
            if err is not None:
                self._warn(f"rejecting {request.request.value} for pipeline {request.id}: {err}")
                continue
            if request.request in (RequestType.CREATE, RequestType.UPDATE):
                self._deploy(request)
            elif request.request == RequestType.DELETE:
                self.pipeline_manager.apply(request)
                dropped = self.pipelines.pop(request.id, None)
                if dropped is not None:
                    # predictions already served belong to the output even
                    # though the pipeline is gone
                    self.orphan_predictions.extend((request.id, v) for v in dropped.predictions)
                self._warn(f"pipeline {request.id} deleted")
            elif request.request == RequestType.QUERY:
                self._answer_query(request)

    def _request_dim(self, request: Request) -> Optional[int]:
        ds = request.learner.data_structure if request.learner else None
        if ds and "nFeatures" in ds:
            return int(ds["nFeatures"]) + int(
                request.training_configuration.extra.get("hashDims", 0))
        return None

    def _deploy(self, request: Request) -> None:
        """Deploy or replace one pipeline on the fleet. Every pipeline shares
        the stream, so its width must agree with the one pinned by the first
        deploy; anything the fleet cannot host is rejected WITH a logged
        reason."""
        from omldm_tpu_torch.parallel.spmd import SPMDTrainer

        ds = (request.learner.data_structure if request.learner else None) or {}
        sparse = bool(ds.get("sparse"))
        if self.stream_mode is not None and (self.stream_mode == "sparse") != sparse:
            self._warn(
                f"rejecting pipeline {request.id}: the stream is {self.stream_mode} (pinned "
                f"by the first deploy) and a {'sparse' if sparse else 'dense'} pipeline "
                "cannot share its parse route")
            return
        # sparse widths are EXACT (hashSpace inside nFeatures)
        dim = (int(ds.get("nFeatures", 0)) or None) if sparse else self._request_dim(request)
        if dim is None:
            self._warn(
                f"rejecting pipeline {request.id}: distributed deployment needs "
                "dataStructure.nFeatures on the Create (the stream width must be known "
                "before partitions start)")
            return
        if self.dim is not None and dim != self.dim:
            self._warn(f"rejecting pipeline {request.id}: feature width {dim} != stream "
                       f"width {self.dim} pinned by the first deploy")
            return
        tc = request.training_configuration or TrainingConfiguration(protocol="Synchronous")
        try:
            trainer = SPMDTrainer(
                request.learner, request.preprocessors or (), dim=dim,
                protocol=tc.protocol, mesh=self.mesh, training_configuration=tc,
                batch_size=self.config.batch_size)
        except ValueError as exc:
            self._warn(f"rejecting pipeline {request.id}: {exc}")
            return
        hash_dims = 0 if sparse else int(tc.extra.get("hashDims", 0))
        if self.dim is not None and hash_dims != self.hash_dims:
            self._warn(f"rejecting pipeline {request.id}: hashDims {hash_dims} != stream "
                       f"hashDims {self.hash_dims} pinned by the first deploy")
            return
        max_nnz = int(ds.get("maxNnz", 40)) if sparse else 0
        hash_space = int(ds.get("hashSpace", 0)) if sparse else 0
        if sparse and self.pipelines:
            pinned = next(iter(self.pipelines.values())).max_nnz
            if max_nnz != pinned or hash_space != self.sparse_hash_space:
                self._warn(
                    f"rejecting pipeline {request.id}: COO layout (maxNnz {max_nnz}, "
                    f"hashSpace {hash_space}) differs from the stream layout pinned by the "
                    "first deploy")
                return
        self.pipeline_manager.apply(request)
        self.dim = dim
        self.hash_dims = hash_dims
        self.stream_mode = "sparse" if sparse else "dense"
        if sparse:
            self.sparse_hash_space = hash_space
        if request.id in self.pipelines:
            self._warn(f"pipeline {request.id} replaced by {request.request.value} "
                       "(fresh model state)")
        self.pipelines[request.id] = _DistPipeline(
            request, dim, trainer, self.config.test_set_size,
            self.dp_local * self.config.batch_size, sparse=sparse, max_nnz=max_nnz)

    # --- data path: this process's partition only ---

    def handle_partition_rows(self, x: np.ndarray, y: np.ndarray) -> None:
        """Buffer rows of THIS process's partition for EVERY live pipeline,
        holdout-split per pipeline as the in-process runtime splits per
        worker. Rows are trained only inside :meth:`pump`, where every
        process agrees on the round count first."""
        if x.shape[0] == 0:
            return
        for p in self.pipelines.values():
            self._buffer_rows(p, (x,), y)

    def handle_partition_rows_sparse(self, idx: np.ndarray, val: np.ndarray,
                                     y: np.ndarray) -> None:
        """COO twin of :meth:`handle_partition_rows`."""
        if idx.shape[0] == 0:
            return
        for p in self.pipelines.values():
            self._buffer_rows(p, (idx, val), y)

    def _buffer_rows(self, p: _DistPipeline, cols: Tuple[np.ndarray, ...], y: np.ndarray) -> None:
        """The 8-of-10 holdout split of one block: ``cols`` are the dense
        rows, or the COO (idx, val); rows the full holdout ring evicts train
        at their stream position."""
        n = y.shape[0]
        if self.config.test:
            c = (p.holdout_count + np.arange(n)) % 10
            p.holdout_count += n
            test_mask = c >= 8
            keep = np.nonzero(~test_mask)[0]
            t_idx = np.nonzero(test_mask)[0]
            evicted = p.test_set.append_many(*(a[t_idx] for a in cols), y[t_idx])
            ev_src = evicted[-1]
            if ev_src.size:
                order = np.argsort(np.concatenate([keep, t_idx[ev_src]]), kind="stable")
                cols = tuple(np.concatenate([a[keep], e])[order]
                             for a, e in zip(cols, evicted[:-2]))
                y = np.concatenate([y[keep], evicted[-2]])[order]
            else:
                cols, y = tuple(a[keep] for a in cols), y[keep]
        else:
            p.holdout_count += n
        if y.shape[0]:
            p.pend_x.append(np.asarray(cols[0], np.int32 if p.sparse else np.float32))
            if p.sparse:
                p.pend_v.append(np.asarray(cols[1], np.float32))
            p.pend_y.append(np.asarray(y, np.float32))
            p.pend_n += y.shape[0]

    def handle_forecast_rows(self, x: np.ndarray) -> None:
        """Buffer forecast rows of this partition for every pipeline; they
        are served at the next :meth:`pump` with worker 0's model."""
        if x.shape[0] == 0:
            return
        for p in self.pipelines.values():
            p.fore_x.append(np.asarray(x, np.float32))
            p.fore_n += x.shape[0]

    def handle_forecast_rows_sparse(self, idx: np.ndarray, val: np.ndarray) -> None:
        if idx.shape[0] == 0:
            return
        for p in self.pipelines.values():
            p.fore_x.append(np.asarray(idx, np.int32))
            p.fore_v.append(np.asarray(val, np.float32))
            p.fore_n += idx.shape[0]

    def pump(self, final: bool = False) -> None:
        """Run the agreed number of lockstep fleet steps per pipeline over
        the buffered rows, then serve the buffered forecasts. Call at
        synchronized points of the drive loop (``final=True`` drains
        remainders with zero-masked padding). Pipelines go in sorted id
        order so every process makes the same group calls."""
        for net_id in sorted(self.pipelines):
            p = self.pipelines[net_id]
            self._pump_pipeline(p, final)
            self._pump_forecasts(p)

    @staticmethod
    def _take(chunks: List[np.ndarray], shape, dtype) -> np.ndarray:
        return np.concatenate(chunks) if chunks else np.zeros(shape, dtype)

    def _pump_pipeline(self, p: _DistPipeline, final: bool) -> None:
        cap = p.stage_cap
        want = -(-p.pend_n // cap) if final else p.pend_n // cap
        rounds = self._agree_rounds(int(want))
        if rounds == 0:
            return
        b, width, dpl = self.config.batch_size, p.width, self.dp_local
        xdt = np.int32 if p.sparse else np.float32
        buf_x = self._take(p.pend_x, (0, width), xdt)
        buf_v = self._take(p.pend_v, (0, width), np.float32) if p.sparse else None
        buf_y = self._take(p.pend_y, (0,), np.float32)
        p.pend_x, p.pend_v, p.pend_y = [], [], []
        requeued: List[tuple] = []  # row blocks refused by the SSP bound this pump
        done = staged = 0
        last_loss = None
        for _ in range(rounds):
            rows = max(min(cap, buf_x.shape[0] - done), 0)
            x = np.zeros((cap, width), xdt)
            v = np.zeros((cap, width), np.float32) if p.sparse else None
            y = np.zeros((cap,), np.float32)
            mask = np.zeros((cap,), np.float32)
            if rows:
                x[:rows] = buf_x[done : done + rows]
                if p.sparse:
                    v[:rows] = buf_v[done : done + rows]
                y[:rows] = buf_y[done : done + rows]
                mask[:rows] = 1.0
            done += rows
            staged += rows
            xg = x.reshape(dpl, b, width)
            vg = v.reshape(dpl, b, width) if p.sparse else None
            yg, mg = y.reshape(dpl, b), mask.reshape(dpl, b)
            last_loss = p.trainer.step((xg, vg) if p.sparse else xg, yg, mg, valid_count=rows)
            p.steps_run += 1
            if p.trainer.protocol == "SSP":
                self._requeue_refused(p, xg, vg, yg, mg, requeued)
        # the trainer's own curve is per process; the fleet's curve below
        # replaces it
        p.trainer._curve.clear()
        # the pending buffer: the un-stepped tail PLUS the SSP-refused rows
        # (the tail alone would drop them)
        tail = done < buf_x.shape[0]
        p.pend_x = [buf_x[done:]] if tail else []
        if p.sparse:
            p.pend_v = [buf_v[done:]] if tail else []
        p.pend_y = [buf_y[done:]] if tail else []
        p.pend_n = max(buf_x.shape[0] - done, 0)
        requeued_rows = 0
        for blk in requeued:
            p.pend_x.append(blk[0])
            if p.sparse:
                p.pend_v.append(blk[1])
            p.pend_y.append(blk[-1])
            p.pend_n += blk[0].shape[0]
            requeued_rows += blk[0].shape[0]
        # one learning-curve point a pump: the fleet-mean loss of the last
        # step and the rows consumed by every process (one group sum)
        loss_sum, consumed = self._collective_reduce(
            [float(last_loss.sum()), float(staged - requeued_rows)], "sum")
        p.global_rows += int(consumed)
        p.curve.append((loss_sum / self.dp_global, p.global_rows))

    def _requeue_refused(self, p: _DistPipeline, xg, vg, yg, mg, requeued) -> None:
        """SSP pacing across processes: the step refuses batches of workers
        past the staleness bound (state untouched, accepted 0); each process
        collects ITS OWN workers' refused rows into ``requeued`` (merged back
        into the pending buffer after the round loop) and corrects the
        fitted counter."""
        for w in np.nonzero(~p.trainer.last_accepted())[0]:
            rows = mg[w] > 0.0
            k = int(rows.sum())
            if k == 0:
                continue
            p.trainer.note_requeued(k)
            if p.sparse:
                requeued.append((xg[w][rows].astype(np.int32), vg[w][rows].astype(np.float32),
                                 yg[w][rows].astype(np.float32)))
            else:
                requeued.append((xg[w][rows].astype(np.float32), yg[w][rows].astype(np.float32)))

    def _pump_forecasts(self, p: _DistPipeline) -> None:
        """Serve the buffered forecast rows: agreed rounds, worker 0's model
        brought to every process once (one group broadcast), each process
        predicting ITS rows, a stage of rows a round."""
        cap = p.stage_cap
        rounds = self._agree_rounds(-(-p.fore_n // cap))
        if rounds == 0:
            return
        w0 = p.trainer.worker0()
        buf = self._take(p.fore_x, (0, p.width), np.int32 if p.sparse else np.float32)
        buf_v = self._take(p.fore_v, (0, p.width), np.float32) if p.sparse else None
        p.fore_x, p.fore_v, p.fore_n = [], [], 0
        for done in range(0, buf.shape[0], cap):
            x = buf[done : done + cap]
            if p.sparse:
                x = (x, buf_v[done : done + cap])
            p.predictions.extend(float(v) for v in p.trainer.predict(x, worker0=w0))

    def flush(self) -> None:
        """Drain every pipeline, SSP-requeued rows included: repeated final
        pumps progress under balanced partitions; where NOBODY advanced, a
        dried-up partition pins the staleness bound and the termination
        release lifts it (SSPParameterServer.on_terminate); a livelock guard
        backstops pathological streams."""
        self.pump(final=True)
        for net_id in sorted(self.pipelines):
            p = self.pipelines[net_id]
            guard = 0
            while self._agree_rounds(1 if p.pend_n else 0):
                before = p.pend_n
                self._pump_pipeline(p, final=True)
                if not self._agree_rounds(1 if p.pend_n < before else 0):
                    p.trainer.release_stragglers()
                guard += 1
                if guard > 1000:
                    raise RuntimeError("SSP drain made no progress requeuing refused rows")
            self._pump_forecasts(p)

    # --- queries ---

    def _answer_query(self, request: Request) -> None:
        """Answer a user Query COLLECTIVELY: the union-holdout evaluation
        and worker 0's parameters reach every process; process 0 assembles
        the bucketed QueryResponse fragments as the SPMD bridge does
        (FlinkNetwork.scala:196-231 wire format; the fleet is one logical
        model, so the merger expects one fragment set)."""
        p = self.pipelines.get(request.id)
        if p is None:
            # admitted by the gatekeeper but never deployed here (e.g. a
            # rejected sparse Create): say so instead of dropping
            self._warn(f"query for undeployed pipeline {request.id} dropped")
            return
        self._pump_pipeline(p, final=True)
        w0 = p.trainer.worker0()
        loss, score = self._evaluate_global(p, w0)
        flat = p.trainer.global_flat_params(worker0=w0)
        fitted = int(self._collective_reduce([float(p.trainer.fitted)], "sum")[0])
        if self.pid != 0:
            return
        rid = request.request_id if request.request_id is not None else 0
        bucket_cap = self.config.max_param_bucket_size
        chunks = [flat[i : i + bucket_cap] for i in range(0, max(flat.size, 1), bucket_cap)]
        req = p.request
        learner_desc = {
            "name": req.learner.name,
            "hyperParameters": dict(req.learner.hyper_parameters or {}),
            "dataStructure": dict(req.learner.data_structure or {}),
        }
        self.response_merger.expect(rid, 1)
        for i, chunk in enumerate(chunks):
            learner = dict(learner_desc) if i == 0 else {"name": learner_desc["name"]}
            learner["parameters"] = {"bucketValues": chunk.tolist()}
            self.response_merger.add_fragment(QueryResponse(
                response_id=rid,
                mlp_id=req.id,
                bucket=i,
                num_buckets=len(chunks),
                preprocessors=[
                    {"name": pr.name, "hyperParameters": dict(pr.hyper_parameters or {})}
                    for pr in (req.preprocessors or [])
                ] if i == 0 else None,
                learner=learner,
                protocol=req.training_configuration.protocol if i == 0 else None,
                data_fitted=fitted,
                loss=loss,
                score=score,
                source_worker=0,
            ))

    # --- reporting ---

    def _evaluate_global(self, p: _DistPipeline, w0=None) -> Tuple[float, float]:
        """Loss and score of worker 0's model on the UNION of every process's
        holdout set: each process lays its holdout in row 0 of its
        ``[dp_local, cap, ...]`` rows, the rows of every process are
        gathered in process order (the JAX package's global array) and
        evaluated as one masked batch, the same on every process."""
        cap = p.test_set.max_size
        width = p.width
        xs = np.zeros((self.dp_local, cap, width), np.int32 if p.sparse else np.float32)
        vs = np.zeros((self.dp_local, cap, width), np.float32) if p.sparse else None
        ys = np.zeros((self.dp_local, cap), np.float32)
        ms = np.zeros((self.dp_local, cap), np.float32)
        n = len(p.test_set)
        if n:
            cols = p.test_set.arrays()
            xs[0, :n] = cols[0]
            if p.sparse:
                vs[0, :n] = cols[1]
            ys[0, :n] = cols[-1]
            ms[0, :n] = 1.0
        xs, ys, ms = self._gather_rows(xs), self._gather_rows(ys), self._gather_rows(ms)
        x = xs.reshape(-1, width)
        if p.sparse:
            x = (x, self._gather_rows(vs).reshape(-1, width))
        return p.trainer.evaluate(x, ys.reshape(-1), ms.reshape(-1),
                                  worker0=w0 or p.trainer.worker0())

    def _global_device_counters(self, p: _DistPipeline) -> Tuple[int, int, int]:
        """(syncs summed over the fleet's workers, worker 0's syncs, worker
        0's steps): one group sum in a fleet."""
        return p.trainer._counters()

    def pipeline_statistics(self, p: _DistPipeline) -> Tuple[Statistics, int]:
        """One pipeline's Statistics (the reference schema,
        FlinkHub.scala:118-153) with group-reduced counters, plus the
        fleet's holdout size. Every process must call it in the same
        order."""
        loss, score = self._evaluate_global(p)
        t = p.trainer
        syncs_sum, syncs00, steps = self._global_device_counters(p)
        sync_count, total_bytes = t.protocol_traffic_bytes(
            t.protocol, t.dp, t.flat_size, syncs_sum, syncs00, steps)
        # the same counters priced at the transport codec's wire width
        _, wire_bytes = t.protocol_traffic_bytes(
            t.protocol, t.dp, t.flat_size, syncs_sum, syncs00, steps, codec=t.codec_name)
        reduced = self._collective_reduce(
            [float(t.fitted), float(len(p.test_set)), float(p.pend_n)], "sum")
        stats = Statistics(
            pipeline=p.request.id,
            protocol=t.protocol,
            models_shipped=sync_count * t.dp,
            bytes_shipped=int(total_bytes),
            bytes_on_wire=int(wire_bytes),
            num_of_blocks=sync_count,
            fitted=int(round(reduced[0])),
            learning_curve=[loss_ for loss_, _ in p.curve],
            lcx=[r for _, r in p.curve],
            mean_buffer_size=float(reduced[2]) / self.nproc,
            score=score,
            fleet_processes=self.nproc,
        )
        return stats, int(round(reduced[1]))

    def merged_report(self) -> Optional[dict]:
        """The job report in the reference's JobStatistics schema: one
        Statistics entry per live pipeline, counters reduced over the group,
        the score on the union holdout. Every process calls it; only process
        0 gets the dict (with the deployment extras), the others None."""
        entries = []
        holdout = {}
        requeued_local = 0
        for net_id in sorted(self.pipelines):
            p = self.pipelines[net_id]
            stats, hold = self.pipeline_statistics(p)
            entries.append(stats)
            holdout[str(net_id)] = hold
            requeued_local += p.trainer.requeued_rows
        # rows left staged at terminate, summed over the group (the SLO
        # evaluator's no-stranded-rows gate reads it)
        stranded = self._collective_reduce([float(self.backlog_rows())], "sum")
        if self.pid != 0:
            return None
        report = JobStatistics(
            job_name=self.config.job_name,
            parallelism=self.dp_global,
            duration_ms=(time.time() - self.start_time) * 1000.0,
            statistics=entries,
        ).to_dict()
        report["processes"] = self.nproc
        report["fleetProcesses"] = self.nproc
        report["rescalesPerformed"] = 0
        report["fleetDegraded"] = 0
        report["holdout"] = holdout
        # LOCAL count (process 0's workers): > 0 proves the SSP requeue ran
        report["requeuedLocal"] = requeued_local
        report["terminateAccounting"] = {"backlogRows": int(stranded[0])}
        return report


# --- the drive ---


def _sync_requests_from_flags(job: DistributedStreamJob, flags: Dict[str, str]) -> None:
    """Deploy the --requests file (process 0 reads, everyone syncs)."""
    lines: List[str] = []
    if job.pid == 0 and flags.get("requests"):
        with open(flags["requests"]) as f:
            lines = [line.strip() for line in f if line.strip()]
    job.sync_requests(lines)


def _load_request_schedule(flags: Dict[str, str]) -> List[Tuple[int, str]]:
    """The count-clocked mid-stream request schedule (--requestSchedule):
    JSONL ``{"atRecord": N, "request": {...}}`` entries, sorted by position.
    EVERY process reads the shared file and computes dueness from the
    cursor (identical across processes), so the group sync fires only at
    pump points where something is due."""
    path = flags.get("requestSchedule")
    if not path:
        return []
    entries: List[Tuple[int, str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                obj = json.loads(line)
                entries.append((int(obj["atRecord"]), json.dumps(obj["request"])))
    entries.sort(key=lambda e: e[0])
    return entries


def _schedule_start(schedule: List[Tuple[int, str]], resume_cursor: int) -> int:
    """First schedule index NOT yet delivered at ``resume_cursor``: entries
    at or before the cut count as delivered (as in the JAX package, so a
    fresh run, at cursor 0, skips entries at record 0)."""
    i = 0
    while i < len(schedule) and schedule[i][0] <= resume_cursor:
        i += 1
    return i


def _deliver_due_requests(job: DistributedStreamJob, schedule: List[Tuple[int, str]],
                          idx: int, cursor: int) -> int:
    """Deliver every schedule entry with ``atRecord <= cursor`` (one group
    sync for the batch); returns the advanced index."""
    if idx >= len(schedule) or schedule[idx][0] > cursor:
        return idx
    due: List[str] = []
    while idx < len(schedule) and schedule[idx][0] <= cursor:
        due.append(schedule[idx][1])
        idx += 1
    job.sync_requests(due if job.pid == 0 else [])
    return idx


def _sparse_tools(job: DistributedStreamJob):
    """(SparseFastParser, SparseVectorizer) for the job's pinned COO
    layout."""
    from omldm_tpu_torch.ops.native import SparseFastParser
    from omldm_tpu_torch.runtime.vectorizer import SparseVectorizer

    p0 = next(iter(job.pipelines.values()))
    parser = SparseFastParser(job.dim - job.sparse_hash_space, job.sparse_hash_space,
                              p0.max_nnz)
    return parser, SparseVectorizer(job.dim, job.sparse_hash_space, p0.max_nnz)


def _consume_sparse_block(job: DistributedStreamJob, parser, vec, block: bytes,
                          line_base: int, nproc: int, pid: int) -> int:
    """Parse a line-aligned COO block, keep this process's stride (row
    ``line_base + i`` belongs to process ``(line_base + i) % nproc``), and
    buffer its training and forecast rows for every pipeline. Rows the C
    parser defers (valid == 2) go through the Python codec at their stream
    position. Returns the number of lines consumed."""
    from omldm_tpu_torch.api.data import FORECASTING, DataInstance
    from omldm_tpu_torch.runtime.vectorizer import F32_MAX

    idx, val, y, op, valid = parser.parse(block)
    n = idx.shape[0]
    if n == 0:
        return 0
    mine = ((line_base + np.arange(n)) % nproc) == pid
    fast = mine & (valid == 1)
    train = fast & (op == 0)
    fore = fast & (op != 0)
    fallback = np.nonzero(mine & (valid == 2))[0]
    lines = block.split(b"\n") if fallback.size else None
    prev = 0
    for s in list(fallback) + [n]:
        s = int(s)
        seg = slice(prev, s)
        if train[seg].any():
            t = train[seg]
            job.handle_partition_rows_sparse(idx[seg][t], val[seg][t], y[seg][t])
        if fore[seg].any():
            f = fore[seg]
            job.handle_forecast_rows_sparse(idx[seg][f], val[seg][f])
        if s >= n:
            break
        inst = DataInstance.from_json(lines[s].decode("utf-8", errors="replace"))
        if inst is not None:
            i1, v1 = vec.vectorize(inst)
            if inst.operation == FORECASTING:
                job.handle_forecast_rows_sparse(i1[None], v1[None])
            else:
                yv = (0.0 if inst.target is None
                      else float(min(max(float(inst.target), -F32_MAX), F32_MAX)))
                job.handle_partition_rows_sparse(i1[None], v1[None],
                                                 np.asarray([yv], np.float32))
        prev = s + 1
    return n


def _drive_file_sparse(job: DistributedStreamJob, flags: Dict[str, str]) -> None:
    """Sparse (padded-COO) file drive: line-aligned chunks through the C
    COO parser, row i striped to process i % nproc -- the sparse twin of
    the dense strided drive. Chunks are sized in bytes: the pump cadence
    only needs to be IDENTICAL across processes, which byte chunks are."""
    from omldm_tpu_torch.runtime.spmd_bridge import _line_aligned_chunks

    parser, vec = _sparse_tools(job)
    chunk_rows = int(flags.get("chunkRows", str(CHUNK_ROWS)))
    line_base = 0
    for buf, stop in _line_aligned_chunks(flags["trainingData"],
                                          max(chunk_rows * 256, 1 << 16)):
        block = bytes(memoryview(buf)[:stop])
        line_base += _consume_sparse_block(job, parser, vec, block, line_base,
                                           job.nproc, job.pid)
        job.pump()
    job.flush()


def _drive_file(job: DistributedStreamJob, flags: Dict[str, str]) -> None:
    """Strided partition of a shared JSON-lines file: row i belongs to
    process i % nproc (the deterministic stand-in for a Kafka partition
    assignment). Uses the same native bulk parser as the single-process
    CLI; every process pumps after the same chunk."""
    from omldm_tpu_torch.runtime.fast_ingest import iter_file_batches

    schedule = _load_request_schedule(flags)
    sched_idx = _schedule_start(schedule, 0)
    cursor = 0
    chunk_rows = int(flags.get("chunkRows", str(CHUNK_ROWS)))
    for bx, by, bop in iter_file_batches(flags["trainingData"], job.dim, chunk_rows,
                                         job.hash_dims):
        n = bx.shape[0]
        mine = ((cursor + np.arange(n)) % job.nproc) == job.pid
        cursor += n
        train = mine & (bop == 0)
        if train.any():
            job.handle_partition_rows(bx[train], by[train])
        fore = mine & (bop != 0)
        if fore.any():
            job.handle_forecast_rows(bx[fore])
        job.pump()
        sched_idx = _deliver_due_requests(job, schedule, sched_idx, cursor)
    # entries scheduled past the end of the stream still belong to it:
    # deliver them at the final cut instead of dropping them
    if sched_idx < len(schedule):
        _deliver_due_requests(job, schedule, sched_idx, schedule[-1][0])
    job.flush()


def fleet_flags(flags: Dict[str, str]) -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(coordinator, processes, process id) of a fleet launch, or Nones for
    one process. ``--processes`` above 1 needs ``--coordinator`` and
    ``--processId``; a ``--coordinator`` or ``--processId`` without
    ``--processes`` is refused by name, as is a half-named fleet: the port
    never runs alone what was asked to join a group."""
    if "processes" not in flags:
        for key in ("coordinator", "processId"):
            if key in flags:
                raise SystemExit(f"--{key} needs --processes N (the fleet's size)")
        return None, None, None
    nproc = int(flags["processes"])
    if nproc < 1:
        raise SystemExit(f"--processes {nproc}: a fleet has at least one process")
    pid = int(flags.get("processId", "0"))
    if not 0 <= pid < nproc:
        raise SystemExit(f"--processId {pid} outside [0, --processes {nproc})")
    if nproc == 1:
        return None, None, None
    for key in ("coordinator", "processId"):
        if key not in flags:
            raise SystemExit(f"--processes {nproc} needs --{key}")
    return flags["coordinator"], nproc, pid


def refuse_fleet_later(flags: Dict[str, str]) -> None:
    """SystemExit naming the first flag of the fleet's later half."""
    for key, what in FLEET_LATER_FLAGS.items():
        if key in flags:
            raise SystemExit(f"--{key}: {what} is not ported to omldm_tpu_torch's fleet")


def run_distributed(argv: Optional[List[str]] = None) -> int:
    """The fleet's file route: every process runs the same command with its
    own ``--processId``. Returns 0; raises SystemExit for a flag it
    refuses."""
    from omldm_tpu_torch.__main__ import parse_flags, refuse_unported

    flags = parse_flags(list(argv or []))
    refuse_unported(flags)
    refuse_fleet_later(flags)
    coordinator, nproc, pid = fleet_flags(flags)
    if "trainingData" not in flags:
        raise SystemExit("--trainingData is required in file mode")
    if "requests" not in flags:
        raise SystemExit("--requests is required")
    config = JobConfig(
        job_name=flags.get("jobName", "OMLDM"),
        batch_size=int(flags.get("batchSize", "256")),
        test_set_size=int(flags.get("testSetSize", "64")),
    )
    job = DistributedStreamJob(config, coordinator=coordinator, num_processes=nproc,
                               process_id=pid, device=flags.get("device"))
    try:
        _sync_requests_from_flags(job, flags)
        if not job.pipelines:
            raise SystemExit(
                "no pipeline deployed: the requests file must contain at least one valid "
                f"Create/Update with dataStructure.nFeatures ({flags.get('requests')!r})")
        if job.stream_mode == "sparse":
            _drive_file_sparse(job, flags)
        else:
            _drive_file(job, flags)
        # post-training control-plane sync point: a second request file
        # handled after the stream drains (queries see the trained model;
        # Deletes drop pipelines from the report)
        if flags.get("requestsFinal"):
            final_lines: List[str] = []
            if job.pid == 0:
                with open(flags["requestsFinal"]) as f:
                    final_lines = [line.strip() for line in f if line.strip()]
            job.sync_requests(final_lines)
        # predictions per process (suffixed: a shared path would keep only
        # the last writer's rows), responses and performance from process 0
        if flags.get("predictionsOut"):
            path = flags["predictionsOut"]
            if job.nproc > 1:
                path = f"{path}.p{job.pid}"
            with open(path, "w") as f:
                for net_id, v in job.orphan_predictions:
                    f.write(json.dumps({"mlpId": net_id, "value": v}) + "\n")
                for net_id in sorted(job.pipelines):
                    for v in job.pipelines[net_id].predictions:
                        f.write(json.dumps({"mlpId": net_id, "value": v}) + "\n")
        report = job.merged_report()
        if report is not None:
            if flags.get("responsesOut"):
                with open(flags["responsesOut"], "w") as f:
                    for resp in job.responses:
                        f.write(resp.to_json() + "\n")
            if flags.get("performanceOut"):
                with open(flags["performanceOut"], "w") as f:
                    f.write(json.dumps(report) + "\n")
            print(json.dumps(report))
        # process 0 hosts the group's store: nobody leaves before all are done
        job.barrier()
    finally:
        multihost.shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(run_distributed(sys.argv[1:]))
