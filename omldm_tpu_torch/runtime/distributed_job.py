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

The recovery half (the role of Flink's checkpoint barriers and
FlinkSpoke.scala:233-334's operator state):

- checkpoints snapshot the SHARED fleet state once (gathered over the
  group, written by process 0) plus each process's cursor and buffers, at
  synchronized pump points, in the JAX package's layout file for file, so
  a snapshot of either package restores in the other;
- restore resumes every process from the newest snapshot valid on every
  process (sha256 digests, then a full load), falling back a generation
  when a shard is torn or lost; a snapshot of N processes restores across
  M (shards merged or seeded, fleet rows redistributed);
- heartbeats (``--heartbeatDir``), the collective hang watchdog
  (``--collectiveTimeoutMs``: a survivor of a wedged peer exits
  ``HANG_EXIT``), a standing rescale signal (``--rescaleSignalDir``: a
  snapshot, then ``RESCALE_EXIT``), the decision journal
  (``--flightRecorder``), the staging backlog's overload level
  (``--overload``) and the process fault injector.

Not here yet: the Kafka drive (ROADMAP queue 1, item 4.2) and the fleet
supervisor (item 4.3); the CLI refuses their flags by name
(``FLEET_LATER_FLAGS``).

CLI (the flags of ``python -m omldm_tpu_torch``'s fleet mode)::

    python -m omldm_tpu_torch.runtime.distributed_job \\
        --coordinator 127.0.0.1:9876 --processes 2 --processId 0 \\
        --requests reqs.jsonl --trainingData train.jsonl \\
        --performanceOut perf.jsonl [--device cpu] \\
        [--checkpointDir D --checkpointEvery K] [--restore true]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.requests import Request, RequestType, TrainingConfiguration
from omldm_tpu_torch.api.responses import QueryResponse
from omldm_tpu_torch.api.stats import JobStatistics, Statistics
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.parallel import multihost
from omldm_tpu_torch.runtime.control import PipelineManager
from omldm_tpu_torch.pipelines.pipeline import _leaves, _rebuild, fleet_state_from_numpy
from omldm_tpu_torch.runtime import events as ev
from omldm_tpu_torch.runtime.databuffers import ArrayHoldout, SparseHoldout
from omldm_tpu_torch.runtime.overload import parse_overload_spec
from omldm_tpu_torch.runtime.responses import ResponseMerger
from omldm_tpu_torch.utils.device import resolve_device
from omldm_tpu_torch.utils.tracing import StepTimer

CONTROL_CAP = 1 << 16  # fixed broadcast buffer: 64 KiB of request lines

# rows read from the source between synchronized pump points
CHUNK_ROWS = 4096

# flags of the JAX fleet whose part is not ported yet: flag -> what it arms
FLEET_LATER_FLAGS = {
    **{k: "the fleet's Kafka drive" for k in (
        "kafkaBrokers", "kafkaTrainTopic", "kafkaForecastTopic", "kafkaRequestTopic",
        "kafkaPollMs", "idleWindows", "startupIdleWindows", "severBrokerAfterChunks")},
    "fleetDegraded": "the self-healing fleet supervisor",
}


# --- elastic rescale-restore helpers (pure) ---------------------------------


def rescale_shard_map(old_n: int, new_n: int, pid: int) -> List[int]:
    """Old-process checkpoint shards owned by NEW process ``pid`` when an
    ``old_n``-process snapshot restores across ``new_n`` processes: old
    shard q merges into survivor ``q % new_n`` -- the distributed twin of
    the in-process shrink's ``id % n_new`` merge (StreamJob.rescale).
    Under grow this degenerates to identity for ``pid < old_n`` and the
    empty list for the seeded new processes; at ``old_n == new_n`` it is
    exactly ``[pid]``."""
    return [q for q in range(old_n) if q % new_n == pid]


def _interleave_perm(lengths: Sequence[int]) -> List[int]:
    """Flat row indices that round-robin across blocks of the given
    lengths (block rows are laid out back to back): [b0[0], b1[0], ...,
    b0[1], b1[1], ...]. Merged per-process stripes stay a fair stream-order
    mix -- the holdout/pending interleave of the in-process ``Spoke.absorb``
    (SpokeLogic.scala:37-50 semantics)."""
    offsets = np.cumsum([0] + list(lengths))
    perm: List[int] = []
    for j in range(max(lengths, default=0)):
        for i, n in enumerate(lengths):
            if j < n:
                perm.append(int(offsets[i]) + j)
    return perm


def _interleave_rows(blocks: List[np.ndarray]) -> np.ndarray:
    """Round-robin row interleave of [n_i, ...] arrays (see
    :func:`_interleave_perm`)."""
    cat = np.concatenate(blocks)
    return cat[_interleave_perm([b.shape[0] for b in blocks])]


def _rescale_fleet_leaf(full: np.ndarray, key: str, dp_new: int) -> np.ndarray:
    """Redistribute one gathered fleet-state leaf (leading axis: the global
    dp worker rows) across a NEW worker-row count:

    - grow: new rows seed from the fleet model -- a copy of worker row 0
      (the replica queries and evaluations read), the in-process grow's
      seed-from-spoke-0; per-row accumulators that must not inflate the
      fleet totals (EF residuals, cum_loss) seed at zero instead;
    - shrink: retired row q merges into survivor ``q % dp_new`` -- model
      state (params, preps) by group MEAN (rows are fed round-robin
      stripes, so equal weight is the faithful merge), fleet-total
      accumulators (cum_loss) by group SUM, codec EF residuals reset (the
      model they were computed against is gone), and round-accounting
      counters (step, syncs, clock, accepted, est, ...) keep the SURVIVOR
      row's own values, so every surviving worker stays on the round
      schedule it checkpointed at."""
    dp_old = full.shape[0]
    if dp_new == dp_old:
        return full
    if dp_new > dp_old:
        if key in ("ef", "cum_loss"):
            extra = np.zeros((dp_new - dp_old,) + full.shape[1:], full.dtype)
        else:
            extra = np.repeat(full[:1], dp_new - dp_old, axis=0)
        return np.concatenate([full, extra], axis=0)
    if key in ("params", "preps"):
        return np.stack([full[w::dp_new].mean(axis=0).astype(full.dtype)
                         for w in range(dp_new)])
    if key == "cum_loss":
        return np.stack([full[w::dp_new].sum(axis=0).astype(full.dtype)
                         for w in range(dp_new)])
    if key == "ef":
        return np.zeros((dp_new,) + full.shape[1:], full.dtype)
    return full[:dp_new]


def _merge_cursors(cursors: List[Any]) -> Any:
    """One process's resume cursor from the per-process cursors of an
    N-process snapshot. Kafka cursors (``{"data": {...}, "requests":
    {...}}``) UNION across processes -- the new partition stripe scatters
    old assignments across every new process, so each one needs the full
    per-partition offset map (max wins where a stale superset entry
    collides with the owner's newer value). File cursors (row ints,
    ``{"bytes", "lines"}`` dicts) are fleet-global and identical at a
    synchronized pump point, so the first shard speaks for everyone."""
    cursors = [c for c in cursors if c is not None]
    if not cursors:
        return None
    head = cursors[0]
    if isinstance(head, dict) and "data" in head:
        data: Dict[str, int] = {}
        requests: Dict[str, int] = {}
        for c in cursors:
            for k, v in (c.get("data") or {}).items():
                data[k] = max(int(v), data.get(k, 0))
            for k, v in (c.get("requests") or {}).items():
                requests[k] = max(int(v), requests.get(k, 0))
        return {"data": data, "requests": requests}
    return head


def _atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_write_json(path: str, obj: Any) -> None:
    _atomic_write_bytes(path, json.dumps(obj).encode("utf-8"))


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Write ``arrays`` as an npz through the fsync'd writer (the
    checkpoint barrier orders the LATEST flip after these writes; the fsync
    makes them durable); returns the sha256 of the bytes as written, which
    the snapshot's metadata pins, so restore verifies a generation before
    trusting, or even loading, it."""
    import hashlib
    import io

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    _atomic_write_bytes(path, data)
    return hashlib.sha256(data).hexdigest()


def _file_sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


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

    def __init__(self, request: Request, raw_line: str, dim: int, trainer, test_cap: int,
                 stage_cap: int, sparse: bool = False, max_nnz: int = 0):
        self.request = request
        self.raw_line = raw_line  # the request's JSON line, for checkpoint manifests
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
        # liveness callback invoked mid-deploy: a fleet-scale Create wave
        # (or a restore redeploying it) builds pipelines for longer than a
        # heartbeat window, and a provably alive worker must not read as
        # beat-silent
        self.beat_hook: Optional[Callable[[], None]] = None
        self.start_time = time.time()
        # overload control (runtime/overload.py; --overload): the fleet's
        # pressure signal is the host-side staging backlog; None = unarmed
        self.overload_cfg = parse_overload_spec(config.overload or "")
        # the pressure PEAK since the last heartbeat tick: the drive pumps
        # (drains) right before each tick, so the level at tick time would
        # always read OK
        self._level_window = 0
        # elastic rescale-restore: a snapshot of N processes may restore
        # across M != N; --rescaleRestore false degrades a count mismatch
        # to a warned fresh start
        self.rescale_restore = True
        # cumulative rescale count for Statistics: pinned by a supervisor
        # (--rescaleCount, authoritative across incarnations), else an
        # unsupervised rescale-restore counts itself
        self.rescales_performed = 0
        self._rescale_count_pinned = False
        # telemetry writes the disk refused (heartbeat files), survived as
        # a dropped-write counter instead of a dead worker
        self.hb_write_errors = 0
        # collective hang watchdog (--collectiveTimeoutMs; None = unarmed)
        self.watchdog = None
        self._ckpt_seq = 0
        # wall clock of each collective predict round: its recent p99 rides
        # the heartbeat frame
        self.serve_timer = StepTimer("dist_serve", cap=8192)
        # flight recorder (--flightRecorder / --blackboxPath): the journal
        # half of the plane -- restore, rescale and hang decisions record as
        # typed events, the ring dumps at every dirty chunk tick. None =
        # unarmed
        self.events = None
        self._ev_clock = 0  # records consumed (the journal's count clock)
        ev_cfg = ev.parse_events_spec(config.events or "")
        if ev_cfg is not None:
            self.events = ev.EventJournal(
                cap=ev_cfg.cap, pid=self.pid,
                path=ev_cfg.blackbox_path or config.blackbox_path,
                position=lambda: self._ev_clock, tail_len=ev_cfg.tail)

    def _warn(self, msg: str) -> None:
        print(f"[distributed p{self.pid}] {msg}", file=sys.stderr)

    def _record_event(self, kind: str, cause: str, **fields) -> None:
        """Flight-recorder hook: one attribute read when unarmed."""
        if self.events is not None:
            self.events.record(kind, cause, **fields)

    # --- hang safety (runtime/selfheal.HangWatchdog) ---

    def hang_guard(self, phase: str):
        """Deadline guard around a region that reaches the group:
        re-entrant, refreshed on every entry. The no-op context when the
        watchdog is unarmed (the default)."""
        if self.watchdog is None:
            from contextlib import nullcontext

            return nullcontext()
        return self.watchdog.guard(phase)

    def arm_hang_watchdog(self, timeout_s: float, warmup_s: Optional[float] = None) -> None:
        """Arm the collective watchdog: a guarded region that makes no
        progress for ``timeout_s`` (first entry a phase: ``warmup_s``)
        dumps this process's black box and exits
        :data:`~omldm_tpu_torch.runtime.selfheal.HANG_EXIT` -- the
        reason-coded "my peer is wedged" exit that blames the SILENT
        process, not this honest survivor."""
        from omldm_tpu_torch.runtime.selfheal import HANG_EXIT, HangWatchdog

        def on_expire(phase: str) -> None:
            self._warn(f"collective watchdog: no progress in {phase!r} for "
                       f"{timeout_s * 1000.0:.0f}ms -- a peer is dead or wedged; dumping "
                       f"black box and exiting HANG_EXIT({HANG_EXIT}) instead of blocking "
                       "forever")
            if self.events is not None:
                self.events.record(ev.HANG, "collective_timeout", phase=phase,
                                   timeout_ms=timeout_s * 1000.0)
                self.events.incident("hang")
            os._exit(HANG_EXIT)

        self.watchdog = HangWatchdog(timeout_s, on_expire, warmup_s=warmup_s)

    def note_event_records(self, n: int) -> None:
        """Advance the journal's count clock (records consumed this
        incarnation); called from the chunk tick."""
        if self.events is not None:
            self._ev_clock += int(n)

    # --- overload control (runtime/overload.py) ---

    def backlog_rows(self) -> int:
        """Host-side staging backlog on THIS process: rows buffered ahead of
        the fleet step plus rows the SSP bound refused and requeued."""
        return int(sum(p.pend_n + p.fore_n + p.trainer.requeued_rows
                       for p in self.pipelines.values()))

    def overload_level(self) -> int:
        """0 OK / 1 ELEVATED / 2 CRITICAL from the staging backlog; 0 when
        unarmed."""
        cfg = self.overload_cfg
        if cfg is None:
            return 0
        backlog = self.backlog_rows()
        if backlog >= cfg.backlog_critical:
            return 2
        if backlog >= cfg.backlog_high:
            return 1
        return 0

    def _note_pressure(self) -> None:
        """Track the pressure peak across a pump window (called by the
        row-buffering paths, while the backlog is honest, before the pump
        drains it)."""
        if self.overload_cfg is not None:
            self._level_window = max(self._level_window, self.overload_level())

    def overload_level_window(self) -> int:
        """The worst pressure level since the last call (folded with the
        instantaneous level), then reset: the heartbeat's level."""
        level = max(self._level_window, self.overload_level())
        self._level_window = 0
        return level

    def heartbeat_frame(self) -> dict:
        """The compact metrics frame this worker's heartbeat file carries:
        the window-peak pressure level, the collective predict's serve p99
        ms, the staging backlog, and the journal's high-water id and alert
        count. ``imbalance`` (a host-plane signal) and ``alerts`` stay 0
        here; the keys ride the frame so one parser serves both planes."""
        return {
            "level": self.overload_level_window(),
            "serveP99": round(self.serve_timer.recent_p99(), 3),
            "imbalance": 0.0,
            "backlog": int(self.backlog_rows()),
            "events": self.events.high_water if self.events is not None else 0,
            "alerts": self.events.alerts if self.events is not None else 0,
        }

    # --- fabric primitives ---

    def _collective_reduce(self, values: Sequence[float], op: str) -> np.ndarray:
        """Elementwise sum/max of a small per-process float vector over the
        group; returns the reduced vector (identical on every process)."""
        vec = np.asarray(list(values), np.float64)
        if self.nproc == 1:
            return vec
        # every completed reduce is fleet progress: the (re-entrant) guard
        # entry refreshes any outer phase's hang deadline
        with self.hang_guard("reduce"):
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
        with self.hang_guard("control"):
            self._sync_requests_guarded(lines)

    def _deploy_beat(self, i: int) -> None:
        if self.beat_hook is not None and i % 256 == 255:
            self.beat_hook()

    def _sync_requests_guarded(self, lines: Optional[List[str]] = None) -> None:
        for i, line in enumerate(self._broadcast_lines(list(lines or []))):
            self._deploy_beat(i)
            request = Request.from_json(line)
            if request is None:
                self._warn(f"dropping unparseable request line: {line[:120]!r}")
                continue
            err = self.pipeline_manager.validate(request)
            if err is not None:
                self._warn(f"rejecting {request.request.value} for pipeline {request.id}: {err}")
                continue
            if request.request in (RequestType.CREATE, RequestType.UPDATE):
                self._deploy(request, line)
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

    def _deploy(self, request: Request, raw_line: str) -> None:
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
            request, raw_line, dim, trainer, self.config.test_set_size,
            self.dp_local * self.config.batch_size, sparse=sparse, max_nnz=max_nnz)
        if self.watchdog is not None:
            # a fresh pipeline's first step warms up again (its kernel's
            # first launch) inside already-warmed phases: re-grant the
            # allowance so the watchdog does not shoot a warming worker
            self.watchdog.rewarm()

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
        self._note_pressure()

    def handle_partition_rows_sparse(self, idx: np.ndarray, val: np.ndarray,
                                     y: np.ndarray) -> None:
        """COO twin of :meth:`handle_partition_rows`."""
        if idx.shape[0] == 0:
            return
        for p in self.pipelines.values():
            self._buffer_rows(p, (idx, val), y)
        self._note_pressure()

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
        self._note_pressure()

    def handle_forecast_rows_sparse(self, idx: np.ndarray, val: np.ndarray) -> None:
        if idx.shape[0] == 0:
            return
        for p in self.pipelines.values():
            p.fore_x.append(np.asarray(idx, np.int32))
            p.fore_v.append(np.asarray(val, np.float32))
            p.fore_n += idx.shape[0]
        self._note_pressure()

    def pump(self, final: bool = False) -> None:
        """Run the agreed number of lockstep fleet steps per pipeline over
        the buffered rows, then serve the buffered forecasts. Call at
        synchronized points of the drive loop (``final=True`` drains
        remainders with zero-masked padding). Pipelines go in sorted id
        order so every process makes the same group calls."""
        with self.hang_guard("pump"):
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
            with self.serve_timer:
                preds = p.trainer.predict(x, worker0=w0)
            p.predictions.extend(float(v) for v in preds)

    def flush(self) -> None:
        """Drain every pipeline, SSP-requeued rows included: repeated final
        pumps progress under balanced partitions; where NOBODY advanced, a
        dried-up partition pins the staleness bound and the termination
        release lifts it (SSPParameterServer.on_terminate); a livelock guard
        backstops pathological streams."""
        self.pump(final=True)
        with self.hang_guard("flush"):
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
            # how many process-count changes this state was carried across,
            # and the fleet's width now
            rescales_performed=self.rescales_performed,
            fleet_processes=self.nproc,
            # telemetry writes the disk refused: heartbeats and ring dumps
            blackbox_write_errors=self.hb_write_errors + (
                self.events.write_errors if self.events is not None else 0),
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
        with self.hang_guard("report"):
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
        report["rescalesPerformed"] = self.rescales_performed
        # slots a supervisor shrank away from the configured width (the
        # supervisor, ROADMAP queue 1 item 4.3, pins it; 0 = full width)
        report["fleetDegraded"] = 0
        report["holdout"] = holdout
        # LOCAL count (process 0's workers): > 0 proves the SSP requeue ran
        report["requeuedLocal"] = requeued_local
        report["terminateAccounting"] = {"backlogRows": int(stranded[0])}
        return report

    # --- checkpoint / restore (FlinkSpoke.scala:233-334 semantics) ---

    def save_checkpoint(self, root: str, cursor: Any) -> str:
        """Write a consistent distributed snapshot. Must be called at a
        synchronized pump point by EVERY process with its own ``cursor``
        (the source position: a row count for the file stripe, ``{"bytes",
        "lines"}`` for the sparse one). The JAX package's layout::

            root/ckpt-<k>/manifest.json     (proc 0: request lines, shape)
            root/ckpt-<k>/fleet_<net>.npz   (proc 0: the gathered fleet state)
            root/ckpt-<k>/proc<p>.npz|.json (each: buffers + cursor)
            root/LATEST                     (proc 0: pointer, flipped last)

        The pointer flips only after a group barrier confirms every
        process's files are durable -- the atomic-commit role of a Flink
        checkpoint barrier's acknowledgement. Every file's sha256 is
        recorded (fleet files in the manifest, each proc shard in its own
        meta), so restore verifies a generation before trusting it."""
        with self.hang_guard("checkpoint"):
            return self._save_checkpoint_guarded(root, cursor)

    def _gather_fleet(self, p: _DistPipeline) -> List[np.ndarray]:
        """The fleet state's leaves in the JAX trainer state's
        ``tree_leaves`` order, each ``[dp_global, hub, ...]`` as
        ``SPMDTrainer.fleet_numpy`` lays a process's rows out: every
        process's rows through one group ``all_gather`` (the leaves packed
        as float64, which holds every float32 and int32 value exactly).
        Every process calls it."""
        leaves = _leaves(p.trainer.fleet_numpy())
        if self.nproc == 1:
            return leaves
        packed = np.concatenate([a.reshape(self.dp_local, -1).astype(np.float64)
                                 for a in leaves], axis=1)
        full = self._gather_rows(packed)
        out, pos = [], 0
        for a in leaves:
            n = int(np.prod(a.shape[1:], dtype=np.int64))
            out.append(full[:, pos : pos + n].astype(a.dtype)
                       .reshape((self.dp_global,) + a.shape[1:]))
            pos += n
        return out

    def _save_checkpoint_guarded(self, root: str, cursor: Any) -> str:
        k = self._ckpt_seq
        self._ckpt_seq += 1
        d = os.path.join(root, f"ckpt-{k}")
        os.makedirs(d, exist_ok=True)
        fleet_digests: Dict[str, str] = {}
        for net_id in sorted(self.pipelines):
            # the gather is a group call every process makes; only process 0
            # writes the file
            leaves = self._gather_fleet(self.pipelines[net_id])
            if self.pid == 0:
                fleet_digests[f"fleet_{net_id}.npz"] = _atomic_savez(
                    os.path.join(d, f"fleet_{net_id}.npz"),
                    {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict[str, Any] = {
            "cursor": cursor,
            "pipelines": {},
            # already-served outputs survive a restore (a deleted pipeline's
            # predictions, process 0's Query responses)
            "orphan_predictions": [[int(n), float(v)] for n, v in self.orphan_predictions],
        }
        if self.pid == 0:
            meta["responses"] = [r.to_dict() for r in self.responses]
        for net_id in sorted(self.pipelines):
            p = self.pipelines[net_id]
            xdt = np.int32 if p.sparse else np.float32
            arrays[f"n{net_id}_pend_x"] = self._take(p.pend_x, (0, p.width), xdt)
            arrays[f"n{net_id}_pend_y"] = self._take(p.pend_y, (0,), np.float32)
            arrays[f"n{net_id}_fore_x"] = self._take(p.fore_x, (0, p.width), xdt)
            if p.sparse:
                arrays[f"n{net_id}_pend_v"] = self._take(p.pend_v, (0, p.width), np.float32)
                arrays[f"n{net_id}_fore_v"] = self._take(p.fore_v, (0, p.width), np.float32)
            if len(p.test_set):
                cols = p.test_set.arrays()
            else:
                cols = ((np.zeros((0, p.width), xdt),)
                        + ((np.zeros((0, p.width), np.float32),) if p.sparse else ())
                        + (np.zeros((0,), np.float32),))
            arrays[f"n{net_id}_test_x"] = np.asarray(cols[0], xdt)
            if p.sparse:
                arrays[f"n{net_id}_test_v"] = np.asarray(cols[1], np.float32)
            arrays[f"n{net_id}_test_y"] = np.asarray(cols[-1], np.float32)
            meta["pipelines"][str(net_id)] = {
                "holdout_count": p.holdout_count,
                "fitted": p.trainer.fitted,
                "steps_host": p.trainer._steps_host,
                "requeued": p.trainer.requeued_rows,
                "steps_run": p.steps_run,
                "predictions": p.predictions,
                "curve": p.curve,
                "global_rows": p.global_rows,
            }
        # the shard's digest rides in the shard's OWN meta (each process
        # writes only its own files)
        meta["sha256"] = _atomic_savez(os.path.join(d, f"proc{self.pid}.npz"), arrays)
        _atomic_write_json(os.path.join(d, f"proc{self.pid}.json"), meta)
        if self.pid == 0:
            _atomic_write_json(os.path.join(d, "manifest.json"), {
                "seq": k,
                "processes": self.nproc,
                "dp_global": self.dp_global,
                "request_lines": [self.pipelines[i].raw_line for i in sorted(self.pipelines)],
                "digests": fleet_digests,
            })
        self.barrier()  # every process's files durable before the flip
        if self.pid == 0:
            _atomic_write_bytes(os.path.join(root, "LATEST"), f"ckpt-{k}".encode())
            # retention: keep JobConfig.checkpoint_keep snapshots (the
            # single-process CheckpointManager's policy); spares survive a
            # torn write of the newest
            import shutil

            keep = max(self.config.checkpoint_keep, 1)
            for seq, cand in self._checkpoint_candidates(root):
                if seq <= k - keep:
                    shutil.rmtree(cand, ignore_errors=True)
        self.barrier()  # nobody races ahead of the visible pointer
        return d

    def _checkpoint_candidates(self, root: str) -> List[Tuple[int, str]]:
        """(seq, dir) of every snapshot under ``root``, newest first."""
        try:
            names = os.listdir(root)
        except OSError:
            return []
        out = []
        for name in names:
            if not name.startswith("ckpt-"):
                continue
            try:
                out.append((int(name.split("-", 1)[1]), os.path.join(root, name)))
            except ValueError:
                continue
        return sorted(out, reverse=True)

    def _validate_checkpoint(self, d: str) -> Optional[dict]:
        """Fully load-check every file THIS process needs from snapshot
        ``d`` (the manifest, the proc shards the rescale shard map hands it,
        every process's meta, the fleet files); returns the manifest, or
        None -- the reason logged and recorded -- when any file is missing,
        truncated, undecodable or fails its digest. Loading every array is
        deliberate: a torn npz can open fine and fail only when its members
        decompress, and restore must never half-load. With rescale-restore
        disabled, a snapshot of another process count checks its manifest
        only (restore then refuses with the knob before touching a
        shard)."""
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            net_ids = [int(json.loads(line)["id"]) for line in manifest["request_lines"]]
            old_n = int(manifest.get("processes", self.nproc))
            if old_n != self.nproc and not self.rescale_restore:
                return manifest
            digests = dict(manifest.get("digests") or {})
            for q in range(old_n):
                with open(os.path.join(d, f"proc{q}.json")) as f:
                    digests[f"proc{q}.npz"] = json.load(f).get("sha256")
            paths = ([os.path.join(d, f"proc{q}.npz")
                      for q in rescale_shard_map(old_n, self.nproc, self.pid)]
                     + [os.path.join(d, f"fleet_{net_id}.npz") for net_id in net_ids])
            for path in paths:
                # integrity first: a recorded digest must match the bytes on
                # disk EXACTLY; a snapshot without digests falls through to
                # the load check
                recorded = digests.get(os.path.basename(path))
                if recorded and _file_sha256(path) != recorded:
                    raise ValueError(f"sha256 mismatch on {os.path.basename(path)}")
                with np.load(path) as z:
                    for key in z.files:
                        _ = z[key]
            return manifest
        except Exception as exc:
            self._warn(f"snapshot {os.path.basename(d)} failed validation: "
                       f"{type(exc).__name__}: {exc}")
            self._record_event(ev.RESTORE, "candidate_rejected", snapshot=os.path.basename(d),
                               error=f"{type(exc).__name__}: {exc}")
            return None

    def _agree_restore_target(self, root: str) -> Tuple[Optional[str], Optional[dict]]:
        """The newest snapshot EVERY process can fully load: each process
        validates candidates newest-first, the fleet agrees on the minimum
        of the per-process bests and re-agrees until one snapshot is valid
        everywhere -- a torn or withheld shard on any process falls the
        whole fleet back to the previous complete snapshot (Flink discards
        an incomplete checkpoint and restores the last COMPLETED one)."""
        ceiling: Optional[int] = None
        while True:
            local_seq, local_manifest = -1, None
            for seq, d in self._checkpoint_candidates(root):
                if ceiling is not None and seq > ceiling:
                    continue
                manifest = self._validate_checkpoint(d)
                if manifest is not None:
                    local_seq, local_manifest = seq, manifest
                    break
            agreed = int(round(-self._collective_reduce([-float(local_seq)], "max")[0]))
            if agreed < 0:
                return None, None
            if agreed != local_seq:
                local_manifest = self._validate_checkpoint(os.path.join(root, f"ckpt-{agreed}"))
            ok = 1.0 if local_manifest is not None else 0.0
            if -self._collective_reduce([-ok], "max")[0] > 0.5:
                return os.path.join(root, f"ckpt-{agreed}"), local_manifest
            ceiling = agreed - 1

    def restore_checkpoint(self, root: str) -> Optional[Any]:
        """Resume every process from the newest CONSISTENT snapshot; returns
        this process's saved cursor (None when no usable snapshot exists).
        Every process calls it before any data is consumed. A snapshot with
        a torn, truncated or missing shard is skipped for the previous
        complete one; process 0 repoints LATEST and prunes the unusable
        snapshots, so later incarnations never retry them."""
        with self.hang_guard("restore"):
            return self._restore_checkpoint_guarded(root)

    def _restore_checkpoint_guarded(self, root: str) -> Optional[Any]:
        latest = os.path.join(root, "LATEST")
        if not os.path.exists(latest) and not self._checkpoint_candidates(root):
            return None
        d, manifest = self._agree_restore_target(root)
        if d is None:
            self._warn("no usable distributed snapshot (every candidate failed validation on "
                       "some process); starting fresh")
            self._record_event(ev.RESTORE, "no_usable_snapshot")
            return None
        pointed = d
        if os.path.exists(latest):
            with open(latest, "rb") as f:
                pointed = os.path.join(root, f.read().decode().strip())
        if os.path.abspath(pointed) != os.path.abspath(d):
            self._warn(f"falling back from {os.path.basename(pointed)} to "
                       f"{os.path.basename(d)} (newer snapshot incomplete)")
            if self.pid == 0:
                # repoint and prune: no later incarnation retries the
                # unusable snapshots, and the next save reuses their seqs
                import shutil

                chosen = int(os.path.basename(d).split("-", 1)[1])
                for seq, cand in self._checkpoint_candidates(root):
                    if seq > chosen:
                        shutil.rmtree(cand, ignore_errors=True)
                _atomic_write_bytes(latest, os.path.basename(d).encode())
            self.barrier()  # nobody proceeds past a half-pruned root
        old_n = int(manifest["processes"])
        if old_n != self.nproc:
            if not self.rescale_restore:
                # a reason-coded refusal, not a crash: the caller redeploys
                # the requests file, and the warning names the knob
                self._warn(
                    f"snapshot {os.path.basename(d)} was taken with {old_n} processes but "
                    f"this fleet has {self.nproc}, and rescale-restore is disabled "
                    "(--rescaleRestore false) -- starting fresh. Relaunch with "
                    "--rescaleRestore true (the default) to redistribute the snapshot "
                    "across the new process count.")
                self._record_event(ev.RESTORE, "rescale_restore_disabled",
                                   snapshot_procs=old_n, fleet_procs=self.nproc)
                return None
            if not self._rescale_count_pinned:
                self.rescales_performed += 1
            self._warn(f"rescale-restore: redistributing a {old_n}-process snapshot across "
                       f"{self.nproc} processes (fleet rows {int(manifest['dp_global'])} -> "
                       f"{self.dp_global}; source stripe re-agreed)")
            self._record_event(ev.RESTORE, "rescale_redistribution", snapshot_procs=old_n,
                               fleet_procs=self.nproc, snapshot=os.path.basename(d))
        else:
            self._record_event(ev.RESTORE, "snapshot", snapshot=os.path.basename(d))
        self._ckpt_seq = int(manifest["seq"]) + 1
        # redeploy the pipeline map from the recorded request lines (every
        # process reads the same manifest); an Update redeploys as a Create,
        # which the gatekeeper admits for a pipeline this incarnation lacks
        for i, line in enumerate(manifest["request_lines"]):
            self._deploy_beat(i)
            request = Request.from_json(line)
            if request is None:
                raise ValueError(f"corrupt manifest request line: {line[:120]!r}")
            if request.request == RequestType.UPDATE:
                request = dataclasses.replace(request, request=RequestType.CREATE)
            self._deploy(request, line)
        # the shards this process merges (exactly [pid] at an unchanged
        # count; the retiring shards' union on shrink; none for a
        # grow-seeded process) and every process's meta
        shards = rescale_shard_map(old_n, self.nproc, self.pid)
        all_metas: List[dict] = []
        for q in range(old_n):
            with open(os.path.join(d, f"proc{q}.json")) as f:
                all_metas.append(json.load(f))
        metas = [all_metas[q] for q in shards]
        self.orphan_predictions = [(int(n), float(v)) for m in metas
                                   for n, v in m.get("orphan_predictions", [])]
        if self.pid == 0:
            # the responses live on old process 0's meta, and shard 0 always
            # maps to new process 0
            self.responses.extend(QueryResponse.from_dict(r)
                                  for r in all_metas[0].get("responses", []))
        shard_arrays = [np.load(os.path.join(d, f"proc{q}.npz")) for q in shards]
        for net_id in sorted(self.pipelines):
            p = self.pipelines[net_id]
            self._restore_fleet(p, os.path.join(d, f"fleet_{net_id}.npz"))
            pms = [m["pipelines"][str(net_id)] for m in metas]
            # additive per-partition counters SUM across merged shards;
            # lockstep counters are equal on every process at a synchronized
            # cut, so max == any
            p.holdout_count = sum(int(pm["holdout_count"]) for pm in pms)
            p.trainer._fitted_host = sum(int(pm["fitted"]) for pm in pms)
            p.trainer._steps_host = max((int(pm["steps_host"]) for pm in pms), default=0)
            p.trainer.requeued_rows = sum(int(pm["requeued"]) for pm in pms)
            p.steps_run = max((int(pm["steps_run"]) for pm in pms), default=0)
            p.predictions = [float(v) for pm in pms for v in pm["predictions"]]
            # the learning curve is fleet-global (reduced at save time): the
            # first merged shard speaks for everyone, and a grow-seeded
            # process adopts old process 0's copy
            curve_src = pms[0] if pms else all_metas[0]["pipelines"].get(
                str(net_id), {"curve": [], "global_rows": 0})
            p.curve = [(float(loss), int(r)) for loss, r in curve_src["curve"]]
            p.global_rows = int(curve_src["global_rows"])
            if shard_arrays:
                self._restore_buffers(p, net_id, shard_arrays)
        return _merge_cursors([m["cursor"] for m in all_metas])

    def _restore_fleet(self, p: _DistPipeline, path: str) -> None:
        """Load a snapshot's fleet file into ``p``'s trainer: each leaf
        redistributed to this fleet's worker count by its top-level state
        key (:func:`_rescale_fleet_leaf`), then rows ``lo:lo+dp_local``
        placed on this process's device (``fleet_state_from_numpy``)."""
        state = p.trainer.state
        keys = [k for k in sorted(state) for _ in _leaves(state[k])]
        with np.load(path) as fleet:
            if len(fleet.files) != len(keys):
                raise ValueError(f"{os.path.basename(path)} holds {len(fleet.files)} leaves, "
                                 f"the pipeline's state {len(keys)}")
            full = [_rescale_fleet_leaf(fleet[f"leaf_{i}"], key, self.dp_global)
                    for i, key in enumerate(keys)]
        p.trainer.load_state(fleet_state_from_numpy(_rebuild(state, iter(full)), p.trainer))

    def _restore_buffers(self, p: _DistPipeline, net_id: int, shard_arrays: List[Any]) -> None:
        """Merge the staged pending, forecast and holdout buffers of every
        checkpoint shard this process owns (one shard at an unchanged count;
        the retiring stripes' union on shrink), rows interleaved round-robin
        so the merged buffers stay a fair stream-order mix."""
        cols = ("x", "v", "y") if p.sparse else ("x", "y")

        def merged(kind: str):
            blocks = [a[f"n{net_id}_{kind}_x"] for a in shard_arrays]
            if not sum(b.shape[0] for b in blocks):
                return None
            perm = _interleave_perm([b.shape[0] for b in blocks])
            return [np.concatenate([a[f"n{net_id}_{kind}_{c}"] for a in shard_arrays])[perm]
                    for c in cols]

        pend = merged("pend")
        if pend is not None:
            p.pend_x, p.pend_y = [pend[0]], [pend[-1]]
            if p.sparse:
                p.pend_v = [pend[1]]
            p.pend_n = int(pend[0].shape[0])
        fore = [a[f"n{net_id}_fore_x"] for a in shard_arrays]
        if sum(b.shape[0] for b in fore):
            perm = _interleave_perm([b.shape[0] for b in fore])
            p.fore_x = [np.concatenate(fore)[perm]]
            if p.sparse:
                p.fore_v = [np.concatenate([a[f"n{net_id}_fore_v"]
                                            for a in shard_arrays])[perm]]
            p.fore_n = int(p.fore_x[0].shape[0])
        test = merged("test")
        if test is not None:
            # merged holdouts can overflow the ring (shrink folds several
            # full rings into one): evicted rows RE-FEED training, as the
            # live split does with its evictions, so no row vanishes with a
            # retired partition
            evicted = p.test_set.append_many(*test)
            if evicted[-1].size:
                p.pend_x.append(np.asarray(evicted[0], np.int32 if p.sparse else np.float32))
                if p.sparse:
                    p.pend_v.append(np.asarray(evicted[1], np.float32))
                p.pend_y.append(np.asarray(evicted[-2], np.float32))
                p.pend_n += int(evicted[-1].size)


# --- the drive ---


def _manifest_is_sparse(flags: Dict[str, str]) -> bool:
    """Restores skip the requests file, so the drive's mode comes from the
    snapshots' recorded Create lines. Sparsity is a job-level property (the
    stream mode is pinned by the first deploy and recorded in every
    snapshot), so when the newest manifest is unreadable -- the corrupt
    snapshot restore itself falls back from -- ANY readable candidate
    answers."""
    root = flags.get("checkpointDir")
    if not root:
        return False
    candidates = []
    latest = os.path.join(root, "LATEST")
    if os.path.exists(latest):
        with open(latest, "rb") as f:
            candidates.append(os.path.join(root, f.read().decode().strip()))
    try:
        names = [n for n in os.listdir(root)
                 if n.startswith("ckpt-") and n.split("-", 1)[1].isdigit()]
    except OSError:
        names = []
    names.sort(key=lambda n: -int(n.split("-", 1)[1]))
    candidates += [os.path.join(root, n) for n in names]
    for d in candidates:
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            continue  # unreadable: restore falls back the same way
        for line in manifest.get("request_lines", []):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            ds = (obj.get("learner") or {}).get("dataStructure") or {}
            if ds.get("sparse"):
                return True
        return False  # the first READABLE manifest decides
    return False


def _flag_true(flags: Dict[str, str], key: str) -> bool:
    return flags.get(key, "").lower() in ("true", "1", "yes")


def _heartbeat(flags: Dict[str, str], pid: int, frame=0) -> bool:
    """Replace this process's heartbeat file (a supervisor's liveness
    channel) at a synchronized pump point, so a process wedged in a
    collective stops beating. The body is the compact metrics frame
    ``<epoch> <pressure-level> [key=value ...]``: token 2 is the
    window-peak overload level, the tail the host-plane signals
    (``serveP99``, ``imbalance``, ``backlog``, ``events``, ``alerts``); a
    bare int ``frame`` writes the two-token form. Returns False when the
    disk refused the write (the caller counts a dropped beat and the worker
    keeps running)."""
    d = flags.get("heartbeatDir")
    if not d:
        return True
    if isinstance(frame, dict):
        level = int(frame.get("level", 0))
        tail = "".join(f" {k}={frame[k]}"
                       for k in ("serveP99", "imbalance", "backlog", "events", "alerts")
                       if k in frame)
    else:
        level, tail = int(frame), ""
    try:
        os.makedirs(d, exist_ok=True)
        # replaced atomically: a reader polling between writes must never
        # see a torn beat
        path = os.path.join(d, f"proc{pid}.hb")
        with open(path + ".tmp", "w") as f:
            f.write(f"{time.time()} {level}{tail}")
        os.replace(path + ".tmp", path)
        return True
    except OSError:
        return False  # a full or odd disk must not kill the job over telemetry


def _maybe_rescale_exit(job: DistributedStreamJob, flags: Dict[str, str], cursor: Any) -> None:
    """Honour a standing rescale signal (``--rescaleSignalDir``): process 0
    reads the target process count from the ``RESCALE`` file, the fleet
    AGREES on it over the group (file visibility can race between
    processes, and an unagreed exit would wedge the survivors), snapshots
    the consistent cut, and every process exits with
    :data:`~omldm_tpu_torch.runtime.supervisor.RESCALE_EXIT` for a relaunch
    at the new count with ``--restore``. Unarmed: no group call."""
    sig_dir = flags.get("rescaleSignalDir")
    if not sig_dir:
        return
    target = 0
    if job.pid == 0:
        try:
            with open(os.path.join(sig_dir, "RESCALE")) as f:
                target = int(f.read().strip() or 0)
        except (OSError, ValueError):
            target = 0
    agreed = int(job._collective_reduce([float(target)], "max")[0])
    if agreed <= 0 or agreed == job.nproc:
        return
    root = flags.get("checkpointDir")
    if not root:
        # without a checkpoint dir the relaunch would lose all state
        job._warn("rescale signal ignored: no --checkpointDir to carry state across the "
                  "relaunch")
        return
    d = job.save_checkpoint(root, cursor)
    job._warn(f"rescale signal honored: snapshot {os.path.basename(d)} taken, fleet exiting "
              f"to relaunch at {agreed} processes")
    if job.events is not None:
        job.events.record(ev.RESCALE, "supervisor_signal_agreed", from_procs=job.nproc,
                          to_procs=agreed, snapshot=os.path.basename(d))
        # the pre-rescale ring must survive the exit
        job.events.incident("rescale")
    from omldm_tpu_torch.runtime.supervisor import RESCALE_EXIT

    raise SystemExit(RESCALE_EXIT)


def _make_injector(job: DistributedStreamJob, flags: Dict[str, str]):
    from omldm_tpu_torch.runtime.supervisor import DistributedFaultInjector

    injector = DistributedFaultInjector(flags, job.pid)
    # the launch-refusal fault fires HERE, before this process's first
    # heartbeat: a worker that died without ever coming up
    injector.on_launch()
    return injector


def _restore_or_fresh(job: DistributedStreamJob, flags: Dict[str, str]):
    """Restore the newest consistent snapshot; when NO candidate is usable
    (restore_checkpoint warned), degrade to a fresh run by deploying the
    requests file instead of dying with no pipelines -- Flink's behaviour
    for a job restarted without a completed checkpoint. Returns the
    restored cursor or None."""
    cur = job.restore_checkpoint(flags["checkpointDir"])
    if cur is None and not job.pipelines:
        _sync_requests_from_flags(job, flags)
    return cur


def _chunk_tick(job: DistributedStreamJob, flags: Dict[str, str], chunk_idx: int, cursor: Any,
                injector, records: int = 0) -> None:
    """One synchronized pump point: heartbeat, checkpoint cadence, fault
    injection, the rescale signal. Every process evaluates the same
    checkpoint condition at the same chunk index, so snapshots are
    consistent; injected crashes fire here too, so a kill lands at one
    well-defined cut (a relaunch with --restore is Flink's global-restart
    strategy)."""
    if not _heartbeat(flags, job.pid, job.heartbeat_frame()):
        job.hb_write_errors += 1
    job.note_event_records(records)
    if job.events is not None and job.events.dirty:
        # dump-on-dirty: a worker killed between ticks leaves a near-current
        # black box
        job.events.dump()
    every = int(flags.get("checkpointEvery", "0"))
    root = flags.get("checkpointDir")
    if every > 0 and root and (chunk_idx + 1) % every == 0:
        d = job.save_checkpoint(root, cursor)
        injector.on_checkpoint(d)
    injector.note_records(records)
    injector.on_chunk(chunk_idx)
    _maybe_rescale_exit(job, flags, cursor)


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
    only needs to be IDENTICAL across processes, which byte chunks are.
    Checkpoint cursors record the line-aligned BYTE offset and the global
    line count (bytes to seek, lines to keep the stripe's phase)."""
    from omldm_tpu_torch.runtime.spmd_bridge import _line_aligned_chunks

    resume = {"bytes": 0, "lines": 0}
    if _flag_true(flags, "restore") and flags.get("checkpointDir"):
        cur = _restore_or_fresh(job, flags)
        if cur is not None:
            resume = dict(cur)
            job._warn(f"restored; resuming at {resume}")
    if job.dim is None:
        raise SystemExit("no pipeline deployed and no snapshot found")
    injector = _make_injector(job, flags)
    parser, vec = _sparse_tools(job)
    chunk_rows = int(flags.get("chunkRows", str(CHUNK_ROWS)))
    consumed = int(resume["bytes"])
    line_base = int(resume["lines"])
    for chunk_idx, (buf, stop) in enumerate(_line_aligned_chunks(
            flags["trainingData"], max(chunk_rows * 256, 1 << 16), start_offset=consumed)):
        block = bytes(memoryview(buf)[:stop])
        n = _consume_sparse_block(job, parser, vec, block, line_base, job.nproc, job.pid)
        line_base += n
        consumed += stop
        job.pump()
        _chunk_tick(job, flags, chunk_idx, {"bytes": consumed, "lines": line_base}, injector,
                    records=n)
    job.flush()


def _drive_file(job: DistributedStreamJob, flags: Dict[str, str]) -> None:
    """Strided partition of a shared JSON-lines file: row i belongs to
    process i % nproc (the deterministic stand-in for a Kafka partition
    assignment). Uses the same native bulk parser as the single-process
    CLI; every process pumps after the same chunk. A restore resumes at the
    snapshot's row cursor, the prefix before it skipped."""
    from omldm_tpu_torch.runtime.fast_ingest import iter_file_batches

    resume_cursor = 0
    if _flag_true(flags, "restore") and flags.get("checkpointDir"):
        cur = _restore_or_fresh(job, flags)
        if cur is not None:
            resume_cursor = int(cur)
            job._warn(f"restored; resuming at row {resume_cursor}")
    if job.dim is None:
        raise SystemExit("no pipeline deployed and no snapshot found")
    injector = _make_injector(job, flags)
    schedule = _load_request_schedule(flags)
    sched_idx = _schedule_start(schedule, resume_cursor)
    cursor = 0
    chunk_idx = 0
    chunk_rows = int(flags.get("chunkRows", str(CHUNK_ROWS)))
    for bx, by, bop in iter_file_batches(flags["trainingData"], job.dim, chunk_rows,
                                         job.hash_dims):
        n = bx.shape[0]
        if cursor + n <= resume_cursor:
            cursor += n
            continue
        if cursor < resume_cursor:
            skip = resume_cursor - cursor
            bx, by, bop = bx[skip:], by[skip:], bop[skip:]
            cursor = resume_cursor
            n = bx.shape[0]
        mine = ((cursor + np.arange(n)) % job.nproc) == job.pid
        cursor += n
        train = mine & (bop == 0)
        if train.any():
            job.handle_partition_rows(bx[train], by[train])
        fore = mine & (bop != 0)
        if fore.any():
            job.handle_forecast_rows(bx[fore])
        # synchronized pump point; scheduled requests land BEFORE the
        # checkpoint cadence, so a snapshot at this cut carries the new
        # topology (a restore never redelivers them: _schedule_start skips
        # the applied prefix)
        job.pump()
        sched_idx = _deliver_due_requests(job, schedule, sched_idx, cursor)
        _chunk_tick(job, flags, chunk_idx, cursor, injector, records=n)
        chunk_idx += 1
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
    own ``--processId``. Returns 0; raises SystemExit for a flag it refuses
    and ``SystemExit(RESCALE_EXIT)`` after honouring a rescale signal; an
    injected crash or a watchdog expiry ends the process where it
    fires."""
    from omldm_tpu_torch.__main__ import parse_flags, refuse_unported
    from omldm_tpu_torch.utils.tracing import trace

    flags = parse_flags(list(argv or []))
    refuse_unported(flags)
    refuse_fleet_later(flags)
    coordinator, nproc, pid = fleet_flags(flags)
    if "trainingData" not in flags:
        raise SystemExit("--trainingData is required in file mode")
    if "requests" not in flags and not _flag_true(flags, "restore"):
        raise SystemExit("--requests is required (or --restore with a checkpoint)")
    config = JobConfig(
        job_name=flags.get("jobName", "OMLDM"),
        batch_size=int(flags.get("batchSize", "256")),
        test_set_size=int(flags.get("testSetSize", "64")),
        # the fleet's pressure signal (the staging backlog's thresholds)
        overload=flags.get("overload", ""),
        # the flight recorder's journal (the bare --events is the
        # in-process CLI's replay file)
        events=flags.get("flightRecorder", ""),
        blackbox_path=flags.get("blackboxPath", ""),
    )
    job = DistributedStreamJob(config, coordinator=coordinator, num_processes=nproc,
                               process_id=pid, device=flags.get("device"))
    try:
        # --rescaleRestore false pins the strict same-count restore;
        # --rescaleCount is a supervisor's authoritative rescale tally
        job.rescale_restore = flags.get("rescaleRestore", "true").lower() not in (
            "false", "0", "no")
        if "rescaleCount" in flags:
            job.rescales_performed = int(flags["rescaleCount"] or 0)
            job._rescale_count_pinned = True
        # --collectiveTimeoutMs arms the hang watchdog; the first guard
        # entry a phase gets --collectiveWarmupMs (a first step's warm-up)
        hang_ms = float(flags.get("collectiveTimeoutMs", "0") or 0)
        if hang_ms > 0:
            job.arm_hang_watchdog(
                hang_ms / 1000.0,
                warmup_s=float(flags.get("collectiveWarmupMs", "120000")) / 1000.0)

        def mid_deploy_beat() -> None:
            if not _heartbeat(flags, job.pid, job.heartbeat_frame()):
                job.hb_write_errors += 1

        job.beat_hook = mid_deploy_beat
        # on a restore the manifest redeploys the pipeline map instead of
        # the requests file (consumed before the first snapshot)
        restoring = (_flag_true(flags, "restore") and bool(flags.get("checkpointDir"))
                     and os.path.exists(os.path.join(flags["checkpointDir"], "LATEST")))
        if not restoring:
            _sync_requests_from_flags(job, flags)
            if not job.pipelines:
                raise SystemExit(
                    "no pipeline deployed: the requests file must contain at least one valid "
                    f"Create/Update with dataStructure.nFeatures ({flags.get('requests')!r})")
        # --profileDir: a torch.profiler trace of this process's drive, one
        # directory a process (a shared one would interleave the files)
        profile_dir = flags.get("profileDir")
        if profile_dir:
            profile_dir = os.path.join(profile_dir, f"proc{job.pid}")
        with trace(profile_dir, job.device):
            if job.stream_mode == "sparse" or (restoring and _manifest_is_sparse(flags)):
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
        # the terminate-time ring is this process's last word in an incident
        if job.events is not None:
            job.events.record(ev.TERMINATE, "drive_complete")
            job.events.dump()
        # process 0 hosts the group's store: nobody leaves before all are done
        job.barrier()
    finally:
        if job.watchdog is not None:
            # the collectives are done (or failed): nothing left to guard
            job.watchdog.stop()
        multihost.shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(run_distributed(sys.argv[1:]))
