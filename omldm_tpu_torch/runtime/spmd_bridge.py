"""SPMDBridge: host one streaming pipeline on the SPMD engine.

Counterpart of ``omldm_tpu/runtime/spmd_bridge.py``. The host plane
multiplexes pipelines across spokes and hubs (message-passing protocol
sync); this bridge is the second deployment mode: a pipeline whose
``trainingConfiguration`` sets ``{"engine": "spmd"}`` trains on
:class:`omldm_tpu_torch.parallel.spmd.SPMDTrainer` instead, every worker a
row of the fleet state and protocol sync a reduction over the workers,
while the pipeline keeps the streaming contract of a host-plane pipeline:
8-of-10 holdout sampling, micro-batch training of evicted and kept
records, forecasting predictions, bucketed query responses, the
responseId -1 termination fragments (one per configured worker, so the
parallelism x pipelines countdown is preserved, StatisticsOperator.scala:109),
and protocol statistics with bytesShipped/modelsShipped accounting from
the collective call sites.

On one card the mesh has one worker (``parallel.mesh.device_slots``), as
the JAX package's has on one chip. The file routes (``ingest_file``,
``ingest_file_overlapped``) run the fused C parse -> holdout -> stage loop
(``ops.native.FusedStage``, ``SparseFusedStage``) straight into the stage
buffers; the overlapped route fills stage k+1 on the calling thread while a
dispatch thread trains stage k. A stage goes to the device as a synchronous
copy from pageable memory, so a stage set is free for the parse thread
again once the dispatch thread's launch call returns.

A job checkpoint (``omldm_tpu_torch.checkpoint``) takes a bridge's holdout
and staged rows through ``snapshot_buffers`` and puts them back with
``restore_buffers``.

With the sharded ingest plane's ``device=on`` (``JobConfig.ingest``,
``runtime.ingest_shard``), ``enable_resident_ingest`` moves a dense
bridge's stage and holdout ring onto its device (``_ResidentIngest``): the
host computes each block's holdout and stage indices, and the rows move by
gathers and scatters on the device; a full stage trains from the resident
tensors as they lie. ``SparseSPMDBridge`` stays on the host route, as in
the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from omldm_tpu_torch.api.data import FORECASTING, DataInstance, Prediction
from omldm_tpu_torch.api.requests import Request
from omldm_tpu_torch.api.responses import TERMINATION_RESPONSE_ID, QueryResponse
from omldm_tpu_torch.api.stats import Statistics
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.ops.native import (
    FusedStage,
    SparseFastParser,
    SparseFusedStage,
    fast_parser_available,
)
from omldm_tpu_torch.parallel.mesh import Mesh, device_slots
from omldm_tpu_torch.parallel.spmd import SPMD_PROTOCOLS, SPMDTrainer
from omldm_tpu_torch.runtime.databuffers import ArrayHoldout, SparseHoldout
from omldm_tpu_torch.runtime.spoke import PREDICT_BATCH, Spoke
from omldm_tpu_torch.runtime.vectorizer import F32_MAX, SparseVectorizer, Vectorizer
from omldm_tpu_torch.utils import resolve_device


# flush remainders pad to this sub-batch instead of a full dp*B group
# (a 1-row tail no longer ships half a megabyte of zeros)
TAIL_BATCH = 256


def _resident_seg_rows(hold_cap: int, test_enabled: bool) -> int:
    """Segment width of the resident scatter. Destinations must be distinct
    within one segment (where two lanes wrote one row, which write lands
    would be the device's choice), so a segment may not carry more test
    rows than the holdout ring holds; the worst case over cycle phases for
    a window of m rows is 2*(m//10) + min(m%10, 2)."""
    if not test_enabled:
        return 4096
    m = 5 * hold_cap
    while m > 1 and (2 * (m // 10) + min(m % 10, 2)) > hold_cap:
        m -= 1
    return max(m, 1)


class _ResidentIngest:
    """Device-resident stage and holdout ring for :class:`SPMDBridge`.

    When armed (``JobConfig.ingest`` with ``device=on``), the stage and the
    holdout ring live as tensors on the bridge's device; the host computes
    only each segment's O(n) index arithmetic (the exact ``_train_rows``
    and ``ArrayHoldout.append_many`` rules; the counters stay on the host),
    and one gather/scatter sequence on the device moves the rows. A full
    stage launches ``step_many_dense`` on the resident stage's
    [chain, dp, B, dim] view: no staging copy on the host, no holdout
    filtering there. Partial drains (flush, snapshot) go back through the
    bridge's host path, so the fitted and holdout row order stays
    bit-identical to the route without residency.

    Each segment is padded to ``seg`` lanes, whose unused lanes write to
    one spare row past the stage (row ``cap``) and past the ring (row
    ``H``) -- the rows JAX's ``mode="drop"`` scatter discards; only views of
    the first ``cap`` and ``H`` rows are ever read. Every other destination
    of a segment is distinct, so what the visible rows hold does not depend
    on the order the device writes in."""

    def __init__(self, bridge: "SPMDBridge"):
        self.bridge = bridge
        ts = bridge.test_set
        self.seg = _resident_seg_rows(ts.max_size, bool(bridge.config.test))
        dev = bridge.trainer.device
        cap, dim = bridge._stage_cap, bridge.dim
        self._sx = torch.zeros((cap + 1, dim), dtype=torch.float32, device=dev)
        self._sy = torch.zeros((cap + 1,), dtype=torch.float32, device=dev)
        self._hx = torch.zeros((ts.max_size + 1, dim), dtype=torch.float32, device=dev)
        self._hy = torch.zeros((ts.max_size + 1,), dtype=torch.float32, device=dev)
        self.push_from_host()

    # --- hot path ---

    def absorb(self, x: np.ndarray, y: np.ndarray) -> None:
        """Resident twin of ``_train_rows`` + ``_stage_rows``: the same
        holdout cycle, eviction order and stage fill order, with the rows
        moved on the device."""
        br = self.bridge
        ts = br.test_set
        n = x.shape[0]
        cap, H, seg = br._stage_cap, ts.max_size, self.seg
        i = 0
        while i < n:
            m = min(seg, n - i)
            if br.config.test:
                c = (br.holdout_count + np.arange(m)) % 10
                test_mask = c >= 8
                # a test row emits a train row only once the ring is full at
                # its turn (it evicts the oldest holdout point)
                free = H - ts._n
                emits = np.where(test_mask, np.cumsum(test_mask) > free, True)
            else:
                test_mask = np.zeros(m, bool)
                emits = np.ones(m, bool)
            train_cum = np.cumsum(emits)
            room = cap - br._stage_n
            if train_cum.size and train_cum[-1] > room:
                # split where the stage fills exactly; trailing rows that emit
                # nothing may ride along (harmless), emitters may not
                m = int(np.searchsorted(train_cum, room, side="right"))
                test_mask = test_mask[:m]
            t_idx = np.nonzero(test_mask)[0]
            keep_idx = np.nonzero(~test_mask)[0]
            fill = min(H - ts._n, t_idx.size)
            k2 = t_idx.size - fill
            head = ts._head
            # evicted points re-enter training at the evicting row's slot:
            # the same stable order as _train_rows' argsort re-merge
            pos = np.concatenate([keep_idx, t_idx[fill:]])
            rank = np.empty(pos.size, np.int64)
            rank[np.argsort(pos, kind="stable")] = np.arange(pos.size)
            base = br._stage_n
            # one upload of the segment's index lanes: ev_slot, ev_dst,
            # keep_src, keep_dst, hold_dst (spare rows: cap, cap, H)
            lanes = np.zeros((5, seg), np.int64)
            ev_slot, ev_dst, keep_src, keep_dst, hold_dst = lanes
            ev_dst[:] = keep_dst[:] = cap
            hold_dst[:] = H
            hold_dst[t_idx[:fill]] = (head + ts._n + np.arange(fill)) % H
            hold_dst[t_idx[fill:]] = ev_slot[:k2] = (head + np.arange(k2)) % H
            ev_dst[:k2] = base + rank[keep_idx.size:]
            keep_src[: keep_idx.size] = keep_idx
            keep_dst[: keep_idx.size] = base + rank[: keep_idx.size]
            rows = np.zeros((seg, br.dim + 1), np.float32)
            rows[:m, :-1] = x[i : i + m]
            rows[:m, -1] = y[i : i + m]
            self._scatter(torch.from_numpy(lanes), torch.from_numpy(rows))
            ts._n += fill
            ts._head = (head + k2) % H
            br.holdout_count += m
            br._stage_n = base + pos.size
            if br._stage_n >= cap:
                self._launch_full()
            i += m

    def _scatter(self, lanes: torch.Tensor, rows: torch.Tensor) -> None:
        """One segment on the device: gather the holdout rows the segment
        evicts (before their slots are overwritten), put them and the kept
        rows into the stage at their stream-order ranks, and put the
        segment's rows into their ring slots (test rows; the rest into the
        spare row)."""
        dev = self._sx.device
        ev_slot, ev_dst, keep_src, keep_dst, hold_dst = lanes.to(dev)
        rows = rows.to(dev)
        bx, by = rows[:, :-1], rows[:, -1]
        self._sx.index_copy_(0, ev_dst, self._hx.index_select(0, ev_slot))
        self._sy.index_copy_(0, ev_dst, self._hy.index_select(0, ev_slot))
        self._sx.index_copy_(0, keep_dst, bx.index_select(0, keep_src))
        self._sy.index_copy_(0, keep_dst, by.index_select(0, keep_src))
        self._hx.index_copy_(0, hold_dst, bx)
        self._hy.index_copy_(0, hold_dst, by)

    def _launch_full(self) -> None:
        br = self.bridge
        b, cap = br.config.batch_size, br._stage_cap
        br.trainer.step_many_dense(self._sx[:cap].view(br.chain, br.dp, b, br.dim),
                                   self._sy[:cap].view(br.chain, br.dp, b))
        br._stage_n = 0

    # --- drains and syncs (the rare paths go through the host route) ---

    def drain_to_host(self) -> None:
        """Launch a partial stage through the bridge's host tail path (whole
        [dp, B] groups, then the padded TAIL_BATCH remainder), so partial
        launches are bit-identical to the route without residency."""
        br = self.bridge
        n = br._stage_n
        br._stage_n = 0
        if n:
            br._launch((self._sx[:n].cpu().numpy(), self._sy[:n].cpu().numpy()), n)

    def sync_host(self) -> None:
        """Copy the resident ring and stage back into the host mirrors
        (checkpoint snapshots read them)."""
        br = self.bridge
        ts = br.test_set
        H, n = ts.max_size, br._stage_n
        ts._x[...] = self._hx[:H].cpu().numpy()
        ts._y[...] = self._hy[:H].cpu().numpy()
        x, y = br._stage.cols
        x[:n] = self._sx[:n].cpu().numpy()
        y[:n] = self._sy[:n].cpu().numpy()

    def push_from_host(self) -> None:
        """Upload the host mirrors (a checkpoint restore writes them)."""
        br = self.bridge
        H, cap = br.test_set.max_size, br._stage_cap
        x, y = br._stage.cols
        self._hx[:H] = torch.from_numpy(br.test_set._x)
        self._hy[:H] = torch.from_numpy(br.test_set._y)
        self._sx[:cap] = torch.from_numpy(np.asarray(x, np.float32))
        self._sy[:cap] = torch.from_numpy(np.asarray(y, np.float32))

    def eval_arrays(self):
        """The holdout eval's inputs straight from the resident ring: the
        same oldest-first order and zero padding as ``ArrayHoldout.arrays``
        and the host's pad, with no round trip through the host."""
        ts = self.bridge.test_set
        H = ts.max_size
        dev = self._hx.device
        idx = torch.from_numpy((ts._head + np.arange(H)) % H).to(dev)
        mask = torch.from_numpy((np.arange(H) < ts._n).astype(np.float32)).to(dev)
        xs = torch.where(mask[:, None] > 0, self._hx.index_select(0, idx), 0.0)
        ys = torch.where(mask > 0, self._hy.index_select(0, idx), 0.0)
        return xs, ys, mask


def spmd_engine_requested(request: Request) -> bool:
    return (
        str(request.training_configuration.extra.get("engine", "")).lower()
        == "spmd"
    )


def spmd_engine_supported(request: Request) -> bool:
    """The engine hosts the 6 collective protocols with device learners;
    anything else falls back to the host plane. Sparse (padded-COO)
    pipelines deploy on :class:`SparseSPMDBridge`."""
    protocol = request.training_configuration.protocol
    learner = request.learner.name if request.learner else ""
    return protocol in SPMD_PROTOCOLS and learner not in ("HT",)


def make_spmd_bridge(request: Request, dim, config, emit_prediction,
                     emit_response, device=None) -> "SPMDBridge":
    """Bridge factory: padded-COO pipelines get the sparse variant."""
    ds = request.learner.data_structure if request.learner else None
    cls = SparseSPMDBridge if (ds and ds.get("sparse")) else SPMDBridge
    return cls(request, dim, config, emit_prediction, emit_response, device)


def _line_aligned_chunks(path: str, chunk_bytes: int):
    """Yield (buf, stop) line-aligned regions of a JSON-lines file from one
    reusable read buffer (readinto + carried partial line; grows when a
    single line exceeds the buffer). Shared by the dense and sparse bulk
    ingest routes so the subtle carry logic exists once."""
    buf = bytearray(chunk_bytes)
    carry = 0
    with open(path, "rb") as f:
        while True:
            if carry >= len(buf):  # one line longer than the buffer
                buf.extend(bytes(len(buf)))
            n = f.readinto(memoryview(buf)[carry:])
            if not n:
                break
            end = carry + n
            cut = buf.rfind(b"\n", 0, end)
            if cut < 0:
                carry = end
                continue
            yield buf, cut + 1
            carry = end - (cut + 1)
            if carry:
                buf[:carry] = buf[cut + 1 : end]
        if carry:
            buf[carry : carry + 1] = b"\n"
            yield buf, carry + 1


class _OverlapDispatcher:
    """Bounded producer/consumer scaffolding shared by the dense and
    sparse double-buffered ingest routes: a pool of ``depth`` spare stage
    sets bounds look-ahead memory (the parse thread blocks on ``swap``
    when the device is behind), a work queue dispatches sets strictly in
    order on one daemon thread, and worker exceptions surface to the
    parse thread — the set returns to the pool even when the launch
    raises, so the producer can never deadlock in ``swap`` instead of
    seeing the error."""

    def __init__(self, make_set, depth: int, train):
        import queue
        import threading

        self.pool: "queue.Queue" = queue.Queue()
        for _ in range(max(depth, 1)):
            self.pool.put(make_set())
        self.work: "queue.Queue" = queue.Queue()
        self.errors: List[BaseException] = []
        self._train = train

        def worker():
            while True:
                item = self.work.get()
                try:
                    if item is None:
                        return
                    stage_set, n = item
                    if not self.errors:
                        self._train(stage_set, n)
                except BaseException as exc:  # surfaced to the producer
                    self.errors.append(exc)
                finally:
                    if item is not None:
                        self.pool.put(item[0])
                    self.work.task_done()

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def submit(self, stage_set, n: int):
        """Queue a filled set, return a fresh one from the pool. Raises
        any pending worker error instead of queueing more work onto a
        dead pipeline."""
        if self.errors:
            raise self.errors[0]
        self.work.put((stage_set, n))
        return self.pool.get()

    def quiesce(self) -> None:
        """Drain the queue (producer-side trainer access needs the worker
        idle); re-raise any worker error."""
        self.work.join()
        if self.errors:
            raise self.errors[0]

    def close(self) -> None:
        self.work.put(None)
        self._thread.join()

    def raise_pending(self) -> None:
        if self.errors:
            raise self.errors[0]


class _StageSet:
    """One set of stage buffers, one array a column (the row's feature
    arrays, then the target), and the C stager over them, built on first
    use. The double-buffered routes keep a pool of sets."""

    __slots__ = ("cols", "fused")

    def __init__(self, cols: Tuple[np.ndarray, ...]):
        self.cols = cols
        self.fused = None


class SPMDBridge:
    """One pipeline, streaming in, trained by the SPMD engine's workers.

    A row is a tuple of columns: ``(x, y)`` here, ``(idx, val, y)`` in
    :class:`SparseSPMDBridge`. The holdout cycle, the staging, the launch
    of whole groups and the striped tail, SSP's requeue, the fused C loop
    and the double-buffered dispatch are written once over those tuples; a
    subclass says what its columns are, how they reach the trainer
    (``_model_input``) and how its C stager is built."""

    # the file routes read line-aligned chunks of this many bytes
    CHUNK_BYTES = 1 << 22
    # a full stage is one chained step_many_dense launch
    CHAINED = True

    def __init__(
        self,
        request: Request,
        dim: int,
        config: JobConfig,
        emit_prediction: Callable[[Prediction], None],
        emit_response: Callable[[QueryResponse], None],
        device=None,
    ):
        self.request = request
        self.config = config
        self._emit_prediction = emit_prediction
        self._emit_response = emit_response
        tc = request.training_configuration
        device = resolve_device(device, "SPMDBridge")
        n_dev = device_slots(device)
        hub = max(int(tc.hub_parallelism), 1)
        if hub > n_dev:
            hub = 1
        # as many mesh workers as the device slots allow, capped by the
        # job's configured parallelism (the virtual worker count for
        # statistics)
        dp = max(min(config.parallelism, n_dev // hub), 1)
        self.trainer = SPMDTrainer(
            request.learner,
            request.preprocessors or (),
            dim=dim,
            protocol=tc.protocol,
            mesh=Mesh(dp, hub, device),
            training_configuration=tc,
            batch_size=config.batch_size,
        )
        self.dp = dp
        self.dim = dim
        self.holdout_count = 0
        # optional narrow feed dtype: float16 staging halves host->device
        # bytes. This is LOSSY quantization of the inputs, not a transport
        # trick: features/targets round to fp16 (~3 decimal digits,
        # |x| <= 65504) before the on-device f32 cast. Opt in only for
        # streams whose value range tolerates it.
        feed = str(tc.extra.get("feedDtype", "float32"))
        if feed not in ("float32", "float16"):
            raise ValueError(f"feedDtype must be float32|float16, got {feed!r}")
        self.feed_dtype = np.dtype(feed)
        # SSP paces per-worker progress: every launch must surface its
        # accept flags so refused batches can be requeued — no chaining.
        # Asynchronous CONSUMES every offered batch (allowed = has_data),
        # so it keeps the chained bulk path and never checks flags.
        self._paced = tc.protocol == "SSP"
        # staged rows fill chain * dp * B rows a column; a full dense stage
        # is one chained step_many_dense call (amortizes the host's work a
        # launch)
        self.chain = 1 if self._paced else max(int(tc.extra.get("stageChain", 8)), 1)
        self._init_rows(tc)
        self._stage_cap = self.chain * dp * config.batch_size
        self._stage = self._new_stage_set()
        self._stage_n = 0
        # the ordered dispatch queue while a double-buffered route runs
        self._dispatch: Optional[_OverlapDispatcher] = None
        # armed by enable_resident_ingest() (JobConfig.ingest device=on)
        self._resident: Optional[_ResidentIngest] = None

    # --- what a row is (the sparse bridge overrides these) ---

    def _init_rows(self, tc) -> None:
        """The vectorizer, the holdout and the stage's columns."""
        self.vectorizer = Vectorizer(self.dim, int(tc.extra.get("hashDims", 0)))
        self.test_set = ArrayHoldout(self.config.test_set_size, self.dim)
        self._stage_columns = [((self.dim,), self.feed_dtype), ((), self.feed_dtype)]

    def _model_input(self, feats):
        """The trainer's input from a batch's feature columns (an fp16
        feed is widened here, exactly)."""
        return feats[0].astype(np.float32, copy=False)

    def _make_fused(self, cols):
        hash_dims = int(self.request.training_configuration.extra.get("hashDims", 0))
        return FusedStage(
            cols[0], cols[1], self.test_set._x, self.test_set._y,
            n_features=self.dim - hash_dims,
            test_enabled=bool(self.config.test),
        )

    def _chunk_consumer(self):
        """``consume(buf, stop)`` for the file routes' chunks."""
        return lambda buf, stop: self._fused_consume(buf, 0, stop)

    # --- data path ---

    def _forecast(self, feats, inst: DataInstance) -> None:
        """Serve one row with worker 0's model, padded to the PREDICT_BATCH
        rows of a serving predict, and emit the prediction for ``inst``."""
        batch = []
        for f, ring in zip(feats, self.test_set._cols):
            b = np.zeros((PREDICT_BATCH,) + ring.shape[1:], ring.dtype)
            b[0] = f
            batch.append(b)
        preds = self.trainer.predict(self._model_input(batch))
        self._emit_prediction(Prediction(self.request.id, inst, float(preds[0])))

    def _forecast_row(self, x: np.ndarray) -> None:
        self._forecast((x,), DataInstance(numerical_features=x.tolist(), operation=FORECASTING))

    def handle_data(self, inst: DataInstance) -> None:
        x = self.vectorizer.vectorize(inst)
        if inst.operation == FORECASTING:
            self._forecast((x,), inst)
            return
        y = (
            0.0 if inst.target is None
            else min(max(float(inst.target), -F32_MAX), F32_MAX)
        )
        # 20% holdout: counts 8,9 of each 0-9 cycle (FlinkSpoke.scala:94-104)
        # -- the single-record case of _train_rows
        self._train_rows(x[None, :], np.asarray([y], np.float32))

    def handle_batch(
        self, x: np.ndarray, y: np.ndarray, op: np.ndarray
    ) -> None:
        """Bulk equivalent of handle_data for pre-vectorized rows (the C++
        ingest path): same holdout cycle and staging order as feeding the
        rows one at a time, but vectorized end to end."""
        n = x.shape[0]
        if n == 0:
            return
        if x.shape[1] != self.dim:
            w = min(x.shape[1], self.dim)
            out = np.zeros((n, self.dim), np.float32)
            out[:, :w] = x[:, :w]
            x = out
        # serve each forecast at its stream position (train the rows before
        # it first) so packed ordering matches per-record
        prev = 0
        for f in np.nonzero(op != 0)[0]:
            f = int(f)
            if f > prev:
                self._train_rows(x[prev:f], y[prev:f])
            self._forecast_row(x[f])
            prev = f + 1
        if prev < n:
            self._train_rows(x[prev:], y[prev:])

    def _train_rows(self, *cols: np.ndarray) -> None:
        """Holdout-split a run of training rows (one array a column, the
        target last), then stage them."""
        n = cols[0].shape[0]
        if n == 0:
            return
        if self._resident is not None:
            self._resident.absorb(*cols)
            return
        if self.config.test:
            cycle = (self.holdout_count + np.arange(n)) % 10
            self.holdout_count += n
            test_mask = cycle >= 8
            keep = np.nonzero(~test_mask)[0]
            t_idx = np.nonzero(test_mask)[0]
            *evicted, ev_src = self.test_set.append_many(*(c[t_idx] for c in cols))
            if ev_src.size:
                # evicted points re-enter training at the evicting row's slot
                order = np.argsort(np.concatenate([keep, t_idx[ev_src]]), kind="stable")
                cols = tuple(np.concatenate([c[keep], e])[order] for c, e in zip(cols, evicted))
            else:
                cols = tuple(c[keep] for c in cols)
        else:
            self.holdout_count += n
        self._stage_rows(*cols)

    def _new_stage_set(self) -> _StageSet:
        return _StageSet(tuple(np.zeros((self._stage_cap,) + shape, dtype)
                               for shape, dtype in self._stage_columns))

    def _stage_rows(self, *cols: np.ndarray) -> None:
        """Fill the stage; a full stage launches and the fill resumes, so
        rows beyond the stage's capacity train rather than truncate."""
        i = 0
        n = cols[0].shape[0]
        while i < n:
            take = min(self._stage_cap - self._stage_n, n - i)
            s = self._stage_n
            for buf, c in zip(self._stage.cols, cols):
                buf[s : s + take] = c[i : i + take]
            self._stage_n += take
            i += take
            if self._stage_n >= self._stage_cap:
                self._train_staged()

    def _train_staged(self) -> None:
        """Launch the staged rows. While a double-buffered route runs, the
        set goes to the dispatch thread instead and staging goes on in a
        free set from the pool. With the resident stage armed, a partial
        stage drains through the host path (a full one launched on the
        device when it filled)."""
        if self._resident is not None:
            self._resident.drain_to_host()
            return
        n = self._stage_n
        self._stage_n = 0
        if n == 0:
            return
        if self._dispatch is not None:
            self._stage = self._dispatch.submit(self._stage, n)
            return
        self._launch(self._stage.cols, n)

    def _launch(self, cols, n: int) -> None:
        """Launch ``n`` staged rows of a stage set's columns (an explicit
        set: the double-buffered routes own several). A full dense stage is
        one chained mask-free step_many_dense launch of ``chain`` [dp, B]
        steps (the stage is exactly chain*dp*B rows, so every row is valid
        and no mask ships); anything else runs whole [dp, B] groups as
        single steps and the remainder through a small [dp, TAIL_B] padded
        step instead of padding a whole dp*B group for a handful of rows."""
        if n == 0:
            return
        b = self.config.batch_size
        if n == self._stage_cap and self.CHAINED and not self._paced:
            x, y = cols
            self.trainer.step_many_dense(
                x.reshape(self.chain, self.dp, b, self.dim), y.reshape(self.chain, self.dp, b)
            )
            return
        # A full stage goes up as it lies: the upload from pageable memory
        # is synchronous, and on the CPU the steps read the buffer before
        # they return, so the set is free once this call returns. Anything
        # else is copied first: under SSP, refused rows re-enter the stage
        # while their batch is still being read.
        cols = tuple(c[:n].copy() for c in cols)
        group = self.dp * b
        done = 0
        while n - done >= group:
            g = tuple(c[done : done + group].reshape((self.dp, b) + c.shape[1:]) for c in cols)
            self._step(g, np.ones((self.dp, b), np.float32), group)
            done += group
        tail_b = min(b, TAIL_BATCH)
        tail_group = self.dp * tail_b
        while n - done > 0:
            rem = min(n - done, tail_group)
            # stripe rows across workers (row i -> slot i % dp); under SSP
            # pacing, slots map SLOWEST-CLOCK-FIRST onto workers — the
            # slowest worker always satisfies the bound, so every tail pass
            # is guaranteed progress and short tails feed the laggards that
            # gate min_clock instead of starving them
            g = []
            for c in cols + (np.ones((n,), np.float32),):
                t = np.zeros((tail_group,) + c.shape[1:], c.dtype)
                t[:rem] = c[done : done + rem]
                g.append(np.ascontiguousarray(
                    t.reshape((tail_b, self.dp) + c.shape[1:]).swapaxes(0, 1)))
            if self._paced:
                order = np.argsort(self.trainer.worker_clocks(), kind="stable")
                inv = np.empty_like(order)
                inv[order] = np.arange(self.dp)
                g = [a[inv] for a in g]
            self._step(tuple(g[:-1]), g[-1], rem)
            done += rem

    def _step(self, g, mask: np.ndarray, valid: int) -> None:
        """One fleet step on a [dp, B] batch of columns, then SSP's requeue."""
        self.trainer.step(self._model_input(g[:-1]), g[-1].astype(np.float32, copy=False),
                          mask, valid_count=valid)
        if not self._paced:
            return
        # SSP pacing: re-stage the rows of workers whose batch the device
        # refused (staleness bound) and correct the fitted counter; they
        # re-enter the stage directly, having been through the holdout
        acc = self.trainer.last_accepted()
        if acc.all():
            return
        for w in np.nonzero(~acc)[0]:
            rows = mask[w] > 0.0
            k = int(rows.sum())
            if k == 0:
                continue
            self.trainer.note_requeued(k)
            self._stage_rows(*(c[w][rows] for c in g))

    def flush(self) -> None:
        """Drain the stage. Under SSP pacing, refused rows re-enter the
        stage; repeated passes are guaranteed progress (tail slots map
        slowest-first, and the slowest worker always satisfies the bound),
        so the drain terminates — the quiesce analogue of the host plane's
        SSPParameterServer.on_terminate release."""
        self._train_staged()
        while self._paced and self._stage_n:
            before = self._stage_n
            self._train_staged()
            if self._stage_n >= before:
                raise RuntimeError(
                    "SSP flush made no progress draining refused rows"
                )

    # --- checkpoint buffer snapshot (the sparse bridge overrides it) ---

    def snapshot_buffers(self) -> dict:
        """Holdout and staged rows for a job checkpoint."""
        if self._resident is not None:
            self._resident.sync_host()
        test_x, test_y = self.test_set.arrays()
        x, y = self._stage.cols
        return {
            "test_x": test_x,
            "test_y": test_y,
            "stage_x": np.asarray(x[: self._stage_n], np.float32).copy(),
            "stage_y": np.asarray(y[: self._stage_n], np.float32).copy(),
        }

    def restore_buffers(self, bd: dict) -> None:
        if self._resident is not None:
            # restore on the host mirrors (the rare path), then upload them
            res, self._resident = self._resident, None
            res.sync_host()
            try:
                self.restore_buffers(bd)
            finally:
                self._resident = res
                res.push_from_host()
            return
        if bd["test_x"].shape[0]:
            self.test_set.append_many(bd["test_x"], bd["test_y"])
        if bd["stage_x"].shape[0]:
            self._stage_rows(bd["stage_x"], bd["stage_y"])

    # --- fused file ingest (C parse -> holdout -> stage, zero numpy) ---

    def supports_fused_ingest(self) -> bool:
        """The fused C loop writes float32 rows straight into the staging
        buffers; fp16 feeds and missing-toolchain hosts use the packed
        numpy route instead. A resident stage lives on the device, where the
        C loop cannot write: the packed route (``_train_rows``, and thereby
        the resident scatter) carries those jobs."""
        return (self.feed_dtype == np.float32 and self._resident is None
                and fast_parser_available())

    # --- device-resident stage and holdout (JobConfig.ingest device=on) ---

    def supports_resident_ingest(self) -> bool:
        """The resident stage needs the chained mask-free launch: a float32
        feed and no SSP pacing (refused rows must re-enter a host stage)."""
        return self.feed_dtype == np.float32 and not self._paced

    def enable_resident_ingest(self) -> bool:
        """Arm the device-resident stage and holdout ring. False (the
        bridge stays on the host route) where the resident path cannot
        serve it. Safe before any data flows; arming mid-stream would
        strand staged host rows, so it is refused then."""
        if self._resident is not None:
            return True
        if not self.supports_resident_ingest():
            return False
        if self._stage_n or len(self.test_set):
            return False
        self._resident = _ResidentIngest(self)
        return True

    def _fused_stage(self):
        """The current stage set's C stager."""
        st = self._stage
        if st.fused is None:
            st.fused = self._make_fused(st.cols)
        return st.fused

    def _stager_call(self, fs, method, *args):
        """Run a C stager call with the bridge's cursors synced in and out
        (Python code, SSP's requeue and a stage swap move them between
        calls)."""
        ctx = fs.ctx
        ctx.stage_n = self._stage_n
        ctx.hold_n = self.test_set._n
        ctx.hold_head = self.test_set._head
        ctx.holdout_count = self.holdout_count
        out = method(*args)
        self._stage_n = int(ctx.stage_n)
        self.test_set._n = int(ctx.hold_n)
        self.test_set._head = int(ctx.hold_head)
        self.holdout_count = int(ctx.holdout_count)
        return out

    def _quiesce(self) -> None:
        """Before Python touches the trainer or the stage from the parse
        thread: drain the dispatch queue, if a double-buffered route runs."""
        if self._dispatch is not None:
            self._dispatch.quiesce()

    def ingest_file(
        self, path: str, chunk_bytes: Optional[int] = None, on_chunk=None
    ) -> None:
        """Stream a JSON-lines file through the fused C ingest: every
        fast-schema line is parsed DIRECTLY into its staging slot and
        holdout-split in C (exact handle_batch semantics); only stage
        launches, Python-codec fallback lines and forecasts return to
        Python. This is the e2e hot path — one pass, no per-row numpy.

        Reference counterpart: the whole-job per-record hot loop
        Job.scala:42-70 -> FlinkSpoke.scala:92-107."""
        consume = self._chunk_consumer()
        for buf, stop in _line_aligned_chunks(path, chunk_bytes or self.CHUNK_BYTES):
            if self._dispatch is not None:
                # a dispatch-thread error surfaces at the next chunk
                # boundary instead of after the rest of the file
                self._dispatch.raise_pending()
            consume(buf, stop)
            if on_chunk is not None:
                on_chunk()

    def supports_overlapped_ingest(self) -> bool:
        """Double-buffered ingest needs chained launches (not SSP's paced
        per-launch accept flags); both the dense fused stage and the
        sparse COO routes implement it. It holds ``depth`` extra stage
        buffer sets (default 2: ~3x staging memory); set
        trainingConfiguration extra ``{"overlappedIngest": false}`` to
        keep the serial fused route on memory-tight hosts."""
        flag = str(
            self.request.training_configuration.extra.get(
                "overlappedIngest", "true"
            )
        ).lower()
        return (
            self.supports_fused_ingest() and not self._paced
            and flag != "false"
        )

    def ingest_file_overlapped(
        self, path: str, chunk_bytes: Optional[int] = None, on_chunk=None,
        depth: int = 2, train_fn=None,
    ) -> None:
        """DOUBLE-BUFFERED file ingest: :meth:`ingest_file`'s loop (whose C
        parse releases the GIL) fills stage set k+1 in the calling thread
        while a dispatch thread ships and trains stage k — so the measured
        wall clock of a run is max(parse, device) instead of their sum, end
        to end. ``depth`` spare stage sets bound the look-ahead (the parse
        thread blocks on an empty pool, so memory stays fixed).
        ``train_fn(cols, n)`` overrides the launch for calibrated
        device-stub measurements.

        Stages are dispatched strictly IN ORDER, so the training result is
        bit-identical to :meth:`ingest_file` (pinned by
        tests/test_torch_spmd_ingest.py). Fallback lines and forecasts
        quiesce the dispatch queue first, then run inline — the rare path
        stays correct, the hot path never synchronizes.

        Reference counterpart: the pipelined whole-job hot path
        Job.scala:42-70 -> FlinkSpoke.scala:92-107 (Flink's operator
        chain keeps source/parse and the learner's fit concurrent across
        its task threads; this is the two-thread form)."""
        if self._paced:
            raise ValueError(
                "overlapped ingest requires chained launches; SSP's "
                "per-launch accept flags force the serial path"
            )
        train = train_fn or self._launch
        disp = _OverlapDispatcher(
            self._new_stage_set, depth, lambda st, n: train(st.cols, n)
        )
        self._dispatch = disp
        try:
            self.ingest_file(path, chunk_bytes, on_chunk)
            # the final partial stage drains through the same ordered queue
            self._train_staged()
        finally:
            self._dispatch = None
            disp.close()
        disp.raise_pending()

    def _fused_consume(self, buf: bytearray, start: int, stop: int) -> None:
        """Drive the C loop over ``buf[start:stop]`` (whole lines), handing
        stage launches, fallback lines and forecasts back to Python. A
        full stage launches (or, double-buffered, goes to the dispatch
        thread and the loop goes on in the next set's stager); a fallback
        or forecast first quiesces the dispatch queue, so the inline path
        never races the dispatch thread."""
        off = start
        while off < stop:
            fs = self._fused_stage()
            rc, consumed, soff, slen = self._stager_call(fs, fs.parse_stage, buf, off, stop)
            base = off
            off += consumed
            if rc == fs.RC_DONE:
                return
            if rc == fs.RC_STAGE_FULL:
                self._train_staged()
                continue
            self._quiesce()
            # the sparse stager hands forecasts back as special lines
            if rc == getattr(fs, "RC_FORECAST", None):
                self._forecast_row(fs.forecast_row()[0])
                continue
            line = bytes(buf[base + soff : base + soff + slen]).decode(
                "utf-8", errors="replace"
            )
            inst = DataInstance.from_json(line)
            if inst is not None:
                self.handle_data(inst)

    # --- query / termination path ---

    def _evaluate(self) -> Tuple[float, float]:
        if self.test_set.is_empty:
            return 0.0, 0.0
        if self._resident is not None:
            # served straight from the resident holdout ring
            return self.trainer.evaluate(*self._resident.eval_arrays())
        cols = self.test_set.arrays()
        # padded to the holdout capacity, as the JAX package pads it for
        # one compiled eval program: the mask keeps the values the same
        cap = self.test_set.max_size
        n = len(cols[-1])
        cols = [np.concatenate([c, np.zeros((cap - n,) + c.shape[1:], c.dtype)]) for c in cols]
        mask = np.zeros((cap,), np.float32)
        mask[:n] = 1.0
        return self.trainer.evaluate(self._model_input(cols[:-1]), cols[-1], mask)

    def emit_query_response(self, response_id: int) -> None:
        """Bucketed QueryResponse (FlinkNetwork.scala:48-149,151-240); the
        fleet model is one logical model, so user queries get a single
        worker's fragment set (the merger expects 1)."""
        self.flush()
        loss, score = self._evaluate()
        flat = self.trainer.global_flat_params()
        chunks: List[Optional[np.ndarray]] = [None]
        if response_id != TERMINATION_RESPONSE_ID:
            bucket = self.config.max_param_bucket_size
            chunks = [
                flat[i : i + bucket]
                for i in range(0, max(flat.size, 1), bucket)
            ] or [None]
        tc = self.request.training_configuration
        learner_desc = {
            "name": self.request.learner.name,
            "hyperParameters": dict(self.request.learner.hyper_parameters or {}),
            "dataStructure": dict(self.request.learner.data_structure or {}),
        }
        n_workers = (
            self.config.parallelism
            if response_id == TERMINATION_RESPONSE_ID
            else 1
        )
        fitted = self.trainer.fitted
        for w in range(n_workers):
            for i, chunk in enumerate(chunks):
                learner = (
                    dict(learner_desc) if i == 0
                    else {"name": learner_desc["name"]}
                )
                if chunk is not None:
                    learner["parameters"] = {"bucketValues": chunk.tolist()}
                self._emit_response(
                    QueryResponse(
                        response_id=response_id,
                        mlp_id=self.request.id,
                        bucket=i,
                        num_buckets=len(chunks),
                        preprocessors=[
                            {"name": p.name, "hyperParameters": dict(p.hyper_parameters or {})}
                            for p in (self.request.preprocessors or [])
                        ] if i == 0 else None,
                        learner=learner,
                        protocol=tc.protocol if i == 0 else None,
                        # fitted counts once across the fleet's fragments
                        data_fitted=fitted if (i == 0 and w == 0) else 0,
                        loss=loss if i == 0 else None,
                        cumulative_loss=None,
                        score=score if i == 0 else None,
                        source_worker=w,
                    )
                )

    def handle_terminate_probe(self) -> None:
        self.emit_query_response(TERMINATION_RESPONSE_ID)

    def network_statistics(self) -> Statistics:
        """Protocol statistics with the collective-call-site accounting
        (bytesShipped parity, FlinkHub.scala:118-127)."""
        curve = self.trainer.curve_slice()
        _, score = self._evaluate()
        return Statistics(
            pipeline=self.request.id,
            protocol=self.request.training_configuration.protocol,
            models_shipped=self.trainer.sync_count() * self.dp,
            bytes_shipped=self.trainer.bytes_shipped(),
            bytes_on_wire=self.trainer.bytes_on_wire(),
            num_of_blocks=self.trainer.sync_count(),
            fitted=self.trainer.fitted,
            learning_curve=[l for l, _ in curve],
            lcx=[f for _, f in curve],
            mean_buffer_size=float(self._stage_n),
            score=score,
        )


class SparseSPMDBridge(SPMDBridge):
    """Padded-COO pipeline on the collective engine: the model vector stays
    dense and hub-bucketed in the fleet state, each record ships only its K
    active features ((idx[K], val[K]) — the SparseVector input type of the
    reference's parse path, DataPointParser.scala:4,20-47), and protocol
    sync is the same collective as the dense bridge. Streaming contract
    identical: 8-of-10 holdout, forecasts at stream position, bucketed
    query responses, termination fragments, byte-accounted statistics.

    The file routes are four, chosen by the Create's extra keys as in the
    JAX package: the fused C line loop or the multithreaded block parse
    (``sparseFusedIngest``, ``parserThreads``), each serial or
    double-buffered (``overlappedIngest``)."""

    # sparse chunks default to 8 MB (vs the dense 4 MB): the MT parse
    # amortizes its newline-index pass and thread handoff over longer
    # line runs — measured ~+8% host throughput on the Criteo stream
    CHUNK_BYTES = 1 << 23
    # COO staging: one [dp, B] group per launch (no dense chaining)
    CHAINED = False

    def _init_rows(self, tc) -> None:
        ds = self.request.learner.data_structure or {}
        self.max_nnz = int(ds.get("maxNnz", 64))
        hash_space = int(ds.get("hashSpace", 0))
        self.vectorizer = SparseVectorizer(self.dim, hash_space, self.max_nnz)
        self.test_set = SparseHoldout(self.config.test_set_size, self.max_nnz)
        self.chain = 1
        k = (self.max_nnz,)
        self._stage_columns = [(k, np.int32), (k, np.float32), ((), np.float32)]

    def _model_input(self, feats):
        return tuple(feats)

    def _make_fused(self, cols):
        return SparseFusedStage(
            *cols, *self.test_set._cols,
            dense_budget=self.vectorizer.dim - self.vectorizer.hash_space,
            hash_space=self.vectorizer.hash_space,
            test_enabled=bool(self.config.test),
        )

    def supports_fused_ingest(self) -> bool:
        """The sparse bridge has its own C bulk routes (ingest_file: the
        fused parse->holdout->stage loop, or padded-COO block packing with
        in-C categorical hashing)."""
        return fast_parser_available()

    # supports_overlapped_ingest: inherited — supports_fused_ingest is
    # polymorphic and the opt-out knob is shared with the dense route.

    def supports_resident_ingest(self) -> bool:
        """Padded-COO rows stay on the host route (the resident stage holds
        dense rows), as in the JAX package."""
        return False

    def _use_fused_coo(self) -> bool:
        """The fused C loop (omldm_parse_stage_sparse) is the default file
        route: it parses each line directly into its COO stage slot with
        the holdout split in C, where the block route re-touches every row
        in numpy (parser output allocation, holdout mask/argsort/concat,
        stage memcpy) — ~2x host throughput measured on the Criteo-shaped
        stream (benchmarks/run_benchmarks.py:bench_criteo_sparse_stream_e2e).
        ``{"sparseFusedIngest": false}`` keeps the multithreaded block
        parser instead (it can win on many-core hosts where the e2e is
        parse-bound and the fused loop's single parse thread loses to 8
        MT block threads)."""
        if not self.supports_fused_ingest():
            return False
        flag = str(
            self.request.training_configuration.extra.get(
                "sparseFusedIngest", "true"
            )
        ).lower()
        return flag != "false"

    def _make_coo_parser(self):
        # parserThreads: 0 = auto (min(cores, 8), FastParser's rule) —
        # multi-core hosts parse disjoint line ranges on C threads.
        # reuse_buffers: the ingest routes consume every returned array
        # within the chunk (staging memcpy / holdout copy), so the parser
        # may hand out scratch views instead of fresh allocations
        return SparseFastParser(
            self.vectorizer.dim - self.vectorizer.hash_space,
            self.vectorizer.hash_space,
            self.max_nnz,
            n_threads=int(
                self.request.training_configuration.extra.get(
                    "parserThreads", 0
                )
            ),
            reuse_buffers=True,
        )

    def _chunk_consumer(self):
        """A single parse thread takes the fused line loop (one C pass,
        parse straight into the stage slot, zlib-CRC32 categorical hashing
        in C); several take the MT block parse on all cores, then the C
        stager (``_stage_parsed_rows``), or the numpy holdout and stage
        with ``sparseFusedIngest: false``. All are bit-identical (pinned
        by tests/test_torch_spmd_ingest.py)."""
        parser = self._make_coo_parser()
        if self._use_fused_coo() and parser.n_threads <= 1:
            return super()._chunk_consumer()
        return lambda buf, stop: self._consume_coo_block(parser, buf, stop)

    # --- data path ---

    def handle_data(self, inst: DataInstance) -> None:
        idx, val = self.vectorizer.vectorize(inst)
        if inst.operation == FORECASTING:
            self._forecast((idx, val), inst)
            return
        y = (
            0.0 if inst.target is None
            else min(max(float(inst.target), -F32_MAX), F32_MAX)
        )
        self._train_rows(idx[None, :], val[None, :], np.asarray([y], np.float32))

    def handle_batch(self, x, y, op) -> None:
        """Dense packed rows (the C ingest path) re-enter as COO — rare for
        sparse jobs (the CLI routes sparse streams per-record), but a mixed
        feed must behave identically to per-record delivery."""
        n = x.shape[0]
        if n == 0:
            return
        prev = 0
        for f in np.nonzero(op != 0)[0]:
            f = int(f)
            if f > prev:
                self._train_sparse_rows(*Spoke._dense_rows_to_coo(x[prev:f], self.max_nnz),
                                        y[prev:f])
            si, sv = Spoke._dense_rows_to_coo(x[f : f + 1], self.max_nnz)
            inst = DataInstance(numerical_features=x[f].tolist(), operation=FORECASTING)
            self._forecast((si[0], sv[0]), inst)
            prev = f + 1
        if prev < n:
            self._train_sparse_rows(*Spoke._dense_rows_to_coo(x[prev:], self.max_nnz), y[prev:])

    def snapshot_buffers(self) -> dict:
        ti, tv, ty = self.test_set.arrays()
        si, sv, sy = (c[: self._stage_n].copy() for c in self._stage.cols)
        return {
            "sparse": True,
            "test_i": ti, "test_v": tv, "test_yv": ty,
            "stage_i": si, "stage_v": sv, "stage_yv": sy,
            # dense-keyed empties: the dense reader's keys exist
            "test_x": np.zeros((0, 1), np.float32),
            "test_y": np.zeros((0,), np.float32),
            "stage_x": np.zeros((0, 1), np.float32),
            "stage_y": np.zeros((0,), np.float32),
        }

    def restore_buffers(self, bd: dict) -> None:
        if bd.get("test_i") is not None and bd["test_i"].shape[0]:
            self.test_set.append_many(bd["test_i"], bd["test_v"], bd["test_yv"])
        if bd.get("stage_i") is not None and bd["stage_i"].shape[0]:
            # through the stage filler: a snapshot of a larger mesh may carry
            # more staged rows than this bridge holds, and the overflow trains
            self._stage_rows(bd["stage_i"], bd["stage_v"], bd["stage_yv"])

    def _train_sparse_rows(self, idx, val, y) -> None:
        y = np.clip(np.asarray(y, np.float64), -F32_MAX, F32_MAX).astype(
            np.float32
        )
        self._train_rows(idx, val, y)

    # --- bulk file ingest via the C sparse parser ---

    def _consume_coo_block(self, parser, buf, stop: int = None) -> None:
        """MT block parse of ``buf[:stop]`` (zero-copy out of the reusable
        read buffer) + vectorized holdout/staging. ``buf`` may also be a
        plain bytes block (Kafka feeds), in which case ``stop`` defaults
        to its length."""
        if stop is None:
            stop = len(buf)
        if isinstance(buf, (bytes, memoryview)):
            block = bytes(buf[:stop])
            idx, val, y, op, valid = parser.parse(block)
        else:
            block = None  # materialized lazily, only for special lines
            idx, val, y, op, valid = parser.parse_range(buf, 0, stop)
        n = idx.shape[0]
        if n == 0:
            return
        # specials (codec fallbacks, forecasts, drops) break the bulk run
        # so ordering matches per-record delivery exactly
        special = np.nonzero((valid != 1) | (op != 0))[0]
        lines = None
        if special.size:
            if block is None:
                block = bytes(memoryview(buf)[:stop])
            lines = block.split(b"\n")
        # bulk runs of parsed training rows: holdout + stage in C when the
        # fused path is on (same per-record semantics either way)
        stage_bulk = (
            self._stage_parsed_rows if self._use_fused_coo()
            else self._train_sparse_rows
        )
        prev = 0
        for s in special:
            s = int(s)
            if s > prev:
                stage_bulk(idx[prev:s], val[prev:s], y[prev:s])
            inst = DataInstance.from_json(
                lines[s].decode("utf-8", errors="replace")
            )
            if inst is not None:
                # specials may touch the trainer from this (producer)
                # thread (forecasts serve a prediction): drain queued
                # collective steps first — including any enqueued by the
                # staging right above — so two threads never race on
                # trainer state
                self._quiesce()
                self.handle_data(inst)
            prev = s + 1
        if prev < n:
            stage_bulk(idx[prev:], val[prev:], y[prev:])

    def _stage_parsed_rows(self, idx, val, y) -> None:
        """Holdout + stage a run of C-PARSED COO rows through the C stager
        (omldm_stage_coo_rows): the staging tail of the MT block route,
        bit-identical to :meth:`_train_rows` but with the holdout cycle,
        ring swap and stage fill in one C pass instead of
        mask/argsort/concatenate numpy per block. Pauses at stage-full for
        the launch (or the overlapped dispatch swap)."""
        n = idx.shape[0]
        i = 0
        while i < n:
            # re-fetched each pass: a stage swap moves to another set's stager
            fs = self._fused_stage()
            i += self._stager_call(fs, fs.stage_rows, idx, val, y, i)
            if self._stage_n >= self._stage_cap:
                self._train_staged()
