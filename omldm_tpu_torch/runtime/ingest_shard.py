"""Sharded multi-process ingest: N parser workers, one driver.

The port's copy of the JAX package's ``runtime/ingest_shard.py``. The file
route's ceiling on the host is one core's C parse (PERF.md section 5: the
card's bench route idles most of the wall while the parse leads the host
profile). This plane stripes a JSON-lines file across N parser
*processes* -- the partition-striping shape of a multi-process source,
each subtask owning the partitions ``p % n == pid`` -- and hands the parsed
row blocks back to ONE driver through shared-memory rings.

Determinism contract (pinned by tests/test_torch_ingest_shard.py): the
file is cut into fixed byte-grid chunks; chunk ``k`` owns the lines whose
first byte falls in ``[k*C, (k+1)*C)`` and is parsed by worker ``k % N``;
the driver consumes blocks in ascending chunk order (round-robin over the
workers by construction). The reassembled row sequence is therefore the
exact file order -- bit-identical to single-process ingest -- and the
holdout split and stage boundaries, which are pure functions of the row
sequence, land identically. Block boundaries carry no meaning.

Worker boundaries need no coordination: each worker derives its chunks'
line-aligned spans on its own (seek to the grid point, scan to the next
line start -- the input-split rule of Hadoop and Flink file sources), so
two workers always agree about which chunk owns a line.

The workers are ``fork`` children of a driver that may hold a live CUDA
context. They touch only numpy, their ring views and the C parser: no
tensor and no CUDA call (PyTorch's fork handler makes a CUDA call in a
forked child raise, so a worker that strayed would fail loudly, not
silently). The rings are ``multiprocessing.RawArray`` buffers, not
``torch.multiprocessing`` tensors.

Failure handling rides the selfheal taxonomy (``runtime.selfheal``): a
parser process that dies mid-stream is classified (crash, hang) from its
exit code or its silence, the degrade is reason-coded through
``on_degrade`` (the flight recorder's journal, when armed), and the driver
goes on parsing in its own process from the exact row where the sharded
stream stopped -- the job degrades; it never wedges and never feeds a row
twice.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue as queue_mod
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from omldm_tpu_torch.runtime.selfheal import classify_failure

__all__ = [
    "IngestConfig",
    "parse_ingest_spec",
    "chunk_span",
    "n_chunks",
    "ShardWorkerDead",
    "ShardedIngest",
]

Rows = Tuple[np.ndarray, np.ndarray, np.ndarray]


# --- spec ---------------------------------------------------------------


@dataclasses.dataclass
class IngestConfig:
    """Parsed ``JobConfig.ingest`` knobs (the serving, overload and
    telemetry spec-string pattern; ``""`` = unarmed = the routes without
    the plane)."""

    # parser worker processes; 0 keeps parsing in-process (the spec can
    # still arm device residency alone)
    shards: int = 0
    # stripe unit in KB: the deterministic chunk grid AND the worker read
    # granularity
    chunk_kb: int = 4096
    # shared-memory ring slots per worker (bounds look-ahead memory; a
    # worker ahead of the driver blocks on a full ring)
    ring: int = 4
    # rows per ring slot; 0 = auto from the chunk size
    slot_rows: int = 0
    # device-resident stage and holdout ring on the SPMD bridges
    # (spmd_bridge._ResidentIngest)
    device: bool = False
    # driver-side wait per block before a silent worker counts as wedged (ms)
    wait_ms: float = 10_000.0

    def chunk_bytes(self) -> int:
        return max(int(self.chunk_kb), 1) * 1024

    def slot_rows_for(self, chunk_bytes: int) -> int:
        if self.slot_rows > 0:
            return int(self.slot_rows)
        # a conservative rows-per-chunk bound (a 128-byte shortest line);
        # denser chunks split across several ring slots
        return max(chunk_bytes // 128, 1024)


_KNOBS: Dict[str, Tuple[str, Any]] = {
    "shards": ("shards", int),
    "chunkKb": ("chunk_kb", int),
    "ring": ("ring", int),
    "slotRows": ("slot_rows", int),
    "device": ("device", None),  # a boolean word
    "waitMs": ("wait_ms", float),
}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def parse_ingest_spec(spec: Any) -> Optional[IngestConfig]:
    """dict, spec string or True -> IngestConfig; None, False or "" ->
    None (unarmed). ``"on"`` arms the default shape: one parser worker a
    spare core. Unknown knobs raise (fail fast, as the telemetry spec)."""
    if spec is None or spec is False or spec == "":
        return None
    if spec is True:
        spec = {}
    if isinstance(spec, str):
        s = spec.strip()
        if s.lower() == "on":
            spec = {}
        else:
            out: dict = {}
            for part in s.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ValueError(f"bad ingest spec entry {part!r} (want k=v)")
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
            spec = out
    if not isinstance(spec, dict):
        raise ValueError(f"ingest spec must be a table, got {type(spec).__name__}")
    unknown = set(spec) - set(_KNOBS)
    if unknown:
        raise ValueError(f"unknown ingest knob(s): {sorted(unknown)}")
    cfg = IngestConfig()
    # armed with no explicit shard count: one parser a spare core
    cfg.shards = max((os.cpu_count() or 2) - 1, 1)
    for key, raw in spec.items():
        field, conv = _KNOBS[key]
        setattr(cfg, field, _parse_bool(raw) if conv is None else conv(float(raw)))
    if cfg.shards < 0:
        raise ValueError("ingest shards must be >= 0")
    if cfg.ring < 1:
        raise ValueError("ingest ring must be >= 1")
    return cfg


# --- deterministic chunk grid -------------------------------------------


def chunk_span(f, k: int, chunk_bytes: int, fsize: int) -> Optional[Tuple[int, int]]:
    """Line-aligned byte span of grid chunk ``k``: the lines whose FIRST
    byte falls in ``[k*C, (k+1)*C)``. Computed from the file alone (seek to
    the grid point minus one, skip to the next line start), so every process
    derives the same boundaries without coordination. None past EOF; an
    empty span (start == stop) is a chunk whose grid window lies wholly
    inside one long line."""
    lo = k * chunk_bytes
    if lo >= fsize:
        return None
    if k == 0:
        start = 0
    else:
        f.seek(lo - 1)
        f.readline()
        start = f.tell()
    hi = lo + chunk_bytes
    if hi >= fsize:
        stop = fsize
    else:
        f.seek(hi - 1)
        f.readline()
        stop = f.tell()
    return (start, max(stop, start))


def n_chunks(fsize: int, chunk_bytes: int) -> int:
    return (fsize + chunk_bytes - 1) // chunk_bytes if fsize > 0 else 0


def _read_span(f, span: Tuple[int, int]) -> bytearray:
    """A span's whole lines, newline-terminated (a file may end without)."""
    start, stop = span
    f.seek(start)
    data = bytearray(f.read(stop - start))
    if not data.endswith(b"\n"):
        data += b"\n"
    return data


def _no_rows(dim: int) -> Rows:
    return (np.zeros((0, dim), np.float32), np.zeros((0,), np.float32),
            np.zeros((0,), np.uint8))


# --- worker process ------------------------------------------------------

_DONE_FLAG = 1  # meta flag: the last block of its chunk


def _worker_main(
    wid: int,
    n_shards: int,
    path: str,
    dim: int,
    hash_dims: int,
    chunk_bytes: int,
    slot_rows: int,
    ring_x,
    ring_y,
    ring_op,
    ring_meta,
    stats,
    ready_q,
    free_q,
    stop_ev,
) -> None:
    """Parser worker: parse chunks ``wid, wid+N, ...`` into ring slots.

    Touches numpy and the native parser only -- no tensor, no CUDA -- so
    it is safe to fork from a driver with a live card. Slot ``s`` holds
    rows ``[s*slot_rows, (s+1)*slot_rows)`` of the flat shared arrays;
    ``ready_q`` and ``free_q`` carry slot indices only."""
    from omldm_tpu_torch.runtime.fast_ingest import PackedBatcher

    rx = np.frombuffer(ring_x, np.float32).reshape(-1, dim)
    ry = np.frombuffer(ring_y, np.float32)
    rop = np.frombuffer(ring_op, np.uint8)
    rmeta = np.frombuffer(ring_meta, np.int64).reshape(-1, 4)
    st = np.frombuffer(stats, np.float64)  # [parse_s, wait_s, rows, chunks]
    pb = PackedBatcher(dim, batch_size=max(slot_rows, 1), hash_dims=hash_dims)

    def get_free_slot() -> Optional[int]:
        t0 = time.perf_counter()
        while not stop_ev.is_set():
            try:
                s = free_q.get(timeout=0.2)
                st[1] += time.perf_counter() - t0
                return s
            except queue_mod.Empty:
                continue
        return None

    try:
        with open(path, "rb") as f:
            fsize = os.fstat(f.fileno()).st_size
            k = wid
            while True:
                span = chunk_span(f, k, chunk_bytes, fsize)
                if span is None:
                    break
                t0 = time.perf_counter()
                x, y, op = pb.parse_rows(_read_span(f, span)) if span[1] > span[0] \
                    else _no_rows(dim)
                st[0] += time.perf_counter() - t0
                total = int(x.shape[0])
                st[2] += total
                st[3] += 1
                off = 0
                while True:
                    n = min(slot_rows, total - off)
                    s = get_free_slot()
                    if s is None:
                        return  # the driver asked us down
                    base = s * slot_rows
                    if n > 0:
                        rx[base : base + n] = x[off : off + n]
                        ry[base : base + n] = y[off : off + n]
                        rop[base : base + n] = op[off : off + n]
                    done = off + n >= total
                    rmeta[s] = (k, off // max(slot_rows, 1), n, _DONE_FLAG if done else 0)
                    ready_q.put(s)
                    off += n
                    if done:
                        break
                k += n_shards
        ready_q.put(-1)  # EOS
    except BaseException as exc:  # surfaced through the queue, then a nonzero exit
        try:
            ready_q.put(("err", repr(exc)))
        except Exception:
            pass
        raise


# --- driver side ---------------------------------------------------------


class ShardWorkerDead(RuntimeError):
    """A parser worker died or wedged; carries the selfheal class."""

    def __init__(self, wid: int, failure_class: str, returncode):
        super().__init__(
            f"ingest shard worker {wid} failed ({failure_class}, rc={returncode})"
        )
        self.wid = wid
        self.failure_class = failure_class
        self.returncode = returncode


class ShardedIngest:
    """Driver handle: stream one file's rows through N parser processes.

    ``blocks()`` yields (x, y, op) row blocks in exact stream order. On a
    worker's death it degrades to in-process parsing from the precise row
    the sharded stream stopped at (``on_degrade`` is told why, reason-coded
    with the selfheal failure class) -- consumers just keep iterating.
    ``stats()`` sums the workers' parse and stall seconds and the driver's
    wait for the phase table; ``starvation()`` is the overload plane's
    backpressure probe."""

    def __init__(
        self,
        path: str,
        dim: int,
        cfg: IngestConfig,
        hash_dims: int = 0,
        on_degrade: Optional[Callable[[dict], None]] = None,
    ):
        from omldm_tpu_torch.ops.native import fast_parser_available

        self.path = path
        self.dim = int(dim)
        self.cfg = cfg
        self.hash_dims = int(hash_dims)
        self.on_degrade = on_degrade
        self.degraded: Optional[dict] = None
        self._chunk_bytes = cfg.chunk_bytes()
        self._slot_rows = cfg.slot_rows_for(self._chunk_bytes)
        self._fsize = os.path.getsize(path)
        self._n_chunks = n_chunks(self._fsize, self._chunk_bytes)
        self._n = max(int(cfg.shards), 1)
        self._driver_wait_s = 0.0
        # starvation window: one bit for each recent block get (1 = the
        # driver had to wait on the ring), the backpressure probe's value
        self._starve_ring: List[int] = []
        self._closed = False
        # the native parser is built (g++ on first use) and loaded here,
        # once, so the forked workers inherit it instead of racing to
        # build it N times
        fast_parser_available()
        ctx = multiprocessing.get_context("fork")
        self._stop_ev = ctx.Event()
        self._procs: List[Any] = []
        self._ready: List[Any] = []
        self._free: List[Any] = []
        self._rings: List[Tuple[Any, Any, Any, Any]] = []
        self._stats: List[Any] = []
        slot_floats = self._slot_rows * self.dim
        for w in range(self._n):
            ring_x = ctx.RawArray("f", cfg.ring * slot_floats)
            ring_y = ctx.RawArray("f", cfg.ring * self._slot_rows)
            ring_op = ctx.RawArray("B", cfg.ring * self._slot_rows)
            ring_meta = ctx.RawArray("q", cfg.ring * 4)
            stats = ctx.RawArray("d", 4)
            ready_q = ctx.Queue()
            free_q = ctx.Queue()
            for s in range(cfg.ring):
                free_q.put(s)
            proc = ctx.Process(
                target=_worker_main,
                args=(
                    w, self._n, path, self.dim, self.hash_dims,
                    self._chunk_bytes, self._slot_rows,
                    ring_x, ring_y, ring_op, ring_meta, stats,
                    ready_q, free_q, self._stop_ev,
                ),
                daemon=True,
                name=f"ingest-shard-{w}",
            )
            self._procs.append(proc)
            self._ready.append(ready_q)
            self._free.append(free_q)
            self._rings.append((ring_x, ring_y, ring_op, ring_meta))
            self._stats.append(stats)
        # the workers touch no tensor and no CUDA (ring views and the C
        # parser only), but the driver usually has threads live (the
        # prefetcher's, PyTorch's own): silence CPython's blanket
        # fork-after-threads warning for these starts, as the JAX package
        # silences its own for its driver's threads
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message=r"This process \(pid=\d+\) is multi-threaded, use of fork\(\)",
                category=DeprecationWarning,
            )
            for proc in self._procs:
                proc.start()

    # --- consumption ------------------------------------------------

    def _get_block(self, w: int):
        """The next ring slot index from worker ``w`` (or raise on its death)."""
        deadline = time.monotonic() + max(self.cfg.wait_ms, 1.0) / 1e3
        t0 = time.perf_counter()
        waited = False
        while True:
            try:
                msg = self._ready[w].get(timeout=0.05)
                break
            except queue_mod.Empty:
                waited = True
                proc = self._procs[w]
                if not proc.is_alive():
                    # a block may have raced in between the poll and the death
                    try:
                        msg = self._ready[w].get_nowait()
                        break
                    except queue_mod.Empty:
                        pass
                    raise ShardWorkerDead(w, classify_failure(proc.exitcode), proc.exitcode)
                if time.monotonic() > deadline:
                    raise ShardWorkerDead(w, classify_failure(heartbeat_silent=True), None)
        self._driver_wait_s += time.perf_counter() - t0
        self._starve_ring.append(1 if waited else 0)
        if len(self._starve_ring) > 64:
            del self._starve_ring[:-64]
        if isinstance(msg, tuple) and msg and msg[0] == "err":
            raise ShardWorkerDead(w, classify_failure(1), msg[1])
        return msg

    def blocks(self) -> Iterator[Rows]:
        """Row blocks in exact stream order (ascending chunk, in-chunk
        sequence). Yields COPIES: the shared slot returns to its worker
        before the next block, so consumers may hold blocks freely."""
        c = 0
        rows_in_chunk = 0
        try:
            while c < self._n_chunks:
                w = c % self._n
                try:
                    msg = self._get_block(w)
                except ShardWorkerDead as dead:
                    yield from self._degrade_blocks(dead, c, rows_in_chunk)
                    return
                if msg == -1:
                    raise RuntimeError(f"ingest shard worker {w} ended early at chunk {c}")
                s = int(msg)
                ring_x, ring_y, ring_op, ring_meta = self._rings[w]
                k, _seq, n, flags = (int(v) for v in
                                     np.frombuffer(ring_meta, np.int64).reshape(-1, 4)[s])
                if k != c:
                    raise RuntimeError(f"ingest shard interleave broke: worker {w} offered "
                                       f"chunk {k}, the driver expected {c}")
                base = s * self._slot_rows
                rows = (
                    np.frombuffer(ring_x, np.float32).reshape(-1, self.dim)[base : base + n].copy(),
                    np.frombuffer(ring_y, np.float32)[base : base + n].copy(),
                    np.frombuffer(ring_op, np.uint8)[base : base + n].copy(),
                )
                self._free[w].put(s)
                if n > 0:
                    rows_in_chunk += n
                    yield rows
                if flags & _DONE_FLAG:
                    c += 1
                    rows_in_chunk = 0
        finally:
            self.close()

    def _degrade_blocks(self, dead: ShardWorkerDead, chunk: int, skip_rows: int
                        ) -> Iterator[Rows]:
        """In-process continuation from (chunk, rows already consumed):
        reparse the wounded chunk, skip the rows the sharded stream already
        delivered, then walk the remaining chunks serially. The consumer
        sees exactly the row sequence of a run without the failure."""
        self.degraded = {
            "worker": dead.wid,
            "class": dead.failure_class,
            "returncode": dead.returncode,
            "chunk": chunk,
            "skipped_rows": skip_rows,
        }
        if self.on_degrade is not None:
            self.on_degrade(dict(self.degraded))
        self.close()
        from omldm_tpu_torch.runtime.fast_ingest import PackedBatcher

        pb = PackedBatcher(self.dim, batch_size=max(self._slot_rows, 1),
                           hash_dims=self.hash_dims)
        with open(self.path, "rb") as f:
            fsize = os.fstat(f.fileno()).st_size
            for k in range(chunk, self._n_chunks):
                span = chunk_span(f, k, self._chunk_bytes, fsize)
                if span is None:
                    break
                if span[1] <= span[0]:
                    continue
                x, y, op = pb.parse_rows(_read_span(f, span))
                if k == chunk and skip_rows:
                    x, y, op = x[skip_rows:], y[skip_rows:], op[skip_rows:]
                if x.shape[0]:
                    yield x, y, op

    # --- observability ----------------------------------------------

    def starvation(self) -> float:
        """Share of recent block waits in which the driver blocked on an
        empty ring (0 = the parsers keep up, 1 = wholly parse-bound): an
        overload ``extra_signals`` probe, so a slow parser shard raises the
        pressure level instead of starving the driver in silence."""
        ring = self._starve_ring
        if not ring:
            return 0.0
        return sum(ring) / len(ring)

    def stats(self) -> dict:
        """Timing for the phase table: the workers' parse seconds (the real
        parse phase, summed across processes), their stall seconds (blocked
        on a full ring: device- or driver-bound), the driver's wait seconds
        (blocked on an empty ring: parse-bound), and row and chunk totals."""
        out = {
            "workers": self._n,
            "parse_s": 0.0,
            "worker_stall_s": 0.0,
            "driver_wait_s": round(self._driver_wait_s, 6),
            "rows": 0,
            "chunks": 0,
        }
        for stats in self._stats:
            st = np.frombuffer(stats, np.float64)
            out["parse_s"] += float(st[0])
            out["worker_stall_s"] += float(st[1])
            out["rows"] += int(st[2])
            out["chunks"] += int(st[3])
        out["parse_s"] = round(out["parse_s"], 6)
        out["worker_stall_s"] = round(out["worker_stall_s"], 6)
        return out

    # --- teardown ----------------------------------------------------

    def close(self) -> None:
        """Stop and reap the workers (idempotent). The ready queues are
        drained so no worker blocks forever on a full ring while it stops."""
        if self._closed:
            return
        self._closed = True
        self._stop_ev.set()
        deadline = time.monotonic() + 5.0
        for w, proc in enumerate(self._procs):
            while proc.is_alive() and time.monotonic() < deadline:
                try:  # drain, so a ring-blocked worker can see the stop
                    self._ready[w].get_nowait()
                except queue_mod.Empty:
                    proc.join(timeout=0.1)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)
        for q in self._ready + self._free:
            try:
                q.cancel_join_thread()
            except Exception:
                pass

    def __enter__(self) -> "ShardedIngest":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
