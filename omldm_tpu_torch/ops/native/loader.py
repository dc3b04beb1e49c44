"""ctypes loader and on-demand build of the native record parser.

The port's copy of the JAX package's loader: the same classes over the
same C ABI (``fastparse.cpp`` beside this file). The library is built with
g++ into ``build/omldm_tpu_torch/native/`` at the repository root, named by
the host's ISA (``-march=native`` output only runs on CPUs with the same
feature set) and a hash of the source. The compiler writes a temporary
name that ``os.replace`` moves into place, so processes building at once
(pytest workers) never load a half-written library. Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastparse.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "omldm_tpu_torch" / "native"


def _host_tag() -> str:
    """ISA identity for the build cache: -march=native output is only
    valid on CPUs with the same feature set, and a build directory can
    travel with the checkout -- a stale library would SIGILL with no
    catchable error."""
    import platform

    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    ident += hashlib.sha1(line.encode()).hexdigest()[:12]
                    break
    except OSError:
        pass
    return ident


def library_path() -> Path:
    """Where this host's build of the current source lives."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libfastparse_{_host_tag()}_{digest}.so"


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
#: g++'s output of the last failed build (empty when none failed)
build_error = ""


def _compile(out: Path) -> bool:
    """g++ into a temporary name, then an atomic rename onto ``out``."""
    global build_error
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", str(tmp), str(_SRC)]
    # -march=native squeezes a few percent out of the SWAR paths; the plain
    # build is the fallback for toolchains/CPUs that reject it
    for cmd in (base[:1] + ["-march=native"] + base[1:], base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        except subprocess.CalledProcessError as exc:
            build_error = exc.stderr or str(exc)
            continue
        except (subprocess.SubprocessError, OSError) as exc:
            build_error = str(exc)
            continue
        os.replace(tmp, out)
        return True
    try:
        tmp.unlink()
    except OSError:
        pass
    return False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists() and not _compile(out):
        _build_failed = True
        return None
    lib = ctypes.CDLL(str(out))
    base_argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_ubyte),
    ]
    consumed_p = ctypes.POINTER(ctypes.c_long)
    lib.omldm_parse_lines.restype = ctypes.c_int
    lib.omldm_parse_lines.argtypes = base_argtypes + [consumed_p]
    lib.omldm_parse_lines_mt.restype = ctypes.c_int
    lib.omldm_parse_lines_mt.argtypes = base_argtypes + [ctypes.c_int, consumed_p]
    ll_p = ctypes.POINTER(ctypes.c_longlong)
    f_p = ctypes.POINTER(ctypes.c_float)
    i32_p = ctypes.POINTER(ctypes.c_int32)
    sparse_argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, i32_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.omldm_parse_lines_sparse.restype = ctypes.c_int
    lib.omldm_parse_lines_sparse.argtypes = sparse_argtypes + [consumed_p]
    lib.omldm_parse_lines_sparse_mt.restype = ctypes.c_int
    lib.omldm_parse_lines_sparse_mt.argtypes = sparse_argtypes + [
        ctypes.c_int, consumed_p,
    ]
    lib.omldm_parse_stage.restype = ctypes.c_int
    lib.omldm_parse_stage.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(StageCtx),
        ll_p, ll_p, ll_p, f_p, f_p,
    ]
    lib.omldm_parse_stage_sparse.restype = ctypes.c_int
    lib.omldm_parse_stage_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(SparseStageCtx), ll_p, ll_p, ll_p,
    ]
    lib.omldm_stage_coo_rows.restype = ctypes.c_longlong
    lib.omldm_stage_coo_rows.argtypes = [
        ctypes.POINTER(SparseStageCtx), i32_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong,
    ]
    return lib


class StageCtx(ctypes.Structure):
    """Mirror of OmldmStageCtx (fastparse.cpp): the fused
    parse->holdout->stage loop's view of the caller's staging buffers."""

    _fields_ = [
        ("stage_x", ctypes.POINTER(ctypes.c_float)),
        ("stage_y", ctypes.POINTER(ctypes.c_float)),
        ("stage_cap", ctypes.c_longlong),
        ("stage_n", ctypes.c_longlong),
        ("hold_x", ctypes.POINTER(ctypes.c_float)),
        ("hold_y", ctypes.POINTER(ctypes.c_float)),
        ("hold_cap", ctypes.c_longlong),
        ("hold_n", ctypes.c_longlong),
        ("hold_head", ctypes.c_longlong),
        ("holdout_count", ctypes.c_longlong),
        ("row_stride", ctypes.c_longlong),
        ("n_features", ctypes.c_int),
        ("test_enabled", ctypes.c_int),
    ]


class SparseStageCtx(ctypes.Structure):
    """Mirror of OmldmSparseStageCtx (fastparse.cpp): the fused sparse
    parse->holdout->stage loop's view of the caller's padded-COO staging
    buffers and holdout ring."""

    _fields_ = [
        ("stage_i", ctypes.POINTER(ctypes.c_int32)),
        ("stage_v", ctypes.POINTER(ctypes.c_float)),
        ("stage_y", ctypes.POINTER(ctypes.c_float)),
        ("stage_cap", ctypes.c_longlong),
        ("stage_n", ctypes.c_longlong),
        ("hold_i", ctypes.POINTER(ctypes.c_int32)),
        ("hold_v", ctypes.POINTER(ctypes.c_float)),
        ("hold_y", ctypes.POINTER(ctypes.c_float)),
        ("hold_cap", ctypes.c_longlong),
        ("hold_n", ctypes.c_longlong),
        ("hold_head", ctypes.c_longlong),
        ("holdout_count", ctypes.c_longlong),
        ("max_nnz", ctypes.c_int),
        ("dense_budget", ctypes.c_int),
        ("hash_space", ctypes.c_longlong),
        ("test_enabled", ctypes.c_int),
    ]


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _build()
    return _lib


def fast_parser_available() -> bool:
    return _get_lib() is not None


class SparseFastParser:
    """Bulk JSON-lines -> padded-COO ((idx, val)[., K], y, op, valid)
    arrays — the sparse twin of :class:`FastParser`. ``valid`` semantics
    match: 1 parsed, 0 dropped, 2 Python-codec fallback (escaped category
    strings, out-of-order keys, metadata, odd scalars). Dense values keep
    positional slots; categoricals hash with zlib-CRC32("{i}={cat}") into
    ``[dense_budget, dense_budget + hash_space)`` with the signed rule —
    bit-identical to SparseVectorizer.vectorize (fuzz-pinned)."""

    def __init__(self, dense_budget: int, hash_space: int, max_nnz: int,
                 n_threads: int = 0, reuse_buffers: bool = False):
        self.dense_budget = dense_budget
        self.hash_space = hash_space
        self.max_nnz = max_nnz
        # <= 0 = auto (FastParser's rule: min(cores, 8)); > 1 parses
        # disjoint line ranges on C threads (each line owns its output
        # row; the CRC prefix cache is thread_local) — the sparse e2e
        # path is parse-bound, so multi-core hosts scale it with the same
        # _mt scheme as the dense parser
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 8)
        self.n_threads = int(n_threads)
        # reuse_buffers: return VIEWS into a persistent scratch instead of
        # fresh np.empty outputs per call. Fresh multi-MB allocations come
        # back from the allocator as unfaulted mmap pages, so the C parser
        # pays a page fault every 4 KB it writes plus munmap TLB
        # shootdowns on free — measured ~15% of the whole sparse parse at
        # Criteo chunk sizes. Only callers that finish with the returned
        # arrays before the next parse call may opt in (the bridge ingest
        # routes do: staging memcpys/copies complete per chunk).
        self.reuse_buffers = bool(reuse_buffers)
        self._scratch = None
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native fast parser unavailable (g++ build failed)")
        self._lib = lib

    def _outputs(self, n_cap: int):
        k = self.max_nnz
        if not self.reuse_buffers:
            return (
                np.empty((n_cap, k), np.int32),
                np.empty((n_cap, k), np.float32),
                np.empty((n_cap,), np.float32),
                np.empty((n_cap,), np.uint8),
                np.empty((n_cap,), np.uint8),
            )
        if self._scratch is None or self._scratch[0].shape[0] < n_cap:
            self._scratch = (
                np.empty((n_cap, k), np.int32),
                np.empty((n_cap, k), np.float32),
                np.empty((n_cap,), np.float32),
                np.empty((n_cap,), np.uint8),
                np.empty((n_cap,), np.uint8),
            )
        return self._scratch

    def _parse_at(self, addr: int, length: int, n_cap: int):
        idx, val, y, op, valid = self._outputs(n_cap)
        n_cap = idx.shape[0]  # a grown scratch can take more rows
        done = ctypes.c_long(0)
        common = (
            ctypes.c_void_p(addr), length, self.dense_budget,
            self.hash_space, self.max_nnz, n_cap,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            op.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if self.n_threads > 1:
            n = self._lib.omldm_parse_lines_sparse_mt(
                *common, self.n_threads, ctypes.byref(done)
            )
        else:
            n = self._lib.omldm_parse_lines_sparse(
                *common, ctypes.byref(done)
            )
        return idx[:n], val[:n], y[:n], op[:n], valid[:n], done.value

    def _empty(self):
        k = self.max_nnz
        return (
            np.empty((0, k), np.int32), np.empty((0, k), np.float32),
            np.empty(0, np.float32), np.empty(0, np.uint8),
            np.empty(0, np.uint8),
        )

    def _parse_region(self, addr: int, length: int, nl_sample: int):
        # size the row estimate from a sampled average line length (sparse
        # records run hundreds of bytes; a fixed 48-byte guess would
        # over-allocate the [n, K] outputs several-fold)
        window = min(length, 1 << 16)
        avg = max(window // max(nl_sample, 1), 8)
        est = length // avg + length // (8 * avg) + 16
        parts = []
        offset = 0
        while offset < length:
            if parts and self.reuse_buffers:
                # a second pass reuses the scratch the previous part views:
                # materialize it first (rare — only on an underestimate)
                parts[-1] = tuple(np.array(a, copy=True) for a in parts[-1])
            out = self._parse_at(addr + offset, length - offset, est)
            parts.append(out[:5])
            offset += out[5]
            est = (length - offset) // avg + 16
        if len(parts) == 1:
            return parts[0]
        return tuple(
            np.concatenate([p[i] for p in parts]) for i in range(5)
        )

    def parse(self, data: bytes):
        if not data:
            return self._empty()
        addr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
        length = len(data)
        return self._parse_region(
            addr, length, data[: min(length, 1 << 16)].count(b"\n")
        )

    def parse_range(self, buf: bytearray, start: int, stop: int):
        """Zero-copy parse of ``buf[start:stop]`` (a writable buffer the
        caller reuses across reads — the sparse block-ingest path; bytes
        are only materialized when a line needs the Python fallback)."""
        if stop <= start:
            return self._empty()
        base = ctypes.addressof(
            (ctypes.c_char * len(buf)).from_buffer(buf)
        )
        window_stop = min(stop, start + (1 << 16))
        return self._parse_region(
            base + start, stop - start, buf.count(b"\n", start, window_stop)
        )


class FusedStage:
    """Runs the fused C parse->holdout->stage loop (omldm_parse_stage).

    Owns the ctypes ``StageCtx`` describing the caller's staging/holdout
    numpy buffers; the caller syncs the mutable cursors (stage_n, holdout
    ring state, holdout cycle counter) in before each C call and out after,
    so Python-side code (device launches, fallback rows) and the C loop can
    interleave on the same state."""

    RC_DONE = 0       # buffer fully consumed
    RC_STAGE_FULL = 1  # caller launches the staged step and resumes
    RC_FALLBACK = 2   # line needs the Python codec
    RC_FORECAST = 3   # forecast row parsed into fore_x / fore_y

    def __init__(
        self,
        stage_x: np.ndarray,
        stage_y: np.ndarray,
        hold_x: np.ndarray,
        hold_y: np.ndarray,
        n_features: int,
        test_enabled: bool,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native fast parser unavailable (g++ build failed)")
        self._lib = lib
        for a in (stage_x, stage_y, hold_x, hold_y):
            if a.dtype != np.float32 or not a.flags.c_contiguous:
                raise ValueError("fused stage buffers must be C-contiguous float32")
        if stage_x.shape[1] != hold_x.shape[1]:
            raise ValueError("stage/holdout row widths differ")
        # keep the arrays alive for the ctx's pointer lifetime
        self._arrays = (stage_x, stage_y, hold_x, hold_y)
        f_p = ctypes.POINTER(ctypes.c_float)
        self.ctx = StageCtx(
            stage_x=stage_x.ctypes.data_as(f_p),
            stage_y=stage_y.ctypes.data_as(f_p),
            stage_cap=stage_x.shape[0],
            stage_n=0,
            hold_x=hold_x.ctypes.data_as(f_p),
            hold_y=hold_y.ctypes.data_as(f_p),
            hold_cap=hold_x.shape[0],
            hold_n=0,
            hold_head=0,
            holdout_count=0,
            row_stride=stage_x.shape[1],
            n_features=n_features,
            test_enabled=1 if test_enabled else 0,
        )
        self._fore_x = np.zeros((stage_x.shape[1],), np.float32)
        self._fore_y = ctypes.c_float(0.0)

    def parse_stage(self, buf: bytearray, start: int, stop: int):
        """One C call over ``buf[start:stop]`` (whole JSON lines only).
        Returns (rc, consumed, special_off, special_len); offsets are
        relative to ``start``."""
        base = ctypes.addressof((ctypes.c_char * len(buf)).from_buffer(buf))
        consumed = ctypes.c_longlong(0)
        soff = ctypes.c_longlong(0)
        slen = ctypes.c_longlong(0)
        rc = self._lib.omldm_parse_stage(
            base + start,
            stop - start,
            ctypes.byref(self.ctx),
            ctypes.byref(consumed),
            ctypes.byref(soff),
            ctypes.byref(slen),
            self._fore_x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(self._fore_y),
        )
        return rc, consumed.value, soff.value, slen.value

    def forecast_row(self):
        return self._fore_x, float(self._fore_y.value)


class SparseFusedStage:
    """Runs the fused sparse C parse->holdout->stage loop
    (omldm_parse_stage_sparse): the padded-COO twin of :class:`FusedStage`.

    Owns the ctypes ``SparseStageCtx`` describing the caller's COO staging
    buffers and sparse holdout ring; the caller syncs the mutable cursors
    (stage_n, holdout ring state, holdout cycle counter) in before each C
    call and out after, exactly like the dense :class:`FusedStage`. Specials (Python
    fallbacks AND forecasts) surface as one RC_SPECIAL code — both re-enter
    through the Python codec's handle_data path, matching the block route's
    special handling byte for byte."""

    RC_DONE = 0        # buffer fully consumed
    RC_STAGE_FULL = 1  # caller launches the staged step and resumes
    RC_SPECIAL = 2     # line re-enters via DataInstance.from_json

    def __init__(
        self,
        stage_i: np.ndarray,
        stage_v: np.ndarray,
        stage_y: np.ndarray,
        hold_i: np.ndarray,
        hold_v: np.ndarray,
        hold_y: np.ndarray,
        dense_budget: int,
        hash_space: int,
        test_enabled: bool,
    ):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native fast parser unavailable (g++ build failed)")
        self._lib = lib
        for a, dt in (
            (stage_i, np.int32), (stage_v, np.float32), (stage_y, np.float32),
            (hold_i, np.int32), (hold_v, np.float32), (hold_y, np.float32),
        ):
            if a.dtype != dt or not a.flags.c_contiguous:
                raise ValueError(
                    "fused sparse stage buffers must be C-contiguous "
                    "int32 idx / float32 val,y"
                )
        if stage_i.shape[1] != hold_i.shape[1]:
            raise ValueError("stage/holdout max_nnz differ")
        # keep the arrays alive for the ctx's pointer lifetime
        self._arrays = (stage_i, stage_v, stage_y, hold_i, hold_v, hold_y)
        f_p = ctypes.POINTER(ctypes.c_float)
        i_p = ctypes.POINTER(ctypes.c_int32)
        self.ctx = SparseStageCtx(
            stage_i=stage_i.ctypes.data_as(i_p),
            stage_v=stage_v.ctypes.data_as(f_p),
            stage_y=stage_y.ctypes.data_as(f_p),
            stage_cap=stage_i.shape[0],
            stage_n=0,
            hold_i=hold_i.ctypes.data_as(i_p),
            hold_v=hold_v.ctypes.data_as(f_p),
            hold_y=hold_y.ctypes.data_as(f_p),
            hold_cap=hold_i.shape[0],
            hold_n=0,
            hold_head=0,
            holdout_count=0,
            max_nnz=stage_i.shape[1],
            dense_budget=dense_budget,
            hash_space=hash_space,
            test_enabled=1 if test_enabled else 0,
        )

    def parse_stage(self, buf: bytearray, start: int, stop: int):
        """One C call over ``buf[start:stop]`` (whole JSON lines only).
        Returns (rc, consumed, special_off, special_len); offsets are
        relative to ``start``."""
        base = ctypes.addressof((ctypes.c_char * len(buf)).from_buffer(buf))
        consumed = ctypes.c_longlong(0)
        soff = ctypes.c_longlong(0)
        slen = ctypes.c_longlong(0)
        rc = self._lib.omldm_parse_stage_sparse(
            base + start,
            stop - start,
            ctypes.byref(self.ctx),
            ctypes.byref(consumed),
            ctypes.byref(soff),
            ctypes.byref(slen),
        )
        return rc, consumed.value, soff.value, slen.value

    def stage_rows(
        self, idx: np.ndarray, val: np.ndarray, y: np.ndarray, start: int
    ) -> int:
        """Holdout + stage already-parsed COO rows ``[start, n)`` through
        the C stager (omldm_stage_coo_rows — the MT block route's staging
        tail). Pauses at stage-full; returns rows consumed."""
        n = idx.shape[0] - start
        if n <= 0:
            return 0
        iv, vv, yv = idx[start:], val[start:], y[start:]
        return int(
            self._lib.omldm_stage_coo_rows(
                ctypes.byref(self.ctx),
                iv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                vv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                yv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n,
            )
        )


class FastParser:
    """Bulk JSON-lines -> packed (x, y, op, valid) arrays.

    ``valid`` semantics (see fastparse.cpp): 1 = parsed, 0 = dropped,
    2 = needs the Python fallback (categorical features / metadata);
    callers reparse flagged lines with ``DataInstance.from_json``.

    ``n_threads`` > 1 uses the multithreaded C entry (disjoint line ranges
    per std::thread; ctypes releases the GIL for the call's duration, so a
    prefetch thread parsing blocks overlaps the device feed)."""

    def __init__(self, dim: int, n_threads: int = 0):
        self.dim = dim
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 8)
        self.n_threads = n_threads
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native fast parser unavailable (g++ build failed)")
        self._lib = lib

    def _parse_at(self, addr: int, length: int, n_cap: int):
        """One C call over ``length`` bytes at ``addr``, arrays sized for
        n_cap lines. Returns (x, y, op, valid) sliced to the consumed rows
        + the bytes consumed."""
        # np.empty: y/op/valid are unconditionally stored per consumed
        # line; x rows are only defined where valid == 1 (callers mask or
        # reparse the rest), and the caller slices to the consumed count
        x = np.empty((n_cap, self.dim), np.float32)
        y = np.empty((n_cap,), np.float32)
        op = np.empty((n_cap,), np.uint8)
        valid = np.empty((n_cap,), np.uint8)
        done = ctypes.c_long(0)
        args = (
            ctypes.c_void_p(addr),
            length,
            self.dim,
            n_cap,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            op.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        if self.n_threads > 1:
            n = self._lib.omldm_parse_lines_mt(
                *args, self.n_threads, ctypes.byref(done)
            )
        else:
            n = self._lib.omldm_parse_lines(*args, ctypes.byref(done))
        return x[:n], y[:n], op[:n], valid[:n], done.value

    def _parse_region(self, addr: int, length: int):
        # Size the output by an average-line-length estimate instead of a
        # newline-counting pre-pass (which cost ~20% of the whole parse);
        # the C parser reports the bytes it consumed, so an underestimate
        # just means another call over the remainder.
        est = length // 48 + 16
        x, y, op, valid, done = self._parse_at(addr, length, est)
        if done >= length:
            return x, y, op, valid
        parts = [(x, y, op, valid)]
        offset = done
        while offset < length:
            est = (length - offset) // 16 + 16
            x, y, op, valid, done = self._parse_at(
                addr + offset, length - offset, est
            )
            parts.append((x, y, op, valid))
            offset += done
        return tuple(
            np.concatenate([p[i] for p in parts]) for i in range(4)
        )

    def parse(
        self, data: bytes
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        if not data:
            return self._empty()
        addr = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
        return self._parse_region(addr, len(data))

    def parse_range(self, buf: bytearray, start: int, stop: int):
        """Zero-copy parse of ``buf[start:stop]`` (a writable buffer the
        caller reuses across reads — the readinto ingest path)."""
        if stop <= start:
            return self._empty()
        base = ctypes.addressof(
            (ctypes.c_char * len(buf)).from_buffer(buf)
        )
        return self._parse_region(base + start, stop - start)

    def _empty(self):
        return (
            np.empty((0, self.dim), np.float32),
            np.empty(0, np.float32),
            np.empty(0, np.uint8),
            np.empty(0, np.uint8),
        )
