"""Bulk ingest through the native parser, with Python fallback (the port's
copy of the JAX package's ``runtime/fast_ingest.py``).

Replaces the per-record Python JSON path for file replay / bulk feeds: the
C++ parser (multithreaded, GIL-released) packs records straight into batch
arrays; lines it flags (categorical features, metadata, odd schemas) are
reparsed with the Python ``DataInstance`` codec so drop/keep semantics match
exactly. Everything after the parse is vectorized numpy — no per-record
Python object is ever built for fast-schema records.

Reference counterpart: DataInstanceParser + DataPointParser (reference:
src/main/scala/omldm/utils/parsers/DataInstanceParser.scala:12-22,
dataStream/DataPointParser.scala:16-54) — the per-record Jackson hot path,
rebuilt as a block parser so one host core can keep the device fed.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from omldm_tpu_torch.api.data import FORECASTING, DataInstance
from omldm_tpu_torch.runtime.vectorizer import F32_MAX, Vectorizer

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]

#: blocks of lines parsed by the native parser and by the Python codec, in
#: this process (a caller sets them to 0 and reads them back to show which
#: parser a run took; lines the native parser flags for the codec count
#: under "native", with their block)
blocks = {"native": 0, "python": 0}


class PackedBatcher:
    def __init__(
        self, dim: int, batch_size: int, hash_dims: int = 0, n_threads: int = 0
    ):
        self.dim = dim
        self.batch_size = batch_size
        self.hash_dims = hash_dims
        self.vec = Vectorizer(dim, hash_dims)
        try:
            from omldm_tpu_torch.ops.native import FastParser

            # the C parser packs dense features only; cap it at the dense
            # budget so the trailing hash_dims slots (reserved for hashed
            # categoricals) stay zero, matching the Vectorizer layout
            self.parser: Optional[object] = FastParser(
                dim - hash_dims, n_threads
            )
        except (RuntimeError, ImportError):
            self.parser = None
        # ragged tail carried between feed() calls (always < batch_size
        # rows) lives in a FIXED accumulator: topping it up is one bounded
        # memcpy per feed, where a grow-by-concatenate carry re-copied all
        # accumulated rows on every call (measurable at 1M+ rows/sec)
        self._acc_x = np.empty((batch_size, dim), np.float32)
        self._acc_y = np.empty((batch_size,), np.float32)
        self._acc_op = np.empty((batch_size,), np.uint8)
        self._acc_n = 0

    def _parse_block(
        self, block: bytes
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One block of whole JSON lines -> kept (x[., dim], y, op) rows."""
        if self.parser is None:
            return self._parse_block_python(block)
        blocks["native"] += 1
        parsed = self.parser.parse(block)
        return self._postprocess(parsed, lambda: block)

    def _postprocess(
        self, parsed, get_block
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Widen to the hash layout + reparse fallback-flagged lines with
        the Python codec (``get_block`` lazily materializes the bytes —
        only paid when a line actually needs the fallback)."""
        x, y, op, valid = parsed
        if self.hash_dims > 0:
            out = np.zeros((x.shape[0], self.dim), np.float32)
            out[:, : x.shape[1]] = x
        else:
            out = x
        fallback = np.nonzero(valid == 2)[0]
        if fallback.size:
            lines = get_block().split(b"\n")
            for i in fallback:
                inst = DataInstance.from_json(
                    lines[i].decode("utf-8", errors="replace")
                )
                if inst is None:
                    valid[i] = 0
                    continue
                out[i] = self.vec.vectorize(inst)
                # same float32 clamp the C parser applies to targets
                y[i] = (
                    0.0 if inst.target is None
                    else min(max(float(inst.target), -F32_MAX), F32_MAX)
                )
                op[i] = 1 if inst.operation == FORECASTING else 0
                valid[i] = 1
        keep = valid == 1
        if keep.all():
            return out, y, op
        return out[keep], y[keep], op[keep]

    def _parse_block_python(
        self, block: bytes
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        blocks["python"] += 1
        rows_x: List[np.ndarray] = []
        rows_y: List[float] = []
        rows_op: List[int] = []
        for line in block.split(b"\n"):
            inst = DataInstance.from_json(line.decode("utf-8", errors="replace"))
            if inst is None:
                continue
            rows_x.append(self.vec.vectorize(inst))
            rows_y.append(
                0.0 if inst.target is None
                else min(max(float(inst.target), -F32_MAX), F32_MAX)
            )
            rows_op.append(1 if inst.operation == FORECASTING else 0)
        if not rows_x:
            return (
                np.zeros((0, self.dim), np.float32),
                np.zeros((0,), np.float32),
                np.zeros((0,), np.uint8),
            )
        return (
            np.stack(rows_x),
            np.asarray(rows_y, np.float32),
            np.asarray(rows_op, np.uint8),
        )

    def parse_rows(
        self, buf, start: int = 0, stop: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Parse ``buf[start:stop]`` (whole JSON lines) to kept
        (x[n, dim], y[n], op[n]) rows WITHOUT the batch accumulator -- the
        block entry point for callers that do their own batching (the
        sharded ingest workers, which hand whole-chunk row blocks to the
        driver's rings in stream order)."""
        if stop is None:
            stop = len(buf)
        if self.parser is None:
            return self._parse_block_python(bytes(buf[start:stop]))
        blocks["native"] += 1
        parsed = self.parser.parse_range(buf, start, stop)
        return self._postprocess(parsed, lambda: bytes(buf[start:stop]))

    def feed_buffer(self, buf: bytearray, start: int, stop: int) -> Iterator[Batch]:
        """Zero-copy variant of :meth:`feed`: parse ``buf[start:stop]``
        (whole JSON lines) straight out of the caller's reusable read
        buffer; bytes are only materialized if a line needs the Python
        fallback."""
        if self.parser is None:
            yield from self.feed(bytes(buf[start:stop]))
            return
        blocks["native"] += 1
        parsed = self.parser.parse_range(buf, start, stop)
        rows = self._postprocess(parsed, lambda: bytes(buf[start:stop]))
        yield from self._emit(rows)

    def feed(self, block: bytes) -> Iterator[Batch]:
        """Consume a byte block of whole JSON lines; yields full batches."""
        yield from self._emit(self._parse_block(block))

    def _emit(self, rows: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> Iterator[Batch]:
        """Yield full batches in stream order. Whole batches that need no
        accumulation are yielded as VIEWS into the parsed block (consumers
        slice/copy before training; holding one alive just pins its block);
        accumulator flushes are copies since the buffer is reused."""
        x, y, op = rows
        n = x.shape[0]
        if n == 0:
            return
        b = self.batch_size
        i = 0
        if self._acc_n:
            take = min(b - self._acc_n, n)
            j = self._acc_n + take
            self._acc_x[self._acc_n : j] = x[:take]
            self._acc_y[self._acc_n : j] = y[:take]
            self._acc_op[self._acc_n : j] = op[:take]
            self._acc_n = j
            i = take
            if self._acc_n == b:
                yield self._acc_x.copy(), self._acc_y.copy(), self._acc_op.copy()
                self._acc_n = 0
        while n - i >= b:
            yield x[i : i + b], y[i : i + b], op[i : i + b]
            i += b
        if i < n:
            r = n - i
            self._acc_x[:r] = x[i:]
            self._acc_y[:r] = y[i:]
            self._acc_op[:r] = op[i:]
            self._acc_n = r

    def flush(self) -> Optional[Batch]:
        if self._acc_n == 0:
            return None
        r = self._acc_n
        self._acc_n = 0
        return (
            self._acc_x[:r].copy(),
            self._acc_y[:r].copy(),
            self._acc_op[:r].copy(),
        )


def iter_file_batches(
    path: str, dim: int, batch_size: int, hash_dims: int = 0,
    chunk_bytes: int = 1 << 22, n_threads: int = 0,
) -> Iterator[Batch]:
    """Stream a JSON-lines file as packed (x, y, op) batches.

    Reads into one reusable buffer (``readinto``) and parses in place —
    the only per-chunk copy is the carried partial line moved to the
    buffer head."""
    b = PackedBatcher(dim, batch_size, hash_dims, n_threads)
    buf = bytearray(chunk_bytes)
    carry = 0  # bytes of partial line sitting at buf[:carry]
    with open(path, "rb") as f:
        while True:
            if carry >= len(buf):  # one line longer than the whole buffer
                buf.extend(bytes(len(buf)))
            n = f.readinto(memoryview(buf)[carry:])
            if not n:
                break
            end = carry + n
            cut = buf.rfind(b"\n", 0, end)
            if cut < 0:
                carry = end
                continue
            yield from b.feed_buffer(buf, 0, cut + 1)
            carry = end - (cut + 1)
            if carry:
                buf[:carry] = buf[cut + 1 : end]
        if carry:
            buf[carry : carry + 1] = b"\n"
            yield from b.feed_buffer(buf, 0, carry + 1)
    tail = b.flush()
    if tail:
        yield tail
