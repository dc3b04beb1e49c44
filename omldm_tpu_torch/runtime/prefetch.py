"""Background prefetch for ingest iterators (the port's copy of the JAX
package's ``runtime/prefetch.py``).

Host→device double buffering, stage one: a daemon thread drains the source
iterator (file read + C++ parse, which releases the GIL) into a small
bounded queue while the consumer feeds the device. With the parse and the
device step overlapped, pipeline throughput is max(parse, step) instead of
their sum — the reference gets the same overlap from Flink's network stack
running ahead of the operator thread (SURVEY.md §7 hard part (d)).

:func:`prefetch` returns a :class:`Prefetcher` — an iterator object rather
than a bare generator so the ring's occupancy is observable
(``queued()`` / ``occupancy()``, the queue-depth contract shared with
``ServingPlane.queued()``): a full ring means the consumer is the
bottleneck, an empty one the parser, and the overload controller can watch
it as an external pressure signal (``Prefetcher.as_signal``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher(Iterator[T]):
    """Iterate ``source`` on a daemon thread, ``depth`` items ahead.

    Exceptions raised by the source are re-raised at the consumption
    point; abandoning the iterator (``close()`` / GC) stops the thread at
    its next put. Iteration semantics are identical to the original
    generator form (tests/test_prefetch.py pins the error paths)."""

    def __init__(self, source: Iterable[T], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._run, args=(source,), daemon=True
        )
        self._thread.start()

    # --- producer side ---------------------------------------------------

    def _put_until_stopped(self, item) -> bool:
        """Stop-aware bounded put: retry until the consumer drains a slot
        or abandons the iterator (stop set). True when delivered."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, source: Iterable[T]) -> None:
        try:
            for item in source:
                if not self._put_until_stopped(item):
                    return
            self._put_until_stopped(_SENTINEL)
        except BaseException as e:  # propagate to the consumer
            # NEVER dropped: with the bounded queue full at raise time, a
            # fire-and-forget put would either block this thread forever
            # or (swallowed) starve the consumer of both the error and
            # the sentinel
            self._put_until_stopped(e)

    # --- consumer side ---------------------------------------------------

    def __iter__(self) -> "Prefetcher[T]":
        return self

    def __next__(self) -> T:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self) -> None:
        """Release the producer thread (the generator form's ``finally``;
        safe to call more than once)."""
        self._done = True
        self._stop.set()

    def __del__(self):  # GC abandonment releases the producer too
        self._stop.set()

    # --- observability ---------------------------------------------------

    def queued(self) -> int:
        """Items currently buffered ahead of the consumer."""
        return self._q.qsize()

    @property
    def depth(self) -> int:
        return self._q.maxsize

    def occupancy(self) -> float:
        """Ring fill fraction in [0, 1] — 1.0 means the parser is running
        ahead of a stalled consumer."""
        return self._q.qsize() / self._q.maxsize

    def as_signal(self, high: float = 0.75, critical: float = 0.95):
        """Occupancy as an ``OverloadController.extra_signals`` probe: the
        value is the ring's EMPTINESS (1 - occupancy), so a source that
        cannot keep the ring fed raises the overload level instead of
        starving the consumer in silence. ``high`` and ``critical`` are
        emptiness fractions."""

        def probe():
            return 1.0 - self.occupancy(), high, critical

        return probe


def prefetch(source: Iterable[T], depth: int = 2) -> Prefetcher[T]:
    """Back-compat constructor: iterate ``source`` on a daemon thread,
    ``depth`` items ahead."""
    return Prefetcher(source, depth)
