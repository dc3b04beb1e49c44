"""Ingest sources: file replay and in-memory streams (the port's copy of
the JAX package's ``runtime/ingest.py``, without ``sharded_packed_events``,
which nothing calls: the sharded ingest plane's driver loop is
``StreamJob.run_file_sharded``).

Reference counterpart: the Kafka sources of Job.scala:42-67,127-142 with
``SimpleStringSchema`` JSON lines; the ``"EOS"`` marker
(DataInstanceParser.scala:14) hints at the reference's own file-replay
tooling. A Kafka consumer adapter can wrap these iterators when a broker is
available (gated import — no broker needed for tests/benchmarks).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Iterator, Sequence, Tuple

from omldm_tpu_torch.api.data import EOS


def file_events(path: str, stream: str) -> Iterator[Tuple[str, str]]:
    """Replay a JSON-lines file as (stream, line) events.

    ``"EOS"`` markers are DROPPED and replay continues — the reference's
    parser swallows them mid-stream (DataInstanceParser.scala:13-21), and
    the C++ bulk path does the same (fastparse.cpp); terminating here would
    silently truncate a stream that embeds markers."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line == EOS or line == f'"{EOS}"':
                continue
            yield (stream, line)


def memory_events(stream: str, items: Sequence[Any]) -> Iterator[Tuple[str, Any]]:
    for item in items:
        yield (stream, item)


def interleave(*sources: Iterable[Tuple[str, Any]]) -> Iterator[Tuple[str, Any]]:
    """Round-robin interleave of event sources (a deterministic stand-in for
    the reference's stream union, Job.scala:70)."""
    iterators = [iter(s) for s in sources]
    while iterators:
        alive = []
        for it in iterators:
            try:
                yield next(it)
                alive.append(it)
            except StopIteration:
                pass
        iterators = alive


def records_to_events(
    stream: str, records: Iterable[Any]
) -> Iterator[Tuple[str, Any]]:
    """Wrap parsed objects (DataInstance / Request) as events."""
    for r in records:
        yield (stream, r)


def jsonl_dumps(objs: Iterable[Any]) -> str:
    """Serialize objects (with .to_dict) to a JSON-lines string + EOS."""
    lines = [json.dumps(o.to_dict() if hasattr(o, "to_dict") else o) for o in objs]
    lines.append(EOS)
    return "\n".join(lines)
