"""Kafka transport adapters: the job's sources and sinks on Kafka topics.

Counterpart of ``omldm_tpu/runtime/kafka_io.py`` (a copy; the port never
imports the JAX package). The reference wires seven topics through
``KafkaUtils`` (src/main/scala/omldm/utils/KafkaUtils.scala:11-54;
trainingData, forecastingData, requests, psMessages, predictions,
responses, performance -- README.md:21-26, FlinkLearning.scala:53-59). The
hub<->spoke feedback loop (psMessages) is in-process here, so only the
EXTERNAL topics need Kafka: records and requests in, predictions /
responses / performance / dead letters out.

The adapters accept any object with the small protocols below, so tests
(and non-Kafka deployments) can inject fakes; :func:`connect_kafka` wires
real clients when ``kafka-python`` is installed and raises ``ImportError``
naming it otherwise. Everything here is host code: the device work is the
streaming job the events feed.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Iterator, Mapping, Optional, Tuple

from omldm_tpu_torch.runtime.job import (
    FORECASTING_STREAM,
    REQUEST_STREAM,
    TRAINING_STREAM,
)
from omldm_tpu_torch.utils.backoff import BackoffPolicy, with_backoff

# connect-time metadata / client-construction retries: a fresh client can
# transiently miss partition metadata, and a broker mid-restart refuses
# connections for a few seconds -- both recover under short backoff
CONNECT_RETRY = BackoffPolicy(attempts=5, base_delay=0.2, growth=1.5, jitter=0.05)
# producer sends are on the streaming hot path: retry briefly, then the
# sink DEGRADES (warn + drop) instead of raising out of the pump loop
SEND_RETRY = BackoffPolicy(attempts=3, base_delay=0.05, jitter=0.02)

# topic-name defaults mirroring the reference (README.md:21-26)
DEFAULT_TOPICS = {
    "trainingData": TRAINING_STREAM,
    "forecastingData": FORECASTING_STREAM,
    "requests": REQUEST_STREAM,
}
DEFAULT_OUT_TOPICS = {
    "predictions": "predictions",
    "responses": "responses",
    "performance": "performance",
    # quarantined records/requests with reason codes (runtime.deadletter);
    # no reference counterpart -- the reference drops them silently
    "deadLetters": "deadLetters",
}


def _record_to_event(
    record: Any, topic_map: Mapping[str, str]
) -> Optional[Tuple[str, str]]:
    """ConsumerRecord -> (stream, payload), or None for unknown topics."""
    stream = topic_map.get(record.topic)
    if stream is None:
        return None
    value = record.value
    if isinstance(value, bytes):
        value = value.decode("utf-8", errors="replace")
    return (stream, value)


def consumer_events(
    consumer: Any,
    topic_map: Optional[Mapping[str, str]] = None,
) -> Iterator[Tuple[str, str]]:
    """Adapt a Kafka-style consumer into the job's event iterable.

    ``consumer`` must yield objects with ``.topic`` and ``.value`` (bytes or
    str) -- the shape of kafka-python's ConsumerRecord. Unknown topics are
    skipped."""
    topic_map = dict(topic_map or DEFAULT_TOPICS)
    for record in consumer:
        event = _record_to_event(record, topic_map)
        if event is not None:
            yield event


def polling_events(
    consumer: Any,
    topic_map: Optional[Mapping[str, str]] = None,
    tracker: Optional[dict] = None,
    pause_when: Optional[Any] = None,
    pause_sleep_s: float = 0.05,
) -> Iterator[Optional[Tuple[str, str]]]:
    """Adapt a poll-style Kafka consumer into a NEVER-ENDING event iterable
    that yields ``None`` whenever a poll window elapses with no message.

    ``consumer`` must support ``next(consumer)`` raising ``StopIteration``
    on an idle window (kafka-python's behavior when ``consumer_timeout_ms``
    is set; each subsequent ``next`` resumes fetching). The ``None`` idle
    markers let the driver run the silence-timer termination check
    (StatisticsOperator.scala:135-142) even when the broker goes quiet.

    ``tracker`` (a mutable dict) records the NEXT offset to read per
    ``(topic, partition)`` as records are consumed -- the source-position
    side of a checkpoint (what a Flink checkpoint barrier snapshots from
    its Kafka sources), enabling seek-and-replay recovery. Records without
    an ``offset`` attribute advance a per-partition counter instead.

    ``pause_when`` (a nullary callable) is the UPSTREAM BACKPRESSURE
    valve: while it returns True -- the overload controller reporting
    CRITICAL pressure (``StreamJob.overload_level()``) -- no record is
    consumed; the loop sleeps briefly and yields idle markers so the
    driver keeps running its silence/recovery ticks. Unconsumed records'
    offsets are never tracked, so paused traffic is REPLAYABLE (the
    at-least-once posture of Flink's credit-based backpressure) instead
    of buffered into host memory."""
    import time as _time

    topic_map = dict(topic_map or DEFAULT_TOPICS)
    while True:
        if pause_when is not None and pause_when():
            _time.sleep(pause_sleep_s)
            yield None
            continue
        try:
            record = next(consumer)
        except StopIteration:
            yield None
            continue
        if tracker is not None:
            key = (record.topic, getattr(record, "partition", 0))
            offset = getattr(record, "offset", None)
            if offset is None:
                offset = tracker.get(key, 0)
            tracker[key] = offset + 1
        event = _record_to_event(record, topic_map)
        if event is not None:
            yield event


class ProducerSinks:
    """Producer-backed sinks for predictions / responses / performance.

    ``producer`` must expose ``send(topic, value: bytes)`` (kafka-python
    shape). Returns the three callbacks StreamJob accepts. ``consumer``,
    when provided, is owned too: :meth:`close` shuts both down (used by
    supervised recovery before rebuilding the clients, so restarts do not
    leak broker connections).

    Failure semantics: each send retries under ``retry`` (short backoff);
    a send that still fails DEGRADES -- the record is dropped with a
    warning instead of raising out of the streaming pump loop, so a broker
    that dies mid-run downgrades topic publication to warnings while the
    job (and any file sinks) keeps flowing. Drops are counted in
    ``dropped`` and summarized at :meth:`close`. This is the sink half of
    the reference's posture: the Flink job's Kafka producers buffer and
    fail asynchronously rather than crashing the operator chain."""

    # warn for the first few drops per topic, then thin the log
    _WARN_FIRST = 3
    _WARN_EVERY = 100
    # consecutive exhausted sends before the breaker trips: a dead broker
    # must not charge every remaining record the full retry backoff on the
    # streaming hot path -- trip, drop with ONE cheap probe per record (so
    # a healed broker closes the breaker again), no sleeping
    _BREAKER_AFTER = 5

    def __init__(
        self,
        producer: Any,
        out_topics: Optional[Mapping[str, str]] = None,
        consumer: Any = None,
        retry: Optional[BackoffPolicy] = None,
    ):
        self.producer = producer
        self.consumer = consumer
        self.topics = dict(out_topics or DEFAULT_OUT_TOPICS)
        self.retry = retry or SEND_RETRY
        self.dropped = 0
        self._drops_by_topic: dict = {}
        self._consecutive_failures = 0

    def close(self) -> None:
        if self.dropped:
            print(
                f"warning: {self.dropped} output record(s) dropped by "
                f"unreachable producer (per topic: {self._drops_by_topic})",
                file=sys.stderr,
            )
        for client in (self.consumer, self.producer):
            close = getattr(client, "close", None)
            if close is not None:
                try:
                    close()
                except Exception as exc:  # a dead client must not mask shutdown
                    print(
                        f"warning: producer/consumer close failed: {exc}",
                        file=sys.stderr,
                    )

    def _send(self, topic_key: str, obj: Any) -> None:
        payload = obj.to_json() if hasattr(obj, "to_json") else json.dumps(obj)
        topic = self.topics[topic_key]
        tripped = self._consecutive_failures >= self._BREAKER_AFTER
        try:
            if tripped:  # breaker open: one probe, no retries, no sleep
                self.producer.send(topic, payload.encode())
            else:
                with_backoff(
                    lambda: self.producer.send(topic, payload.encode()),
                    retry_on=(Exception,),
                    policy=self.retry,
                )
            self._consecutive_failures = 0
        except Exception as exc:
            self._consecutive_failures += 1
            self.dropped += 1
            n = self._drops_by_topic.get(topic, 0) + 1
            self._drops_by_topic[topic] = n
            if n <= self._WARN_FIRST or n % self._WARN_EVERY == 0:
                print(
                    f"warning: dropping record for topic {topic!r} "
                    f"(send failed {n}x: {type(exc).__name__}: {exc}); "
                    "continuing without topic publication",
                    file=sys.stderr,
                )

    def on_prediction(self, pred) -> None:
        self._send("predictions", pred)

    def on_response(self, resp) -> None:
        self._send("responses", resp)

    def on_performance(self, report) -> None:
        self._send("performance", report)

    def on_dead_letter(self, entry: dict) -> None:
        """Publish one quarantined record/request (a plain dict entry from
        :class:`~omldm_tpu_torch.runtime.deadletter.DeadLetterSink`). Same
        degrade-on-failure semantics as every other sink -- the quarantine
        ring and file keep the entry either way."""
        self._send("deadLetters", entry)


def _partitions_with_retry(consumer, topic, retry: Optional[BackoffPolicy] = None):
    """partitions_for_topic can transiently return None on a fresh client
    (metadata not fetched yet) -- retry with backoff, ``None`` after the
    budget (callers keep their degrade paths)."""
    return with_backoff(
        lambda: consumer.partitions_for_topic(topic),
        accept=bool,
        policy=retry or CONNECT_RETRY,
    ) or None


def connect_kafka(
    brokers: str,
    topic_map: Optional[Mapping[str, str]] = None,
    out_topics: Optional[Mapping[str, str]] = None,
    poll_timeout_ms: int = 1000,
    position: Optional[Mapping[Tuple[str, int], int]] = None,
    tracker: Optional[dict] = None,
    retry: Optional[BackoffPolicy] = None,
    send_retry: Optional[BackoffPolicy] = None,
    pause_when: Optional[Any] = None,
) -> Tuple[Iterator[Optional[Tuple[str, str]]], "ProducerSinks"]:
    """Wire real Kafka clients. Requires kafka-python (a module importable
    as ``kafka``); raises ImportError with guidance otherwise -- use file
    replay or in-memory events instead. There is no fallback.

    ``position`` (a checkpoint's ``source_position``): manually assign the
    UNION of the topic map's partitions -- partitions with a recorded
    next-offset seek there (seek-and-replay recovery, the consumer side of
    Flink's restore-from-checkpoint). Partitions ABSENT from the snapshot
    split by stream: request-topic partitions rewind to the beginning (a
    fresh-state incarnation must re-consume Create/Update/Delete to rebuild
    its topology -- _run_kafka deliberately drops those keys), while data
    partitions seek to the live END -- the original consumer (subscribe
    mode, latest) started at the log end, so an idle-before-snapshot or
    created-after-snapshot partition must not replay retained history the
    original job never consumed. At initial connect the ``tracker`` is
    seeded with every partition's starting position (its end offset at
    connect time) so snapshots record idle partitions as consumed-from-
    start. Under manual assignment, partitions created after the reconnect
    are not picked up (same caveat as Flink restore without partition
    discovery). ``tracker`` is threaded through to
    :func:`polling_events`."""
    try:
        from kafka import KafkaConsumer, KafkaProducer, TopicPartition  # type: ignore
    except ImportError as e:
        raise ImportError(
            "Kafka transport needs the 'kafka-python' package (or adapt "
            "confluent_kafka to consumer_events/ProducerSinks); neither is "
            "installed -- use omldm_tpu_torch.runtime.ingest file replay or "
            "in-memory events."
        ) from e
    topic_map = dict(topic_map or DEFAULT_TOPICS)
    retry = retry or CONNECT_RETRY

    def _client(ctor, *args, **kw):
        # broker mid-restart: client CONSTRUCTION (bootstrap metadata)
        # retries under the same policy as partition metadata
        return with_backoff(
            lambda: ctor(*args, **kw),
            retry_on=(Exception,),
            policy=retry,
        )

    # consumer_timeout_ms bounds each poll so the iterator goes idle (raises
    # StopIteration, resumable) instead of blocking forever -- required for
    # the silence-timer termination to ever fire on a quiet broker
    if position is not None:
        consumer = _client(
            KafkaConsumer,
            bootstrap_servers=brokers,
            consumer_timeout_ms=poll_timeout_ms,
        )
        # union of the subscribed topics' partitions: a topic that never
        # delivered a record before the snapshot must still be consumed.
        # On metadata failure fall back to the snapshot-recorded
        # partitions + partition 0, and say so: silently narrowing a
        # multi-partition topic would lose data
        assigned = []
        for topic in topic_map:
            parts = _partitions_with_retry(consumer, topic, retry)
            if not parts:
                parts = {
                    p for (t, p) in position if t == topic
                } | {0}
                import sys as _sys

                print(
                    f"warning: no partition metadata for topic {topic!r} "
                    f"after retries; assigning {sorted(parts)} (snapshot "
                    "partitions + 0) — records on other partitions will "
                    "not be consumed",
                    file=_sys.stderr,
                )
            assigned.extend(TopicPartition(topic, p) for p in parts)
        for (t, p) in position:
            if TopicPartition(t, p) not in assigned:
                assigned.append(TopicPartition(t, p))
        consumer.assign(assigned)
        for tp in assigned:
            offset = position.get((tp.topic, tp.partition))
            if offset is not None:
                consumer.seek(tp, offset)
            elif topic_map.get(tp.topic) == REQUEST_STREAM:
                # deliberate control-stream rewind: fresh-state
                # incarnations re-consume Create/Update/Delete to rebuild
                # topology (_run_kafka drops these keys on purpose)
                consumer.seek_to_beginning(tp)
            else:
                # data partition the snapshot never recorded: the original
                # consumer (subscribe mode, latest) started at the live
                # end -- replaying retained history it never consumed would
                # train on and emit predictions for arbitrarily old data.
                # Seeding at connect is best-effort, so a partition created
                # (or left unseeded) between connect and the crash loses
                # whatever it received before this recovery: WARN so the
                # operator can see the potential gap instead of silence
                import sys as _sys

                print(
                    f"warning: data partition {tp.topic}:{tp.partition} "
                    "has no snapshot offset; seeking to live END — any "
                    "records delivered to it before this recovery are "
                    "skipped (tracker seeding may have failed at connect)",
                    file=_sys.stderr,
                )
                consumer.seek_to_end(tp)
            # record where this incarnation starts each partition so the
            # NEXT snapshot covers it -- without this, a partition that
            # stays quiet between two recoveries is re-sought to the
            # then-current end and everything in between is lost
            if tracker is not None and (tp.topic, tp.partition) not in tracker:
                try:
                    tracker[(tp.topic, tp.partition)] = consumer.position(tp)
                except Exception:
                    pass  # best-effort, like the initial-connect seeding
    else:
        consumer = _client(
            KafkaConsumer,
            *topic_map.keys(),
            bootstrap_servers=brokers,
            consumer_timeout_ms=poll_timeout_ms,
        )
        if tracker is not None:
            # Seed the tracker with every partition's STARTING position
            # (its end offset now -- what a latest-mode subscriber starts
            # from): a partition idle until the first snapshot is then
            # recorded as consumed-from-start, so recovery seeks it back
            # there instead of hitting the untracked-partition path above.
            # Single metadata attempt per topic: seeding is best-effort and
            # a not-yet-created topic (broker auto-creation) must not stall
            # startup behind the retry backoff.
            # KNOWN WINDOW: a latest-mode subscriber's true start position
            # is assigned at the first rebalance, slightly AFTER this
            # end_offsets call. Records arriving in between are consumed
            # and overwrite the seed; but a crash before the first record
            # of a partition replays from the (older) seeded offset -- a
            # small duplicate-training window, the benign direction for a
            # streaming learner (at-least-once, like the reference's
            # restart without committed offsets).
            for topic in topic_map:
                parts = consumer.partitions_for_topic(topic)
                if not parts:
                    continue
                tps = [TopicPartition(topic, p) for p in parts]
                try:
                    ends = consumer.end_offsets(tps)
                except Exception:
                    continue  # seeding is best-effort, never fatal
                for tp, off in ends.items():
                    tracker.setdefault((tp.topic, tp.partition), off)
    producer = _client(KafkaProducer, bootstrap_servers=brokers)
    # broker-side chaos (OMLDM_CHAOS_KAFKA): seeded drop/dup/reorder on the
    # consumed record stream -- the at-least-once misbehavior a real broker
    # exhibits across restarts/rebalances, made deterministic for tests.
    # Unarmed (the default) this returns the consumer untouched.
    from omldm_tpu_torch.runtime.supervisor import maybe_chaos_consumer

    chaos_consumer = maybe_chaos_consumer(
        consumer,
        # the CONTROL stream is exempt from poison-record injection: a
        # poisoned request is consumed (offset advances, no replay) and
        # its loss would silently change the job topology
        poison_exempt_topics=[
            t for t, s in topic_map.items() if s == REQUEST_STREAM
        ],
    )
    return (
        polling_events(
            chaos_consumer, topic_map, tracker=tracker,
            pause_when=pause_when,
        ),
        ProducerSinks(
            producer, out_topics, consumer=consumer, retry=send_retry
        ),
    )
