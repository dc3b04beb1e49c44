"""Failure detection and restart-from-checkpoint supervision.

Counterpart of ``omldm_tpu/runtime/recovery.py``. The reference job carries
no failure detector of its own: it delegates crash recovery to Flink's
restart-from-checkpoint machinery (the ``RestartStrategies`` import at
Job.scala:14 and the opt-in checkpoint config, Checkpointing.scala:9-25;
SURVEY.md section 5, "failure detection"). This module is that machinery:

- :class:`JobSupervisor` runs a ``StreamJob`` over a replayable event
  source, detects failures (any exception escaping event processing) and
  restarts the job from its newest usable checkpoint, resuming the source
  at the exact event offset the snapshot covers -- Flink's restart
  strategy (attempts and delay, ``runtime.selfheal.RestartPolicy``). The
  restored job runs on the failed job's device.
- Without checkpointing, a restart is from scratch at offset 0, Flink's
  behaviour for an uncheckpointed job.
- :class:`FaultInjector` arms deterministic crashes inside spokes for
  recovery tests and drills.

Consistency model: checkpoints are taken between events (``StreamJob.run``
calls ``maybe_save`` after each event), so a restored job's state is
exactly the recorded offset's, and replaying the rest gives exactly-once
state updates. Sinks are not transactional: predictions and responses
emitted between the last checkpoint and the crash are emitted again on
replay (at-least-once sinks, as in Flink without two-phase-commit sinks).
A deterministic poison event crashes every attempt and exhausts
``max_restarts``, also as in Flink.

With the supervised job's flight recorder armed (``job.events``), the
supervisor keeps its own journal (``pid="sup"``): each restore decision is
a ``restore`` event (``_record_restore``), each failed incarnation's ring is
dumped as a ``worker_death`` incident and gathered, each restart is a
``restart`` event, and the run ends with one merged bundle,
``incident-supervised.json`` under the black-box directory
(``_write_bundle``). Each incarnation keeps its own ring (ids from 1); the
bundle merge keeps the rings apart. Unarmed: no recorder object exists.

The JAX supervisor's ``restart_jitter_s``, ``restart_growth`` and
``restart_seed`` options are left out: nothing in the port sets them, and
the restart runs :class:`~omldm_tpu_torch.runtime.selfheal.RestartPolicy`'s
defaults. They return with the fleet supervisor (item 4) if it needs them.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

from omldm_tpu_torch.api.stats import JobStatistics
from omldm_tpu_torch.runtime.events import RESTART, RESTORE, EventJournal, write_bundle
from omldm_tpu_torch.runtime.job import StreamJob
from omldm_tpu_torch.runtime.selfheal import RestartPolicy, classify_exception
from omldm_tpu_torch.utils.backoff import with_backoff

Event = Tuple[str, Any]
# a replayable source: offset -> the remaining events from that position
SourceFactory = Callable[[int], Iterable[Event]]


class InjectedFault(RuntimeError):
    """Raised by :class:`FaultInjector` trip-wires."""


@dataclasses.dataclass
class FailureRecord:
    """One detected job failure (the supervisor's incident log)."""

    offset: int  # events consumed when the failure surfaced
    error: str
    at: float
    restored_from: Optional[str] = None  # checkpoint path, None = fresh
    # failure class (runtime/selfheal.classify_exception): "crash" |
    # "hang" (timeout shape) | "launch" (died before processing a single
    # event of the attempt -- the in-process form of "never heartbeat")
    kind: str = "crash"


def skip_events(events: Iterable[Event], n: int) -> Iterator[Event]:
    """Drop the first ``n`` events of a replay -- turns a from-the-start
    source into a from-offset source for deterministic files/iterables."""
    it = iter(events)
    for _ in range(n):
        try:
            next(it)
        except StopIteration:
            return
    yield from it


def _record_restore(job: StreamJob, cause: str, **fields) -> None:
    """Reason-coded restore-decision event on the (armed) flight
    recorder; a no-op otherwise -- restore decisions must read in the
    incident bundle either way they go."""
    rec = getattr(job, "events", None)
    if rec is not None:
        rec.journal.record(RESTORE, cause, **fields)


def recover_job(
    failed: StreamJob, ckpt_floor: Optional[str] = None
) -> Tuple[StreamJob, Optional[str]]:
    """Build a failed job's next incarnation: restore the newest USABLE
    checkpoint newer than ``ckpt_floor`` (pre-existing snapshots from an
    earlier run are never restored), else a fresh job from the original
    config. A generation that fails to load -- torn pickle, truncated
    file, unreadable disk -- falls back to the previous surviving one
    instead of crashing the supervisor or silently starting fresh while
    older good snapshots exist; each decision is reason-coded onto the
    failed job's flight recorder when armed. Sinks carry over. Returns
    (job, restored_from_path_or_None)."""
    manager = failed.checkpoint_manager
    floor_name = os.path.basename(ckpt_floor) if ckpt_floor else ""
    job: Optional[StreamJob] = None
    path: Optional[str] = None
    if manager is not None:
        for candidate in manager.candidate_paths():
            # names sort chronologically: at/below the floor = a snapshot
            # from an earlier run in a reused directory, never restored
            if floor_name and os.path.basename(candidate) <= floor_name:
                break
            try:
                job = manager.restore(path=candidate)
                path = candidate
                break
            except Exception as exc:
                print(
                    f"warning: checkpoint {os.path.basename(candidate)} "
                    f"failed to restore ({type(exc).__name__}: {exc}); "
                    "falling back to the previous generation",
                    file=sys.stderr,
                )
                _record_restore(
                    failed, "candidate_rejected",
                    snapshot=os.path.basename(candidate),
                    error=f"{type(exc).__name__}: {exc}",
                )
    if job is not None:
        _record_restore(
            failed, "snapshot", snapshot=os.path.basename(path)
        )
    else:
        if manager is not None:
            _record_restore(failed, "no_usable_snapshot")
        job = StreamJob(copy.deepcopy(failed.config), device=failed.device)
    job.set_sinks(
        on_prediction=failed._on_prediction,
        on_response=failed._on_response,
        on_performance=failed._on_performance,
    )
    return job, path


def replayable(make_events: Callable[[], Iterable[Event]]) -> SourceFactory:
    """Lift a zero-argument source constructor (e.g. re-opening the same
    files) into a :data:`SourceFactory` by skipping already-consumed
    events. Valid for deterministic sources: the same constructor must
    yield the same event sequence on every call."""

    def factory(offset: int) -> Iterable[Event]:
        return skip_events(make_events(), offset)

    return factory


class JobSupervisor:
    """Run a job to completion, restarting on failure.

    ``job`` should have checkpointing enabled (``config.checkpointing``)
    for restore-from-snapshot recovery; otherwise every restart replays
    from the beginning with fresh state. Sinks installed on the supervised
    job are carried onto each restarted incarnation.
    """

    def __init__(
        self,
        job: StreamJob,
        source_factory: SourceFactory,
        max_restarts: int = 3,
        restart_delay_s: float = 0.0,
        on_failure: Optional[Callable[[FailureRecord], None]] = None,
    ):
        self.job = job
        self.source_factory = source_factory
        self.max_restarts = max_restarts
        self.restart_delay_s = restart_delay_s
        self.on_failure = on_failure
        self.failures: List[FailureRecord] = []
        # only checkpoints taken DURING this supervised run are restore
        # candidates: a stale snapshot left in a reused checkpoint directory
        # by an earlier job would otherwise be restored silently -- its
        # near-end offset skipping (and masking) almost the whole stream
        manager = job.checkpoint_manager
        self._ckpt_floor = (
            manager.latest_path() if manager is not None else None
        )
        # flight recorder (runtime/events.py): with the supervised job's
        # recorder armed, the supervisor keeps its OWN decision journal
        # (worker-death detection, restart + restore decisions), dumps
        # each failed incarnation's ring before replacing it, and writes
        # one merged incident bundle at the end of the run. Unarmed job
        # (the default) = zero recorder objects here too.
        self.journal = None
        self.bundle_path: Optional[str] = None
        self._gathered: List[List[dict]] = []
        self._ensure_journal()

    def _ensure_journal(self):
        """The supervisor's own decision journal, created as soon as the
        CURRENT job incarnation's recorder exists -- at construction for a
        job-wide spec, or on the first failure/bundle write for a job
        whose plane armed LAZILY (a pipeline events table arriving
        mid-stream)."""
        if self.journal is None:
            rec = getattr(self.job, "events", None)
            if rec is not None:
                self.journal = EventJournal(
                    cap=1024, pid="sup", path=rec.journal.path
                )
        return self.journal

    def run(self, terminate_on_end: bool = True) -> Optional[JobStatistics]:
        def attempt() -> Optional[JobStatistics]:
            job = self.job
            start_offset = job.events_processed
            try:
                return job.run(
                    self.source_factory(job.events_processed),
                    terminate_on_end=terminate_on_end,
                )
            except Exception as exc:  # any escape is a detected job failure
                self.failures.append(FailureRecord(
                    offset=job.events_processed,
                    error=f"{type(exc).__name__}: {exc}",
                    at=time.time(),
                    # classified like the fleet's: an attempt that died
                    # before processing a single event is the launch class
                    kind=classify_exception(
                        exc, progressed=job.events_processed > start_offset
                    ),
                ))
                raise

        def on_retry(exc: Exception, next_attempt: int) -> None:
            record = self.failures[-1]
            self.job = self._recover(self.job, record)
            if self.on_failure is not None:
                self.on_failure(record)

        # the shared RestartPolicy (runtime/selfheal.py) with its default
        # growth and no jitter; built at run() time so pre-run mutation of
        # the two attributes keeps working
        restart_policy = RestartPolicy(
            max_restarts=self.max_restarts,
            base_delay_s=self.restart_delay_s,
        )
        try:
            return with_backoff(
                attempt,
                policy=restart_policy.backoff(),
                retry_on=(Exception,),
                on_retry=on_retry,
                rng=restart_policy.rng(),
            )
        finally:
            # one merged incident bundle per supervised run: every failed
            # incarnation's gathered ring + the final job's ring + the
            # supervisor's own decision log, merge-ordered on the
            # transport stamps (runtime/events.py)
            self._write_bundle()

    def _write_bundle(self) -> None:
        rec = getattr(self.job, "events", None)
        if rec is None or self._ensure_journal() is None:
            return
        streams = list(self._gathered)
        if rec.journal.events:
            streams.append(rec.journal.tail())
        if self.journal.events:
            streams.append(self.journal.tail())
        if not streams or not rec.journal.path:
            return
        self.bundle_path = write_bundle(
            os.path.join(rec.journal.path, "incident-supervised.json"),
            streams,
            meta={
                "reason": "supervised_run",
                "restarts": len(self.failures),
            },
        )

    def _recover(self, failed: StreamJob, record: FailureRecord) -> StreamJob:
        """Build the next incarnation: restore the latest checkpoint when
        one exists, else a fresh job from the original config (offset 0)."""
        rec = getattr(failed, "events", None)
        if rec is not None:
            # the failed incarnation's ring is the worker-death incident:
            # dump it (black box) and gather it (bundle) before the
            # replacement job's journal takes over
            rec.journal.incident("worker_death", error=record.error)
            self._gathered.append(rec.journal.tail())
        job, record.restored_from = recover_job(failed, self._ckpt_floor)
        if self._ensure_journal() is not None:
            self.journal.record(
                RESTART, "worker_failure", error=record.error,
                offset=record.offset, attempt=len(self.failures),
                restored_from=record.restored_from,
                failure_kind=record.kind,
            )
        return job


class FaultInjector:
    """Deterministic crash injection for recovery tests and drills.

    ``arm(job, worker_id, after_records)`` trips an :class:`InjectedFault`
    out of the target spoke once it has handled ``after_records`` more
    records (per-record and packed rows both count). One-shot by default --
    the fault models a transient crash: after firing once it never fires
    again, including on job incarnations built by recovery."""

    def __init__(self, one_shot: bool = True):
        self.one_shot = one_shot
        self.fired = 0
        self._armed = True

    def arm(self, job: StreamJob, worker_id: int, after_records: int) -> None:
        spoke = job.spokes[worker_id]
        remaining = [after_records]
        orig_data, orig_packed = spoke.handle_data, spoke.handle_packed

        def _trip(rows: int) -> None:
            if not self._armed:
                return
            remaining[0] -= rows
            if remaining[0] <= 0:
                self.fired += 1
                if self.one_shot:
                    self._armed = False
                raise InjectedFault(
                    f"injected crash in worker {worker_id}"
                )

        def handle_data(inst):
            _trip(1)
            return orig_data(inst)

        def handle_packed(x, y, op):
            _trip(int(x.shape[0]))
            return orig_packed(x, y, op)

        spoke.handle_data = handle_data
        spoke.handle_packed = handle_packed
