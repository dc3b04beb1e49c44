"""Failure classification and the restart policy of supervised recovery.

Counterpart of the part of ``omldm_tpu/runtime/selfheal.py`` that the
in-process supervisor (``runtime.recovery.JobSupervisor``) uses. The
reference's failure story is crash-stop: ``JobTerminator.scala:6-10``
throws and Flink restarts the whole job with a fixed-delay strategy
(Job.scala:14).

- :func:`classify_exception` -- the failure taxonomy: ``crash`` (a failure
  after the attempt had made progress), ``hang`` (a timeout shape) and
  ``launch`` (an attempt that failed before processing a single event).
- :func:`classify_failure` -- the same taxonomy for a process, from its exit
  code and heartbeat (the sharded ingest plane's parser workers,
  ``runtime.ingest_shard``), with ``HANG_EXIT``, the exit code a wedged
  slot's watchdog uses.
- :class:`RestartPolicy` -- exponential backoff (Flink's fixed delay is
  ``growth=1``) with deterministic, seeded jitter.

The rest of the fleet's half of the JAX module -- ``SelfHealPolicy``
(slot strikes, shrink-to-survivors, probed re-expansion), ``HangWatchdog``,
``kill_escalate`` and ``sigstop_self`` -- waits for the multi-process
fleet (ROADMAP queue 1, item 4), which is their only caller.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from omldm_tpu_torch.utils.backoff import BackoffPolicy, seeded_rng

# --- failure taxonomy -------------------------------------------------------

CRASH = "crash"    # a failure after the attempt had proven itself alive
HANG = "hang"      # heartbeat silence / wedged in a collective
LAUNCH = "launch"  # died without ever making progress: never came up

# exit code a worker's hang watchdog uses: "my peer is dead or wedged; I am
# exiting instead of blocking in this collective forever". Distinct from
# RESCALE_EXIT (17) and the fault injector's crash code (3), so a
# supervisor blames the WEDGED slot, not the honest survivor.
HANG_EXIT = 19


def classify_failure(
    returncode: Optional[int] = None,
    heartbeat_silent: bool = False,
    ever_beat: Optional[bool] = None,
) -> str:
    """One failed process's failure class. ``ever_beat`` is None when the
    heartbeat channel is unarmed (launch failures are then
    indistinguishable from crashes and classify as ``crash``)."""
    if heartbeat_silent or returncode == HANG_EXIT:
        return HANG
    if ever_beat is False:
        return LAUNCH
    return CRASH


def classify_exception(exc: BaseException, progressed: bool = True) -> str:
    """The in-process twin (``recovery.JobSupervisor``): an attempt that
    failed before processing a single event is the launch class; a timeout
    shape is a hang; everything else is a crash."""
    if isinstance(exc, TimeoutError):
        return HANG
    if not progressed:
        return LAUNCH
    return CRASH


# --- restart policy ---------------------------------------------------------


@dataclasses.dataclass
class RestartPolicy:
    """``max_restarts`` relaunches with exponential backoff
    (``base_delay_s * growth**k``) and deterministic jitter (``U(0,
    jitter_s)`` from a seeded stream: same seed, same delays, every run).
    ``growth=1.0`` is the reference's fixedDelayRestart.

    ``seed=None`` derives the stream from the process id, so co-hosted
    supervisors still desynchronize; an explicit seed pins the schedule
    for replays and tests."""

    max_restarts: int = 3
    base_delay_s: float = 0.0
    growth: float = 2.0
    jitter_s: float = 0.0
    seed: Optional[int] = None

    def backoff(self) -> BackoffPolicy:
        return BackoffPolicy(
            attempts=self.max_restarts + 1,
            base_delay=self.base_delay_s,
            growth=self.growth,
            jitter=self.jitter_s,
        )

    def rng(self) -> Callable[[], float]:
        seed = self.seed if self.seed is not None else os.getpid()
        return seeded_rng(seed, "restart")
