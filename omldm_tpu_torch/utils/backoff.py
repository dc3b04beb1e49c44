"""Shared retry/backoff: the one implementation behind every retry loop.

Counterpart of ``omldm_tpu/utils/backoff.py`` (a copy; the port never
imports the JAX package). The reference inherits its retry behaviour from
the substrate: Flink's fixed-delay restart strategy
(``RestartStrategies.fixedDelayRestart(attempts, delay)``, Job.scala:14).
In the port the supervised restart (``runtime.recovery.JobSupervisor``,
through ``runtime.selfheal.RestartPolicy``) is the loop that routes
through :func:`with_backoff`; the policy vocabulary (attempts, base delay,
growth, jitter) is the JAX package's.

A call is retried when it raises one of ``retry_on``; exhausting attempts
re-raises the last exception. ``growth=1.0`` is Flink's fixed delay;
``jitter`` desynchronizes fleets of processes retrying against the same
resource.

Left out of the copy until the multi-process fleet (ROADMAP queue 1,
item 4) calls them: ``BackoffPolicy.from_flags`` (the ``--retry*`` CLI
knobs), the policy's ``timeout`` deadline, and ``with_backoff``'s
``accept`` (retry on the return value), ``timeout`` and ``clock``.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type


def seeded_rng(seed: int, name: str = "backoff") -> Callable[[], float]:
    """A DETERMINISTIC uniform-[0,1) stream for backoff jitter: same
    ``(seed, name)`` => same delay schedule, every run, every machine
    (crc32, not the per-process-salted ``hash()`` — the chaos-channel
    seeding rule). Jitter desynchronizes a fleet of retriers; making it
    deterministic keeps supervised-restart timing replayable in tests and
    incident reconstructions."""
    return random.Random(
        (int(seed) ^ zlib.crc32(name.encode())) & 0x7FFFFFFF
    ).random


@dataclass(frozen=True)
class BackoffPolicy:
    """One retry policy: ``attempts`` total calls, delay before retry k
    (1-based) of ``base_delay * growth**(k-1) + U(0, jitter)`` seconds."""

    attempts: int = 5
    base_delay: float = 0.2
    growth: float = 1.0
    jitter: float = 0.0

    def delay(self, retry_index: int, rng: Callable[[], float]) -> float:
        d = self.base_delay * (self.growth ** max(retry_index - 1, 0))
        if self.jitter > 0:
            d += rng() * self.jitter
        return max(d, 0.0)


def with_backoff(
    fn: Callable[[], Any],
    *,
    policy: BackoffPolicy,
    retry_on: Tuple[Type[BaseException], ...] = (),
    on_retry: Optional[Callable[[BaseException, int], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Callable[[], float] = random.random,
) -> Any:
    """Call ``fn`` up to ``policy.attempts`` times with backoff between calls.

    A call FAILS when it raises one of ``retry_on``. On failure, if the
    attempt budget allows, ``on_retry(exc, next_attempt_index)`` is invoked
    (restart bookkeeping hook -- the supervisor rebuilds job state here),
    the computed delay elapses, and ``fn`` runs again. The last exception
    re-raises.
    """
    attempts = policy.attempts
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as exc:  # noqa: B030 -- tuple of exc types
            if attempt == attempts:
                raise
            if on_retry is not None:
                on_retry(exc, attempt + 1)
            delay = policy.delay(attempt, rng)
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable: the last attempt returns or raises")
