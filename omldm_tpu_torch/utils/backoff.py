"""Shared retry/backoff: the one implementation behind every retry loop.

Counterpart of ``omldm_tpu/utils/backoff.py`` (a copy; the port never
imports the JAX package). The reference inherits its retry behaviour from
the substrate: Flink's fixed-delay restart strategy
(``RestartStrategies.fixedDelayRestart(attempts, delay)``, Job.scala:14)
and the Kafka clients' internal metadata and send retries. In the port the
supervised restart (``runtime.recovery.JobSupervisor``, through
``runtime.selfheal.RestartPolicy``), the Kafka route's restart loop
(``__main__._run_kafka``), and the Kafka adapters' connect, metadata and
send retries (``runtime.kafka_io``) all route through :func:`with_backoff`,
so they share one policy vocabulary (attempts, base delay, growth, jitter,
deadline) and one set of CLI knobs (``--retryAttempts`` /
``--retryBaseDelayMs`` / ``--retryGrowth`` / ``--retryJitterMs`` /
``--retryTimeoutMs``, and the ``--sendRetry*`` twins; see
``BackoffPolicy.from_flags``).

Two retry triggers are supported:

- ``retry_on``: exception classes that mark a transient failure (broker
  connect refused, producer send timeout);
- ``accept``: a predicate on the RETURN VALUE (``partitions_for_topic``
  transiently returns ``None`` on a fresh client without raising).

Exhausting attempts re-raises the last exception, or returns the last
(unaccepted) value -- callers keep their "give up and degrade" paths.
``growth=1.0`` is Flink's fixed delay; ``jitter`` desynchronizes fleets of
processes retrying against the same broker.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Tuple, Type


def seeded_rng(seed: int, name: str = "backoff") -> Callable[[], float]:
    """A DETERMINISTIC uniform-[0,1) stream for backoff jitter: same
    ``(seed, name)`` => same delay schedule, every run, every machine
    (crc32, not the per-process-salted ``hash()`` -- the chaos-channel
    seeding rule). Jitter desynchronizes a fleet of retriers; making it
    deterministic keeps supervised-restart timing replayable in tests and
    incident reconstructions."""
    return random.Random(
        (int(seed) ^ zlib.crc32(name.encode())) & 0x7FFFFFFF
    ).random


@dataclass(frozen=True)
class BackoffPolicy:
    """One retry policy: ``attempts`` total calls, delay before retry k
    (1-based) of ``base_delay * growth**(k-1) + U(0, jitter)`` seconds,
    bounded by an optional overall ``timeout`` deadline."""

    attempts: int = 5
    base_delay: float = 0.2
    growth: float = 1.0
    jitter: float = 0.0
    timeout: Optional[float] = None

    def delay(self, retry_index: int, rng: Callable[[], float]) -> float:
        d = self.base_delay * (self.growth ** max(retry_index - 1, 0))
        if self.jitter > 0:
            d += rng() * self.jitter
        return max(d, 0.0)

    @classmethod
    def from_flags(
        cls, flags: Mapping[str, str], prefix: str = "retry", **defaults: Any
    ) -> "BackoffPolicy":
        """Build a policy from CLI flags (``--retryAttempts 5``,
        ``--retryBaseDelayMs 200``, ``--retryJitterMs 50``,
        ``--retryTimeoutMs 30000``); ``defaults`` override the dataclass
        defaults for knobs the flags leave unset."""
        base = cls(**defaults)
        ms = lambda key, cur: (  # noqa: E731 -- tiny local accessor
            float(flags[key]) / 1000.0 if key in flags else cur
        )
        return cls(
            attempts=int(flags.get(f"{prefix}Attempts", base.attempts)),
            base_delay=ms(f"{prefix}BaseDelayMs", base.base_delay),
            growth=float(flags.get(f"{prefix}Growth", base.growth)),
            jitter=ms(f"{prefix}JitterMs", base.jitter),
            timeout=ms(f"{prefix}TimeoutMs", base.timeout),
        )


def with_backoff(
    fn: Callable[[], Any],
    *,
    policy: BackoffPolicy,
    retry_on: Tuple[Type[BaseException], ...] = (),
    accept: Optional[Callable[[Any], bool]] = None,
    on_retry: Optional[Callable[[Optional[BaseException], int], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Callable[[], float] = random.random,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Call ``fn`` up to ``policy.attempts`` times with backoff between calls.

    A call FAILS when it raises one of ``retry_on``, or when ``accept`` is
    given and ``accept(result)`` is falsy. On failure, if attempt budget
    and the policy's ``timeout`` deadline both allow, ``on_retry(exc_or_None,
    next_attempt_index)`` is invoked (restart bookkeeping hook -- the
    supervisors rebuild job state here), the computed delay elapses, and
    ``fn`` runs again.

    Exhaustion semantics match the loops this replaces: the last exception
    re-raises; an unaccepted last RESULT is returned as-is (callers keep
    their degrade-and-warn paths). ``timeout`` bounds the whole affair:
    once the deadline passes, no further retry starts.
    """
    attempts, timeout = policy.attempts, policy.timeout
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    deadline = None if timeout is None else clock() + timeout
    result: Any = None
    for attempt in range(1, attempts + 1):
        exc: Optional[BaseException] = None
        try:
            result = fn()
            if accept is None or accept(result):
                return result
        except retry_on as caught:  # noqa: B030 -- tuple of exc types
            exc = caught
        delay = policy.delay(attempt, rng)
        # a retry that would only WAKE past the deadline never starts
        last = attempt == attempts or (
            deadline is not None and clock() + delay >= deadline
        )
        if last:
            if exc is not None:
                raise exc
            return result
        if on_retry is not None:
            on_retry(exc, attempt + 1)
        if delay > 0:
            sleep(delay)
    return result  # unreachable; loop always returns/raises on the last pass
