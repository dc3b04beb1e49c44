"""The runtime's injectable clocks (the port's copy of the part of the JAX
package's ``utils/clock.py`` that the serving plane, the flight recorder
and the fleet's hang watchdog use).

:data:`PERF` is the system clock the serving plane's ``maxDelayMs``
deadline and latency accounting default to; :data:`WALL` stamps the flight
recorder's events (timestamps that cross processes); :data:`MONOTONIC`
times the hang watchdog's deadlines (durations that must survive a step of
the system clock). :class:`ManualClock` is the
deterministic test double: a callable a plane accepts wherever a clock is
injectable, moved forward with ``advance()`` instead of sleeping.
"""

from __future__ import annotations

import time
from typing import Callable

Clock = Callable[[], float]

# sub-ms latency measurement; sites reference the name instead of binding
# time.perf_counter, so a test that patches it moves every default clock
PERF: Clock = time.perf_counter
WALL: Clock = time.time
MONOTONIC: Clock = time.monotonic


class ManualClock:
    """A deterministic, manually advanced clock: starts at ``start`` and
    moves only when told to, so a test crosses a deadline by ``advance``
    instead of sleeping, and two replays read identical timestamps."""

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds (a negative dt is refused:
        no consumer tolerates a clock running backwards)."""
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards ({dt})")
        self._now += float(dt)
        return self._now
