"""The in-process chaos channel: seeded faults on the hub<->spoke bridge.

Counterpart of the chaos half of ``omldm_tpu/runtime/supervisor.py``. The
reference's psMessages edge is a Kafka topic (Job.scala:76-87): at least
once, so a message may be duplicated, delayed, reordered or lost.
:class:`ChaosChannel` makes the in-process bridge misbehave that way, and
corrupts payloads on request (a NaN in a shipped parameter vector, or a
1e12 norm explosion), each fate drawn from a seeded RNG, so a schedule is
a pure function of ``(seed, name, call sequence)``: the JAX package's, call
for call (:func:`_chaos_rng` is its ``numpy.random.RandomState`` seeded by
crc32). ``StreamJob`` wraps both directions of its bridge in one when
``JobConfig.chaos`` or ``OMLDM_CHAOS`` holds a spec
(:func:`parse_chaos_spec`), and every pipeline's reliable channel arms.

The spec's burst keys arm :class:`BurstInjector`, the overload plane's
seeded hot-tenant flood: the job feeds it every forecasting record and
handles the tenant-addressed copies it returns.

:class:`ChaosConsumer` makes a Kafka-style consumer misbehave the way a
broker does across restarts and rebalances (drop, duplicate, reorder, and
poisoned record values), on the same seeded schedule; the Kafka route arms
it with ``OMLDM_CHAOS_KAFKA`` (:func:`maybe_chaos_consumer`).

The rest of the JAX module -- the fleet supervisor and autoscaler and the
process fault injector -- arrives with the distributed fleet (ROADMAP
queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import zlib
from typing import Dict, List, Optional

import numpy as np

from omldm_tpu_torch.runtime.codec import EncodedLeaf

_CHAOS_PARAMS = ("drop", "dup", "reorder", "delay")
# corruption (poison) fault classes -- distinct from the loss classes
# above: the message ARRIVES, but its content is hostile. ``nan`` plants a
# NaN in a shipped parameter vector, ``explode`` scales it past any sane
# norm, ``poison`` (record streams only) mutates a source record into
# malformed/non-finite input. These drive the model-integrity guard's
# detection/rollback/quarantine paths the way drop/dup drive the reliable
# channel. Probability draws happen ONLY when a corruption class is armed,
# so pre-existing specs keep their exact seeded schedules.
_CHAOS_CORRUPT = ("nan", "explode", "poison")

# burst / hot-tenant injector keys (channel-wide, not per-direction): the
# overload-control plane's fault injectors. ``burst=K`` amplifies every
# forecasting record inside the window [burstFrom, burstFrom+burstLen)
# (counted in FORECAST records) into K copies, the K-1 extras
# tenant-addressed at ``hotTenant`` -- a deterministic traffic flood at
# one tenant that the fair-share admission must absorb without degrading
# its gang siblings.
_CHAOS_BURST = ("burst", "burstFrom", "burstLen", "hotTenant")


def parse_chaos_spec(spec: Optional[str]) -> Optional[Dict]:
    """Parse a chaos spec string into ``{seed, window, up: {...}, down:
    {...}, burst...}``.

    Format: comma-separated ``key=value`` pairs. ``seed`` and ``window``
    are channel-wide; ``drop``/``dup``/``reorder``/``delay`` (loss
    classes) and ``nan``/``explode``/``poison`` (corruption classes) are
    probabilities applied to BOTH directions unless prefixed
    (``up.drop=0.1`` hits only worker->hub, ``down.dup=0.05`` only
    hub->worker); ``burst``/``burstFrom``/``burstLen``/``hotTenant`` arm
    the hot-tenant burst injector (channel-wide ints). Returns None for
    an empty/None spec; raises ValueError on unknown keys so a typo'd
    flag fails loudly instead of running fault-free."""
    if not spec:
        return None
    base = {k: 0.0 for k in _CHAOS_PARAMS + _CHAOS_CORRUPT}
    out: Dict = {"seed": 0, "window": 4, "up": dict(base), "down": dict(base),
                 "burst": 0, "burstFrom": 0, "burstLen": 1 << 31,
                 "hotTenant": 0}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        value = value.strip() or "0"
        if key in ("seed", "window") or key in _CHAOS_BURST:
            out[key] = int(float(value))
        elif "." in key:
            direction, _, param = key.partition(".")
            if direction not in ("up", "down") or param not in (
                _CHAOS_PARAMS + _CHAOS_CORRUPT
            ):
                raise ValueError(f"unknown chaos key {key!r}")
            out[direction][param] = float(value)
        elif key in _CHAOS_PARAMS + _CHAOS_CORRUPT:
            out["up"][key] = out["down"][key] = float(value)
        else:
            raise ValueError(f"unknown chaos key {key!r}")
    return out


def _corrupt_payload(payload, mode: str, rng):
    """A corrupted COPY of a protocol payload, or None when the payload
    carries nothing corruptible (control votes, NACKs, raw-data forwards --
    corrupting those would test the wrong layer). ``nan`` plants a NaN at
    a seeded position of the shipped parameter vector; ``explode`` scales
    the vector by 1e12, far past any configured guard norm limit.
    Codec-encoded params (``EncodedLeaf``) corrupt too -- the on-wire form
    is exactly what a real fault would hit, and skipping it would make
    ``nan``/``explode`` silently inert on codec-armed pipelines. The
    original payload object is never mutated (the sender may hold
    references)."""

    def corrupt_vec(vec):
        vec = vec.copy()
        flat = vec.ravel()
        if mode == "nan":
            flat[int(rng.randint(flat.size))] = np.nan
        else:  # explode
            flat *= np.float32(1e12)
        return vec

    def corrupt_leaf(leaf):
        if leaf.kind == "fp16":
            data = leaf.data.copy()
            if mode == "nan":
                data.ravel()[int(rng.randint(data.size))] = np.float16(np.nan)
            else:  # fp16 max is 65504: a big scale overflows to inf
                data = data * np.float16(1e4) * np.float16(1e4)
            meta = leaf.meta
        elif leaf.kind == "int8":
            # uint8 codes can't hold a NaN; corrupt the affine meta so the
            # DECODE goes non-finite/exploded -- the receiver-side shape of
            # the same fault
            data = leaf.data
            scale, zero = leaf.meta
            meta = (
                (np.float32(np.nan), zero) if mode == "nan"
                else (np.float32(1e12), zero)
            )
        elif leaf.kind == "topk":
            idx, val = leaf.data
            if val.size == 0:
                return None
            data = (idx, corrupt_vec(val))
            meta = leaf.meta
        else:
            return None
        return EncodedLeaf(
            leaf.kind, data, meta, leaf.shape, leaf.dtype, leaf.stream,
            leaf.seq,
        )

    def corrupt_any(value):
        if (
            isinstance(value, np.ndarray)
            and value.dtype.kind == "f"
            and value.size
        ):
            return corrupt_vec(value)
        if isinstance(value, EncodedLeaf):
            return corrupt_leaf(value)
        return None

    corrupted = corrupt_any(payload)
    if corrupted is not None:
        return corrupted
    if isinstance(payload, dict):
        params = corrupt_any(payload.get("params"))
        if params is not None:
            out = dict(payload)
            out["params"] = params
            return out
    return None


def _chaos_rng(seed: int, name: str):
    # stable per-channel stream: python's hash() is salted per process,
    # crc32 is not -- same (seed, name) => same schedule, everywhere
    return np.random.RandomState(
        (int(seed) ^ zlib.crc32(name.encode())) & 0x7FFFFFFF
    )


class ChaosChannel:
    """Seeded lossy wrapper around a deliver callable (the in-process
    hub<->spoke bridge).

    Every :meth:`send` draws an independent fate per fault class from the
    channel's private RNG, so the drop/dup/reorder/delay schedule is a pure
    function of ``(seed, name, call sequence)`` -- deterministic, replayable,
    assertable. Held messages (reordered / delayed / duplicate copies)
    release after 1..window subsequent sends pass, preserving bounded
    reordering. ``quiesce()`` ends the fault window: held traffic flushes
    and later sends pass through untouched (stream-end must not eat final
    state pushes)."""

    def __init__(
        self,
        deliver,
        *,
        seed: int = 0,
        drop: float = 0.0,
        dup: float = 0.0,
        reorder: float = 0.0,
        delay: float = 0.0,
        nan: float = 0.0,
        explode: float = 0.0,
        poison: float = 0.0,  # record-stream class; inert on the bridge
        window: int = 4,
        name: str = "chan",
    ):
        self._deliver = deliver
        self._rng = _chaos_rng(seed, name)
        self.drop = float(drop)
        self.dup = float(dup)
        self.reorder = float(reorder)
        self.delay = float(delay)
        # payload corruption, the faults the model-integrity guard meets:
        # the message still arrives, but its parameter vector carries a
        # seeded NaN or a 1e12 norm explosion. Fate draws happen ONLY when
        # a corruption class is armed, so loss-only specs keep their exact
        # seeded schedules.
        self.nan = float(nan)
        self.explode = float(explode)
        self.window = max(int(window), 1)
        self.name = name
        self.active = True
        self._held: List[list] = []  # [countdown, args]
        self.sent = 0
        self.delivered = 0
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.corrupted = 0

    @classmethod
    def from_spec(cls, deliver, spec: Dict, direction: str, name: str = ""):
        return cls(
            deliver,
            seed=spec["seed"],
            window=spec["window"],
            name=name or direction,
            **spec[direction],
        )

    def send(self, *args) -> None:
        self.sent += 1
        if not self.active:
            self.delivered += 1
            self._deliver(*args)
            return
        if self.nan > 0.0 or self.explode > 0.0:
            # (net, hub, worker, op, payload, seq) on both directions:
            # payload rides at index 4
            u_nan, u_explode = self._rng.random_sample(2)
            mode = (
                "nan" if u_nan < self.nan
                else "explode" if u_explode < self.explode
                else None
            )
            if mode is not None and len(args) > 4:
                corrupted = _corrupt_payload(args[4], mode, self._rng)
                if corrupted is not None:
                    args = args[:4] + (corrupted,) + args[5:]
                    self.corrupted += 1
        u_drop, u_dup, u_reorder, u_delay = self._rng.random_sample(4)
        if u_drop < self.drop:
            self.dropped += 1
        elif u_reorder < self.reorder or u_delay < self.delay:
            self._held.append([int(self._rng.randint(1, self.window + 1)), args])
            self.reordered += 1
        else:
            self.delivered += 1
            self._deliver(*args)
        if u_dup < self.dup:
            # the duplicate copy arrives LATE (held like a reordered
            # message): receivers must survive out-of-order duplicates,
            # not just back-to-back ones
            self._held.append([int(self._rng.randint(1, self.window + 1)), args])
            self.duplicated += 1
        self._tick()

    def _tick(self) -> None:
        for h in self._held:
            h[0] -= 1
        # pop-one-at-a-time: delivering may recurse into send() and mutate
        # the queue (in-process routing is synchronous)
        while True:
            due = next((h for h in self._held if h[0] <= 0), None)
            if due is None:
                return
            self._held.remove(due)
            self.delivered += 1
            self._deliver(*due[1])

    def flush(self) -> None:
        """Deliver everything held, in hold order."""
        while self._held:
            _, args = self._held.pop(0)
            self.delivered += 1
            self._deliver(*args)

    def quiesce(self) -> None:
        """End the fault window (stream end / termination probe)."""
        self.active = False
        self.flush()

    def counters(self) -> Dict[str, int]:
        return {
            "sent": self.sent,
            "delivered": self.delivered,
            "dropped": self.dropped,
            "duplicated": self.duplicated,
            "reordered": self.reordered,
            "corrupted": self.corrupted,
        }


class BurstInjector:
    """Seeded hot-tenant burst injector (the overload plane's fault
    injector): inside a window counted in forecasting records, every
    forecast gains ``factor - 1`` TENANT-ADDRESSED copies
    (``metadata.tenant``) that flood one pipeline.

    The schedule is a pure function of the spec and the forecast sequence,
    so a spec replays the same flood and, downstream, the same shed and
    throttle schedule. The seed keys the injector's own RNG stream
    (``_chaos_rng``, the JAX package's draw for draw) for stochastic
    classes; the window itself draws nothing."""

    def __init__(self, factor: int, start: int = 0, length: int = 1 << 31,
                 hot_tenant: int = 0, seed: int = 0):
        self.factor = int(factor)
        self.start = int(start)
        self.length = int(length)
        self.hot_tenant = int(hot_tenant)
        self._rng = _chaos_rng(seed, "burst")
        self.forecasts_seen = 0
        self.injected = 0

    @classmethod
    def from_spec(cls, spec: Optional[Dict]) -> Optional["BurstInjector"]:
        """The injector a parsed chaos spec arms, or None (no ``burst`` of
        at least 2)."""
        if not spec or int(spec.get("burst", 0)) < 2:
            return None
        return cls(spec["burst"], spec.get("burstFrom", 0),
                   spec.get("burstLen", 1 << 31), spec.get("hotTenant", 0),
                   seed=spec.get("seed", 0))

    def clones(self, inst):
        """The extra copies of ``inst`` to inject: empty outside the window
        and for a training record. Copies share the feature payload
        (read-only) and carry the hot tenant's address."""
        from omldm_tpu_torch.api.data import FORECASTING

        if inst.operation != FORECASTING:
            return ()
        i = self.forecasts_seen
        self.forecasts_seen += 1
        if not (self.start <= i < self.start + self.length):
            return ()
        clone = dataclasses.replace(inst, metadata={"tenant": self.hot_tenant, "burst": True})
        k = self.factor - 1
        self.injected += k
        return [clone] * k


# poison-record templates: malformed or non-finite record values a
# hostile producer could publish (ChaosConsumer's ``poison`` class)
_POISON_RECORDS = (
    '{"numericalFeatures": [NaN, 1.0], "target": 1.0}',
    '{"numericalFeatures": [1e999, 0.5], "target": 0.0}',
    '{"numericalFeatures": [1.0, 2.0], "target": Infinity}',
    '{"numericalFeatures": [1.0, 2.0], "target": ',
)


class _PoisonedRecord:
    """Minimal ConsumerRecord stand-in carrying a poisoned value."""

    __slots__ = ("topic", "value", "partition", "offset")

    def __init__(self, rec, value):
        self.topic = rec.topic
        self.value = value
        self.partition = getattr(rec, "partition", 0)
        self.offset = getattr(rec, "offset", None)


class ChaosConsumer:
    """Seeded lossy wrapper around a Kafka-style consumer iterator.

    Applies drop/dup/reorder to the RECORD stream (the broker-side faults
    of an at-least-once source: redelivery after rebalance, replayed
    batches after restart). Drops model transient loss before commit --
    offsets of dropped records are never recorded, so a checkpoint/restore
    cycle re-reads them: at-least-once is preserved, exactly what the
    reference's Kafka sources guarantee. All non-iterator attributes
    (assign/seek/position/...) delegate to the wrapped consumer."""

    def __init__(self, inner, *, seed: int = 0, drop: float = 0.0,
                 dup: float = 0.0, reorder: float = 0.0, delay: float = 0.0,
                 poison: float = 0.0, nan: float = 0.0, explode: float = 0.0,
                 window: int = 4, name: str = "kafka",
                 poison_exempt_topics=()):
        self._inner = inner
        self._rng = _chaos_rng(seed, name)
        self._drop = float(drop)
        self._dup = float(dup)
        self._reorder = float(reorder + delay)
        # poison-record injection: with probability ``poison`` a consumed
        # record's VALUE is replaced by a seeded malformed/non-finite
        # template (_POISON_RECORDS) -- the hostile-producer fault the
        # dead-letter quarantine + isValid boundary must absorb without
        # crashing or training on it. ``nan``/``explode`` are channel
        # (parameter-payload) classes and are inert on a record stream --
        # accepted so one spec string can arm both layers.
        self._poison = float(poison)
        # topics poison must never touch (the CONTROL stream): a poisoned
        # record is consumed -- its offset advances -- so unlike the drop
        # class it is not replayed later. Destroying a Create/Delete
        # would silently change the job topology forever, which is a
        # different fault class than hostile data records. The fate draw
        # still happens for exempt topics so the corruption schedule of
        # the data streams does not depend on the topic mix.
        self._poison_exempt = frozenset(poison_exempt_topics)
        self._window = max(int(window), 1)
        self._held: List[list] = []  # [countdown, record]
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.poisoned = 0

    def __iter__(self):
        return self

    def _due(self):
        due = next((h for h in self._held if h[0] <= 0), None)
        if due is not None:
            self._held.remove(due)
        return due

    def __next__(self):
        while True:
            due = self._due()
            if due is not None:
                return due[1]
            try:
                rec = next(self._inner)
            except StopIteration:
                # idle window: release held records (nothing left for them
                # to reorder past) before going idle ourselves
                if self._held:
                    return self._held.pop(0)[1]
                raise
            for h in self._held:
                h[0] -= 1
            if self._poison > 0.0:
                u_poison = self._rng.random_sample()
                hit = u_poison < self._poison
                if hit:
                    value = _POISON_RECORDS[
                        int(self._rng.randint(len(_POISON_RECORDS)))
                    ]
                if hit and getattr(rec, "topic", None) not in self._poison_exempt:
                    rec = _PoisonedRecord(rec, value)
                    self.poisoned += 1
            u_drop, u_dup, u_reorder = self._rng.random_sample(3)
            if u_dup < self._dup:
                self._held.append(
                    [int(self._rng.randint(1, self._window + 1)), rec]
                )
                self.duplicated += 1
            if u_drop < self._drop:
                self.dropped += 1
                continue
            if u_reorder < self._reorder:
                self._held.append(
                    [int(self._rng.randint(1, self._window + 1)), rec]
                )
                self.reordered += 1
                continue
            return rec

    def __getattr__(self, name):
        return getattr(self._inner, name)


def maybe_chaos_consumer(
    consumer,
    env_var: str = "OMLDM_CHAOS_KAFKA",
    name: str = "kafka",
    poison_exempt_topics=(),
):
    """Wrap ``consumer`` in a :class:`ChaosConsumer` when broker chaos is
    armed by the env var; otherwise return it untouched.
    ``poison_exempt_topics`` names topics the poison class must never
    mutate -- callers pass their request/control topics."""
    spec = parse_chaos_spec(os.environ.get(env_var, ""))
    if spec is None:
        return consumer
    params = spec["up"]
    if not any(params.values()):
        return consumer
    print(
        f"[chaos] kafka consumer chaos armed: seed={spec['seed']} {params}",
        file=sys.stderr,
        flush=True,
    )
    return ChaosConsumer(
        consumer, seed=spec["seed"], window=spec["window"], name=name,
        poison_exempt_topics=poison_exempt_topics, **params
    )


__all__ = [
    "BurstInjector",
    "ChaosChannel",
    "ChaosConsumer",
    "maybe_chaos_consumer",
    "parse_chaos_spec",
]
