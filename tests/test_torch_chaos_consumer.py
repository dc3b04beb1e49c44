"""The port's ChaosConsumer (omldm_tpu_torch/runtime/supervisor.py) against
the JAX package's on the same inner record lists and seeds.

A consumer is drained the way the polling loop drains it: ``next`` until
StopIteration (an idle window), then once more after every idle window,
until two idle windows come back to back. The delivered sequence -- each
record's topic, partition, offset and value, poisoned values included --
and the counters (dropped, duplicated, reordered, poisoned) must be equal,
record for record: the fates come from the same crc32-seeded
``numpy.random.RandomState`` draws, so the tolerance is zero. Request
topics are exempt from poison in both."""

import dataclasses
import json

import pytest

import omldm_tpu.runtime.supervisor as jax_sup
import omldm_tpu_torch.runtime.supervisor as port_sup


@dataclasses.dataclass
class Record:
    topic: str
    value: bytes
    partition: int = 0
    offset: int = 0


class WindowedConsumer:
    """Poll-style fake: StopIteration between windows, resumable."""

    def __init__(self, windows):
        self._flat = []
        for w in windows:
            self._flat.extend(w)
            self._flat.append(None)

    def __next__(self):
        if not self._flat:
            raise StopIteration
        item = self._flat.pop(0)
        if item is None:
            raise StopIteration
        return item

    def position(self, tp):  # a delegated, non-iterator attribute
        return 42


def records(n=400, windows=5, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    out = [Record("requests", json.dumps({"id": 0, "request": "Create"}).encode(), 0, 0)]
    offsets = {}
    for i in range(n):
        topic = ["trainingData", "forecastingData", "requests"][
            0 if i % 7 else (1 if i % 2 else 2)]
        part = int(rng.randint(2))
        off = offsets.get((topic, part), 0)
        offsets[(topic, part)] = off + 1
        out.append(Record(topic, json.dumps(
            {"numericalFeatures": np.round(rng.randn(3), 4).tolist(), "i": i}).encode(),
            part, off))
    size = -(-len(out) // windows)
    return [out[k:k + size] for k in range(0, len(out), size)]


def drain(consumer):
    seen, idle = [], 0
    while idle < 2:
        try:
            rec = next(consumer)
        except StopIteration:
            idle += 1
            seen.append(None)
            continue
        idle = 0
        seen.append((rec.topic, getattr(rec, "partition", 0), getattr(rec, "offset", None),
                     rec.value))
    return seen


def counters(c):
    return (c.dropped, c.duplicated, c.reordered, c.poisoned)


SPECS = {
    "drop": dict(seed=7, drop=0.1),
    "dup_reorder": dict(seed=3, dup=0.1, reorder=0.15, window=5),
    "loss_mix": dict(seed=11, drop=0.05, dup=0.05, reorder=0.05, delay=0.05),
    "poison": dict(seed=5, poison=0.2),
    "everything": dict(seed=2, drop=0.05, dup=0.1, reorder=0.1, poison=0.1, nan=0.3,
                       explode=0.3, window=3),
}


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("stream_seed", [0, 1])
def test_chaos_consumer_matches_jax(name, stream_seed):
    kw = SPECS[name]
    port = port_sup.ChaosConsumer(WindowedConsumer(records(seed=stream_seed)),
                                  poison_exempt_topics=["requests"], **kw)
    ref = jax_sup.ChaosConsumer(WindowedConsumer(records(seed=stream_seed)),
                                poison_exempt_topics=["requests"], **kw)
    got, want = drain(port), drain(ref)
    assert got == want
    assert counters(port) == counters(ref)
    assert sum(counters(port)) > 0  # the spec did misbehave
    poisoned = {v for e in got if e is not None for v in [e[3]]
                if isinstance(v, str)}
    assert poisoned <= set(port_sup._POISON_RECORDS)
    # the control stream stays intact: every request delivered is a bytes
    # value from the inner stream
    assert all(isinstance(e[3], bytes) for e in got if e is not None and e[0] == "requests")
    if kw.get("poison"):
        assert port.poisoned > 0 and poisoned
    # non-iterator attributes delegate to the wrapped consumer
    assert port.position(None) == 42


def test_poison_without_exemption_hits_requests():
    """Without the exemption a request can be poisoned (the exemption is
    what keeps the topology intact), in both packages alike."""
    kw = dict(seed=5, poison=0.5)
    port = port_sup.ChaosConsumer(WindowedConsumer(records(n=200)), **kw)
    ref = jax_sup.ChaosConsumer(WindowedConsumer(records(n=200)), **kw)
    got, want = drain(port), drain(ref)
    assert got == want
    assert any(isinstance(e[3], str) for e in got if e is not None and e[0] == "requests")


@pytest.mark.parametrize("spec,armed", [
    ("", False),
    ("seed=7", False),                    # nothing armed: the consumer untouched
    ("seed=7,drop=0.1,dup=0.05", True),
    ("seed=9,up.reorder=0.2,down.drop=0.5", True),
    ("seed=1,poison=0.1", True),
])
def test_maybe_chaos_consumer_matches_jax(monkeypatch, spec, armed):
    monkeypatch.setenv("OMLDM_CHAOS_KAFKA", spec)
    inner_p, inner_j = WindowedConsumer(records()), WindowedConsumer(records())
    port = port_sup.maybe_chaos_consumer(inner_p, poison_exempt_topics=["requests"])
    ref = jax_sup.maybe_chaos_consumer(inner_j, poison_exempt_topics=["requests"])
    assert (port is not inner_p) == (ref is not inner_j) == armed
    assert drain(port) == drain(ref)
    if armed:
        assert counters(port) == counters(ref)


def test_named_env_var_matches_jax(monkeypatch):
    """An armed spec under another variable name: only that variable arms
    the wrapper, and the named wrapper delivers as the JAX one does."""
    monkeypatch.setenv("OMLDM_CHAOS_KAFKA", "seed=1,drop=0.9")
    monkeypatch.setenv("OMLDM_CHAOS_KAFKA_TEST", "seed=4,dup=0.2")
    kw = dict(env_var="OMLDM_CHAOS_KAFKA_TEST", name="fleet")
    port = port_sup.maybe_chaos_consumer(WindowedConsumer(records()), **kw)
    ref = jax_sup.maybe_chaos_consumer(WindowedConsumer(records()), **kw)
    assert drain(port) == drain(ref)
    assert port.dropped == 0 and port.duplicated == ref.duplicated > 0


def test_unknown_chaos_key_raises(monkeypatch):
    monkeypatch.setenv("OMLDM_CHAOS_KAFKA", "seed=1,dorp=0.1")
    with pytest.raises(ValueError, match="unknown chaos key"):
        port_sup.maybe_chaos_consumer(WindowedConsumer([]))


def test_exported():
    assert {"ChaosConsumer", "maybe_chaos_consumer"} <= set(port_sup.__all__)
