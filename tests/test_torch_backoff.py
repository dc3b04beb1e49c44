"""The port's shared retry/backoff helper (omldm_tpu_torch/utils/backoff.py)
against the JAX package's on the same inputs.

Every case runs one scripted ``fn`` (a fixed sequence of raises and
results) through both ``with_backoff``s with a deterministic sleep/clock
pair and a seeded jitter stream; the delays slept, the attempts made, the
``on_retry`` calls and the outcome (value or exception) must be equal --
exactly: the helper does integer and float arithmetic in the same order
in both packages, so the tolerance is zero. ``BackoffPolicy.from_flags``
gives equal policies on the same flag maps."""

import dataclasses

import pytest

import omldm_tpu.utils.backoff as jax_backoff
import omldm_tpu_torch.utils.backoff as port_backoff


class Clock:
    """Deterministic sleep/clock pair: sleeping advances the clock."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s

    def clock(self):
        return self.now


def scripted(script):
    """fn replaying ``script``: an exception instance raises, anything else
    returns; past the end the last step repeats."""
    state = {"n": 0}

    def fn():
        step = script[min(state["n"], len(script) - 1)]
        state["n"] += 1
        if isinstance(step, BaseException):
            raise step
        return step

    return fn, state


def run(mod, script, kw, seed=7):
    clk = Clock()
    fn, state = scripted(script)
    seen = []
    kw = dict(kw)
    policy_kw = {k: kw.pop(k) for k in ("attempts", "base_delay", "growth", "jitter", "timeout")
                 if k in kw}
    kw["policy"] = mod.BackoffPolicy(**policy_kw)
    try:
        out = ("value", mod.with_backoff(
            fn, sleep=clk.sleep, clock=clk.clock, rng=mod.seeded_rng(seed, "test"),
            on_retry=lambda exc, k: seen.append((type(exc).__name__ if exc else None, k)),
            **kw))
    except Exception as exc:  # noqa: BLE001 -- the outcome is compared
        out = ("raised", type(exc).__name__, str(exc))
    return out, clk.sleeps, state["n"], seen


DOWN = ConnectionError("down")
CASES = {
    "first_try": ([1], dict(attempts=5, retry_on=(ConnectionError,))),
    "retry_then_ok": ([DOWN, DOWN, 3], dict(attempts=5, base_delay=0.2,
                                            retry_on=(ConnectionError,))),
    "unlisted_propagates": ([ValueError("no")], dict(attempts=5, retry_on=(ConnectionError,))),
    "exhausted_reraises": ([DOWN], dict(attempts=3, base_delay=0.1,
                                        retry_on=(ConnectionError,))),
    "accept_retries": ([None, None, {1, 2}], dict(attempts=5, base_delay=0.2, accept=bool)),
    "accept_exhausted_returns_last": ([None], dict(attempts=3, base_delay=0.0, accept=bool)),
    "accept_and_raise": ([DOWN, None, {0}], dict(attempts=4, base_delay=0.05, accept=bool,
                                                 retry_on=(ConnectionError,))),
    "growth_jitter": ([DOWN], dict(attempts=4, base_delay=0.1, growth=2.0, jitter=0.05,
                                   retry_on=(ConnectionError,))),
    "timeout_deadline": ([DOWN], dict(attempts=100, base_delay=1.0, timeout=2.5,
                                      retry_on=(ConnectionError,))),
    "timeout_with_growth": ([DOWN], dict(attempts=100, base_delay=0.3, growth=1.7,
                                         jitter=0.2, timeout=4.0,
                                         retry_on=(ConnectionError,))),
    "timeout_accept": ([None], dict(attempts=50, base_delay=0.5, timeout=1.2, accept=bool)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_with_backoff_matches_jax(case):
    script, kw = CASES[case]
    port = run(port_backoff, script, kw)
    ref = run(jax_backoff, script, kw)
    assert port == ref
    assert port[2] >= 1


def test_attempts_must_be_positive():
    for mod in (port_backoff, jax_backoff):
        with pytest.raises(ValueError, match="attempts"):
            mod.with_backoff(lambda: 1, policy=mod.BackoffPolicy(attempts=0))


def test_policy_is_required():
    """The port takes its policy as one value: no loose attempts/delay
    keywords beside it."""
    with pytest.raises(TypeError):
        port_backoff.with_backoff(lambda: 1)
    with pytest.raises(TypeError):
        port_backoff.with_backoff(lambda: 1, policy=port_backoff.BackoffPolicy(), attempts=2)


@pytest.mark.parametrize("flags,prefix,defaults", [
    ({"retryAttempts": "7", "retryBaseDelayMs": "250", "retryJitterMs": "50",
      "retryTimeoutMs": "3000"}, "retry", {}),
    ({}, "retry", dict(attempts=2, base_delay=0.01)),
    ({"sendRetryAttempts": "2", "retryAttempts": "9", "sendRetryGrowth": "1.5"}, "sendRetry",
     dict(attempts=3, base_delay=0.05, jitter=0.02)),
    ({"retryGrowth": "2", "retryTimeoutMs": "0"}, "retry",
     dict(attempts=5, base_delay=0.2, growth=1.5, jitter=0.05)),
])
def test_policy_from_flags_matches_jax(flags, prefix, defaults):
    port = port_backoff.BackoffPolicy.from_flags(flags, prefix, **defaults)
    ref = jax_backoff.BackoffPolicy.from_flags(flags, prefix, **defaults)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_kafka_policies_from_flags_match_jax():
    """The Kafka route's two policies from the same CLI flags: the port's
    defaults (CONNECT_RETRY, SEND_RETRY) are the JAX package's."""
    import omldm_tpu.__main__ as jax_cli
    import omldm_tpu_torch.__main__ as port_cli

    for flags in ({}, {"retryAttempts": "2", "sendRetryBaseDelayMs": "5",
                       "retryTimeoutMs": "900"}):
        port = port_cli._kafka_retry_policies(flags)
        ref = jax_cli._kafka_retry_policies(flags)
        assert [dataclasses.asdict(p) for p in port] == [dataclasses.asdict(p) for p in ref]


def test_seeded_jitter_schedule_matches_jax():
    for seed, name in ((0, "backoff"), (7, "restart"), (123456, "kafka")):
        a, b = port_backoff.seeded_rng(seed, name), jax_backoff.seeded_rng(seed, name)
        assert [a() for _ in range(16)] == [b() for _ in range(16)]
