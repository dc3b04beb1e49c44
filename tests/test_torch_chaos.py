"""The in-process chaos channel: the port against the JAX package.

- ``parse_chaos_spec`` gives the JAX package's dict for the same specs and
  refuses the same typos.
- ``ChaosChannel`` fed the same calls gives the same schedule, call for
  call: which messages drop, which arrive twice and when, the order held
  messages release in, which payloads are corrupted and where the NaN
  lands, and the counters. Its RNG is the JAX package's crc32-seeded
  ``RandomState``.
- ``_corrupt_payload`` corrupts raw vectors and every encoded leaf kind
  the way the JAX package does, and never mutates its input.
- A job with ``chaos`` (or ``OMLDM_CHAOS``) runs; the overload plane's
  burst keys arm its burst injector; 64 PA-I Synchronous tenants under a drop
  spec with cohorts off finish inside the job's raised recursion limit
  (the JAX package stops with RecursionError there, ROADMAP queue 3).
"""

import json
import sys

import numpy as np
import pytest

from omldm_tpu.runtime import codec as jrcodec
from omldm_tpu.runtime import supervisor as jsup
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import codec as trcodec
from omldm_tpu_torch.runtime import supervisor as tsup

SPECS = [
    "seed=9,drop=0.1,up.dup=0.2,window=6",
    "seed=7,up.nan=0.05,up.explode=0.05",
    "seed=11,drop=0.05,dup=0.05,reorder=0.05,delay=0.05",
    " seed=3 , down.poison=0.5,,burst=4,burstFrom=2,hotTenant=1",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_spec_matches_jax(spec):
    assert tsup.parse_chaos_spec(spec) == jsup.parse_chaos_spec(spec)


@pytest.mark.parametrize("bad", ["dorp=0.1", "side.drop=0.1", "up.bogus=1"])
def test_parse_chaos_spec_refuses_typos(bad):
    with pytest.raises(ValueError, match="unknown chaos key"):
        tsup.parse_chaos_spec(bad)
    with pytest.raises(ValueError, match="unknown chaos key"):
        jsup.parse_chaos_spec(bad)


def _same(a, b):
    """Equal delivered argument tuples, NaN-aware for arrays."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, dict):
            assert set(x) == set(y)
            for k in y:
                _same([x[k]], [y[k]])
        elif isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("params", [
    dict(drop=0.1, dup=0.1, reorder=0.2, window=4),
    dict(delay=0.3, window=2),
    dict(nan=0.2, explode=0.1, drop=0.05),
    dict(nan=0.5, dup=0.2, window=3),
])
def test_chaos_channel_schedule_matches_jax(params):
    rng = np.random.RandomState(0)
    out_t, out_j = [], []
    ct = tsup.ChaosChannel(lambda *a: out_t.append(a), seed=7, name="spoke>hub", **params)
    cj = jsup.ChaosChannel(lambda *a: out_j.append(a), seed=7, name="spoke>hub", **params)
    for i in range(300):
        r = rng.rand()
        if r < 0.5:
            payload = {"params": rng.randn(9).astype(np.float32), "fitted": i}
        elif r < 0.7:
            payload = rng.randn(5).astype(np.float32)
        else:
            payload = {"violation": True}
        args = (0, 0, i % 3, "push", payload, i)
        ct.send(*args)
        cj.send(*args)
        if i == 250:
            ct.quiesce()
            cj.quiesce()
    ct.flush()
    cj.flush()
    assert ct.counters() == cj.counters()
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        _same(a, b)
    assert [a[5] for a in out_t] != list(range(len(out_t))) or not any(
        params.get(k) for k in ("drop", "dup", "reorder", "delay"))


@pytest.mark.parametrize("kind", ["fp16", "int8", "topk"])
@pytest.mark.parametrize("mode", ["nan", "explode"])
def test_corrupt_encoded_leaves_as_jax(kind, mode):
    vec = np.random.RandomState(1).randn(40).astype(np.float32)
    tt = trcodec.TransportCodec(kind, min_leaf_size=4, top_k=8)
    tj = jrcodec.TransportCodec(kind, min_leaf_size=4, top_k=8)
    pt, pj = tt.encode({"params": vec.copy()}, "w0>h0"), tj.encode({"params": vec.copy()}, "w0>h0")
    bt = tsup._corrupt_payload(pt, mode, tsup._chaos_rng(5, "x"))
    bj = jsup._corrupt_payload(pj, mode, jsup._chaos_rng(5, "x"))
    dt = trcodec.decode_payload(bt, trcodec.TransportCodec(kind, min_leaf_size=4, top_k=8))
    dj = jrcodec.decode_payload(bj, jrcodec.TransportCodec(kind, min_leaf_size=4, top_k=8))
    np.testing.assert_array_equal(dt["params"], dj["params"])
    assert not (np.isfinite(dt["params"]).all() and np.abs(dt["params"]).max() < 1e6)
    # the encoded original is untouched
    orig = trcodec.decode_payload(pt, trcodec.TransportCodec(kind, min_leaf_size=4, top_k=8))
    assert np.isfinite(orig["params"]).all() and np.abs(orig["params"]).max() < 1e3


def test_control_payloads_never_corrupt():
    rng = tsup._chaos_rng(0, "c")
    for payload in ({"violation": True}, {"gap": True}, None, {"params": np.ones(3, np.int32)},
                    {"x": np.ones((2, 3), np.float32)}):
        assert tsup._corrupt_payload(payload, "nan", rng) is None


def _create(pid=0, protocol="Synchronous", dim=6, **tc):
    return json.dumps({
        "id": pid, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.01, "variant": "PA-I"},
                    "dataStructure": {"nFeatures": dim}},
        "trainingConfiguration": dict({"protocol": protocol, "perRecord": True}, **tc),
    })


def _stream(n, dim=6, seed=2):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(4).randn(dim)
    x = rng.randn(n, dim).astype(np.float32)
    y = (x @ w > 0).astype(np.float32)
    op = np.zeros((n,), np.uint8)
    op[::10] = 1
    return x, y, op


def test_job_runs_under_chaos_and_env(monkeypatch):
    x, y, op = _stream(2000)
    job = StreamJob(JobConfig(parallelism=2, batch_size=32, chaos="seed=5,drop=0.1,dup=0.1"),
                    device="cpu")
    job.process_event("requests", _create())
    job.process_packed_batch(x, y, op)
    [s] = job.terminate().statistics
    assert job._chaos_up.counters()["dropped"] > 0 and s.fitted > 0
    assert all(net.channel_armed for sp in job.spokes for net in sp.nets.values())
    monkeypatch.setenv("OMLDM_CHAOS", "seed=1,drop=0.1")
    assert StreamJob(JobConfig(parallelism=2), device="cpu")._chaos_up is not None
    monkeypatch.setenv("OMLDM_CHAOS", "seed=1,dorp=0.1")
    with pytest.raises(ValueError, match="unknown chaos key"):
        StreamJob(JobConfig(parallelism=2), device="cpu")


@pytest.mark.parametrize("spec,keys", [
    ("seed=1,burst=4", "burst"), ("seed=1,drop=0.1,burstFrom=3,hotTenant=2",
                                  "burstFrom, hotTenant"),
])
def test_chaos_burst_keys_refused_by_name(spec, keys):
    """The burst keys were refused while the overload plane was missing;
    they now arm its ``BurstInjector`` (a ``burst`` of at least 2), whose
    window and hot tenant are the spec's, and turn tenant routing on."""
    job = StreamJob(JobConfig(chaos=spec), device="cpu")
    if "burst" in keys.split(", "):
        assert job._burst is not None and job._burst.factor == 4
        assert all(s.tenant_routing for s in job.spokes)
    else:
        assert job._burst is None
        assert tsup.parse_chaos_spec(spec)["hotTenant"] == 2


def test_64_synchronous_tenants_under_drop_fit_the_stack():
    """64 PA-I Synchronous tenants, cohorts off, parallelism 2, under a
    drop spec: NACKs and resyncs add frames to the cooperative toggle's
    nesting, and the job's raised limit still holds it (the caller's limit
    is restored after)."""
    x, y, op = _stream(1200)
    job = StreamJob(JobConfig(parallelism=2, batch_size=64, test_set_size=16, cohort="off",
                              chaos="seed=3,drop=0.05"), device="cpu")
    for pid in range(64):
        job.process_event("requests", _create(pid))
    old = sys.getrecursionlimit()
    for i in range(0, 1200, 400):
        job.process_packed_batch(x[i:i + 400], y[i:i + 400], op[i:i + 400])
    report = job.terminate()
    assert sys.getrecursionlimit() == old
    assert len(report.statistics) == 64
    assert all(s.fitted > 0 for s in report.statistics)
    assert job._chaos_up.counters()["dropped"] > 0
