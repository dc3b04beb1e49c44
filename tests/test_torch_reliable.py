"""The reliable channel: the port against the JAX package.

- ``StreamSequencer`` and ``ReceiveWindow`` fed the same calls give the
  same results (delivered messages, duplicates, gaps and their spans,
  counters), the JAX suite's cases (tests/test_reliable_transport.py)
  among them; the arming rules and the wire message types agree.
- Whole ``StreamJob`` runs (PA C 1.0, dim 6, batch 32, syncEvery 2, JSON
  records at parallelism 4: the JAX suite's template) of every parameter
  protocol under the JAX suite's acceptance chaos
  (``seed=7,drop=0.05,dup=0.05,reorder=0.1,window=4``), and the heavy-loss
  cases (tight windows, the stall watchdog): every integer counter
  (``duplicatesDropped``, ``gapsResynced``, ``bytesOnWire`` among them)
  and the chaos channels' counters equal the JAX job's; parameters at
  rtol 2e-4, atol 2e-5; the holdout score within one holdout row.
- Liveness: a silent worker is retired past ``workerTimeoutMs`` (a fake
  clock), the round releases on the quorum, and the worker is re-admitted
  when it speaks again, as in the JAX job.
"""

import json

import numpy as np
import pytest

from omldm_tpu.api.requests import TrainingConfiguration as JTrainingConfiguration
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import messages as jmessages
from omldm_tpu_torch.api.requests import TrainingConfiguration
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import messages as tmessages
from omldm_tpu_torch.runtime.messages import OP_RESYNC, ReceiveWindow, StreamSequencer

RTOL, ATOL = 2e-4, 2e-5
ACCEPTANCE_CHAOS = "seed=7,drop=0.05,dup=0.05,reorder=0.1,window=4"
PARAM_PROTOCOLS = ["Asynchronous", "Synchronous", "SSP", "EASGD", "GM", "FGM"]
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}


# --- units ---


def test_sequencer_matches_jax():
    t, j = StreamSequencer(), jmessages.StreamSequencer()
    for key in ("a", "a", "b", 3, 3, 1, "a"):
        assert t.next(key) == j.next(key)
    t.drop_streams([3, "zz"])
    j.drop_streams([3, "zz"])
    assert [t.next(k) for k in (3, 1, "a")] == [j.next(k) for k in (3, 1, "a")] == [0, 1, 3]


def _window_calls(rng, n=400):
    """Seeded offers: in order, reordered, duplicated, lost, resyncs, and a
    flush midway."""
    calls, seq = [], 0
    for _ in range(n):
        r = rng.rand()
        if r < 0.05:
            calls.append(("flush",))
            continue
        if r < 0.15:
            seq += int(rng.randint(1, 6))  # a hole
        s = seq + (int(rng.randint(-3, 4)) if rng.rand() < 0.3 else 0)
        op = OP_RESYNC if rng.rand() < 0.04 else "push"
        calls.append(("offer", max(s, 0), op, s))
        seq += 1
    return calls


@pytest.mark.parametrize("size,passthrough,seed", [
    (4, False, 0), (2, False, 1), (16, False, 2), (8, True, 3),
])
def test_receive_window_matches_jax(size, passthrough, seed):
    t = ReceiveWindow(size, passthrough=passthrough)
    j = jmessages.ReceiveWindow(size, passthrough=passthrough)
    for call in _window_calls(np.random.RandomState(seed)):
        if call[0] == "flush":
            assert t.flush() == j.flush()
            continue
        _, s, op, payload = call
        rt, rj = t.offer(s, op, payload), j.offer(s, op, payload)
        assert (rt.deliver, rt.duplicates, rt.gap, rt.gap_from, rt.gap_to) == (
            rj.deliver, rj.duplicates, rj.gap, rj.gap_from, rj.gap_to)
        assert (t.expected, len(t)) == (j.expected, len(j))
    assert (t.duplicates_dropped, t.gaps_resynced) == (j.duplicates_dropped, j.gaps_resynced)
    assert t.duplicates_dropped > 0


def test_receive_window_cases():
    """The JAX suite's window cases, on the port's window."""
    w = ReceiveWindow(4)
    assert w.offer(1, "op", "b").deliver == []
    assert w.offer(2, "op", "c").deliver == []
    assert w.offer(0, "op", "a").deliver == [("op", "a"), ("op", "b"), ("op", "c")]
    assert w.offer(0, "op", "a").duplicates == 1
    w = ReceiveWindow(2)
    w.offer(0, "op", "a")
    w.offer(2, "op", "c")
    assert w.offer(3, "op", "d").gap is False
    res = w.offer(4, "op", "e")
    assert res.gap and (res.gap_from, res.gap_to) == (1, 5) and w.expected == 5
    w = ReceiveWindow(8)
    w.offer(0, "op", "a")
    w.offer(3, "op", "stale-held")
    assert w.offer(5, OP_RESYNC, {"params": 1}).deliver == [(OP_RESYNC, {"params": 1})]
    assert w.offer(5, OP_RESYNC, {"params": 1}).duplicates == 1
    assert w.offer(6, "op", "f").deliver == [("op", "f")]
    assert ReceiveWindow(8, passthrough=True).offer(3, "op", "x").deliver == [("op", "x")]


@pytest.mark.parametrize("extra,chaos", [
    ({}, ""), ({}, "seed=1,drop=0.1"), ({"comm": {"quorum": 2}}, ""),
    ({"comm": {"reliable": False}}, "seed=1,drop=0.1"), ({"comm": {"reliable": 1}}, ""),
    ({"comm": {"windowSize": 3}}, ""),
])
def test_arming_rules_match_jax(extra, chaos):
    t = TrainingConfiguration(protocol="Synchronous", extra=extra)
    j = JTrainingConfiguration(protocol="Synchronous", extra=extra)
    assert tmessages.reliability_armed(t, chaos) == jmessages.reliability_armed(j, chaos)
    assert tmessages.channel_window_size(t) == jmessages.channel_window_size(j)
    assert tmessages.DEFAULT_STALL_AFTER == jmessages.DEFAULT_STALL_AFTER
    assert (tmessages.OP_NACK, tmessages.OP_RESYNC) == (jmessages.OP_NACK, jmessages.OP_RESYNC)


def test_chaos_spec_source(monkeypatch):
    monkeypatch.setenv("OMLDM_CHAOS", "seed=2,drop=0.1")
    assert tmessages.channel_chaos_spec(JobConfig()) == "seed=2,drop=0.1"
    assert tmessages.channel_chaos_spec(JobConfig(chaos="seed=3")) == "seed=3"


def test_messages_match_jax():
    src, dsts = tmessages.NodeId("hub", 0), [tmessages.NodeId("spoke", i) for i in range(3)]
    payload = {"params": np.ones(5, np.float32), "fitted": 3}
    b = tmessages.BroadcastMessage(0, "update", src, dsts, payload, seqs=[4, 0, 9])
    jb = jmessages.BroadcastMessage(0, "update", jmessages.NodeId("hub", 0),
                                    [jmessages.NodeId("spoke", i) for i in range(3)],
                                    payload, seqs=[4, 0, 9])
    assert b.get_size() == jb.get_size()
    assert [(m.destination.id, m.seq, m.get_size()) for m in b.expand()] == [
        (m.destination.id, m.seq, m.get_size()) for m in jb.expand()]


# --- whole jobs ---


def stream_lines(n, dim=6, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    x = rng.randn(n, dim)
    y = (x @ w > 0).astype(np.float64)
    return [json.dumps({"numericalFeatures": list(np.round(x[i], 5)), "target": float(y[i])})
            for i in range(n)]


def _events(protocol, lines, comm=None, extra=None):
    tc = {"protocol": protocol, "syncEvery": 2}
    if comm is not None:
        tc["comm"] = comm
    tc.update(extra or {})
    create = {"id": 0, "request": "Create",
              "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                          "dataStructure": {"nFeatures": 6}},
              "trainingConfiguration": tc}
    events = [("requests", json.dumps(create))]
    for i, line in enumerate(lines):
        events.append(("trainingData", line))
        if i % 9 == 8:
            events.append(("forecastingData", line))
    return events


def run_pair(protocol, chaos="", comm=None, extra=None, n=2000, parallelism=4):
    events = _events(protocol, stream_lines(n), comm, extra)
    kw = dict(parallelism=parallelism, batch_size=32, test_set_size=32, chaos=chaos)
    jax_job, job = JaxStreamJob(JaxJobConfig(**kw)), StreamJob(JobConfig(**kw), device="cpu")
    return jax_job, jax_job.run(events), job, job.run(events)


def assert_match(jax_job, jax_report, job, report):
    jp = np.array([p.value for p in jax_job.predictions])
    tp = np.array([p.value for p in job.predictions])
    assert len(tp) == len(jp) and (tp == jp).mean() >= 0.99
    [js], [ts] = jax_report.statistics, report.statistics
    jd, td = js.to_dict(), ts.to_dict()
    assert set(td) == set(jd)
    for key, jv in jd.items():
        tv = td[key]
        if key in WALL_CLOCK_FIELDS:
            continue
        if key == "score":
            assert abs(tv - jv) <= 1.0 / 32 + 1e-9, key
        elif isinstance(jv, list):
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=key)
        elif isinstance(jv, float):
            assert abs(tv - jv) <= 1e-4, (key, tv, jv)
        else:
            assert tv == jv, (key, tv, jv)
    for jsp, tsp in zip(jax_job.spokes, job.spokes):
        np.testing.assert_allclose(tsp.nets[0].pipeline.get_flat_params()[0],
                                   jsp.nets[0].pipeline.get_flat_params()[0],
                                   rtol=RTOL, atol=ATOL)
    if job._chaos_up is not None:
        assert job._chaos_up.counters() == jax_job._chaos_up.counters()
        assert job._chaos_down.counters() == jax_job._chaos_down.counters()
    return ts


@pytest.mark.parametrize("protocol", PARAM_PROTOCOLS)
def test_acceptance_chaos_matches_jax(protocol):
    extra = {"threshold": 0.3} if protocol in ("GM", "FGM") else None
    pair = run_pair(protocol, ACCEPTANCE_CHAOS, extra=extra)
    assert_match(*pair)
    job = pair[2]
    faults = job._chaos_up.counters(), job._chaos_down.counters()
    assert sum(c["dropped"] + c["duplicated"] + c["reordered"] for c in faults) > 0


@pytest.mark.parametrize("protocol,chaos,comm", [
    ("Asynchronous", "seed=11,drop=0.2,window=2", {"windowSize": 2}),
    ("Synchronous", "seed=13,drop=0.2,window=4", {"windowSize": 4, "stallAfter": 4}),
    ("Synchronous", "seed=11,drop=0.05,dup=0.05,reorder=0.05,delay=0.05",
     {"codec": "topk", "anchorEvery": 8}),
])
def test_heavy_loss_matches_jax(protocol, chaos, comm):
    pair = run_pair(protocol, chaos, comm=comm, extra={"syncEvery": 1})
    ts = assert_match(*pair)
    faults = pair[2]._chaos_up.counters(), pair[2]._chaos_down.counters()
    assert sum(c["dropped"] + c["reordered"] for c in faults) > 0 and ts.score > 0.8


def test_armed_faultless_channel_is_transparent():
    """comm.reliable on a clean channel changes no statistic."""
    _, _, _, base = run_pair("Synchronous", n=1000)
    _, _, job, armed = run_pair("Synchronous", comm={"reliable": True}, n=1000)
    assert job.spokes[0].nets[0].channel_armed
    b, a = base.statistics[0].to_dict(), armed.statistics[0].to_dict()
    assert {k: v for k, v in b.items() if k not in WALL_CLOCK_FIELDS} == {
        k: v for k, v in a.items() if k not in WALL_CLOCK_FIELDS}


def _silent_worker_pair():
    out = []
    for cls, cfg in ((JaxStreamJob, JaxJobConfig), (StreamJob, JobConfig)):
        kw = {"device": "cpu"} if cls is StreamJob else {}
        job = cls(cfg(parallelism=3, batch_size=16, test_set_size=16), **kw)
        job.process_event("requests", json.dumps({
            "id": 0, "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                        "dataStructure": {"nFeatures": 6}},
            "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 1,
                                      "comm": {"quorum": 2, "workerTimeoutMs": 1000}},
        }))
        hub = job.hub_manager.hubs[(0, 0)].node
        now = [0.0]
        hub._clock = lambda now=now: now[0]
        out.append((job, hub, now))
    return out


def test_quorum_release_and_readmission_match_jax():
    """Worker 2 goes silent: the survivors block, the hub retires it once
    the (fake) clock passes workerTimeoutMs and releases on the quorum;
    when it speaks again it is re-admitted with a resync."""
    lines = stream_lines(900, seed=2)
    pairs = _silent_worker_pair()
    for job, hub, now in pairs:
        silent = job.spokes[2].nets[0].node
        real_send = silent.send
        silent.send = lambda *a, **k: None
        for line in lines[:300]:
            job.process_event("trainingData", line)
        assert job.spokes[0].nets[0].node.waiting
        now[0] = 2.0
        for line in lines[300:600]:
            job.process_event("trainingData", line)
        assert hub._retired_live == {2} and hub.stats.quorum_releases > 0
        silent.send = real_send
        for line in lines[600:]:
            job.process_event("trainingData", line)
        assert hub._retired_live == set()
    (jj, jh, _), (tj, th, _) = pairs
    jr, tr = jj.terminate(), tj.terminate()
    assert th.stats.quorum_releases == jh.stats.quorum_releases
    js, ts = jr.statistics[0].to_dict(), tr.statistics[0].to_dict()
    for key in ("fitted", "modelsShipped", "bytesShipped", "bytesOnWire", "quorumReleases",
                "numOfBlocks"):
        assert ts[key] == js[key], key
    assert ts["score"] > 0.8


def test_liveness_stride_is_a_job_field():
    job = StreamJob(JobConfig(liveness_stride=3), device="cpu")
    assert job.hub_manager._liveness_stride == 3
    assert JobConfig.from_args({"livenessStride": "5"}).liveness_stride == 5


@pytest.mark.parametrize("protocol", ["Synchronous", "SSP", "GM", "FGM"])
def test_set_parallelism_prunes_as_jax(protocol):
    """A shrink from 4 workers to 3 on a hub shard (the rescale's hub half):
    the retired worker's barrier entries and liveness/guard records go, the
    codec forgets its streams, and a barrier the survivors complete
    releases at once; the replies equal the JAX hub's."""
    from omldm_tpu.api.requests import LearnerSpec as JLearnerSpec
    from omldm_tpu.api.requests import Request as JRequest
    from omldm_tpu.api.requests import RequestType as JRequestType
    from omldm_tpu.runtime.hub import Hub as JHub
    from omldm_tpu_torch.api.requests import LearnerSpec, Request, RequestType
    from omldm_tpu_torch.runtime.hub import Hub

    extra = {"guard": True, "comm": {"codec": "topk", "quorum": 2}, "threshold": 0.1}
    hubs, sent = [], []
    for req_cls, spec, rt, hub_cls, cfg, tc_cls, kw in (
        (JRequest, JLearnerSpec, JRequestType, JHub, JaxJobConfig, JTrainingConfiguration, {}),
        (Request, LearnerSpec, RequestType, Hub, JobConfig, TrainingConfiguration,
         {"device": "cpu"}),
    ):
        out = []
        request = req_cls(id=0, request=rt.CREATE,
                          learner=spec("PA", hyper_parameters={"C": 1.0},
                                       data_structure={"nFeatures": 30}),
                          training_configuration=tc_cls(protocol=protocol, extra=extra))
        hubs.append(hub_cls(0, 0, request, 30, cfg(parallelism=4),
                            reply=lambda w, op, p, out=out: out.append((w, op)),
                            broadcast=lambda op, p, out=out: out.append(("*", op)), **kw))
        sent.append(out)
    rng = np.random.RandomState(0)
    for step in range(3):
        for w in (0, 1, 3):
            vec = rng.randn(31).astype(np.float32)
            if protocol in ("GM", "FGM"):
                msgs = [("zeta", {"violation": True, "curve": [], "fitted": step}),
                        ("zeta", {"phi": 1.0}), ("push", {"params": vec, "curve": [],
                                                          "fitted": step})]
            else:
                msgs = [("push", {"params": vec, "curve": [], "fitted": step,
                                  "clock": step + 1})]
            for op, payload in msgs:
                for hub in hubs:
                    hub.receive(w, op, dict(payload))
    for hub in hubs:
        hub.set_parallelism(3)
    assert sent[1] == sent[0]
    jn, tn = hubs[0].node, hubs[1].node
    assert (tn.n_workers, tn.round_target(), tn._last_seen.keys()) == (
        jn.n_workers, jn.round_target(), jn._last_seen.keys())
    assert all("w3" not in k[0] for k in tn.codec._rx_base)
    assert tn.stats.fitted == jn.stats.fitted


def test_codec_seconds_sum_hubs_and_spokes():
    events = _events("Synchronous", stream_lines(600), comm={"codec": "int8", "minLeafSize": 4})
    job = StreamJob(JobConfig(parallelism=2, batch_size=32, test_set_size=32), device="cpu")
    job.run(events, terminate_on_end=False)
    enc, dec = job.codec_seconds()
    nodes = [h.node for h in job.hub_manager.hubs.values()] + [
        n.node for sp in job.spokes for n in sp.nets.values()]
    assert enc == sum(n.codec.encode_seconds for n in nodes) > 0.0
    assert dec == sum(n.codec.decode_seconds for n in nodes) > 0.0
    [s] = job.terminate().statistics
    assert s.codec_encode_seconds > 0.0 and s.codec_decode_seconds > 0.0
