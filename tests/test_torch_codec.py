"""The transport codec: the port against the JAX package on the same inputs.

- The numpy host codecs (fp16, int8 affine, top-k) and ``TransportCodec``
  streams (error feedback, top-k bases, anchors, resets): bitwise, leaf by
  leaf, message by message.
- The SPMD engine's QDQ twins against the JAX ``jnp`` twins on crafted
  vectors: fp16 bitwise (values past 65504 become inf in both); int8
  within one quantization step, with exact ties on the grid and an
  all-zero vector (scale 1).
- Whole ``StreamJob`` runs at parallelism 2 for each codec under
  Synchronous, Asynchronous and FGM: predictions and the integer counters
  (``bytesOnWire``, ``bytesShipped``, ``modelsShipped`` among them) equal,
  parameters at rtol 2e-4, atol 2e-5.
- ``SPMDTrainer`` with ``int8`` and ``fp16`` on ``Mesh(4, 1, "cpu")`` (the
  JAX trainer on 4 of conftest's 8 CPU devices), at the same tolerance,
  its ``ef`` residual leaf included.
"""

import json

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import LearnerSpec as JLearnerSpec
from omldm_tpu.api.requests import TrainingConfiguration as JTrainingConfiguration
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.ops import codec as jcodec
from omldm_tpu.parallel import SPMDTrainer as JSPMDTrainer, make_mesh as jmake_mesh
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import codec as jrcodec
from omldm_tpu_torch.api.requests import LearnerSpec, TrainingConfiguration
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.ops import codec as tcodec
from omldm_tpu_torch.parallel.mesh import Mesh
from omldm_tpu_torch.parallel.spmd import SPMDTrainer
from omldm_tpu_torch.pipelines import fleet_state_from_numpy
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import codec as trcodec
from omldm_tpu_torch.runtime.messages import comm_codec_name, payload_size

RTOL, ATOL = 2e-4, 2e-5
WALL_CLOCK_FIELDS = {
    "serveLatencyP50Ms", "serveLatencyP99Ms", "serveLatencyP999Ms",
    "launchP50Ms", "launchP99Ms", "serveLaunchP50Ms", "serveLaunchP99Ms",
    "codecEncodeSeconds", "codecDecodeSeconds",
}


def _vectors():
    rng = np.random.RandomState(0)
    return [
        rng.randn(257).astype(np.float32),
        (rng.randn(64, 3) * 40.0).astype(np.float32),
        np.full((33,), 3.25, np.float32),
        np.zeros((20,), np.float32),
        np.float32([1e-40, 2e-40, 3e-40] * 6),  # a subnormal span
    ]


# --- host kernels ---


@pytest.mark.parametrize("i", range(5))
def test_host_kernels_bitwise(i):
    x = _vectors()[i]
    np.testing.assert_array_equal(tcodec.fp16_encode(x), jcodec.fp16_encode(x))
    np.testing.assert_array_equal(tcodec.fp16_decode(tcodec.fp16_encode(x)),
                                  jcodec.fp16_decode(jcodec.fp16_encode(x)))
    tq, ts, tz = tcodec.int8_affine_encode(x)
    jq, js, jz = jcodec.int8_affine_encode(x)
    np.testing.assert_array_equal(tq, jq)
    assert (ts, tz) == (js, jz)
    np.testing.assert_array_equal(tcodec.int8_affine_decode(tq, ts, tz),
                                  jcodec.int8_affine_decode(jq, js, jz))
    assert tcodec.int8_quantization_step(x) == jcodec.int8_quantization_step(x)
    for k in (1, 5, x.size, x.size + 3):
        ti, tv = tcodec.topk_encode(x, k)
        ji, jv = jcodec.topk_encode(x, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tcodec.topk_decode(ti, tv, x.size),
                                      jcodec.topk_decode(ji, jv, x.size))


def test_int8_non_finite_leaf_fails_loudly():
    for bad in (np.nan, np.inf):
        x = np.ones((20,), np.float32)
        x[3] = bad
        with pytest.raises(ValueError, match="non-finite"):
            tcodec.int8_affine_encode(x)
        with pytest.raises(ValueError, match="non-finite"):
            jcodec.int8_affine_encode(x)


# --- TransportCodec streams ---


def _leaf_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    if hasattr(j, "kind"):
        assert (t.kind, t.shape, t.dtype, t.stream, t.seq, t.nbytes) == (
            j.kind, j.shape, j.dtype, j.stream, j.seq, j.nbytes)
        if j.kind == "topk":
            for a, b in zip(t.data, j.data):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(t.data, j.data)
        if j.meta is not None:
            assert tuple(t.meta) == tuple(j.meta)
    elif isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _leaf_equal(t[k], j[k])
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _leaf_equal(a, b)
    elif isinstance(j, np.ndarray):
        np.testing.assert_array_equal(t, j)
    else:
        assert t == j


@pytest.mark.parametrize("kind", ["fp16", "int8", "topk"])
def test_transport_codec_streams_bitwise(kind):
    """Two streams, a drifting parameter vector, a small leaf that stays
    raw, scalars and curve slices; a NACK-style tx reset, an rx reset and a
    retired-worker reset midway; the anchor cycle of 5 wraps twice."""
    rng = np.random.RandomState(1)
    kw = dict(top_k=7, min_leaf_size=8, anchor_every=5)
    tx_t, tx_j = trcodec.TransportCodec(kind, **kw), jrcodec.TransportCodec(kind, **kw)
    rx_t, rx_j = trcodec.TransportCodec(kind, **kw), jrcodec.TransportCodec(kind, **kw)
    w = rng.randn(40).astype(np.float32)
    for step in range(14):
        w = (w + 0.1 * rng.randn(40)).astype(np.float32)
        for stream in ("w0>h0", "w3>h0"):
            payload = {"params": w * (1.0 if stream == "w0>h0" else -2.0),
                       "small": np.ones((3,), np.float32), "fitted": step,
                       "curve": [(0.5, step)], "pair": (w[:10].copy(), 1.0)}
            et, ej = tx_t.encode(payload, stream), tx_j.encode(payload, stream)
            _leaf_equal(et, ej)
            assert payload_size(et) == payload_size(ej)
            dt, dj = rx_t.decode(et), rx_j.decode(ej)
            np.testing.assert_array_equal(dt["params"], dj["params"])
        if step == 4:
            tx_t.reset_tx_stream("w0>h0")
            tx_j.reset_tx_stream("w0>h0")
        if step == 7:
            rx_t.reset_rx_stream("w3>h0")
            rx_j.reset_rx_stream("w3>h0")
        if step == 10:
            for c in (tx_t, tx_j, rx_t, rx_j):
                c.reset_retired_worker_streams(2)
    for attr in ("leaves_encoded", "bytes_logical", "bytes_wire"):
        assert getattr(tx_t, attr) == getattr(tx_j, attr)
    for key, r in tx_j._residual.items():
        np.testing.assert_array_equal(tx_t._residual[key], r)
    assert sorted(rx_t._rx_base) == sorted(rx_j._rx_base)
    for key, b in rx_j._rx_base.items():
        np.testing.assert_array_equal(rx_t._rx_base[key], b)


def test_stateless_decode_and_config():
    leaf = trcodec.TransportCodec("topk", top_k=2, min_leaf_size=1).encode(
        np.arange(8, dtype=np.float32), "s")
    with pytest.raises(ValueError, match="stateful"):
        trcodec.decode_payload(leaf)
    tc = TrainingConfiguration(extra={"comm": {"codec": "TopK", "topK": 3,
                                               "anchorEvery": 9, "minLeafSize": 2}})
    c = trcodec.make_transport_codec(tc)
    assert (c.kind, c.top_k, c.anchor_every, c.min_leaf_size) == ("topk", 3, 9, 2)
    assert trcodec.make_transport_codec(TrainingConfiguration()) is None
    assert comm_codec_name(TrainingConfiguration(extra={"codec": "fp16"})) == "fp16"
    with pytest.raises(ValueError, match="unknown comm codec"):
        comm_codec_name(TrainingConfiguration(extra={"comm": {"codec": "zstd"}}))
    with pytest.raises(ValueError, match="host-plane"):
        tcodec.make_qdq("topk")
    assert tcodec.make_qdq("none") is None


# --- the device twins ---


def _craft_int8():
    """Vectors whose every element sits on the int8 grid or exactly half a
    step between two grid points (amax 127 -> scale 1.0, so x / scale is
    exact), with ties on both even and odd integers and both signs."""
    ties = np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.0, 3.0])
    return [
        ties,
        np.float32([127.0, -63.5, 0.0, 10.5, 11.5, -12.5]),
        np.zeros((9,), np.float32),
        np.random.RandomState(2).randn(300).astype(np.float32) * 7.0,
        np.float32([1e-30, -3e-30, 2e-30]),
    ]


def test_qdq_int8_ties_and_zero():
    for x in _craft_int8():
        got = tcodec.qdq_int8(torch.from_numpy(x)).numpy()
        ref = np.asarray(jcodec.qdq_int8(jnp.asarray(x)))
        amax = float(np.abs(x).max())
        step = amax / 127.0 if amax > 0 else 1.0
        assert np.max(np.abs(got - ref)) <= step, x
        # round half to even, as jnp.round: the crafted ties land bitwise
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tcodec.qdq_int8(torch.from_numpy(_craft_int8()[0])).numpy(),
                                  np.float32([0, 2, 2, -0, -2, -2, 126, -126, 127, 3]))


def test_qdq_int8_rowwise_matches_per_worker_twin():
    x = np.random.RandomState(3).randn(4, 50).astype(np.float32) * [[1], [10], [0], [1e3]]
    got = tcodec.qdq_int8(torch.from_numpy(x.astype(np.float32))).numpy()
    for r in range(4):
        ref = np.asarray(jcodec.qdq_int8(jnp.asarray(x[r].astype(np.float32))))
        np.testing.assert_array_equal(got[r], ref)


def test_qdq_fp16_bitwise_with_overflow():
    x = np.float32([0.1, -3.3, 65504.0, 65519.0, 65520.0, -7e4, 1e-8, 6e-5, 3.4e38])
    x = np.concatenate([x, np.random.RandomState(4).randn(100).astype(np.float32)])
    got = tcodec.qdq_fp16(torch.from_numpy(x)).numpy()
    ref = np.asarray(jcodec.qdq_fp16(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    assert np.isinf(got[4]) and np.isinf(got[5]) and got[2] == 65504.0


# --- whole jobs ---


def _events(protocol, codec, n=1500, dim=20, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim)
    tc = {"protocol": protocol, "syncEvery": 2, "threshold": 0.3,
          "comm": {"codec": codec, "topK": 6, "anchorEvery": 8}}
    events = [("requests", json.dumps({
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                    "dataStructure": {"nFeatures": dim}},
        "trainingConfiguration": tc,
    }))]
    for i in range(n):
        x = np.round(rng.randn(dim), 5)
        events.append(("trainingData", json.dumps(
            {"numericalFeatures": x.tolist(), "target": float(x @ w > 0)})))
        if i % 9 == 8:
            events.append(("forecastingData", json.dumps(
                {"numericalFeatures": np.round(rng.randn(dim), 5).tolist()})))
        if i == n - 40:
            events.append(("requests", json.dumps({"id": 0, "request": "Query",
                                                   "requestId": 1})))
    return events


def run_job_pair(events, parallelism=2, chaos="", **cfg):
    kw = dict(parallelism=parallelism, batch_size=32, test_set_size=32, chaos=chaos, **cfg)
    jax_job = JaxStreamJob(JaxJobConfig(**kw))
    job = StreamJob(JobConfig(**kw), device="cpu")
    return jax_job, jax_job.run(events), job, job.run(events)


def assert_jobs_match(jax_job, jax_report, job, report, min_equal=1.0):
    jp = np.array([p.value for p in jax_job.predictions])
    tp = np.array([p.value for p in job.predictions])
    assert len(tp) == len(jp)
    assert (tp == jp).mean() >= min_equal
    td = [s.to_dict() for s in report.statistics]
    jd = [s.to_dict() for s in jax_report.statistics]
    assert len(td) == len(jd) > 0
    for t, j in zip(td, jd):
        assert set(t) == set(j)
        for key, jv in j.items():
            tv = t[key]
            if key in WALL_CLOCK_FIELDS:
                continue
            if isinstance(jv, list):
                np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4, err_msg=key)
            elif isinstance(jv, float):
                assert abs(tv - jv) <= 1e-4, (key, tv, jv)
            else:
                assert tv == jv, (key, tv, jv)
    for js, ts in zip(jax_job.spokes, job.spokes):
        for nid, jnet in js.nets.items():
            np.testing.assert_allclose(ts.nets[nid].pipeline.get_flat_params()[0],
                                       jnet.pipeline.get_flat_params()[0],
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("protocol", ["Synchronous", "Asynchronous", "FGM"])
@pytest.mark.parametrize("codec", ["fp16", "int8", "topk"])
def test_stream_job_codec_matches_jax(codec, protocol):
    events = _events(protocol, codec)
    jax_job, jax_report, job, report = run_job_pair(events)
    assert_jobs_match(jax_job, jax_report, job, report)
    [s] = report.statistics
    assert 0 < s.bytes_on_wire < s.bytes_shipped  # compressed, and counted
    hub = job.hub_manager.hubs[(0, 0)].node
    assert hub.codec is not None and hub.codec.kind == codec
    assert s.codec_encode_seconds > 0.0


def test_codec_none_builds_nothing_and_counts_raw():
    events = _events("Asynchronous", "none", n=400)
    jax_job, jax_report, job, report = run_job_pair(events)
    assert_jobs_match(jax_job, jax_report, job, report)
    [s] = report.statistics
    assert s.bytes_on_wire == s.bytes_shipped > 0
    assert all(net.node.codec is None for sp in job.spokes for net in sp.nets.values())


def test_codec_gate():
    """An unknown codec and topk on the collective engine drop their
    Create alone, with the JAX gate's reasons; topk on the host plane and
    fp16/int8 on the collective engine deploy."""
    def create(pid, **tc):
        return ("requests", json.dumps({
            "id": pid, "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                        "dataStructure": {"nFeatures": 4}},
            "trainingConfiguration": dict({"protocol": "Synchronous"}, **tc),
        }))

    events = [create(0, comm={"codec": "zstd"}),
              create(1, engine="SPMD", comm={"codec": "topk"}),
              create(2, comm={"codec": "topk"}),
              create(3, engine="spmd", comm={"codec": "int8"}),
              create(4, engine="spmd", codec="fp16")]
    job = StreamJob(JobConfig(parallelism=2), device="cpu")
    jax_job = JaxStreamJob(JaxJobConfig(parallelism=2))
    job.run(events, terminate_on_end=False)
    jax_job.run(events, terminate_on_end=False)
    assert job.pipeline_manager.live_pipelines == jax_job.pipeline_manager.live_pipelines == [2, 3, 4]
    details = [e["detail"] for e in job.dead_letter.entries]
    assert details == [e["detail"] for e in jax_job.dead_letter.entries]
    assert "unknown comm codec 'zstd'" in details[0] and "host-plane only" in details[1]
    assert job.spmd_bridges[3].trainer._qdq is tcodec.qdq_int8
    assert job.spmd_bridges[4].trainer._qdq is tcodec.qdq_fp16


# --- the SPMD engine ---


def _spmd_pair(codec, protocol, dp=4, dim=24, hub=1):
    tc = dict(protocol=protocol, extra={"syncEvery": 2, "threshold": 0.3,
                                        "comm": {"codec": codec}})
    jt = JSPMDTrainer(JLearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=dim,
                      protocol=protocol, mesh=jmake_mesh(dp=dp, hub=hub),
                      training_configuration=JTrainingConfiguration(**tc), batch_size=16)
    tt = SPMDTrainer(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=dim,
                     protocol=protocol, mesh=Mesh(dp, hub, "cpu"),
                     training_configuration=TrainingConfiguration(**tc), batch_size=16)
    tt.load_state(fleet_state_from_numpy(jax.device_get(jt.state), tt))
    return jt, tt


@pytest.mark.parametrize("protocol", ["Synchronous", "EASGD", "GM", "Asynchronous"])
@pytest.mark.parametrize("codec", ["int8", "fp16"])
def test_spmd_trainer_codec_matches_jax(codec, protocol):
    dp, dim = 4, 24
    jt, tt = _spmd_pair(codec, protocol, dp, dim)
    assert "ef" in tt.state and tt.state["ef"].shape == (dp, tt.flat_size)
    rng = np.random.RandomState(5)
    w = rng.randn(dim)
    for t in range(12):
        x = rng.randn(dp, 16, dim).astype(np.float32)
        y = (x @ w > 0).astype(np.float32)
        m = np.ones((dp, 16), np.float32)
        if t % 3 == 1:
            m[t % dp] = 0.0
        jt.step(x, y, m)
        tt.step(x, y, m)
    jflat = np.stack([np.asarray(jax.flatten_util.ravel_pytree(p)[0])
                      for p in jt.shard_params()])
    np.testing.assert_allclose(tt._flat(tt.state["params"])[:, : tt.n_params].numpy(),
                               jflat, rtol=RTOL, atol=ATOL)
    js = jax.device_get(jt.state)
    for key in ("est", "center", "ef"):
        np.testing.assert_allclose(tt.state[key].numpy(), np.asarray(js[key])[:, 0],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ("step", "syncs", "clock", "fold_rounds"):
        np.testing.assert_array_equal(tt.state[key].numpy(), np.asarray(js[key])[:, 0])
    assert tt.bytes_on_wire() == jt.bytes_on_wire() < tt.bytes_shipped() == jt.bytes_shipped()
    assert np.abs(tt.state["ef"].numpy()).max() > 0.0  # the residual is live


def test_spmd_topk_refused_and_none_has_no_ef():
    with pytest.raises(ValueError, match="host-plane"):
        _spmd_pair("topk", "Synchronous")
    _, tt = _spmd_pair("none", "Synchronous")
    assert "ef" not in tt.state
