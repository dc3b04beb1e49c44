"""Packed ingest and prefetch of the port (runtime.fast_ingest,
runtime.prefetch, MicroBatcher.add_many) against the JAX package's, on the
same files and bytes.

``iter_file_batches`` reads a file in chunks and carries the partial line
at a chunk's end into the next; the port's batches must equal the JAX
package's exactly, batch by batch, at chunk sizes that cut lines anywhere,
with and without hashed-categorical slots (lines the native parser flags
go through the Python codec in both)."""

import json
import threading
import time

import numpy as np
import pytest

import omldm_tpu.runtime.fast_ingest as jax_ingest
import omldm_tpu.runtime.vectorizer as jax_vec
import omldm_tpu_torch.runtime.fast_ingest as port_ingest
import omldm_tpu_torch.runtime.vectorizer as port_vec
from omldm_tpu.runtime.prefetch import prefetch as jax_prefetch
from omldm_tpu_torch.runtime.prefetch import Prefetcher, prefetch
from test_parser_fuzz import make_lines

DIM = 8


def _mixed_lines(seed, n):
    """Fuzzed lines plus records with categoricals (codec fallback) and
    forecasts, shuffled."""
    rng = np.random.RandomState(seed)
    lines = make_lines(rng, n)
    for i in range(n // 5):
        lines.append(json.dumps({
            "numericalFeatures": np.round(rng.randn(5), 6).tolist(),
            "categoricalFeatures": [f"c{i % 7}", f"d{i % 3}"],
            "target": float(i % 2),
        }))
        lines.append(json.dumps({"numericalFeatures": np.round(rng.randn(6), 6).tolist(),
                                 "operation": "forecasting"}))
    rng.shuffle(lines)
    return lines


def _batches_equal(port, ref):
    assert len(port) == len(ref) > 0
    for (px, py, pop), (rx, ry, rop) in zip(port, ref):
        np.testing.assert_array_equal(px, rx)
        np.testing.assert_array_equal(py, ry)
        np.testing.assert_array_equal(pop, rop)


@pytest.mark.parametrize("trailing_newline", [True, False])
@pytest.mark.parametrize("hash_dims", [0, 4])
@pytest.mark.parametrize("chunk_bytes", [97, 1000, 1 << 22])
def test_iter_file_batches_matches_reference(tmp_path, chunk_bytes, hash_dims,
                                             trailing_newline):
    lines = _mixed_lines(chunk_bytes + hash_dims, 400)
    path = tmp_path / "train.jsonl"
    path.write_text("\n".join(lines) + ("\n" if trailing_newline else ""))
    kw = dict(chunk_bytes=chunk_bytes, n_threads=2)
    port = list(port_ingest.iter_file_batches(str(path), DIM + hash_dims, 32, hash_dims, **kw))
    ref = list(jax_ingest.iter_file_batches(str(path), DIM + hash_dims, 32, hash_dims, **kw))
    _batches_equal(port, ref)
    # whole batches but the last, which carries the ragged tail
    assert all(b[0].shape[0] == 32 for b in port[:-1])


def test_line_longer_than_the_chunk(tmp_path):
    """A line longer than the whole read buffer grows the buffer."""
    long = json.dumps({"numericalFeatures": [0.123456] * 60, "target": 1.0})
    lines = [long, '{"numericalFeatures": [1.0], "target": 0.0}', long]
    path = tmp_path / "long.jsonl"
    path.write_text("\n".join(lines) + "\n")
    port = list(port_ingest.iter_file_batches(str(path), DIM, 2, chunk_bytes=64))
    ref = list(jax_ingest.iter_file_batches(str(path), DIM, 2, chunk_bytes=64))
    _batches_equal(port, ref)


def test_packed_batcher_feed_across_blocks():
    """Blocks fed one after another carry the ragged tail in the
    accumulator: the same batches as the JAX batcher, and the native
    parser took every block."""
    lines = _mixed_lines(5, 300)
    blocks = [("\n".join(lines[i : i + 37]) + "\n").encode() for i in range(0, len(lines), 37)]
    port_ingest.blocks.update(native=0, python=0)
    pb, rb = port_ingest.PackedBatcher(DIM, 16), jax_ingest.PackedBatcher(DIM, 16)
    assert pb.parser is not None
    port, ref = [], []
    for block in blocks:
        port.extend(pb.feed(block))
        ref.extend(rb.feed(block))
    port.append(pb.flush())
    ref.append(rb.flush())
    _batches_equal(port, ref)
    assert port_ingest.blocks == {"native": len(blocks), "python": 0}


def test_python_fallback_batcher_matches_reference():
    """Without the native parser both batchers parse with the codec."""
    lines = _mixed_lines(6, 200)
    block = ("\n".join(lines) + "\n").encode()
    pb, rb = port_ingest.PackedBatcher(DIM, 16), jax_ingest.PackedBatcher(DIM, 16)
    pb.parser = rb.parser = None
    port_ingest.blocks.update(native=0, python=0)
    port = list(pb.feed(block)) + [pb.flush()]
    ref = list(rb.feed(block)) + [rb.flush()]
    _batches_equal(port, ref)
    assert port_ingest.blocks == {"native": 0, "python": 1}


def test_micro_batcher_add_many_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(70, 5).astype(np.float32)
    y = rng.randn(70).astype(np.float32)
    pm, rm = port_vec.MicroBatcher(5, 32), jax_vec.MicroBatcher(5, 32)
    out_p, out_r = [], []
    for m, out in ((pm, out_p), (rm, out_r)):
        i = 0
        while i < x.shape[0]:
            i += m.add_many(x[i:], y[i:])
            assert len(m) == m._n
            if m.full:
                out.append(m.flush())
        out.append(m.flush())
    for a, b in zip(out_p, out_r):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def _drain(it, timeout=10.0):
    out = {"items": [], "exc": None}

    def run():
        try:
            for item in it:
                out["items"].append(item)
        except BaseException as e:  # noqa: BLE001 - the assertion target
            out["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "consumer hung"
    return out["items"], out["exc"]


@pytest.mark.parametrize("depth", [1, 2, 8])
def test_prefetch_keeps_order(depth):
    items, exc = _drain(prefetch(iter(range(200)), depth=depth))
    ref, _ = _drain(jax_prefetch(iter(range(200)), depth=depth))
    assert exc is None and items == ref == list(range(200))


def test_prefetch_delivers_the_error_after_the_items():
    def source():
        yield 1
        yield 2
        raise RuntimeError("boom")

    items, exc = _drain(prefetch(source(), depth=1))
    assert items == [1, 2] and isinstance(exc, RuntimeError)


def test_prefetch_close_releases_the_producer():
    """Closing mid-stream stops the producer thread even while it waits on
    a full queue; the ring's occupancy is observable before that."""
    def source():
        for i in range(100):
            yield i

    it = prefetch(source(), depth=2)
    assert isinstance(it, Prefetcher) and it.depth == 2
    assert next(it) == 0
    deadline = time.time() + 5.0
    while it.queued() < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert it.occupancy() == 1.0
    it.close()
    it._thread.join(5.0)
    assert not it._thread.is_alive(), "producer still alive after close"
    with pytest.raises(StopIteration):
        next(it)


# --- the packed path through the job: against the JAX job, block by block ----------

CREATE = {
    "id": 0, "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 1.0}, "dataStructure": {"nFeatures": DIM}},
    "trainingConfiguration": {"protocol": "Asynchronous"},
}


def _rows(n, dim=DIM, seed=0, forecast_every=13):
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(n, dim), 6).astype(np.float32)
    y = (x @ rng.randn(dim).astype(np.float32) > 0).astype(np.float32)
    op = np.zeros(n, np.uint8)
    op[::forecast_every] = 1
    return x, y, op


def _jobs(parallelism=3, record_buffer_cap=100_000):
    from omldm_tpu.config import JobConfig as JaxJobConfig
    from omldm_tpu.runtime import StreamJob as JaxStreamJob
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    kw = dict(parallelism=parallelism, batch_size=16, test_set_size=32,
              record_buffer_cap=record_buffer_cap)
    return StreamJob(JobConfig(**kw), device="cpu"), JaxStreamJob(JaxJobConfig(**kw))


def _state(job):
    out = []
    for spoke in job.spokes:
        for net in spoke.nets.values():
            net.flush_batch()
            out.append((net.dim, net.holdout_count, len(net.test_set),
                        net.pipeline.get_flat_params()[0]))
    return out


def _assert_same_state(port, ref):
    assert len(port) == len(ref) > 0
    for (pd, ph, pt, pf), (rd, rh, rt, rf) in zip(port, ref):
        assert (pd, ph, pt) == (rd, rh, rt)
        np.testing.assert_allclose(pf, rf, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("block", [7, 64, 500])
def test_packed_blocks_match_jax_job(block):
    """The same packed blocks through both jobs: rows dealt round-robin
    across workers (continuing the cycle between blocks), the holdout
    cycle, batch fills and forecasts at their positions. Equal holdout
    counts and test sets, parameters within the stream tolerance, >= 99%
    of predictions equal in the same order."""
    x, y, op = _rows(1500)
    port, ref = _jobs()
    for job in (port, ref):
        job.process_event("requests", json.dumps(CREATE))
        for s in range(0, x.shape[0], block):
            job.process_event("__packed__", (x[s : s + block], y[s : s + block],
                                             op[s : s + block]))
    _assert_same_state(_state(port), _state(ref))
    pv = [p.value for p in port.predictions]
    rv = [p.value for p in ref.predictions]
    assert len(pv) == len(rv) == int(op.sum())
    assert [p.data_instance.numerical_features for p in port.predictions] == \
        [p.data_instance.numerical_features for p in ref.predictions]
    assert sum(a != b for a, b in zip(pv, rv)) <= 0.01 * len(pv)


def test_packed_rows_buffer_before_create_like_jax():
    """Blocks that arrive before any Create are held and replayed on the
    first deploy, trimmed to the newest rows past the cap; a Create without
    a width takes the held block's."""
    create = json.loads(json.dumps(CREATE))
    del create["learner"]["dataStructure"]
    x, y, op = _rows(300, dim=5)
    port, ref = _jobs(record_buffer_cap=250)
    for job in (port, ref):
        job.process_event("__packed__", (x[:200], y[:200], op[:200]))
        job.process_event("__packed__", (x[200:], y[200:], op[200:]))
        job.process_event("requests", json.dumps(create))
    _assert_same_state(_state(port), _state(ref))
    assert _state(port)[0][0] == 5


def test_pending_create_takes_the_packed_width_like_jax():
    create = json.loads(json.dumps(CREATE))
    del create["learner"]["dataStructure"]
    x, y, op = _rows(100, dim=5)
    port, ref = _jobs()
    for job in (port, ref):
        job.process_event("requests", json.dumps(create))
        job.process_event("__packed__", (x, y, op))
    _assert_same_state(_state(port), _state(ref))


def test_ensure_deployed_deploys_pending_creates():
    create = json.loads(json.dumps(CREATE))
    del create["learner"]["dataStructure"]
    port, _ = _jobs()
    port.process_event("requests", json.dumps(create))
    assert not port.spokes[0].nets
    port.ensure_deployed(6)
    assert [s.nets[0].dim for s in port.spokes] == [6, 6, 6]
