"""Job checkpoints and rescale-merge restores: the port against the JAX package.

The cases of tests/test_checkpoint.py, each run on the JAX job and on the
port's job (``device="cpu"``) fed the same seeded records, side by side:
PA C 1.0, Synchronous syncEvery 2, batch 32, holdout 32, JSON records of
dim 5. Tolerances:

- the two packages' jobs after the same stream: parameters rtol 2e-4,
  atol 2e-5 (the stream parity of the earlier slices), integer counters
  equal, the holdout score within one holdout row;
- a save, restore or merge on one side: rtol 1e-6 (the JAX suite's).

Beside them: the snapshot's schema against the JAX snapshot of the same job
at the same offset (key sets equal, every numpy leaf within the stream
tolerance), no torch tensor anywhere in a snapshot, and no two workers
sharing a parameter buffer after a restore at another parallelism or a
grow.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import LearnerSpec as JLearnerSpec
from omldm_tpu.api.requests import TrainingConfiguration as JTrainingConfiguration
from omldm_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu_torch.api.requests import LearnerSpec, TrainingConfiguration
from omldm_tpu_torch.checkpoint import CheckpointManager
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.parallel.mesh import Mesh
from omldm_tpu_torch.parallel.spmd import SPMDTrainer
from omldm_tpu_torch.pipelines.pipeline import fleet_state_from_numpy
from omldm_tpu_torch.runtime import StreamJob

RTOL, ATOL = 2e-4, 2e-5       # the two packages after the same stream
MERGE_RTOL = 1e-6             # one save/restore/merge on one side


def stream_lines(n, dim=5, seed=0):
    # the concept (separating hyperplane) is fixed; seed varies the draws
    w = np.random.RandomState(42).randn(dim)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim)
    y = (x @ w > 0).astype(np.float64)
    return [json.dumps({"numericalFeatures": list(np.round(x[i], 5)), "target": float(y[i])})
            for i in range(n)]


CREATE = {
    "id": 0,
    "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 1.0}},
    "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 2},
}


def trained_pair(parallelism=4, n=1500, create=CREATE, **cfg):
    """The JAX job and the port's job after the same Create and records."""
    events = [("requests", json.dumps(create))] + [("trainingData", l) for l in stream_lines(n)]
    kw = dict(parallelism=parallelism, batch_size=32, test_set_size=32, **cfg)
    jax_job = JaxStreamJob(JaxJobConfig(**kw))
    jax_job.run(events, terminate_on_end=False)
    job = StreamJob(JobConfig(**kw), device="cpu")
    job.run(events, terminate_on_end=False)
    return jax_job, job


def managers(tmp_path, **kw):
    return (JaxCheckpointManager(str(tmp_path / "jax"), **kw),
            CheckpointManager(str(tmp_path / "port"), device="cpu", **kw))


def flats(job):
    return [s.nets[0].pipeline.get_flat_params()[0] for s in job.spokes]


def assert_jobs_close(jax_job, job, rtol=RTOL, atol=ATOL):
    assert len(job.spokes) == len(jax_job.spokes)
    for a, b in zip(flats(jax_job), flats(job)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)
    for js, ts in zip(jax_job.spokes, job.spokes):
        jn, tn = js.nets[0], ts.nets[0]
        assert (tn.pipeline.fitted, tn.holdout_count, len(tn.test_set), len(tn.batcher)) == (
            jn.pipeline.fitted, jn.holdout_count, len(jn.test_set), len(jn.batcher))


def assert_reports_match(jax_report, report):
    [js], [ts] = jax_report.statistics, report.statistics
    assert ts.fitted == js.fitted
    assert ts.models_shipped == js.models_shipped
    assert ts.bytes_shipped == js.bytes_shipped
    assert ts.rescales_performed == js.rescales_performed
    assert abs(ts.score - js.score) <= 1.0 / 32 + 1e-9
    return ts


@pytest.fixture(scope="module")
def trained():
    return trained_pair()


class TestSaveRestore:
    def test_roundtrip_same_parallelism(self, tmp_path, trained):
        jax_job, job = trained
        jm, tm = managers(tmp_path)
        jm.save(jax_job)
        tm.save(job)
        jr, tr = jm.restore(), tm.restore()
        assert tr.pipeline_manager.live_pipelines == jr.pipeline_manager.live_pipelines == [0]
        for a, b in zip(flats(job), flats(tr)):
            np.testing.assert_allclose(b, a, rtol=MERGE_RTOL)
        assert_jobs_close(jr, tr)
        assert tr.events_processed == jr.events_processed == 1501

    def test_restored_job_continues_training(self, tmp_path, trained):
        jax_job, job = trained
        jm, tm = managers(tmp_path)
        jm.save(jax_job)
        tm.save(job)
        more = [("trainingData", l) for l in stream_lines(1500, seed=1)]
        jr, tr = jm.restore(), tm.restore()
        stats = assert_reports_match(jr.run(more), tr.run(more))
        assert stats.score > 0.85
        assert_jobs_close(jr, tr)

    def test_rescale_down_merges_exactly_when_quiesced(self, tmp_path):
        """With empty buffers a 4 -> 2 restore lands exactly the averaged
        replicas on every new worker (the assignment the reference's
        restore forgot, FlinkSpoke.scala:291-305)."""
        jax_job, job = trained_pair()
        for j in (jax_job, job):
            for s in j.spokes:  # quiesce: no pending work to re-train
                s.nets[0].flush_batch()
                s.nets[0].test_set.clear()
        jm, tm = managers(tmp_path)
        jm.save(jax_job)
        tm.save(job)
        jr, tr = jm.restore(parallelism=2), tm.restore(parallelism=2)
        assert len(tr.spokes) == 2
        expect = np.stack(flats(job)).mean(0)
        for got in flats(tr):
            np.testing.assert_allclose(got, expect, rtol=MERGE_RTOL, atol=1e-7)
        assert_jobs_close(jr, tr)

    def test_rescale_down_retrains_overflow_and_converges(self, tmp_path, trained):
        """With live buffers a rescale deals the holdout points (capacity
        overflow re-trained) and keeps learning."""
        jax_job, job = trained
        jm, tm = managers(tmp_path)
        jm.save(jax_job)
        tm.save(job)
        jr, tr = jm.restore(parallelism=2), tm.restore(parallelism=2)
        assert sum(len(s.nets[0].test_set) for s in tr.spokes) > 0
        assert_jobs_close(jr, tr)
        more = [("trainingData", l) for l in stream_lines(800, seed=2)]
        stats = assert_reports_match(jr.run(more), tr.run(more))
        assert stats.score > 0.85 and stats.rescales_performed == 1

    def test_rescale_up_replicates(self, tmp_path):
        jax_job, job = trained_pair(parallelism=2)
        jm, tm = managers(tmp_path)
        jm.save(jax_job)
        tm.save(job)
        jr, tr = jm.restore(parallelism=4), tm.restore(parallelism=4)
        assert len(tr.spokes) == 4
        assert_jobs_close(jr, tr)
        more = [("trainingData", l) for l in stream_lines(800, seed=3)]
        assert assert_reports_match(jr.run(more), tr.run(more)).score > 0.8

    def test_hub_stats_continuity(self, tmp_path, trained):
        jax_job, job = trained
        jm, tm = managers(tmp_path)
        jm.save(jax_job)
        tm.save(job)
        before = job.hub_manager.network_statistics(0)
        after = tm.restore().hub_manager.hubs[(0, 0)].node.stats
        jafter = jm.restore().hub_manager.hubs[(0, 0)].node.stats
        assert (after.bytes_shipped, after.fitted) == (before.bytes_shipped, before.fitted)
        assert (after.bytes_shipped, after.fitted, after.models_shipped) == (
            jafter.bytes_shipped, jafter.fitted, jafter.models_shipped)

    def test_periodic_maybe_save(self, tmp_path):
        events = [("requests", json.dumps(CREATE))] + [
            ("trainingData", l) for l in stream_lines(100)]
        saved = []
        for cls, cfg, sub, kw in ((JaxStreamJob, JaxJobConfig, "jax", {}),
                                  (StreamJob, JobConfig, "port", {"device": "cpu"})):
            job = cls(cfg(parallelism=1, checkpointing=True, check_interval_ms=0,
                          checkpoint_dir=str(tmp_path / sub), batch_size=16), **kw)
            job.run(events, terminate_on_end=False)
            assert job.checkpoint_manager.latest_path() is not None
            saved.append(len(os.listdir(tmp_path / sub)))
        # keep 3 snapshots and the `latest` pointer, on both sides
        assert saved[0] == saved[1] == 4

    def test_restore_without_checkpoint_raises(self, tmp_path):
        for mgr in managers(tmp_path):
            with pytest.raises(FileNotFoundError):
                mgr.restore()


class TestSPMDCheckpoint:
    def test_spmd_save_load(self, tmp_path):
        """Mesh(4, 2) from the JAX trainer's draw: five steps on both, then
        the port's save/load round trip is bitwise and both equal the JAX
        trainer's params."""
        import jax

        from omldm_tpu.parallel import SPMDTrainer as JaxSPMDTrainer
        from omldm_tpu.parallel import make_mesh

        def tc(cls):
            return cls(protocol="Synchronous", extra={"syncEvery": 1})

        jt = JaxSPMDTrainer(JLearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=6,
                            protocol="Synchronous", mesh=make_mesh(dp=4, hub=2),
                            training_configuration=tc(JTrainingConfiguration))

        def port_trainer():
            t = SPMDTrainer(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=6,
                            protocol="Synchronous", mesh=Mesh(4, 2, "cpu"),
                            training_configuration=tc(TrainingConfiguration))
            t.load_state(fleet_state_from_numpy(jax.device_get(jt.state), t))
            return t

        t = port_trainer()
        rng = np.random.RandomState(0)
        for _ in range(5):
            x = rng.randn(4, 32, 6).astype(np.float32)
            y = (x.sum(-1) > 0).astype(np.float32)
            m = np.ones((4, 32), np.float32)
            jt.step(x, y, m)
            t.step(x, y, m)
        t.save(str(tmp_path / "spmd"))
        t2 = port_trainer()
        t2.load(str(tmp_path / "spmd"))
        np.testing.assert_array_equal(t2.global_flat_params(), t.global_flat_params())
        for k in t.state:
            if isinstance(t.state[k], torch.Tensor):
                assert torch.equal(t.state[k], t2.state[k]), k
        np.testing.assert_allclose(t2.global_flat_params(), jt.global_flat_params(),
                                   rtol=RTOL, atol=ATOL)


class TestStatisticsContinuity:
    def test_cumulative_loss_restored(self, tmp_path, trained):
        jax_job, job = trained
        losses = [s.nets[0].pipeline.cumulative_loss for s in job.spokes]
        jlosses = [s.nets[0].pipeline.cumulative_loss for s in jax_job.spokes]
        assert sum(losses) > 0
        np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
        _, tm = managers(tmp_path)
        tm.save(job)
        for spoke, expected in zip(tm.restore().spokes, losses):
            assert spoke.nets[0].pipeline.cumulative_loss == pytest.approx(expected, rel=MERGE_RTOL)

    def test_cumulative_loss_sum_survives_rescale(self, tmp_path, trained):
        jax_job, job = trained
        total = sum(s.nets[0].pipeline.cumulative_loss for s in job.spokes)
        jm, tm = managers(tmp_path)
        jm.save(jax_job)
        tm.save(job)
        got = sum(s.nets[0].pipeline.cumulative_loss for s in tm.restore(parallelism=2).spokes)
        jgot = sum(s.nets[0].pipeline.cumulative_loss for s in jm.restore(parallelism=2).spokes)
        # merged replicas may retrain overflow records (adding loss)
        assert got >= total * (1 - MERGE_RTOL)
        assert got == pytest.approx(jgot, rel=RTOL)


def _snaps(directory):
    return sorted(f for f in os.listdir(directory) if f.startswith("ckpt_") and f.endswith(".pkl"))


class TestRetention:
    @pytest.fixture(scope="class")
    def small(self):
        return trained_pair(parallelism=2, n=400)

    def test_prunes_to_keep_newest(self, tmp_path, small):
        for mgr, job in zip(managers(tmp_path, keep=3), small):
            paths = [mgr.save(job) for _ in range(7)]
            snaps = _snaps(mgr.directory)
            assert len(snaps) == 3
            assert snaps[-1] == os.path.basename(paths[-1])
            assert mgr.latest_path().endswith(snaps[-1])
            mgr.restore()

    def test_empty_latest_pointer_reads_as_no_checkpoint(self, tmp_path, small):
        for mgr, job in zip(managers(tmp_path, keep=3), small):
            mgr.save(job)
            pointer = os.path.join(mgr.directory, "latest")
            with open(pointer, "w"):
                pass  # a truncated pointer
            assert mgr.latest_path() is None
            with pytest.raises(FileNotFoundError):
                mgr.restore()
            with open(pointer, "w") as f:
                f.write("ckpt_gone.pkl")  # a dangling pointer
            assert mgr.latest_path() is None

    def test_same_millisecond_saves_do_not_collide(self, tmp_path, small):
        for mgr, job in zip(managers(tmp_path, keep=0), small):
            assert len({mgr.save(job) for _ in range(5)}) == 5

    def test_keep_zero_retains_everything(self, tmp_path, small):
        for mgr, job in zip(managers(tmp_path, keep=0), small):
            for _ in range(5):
                mgr.save(job)
            assert len(_snaps(mgr.directory)) == 5

    def test_sequence_survives_new_manager_on_same_dir(self, tmp_path, small):
        for cls, sub, job, kw in ((JaxCheckpointManager, "jax", small[0], {}),
                                  (CheckpointManager, "port", small[1], {"device": "cpu"})):
            d = str(tmp_path / sub)
            m1 = cls(d, keep=2, **kw)
            m1.save(job)
            p2 = m1.save(job)
            m2 = cls(d, keep=2, **kw)
            p3 = m2.save(job)
            assert os.path.basename(p3) > os.path.basename(p2)
            assert m2.latest_path() == p3
            m2.restore()


# --- the snapshot itself ---


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _tensor_paths(obj, path="", seen=None):
    """Every place a torch.Tensor hides in ``obj`` (containers and object
    attributes walked)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [path]
    out = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            out += _tensor_paths(v, f"{path}/{k}", seen)
    elif isinstance(obj, (list, tuple, set)):
        for i, v in enumerate(obj):
            out += _tensor_paths(v, f"{path}[{i}]", seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        out += _tensor_paths(vars(obj), f"{path}.{type(obj).__name__}", seen)
    return out


def _assert_tree_close(a, b, path):
    """Same nesting; numpy leaves within the stream tolerance, other leaves
    equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_tree_close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_close(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=path)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=RTOL, abs=ATOL), path
    else:
        assert a == b, (path, a, b)


GUARDED = {**CREATE, "trainingConfiguration": {**CREATE["trainingConfiguration"], "guard": True}}
SPMD = {**CREATE, "trainingConfiguration": {"protocol": "Asynchronous", "syncEvery": 8,
                                            "engine": "spmd", "stageChain": 1}}
SL = {**CREATE, "trainingConfiguration": {"protocol": "SingleLearner"}}
# what the port's job snapshot holds for a spoke net and a hub, as the JAX
# package's; the node round state is framework-specific
NET_KEYS = {"params", "preps", "fitted", "cum_loss", "holdout_count", "test_set", "pending",
            "node"}
JOB_KEYS = {"config", "requests", "dims", "spokes", "hub_stats", "hub_nodes", "bridges",
            "offset", "source_position", "rr", "rescales", "backlog", "pending_creates", "time"}


@pytest.mark.parametrize("create,parallelism", [
    (CREATE, 4), (GUARDED, 2), (SL, 2), (SPMD, 2),
], ids=["sync", "guarded", "single_learner", "spmd_bridge"])
def test_snapshot_schema_matches_jax(tmp_path, monkeypatch, create, parallelism):
    """The port's snapshot has the JAX snapshot's keys, key for key, and its
    plain-data leaves within the stream tolerance, for the same job at the
    same offset (the bridge on the JAX job's 8-slot mesh)."""
    import omldm_tpu_torch.runtime.spmd_bridge as tb

    monkeypatch.setattr(tb, "device_slots", lambda device: 8)
    jax_job, job = trained_pair(parallelism=parallelism, n=700, create=create)
    jm, tm = managers(tmp_path)
    js, ts = _load(jm.save(jax_job)), _load(tm.save(job))
    assert set(js) == set(ts) == JOB_KEYS
    shared = set(js["config"]) & set(ts["config"])
    assert {k: js["config"][k] for k in shared if k != "checkpoint_dir"} == {
        k: ts["config"][k] for k in shared if k != "checkpoint_dir"}
    for key in ("requests", "dims", "offset", "source_position", "rr", "rescales",
                "backlog", "pending_creates"):
        assert ts[key] == js[key], key
    assert len(ts["spokes"]) == len(js["spokes"]) == parallelism
    for jnets, tnets in zip(js["spokes"], ts["spokes"]):
        assert set(jnets) == set(tnets)
        for net_id, jsv in jnets.items():
            tsv = tnets[net_id]
            assert set(tsv) == set(jsv) and NET_KEYS <= set(tsv)
            for key in jsv:
                if key != "node":
                    _assert_tree_close(jsv[key], tsv[key], key)
    assert set(ts["hub_nodes"]) == set(js["hub_nodes"])
    for key, jentry in js["hub_nodes"].items():
        assert set(ts["hub_nodes"][key]) == set(jentry)
        if "pipeline" in jentry:
            _assert_tree_close(jentry["pipeline"], ts["hub_nodes"][key]["pipeline"], "pipeline")
    assert set(ts["hub_stats"]) == set(js["hub_stats"])
    for net_id, jd in js["hub_stats"].items():
        td = ts["hub_stats"][net_id]
        assert set(td) == set(jd)
        for k in ("modelsShipped", "bytesShipped", "numOfBlocks", "fitted"):
            assert td[k] == jd[k], k
    assert set(ts["bridges"]) == set(js["bridges"])
    for net_id, jb in js["bridges"].items():
        _assert_tree_close(jb, ts["bridges"][net_id], "bridge")
    assert not _tensor_paths(ts)


def test_snapshot_holds_no_tensor_and_restores_across_devices(tmp_path):
    """Every leaf of a snapshot is numpy or plain Python (no tensor that a
    pickle would tie to a device), for a guarded, codec-armed, reliable
    cohort job; the snapshot restores on the CPU to the same params."""
    create = {"id": 0, "request": "Create",
              "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                          "dataStructure": {"nFeatures": 5}},
              "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 2, "guard": True,
                                        "comm": {"codec": "topk", "reliable": True}}}
    job = StreamJob(JobConfig(parallelism=2, batch_size=32, test_set_size=32, cohort="on",
                              cohort_min=1), device="cpu")
    job.run([("requests", json.dumps(create))]
            + [("trainingData", l) for l in stream_lines(600)], terminate_on_end=False)
    assert job.spokes[0].nets[0].pipeline._cohort is not None
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    snapshot = _load(mgr.save(job))
    assert not _tensor_paths(snapshot)
    restored = mgr.restore()
    for a, b in zip(flats(job), flats(restored)):
        np.testing.assert_allclose(b, a, rtol=MERGE_RTOL)


def _storages(job):
    out = []
    for spoke in job.spokes:
        st = spoke.nets[0].pipeline.state
        leaves = list(st["params"].values()) + [t for s in st["preps"] for t in s.values()]
        out.append({t.untyped_storage().data_ptr() for t in leaves})
    return out


def test_workers_own_their_buffers_after_rescale(tmp_path):
    """A fit gives its state up (the sparse scatter writes in place), so no
    two workers may share a parameter tensor: not after a restore at
    another parallelism, not after a live grow."""
    create = {**CREATE, "preProcessors": [{"name": "StandardScaler"}]}
    job = StreamJob(JobConfig(parallelism=4, batch_size=32, test_set_size=32), device="cpu")
    job.run([("requests", json.dumps(create))]
            + [("trainingData", l) for l in stream_lines(900)], terminate_on_end=False)
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    mgr.save(job)
    for grown in (mgr.restore(parallelism=6), mgr.restore(parallelism=2)):
        ptrs = _storages(grown)
        assert all(not (a & b) for i, a in enumerate(ptrs) for b in ptrs[i + 1:])
    job.rescale(7)
    ptrs = _storages(job)
    assert all(not (a & b) for i, a in enumerate(ptrs) for b in ptrs[i + 1:])


def test_restore_wants_cuda_unless_asked_for_the_cpu(tmp_path, trained):
    """A manager with no device restores onto CUDA: without a card that
    raises, never falling back to the CPU; ``device="cpu"`` restores."""
    _, job = trained
    CheckpointManager(str(tmp_path / "ck"), device="cpu").save(job)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    if torch.cuda.is_available():
        assert mgr.restore().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            mgr.restore()
        with pytest.raises(RuntimeError, match="CUDA"):
            mgr.restore(device="cuda")
    assert mgr.restore(device="cpu").device.type == "cpu"
