"""Supervised recovery and fault injection: the port against the JAX package.

The cases of tests/test_recovery.py, each run on the JAX job and on the
port's job (``device="cpu"``) with the same seeded records and the same
injected faults. Tolerances:

- a recovered run against the unfaulted run of the same package:
  parameters rtol 1e-5, atol 1e-6 and the score within 1e-6 (the JAX
  suite's limits), integer statistics equal;
- the port against the JAX package after the same stream and faults:
  parameters rtol 2e-4, atol 2e-5, integer statistics and the failure
  records' offsets equal, the score within one holdout row;
- a bridge restore on one side: rtol 1e-6.
"""

import json
import pickle
import time

import numpy as np
import pytest

from omldm_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from omldm_tpu.config import JobConfig as JaxJobConfig
from omldm_tpu.runtime import StreamJob as JaxStreamJob
from omldm_tpu.runtime import recovery as jrecovery
from omldm_tpu_torch.checkpoint import CheckpointManager
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.runtime import StreamJob
from omldm_tpu_torch.runtime import recovery
from omldm_tpu_torch.runtime.recovery import (
    FaultInjector,
    InjectedFault,
    JobSupervisor,
    replayable,
    skip_events,
)

RTOL, ATOL = 2e-4, 2e-5
REC_RTOL, REC_ATOL = 1e-5, 1e-6
SIDES = ("jax", "port")


def stream_lines(n, dim=5, seed=0):
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


def make_events(n=1200, seed=0, create=CREATE):
    return [("requests", json.dumps(create))] + [
        ("trainingData", l) for l in stream_lines(n, seed=seed)]


def new_job(side, **kw):
    if side == "jax":
        return JaxStreamJob(JaxJobConfig(**kw))
    return StreamJob(JobConfig(**kw), device="cpu")


def checkpointed_job(side, tmp_path, **kw):
    cfg = dict(parallelism=kw.pop("parallelism", 2), batch_size=32, test_set_size=32,
               checkpointing=True, checkpoint_dir=str(tmp_path / side / "ck"),
               check_interval_ms=0)  # a save at every opportunity
    cfg.update(kw)
    return new_job(side, **cfg)


def api(side):
    return jrecovery if side == "jax" else recovery


def flat0(job):
    return job.spokes[0].nets[0].pipeline.get_flat_params()[0]


def assert_pair(results, rtol=RTOL, atol=ATOL):
    """``results``: {side: (job, report)}; the port's against the JAX's."""
    (jj, jr), (tj, tr) = results["jax"], results["port"]
    [js], [ts] = jr.statistics, tr.statistics
    assert (ts.fitted, ts.models_shipped, ts.bytes_shipped, ts.rescales_performed) == (
        js.fitted, js.models_shipped, js.bytes_shipped, js.rescales_performed)
    assert abs(ts.score - js.score) <= 1.0 / 32 + 1e-9
    np.testing.assert_allclose(flat0(tj), flat0(jj), rtol=rtol, atol=atol)
    return ts


class TestSupervisorRecovery:
    def test_transient_crash_recovers_and_finishes(self, tmp_path):
        events = make_events()
        results, offsets = {}, {}
        for side in SIDES:
            job = checkpointed_job(side, tmp_path)
            fault = api(side).FaultInjector()
            fault.arm(job, worker_id=0, after_records=300)
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            report = sup.run()
            assert fault.fired == 1 and len(sup.failures) == 1
            assert sup.failures[0].restored_from is not None
            assert sup.job.events_processed == len(events)
            results[side] = (sup.job, report)
            offsets[side] = (sup.failures[0].offset, sup.failures[0].kind)
        assert offsets["port"] == offsets["jax"]
        assert assert_pair(results).score > 0.8

    def test_recovery_matches_unfaulted_run_exactly(self, tmp_path):
        """The checkpoint holds the state at its offset and the routing
        cursor, so a recovered run fits the records a run that never
        crashed fits."""
        events = make_events(n=900)
        results = {}
        for side in SIDES:
            clean = checkpointed_job(side, tmp_path / "clean")
            clean_report = clean.run(list(events))
            job = checkpointed_job(side, tmp_path / "faulted")
            api(side).FaultInjector().arm(job, worker_id=1, after_records=200)
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            report = sup.run()
            [cs], [s] = clean_report.statistics, report.statistics
            assert s.fitted == cs.fitted
            assert s.score == pytest.approx(cs.score, abs=1e-6)
            np.testing.assert_allclose(flat0(sup.job), flat0(clean), rtol=REC_RTOL, atol=REC_ATOL)
            results[side] = (sup.job, report)
        assert_pair(results)

    def test_uncheckpointed_job_restarts_from_scratch(self, tmp_path):
        events = make_events(n=600)
        results = {}
        for side in SIDES:
            job = new_job(side, parallelism=2, batch_size=32, test_set_size=32)
            api(side).FaultInjector().arm(job, worker_id=0, after_records=150)
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            report = sup.run()
            assert sup.failures[0].restored_from is None
            assert sup.job.events_processed == len(events)
            results[side] = (sup.job, report)
        assert assert_pair(results).score > 0.8

    def test_poison_event_exhausts_restarts(self, tmp_path):
        """A fault re-armed on every incarnation crashes each attempt until
        max_restarts is spent (Flink semantics)."""
        events = make_events(n=2000)
        counts = {}
        for side in SIDES:
            job = checkpointed_job(side, tmp_path)
            mod = api(side)

            def arm(j, mod=mod):
                mod.FaultInjector().arm(j, worker_id=0, after_records=50)

            arm(job)
            sup = mod.JobSupervisor(job, mod.replayable(lambda: list(events)), max_restarts=2,
                                    on_failure=lambda rec, arm=arm: arm(sup.job))
            with pytest.raises(mod.InjectedFault):
                sup.run()
            counts[side] = [(f.offset, f.kind, f.restored_from is not None) for f in sup.failures]
        assert len(counts["port"]) == 3  # the first attempt and 2 restarts
        assert counts["port"] == counts["jax"]

    def test_failure_record_contents(self, tmp_path):
        events = make_events(n=400)
        records = {}
        for side in SIDES:
            job = checkpointed_job(side, tmp_path)
            api(side).FaultInjector().arm(job, worker_id=0, after_records=100)
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            sup.run()
            [rec] = sup.failures
            assert "InjectedFault" in rec.error and rec.offset > 0
            records[side] = (rec.offset, rec.error, rec.kind)
        assert records["port"] == records["jax"]


class TestOffsetTracking:
    def test_events_processed_counts_and_checkpoints(self, tmp_path):
        events = make_events(n=100)
        job = checkpointed_job("port", tmp_path)
        job.run(list(events), terminate_on_end=False)
        assert job.events_processed == len(events)
        restored = CheckpointManager(job.config.checkpoint_dir, device="cpu").restore()
        assert restored.events_processed == len(events)
        jax_job = checkpointed_job("jax", tmp_path)
        jax_job.run(list(events), terminate_on_end=False)
        assert JaxCheckpointManager(jax_job.config.checkpoint_dir).restore().events_processed == (
            restored.events_processed)

    def test_skip_events(self):
        evs = [("a", 1), ("b", 2), ("c", 3)]
        for mod in (recovery, jrecovery):
            assert list(mod.skip_events(evs, 2)) == [("c", 3)]
            assert list(mod.skip_events(evs, 5)) == []
        assert list(skip_events(iter(evs), 0)) == evs


CREATE_SPMD = {
    "id": 0,
    "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 1.0}},
    "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 2, "engine": "spmd",
                              "stageChain": 1},
}


@pytest.fixture
def eight_slots(monkeypatch):
    """The bridge's mesh as the JAX job's on conftest's 8 devices."""
    import omldm_tpu_torch.runtime.spmd_bridge as tb

    monkeypatch.setattr(tb, "device_slots", lambda device: 8)


def _bridge_pair(tmp_path, create=CREATE_SPMD, n=800):
    out = {}
    for side in SIDES:
        job = new_job(side, parallelism=2, batch_size=16, test_set_size=32)
        job.run(make_events(n=n, create=create), terminate_on_end=False)
        mgr = (JaxCheckpointManager(str(tmp_path / side)) if side == "jax"
               else CheckpointManager(str(tmp_path / side), device="cpu"))
        out[side] = (job, mgr)
    return out


class TestSPMDBridgeCheckpoint:
    def test_bridge_state_roundtrip(self, tmp_path, eight_slots):
        """Fleet state, holdout, stage and progress counters survive a
        save and restore on the same mesh."""
        pairs = _bridge_pair(tmp_path)
        restored = {}
        for side, (job, mgr) in pairs.items():
            mgr.save(job)
            r = mgr.restore()
            bridge, rbridge = job.spmd_bridges[0], r.spmd_bridges[0]
            np.testing.assert_allclose(rbridge.trainer.global_flat_params(),
                                       bridge.trainer.global_flat_params(), rtol=1e-6)
            assert rbridge.trainer.fitted == bridge.trainer.fitted
            assert rbridge.holdout_count == bridge.holdout_count
            assert len(rbridge.test_set) == len(bridge.test_set)
            assert rbridge._stage_n == bridge._stage_n
            restored[side] = rbridge
        j, t = restored["jax"], restored["port"]
        assert (t.trainer.fitted, t.holdout_count, t._stage_n, t.trainer.dp) == (
            j.trainer.fitted, j.holdout_count, j._stage_n, j.trainer.dp)
        np.testing.assert_allclose(t.trainer.global_flat_params(), j.trainer.global_flat_params(),
                                   rtol=RTOL, atol=ATOL)

    def test_bridge_continues_training_after_restore(self, tmp_path, eight_slots):
        pairs = _bridge_pair(tmp_path)
        stats = {}
        for side, (job, mgr) in pairs.items():
            mgr.save(job)
            report = mgr.restore().run(
                [("trainingData", l) for l in stream_lines(800, seed=1)])
            [s] = report.statistics
            assert s.score > 0.8 and s.fitted > job.spmd_bridges[0].trainer.fitted
            stats[side] = s
        assert stats["port"].fitted == stats["jax"].fitted
        assert abs(stats["port"].score - stats["jax"].score) <= 1.0 / 32 + 1e-9

    def test_supervised_recovery_with_spmd_bridge(self, tmp_path, eight_slots):
        """Crash and restore through the supervisor with the pipeline on the
        SPMD engine: the bridge resumes from the checkpointed fleet."""
        events = make_events(n=1000, create=CREATE_SPMD)
        stats = {}
        for side in SIDES:
            job = checkpointed_job(side, tmp_path, batch_size=16)
            fault = api(side).FaultInjector()
            # records still route through the host spokes round-robin, so a
            # spoke trip-wire models a worker crash mid-stream
            fault.arm(job, worker_id=0, after_records=120)
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            [s] = sup.run().statistics
            assert fault.fired == 1 and sup.failures[0].restored_from is not None
            assert s.score > 0.8
            stats[side] = s
        assert stats["port"].fitted == stats["jax"].fitted

    def test_rescale_restore_merges_diverged_replicas(self, tmp_path, eight_slots):
        """Restoring under another mesh seeds every replica from the MEAN of
        the saved dp replicas (Asynchronous, long rounds: the snapshot lands
        mid-round, so the replicas differ)."""
        create = {**CREATE_SPMD, "trainingConfiguration": {
            "protocol": "Asynchronous", "syncEvery": 8, "engine": "spmd", "stageChain": 1}}
        pairs = _bridge_pair(tmp_path, create=create, n=500)
        got = {}
        for side, (job, mgr) in pairs.items():
            job.spmd_bridges[0].flush()  # staged rows would retrain on restore
            with open(mgr.save(job), "rb") as f:
                snapshot = pickle.load(f)
            saved = np.asarray(snapshot["bridges"][0]["fleet"]["params"]["w"])  # [dp, hub, D]
            assert saved.shape[0] == 2
            assert not np.allclose(saved[0, 0], saved[1, 0])
            restored = mgr.restore(parallelism=1)
            t = restored.spmd_bridges[0].trainer
            w = np.asarray(t.shard_params()[0]["w"]) if side == "port" else np.asarray(
                t.state["params"]["w"])[0, 0]
            np.testing.assert_allclose(w, saved[:, 0].mean(axis=0), rtol=1e-6, atol=1e-7)
            got[side] = w
        np.testing.assert_allclose(got["port"], got["jax"], rtol=RTOL, atol=ATOL)


class TestCentralModelRescaleRestore:
    def test_rescale_restore_keeps_hub_model(self, tmp_path):
        """SingleLearner: the model lives on the hub; a restore at another
        parallelism still carries it."""
        create = {**CREATE, "trainingConfiguration": {"protocol": "SingleLearner"}}
        weights = {}
        for side in SIDES:
            job = new_job(side, parallelism=2, batch_size=32, test_set_size=32)
            job.run(make_events(n=600, create=create), terminate_on_end=False)
            central = job.hub_manager.hubs[(0, 0)].node.pipeline
            w_before, _ = central.get_flat_params()
            assert central.fitted > 0
            mgr = (JaxCheckpointManager(str(tmp_path / side)) if side == "jax"
                   else CheckpointManager(str(tmp_path / side), device="cpu"))
            mgr.save(job)
            rcentral = mgr.restore(parallelism=4).hub_manager.hubs[(0, 0)].node.pipeline
            w_after, _ = rcentral.get_flat_params()
            np.testing.assert_allclose(w_after, w_before, rtol=1e-6)
            assert rcentral.fitted == central.fitted
            weights[side] = (w_after, rcentral.fitted)
        np.testing.assert_allclose(weights["port"][0], weights["jax"][0], rtol=RTOL, atol=ATOL)
        assert weights["port"][1] == weights["jax"][1]


class TestStaleCheckpointGuard:
    def test_supervisor_ignores_preexisting_checkpoint(self, tmp_path):
        """A snapshot an earlier run left in a reused directory is never
        restored: it would skip (and mask) nearly the whole new stream."""
        events = make_events(n=600)
        results = {}
        for side in SIDES:
            checkpointed_job(side, tmp_path).run(list(events), terminate_on_end=False)
            job = checkpointed_job(side, tmp_path, check_interval_ms=10_000_000)
            job.checkpoint_manager._last_save = time.time()  # arm the interval
            api(side).FaultInjector().arm(job, worker_id=0, after_records=50)
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            report = sup.run()
            assert sup.failures[0].restored_from is None
            assert sup.job.events_processed == len(events)
            results[side] = (sup.job, report)
        assert assert_pair(results).score > 0.8


class TestCLIRecoveryFlags:
    def test_restart_attempts_flag_supervises(self, tmp_path, monkeypatch):
        """--restartAttempts routes the file replay through the supervisor;
        a fault in the first incarnation recovers from the checkpoint."""
        from omldm_tpu_torch.__main__ import main

        train = tmp_path / "train.jsonl"
        train.write_text("\n".join(stream_lines(400)) + "\n")
        reqs = tmp_path / "reqs.jsonl"
        reqs.write_text(json.dumps(CREATE) + "\n")
        calls = {"n": 0, "sup": None}
        orig_run, orig_init = JobSupervisor.run, JobSupervisor.__init__

        def spy_init(self, job, *a, **kw):
            orig_init(self, job, *a, **kw)
            FaultInjector().arm(job, worker_id=1, after_records=60)
            calls["sup"] = self

        def spy_run(self, *a, **kw):
            calls["n"] += 1
            return orig_run(self, *a, **kw)

        monkeypatch.setattr(recovery.JobSupervisor, "__init__", spy_init)
        monkeypatch.setattr(recovery.JobSupervisor, "run", spy_run)
        outs = {}
        for name, extra in (("faulted", ["--restartAttempts", "2", "--checkpointing", "true",
                                         "--stateBackend", str(tmp_path / "ck"),
                                         "--checkInterval", "0"]),
                            ("clean", [])):
            perf = tmp_path / f"perf_{name}.jsonl"
            rc = main(["--trainingData", str(train), "--requests", str(reqs), "--device", "cpu",
                       "--parallelism", "2", "--performanceOut", str(perf), *extra])
            assert rc == 0
            outs[name] = json.loads(perf.read_text().strip().splitlines()[-1])
        assert calls["n"] == 1
        [failure] = calls["sup"].failures
        assert failure.restored_from is not None
        faulted, clean = outs["faulted"]["statistics"][0], outs["clean"]["statistics"][0]
        assert faulted["fitted"] == clean["fitted"] > 0


class TestRescaleRecoveryInterplay:
    def test_recover_after_live_rescale_restores_new_parallelism(self, tmp_path):
        """A live rescale changes config.parallelism; a checkpoint after it
        restores the rescaled worker count and trains on through recovery."""
        events = make_events(n=1200)
        results = {}
        for side in SIDES:
            job = checkpointed_job(side, tmp_path, parallelism=2)
            # the stale-snapshot floor is taken at construction: build the
            # supervisor before the post-rescale checkpoint
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            job.run(list(events)[:600], terminate_on_end=False)
            job.rescale(4)
            assert len(job.spokes) == 4
            job.checkpoint_manager.maybe_save(job)
            fault = api(side).FaultInjector()
            fault.arm(job, worker_id=3, after_records=30)
            report = sup.run()
            assert fault.fired == 1 and sup.failures[0].restored_from is not None
            assert len(sup.job.spokes) == sup.job.config.parallelism == 4
            assert sup.job.events_processed == len(events)
            results[side] = (sup.job, report)
        stats = assert_pair(results)
        assert stats.score > 0.8 and stats.rescales_performed == 1


class TestSparseCheckpointRecovery:
    HASH_SPACE = 1 << 12
    DIM = 3 + HASH_SPACE

    def _create(self):
        return {
            "id": 0,
            "request": "Create",
            "learner": {"name": "PA", "hyperParameters": {"C": 1.0, "variant": "PA-II"},
                        "dataStructure": {"sparse": True, "nFeatures": self.DIM,
                                          "hashSpace": self.HASH_SPACE, "maxNnz": 8}},
            "preProcessors": [],
            "trainingConfiguration": {"protocol": "Synchronous"},
        }

    def _lines(self, n, seed=0):
        rng = np.random.RandomState(seed)
        hidden = {}
        lines = []
        for _ in range(n):
            num = rng.randn(3)
            cats = [f"c{rng.randint(30)}", f"d{rng.randint(30)}"]
            m = float(num.sum())
            for i, c in enumerate(cats):
                if (i, c) not in hidden:
                    hidden[(i, c)] = rng.randn() * 2.0
                m += hidden[(i, c)]
            lines.append(json.dumps({
                "numericalFeatures": [round(float(v), 5) for v in num],
                "categoricalFeatures": cats, "target": float(m > 0)}))
        return lines

    def test_sparse_job_checkpoints_and_recovers(self, tmp_path):
        """A sparse (padded-COO) pipeline checkpoints -- pending rows of the
        sparse batcher included -- and recovers through the supervisor."""
        events = [("requests", json.dumps(self._create()))] + [
            ("trainingData", l) for l in self._lines(1800)]
        results = {}
        for side in SIDES:
            job = checkpointed_job(side, tmp_path, batch_size=64)
            fault = api(side).FaultInjector()
            fault.arm(job, worker_id=0, after_records=400)
            sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
            report = sup.run()
            assert fault.fired == 1 and sup.failures[0].restored_from is not None
            [s] = report.statistics
            assert s.fitted > 1200 and s.score > 0.6
            results[side] = (sup.job, report)
        assert_pair(results)

    def test_sparse_pending_rows_survive_roundtrip(self, tmp_path):
        events = [("requests", json.dumps(self._create()))] + [
            ("trainingData", l) for l in self._lines(30)]
        pending = {}
        for side in SIDES:
            job = new_job(side, parallelism=1, batch_size=64, test_set_size=16)
            job.run(events, terminate_on_end=False)
            net = job.spokes[0].nets[0]
            assert len(net.batcher) > 0  # far fewer than one batch: rows pending
            mgr = (JaxCheckpointManager(str(tmp_path / side)) if side == "jax"
                   else CheckpointManager(str(tmp_path / side), device="cpu"))
            mgr.save(job)
            rnet = mgr.restore().spokes[0].nets[0]
            assert len(rnet.batcher) == len(net.batcher)
            np.testing.assert_array_equal(rnet.batcher._idx, net.batcher._idx)
            # a rescale restore re-feeds the sparse rows too
            grown = mgr.restore(parallelism=2)
            pending[side] = (rnet.batcher._idx.copy(), rnet.batcher._val.copy(),
                             [len(s.nets[0].batcher) for s in grown.spokes])
        np.testing.assert_array_equal(pending["port"][0], pending["jax"][0])
        np.testing.assert_array_equal(pending["port"][1], pending["jax"][1])
        assert pending["port"][2] == pending["jax"][2]


def test_supervisor_restores_on_the_failed_jobs_device(tmp_path):
    """The next incarnation runs on the failed job's device, the manager
    the job built carries it, and an injected crash surfaces as
    InjectedFault."""
    job = checkpointed_job("port", tmp_path)
    assert str(job.checkpoint_manager.device) == "cpu"
    events = make_events(n=300)
    FaultInjector().arm(job, worker_id=0, after_records=40)
    with pytest.raises(InjectedFault):
        job.run(list(events), terminate_on_end=False)
    nxt, path = recovery.recover_job(job)
    assert path is not None and nxt.device.type == "cpu"
    assert nxt.events_processed == CheckpointManager(
        job.config.checkpoint_dir, device="cpu").restore().events_processed
    report = JobSupervisor(nxt, replayable(lambda: list(events))).run()
    assert report.statistics[0].fitted > 0


def test_recovery_loses_what_the_jax_snapshot_loses(tmp_path):
    """Neither package's snapshot carries the spoke-side tallies nor the
    learning-curve points of the fits since a worker's last push: a
    recovered run reports a shorter learning curve and fewer
    bytesShipped than the unfaulted run, and the port loses exactly what
    the JAX package loses."""
    create = {**CREATE, "trainingConfiguration": {"protocol": "Asynchronous", "syncEvery": 8}}
    events = make_events(n=1500, create=create)
    out = {}
    for side in SIDES:
        kw = dict(parallelism=4, batch_size=64, test_set_size=32)
        [clean] = new_job(side, **kw).run(list(events)).statistics
        job = checkpointed_job(side, tmp_path, **kw)
        api(side).FaultInjector().arm(job, worker_id=1, after_records=300)
        sup = api(side).JobSupervisor(job, api(side).replayable(lambda: list(events)))
        [rec] = sup.run().statistics
        assert rec.fitted == clean.fitted
        assert len(rec.learning_curve) < len(clean.learning_curve)
        assert rec.bytes_shipped < clean.bytes_shipped
        out[side] = (sup.failures[0].offset, clean.bytes_shipped, rec.bytes_shipped,
                     len(clean.learning_curve), len(rec.learning_curve),
                     clean.program_launches - rec.program_launches)
    assert out["port"] == out["jax"]
