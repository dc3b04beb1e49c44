"""The fleet's recovery half in one process, held against the JAX package.

- the pure helpers (the rescale shard map, the fleet-leaf redistribution,
  the cursor merge, the round-robin interleave) against their JAX twins on
  the same numpy inputs, with exact equality;
- the JAX cases of ``tests/test_selfheal.py`` (checkpoint integrity, the
  hang watchdog in its deterministic ``thread=False`` form, the fault
  injector, dropped-write counters) and of ``tests/test_rescale_restore.py``
  (a fabricated 2-process snapshot restored in one process) on the port's
  ``DistributedStreamJob(device="cpu")``;
- the snapshot layout across packages: the JAX job in this process sees
  conftest's 8 CPU devices, so the port's mesh is given 8 slots too
  (``multihost.device_slots`` patched) and both fleets hold 8 workers; a
  snapshot of either restores in the other, and the restored jobs train
  on to the same state (parameters rtol 2e-4, atol 2e-5; every counter
  equal).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.parallel import multihost
from omldm_tpu_torch.pipelines.pipeline import _leaves
from omldm_tpu_torch.runtime import distributed_job as dj
from omldm_tpu_torch.runtime.distributed_job import (
    DistributedStreamJob,
    _file_sha256,
    _heartbeat,
    _interleave_perm,
    _interleave_rows,
    _merge_cursors,
    _rescale_fleet_leaf,
    rescale_shard_map,
)
from omldm_tpu_torch.runtime.selfheal import HANG_EXIT, HangWatchdog
from omldm_tpu_torch.runtime.supervisor import RESCALE_EXIT, DistributedFaultInjector

RTOL, ATOL = 2e-4, 2e-5
DIM = 6
STATE_KEYS = ("params", "preps", "est", "center", "step", "syncs", "cum_loss", "clock",
              "accepted", "fold_rounds", "ef")
CREATE = json.dumps({
    "id": 0, "request": "Create",
    "learner": {"name": "PA", "hyperParameters": {"C": 1.0},
                "dataStructure": {"nFeatures": DIM}},
    "preProcessors": [],
    "trainingConfiguration": {"protocol": "Synchronous", "syncEvery": 1},
})


def _jax_dj():
    pytest.importorskip("jax")
    from omldm_tpu.runtime import distributed_job

    return distributed_job


# --- the pure helpers against their JAX twins --------------------------------


@pytest.mark.parametrize("old_n", range(1, 7))
def test_shard_map_matches_jax(old_n):
    jdj = _jax_dj()
    for new_n in range(1, 7):
        owned = []
        for pid in range(new_n):
            got = rescale_shard_map(old_n, new_n, pid)
            assert got == jdj.rescale_shard_map(old_n, new_n, pid)
            owned += got
        assert sorted(owned) == list(range(old_n))  # every old shard owned once


@pytest.mark.parametrize("key", STATE_KEYS)
@pytest.mark.parametrize("dp_old,dp_new", [(4, 6), (4, 2), (3, 2), (4, 4), (1, 3), (6, 1)])
def test_rescale_fleet_leaf_matches_jax(key, dp_old, dp_new):
    jdj = _jax_dj()
    rng = np.random.RandomState(dp_old * 10 + dp_new)
    for full in (rng.randn(dp_old, 1, 5).astype(np.float32),
                 rng.randint(0, 100, size=(dp_old, 1)).astype(np.int32)):
        got = _rescale_fleet_leaf(full, key, dp_new)
        want = jdj._rescale_fleet_leaf(full, key, dp_new)
        assert got.shape == want.shape == (dp_new,) + full.shape[1:]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cursors", [
    [300, 300],
    [{"bytes": 10, "lines": 4}, {"bytes": 10, "lines": 4}],
    [{"data": {"t:0": 5, "t:1": 2}, "requests": {}},
     {"data": {"t:1": 7, "t:2": 3}, "requests": {"r:0": 4}}],
    [],
    [None, 7],
])
def test_merge_cursors_matches_jax(cursors):
    assert _merge_cursors(cursors) == _jax_dj()._merge_cursors(cursors)


@pytest.mark.parametrize("lengths", [[2, 3], [0, 2], [], [4, 1, 3], [5]])
def test_interleave_matches_jax(lengths):
    jdj = _jax_dj()
    assert _interleave_perm(lengths) == jdj._interleave_perm(lengths)
    if lengths:
        blocks = [np.full((n, 2), i, np.float32) for i, n in enumerate(lengths)]
        np.testing.assert_array_equal(_interleave_rows(blocks), jdj._interleave_rows(blocks))


def test_exit_codes_distinct():
    assert HANG_EXIT not in (0, RESCALE_EXIT, DistributedFaultInjector.EXIT_CODE)
    assert RESCALE_EXIT == 17 and HANG_EXIT == 19


# --- the hang watchdog (deterministic form) ------------------------------------


class TestHangWatchdog:
    def _wd(self, timeout=10.0, warmup=None):
        fired = []
        wd = HangWatchdog(timeout, fired.append, warmup_s=warmup, clock=lambda: self.now,
                          thread=False)
        return wd, fired

    def test_unarmed_never_fires(self):
        self.now = 0.0
        wd, fired = self._wd()
        self.now = 1e9
        assert not wd.check()
        assert fired == []

    def test_guard_deadline_fires_once(self):
        self.now = 0.0
        wd, fired = self._wd(timeout=10.0, warmup=10.0)
        with wd.guard("pump"):
            self.now = 9.0
            assert not wd.check()
            self.now = 11.0
            assert wd.check()
            assert not wd.check()  # fire-once
        assert fired == ["pump"]

    def test_exit_disarms(self):
        self.now = 0.0
        wd, fired = self._wd(timeout=5.0, warmup=5.0)
        with wd.guard("pump"):
            pass
        self.now = 100.0
        assert not wd.check()
        assert fired == []

    def test_reentrant_refresh(self):
        self.now = 0.0
        wd, fired = self._wd(timeout=5.0, warmup=5.0)
        with wd.guard("pump"):
            for _ in range(10):
                self.now += 4.0
                with wd.guard("reduce"):  # progress refreshes the deadline
                    pass
                assert not wd.check()
            # inner exits must NOT disarm the outer guard
            self.now += 6.0
            assert wd.check()
        assert len(fired) == 1

    def test_warmup_allowance_first_entry_per_phase(self):
        self.now = 0.0
        wd, fired = self._wd(timeout=5.0, warmup=60.0)
        with wd.guard("pump"):  # first entry: the warm-up allowance
            self.now = 50.0
            assert not wd.check()
        with wd.guard("pump"):  # warmed: the normal timeout
            self.now = 56.0
            assert wd.check()
        assert fired == ["pump"]

    def test_rewarm_regrants_the_allowance(self):
        self.now = 0.0
        wd, fired = self._wd(timeout=5.0, warmup=60.0)
        with wd.guard("pump"):
            pass
        wd.rewarm()
        with wd.guard("pump"):
            self.now = 50.0
            assert not wd.check()
        assert fired == []

    def test_threaded_fires_for_real(self):
        import threading

        fired = threading.Event()
        wd = HangWatchdog(0.05, lambda phase: fired.set(), warmup_s=0.05, poll_s=0.01)
        try:
            with wd.guard("pump"):
                assert fired.wait(2.0)
        finally:
            wd.stop()

    def test_validation(self):
        with pytest.raises(ValueError):
            HangWatchdog(0.0, lambda p: None, thread=False)


# --- the fault injector ---------------------------------------------------------


class TestInjectorFaults:
    def test_hang_sigstops_once_across_incarnations(self, tmp_path, monkeypatch):
        stops = []
        monkeypatch.setattr("omldm_tpu_torch.runtime.selfheal.sigstop_self",
                            lambda: stops.append(True))
        flags = {"hangProcess": "1", "hangAfterChunks": "3",
                 "faultStateDir": str(tmp_path / "fault")}
        inj = DistributedFaultInjector(flags, pid=1)
        inj.on_chunk(1)
        assert stops == []
        inj.on_chunk(2)  # chunk_idx + 1 == 3: fires
        assert stops == [True]
        # a relaunched incarnation re-runs the injector: the marker file
        # keeps the hang one-shot
        DistributedFaultInjector(flags, pid=1).on_chunk(5)
        assert stops == [True]

    def test_hang_other_process_inert(self, monkeypatch):
        stops = []
        monkeypatch.setattr("omldm_tpu_torch.runtime.selfheal.sigstop_self",
                            lambda: stops.append(True))
        DistributedFaultInjector({"hangProcess": "1", "hangAfterChunks": "1"},
                                 pid=0).on_chunk(5)
        assert stops == []

    def test_launch_refusal_counts_down(self, tmp_path, monkeypatch):
        died = []
        monkeypatch.setattr(DistributedFaultInjector, "_die",
                            lambda self, why: died.append(why))
        flags = {"refuseLaunchProcess": "0", "refuseLaunchCount": "2",
                 "faultStateDir": str(tmp_path / "fault")}
        for _ in range(3):
            DistributedFaultInjector(flags, pid=0).on_launch()
        assert len(died) == 2  # the third incarnation launches fine
        DistributedFaultInjector(flags, pid=1).on_launch()
        assert len(died) == 2  # other slots unaffected

    def test_fail_after_records_and_chunks(self, monkeypatch):
        died = []
        monkeypatch.setattr(DistributedFaultInjector, "_die",
                            lambda self, why: died.append(why))
        inj = DistributedFaultInjector({"failProcess": "0", "failAfterRecords": "10"}, pid=0)
        inj.note_records(9)
        inj.on_chunk(0)
        assert died == []
        inj.note_records(1)
        inj.on_chunk(1)
        assert died == ["worker 0 after 10 records"]
        DistributedFaultInjector({"failAfterChunks": "3"}, pid=1).on_chunk(2)
        assert died[-1] == "after chunk 3 (all processes)"

    @pytest.mark.parametrize("mode", ["truncate", "withhold"])
    def test_corrupt_shard_one_shot(self, tmp_path, mode):
        d = tmp_path / "ckpt-1"
        d.mkdir()
        (d / "proc1.npz").write_bytes(b"x" * 100)
        inj = DistributedFaultInjector({"corruptShardProcess": "1", "corruptShardSeq": "1",
                                        "corruptShardMode": mode}, pid=1)
        inj.on_checkpoint(str(tmp_path / "ckpt-0"))  # another seq: untouched
        assert (d / "proc1.npz").stat().st_size == 100
        inj.on_checkpoint(str(d))
        if mode == "withhold":
            assert not (d / "proc1.npz").exists()
        else:
            assert (d / "proc1.npz").stat().st_size == 50


# --- dropped-write counters ------------------------------------------------------


class TestDroppedWriteCounters:
    def test_blackbox_dump_counts_not_raises(self, tmp_path):
        from omldm_tpu_torch.runtime.events import EventJournal

        blocker = tmp_path / "file"
        blocker.write_text("x")
        # the "directory" is a plain file: every dump gets OSError
        j = EventJournal(cap=8, pid=0, path=str(blocker / "sub"))
        j.record("terminate", "x")
        assert j.dump() is None
        assert j.dump() is None
        assert j.write_errors == 2
        assert j.events  # ring intact

    def test_deadletter_counts_not_raises(self, tmp_path):
        from omldm_tpu_torch.runtime.deadletter import DeadLetterSink

        blocker = tmp_path / "file"
        blocker.write_text("x")
        sink = DeadLetterSink(path=str(blocker / "sub" / "dl.jsonl"))
        sink.quarantine("training", "{bad", "malformed_json")
        sink.quarantine("training", "{bad2", "malformed_json")
        assert sink.write_errors == 1  # degrades once, loudly
        assert sink.record_count == 2  # the in-memory quarantine continues

    def test_heartbeat_returns_false_not_raises(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("x")
        assert _heartbeat({"heartbeatDir": str(blocker / "sub")}, 0, 1) is False
        assert _heartbeat({}, 0, 1) is True  # unarmed: trivially fine
        ok_dir = tmp_path / "hb"
        assert _heartbeat({"heartbeatDir": str(ok_dir)}, 0, 1) is True

    def test_heartbeat_frame_matches_jax(self, tmp_path):
        jdj = _jax_dj()
        frame = {"level": 2, "serveP99": 1.5, "imbalance": 0.0, "backlog": 7, "events": 3,
                 "alerts": 0}
        _heartbeat({"heartbeatDir": str(tmp_path / "port")}, 1, frame)
        jdj._heartbeat({"heartbeatDir": str(tmp_path / "jax")}, 1, frame)
        port = (tmp_path / "port" / "proc1.hb").read_text().split(" ", 1)
        ref = (tmp_path / "jax" / "proc1.hb").read_text().split(" ", 1)
        assert port[1] == ref[1] == "2 serveP99=1.5 imbalance=0.0 backlog=7 events=3 alerts=0"


# --- checkpoint integrity (sha256 + generation fallback) -------------------------


def _job(**config):
    job = DistributedStreamJob(JobConfig(batch_size=8, test_set_size=16, **config),
                               device="cpu")
    job.sync_requests([CREATE])
    rng = np.random.RandomState(0)
    x = rng.randn(64, DIM).astype(np.float32)
    job.handle_partition_rows(x, (x[:, 0] > 0).astype(np.float32))
    job.pump()
    return job


class TestCheckpointIntegrity:
    def test_digests_recorded(self, tmp_path):
        d = _job().save_checkpoint(str(tmp_path), 100)
        manifest = json.load(open(os.path.join(d, "manifest.json")))
        assert manifest["digests"]["fleet_0.npz"] == _file_sha256(os.path.join(d, "fleet_0.npz"))
        meta = json.load(open(os.path.join(d, "proc0.json")))
        assert meta["sha256"] == _file_sha256(os.path.join(d, "proc0.npz"))
        assert (manifest["seq"], manifest["processes"], manifest["dp_global"]) == (0, 1, 1)
        assert manifest["request_lines"] == [CREATE]
        assert open(os.path.join(str(tmp_path), "LATEST")).read() == "ckpt-0"

    def test_digest_mismatch_rejected(self, tmp_path, capsys):
        job = _job(events="on")
        d = job.save_checkpoint(str(tmp_path), 100)
        # same-length corruption: np.load may well decode this fine; only
        # the digest catches it
        path = os.path.join(d, "fleet_0.npz")
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
        assert job._validate_checkpoint(d) is None
        assert "sha256 mismatch" in capsys.readouterr().err
        [rejected] = [e for e in job.events.tail() if e["kind"] == "restore"]
        assert rejected["cause"] == "candidate_rejected"

    def test_corrupt_generation_falls_back_to_previous(self, tmp_path):
        job = _job()
        job.save_checkpoint(str(tmp_path), 100)
        d2 = job.save_checkpoint(str(tmp_path), 200)
        path = os.path.join(d2, "proc0.npz")
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
        restored = _job()
        assert restored.restore_checkpoint(str(tmp_path)) == 100  # the previous generation
        assert restored.pipelines  # pipelines redeployed from it
        # LATEST repointed, the unusable generation pruned
        assert open(os.path.join(str(tmp_path), "LATEST")).read() == "ckpt-0"
        assert not os.path.exists(d2)

    def test_predigest_snapshots_still_restore(self, tmp_path):
        d = _job().save_checkpoint(str(tmp_path), 100)
        # strip the digests (an old-format snapshot): the load checks remain
        manifest = json.load(open(os.path.join(d, "manifest.json")))
        manifest.pop("digests")
        json.dump(manifest, open(os.path.join(d, "manifest.json"), "w"))
        meta = json.load(open(os.path.join(d, "proc0.json")))
        meta.pop("sha256")
        json.dump(meta, open(os.path.join(d, "proc0.json"), "w"))
        assert _job().restore_checkpoint(str(tmp_path)) == 100

    def test_retention_keeps_checkpoint_keep(self, tmp_path):
        job = _job(checkpoint_keep=2)
        for cur in range(4):
            job.save_checkpoint(str(tmp_path), cur)
        assert sorted(os.listdir(tmp_path)) == ["LATEST", "ckpt-2", "ckpt-3"]


# --- a fabricated 2-process snapshot restored in one process -----------------------


def _one_proc_job(test_cap=16, **config):
    job = DistributedStreamJob(JobConfig(batch_size=8, test_set_size=test_cap, **config),
                               device="cpu")
    job.sync_requests([CREATE])
    return job


def _feed(job, n=200, seed=0):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(5).randn(DIM)
    x = rng.randn(n, DIM).astype(np.float32)
    job.handle_partition_rows(x, (x @ w > 0).astype(np.float32))
    return x


def _fabricate_two_proc_snapshot(d, scale_row1=1.5, preds1=(9.0,)):
    """The JAX test's fabrication: fleet leaves gain a second worker row
    (float leaves scaled so merges are detectable), proc1 duplicates proc0's
    shard with marker predictions."""
    fleet = dict(np.load(os.path.join(d, "fleet_0.npz")))
    for k, leaf in fleet.items():
        row1 = leaf * scale_row1 if leaf.dtype.kind == "f" else leaf.copy()
        fleet[k] = np.concatenate([leaf, row1], axis=0)
    np.savez(os.path.join(d, "fleet_0.npz"), **fleet)
    with open(os.path.join(d, "proc0.json")) as f:
        meta1 = json.load(f)
    meta1["pipelines"]["0"]["predictions"] = list(preds1)
    with open(os.path.join(d, "proc1.json"), "w") as f:
        json.dump(meta1, f)
    shutil.copy(os.path.join(d, "proc0.npz"), os.path.join(d, "proc1.npz"))
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["processes"] = 2
    manifest["dp_global"] = 2
    manifest["digests"]["fleet_0.npz"] = _file_sha256(os.path.join(d, "fleet_0.npz"))
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _params(job, net_id=0):
    return np.concatenate([t.reshape(t.shape[0], -1).numpy() for t in
                           _leaves(job.pipelines[net_id].trainer.state["params"])], axis=1)


class TestShrinkRestoreInProcess:
    def test_two_proc_snapshot_restores_in_one(self, tmp_path):
        job = _one_proc_job()
        _feed(job)
        job.handle_forecast_rows(np.zeros((3, DIM), np.float32))
        job.pump()
        root = str(tmp_path / "ck")
        d = job.save_checkpoint(root, 200)
        base_params = _params(job)
        base = job.pipelines[0]
        _fabricate_two_proc_snapshot(d)

        restored = _one_proc_job(events="on")
        assert restored.restore_checkpoint(root) == 200
        assert restored.rescales_performed == 1
        assert [e["cause"] for e in restored.events.tail() if e["kind"] == "restore"] == [
            "rescale_redistribution"]
        p = restored.pipelines[0]
        # partition counters SUM across the merged shards
        assert p.holdout_count == 2 * base.holdout_count
        assert p.trainer._fitted_host == 2 * base.trainer._fitted_host
        assert 9.0 in p.predictions  # both shards' predictions survive
        # params = mean(row0, 1.5 * row0) = 1.25 * row0: the group-mean merge
        np.testing.assert_allclose(_params(restored), 1.25 * base_params, atol=1e-6)
        assert p.raw_line == base.raw_line  # the request line redeployed as it was
        # the restored fleet trains and checkpoints again
        _feed(restored, n=40, seed=1)
        restored.pump(final=True)
        restored.save_checkpoint(root, 240)
        merged = restored.merged_report()
        assert merged["rescalesPerformed"] == 1
        assert merged["statistics"][0]["rescalesPerformed"] == 1

    def test_holdout_overflow_refeeds_training(self, tmp_path):
        """Two full 16-row holdout rings merge into one: the 16 evicted
        rows land back in the pending training buffer."""
        job = _one_proc_job(test_cap=16)
        _feed(job)
        job.pump(final=True)
        root = str(tmp_path / "ck")
        _fabricate_two_proc_snapshot(job.save_checkpoint(root, 200))

        restored = _one_proc_job(test_cap=16)
        restored.restore_checkpoint(root)
        p = restored.pipelines[0]
        assert len(p.test_set) == 16
        assert p.pend_n >= 16

    def test_rescale_restore_disabled_warns_with_knob(self, tmp_path, capsys):
        job = _one_proc_job()
        _feed(job)
        job.pump()
        root = str(tmp_path / "ck")
        _fabricate_two_proc_snapshot(job.save_checkpoint(root, 200))

        restored = DistributedStreamJob(JobConfig(batch_size=8, test_set_size=16, events="on"),
                                        device="cpu")
        restored.rescale_restore = False
        assert restored.restore_checkpoint(root) is None
        err = capsys.readouterr().err
        assert restored.pipelines == {}
        assert "--rescaleRestore" in err and "starting fresh" in err
        assert restored.rescales_performed == 0
        assert [e["cause"] for e in restored.events.tail()] == ["rescale_restore_disabled"]

    def test_same_count_restore_unchanged(self, tmp_path):
        job = _one_proc_job()
        _feed(job)
        job.pump()
        root = str(tmp_path / "ck")
        job.save_checkpoint(root, 200)
        restored = _one_proc_job()
        assert restored.restore_checkpoint(root) == 200
        assert restored.rescales_performed == 0
        np.testing.assert_array_equal(_params(restored), _params(job))
        for key in ("step", "syncs", "clock", "cum_loss"):
            assert torch.equal(restored.pipelines[0].trainer.state[key],
                               job.pipelines[0].trainer.state[key])

    def test_supervisor_pinned_count_not_double_counted(self, tmp_path):
        job = _one_proc_job()
        _feed(job)
        job.pump()
        root = str(tmp_path / "ck")
        _fabricate_two_proc_snapshot(job.save_checkpoint(root, 200))
        restored = _one_proc_job()
        restored.rescales_performed = 3
        restored._rescale_count_pinned = True
        restored.restore_checkpoint(root)
        assert restored.rescales_performed == 3

    def test_no_usable_snapshot_records_the_cause(self, tmp_path):
        job = _one_proc_job()
        root = str(tmp_path / "ck")
        d = job.save_checkpoint(root, 10)
        os.unlink(os.path.join(d, "proc0.npz"))
        restored = DistributedStreamJob(JobConfig(events="on"), device="cpu")
        assert restored.restore_checkpoint(root) is None
        assert [e["cause"] for e in restored.events.tail()] == [
            "candidate_rejected", "no_usable_snapshot"]


# --- snapshots across packages (8 workers each) --------------------------------------


ROWS = 640


def _stream(seed=3):
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    x = rng.randn(ROWS, DIM).astype(np.float32)
    return x, (x @ w > 0).astype(np.float32)


def _jax_job():
    jdj = _jax_dj()
    from omldm_tpu.config import JobConfig as JaxConfig

    job = jdj.DistributedStreamJob(JaxConfig(batch_size=8, test_set_size=16))
    job.sync_requests([CREATE])
    return job


@pytest.fixture
def eight_slots(monkeypatch):
    monkeypatch.setattr(multihost, "device_slots", lambda device: 8)


def _port_job():
    job = DistributedStreamJob(JobConfig(batch_size=8, test_set_size=16), device="cpu")
    job.sync_requests([CREATE])
    assert job.dp_global == 8
    return job


def _train(job, x, y, lo, hi):
    job.handle_partition_rows(x[lo:hi], y[lo:hi])
    job.pump()


def _jax_leaves(job):
    import jax

    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(
        jax.device_get(job.pipelines[0].trainer.state))]


def _port_leaves(job):
    return _leaves(job.pipelines[0].trainer.fleet_numpy())


def _assert_same_leaves(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.shape == b.shape
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(a, b)


def _assert_same_snapshot(d_port, d_jax):
    mp, mj = (json.load(open(os.path.join(d, "manifest.json"))) for d in (d_port, d_jax))
    for key in ("seq", "processes", "dp_global", "request_lines"):
        assert mp[key] == mj[key], key
    assert sorted(mp["digests"]) == sorted(mj["digests"])
    fp, fj = (np.load(os.path.join(d, "fleet_0.npz")) for d in (d_port, d_jax))
    assert sorted(fp.files) == sorted(fj.files)
    _assert_same_leaves([fp[f"leaf_{i}"] for i in range(len(fp.files))],
                        [fj[f"leaf_{i}"] for i in range(len(fj.files))])
    pp, pj = (json.load(open(os.path.join(d, "proc0.json"))) for d in (d_port, d_jax))
    assert pp["cursor"] == pj["cursor"]
    for key in ("holdout_count", "fitted", "steps_host", "requeued", "steps_run",
                "global_rows"):
        assert pp["pipelines"]["0"][key] == pj["pipelines"]["0"][key], key
    np.testing.assert_allclose([c[0] for c in pp["pipelines"]["0"]["curve"]],
                               [c[0] for c in pj["pipelines"]["0"]["curve"]], atol=1e-5)
    ap, aj = (np.load(os.path.join(d, "proc0.npz")) for d in (d_port, d_jax))
    assert sorted(ap.files) == sorted(aj.files)
    for key in aj.files:
        np.testing.assert_array_equal(ap[key], aj[key])


def test_snapshot_layout_matches_jax(tmp_path, eight_slots):
    x, y = _stream()
    port, ref = _port_job(), _jax_job()
    for job in (port, ref):
        _train(job, x, y, 0, 500)
    d_port = port.save_checkpoint(str(tmp_path / "port"), 500)
    d_jax = ref.save_checkpoint(str(tmp_path / "jax"), 500)
    _assert_same_snapshot(d_port, d_jax)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_restores_across_packages(tmp_path, eight_slots, direction):
    """A snapshot of one package restores in the other: the restored job
    holds the saved state and, trained on the rest of the stream, ends
    where the saving package's own continuation ends."""
    x, y = _stream()
    port, ref = _port_job(), _jax_job()
    for job in (port, ref):
        _train(job, x, y, 0, 500)
    saver = ref if direction == "jax_to_port" else port
    root = str(tmp_path / "ck")
    saver.save_checkpoint(root, 500)
    if direction == "jax_to_port":
        restored = DistributedStreamJob(JobConfig(batch_size=8, test_set_size=16),
                                        device="cpu")
        assert restored.restore_checkpoint(root) == 500
        _assert_same_leaves(_port_leaves(restored), _jax_leaves(ref))
    else:
        jdj = _jax_dj()
        from omldm_tpu.config import JobConfig as JaxConfig

        restored = jdj.DistributedStreamJob(JaxConfig(batch_size=8, test_set_size=16))
        assert restored.restore_checkpoint(root) == 500
        _assert_same_leaves(_port_leaves(port), _jax_leaves(restored))
    for job in (restored, saver):
        _train(job, x, y, 500, ROWS)
        job.flush()
    if direction == "jax_to_port":
        _assert_same_leaves(_port_leaves(restored), _jax_leaves(saver))
    else:
        _assert_same_leaves(_port_leaves(saver), _jax_leaves(restored))
    rp, rj = ((restored, saver) if direction == "jax_to_port" else (saver, restored))
    sp, sj = rp.merged_report(), rj.merged_report()
    for key in ("fitted", "numOfBlocks", "bytesShipped", "modelsShipped", "rescalesPerformed"):
        assert sp["statistics"][0][key] == sj["statistics"][0][key], key
    assert sp["holdout"] == sj["holdout"]
    assert abs(sp["statistics"][0]["score"] - sj["statistics"][0]["score"]) <= 1e-5


def test_rescale_restore_across_packages(tmp_path, eight_slots):
    """A JAX snapshot of 8 workers restored by the port at 4 workers and by
    the JAX package at 4 (a fabricated shrink: the manifest's process count
    doubled, so the merge rules run): the same merged state."""
    x, y = _stream()
    ref = _jax_job()
    _train(ref, x, y, 0, 500)
    root = str(tmp_path / "ck")
    d = ref.save_checkpoint(root, 500)
    _fabricate_two_proc_snapshot(d)
    # the JAX job restores at its 8 workers; the port at 8 (the merge of
    # 16 fabricated rows into 8 by the same rules)
    jdj = _jax_dj()
    from omldm_tpu.config import JobConfig as JaxConfig

    jrest = jdj.DistributedStreamJob(JaxConfig(batch_size=8, test_set_size=16))
    prest = DistributedStreamJob(JobConfig(batch_size=8, test_set_size=16), device="cpu")
    assert jrest.restore_checkpoint(root) == prest.restore_checkpoint(root) == 500
    assert prest.rescales_performed == jrest.rescales_performed == 1
    _assert_same_leaves(_port_leaves(prest), _jax_leaves(jrest))
    pj, pp = jrest.pipelines[0], prest.pipelines[0]
    assert (pp.holdout_count, pp.trainer.fitted, pp.pend_n, len(pp.test_set)) == (
        pj.holdout_count, pj.trainer.fitted, pj.pend_n, len(pj.test_set))
