"""Job checkpointing with rescale-merge restore.

Counterpart of ``omldm_tpu/checkpoint/checkpoint.py``; in the reference,
Flink-native checkpointing (opt-in flag Job.scala:120, FsStateBackend and a
5 s interval, Checkpointing.scala:9-25). The spoke snapshots its node
wrappers (model state included), the holdout test set, the record buffer
and the request buffer into operator ListState (FlinkSpoke.scala:233-251);
on restore parallel copies are merged and overflow re-trained
(FlinkSpoke.scala:261-334). The reference's restore never assigns the
merged state back (FlinkSpoke.scala:291-305, SURVEY.md section 5); this
one does, as the JAX package's does.

Rescale semantics (FlinkSpoke.scala:345-348): restoring at another
``parallelism`` merges every worker replica of a pipeline with the
learner's ``merge`` (parameter average, sufficient-statistics sum,
count-weighted centroids, biggest tree), deals the holdout sets round-robin
(capacity overflow queues for training, the evicted-holdout rule) and
redeploys onto the new worker count. Every new worker gets buffers of its
own: a fit gives its state up (a sparse scatter writes in place), so two
workers sharing a tensor would corrupt each other.

Format: one pickle a snapshot and a ``latest`` pointer, both written to a
temporary name and renamed. The snapshot's schema is the JAX package's, key
for key: numpy leaves and Python values (a host-side learner's tree as its
host objects), no tensor. So a snapshot taken on the card restores with
``device="cpu"`` and the other way round. Only the protocol nodes' round
state (``node``) is framework-specific. A guarded net carries its guard's
last-known-good ring (``guard``), and a lifecycle-armed net its version
registry (``lifecycle``: versions, the candidate's and the retained
model's state, the canary clocks), so a restart resumes mid-canary; a
restore whose active version is a promoted candidate installs that
pipeline before loading the net's state into it.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from omldm_tpu_torch.api.requests import Request
from omldm_tpu_torch.config import JobConfig
from omldm_tpu_torch.models.transformer import tree_map
from omldm_tpu_torch.parallel.ckpt import place_tree, to_host
from omldm_tpu_torch.pipelines.pipeline import fleet_state_from_numpy
from omldm_tpu_torch.utils.device import resolve_device

# node attributes that are wiring (callables, config, the job's gang
# averager and flight-recorder journal, set by the HubManager, and the
# transient receive stamp) or restored separately (the pipeline), not
# protocol state
_NODE_SKIP = frozenset({"pipeline", "config", "send", "reply", "broadcast", "gang",
                        "events", "_rx_stamp"})


def _node_state(node) -> dict:
    """Snapshot a protocol node's round state (sync barriers, clocks,
    partial rounds, blocked batches, statistics counters, the codec's
    streams) -- the state the reference keeps in its wrapper and PS objects
    inside Flink operator state (FlinkSpoke.scala:233-251). Wiring is
    excluded and re-established by the runtime on restore."""
    return {
        k: copy.deepcopy(v)
        for k, v in vars(node).items()
        if k not in _NODE_SKIP and not callable(v)
    }


def _restore_node(node, state: Optional[dict]) -> None:
    if state:
        vars(node).update(copy.deepcopy(state))


def _pipeline_snapshot(pipe) -> dict:
    """The one pipeline-state schema: spoke nets and the SingleLearner hub
    model both save and load through this pair. A cohort member's state is
    read from the stacked tree without checking it out."""
    st = pipe._read_state()
    return {
        "params": to_host(st["params"]),
        "preps": [to_host(s) for s in st["preps"]],
        "fitted": pipe.fitted,
        "cum_loss": pipe.cumulative_loss,
    }


def _pipeline_load(pipe, sv: dict) -> None:
    """Load a :func:`_pipeline_snapshot` into ``pipe`` on its device; a
    cohort member's edits land in its checked-out state."""
    st = pipe.state
    st["params"] = place_tree(sv["params"], pipe.device)
    st["preps"] = [place_tree(s, pipe.device) for s in sv["preps"]]
    st["cum_loss"] = torch.tensor(float(sv["cum_loss"]), dtype=torch.float32,
                                  device=pipe.device)
    pipe._fitted_host = sv["fitted"]


class CheckpointManager:
    """Periodic job snapshots in ``directory``; ``keep`` newest retained.
    ``device`` is where :meth:`restore` builds the job by default (the
    card unless given; a ``StreamJob`` passes its own)."""

    def __init__(self, directory: str, keep: int = 3, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)
        self._last_save = 0.0
        # seed the sequence past the snapshots already in the directory: a
        # manager built mid-recovery must not reuse a live sequence number
        # (a same-millisecond collision would overwrite, or sort before,
        # the newest snapshot and let _prune delete what `latest` names)
        self._seq = 0
        for name in os.listdir(directory):
            if name.startswith("ckpt_") and name.endswith(".pkl"):
                parts = name[:-4].split("_")
                if len(parts) == 3 and parts[2].isdigit():
                    self._seq = max(self._seq, int(parts[2]))
        # snapshots retained on disk; <= 0 keeps everything
        self.keep = keep

    # --- save ---

    def save(self, job) -> str:
        """Snapshot a StreamJob; returns the checkpoint path."""
        spokes = []
        for spoke in job.spokes:
            nets: Dict[int, dict] = {}
            for net_id, net in spoke.nets.items():
                pipe = net.pipeline
                nets[net_id] = {
                    **_pipeline_snapshot(pipe),
                    "holdout_count": net.holdout_count,
                    "test_set": net.test_set.to_list(),
                    "pending": self._batcher_contents(net.batcher),
                    "node": _node_state(net.node),
                }
                # the guard's last-known-good ring survives a restart (a
                # reseed at the restored params could make a corruption
                # that slipped into the snapshot its own rollback target)
                if pipe.guard is not None:
                    nets[net_id]["guard"] = pipe.guard.snapshot()
                # the version registry: a supervised restart resumes
                # mid-canary instead of reverting to one unversioned model
                if net.lifecycle is not None:
                    nets[net_id]["lifecycle"] = net.lifecycle.snapshot()
            spokes.append(nets)
        hub_nodes = {}
        for (net_id, hub_id), hub in job.hub_manager.hubs.items():
            entry: Dict[str, Any] = {"node": _node_state(hub.node)}
            central = getattr(hub.node, "pipeline", None)
            if central is not None:
                # SingleLearner: the model lives on the hub
                # (FlinkHub.scala:128-153)
                entry["pipeline"] = _pipeline_snapshot(central)
            hub_nodes[(net_id, hub_id)] = entry
        hub_stats = {}
        for net_id in job.pipeline_manager.live_pipelines:
            merged = job.hub_manager.network_statistics(net_id)
            if merged is not None:
                hub_stats[net_id] = merged.to_dict()
        bridges = {}
        for net_id, bridge in job.spmd_bridges.items():
            t = bridge.trainer
            bridges[net_id] = {
                "mesh": (t.dp, t.hub),
                "fleet": t.fleet_numpy(),
                "fitted": t.fitted,
                "steps": t._steps_host,
                "holdout_count": bridge.holdout_count,
                **bridge.snapshot_buffers(),
            }
        snapshot = {
            "config": dataclasses.asdict(job.config),
            "requests": [r.to_dict() for r in job.pipeline_manager.node_map.values()],
            "dims": dict(job._dims),
            "spokes": spokes,
            "hub_stats": hub_stats,
            "hub_nodes": hub_nodes,
            "bridges": bridges,
            # stream position and routing state: a supervisor resumes a
            # replayable source at ``offset`` and the restored job routes
            # the records after it as the original would have (the role of
            # source offsets in a Flink checkpoint barrier)
            "offset": job.events_processed,
            "source_position": copy.deepcopy(job.source_position),
            "rr": job._rr,
            "rescales": job.rescales_performed,
            "backlog": list(job._backlog._entries),
            "pending_creates": [r.to_dict() for r in job._pending_creates],
            "time": time.time(),
        }
        # ms timestamp and a monotonic sequence: unique, name-sortable
        # names even for saves inside one millisecond
        self._seq += 1
        path = os.path.join(
            self.directory, f"ckpt_{int(time.time() * 1000):013d}_{self._seq:06d}.pkl")
        # a crash mid-write never leaves a truncated snapshot or an empty
        # `latest` pointer: the recovery path reads both
        with open(path + ".tmp", "wb") as f:
            pickle.dump(snapshot, f)
        os.replace(path + ".tmp", path)
        pointer = os.path.join(self.directory, "latest")
        with open(pointer + ".tmp", "w") as f:
            f.write(os.path.basename(path))
        os.replace(pointer + ".tmp", pointer)
        self._last_save = time.time()
        self._prune()
        return path

    def _prune(self) -> None:
        """Retain the newest ``keep`` snapshots (names sort
        chronologically); <= 0 keeps everything."""
        if self.keep <= 0:
            return
        snaps = sorted(f for f in os.listdir(self.directory)
                       if f.startswith("ckpt_") and f.endswith(".pkl"))
        for stale in snaps[: -self.keep]:
            try:
                os.remove(os.path.join(self.directory, stale))
            except OSError:
                pass

    @staticmethod
    def _batcher_contents(batcher) -> List[tuple]:
        """Pending rows: ``(idx, val, y)`` for a sparse batcher, ``(x, y)``
        for a dense one."""
        if hasattr(batcher, "_idx"):
            return [(batcher._idx[i].copy(), batcher._val[i].copy(), float(batcher._y[i]))
                    for i in range(len(batcher))]
        return [(batcher._x[i].copy(), float(batcher._y[i])) for i in range(len(batcher))]

    @staticmethod
    def _refeed_pending(net, pending) -> None:
        """Re-add snapshotted pending rows to a net's batcher. Shapes:
        (idx, val, y) sparse batcher rows; ((idx, val), y) sparse
        holdout-evicted points; (x, y) dense."""
        for row in pending:
            if len(row) == 3:
                net.batcher.add((np.asarray(row[0], np.int32),
                                 np.asarray(row[1], np.float32)), float(row[2]))
            elif isinstance(row[0], tuple):
                (idx, val), y = row
                net.batcher.add((np.asarray(idx, np.int32),
                                 np.asarray(val, np.float32)), float(y))
            else:
                net.batcher.add(np.asarray(row[0], np.float32), float(row[1]))
            if net.batcher.full:
                net.flush_batch()

    def maybe_save(self, job, now: Optional[float] = None) -> Optional[str]:
        """Periodic checkpointing at ``check_interval_ms`` (the reference's
        5 s default, Checkpointing.scala:21)."""
        if not job.config.checkpointing:
            return None
        now = time.time() if now is None else now
        if (now - self._last_save) * 1000.0 >= job.config.check_interval_ms:
            return self.save(job)
        return None

    # --- restore ---

    def candidate_paths(self) -> List[str]:
        """Every snapshot in the directory, newest first. The recovery path
        walks this list when the newest generation fails to load."""
        try:
            names = sorted((f for f in os.listdir(self.directory)
                            if f.startswith("ckpt_") and f.endswith(".pkl")),
                           reverse=True)
        except OSError:
            return []
        return [os.path.join(self.directory, f) for f in names]

    def latest_path(self) -> Optional[str]:
        pointer = os.path.join(self.directory, "latest")
        if not os.path.exists(pointer):
            return None
        with open(pointer) as f:
            name = f.read().strip()
        if not name:  # an empty pointer means no checkpoint, not a crash
            return None
        path = os.path.join(self.directory, name)
        return path if os.path.exists(path) else None

    def restore(self, parallelism: Optional[int] = None, path: Optional[str] = None,
                device=None):
        """Rebuild a StreamJob from a snapshot on ``device`` (else the
        manager's); ``parallelism`` overrides the saved worker count
        (rescale-merge)."""
        from omldm_tpu_torch.runtime.job import StreamJob

        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        with open(path, "rb") as f:
            snapshot = pickle.load(f)

        config = JobConfig(**snapshot["config"])
        if parallelism is not None:
            config.parallelism = parallelism
        job = StreamJob(config, device=resolve_device(
            device if device is not None else self.device, "CheckpointManager.restore"))

        # re-admit and redeploy the live pipelines
        for req_dict in snapshot["requests"]:
            request = Request.from_dict(req_dict)
            if job.pipeline_manager.validate(request) is None:
                job.pipeline_manager.apply(request)
                dim = snapshot["dims"].get(request.id)
                if dim is not None:
                    job._deploy(request, dim)

        for net_id in {k for nets in snapshot["spokes"] for k in nets}:
            self._restore_network(job, snapshot, net_id)

        for net_id, bd in snapshot.get("bridges", {}).items():
            self._restore_bridge(job, int(net_id), bd)

        # stream position and routing continuity (resume-from-offset replay)
        job.events_processed = snapshot.get("offset", 0)
        job.source_position = snapshot.get("source_position")
        job._rr = snapshot.get("rr", 0)
        job.rescales_performed = snapshot.get("rescales", 0)
        if parallelism is not None and parallelism != snapshot["config"].get("parallelism"):
            # a restore with a rescale counts like a live rescale
            job.rescales_performed += 1
        for entry in snapshot.get("backlog", ()):
            job._backlog.append(entry)
        job._pending_creates = [Request.from_dict(d) for d in snapshot.get("pending_creates", ())]

        # protocol statistics continuity (counters keep accumulating)
        for net_id, sd in snapshot["hub_stats"].items():
            hub = job.hub_manager.hubs.get((int(net_id), 0))
            if hub is not None:
                s = hub.node.stats
                s.models_shipped = sd["modelsShipped"]
                s.bytes_shipped = sd["bytesShipped"]
                s.num_of_blocks = sd["numOfBlocks"]
                s.fitted = sd["fitted"]
                s.learning_curve = list(sd["learningCurve"])
                s.lcx = list(sd["LCX"])

        # protocol round state (sync barriers, partial rounds, clocks,
        # blocked batches, watermarks) continues exactly only 1:1: under a
        # rescale the fresh nodes start a clean round over the merged model
        same_parallelism = len(snapshot["spokes"]) == len(job.spokes)
        if same_parallelism:
            for spoke, nets in zip(job.spokes, snapshot["spokes"]):
                for net_id, sv in nets.items():
                    net = spoke.nets.get(net_id)
                    if net is not None:
                        _restore_node(net.node, sv.get("node"))
        for key, entry in snapshot.get("hub_nodes", {}).items():
            hub = job.hub_manager.hubs.get(key)
            if hub is None:
                continue
            if same_parallelism:
                _restore_node(hub.node, entry.get("node"))
            # the SingleLearner central model does not depend on the spoke
            # count: it survives a rescale restore too
            central = getattr(hub.node, "pipeline", None)
            if central is not None and "pipeline" in entry:
                _pipeline_load(central, entry["pipeline"])
        return job

    def _restore_bridge(self, job, net_id: int, bd: dict) -> None:
        """Restore an SPMD-engine pipeline's fleet.

        The same mesh: exact. Another mesh (a restore at another
        parallelism): every worker seeds from the MEAN of the saved dp
        replicas -- checkpoints land between events, not at sync barriers,
        so under Asynchronous, SSP or EASGD the replicas diverge mid-round
        and the mean keeps every worker's progress; progress counters
        carry worker 0's values and staleness clocks restart at zero."""
        bridge = job.spmd_bridges.get(net_id)
        if bridge is None:
            return
        t = bridge.trainer
        fleet = bd["fleet"]
        if (t.dp, t.hub) != tuple(bd["mesh"]):

            def tile(leaf):
                return np.broadcast_to(leaf[0, 0], (t.dp, t.hub) + leaf.shape[2:]).copy()

            def merge_tile(leaf):
                # model-bearing leaves: mean over the dp replicas of hub
                # slot 0 (the hub slots agree)
                m = leaf[:, 0].mean(axis=0).astype(leaf.dtype)
                return np.broadcast_to(m, (t.dp, t.hub) + m.shape).copy()

            def refit(leaf):
                # flat vectors pad to a multiple of hub: another hub count
                # takes another pad (the pad is zeros)
                out = np.zeros(leaf.shape[:2] + (t.flat_size,), leaf.dtype)
                n = min(t.flat_size, leaf.shape[2])
                out[..., :n] = leaf[..., :n]
                return out

            new_state = {
                "params": tree_map(merge_tile, fleet["params"]),
                "preps": [tree_map(merge_tile, p) for p in fleet["preps"]],
                "est": refit(merge_tile(fleet["est"])),
                "center": refit(merge_tile(fleet["center"])),
                "step": tile(fleet["step"]),
                "syncs": tile(fleet["syncs"]),
                "cum_loss": tile(fleet["cum_loss"]),
                "clock": np.zeros_like(tile(fleet["clock"])),
                "accepted": np.ones_like(tile(fleet["accepted"])),
            }
            # call-site counters and protocol extras carry worker 0's values
            for key, val in fleet.items():
                if key not in new_state:
                    tiled = tree_map(tile, val)
                    new_state[key] = refit(tiled) if key == "ef" else tiled
            fleet = new_state
        t.load_state(fleet_state_from_numpy(fleet, t))
        t._fitted_host = bd["fitted"]
        t._steps_host = bd["steps"]
        bridge.holdout_count = bd["holdout_count"]
        bridge.restore_buffers(bd)

    def _restore_network(self, job, snapshot, net_id: int) -> None:
        saved = [nets[net_id] for nets in snapshot["spokes"] if net_id in nets]
        if not saved:
            return
        new_spokes = [s for s in job.spokes if net_id in s.nets]
        if not new_spokes:
            return
        pipes = [s.nets[net_id].pipeline for s in new_spokes]
        learner, device = pipes[0].learner, pipes[0].device

        if len(saved) == len(new_spokes):
            # the same parallelism: a 1:1 reload
            for spoke, sv in zip(new_spokes, saved):
                self._load_net_state(spoke.nets[net_id], sv)
            return

        # rescale: merge every saved replica into one state...
        merged_params = learner.merge([place_tree(sv["params"], device) for sv in saved])
        merged_preps = [
            prep.merge([place_tree(sv["preps"][i], device) for sv in saved])
            for i, prep in enumerate(pipes[0].preps)
        ]
        total_fitted = sum(sv["fitted"] for sv in saved)
        total_cum_loss = sum(sv["cum_loss"] for sv in saved)

        # ...and put it on every new worker, each with buffers of its own
        for spoke in new_spokes:
            net = spoke.nets[net_id]
            pipe = net.pipeline
            st = pipe.state
            st["params"] = place_tree(merged_params, device)
            st["preps"] = [place_tree(p, device) for p in merged_preps]
            pipe._fitted_host = total_fitted // len(new_spokes)
            # the summed cumulative loss, dealt evenly: the job-wide sum
            # carries across the rescale
            st["cum_loss"] = torch.tensor(total_cum_loss / len(new_spokes),
                                          dtype=torch.float32, device=device)
            # the guard's ring restarts at the merged model (the saved
            # per-replica rings describe states no restored worker holds);
            # the lifecycle registry restarts clean too: its clocks are per
            # replica and only defined 1:1
            if pipe.guard is not None:
                pipe.guard.reseed(pipe)
            net.holdout_count = max(sv["holdout_count"] for sv in saved)

        # ...then deal holdout points and pending records round-robin;
        # test-set overflow queues for training (the evicted-holdout rule)
        all_test = [p for sv in saved for p in sv["test_set"]]
        all_pending = [p for sv in saved for p in sv["pending"]]
        for i, (x, y) in enumerate(all_test):
            net = new_spokes[i % len(new_spokes)].nets[net_id]
            evicted = net.test_set.append((x, y))
            if evicted is not None:
                all_pending.append(evicted)
        for i, row in enumerate(all_pending):
            net = new_spokes[i % len(new_spokes)].nets[net_id]
            self._refeed_pending(net, [row])

    @classmethod
    def _load_net_state(cls, net, sv: dict) -> None:
        # the registry first: when the saved ACTIVE version is a promoted
        # candidate, restore() rebuilds that pipeline from its spec, loads
        # this snapshot's pipeline fields into it and installs it (the
        # default load would push promoted-spec parameters into the
        # Create-spec pipeline)
        swapped = False
        if net.lifecycle is not None and sv.get("lifecycle") is not None:
            swapped = net.lifecycle.restore(net, sv["lifecycle"], sv)
        if not swapped:
            _pipeline_load(net.pipeline, sv)
        if net.pipeline.guard is not None and sv.get("guard") is not None:
            net.pipeline.guard.restore(sv["guard"])
        net.holdout_count = sv["holdout_count"]
        for p in sv["test_set"]:
            net.test_set.append(p)
        cls._refeed_pending(net, sv["pending"])
