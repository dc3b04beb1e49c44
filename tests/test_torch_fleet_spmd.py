"""The SPMD engine across processes: two gloo processes at ``dp_local`` 1
against one process at ``Mesh(dp=2)``.

Both processes run every case in one launch (a module-scoped fixture):
each joins the group, builds the case's trainer on ``Mesh(2, 1, "cpu",
processes=2, process_id=pid)``, steps it on its own row of the same
seeded ``[2, B, D]`` batches, and saves its rows of the state, the
counters the job reads and worker 0's answers. The one-process trainer
steps both rows. State to atol 1e-6, every counter equal.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec, TrainingConfiguration
from omldm_tpu_torch.parallel.mesh import Mesh
from omldm_tpu_torch.parallel.spmd import SPMD_PROTOCOLS, SPMDTrainer

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
ATOL = 1e-6
DIM, BATCH, SPARSE_DIM, NNZ, STEPS = 7, 16, 50, 5, 9

PA_RECORD = ("PA", {"C": 0.01, "variant": "PA-I"}, {}, ("StandardScaler",), True)
SPARSE_PA = ("PA", {"C": 0.1, "variant": "PA-II"},
             {"sparse": True, "nFeatures": SPARSE_DIM, "maxNnz": NNZ}, (), False)
NN = ("NN", {"learningRate": 0.05}, {"hiddenLayers": [6]}, (), False)
CASES = (
    [(f"pa-record-{p}", PA_RECORD, p) for p in SPMD_PROTOCOLS]
    + [(f"sparse-pa-{p}", SPARSE_PA, p) for p in SPMD_PROTOCOLS]
    + [("nn-GM", NN, "GM")]
)


def _steps(kind, seed):
    """STEPS batches for 2 workers: ragged masks, worker 1 idle now and then
    (so the Async and SSP clocks part), {0, 1} targets of a planted rule."""
    rng = np.random.RandomState(seed)
    d = SPARSE_DIM if kind == "sparse" else DIM
    w = rng.randn(d)
    out = []
    for t in range(STEPS):
        m = np.ones((2, BATCH), np.float32)
        m[:, rng.randint(BATCH // 2, BATCH + 1):] = 0.0
        if t % 3 == 1:
            m[1] = 0.0
        if kind == "sparse":
            idx = rng.randint(0, SPARSE_DIM, size=(2, BATCH, NNZ)).astype(np.int32)
            val = rng.randn(2, BATCH, NNZ).astype(np.float32)
            y = ((w[idx] * val).sum(-1) > 0).astype(np.float32)
            out.append(((idx, val), y, m))
        else:
            x = rng.randn(2, BATCH, DIM).astype(np.float32)
            out.append((x, (x @ w > 0).astype(np.float32), m))
    return out


def _rows(batch, rows):
    x, y, m = batch
    x = (x[0][rows], x[1][rows]) if isinstance(x, tuple) else x[rows]
    return x, y[rows], m[rows]


def _trainer(spec, protocol, mesh):
    name, hp, ds, preps, per_record = spec
    return SPMDTrainer(
        LearnerSpec(name, hyper_parameters=hp, data_structure=ds),
        [PreprocessorSpec(p) for p in preps], dim=SPARSE_DIM if ds.get("sparse") else DIM,
        protocol=protocol, mesh=mesh, batch_size=BATCH,
        training_configuration=TrainingConfiguration(
            protocol=protocol, per_record=per_record,
            extra={"syncEvery": 2, "threshold": 0.02, "staleness": 1}))


def run_case(spec, protocol, mesh, rows):
    """Step a trainer on ``rows`` of every batch; its rows of the state,
    the counters and worker 0's answers on a probe, as numpy."""
    kind = "sparse" if spec[2].get("sparse") else "dense"
    tt = _trainer(spec, protocol, mesh)
    batches = _steps(kind, seed=len(protocol))
    losses = []
    for batch in batches:
        x, y, m = _rows(batch, rows)
        losses.append(tt.step(x, y, m).numpy().copy())
    probe_x, probe_y, probe_m = _rows(batches[0], 0)
    loss, score = tt.evaluate(probe_x, probe_y, probe_m)
    out = {
        "params": tt._flat(tt.state["params"]).numpy(),
        "losses": np.stack(losses),
        "curve": np.asarray(tt.curve_slice(), np.float64),
        "predict": tt.predict(probe_x),
        "eval": np.asarray([loss, score]),
        "flat0": tt.global_flat_params(),
        "counters": np.asarray([tt.sync_count(), tt.bytes_shipped(), tt.bytes_on_wire(),
                                tt.collective_bytes_physical()], np.int64),
        "fitted": np.asarray(tt.fitted),
        "accepted": tt.last_accepted(),
    }
    for key in ("est", "center", "step", "syncs", "clock", "fold_rounds", "cum_loss"):
        out[key] = tt.state[key].numpy()
    for j, s in enumerate(tt.state["preps"]):
        for k, v in s.items():
            out[f"prep{j}.{k}"] = v.numpy()
    tt.release_stragglers()
    out["released"] = tt.state["clock"].numpy()
    return out


def fleet_worker(pid: int, port: int, out_dir: str) -> None:
    """One process of the two: every case, its row of each batch."""
    from omldm_tpu_torch.parallel import multihost

    multihost.initialize_multihost(f"127.0.0.1:{port}", 2, pid, device="cpu")
    mesh = Mesh(2, 1, "cpu", processes=2, process_id=pid)
    for case, spec, protocol in CASES:
        out = run_case(spec, protocol, mesh, slice(pid, pid + 1))
        np.savez(os.path.join(out_dir, f"{case}.p{pid}.npz"), **out)
    multihost.shutdown_multihost()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(code: str, tmp: Path, n: int = 2, timeout: float = 240):
    """Run ``code`` (formatted with ``pid``) in n processes; a process that
    fails or overruns kills the others."""
    procs = [subprocess.Popen([sys.executable, "-c", code.format(pid=pid)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


@pytest.fixture(scope="module")
def fleet_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_spmd")
    code = ("import sys; sys.path.insert(0, {tests!r}); import test_torch_fleet_spmd as m; "
            "m.fleet_worker({{pid}}, {port}, {out!r})").format(
                tests=str(TESTS), port=_free_port(), out=str(tmp))
    launch(code, tmp)
    return tmp


@pytest.mark.parametrize("case,spec,protocol", CASES, ids=[c[0] for c in CASES])
def test_two_processes_hold_the_one_process_fleet(fleet_results, case, spec, protocol):
    one = run_case(spec, protocol, Mesh(2, 1, "cpu"), slice(0, 2))
    parts = [dict(np.load(fleet_results / f"{case}.p{pid}.npz")) for pid in range(2)]
    for key, want in one.items():
        if key == "curve":
            # the fleet-mean loss of each step on every process; the fitted
            # count beside it is each process's own, as the JAX trainer's
            for part in parts:
                np.testing.assert_allclose(part[key][:, 0], want[:, 0], rtol=0, atol=ATOL)
            np.testing.assert_array_equal(parts[0][key][:, 1] + parts[1][key][:, 1],
                                          want[:, 1])
        elif key in ("counters", "predict", "eval", "flat0"):
            # every process holds the fleet's value
            for part in parts:
                if key == "counters":
                    np.testing.assert_array_equal(part[key], want, err_msg=key)
                else:
                    np.testing.assert_allclose(part[key], want, rtol=0, atol=ATOL, err_msg=key)
        elif key == "fitted":
            assert int(parts[0][key]) + int(parts[1][key]) == int(want)
        elif key in ("losses",):
            got = np.concatenate([p[key] for p in parts], axis=1)
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=key)
        else:
            got = np.concatenate([p[key] for p in parts])
            if want.dtype.kind in "iub":
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=key)
    assert int(parts[0]["counters"][0]) > 0, "no synchronization ran"


def test_fleet_mesh_layout():
    """A fleet mesh splits dp over the processes; a one-process mesh is the
    whole fleet; a dp that does not split is refused."""
    mesh = Mesh(4, 1, "cpu", processes=2, process_id=1)
    assert (mesh.dp_global, mesh.dp_local, mesh.fleet) == (4, 2, True)
    assert mesh.shape == {"dp": 4, "hub": 1}
    one = Mesh(4, 1, "cpu")
    assert (one.dp_local, one.fleet) == (4, False)
    with pytest.raises(ValueError, match="do not split"):
        Mesh(3, 1, "cpu", processes=2)
    with pytest.raises(ValueError, match="process id"):
        Mesh(2, 1, "cpu", processes=2, process_id=2)


def test_fleet_state_from_numpy_takes_the_process_rows():
    """A JAX fleet state ``[dp_global, hub, ...]`` loads as the process's
    ``[dp_local, ...]`` rows."""
    from omldm_tpu_torch.pipelines import fleet_state_from_numpy

    mesh = Mesh(4, 1, "cpu", processes=2, process_id=1)
    tt = _trainer(PA_RECORD, "Synchronous", mesh)
    tree = {"a": np.arange(8, dtype=np.float32).reshape(4, 2), "b": [np.arange(4)[:, None]]}
    got = fleet_state_from_numpy({"a": tree["a"][:, None], "b": [tree["b"][0][:, None]]}, tt)
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"][2:4])
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray([[2], [3]]))
    assert json.dumps(list(got["a"].shape)) == "[2, 2]"
    assert isinstance(got["a"], torch.Tensor)


def test_per_record_pa_takes_the_op_only_under_vmap(monkeypatch):
    """A plain perRecord PA fit calls the scan's wrapper (no custom-op
    dispatch: the op's first call imports torch._dynamo, seconds in each
    fresh fleet process); under torch.func.vmap it goes through the op, whose
    vmap rule runs the batched scan once for every member. Same values."""
    from omldm_tpu_torch.learners import linear
    from omldm_tpu_torch.learners.registry import make_learner
    from omldm_tpu_torch.ops import pa_scan

    calls = {"solo": 0, "batched": 0}
    solo, batched = pa_scan.pa_scan_update, pa_scan.pa_scan_update_batched

    def count(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(linear, "pa_scan_update", count("solo", solo))
    monkeypatch.setattr(pa_scan, "pa_scan_update_batched", count("batched", batched))
    learner = make_learner(LearnerSpec("PA", hyper_parameters={"C": 0.01, "variant": "PA-I"}))
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(3, 16, DIM, generator=g), (torch.rand(3, 16, generator=g) > 0.5).float()
    mask = torch.ones(3, 16)
    w = torch.randn(3, DIM + 1, generator=g)
    singles = [learner.update_per_record({"w": w[i]}, x[i], y[i], mask[i]) for i in range(3)]
    assert calls == {"solo": 3, "batched": 0}
    out, loss = torch.func.vmap(learner.update_per_record)({"w": w}, x, y, mask)
    assert calls == {"solo": 3, "batched": 1}
    torch.testing.assert_close(out["w"], torch.stack([s[0]["w"] for s in singles]))
    torch.testing.assert_close(loss, torch.stack([s[1] for s in singles]))
