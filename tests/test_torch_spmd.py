"""The port's SPMDTrainer against the JAX package's on the same numpy batches.

JAX runs its trainer over the 8 virtual CPU devices that ``conftest.py``
sets up; the port holds the same fleet as the leading axis of its state on
the CPU (``Mesh(dp, hub, "cpu")``). Parameters are held to rtol 2e-4,
atol 2e-5, losses to 1e-5, and every integer counter must be equal.
"""

import jax
import jax.flatten_util
import numpy as np
import pytest
import torch

from omldm_tpu.api.requests import (
    LearnerSpec as JLearnerSpec,
    PreprocessorSpec as JPreprocessorSpec,
    TrainingConfiguration as JTrainingConfiguration,
)
from omldm_tpu.parallel import SPMDTrainer as JSPMDTrainer, make_mesh as jmake_mesh
from omldm_tpu_torch.api.requests import LearnerSpec, PreprocessorSpec, TrainingConfiguration
from omldm_tpu_torch.learners.registry import make_learner
from omldm_tpu_torch.parallel.mesh import Mesh, device_slots, make_mesh
from omldm_tpu_torch.parallel.spmd import SPMD_PROTOCOLS, SPMDTrainer
from omldm_tpu_torch.pipelines import fleet_state_from_numpy

RTOL, ATOL, LOSS_TOL = 2e-4, 2e-5, 1e-5
DIM, BATCH, SPARSE_DIM, NNZ = 7, 16, 50, 5

PA = ("PA", {"C": 1.0}, {})
SOFTMAX = ("Softmax", {"learningRate": 0.05, "nClasses": 2}, {})
NN = ("NN", {"learningRate": 0.05}, {"hiddenLayers": [6]})
PA_RECORD = ("PA", {"C": 1.0, "variant": "PA-I"}, {})
SPARSE_PA2 = ("PA", {"C": 0.1, "variant": "PA-II"},
              {"sparse": True, "nFeatures": SPARSE_DIM, "maxNnz": NNZ})


def dense_steps(n, dp, seed=0, starve=False):
    """``n`` steps of [dp, B, D] batches of a planted linear rule; ragged
    masks, and a worker with no rows now and then (or, with ``starve``,
    every worker but 0 idle on three steps of four)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(DIM)
    out = []
    for t in range(n):
        x = rng.randn(dp, BATCH, DIM).astype(np.float32)
        y = (x @ w > 0).astype(np.float32)
        m = np.ones((dp, BATCH), np.float32)
        m[:, rng.randint(BATCH // 2, BATCH + 1):] = 0.0
        if starve and t % 4:
            m[1:] = 0.0
        elif dp > 1 and t % 3 == 1:
            m[t % dp] = 0.0
        out.append((x, y, m))
    return out


def sparse_steps(n, dp, seed=0):
    """``n`` steps of padded-COO batches: K active slots from [0, D), the
    last slot a pad (idx 0, val 0) on every other row; {0, 1} targets."""
    rng = np.random.RandomState(seed)
    w = rng.randn(SPARSE_DIM)
    out = []
    for _ in range(n):
        idx = rng.randint(0, SPARSE_DIM, size=(dp, BATCH, NNZ)).astype(np.int32)
        val = rng.randn(dp, BATCH, NNZ).astype(np.float32)
        idx[:, ::2, -1] = 0
        val[:, ::2, -1] = 0.0
        y = ((w[idx] * val).sum(-1) > 0).astype(np.float32)
        m = np.ones((dp, BATCH), np.float32)
        m[:, rng.randint(BATCH // 2, BATCH + 1):] = 0.0
        out.append(((idx, val), y, m))
    return out


def build(learner, protocol, dp, hub, extra=None, preps=(), per_record=False):
    name, hp, ds = learner
    tc = dict(protocol=protocol, per_record=per_record,
              extra={"syncEvery": 2, "threshold": 0.3, **(extra or {})})
    dim = SPARSE_DIM if ds.get("sparse") else DIM
    jt = JSPMDTrainer(
        JLearnerSpec(name, hyper_parameters=hp, data_structure=ds),
        [JPreprocessorSpec(p) for p in preps], dim=dim, protocol=protocol,
        mesh=jmake_mesh(dp=dp, hub=hub),
        training_configuration=JTrainingConfiguration(**tc), batch_size=BATCH,
    )
    tt = SPMDTrainer(
        LearnerSpec(name, hyper_parameters=hp, data_structure=ds),
        [PreprocessorSpec(p) for p in preps], dim=dim, protocol=protocol,
        mesh=Mesh(dp, hub, "cpu"),
        training_configuration=TrainingConfiguration(**tc), batch_size=BATCH,
    )
    # the JAX init draws per worker from split PRNG keys: load it
    tt.load_state(fleet_state_from_numpy(jax.device_get(jt.state), tt))
    return jt, tt


def worker_flats(jt):
    return np.stack([np.asarray(jax.flatten_util.ravel_pytree(p)[0])
                     for p in jt.shard_params()])


def assert_same(jt, tt, probe):
    """Parameters, the PS state, every integer counter, the learning curve
    and worker 0's predictions and evaluation."""
    np.testing.assert_allclose(tt._flat(tt.state["params"])[:, : tt.n_params].numpy(),
                               worker_flats(jt), rtol=RTOL, atol=ATOL)
    js = jax.device_get(jt.state)
    for key in ("est", "center"):
        np.testing.assert_allclose(tt.state[key].numpy(), np.asarray(js[key])[:, 0],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ("step", "syncs", "clock", "fold_rounds", "accepted"):
        np.testing.assert_array_equal(tt.state[key].numpy(), np.asarray(js[key])[:, 0],
                                      err_msg=key)
    assert tt.fitted == jt.fitted
    assert tt.sync_count() == jt.sync_count()
    assert tt.bytes_shipped() == jt.bytes_shipped()
    assert tt.bytes_on_wire() == jt.bytes_on_wire()
    assert tt.collective_bytes_physical() == jt.collective_bytes_physical()
    np.testing.assert_array_equal(tt.worker_clocks(), jt.worker_clocks())
    np.testing.assert_array_equal(tt.last_accepted(), jt.last_accepted())
    jc, tc = jt.curve_slice(), tt.curve_slice()
    assert [f for _, f in tc] == [f for _, f in jc]
    np.testing.assert_allclose([l for l, _ in tc], [l for l, _ in jc], atol=LOSS_TOL)
    x, y, m = probe
    np.testing.assert_array_equal(tt.predict(x), jt.predict(x))
    np.testing.assert_allclose(tt.evaluate(x, y, m), jt.evaluate(x, y, m), atol=LOSS_TOL)


def run_dense(learner, protocol, dp, hub, steps=12, **kw):
    jt, tt = build(learner, protocol, dp, hub, **kw)
    data = dense_steps(steps, dp)
    for x, y, m in data:
        jt.step(x, y, m)
        tt.step(x, y, m)
    x, y, m = data[0]
    assert_same(jt, tt, (x[0], y[0], m[0]))
    return jt, tt


@pytest.mark.parametrize("protocol", SPMD_PROTOCOLS)
def test_protocols_at_dp4(protocol):
    run_dense(PA, protocol, dp=4, hub=1)


@pytest.mark.parametrize("dp,hub", [(1, 1), (1, 2), (4, 1), (4, 2), (8, 1)])
def test_synchronous_mesh_shapes(dp, hub):
    """hub 2 pads PA's 8 parameters' flat to an even length; JAX's mesh of 8
    devices takes dp * hub <= 8 (the card-vs-CPU run covers dp 8, hub 2)."""
    run_dense(PA, "Synchronous", dp=dp, hub=hub)


@pytest.mark.parametrize("protocol", ["Synchronous", "GM", "SSP"])
def test_softmax_behind_a_scaler(protocol):
    run_dense(SOFTMAX, protocol, dp=4, hub=2, preps=("StandardScaler",))


@pytest.mark.parametrize("protocol", ["Synchronous", "Asynchronous"])
def test_nn_from_the_jax_init(protocol):
    """NN's per-worker random init and Adam state (its int32 count rides in
    the flat vector as a float) come over with fleet_state_from_numpy."""
    run_dense(NN, protocol, dp=4, hub=1, steps=8)


@pytest.mark.parametrize("protocol", ["Synchronous", "FGM"])
def test_per_record_pa(protocol):
    """perRecord PA: the JAX side runs its lax.scan pass, the function its
    Pallas scan computes (that kernel does not trace under this JAX's
    shard_map, whose vma check wants the out shapes' vma set); the port's
    pa_scan runs its plain twin on the CPU, once a step for every worker
    (the batched entry, through vmap over the workers)."""
    run_dense(PA_RECORD, protocol, dp=4, hub=1, steps=6, per_record=True)


@pytest.mark.parametrize("protocol", ["Synchronous", "EASGD", "Asynchronous"])
@pytest.mark.parametrize("dp", [1, 4])
def test_sparse_pa2(protocol, dp):
    jt, tt = build(SPARSE_PA2, protocol, dp, 1)
    data = sparse_steps(10, dp)
    for x, y, m in data:
        jt.step(x, y, m)
        tt.step(x, y, m)
    (idx, val), y, m = data[0]
    assert_same(jt, tt, ((idx[0], val[0]), y[0], m[0]))


def test_ssp_refusals_and_release():
    """Worker 0 runs ahead of starved peers until the staleness bound
    refuses its batch; the accept flags, clocks and the fitted count
    (corrected by note_requeued) follow the JAX trainer step by step, and
    release_stragglers lifts every clock to the fleet max on both."""
    jt, tt = build(PA, "SSP", 4, 1, extra={"staleness": 2})
    refused = 0
    for x, y, m in dense_steps(12, 4, starve=True):
        jt.step(x, y, m)
        tt.step(x, y, m)
        acc = jt.last_accepted()
        np.testing.assert_array_equal(tt.last_accepted(), acc)
        np.testing.assert_array_equal(tt.worker_clocks(), jt.worker_clocks())
        for w in np.nonzero(~acc)[0]:
            k = int(m[w].sum())
            if k:
                refused += 1
                jt.note_requeued(k)
                tt.note_requeued(k)
    assert refused > 0
    jt.release_stragglers()
    tt.release_stragglers()
    np.testing.assert_array_equal(tt.worker_clocks(), jt.worker_clocks())
    assert len(set(tt.worker_clocks().tolist())) == 1
    x, y, m = dense_steps(1, 4, seed=5)[0]
    jt.step(x, y, m)
    tt.step(x, y, m)
    assert_same(jt, tt, (x[0], y[0], m[0]))


@pytest.mark.parametrize("name,hp", [
    ("PA", {"variant": "PA-II", "C": 0.1}), ("RegressorPA", {}),
    ("SVM", {"lambda": 0.01}), ("Softmax", {"nClasses": 3}),
])
def test_fleet_scatter_is_one_offset_scatter(name, hp):
    """fleet_update scatters every worker's update into the [dp * R] view
    of the weights, worker i's indices offset by i * R, and equals dp
    separate updates."""
    learner = make_learner(LearnerSpec(name, hyper_parameters=hp, data_structure={
        "sparse": True, "nFeatures": SPARSE_DIM, "maxNnz": NNZ}))
    dp = 3
    (idx, val), y, m = sparse_steps(1, dp, seed=2)[0]
    idx, val = torch.from_numpy(idx), torch.from_numpy(val)
    y, m = torch.from_numpy(y % 3), torch.from_numpy(m)
    gen = torch.Generator().manual_seed(0)
    workers = []
    for _ in range(dp):
        p = learner.init(SPARSE_DIM, gen)
        key = learner.weight_key
        p[key] = p[key] + torch.randn(p[key].shape, generator=gen)
        workers.append(p)
    fleet = {k: torch.stack([p[k] for p in workers]) for k in workers[0]}
    new, loss = learner.fleet_update(fleet, (idx, val), y, m)
    for i, p in enumerate(workers):
        want, want_loss = learner.update(p, (idx[i], val[i]), y[i], m[i])
        for k in want:
            torch.testing.assert_close(new[k][i], want[k], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(loss[i], want_loss)


def test_step_many_matches_steps():
    """step_many and step_many_dense (loops of steps here) equal the same
    steps one by one, counters and curve watermarks included."""
    data = dense_steps(5, 2, seed=3)
    xs, ys = np.stack([d[0] for d in data]), np.stack([d[1] for d in data])
    ms = np.stack([d[2] for d in data])

    def build_one():
        return SPMDTrainer(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=DIM,
                           protocol="GM", mesh=Mesh(2, 2, "cpu"),
                           training_configuration=TrainingConfiguration(
                               protocol="GM", extra={"syncEvery": 2, "threshold": 0.1}))

    seq, many, dense, seq_dense = build_one(), build_one(), build_one(), build_one()
    for x, y, m in data:
        seq.step(x, y, m)
        seq_dense.step(x, y, np.ones_like(m))
    many.step_many(xs, ys, ms)
    dense.step_many_dense(xs.astype(np.float16), ys)
    for a, b in ((seq, many), (seq_dense, dense)):
        assert a.fitted == b.fitted and a.sync_count() == b.sync_count()
        assert [f for _, f in a.curve_slice()] == [f for _, f in b.curve_slice()]
    np.testing.assert_array_equal(seq.global_flat_params(), many.global_flat_params())
    # the fp16 feed rounds the inputs once, on the device's side of the copy
    ref = build_one()
    ref.step_many_dense(xs.astype(np.float16).astype(np.float32), ys)
    np.testing.assert_array_equal(ref.global_flat_params(), dense.global_flat_params())


def test_no_state_alias_survives_a_step():
    """Every state tensor owns its storage after a sync: an in-place write
    into the weights (the sparse scatter's donation) cannot reach the PS
    estimate or center."""
    jt, tt = build(SPARSE_PA2, "Synchronous", 1, 1)
    for x, y, m in sparse_steps(2, 1):
        tt.step(x, y, m)
    st = tt.state
    tensors = [st["params"]["w"], st["est"], st["center"]]
    ptrs = {t.untyped_storage().data_ptr() for t in tensors}
    assert len(ptrs) == len(tensors)


def test_mesh_rules():
    """make_mesh keeps the reference's rule over the process's slots (one on
    the CPU); an explicit Mesh may hold more workers than slots."""
    assert device_slots("cpu") == 1
    assert make_mesh(device="cpu").shape == {"dp": 1, "hub": 1}
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(dp=2, device="cpu")
    assert Mesh(8, 2, "cpu").shape == {"dp": 8, "hub": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            SPMDTrainer(LearnerSpec("PA"), dim=3)


def test_mesh_default_device_is_cuda():
    """A Mesh with no device wants CUDA, so a trainer on it never runs on
    the CPU unless the caller asks: without a card it raises as StreamJob()
    does."""
    if torch.cuda.is_available():
        assert Mesh(2).device.type == "cuda"
        assert SPMDTrainer(LearnerSpec("PA"), dim=3, mesh=Mesh(2)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="Mesh: CUDA requested"):
            SPMDTrainer(LearnerSpec("PA"), dim=3, mesh=Mesh(2))
    assert Mesh(2, 1, "cpu").device.type == "cpu"


def test_trainer_refusals():
    with pytest.raises(ValueError, match="SPMD engine supports"):
        SPMDTrainer(LearnerSpec("PA"), dim=3, protocol="SingleLearner", device="cpu")
    with pytest.raises(ValueError, match="host-side"):
        SPMDTrainer(LearnerSpec("HT"), dim=3, device="cpu")
    with pytest.raises(ValueError, match="staleness"):
        SPMDTrainer(LearnerSpec("PA"), dim=3, protocol="SSP", device="cpu",
                    training_configuration=TrainingConfiguration(
                        protocol="SSP", extra={"staleness": 0}))
    with pytest.raises(ValueError, match="topk is a host-plane transport codec"):
        SPMDTrainer(LearnerSpec("PA"), dim=3, device="cpu",
                    training_configuration=TrainingConfiguration(extra={"comm": {"codec": "topk"}}))
    # fp16 and int8 are ported (tests/test_torch_codec.py holds them to JAX)
    assert "ef" in SPMDTrainer(LearnerSpec("PA"), dim=3, device="cpu",
                               training_configuration=TrainingConfiguration(
                                   extra={"comm": {"codec": "fp16"}})).state
    tt = SPMDTrainer(LearnerSpec("PA"), dim=3, mesh=Mesh(2, 1, "cpu"))
    with pytest.raises(ValueError, match="not \\[dp=2"):
        fleet_state_from_numpy({"w": np.zeros((3, 1, 4))}, tt)
