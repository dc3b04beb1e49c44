"""Trainer checkpoints: save -> fresh trainer -> load -> identical training.

- ``SeqTrainer`` (the CPU: the attention kernels' plain twins): a trainer
  saved after two steps and loaded into a fresh one (another seed) holds
  the same parameters, optimizer state and fitted count bitwise, and the
  next step gives both the same loss and parameters bitwise -- as an
  uninterrupted run. Held to JAX tests/test_trainer_ckpt.py's round trip
  from the same numpy parameters (JAX ``SeqTrainer`` on a one-device mesh):
  losses and parameters at atol 1e-5 (tests/test_torch_transformer.py's
  float32 tolerance).
- ``SPMDTrainer`` at ``Mesh(4, 2)``: the fleet state survives save/load
  bitwise, the snapshot is a numpy tree in the JAX trainer's layout
  (leaves ``[dp, hub, ...]``), and the loaded trainer steps as the saved
  one does.
"""

import jax
import numpy as np
import pytest
import torch

from omldm_tpu.models import transformer as jt
from omldm_tpu.parallel.seq_trainer import SeqTrainer as JaxSeqTrainer
from omldm_tpu.parallel.seq_trainer import make_seq_mesh
from omldm_tpu_torch.api.requests import LearnerSpec, TrainingConfiguration
from omldm_tpu_torch.models import transformer as tt
from omldm_tpu_torch.parallel import SeqTrainer
from omldm_tpu_torch.parallel.ckpt import load_tree
from omldm_tpu_torch.parallel.mesh import Mesh
from omldm_tpu_torch.parallel.spmd import SPMDTrainer

DIMS = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=32)
ATOL = 1e-5


def _batch(rng, b=4, l=16):
    toks = rng.randint(1, 32, size=(b, l + 1))
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32),
            np.ones((b, l), np.float32))


def _assert_trees_equal(a, b):
    la, lb = tt.tree_leaves(a), tt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_seq_trainer_checkpoint_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    cfg = tt.TransformerConfig(**DIMS)
    tr = SeqTrainer(cfg, device="cpu", lr=1e-2, seed=1)
    for _ in range(2):
        tr.step(*batch)
    tr.save(str(tmp_path / "ck"))
    fresh = SeqTrainer(cfg, device="cpu", lr=1e-2, seed=99)
    fresh.load(str(tmp_path / "ck"))
    assert fresh.fitted == tr.fitted == 2 * 4 * 16
    _assert_trees_equal(fresh.params, tr.params)
    _assert_trees_equal(fresh.opt, tr.opt)
    # continued training is bitwise the uninterrupted run's
    assert torch.equal(tr.step(*batch), fresh.step(*batch))
    _assert_trees_equal(fresh.params, tr.params)


def test_seq_trainer_roundtrip_matches_jax(tmp_path):
    """The JAX round trip and the port's from the same numpy parameters:
    two steps, save, load into a fresh trainer, one more step."""
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    jcfg = jt.TransformerConfig(**DIMS)
    jtr = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=1e-2, seed=1)
    ttr = SeqTrainer(tt.TransformerConfig(**DIMS), device="cpu", lr=1e-2)
    ttr.load_numpy(jtr.host_params())
    for _ in range(2):
        jtr.step(*batch)
        ttr.step(*batch)
    jtr.save(str(tmp_path / "jax"))
    ttr.save(str(tmp_path / "port"))
    jfresh = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=1e-2, seed=99)
    jfresh.load(str(tmp_path / "jax"))
    tfresh = SeqTrainer(tt.TransformerConfig(**DIMS), device="cpu", lr=1e-2, seed=99)
    tfresh.load(str(tmp_path / "port"))
    assert tfresh.fitted == jfresh.fitted
    jl, tl = float(np.asarray(jfresh.step(*batch))), float(tfresh.step(*batch))
    assert abs(tl - jl) <= ATOL
    jleaves = jax.tree_util.tree_leaves(jfresh.host_params())
    tleaves = tt.tree_leaves(tfresh.params)
    assert len(jleaves) == len(tleaves)
    for x, y in zip(jleaves, tleaves):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=ATOL, rtol=0)
    assert int(tfresh.opt["count"]) == int(np.asarray(jfresh.opt["count"])) == 3
    # the snapshot is a numpy tree: no tensor, so it loads on any device
    host = load_tree(str(tmp_path / "port"))
    assert all(isinstance(leaf, np.ndarray) for leaf in tt.tree_leaves(host["params"]))


MOE_DIMS = dict(DIMS, n_experts=4, remat=True)


def test_moe_trainer_checkpoint_roundtrip(tmp_path):
    """An MoE + remat trainer: save after two steps, load into a fresh one
    (another seed): the router and expert leaves, optimizer and count come
    back bitwise, and the next step is bitwise the uninterrupted run's."""
    rng = np.random.RandomState(2)
    batch = _batch(rng)
    cfg = tt.TransformerConfig(**MOE_DIMS)
    tr = SeqTrainer(cfg, device="cpu", lr=1e-2, seed=1)
    for _ in range(2):
        tr.step(*batch)
    tr.save(str(tmp_path / "moe"))
    host = load_tree(str(tmp_path / "moe"))
    assert host["params"]["layers"][0]["w1"].shape == (4, 16, 32)
    assert host["params"]["layers"][0]["router"].shape == (16, 4)
    fresh = SeqTrainer(cfg, device="cpu", lr=1e-2, seed=99)
    fresh.load(str(tmp_path / "moe"))
    _assert_trees_equal(fresh.params, tr.params)
    _assert_trees_equal(fresh.opt, tr.opt)
    assert fresh.fitted == tr.fitted
    assert torch.equal(tr.step(*batch), fresh.step(*batch))
    _assert_trees_equal(fresh.params, tr.params)


def test_moe_trainer_roundtrip_matches_jax(tmp_path):
    """The JAX MoE round trip (its expert-parallel block on a one-device
    mesh, orbax snapshot) and the port's (numpy snapshot)
    from the same numpy parameters: two steps, save, load into fresh
    trainers, one more step; losses and parameters at atol 1e-5."""
    rng = np.random.RandomState(1)
    batch = _batch(rng)
    jcfg = jt.TransformerConfig(**MOE_DIMS)
    jtr = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=1e-2, seed=1)
    ttr = SeqTrainer(tt.TransformerConfig(**MOE_DIMS), device="cpu", lr=1e-2)
    ttr.load_numpy(jtr.host_params())
    for _ in range(2):
        jtr.step(*batch)
        ttr.step(*batch)
    jtr.save(str(tmp_path / "jax"))
    ttr.save(str(tmp_path / "port"))
    jfresh = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=1e-2, seed=99)
    jfresh.load(str(tmp_path / "jax"))
    tfresh = SeqTrainer(tt.TransformerConfig(**MOE_DIMS), device="cpu", lr=1e-2, seed=99)
    tfresh.load(str(tmp_path / "port"))
    jl, tl = float(np.asarray(jfresh.step(*batch))), float(tfresh.step(*batch))
    assert abs(tl - jl) <= ATOL
    jleaves = jax.tree_util.tree_leaves(jfresh.host_params())
    tleaves = tt.tree_leaves(tfresh.params)
    assert len(jleaves) == len(tleaves)
    for x, y in zip(jleaves, tleaves):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=ATOL, rtol=0)


def _spmd(protocol="Synchronous"):
    return SPMDTrainer(LearnerSpec("PA", hyper_parameters={"C": 1.0}), dim=6, protocol=protocol,
                       mesh=Mesh(4, 2, "cpu"),
                       training_configuration=TrainingConfiguration(protocol=protocol,
                                                                    extra={"syncEvery": 2}))


def _steps(trainer, rng, n):
    for _ in range(n):
        x = rng.randn(4, 32, 6).astype(np.float32)
        trainer.step(x, (x.sum(-1) > 0).astype(np.float32), np.ones((4, 32), np.float32))


@pytest.mark.parametrize("protocol", ["Synchronous", "Asynchronous", "EASGD"])
def test_spmd_trainer_save_load_roundtrip(tmp_path, protocol):
    t = _spmd(protocol)
    _steps(t, np.random.RandomState(0), 5)
    t.save(str(tmp_path / "spmd"))
    host = load_tree(str(tmp_path / "spmd"))
    assert host["params"]["w"].shape == (4, 2, 7)
    assert host["step"].shape == (4, 2)
    t2 = _spmd(protocol)
    t2.load(str(tmp_path / "spmd"))
    for key, leaf in t.state.items():
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(leaf, t2.state[key]), key
    assert t2._steps_host == t._steps_host == 5
    rng_a, rng_b = np.random.RandomState(1), np.random.RandomState(1)
    _steps(t, rng_a, 3)
    _steps(t2, rng_b, 3)
    np.testing.assert_array_equal(t2.global_flat_params(), t.global_flat_params())
