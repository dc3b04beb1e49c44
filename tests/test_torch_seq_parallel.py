"""The port's sequence-parallel half against the JAX package: ring and
Ulysses attention over an sp process group, and ``SeqTrainer`` over its
("dp", "sp", "tp") mesh (Megatron tensor parallelism, expert-parallel MoE
over dp, the sharded checkpoint).

Each mesh position of the port is a process of one gloo group: a test
launches its processes once (``python -c WORKER``, at most 4, each launch
bounded at 120 s) and they compute every case of that test in one go. The
JAX side runs here, on the 8 virtual CPU devices of ``tests/conftest.py``,
while the port's processes run; both start from the same numpy inputs and
the same weights (the JAX trainer's ``host_params()``, loaded by
``load_numpy``). Each test names the JAX test it mirrors and keeps its
tolerance.

Worst errors met on this container (the port against the JAX package and
its own one-device trainer): ring forward 4.8e-7 (also on 2 x 2), ring
gradients 2.9e-6, Ulysses forward 4.8e-7; sharded trainer losses 4.8e-7
and parameters 7.7e-7 after 3 steps; Ulysses against ring 4.8e-7 (losses)
and 1.4e-7 (parameters); MoE 4.8e-7 and 7.5e-7; classify 6.0e-8 and
5.7e-7; the fused loss 2.4e-7; the snapshot against the JAX trainer
1.1e-6, and its loads bitwise; bf16 losses within 1.2e-2 of the
one-device run over 31 steps.
"""

import dataclasses
import pickle
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from omldm_tpu.models import transformer as jt
from omldm_tpu.ops.attention import mha_reference as jax_mha
from omldm_tpu.ops.ring_attention import ring_attention as jax_ring
from omldm_tpu.ops.ring_attention import ring_attention_sharded as jax_ring_sharded
from omldm_tpu.ops.ulysses import ulysses_attention_sharded as jax_ulysses_sharded
from omldm_tpu.parallel.seq_trainer import SeqTrainer as JaxSeqTrainer
from omldm_tpu.parallel.seq_trainer import make_seq_mesh as jax_mesh
from omldm_tpu.utils.jaxcompat import shard_map
from omldm_tpu_torch.models import transformer as tt
from omldm_tpu_torch.parallel import SeqTrainer, make_seq_mesh
from omldm_tpu_torch.parallel.ckpt import load_tree
from omldm_tpu_torch.parallel.seq_trainer import SeqMesh

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 120

# One process of a launch: join the gloo group, run every case of the job,
# write one pickle of results. It imports no JAX.
WORKER = textwrap.dedent(r'''
    import pickle, sys
    import numpy as np, torch
    torch.set_num_threads(1)  # four processes on the host's cores: no thread oversubscription
    from omldm_tpu_torch.parallel import multihost
    pid, nproc, port, job_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    multihost.initialize_multihost(f"127.0.0.1:{port}", nproc, pid, device="cpu",
                                   connect_timeout_s=60)
    import torch.distributed as dist
    from omldm_tpu_torch.models import transformer as tt
    from omldm_tpu_torch.ops import ring_attention as ra, ulysses as ul
    from omldm_tpu_torch.parallel.seq_trainer import SeqTrainer, make_seq_mesh
    from omldm_tpu_torch.parallel.ckpt import load_tree

    def block(x, mesh, batch):
        if batch and mesh.groups["dp"] is not None:
            n = x.shape[0] // mesh.shape["dp"]
            x = x[mesh.coords["dp"] * n:(mesh.coords["dp"] + 1) * n]
        lc = x.shape[1] // mesh.shape["sp"]
        return x[:, mesh.coords["sp"] * lc:(mesh.coords["sp"] + 1) * lc]

    def whole(x, mesh, batch):
        if mesh.groups["sp"] is not None:
            x = multihost.all_gather(x, mesh.groups["sp"], dim=1)
        if batch and mesh.groups["dp"] is not None:
            x = multihost.all_gather(x, mesh.groups["dp"], dim=0)
        return x.numpy()

    def attn(case):
        mesh = make_seq_mesh(*case["mesh"])
        if case.get("sharded"):
            fn = ra.ring_attention_sharded if case["fn"] == "ring" else ul.ulysses_attention_sharded
            try:
                out = fn(*(torch.from_numpy(a) for a in case["qkv"]), mesh, case["causal"])
            except ValueError as exc:
                return {"error": str(exc)}
            return {"out": out.numpy()}
        q, k, v = (block(torch.from_numpy(a), mesh, case["batch"]).requires_grad_(True)
                   for a in case["qkv"])
        fn = ra.ring_attention if case["fn"] == "ring" else ul.ulysses_attention
        out = fn(q, k, v, mesh.groups["sp"], case["causal"])
        (out ** 2).sum().backward()
        return {"out": whole(out.detach(), mesh, case["batch"]),
                "grads": [whole(t.grad, mesh, case["batch"]) for t in (q, k, v)]}

    def train(case):
        mesh = make_seq_mesh(*case["mesh"])
        tr = SeqTrainer(tt.TransformerConfig(**case["cfg"]), mesh=mesh, device="cpu",
                        lr=case["lr"])
        if "load" in case:
            tr.load(case["load"])
        else:
            tr.load_numpy(case["params"])
        losses, calls, nbytes = [], [], []
        for batch in case["batches"]:
            multihost.group_calls = multihost.group_bytes = 0
            losses.append(float(tr.step(*batch)))
            calls.append(multihost.group_calls)
            nbytes.append(multihost.group_bytes)
        if "save" in case:
            tr.save(case["save"])
        params = tr.host_params()
        return {"losses": losses, "params": params, "fitted": tr.fitted,
                "group_calls": calls, "group_bytes": nbytes}

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    results = [attn(c) if c["kind"] == "attn" else train(c) for c in job]
    with open(f"{job_path}.{pid}", "wb") as f:
        pickle.dump(results, f)
    multihost.shutdown_multihost()
''')


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Launch:
    """``nproc`` worker processes running ``cases``; :meth:`results` waits
    (each launch bounded) and returns every process's result list."""

    def __init__(self, nproc, cases, tmp_path: Path):
        self.job = tmp_path / f"job{_free_port()}.pkl"
        with open(self.job, "wb") as f:
            pickle.dump(cases, f)
        port = str(_free_port())
        self.procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(pid), str(nproc),
                                        port, str(self.job)], cwd=ROOT,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
                      for pid in range(nproc)]

    def results(self):
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (_, err) in zip(self.procs, outs):
            assert p.returncode == 0, err[-3000:]
        results = []
        for pid in range(len(self.procs)):
            with open(f"{self.job}.{pid}", "rb") as f:
                results.append(pickle.load(f))
        return results


def _qkv(b=2, l=64, h=2, dh=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, l, h, dh).astype(np.float32) for _ in range(3)]


def _jax_mesh(n, name="sp"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


# --- ring and Ulysses attention ---------------------------------------------

# (mesh, sp): sp 2 runs on a (1, 2, 2) mesh (the two tp rings compute alike)
ATTN_MESHES = [((1, 2, 2), 2), ((1, 4, 1), 4)]


def test_ring_matches_full(tmp_path):
    """tests/test_ring_attention.py::test_ring_matches_full at sp 2 and 4,
    causal and not: forward atol 1e-5 against mha_reference and the JAX
    ring on the same inputs."""
    qkv = _qkv()
    cases = [dict(kind="attn", fn="ring", sharded=True, mesh=m, causal=c, qkv=qkv)
             for m, _ in ATTN_MESHES for c in (False, True)]
    run = Launch(4, cases, tmp_path)
    want = [(jax_ring_sharded(*qkv, _jax_mesh(sp), causal=c), jax_mha(*qkv, causal=c))
            for _, sp in ATTN_MESHES for c in (False, True)]
    for per_process in run.results():
        for got, (ring, ref) in zip(per_process, want):
            _close(got["out"], ref, 1e-5)
            _close(got["out"], ring, 1e-5)


def test_ring_grad_flows(tmp_path):
    """tests/test_ring_attention.py::test_ring_grad_flows at sp 4: the
    gradients of sum(out ** 2) through the ring (dK/dV carried home) equal
    mha_reference's, atol 1e-4 (the JAX test holds its ring to the same
    gradients)."""
    qkv = _qkv(b=1, l=32)
    run = Launch(4, [dict(kind="attn", fn="ring", mesh=(1, 4, 1), causal=True, batch=False,
                          qkv=qkv)], tmp_path)
    g_ref = jax.grad(lambda *a: jnp.sum(jax_mha(*a, causal=True) ** 2), argnums=(0, 1, 2))(*qkv)
    for [got] in run.results():
        for g, ref in zip(got["grads"], g_ref):
            _close(g, ref, 1e-4)


def test_ring_inside_shard_map_2d_mesh(tmp_path):
    """tests/test_ring_attention.py::test_ring_inside_shard_map_2d_mesh on
    2 x 2 processes: the batch split over dp, the ring over sp; forward atol
    1e-5 against mha_reference and the JAX ring on a 2 x 2 mesh."""
    qkv = _qkv(b=4, l=32)
    run = Launch(4, [dict(kind="attn", fn="ring", mesh=(2, 2, 1), causal=True, batch=True,
                          qkv=qkv)], tmp_path)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    spec = P("dp", "sp", None, None)
    ring = shard_map(lambda q, k, v: jax_ring(q, k, v, "sp", causal=True), mesh=mesh,
                     in_specs=(spec, spec, spec), out_specs=spec)(*qkv)
    ref = jax_mha(*qkv, causal=True)
    for [got] in run.results():
        _close(got["out"], ref, 1e-5)
        _close(got["out"], ring, 1e-5)


def test_ulysses_matches_full(tmp_path):
    """tests/test_ulysses.py::test_ulysses_matches_full at sp 2 and 4, causal
    and not (4 heads): forward atol 1e-5 against mha_reference and the JAX
    Ulysses."""
    qkv = _qkv(h=4)
    cases = [dict(kind="attn", fn="ulysses", sharded=True, mesh=m, causal=c, qkv=qkv)
             for m, _ in ATTN_MESHES for c in (False, True)]
    run = Launch(4, cases, tmp_path)
    want = [(jax_ulysses_sharded(*qkv, _jax_mesh(sp), causal=c), jax_mha(*qkv, causal=c))
            for _, sp in ATTN_MESHES for c in (False, True)]
    for per_process in run.results():
        for got, (uly, ref) in zip(per_process, want):
            _close(got["out"], ref, 1e-5)
            _close(got["out"], uly, 1e-5)


def test_ulysses_rejects_indivisible_heads(tmp_path):
    """tests/test_ulysses.py::test_ulysses_rejects_indivisible_heads: 3
    heads over sp 2 raise the JAX ValueError on every process (as 4 heads
    over the JAX test's 8)."""
    qkv = _qkv(h=3, l=16)
    run = Launch(2, [dict(kind="attn", fn="ulysses", sharded=True, mesh=(1, 2, 1),
                          causal=False, qkv=qkv)], tmp_path)
    with pytest.raises(ValueError, match="not divisible"):
        jax_ulysses_sharded(*_qkv(h=4, l=16), _jax_mesh(8), causal=False)
    for [got] in run.results():
        assert "not divisible" in got["error"]


# --- SeqTrainer over the mesh ----------------------------------------------

CFG = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_len=64,
           objective="lm")


def _copy_batch(rng, b, l, vocab):
    """Repeating-pattern sequences (the JAX tests' ``_copy_batch``)."""
    base = rng.randint(1, vocab, size=(b, 4))
    toks = np.tile(base, (1, l // 4 + 1))[:, : l + 1]
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32),
            np.ones((b, l), np.float32))


def _jcfg(cfg):
    dtype = jnp.bfloat16 if cfg.get("dtype") == "bfloat16" else jnp.float32
    return jt.TransformerConfig(**{**cfg, "dtype": dtype})


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Reference:
    """The JAX trainer at one mesh and the port's one-device trainer, from
    the JAX trainer's initial weights, stepped on the same batches."""

    def __init__(self, cfg, mesh, lr, seed, batches):
        self.jax = JaxSeqTrainer(_jcfg(cfg), mesh=jax_mesh(*mesh), lr=lr, seed=seed)
        self.start = _host(self.jax.host_params())
        self.single = SeqTrainer(tt.TransformerConfig(**cfg), device="cpu", lr=lr)
        self.single.load_numpy(self.start)
        self.batches = batches

    def run(self):
        self.jax_losses = [float(self.jax.step(*b)) for b in self.batches]
        self.single_losses = [float(self.single.step(*b)) for b in self.batches]
        return self


def _params_close(a, b, atol):
    la, lb = tt.tree_leaves(a), tt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        _close(x, y, atol)


def _train_case(ref, cfg, mesh, lr, **extra):
    return dict(kind="train", cfg=cfg, mesh=mesh, lr=lr, params=ref.start,
                batches=ref.batches, **extra)


def _group_calls(cfg, mesh):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.seqpar_group_calls(cfg, *mesh)


SHARDED_MESHES = [(1, 2, 2), (2, 2, 1), (2, 1, 2), (1, 4, 1)]


def test_sharded_step_matches_single_device(tmp_path):
    """tests/test_transformer.py::test_sharded_step_matches_single_device at
    (1, 2, 2), (2, 2, 1), (2, 1, 2), (1, 4, 1): 3 steps, each against the
    port's one-device trainer and the JAX trainer at the same mesh (loss
    1e-4, parameters 2e-4); every process holds the same loss, and the
    group calls a step are chip_smoke's count."""
    batch = _copy_batch(np.random.RandomState(1), 4, 16, CFG["vocab_size"])
    refs = [Reference(CFG, m, 1e-2, 3, [batch] * 3) for m in SHARDED_MESHES]
    run = Launch(4, [_train_case(r, CFG, m, 1e-2) for r, m in zip(refs, SHARDED_MESHES)],
                 tmp_path)
    for r in refs:
        r.run()
    results = run.results()
    for i, (ref, mesh) in enumerate(zip(refs, SHARDED_MESHES)):
        got = results[0][i]
        assert all(p[i]["losses"] == got["losses"] for p in results)
        _close(got["losses"], ref.single_losses, 1e-4)
        _close(got["losses"], ref.jax_losses, 1e-4)
        _params_close(got["params"], ref.single.host_params(), 2e-4)
        _params_close(got["params"], _host(ref.jax.host_params()), 2e-4)
        assert got["fitted"] == ref.single.fitted == ref.jax.fitted
        want = _group_calls(CFG, mesh)
        assert all(c == want for p in results for c in p[i]["group_calls"])


def test_seqtrainer_ulysses_matches_ring(tmp_path):
    """tests/test_ulysses.py::test_seqtrainer_ulysses_matches_ring at
    (1, 2, 2) (4 heads): ring and Ulysses train alike (loss 1e-4,
    parameters 2e-4), as the one-device trainer and the JAX trainers at the
    same mesh do."""
    cfg = dict(vocab_size=32, d_model=16, n_heads=4, n_layers=2, d_ff=32, max_len=64)
    rng = np.random.RandomState(0)
    toks = np.tile(rng.randint(1, 32, size=(4, 4)), (1, 5))[:, :17]
    batch = (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32),
             np.ones((4, 16), np.float32))
    mesh = (1, 2, 2)
    refs = {s: Reference(dict(cfg, seq_parallel=s), mesh, 1e-2, 21, [batch] * 3)
            for s in ("ring", "ulysses")}
    run = Launch(4, [_train_case(refs[s], dict(cfg, seq_parallel=s), mesh, 1e-2)
                     for s in ("ring", "ulysses")], tmp_path)
    for r in refs.values():
        r.run()
    results = run.results()
    ring, uly = results[0]
    _close(ring["losses"], uly["losses"], 1e-4)
    _params_close(ring["params"], uly["params"], 2e-4)
    for got, s in ((ring, "ring"), (uly, "ulysses")):
        _close(got["losses"], refs[s].single_losses, 1e-4)
        _close(got["losses"], refs[s].jax_losses, 1e-4)
        want = _group_calls(dict(cfg, seq_parallel=s), mesh)
        assert all(c == want for p in results for c in p[["ring", "ulysses"].index(s)]
                   ["group_calls"])


EP_MESHES = [(2, 2, 1), (4, 1, 1)]


def test_moe_expert_parallel_matches_dense_dispatch(tmp_path):
    """tests/test_transformer.py::test_moe_expert_parallel_matches_dense_dispatch
    at (2, 2, 1) and (4, 1, 1): 4 experts over ep = dp with capacity 4.0 (no
    token drops), 2 steps, loss 1e-4 against the one-device trainer and the
    JAX trainer at the same mesh; the parameters (the experts gathered) at
    2e-4."""
    cfg = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=64,
               n_experts=4, capacity_factor=4.0)
    batch = _copy_batch(np.random.RandomState(2), 4, 16, 32)
    refs = [Reference(cfg, m, 1e-2, 5, [batch] * 2) for m in EP_MESHES]
    run = Launch(4, [_train_case(r, cfg, m, 1e-2) for r, m in zip(refs, EP_MESHES)], tmp_path)
    for r in refs:
        r.run()
    results = run.results()
    for i, (ref, mesh) in enumerate(zip(refs, EP_MESHES)):
        got = results[0][i]
        _close(got["losses"], ref.single_losses, 1e-4)
        _close(got["losses"], ref.jax_losses, 1e-4)
        _params_close(got["params"], ref.single.host_params(), 2e-4)
        want = _group_calls(cfg, mesh)
        assert all(c == want for p in results for c in p[i]["group_calls"])


CLASSIFY_MESHES = [(2, 1, 2), (2, 2, 1), (1, 2, 2)]


def test_classify_objective_sharded(tmp_path):
    """tests/test_transformer.py::test_classify_objective_sharded at
    (2, 1, 2), (2, 2, 1), (1, 2, 2): tokens split over sp, pooled by the
    mean over sp, labels over dp; 3 steps, loss 1e-4 against the one-device
    trainer and the JAX trainer at the same mesh, and the parameters (the
    head summed over dp only) at 2e-4."""
    cfg = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=64,
               objective="classify", n_classes=2, causal=False)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, 32, size=(8, 16)).astype(np.int32)
    labels = (tokens.sum(axis=1) % 2).astype(np.int32)
    refs = [Reference(cfg, m, 1e-2, 7, [(tokens, labels)] * 3) for m in CLASSIFY_MESHES]
    run = Launch(4, [_train_case(r, cfg, m, 1e-2) for r, m in zip(refs, CLASSIFY_MESHES)],
                 tmp_path)
    for r in refs:
        r.run()
    results = run.results()
    for i, (ref, mesh) in enumerate(zip(refs, CLASSIFY_MESHES)):
        got = results[0][i]
        _close(got["losses"], ref.single_losses, 1e-4)
        _close(got["losses"], ref.jax_losses, 1e-4)
        _params_close(got["params"], ref.single.host_params(), 2e-4)
        want = _group_calls(cfg, mesh)
        assert all(c == want for p in results for c in p[i]["group_calls"])


def test_fused_loss_trains_sharded(tmp_path):
    """tests/test_transformer.py::test_fused_loss_trains_sharded at
    (1, 2, 2): the chunked loss (loss_chunk 16) on the mesh follows the
    unfused one-device run, loss 1e-4, and the JAX fused trainer at the same
    mesh."""
    batch = _copy_batch(np.random.RandomState(12), 4, 16, CFG["vocab_size"])
    fused = dict(CFG, loss_chunk=16)
    ref = Reference(fused, (1, 2, 2), 1e-2, 5, [batch] * 3)
    plain = SeqTrainer(tt.TransformerConfig(**CFG), device="cpu", lr=1e-2)
    plain.load_numpy(ref.start)
    run = Launch(4, [_train_case(ref, fused, (1, 2, 2), 1e-2)], tmp_path)
    ref.run()
    plain_losses = [float(plain.step(*batch)) for _ in range(3)]
    for [got] in run.results():
        _close(got["losses"], plain_losses, 1e-4)
        _close(got["losses"], ref.jax_losses, 1e-4)


def test_bf16_mixed_precision_trains_and_matches_sharded(tmp_path):
    """tests/test_transformer.py::test_bf16_mixed_precision_trains_and_matches_sharded
    at (1, 2, 2): bf16 compute over float32 master weights; after 31 steps
    the one-device loss is below 0.7 of its first and the mesh's within
    0.15 of it; the master weights stay float32."""
    cfg = dict(CFG, dtype="bfloat16")
    batch = _copy_batch(np.random.RandomState(6), 4, 16, 32)
    ref = Reference(cfg, (1, 2, 2), 1e-2, 13, [batch] * 31)
    run = Launch(4, [_train_case(ref, cfg, (1, 2, 2), 1e-2)], tmp_path)
    single = [float(ref.single.step(*batch)) for _ in range(31)]
    assert single[-1] < single[0] * 0.7
    for [got] in run.results():
        assert abs(got["losses"][-1] - single[-1]) <= 0.15
        assert got["losses"][-1] < got["losses"][0] * 0.7
        assert all(a.dtype == np.float32 for a in tt.tree_leaves(got["params"]))


def test_seq_trainer_checkpoint_roundtrip(tmp_path):
    """tests/test_trainer_ckpt.py::test_seq_trainer_checkpoint_roundtrip on
    meshes: a trainer saved at (1, 2, 2) after 2 steps writes the global
    tree, equal to the JAX trainer's ``host_params()`` after the same steps
    within 2e-4; it loads at (1, 1, 1) and at (2, 1, 2) with the same
    parameters and fitted count, and both take the next step alike (loss
    1e-4); a one-device snapshot loads at (1, 2, 2) as it was saved."""
    rng = np.random.RandomState(0)
    toks = rng.randint(1, 32, size=(4, 17))
    batch = (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32),
             np.ones((4, 16), np.float32))
    cfg = dict(CFG, max_len=32)
    ref = Reference(cfg, (1, 2, 2), 1e-2, 1, [batch] * 2)
    one = tmp_path / "one"
    ref.single.save(str(one))
    sharded = tmp_path / "sharded"
    run = Launch(4, [
        _train_case(ref, cfg, (1, 2, 2), 1e-2, save=str(sharded)),
        dict(kind="train", cfg=cfg, mesh=(2, 1, 2), lr=1e-2, load=str(sharded),
             batches=[batch]),
        dict(kind="train", cfg=cfg, mesh=(1, 2, 2), lr=1e-2, load=str(one), batches=[]),
    ], tmp_path)
    ref.run()
    results = run.results()
    saved, resumed, from_one = results[0]
    snap = load_tree(str(sharded))
    assert int(snap["fitted"]) == saved["fitted"] == ref.jax.fitted == 2 * 4 * 16
    _params_close(snap["params"], _host(ref.jax.host_params()), 2e-4)
    _params_close(snap["params"], saved["params"], 0)
    assert int(snap["opt"]["count"]) == 2
    _params_close(from_one["params"], ref.start, 0)  # the one-device save: before its steps
    local = SeqTrainer(tt.TransformerConfig(**cfg), device="cpu", lr=1e-2, seed=99)
    local.load(str(sharded))
    assert local.fitted == saved["fitted"]
    _params_close(local.host_params(), snap["params"], 0)
    _close(resumed["losses"], [float(local.step(*batch))], 1e-4)
    _params_close(resumed["params"], local.host_params(), 2e-4)


# --- in one process -----------------------------------------------------------


def _mesh(dp, sp, tp):
    return SeqMesh({"dp": dp, "sp": sp, "tp": tp}, {"dp": 0, "sp": 0, "tp": 0},
                   {"dp": None, "sp": None, "tp": None}, 0, 1)


@pytest.mark.parametrize("change,shape,message", [
    ({"n_heads": 2}, (1, 1, 4), "n_heads 2 not divisible by tp 4"),
    ({"d_ff": 30}, (1, 1, 4), "d_ff 30 not divisible by tp 4"),
    ({"n_experts": 3}, (2, 1, 1), "n_experts 3 not divisible by dp 2"),
    ({"seq_parallel": "zigzag"}, (1, 1, 1), "seq_parallel must be 'ring' or 'ulysses'"),
    ({"seq_parallel": "ulysses", "n_heads": 4}, (1, 4, 2), "per-tp-shard head count"),
])
def test_constructor_validations(change, shape, message):
    """The JAX constructor's ValueErrors (``parallel/seq_trainer.py:101-118``),
    with its messages; the same configs pass the JAX trainer's checks
    alike."""
    cfg = tt.TransformerConfig(**{**CFG, "d_model": 32, "n_heads": 4, **change})
    with pytest.raises(ValueError, match=re.escape(message)):
        SeqTrainer(cfg, mesh=_mesh(*shape), device="cpu")
    jcfg = _jcfg({**CFG, "d_model": 32, "n_heads": 4, **change})
    with pytest.raises(ValueError, match=re.escape(message)):
        JaxSeqTrainer(jcfg, mesh=jax_mesh(*shape))


def test_mesh_needs_its_processes():
    """A mesh needs exactly dp * sp * tp processes; (1, 1, 1) without a
    group is the one device."""
    with pytest.raises(ValueError, match=r"mesh \(2x1x2\) needs 4 processes, have 1"):
        make_seq_mesh(2, 1, 2)
    mesh = make_seq_mesh()
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1} and mesh.world == 1
    assert all(g is None for g in mesh.groups.values())


def test_step_with_valid_count_reads_no_mask(monkeypatch):
    """``step(valid_count=)`` counts the fitted tokens from the caller's
    number: no tensor is read back to the host (here any such read
    raises), as the JAX trainer's ``valid_count`` avoids its device->host
    copy; without it the mask is summed on the host."""
    tr = SeqTrainer(tt.TransformerConfig(**CFG), device="cpu", lr=1e-2)
    tok, tgt, mask = _copy_batch(np.random.RandomState(4), 2, 16, 32)
    mask = torch.from_numpy(mask)

    def no_read(self, *a):
        raise AssertionError("a tensor was read back to the host")

    with monkeypatch.context() as m:
        for name in ("__int__", "__index__", "__float__", "item", "tolist"):
            m.setattr(torch.Tensor, name, no_read)
        tr.step(tok, tgt, mask, valid_count=7)
        tr.step_many(np.stack([tok]), np.stack([tgt]), mask[None], valid_counts=[5])
        with pytest.raises(AssertionError, match="read back"):
            tr.step(tok, tgt, mask)
    assert tr.fitted == 12
    tr.step(tok, tgt, mask)
    assert tr.fitted == 12 + 32


def test_param_placement_table():
    """The JAX ``_param_specs``: wqkv on its last dimension and wo on its
    first over tp, dense w1/w2 as Megatron's column and row halves, MoE
    w1/w2 on the expert dimension over dp, everything else whole; a global
    tree sliced at every coordinate and gathered back is itself."""
    from omldm_tpu.parallel.seq_trainer import _param_specs as jax_specs
    from omldm_tpu_torch.parallel.ckpt import shard_tree
    from omldm_tpu_torch.parallel.seq_trainer import _param_specs

    for cfg in (CFG, dict(CFG, n_experts=4)):
        specs = tt.tree_leaves(_param_specs(tt.TransformerConfig(**cfg)))
        jspecs = jax.tree_util.tree_leaves(jax_specs(_jcfg(cfg)),
                                           is_leaf=lambda x: isinstance(x, P))
        assert len(specs) == len(jspecs)
        for spec, jspec in zip(specs, jspecs):
            named = [(i, a) for i, a in enumerate(jspec) if a is not None]
            assert named == ([] if spec is None else [(spec.dim, spec.axis)])
        params = _host(jt.init_transformer(_jcfg(cfg), jax.random.PRNGKey(0)))
        pspecs = _param_specs(tt.TransformerConfig(**cfg))
        for shape in ((2, 1, 2), (1, 2, 1)):
            blocks = {}
            for d in range(shape[0]):
                for t in range(shape[2]):
                    mesh = SeqMesh(dict(zip("dp sp tp".split(), shape)),
                                   {"dp": d, "sp": 0, "tp": t}, {}, 0, 1)
                    blocks[(d, t)] = tt.tree_leaves(shard_tree(params, pspecs, mesh))
            for j, (leaf, spec) in enumerate(zip(tt.tree_leaves(params), specs)):
                if spec is None:
                    assert all(b[j] is leaf for b in blocks.values())
                    continue
                n = shape[0] if spec.axis == "dp" else shape[2]
                parts = [blocks[(i, 0) if spec.axis == "dp" else (0, i)][j] for i in range(n)]
                np.testing.assert_array_equal(np.concatenate(parts, axis=spec.dim), leaf)


def test_ring_live_pairs_and_launch_rule():
    """The ring's schedule: under causal, process s launches its s + 1
    pairs with src <= s (the diagonal first); without, all sp."""
    from omldm_tpu_torch.ops.ring_attention import live_pairs

    for n in (2, 4):
        for s in range(n):
            pairs = live_pairs(s, n, True)
            assert pairs[0] == (0, s, True)
            assert [src for _, src, live in pairs if live] == list(range(s, -1, -1))
            assert sum(live for *_, live in live_pairs(s, n, False)) == n


def test_single_process_ring_and_ulysses_take_no_group():
    """Without an sp group the sharded wrappers are the flash attention
    itself (the JAX ``n == 1`` branch)."""
    from omldm_tpu_torch.ops import attention as tatt
    from omldm_tpu_torch.ops.ring_attention import ring_attention_sharded
    from omldm_tpu_torch.ops.ulysses import ulysses_attention_sharded

    q, k, v = (torch.from_numpy(a) for a in _qkv(l=16))
    ref = tatt.flash_attention(q, k, v, True)
    for fn in (ring_attention_sharded, ulysses_attention_sharded):
        assert torch.equal(fn(q, k, v, make_seq_mesh(), True), ref)


def test_transformer_takes_the_jax_config_fields():
    """A JAX config's fields, seq_parallel included, build the port's
    config (the parity tests above build both from one dict)."""
    jcfg = jt.TransformerConfig(seq_parallel="ulysses", n_experts=2)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = tt.TransformerConfig(**fields)
    assert cfg.seq_parallel == "ulysses" and cfg.n_experts == 2


@pytest.mark.parametrize("b", [1, 2])
def test_backward_hands_the_kernels_contiguous_row_statistics(b, monkeypatch):
    """The backward's delta (and lse) reach the dQ and dK/dV kernels as the
    contiguous [B*H, Lq] float32 they take, at B = 1 too: there the
    transposed row sums reshape to a strided view, which the kernels'
    check refused on the card (phase 51's float32 case at B = 1 found it)."""
    from omldm_tpu_torch.ops import attention as tatt

    seen = []
    real = tatt.flash_attention_bwd

    def spy(q, k, v, dout, lse, delta, *args):
        seen.append((lse.is_contiguous(), delta.is_contiguous(), tuple(delta.shape)))
        return real(q, k, v, dout, lse, delta, *args)

    monkeypatch.setattr(tatt, "flash_attention_bwd", spy)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(b=b, l=16, h=3))
    tatt.attention(q, k, v, causal=True).square().sum().backward()
    assert seen == [(True, True, (b * 3, 16))]
    out = torch.randn(b, 16, 3, 8)
    delta = tatt.row_delta(out, out)
    assert delta.is_contiguous() and torch.allclose(
        delta, out.square().sum(-1).transpose(1, 2).reshape(b * 3, 16))
