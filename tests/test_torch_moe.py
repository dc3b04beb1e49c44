"""The port's switch mixture of experts and remat against the JAX package, on
the same numpy inputs and parameters (JAX ``init_transformer`` carried
across by ``params_from_numpy``).

- the port's one MoE block, ``_moe_block`` (a ``[E, C, D]`` dispatch
  buffer), against both JAX forms: ``_moe_block_dense`` (what the JAX
  package runs with no mesh axes) and ``_moe_block_ep`` on a one-device
  mesh (its all_to_alls are identities there; what the JAX trainer runs):
  outputs and gradients, including a rigged router that sends every token
  to one expert, so capacity drops most of them.
- ``lm_loss`` and its gradients with ``n_experts=4``, with and without
  ``remat``; 3 ``SeqTrainer`` steps against the JAX ``SeqTrainer`` at
  ``make_seq_mesh(1, 1, 1)`` (which runs the expert-parallel block).
- ``remat=True`` against ``remat=False`` in the port, and the flash forward
  run again in the backward pass under remat.

Tolerances, float32: block outputs and gradients atol 1e-5 against JAX
(met: <= 2e-7); losses atol 1e-5 and
gradients 1e-5; parameters after 3 Adam steps atol 1e-4 (met: ~1e-7; the
limit of tests/test_torch_transformer.py's float32 trainer tolerance
widened tenfold for the gate's softmax, argmax and capacity mask); the
port's remat run against its plain run atol 1e-6 (the same products in
the same order: met exactly or to float32 rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from omldm_tpu.models import transformer as jt
from omldm_tpu.parallel.seq_trainer import SeqTrainer as JaxSeqTrainer
from omldm_tpu.parallel.seq_trainer import make_seq_mesh
from omldm_tpu.utils.jaxcompat import shard_map
from omldm_tpu_torch.models import transformer as tt
from omldm_tpu_torch.ops import attention as tatt
from omldm_tpu_torch.parallel import SeqTrainer

DIMS = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64)
MOE = dict(DIMS, n_experts=4)


def _cfgs(**kw):
    return (jt.TransformerConfig(**{**MOE, **kw}),
            tt.TransformerConfig(**{**MOE, **kw, "dtype": "float32"}))


def _params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jt.init_transformer(jcfg, jax.random.PRNGKey(seed)))


def _layer(seed, d=8, f=16, e=4, rigged=False):
    rng = np.random.RandomState(seed)
    router = rng.randn(d, e).astype(np.float32)
    if rigged:  # every token picks expert 0 (tests/test_transformer.py:306)
        router = np.concatenate([np.full((d, 1), 5.0), np.zeros((d, e - 1))], 1).astype(np.float32)
    return {"router": router,
            "w1": (rng.randn(e, d, f) * 0.3).astype(np.float32),
            "w2": (rng.randn(e, f, d) * 0.3).astype(np.float32)}


def _x(seed, b=2, lc=8, d=8, positive=False):
    x = np.random.RandomState(seed + 100).randn(b, lc, d).astype(np.float32)
    return np.abs(x) * 0.5 if positive else x


def _jax_ep(layer, x, cf):
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))
    return shard_map(lambda xx, lay: jt._moe_block_ep(lay, xx, "ep", cf), mesh=mesh,
                     in_specs=(P(), P()), out_specs=P(), check_vma=False)(x, layer)


def _torch_layer(layer):
    return {k: torch.from_numpy(v).requires_grad_(True) for k, v in layer.items()}


def _vjp_jax(fn, layer, x, g):
    out, vjp = jax.vjp(fn, jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(x))
    gl, gx = vjp(jnp.asarray(g))
    return np.asarray(out), {k: np.asarray(v) for k, v in gl.items()}, np.asarray(gx)


def _vjp_torch(fn, layer, x, g):
    tl = _torch_layer(layer)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = fn(tl, tx)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), {k: v.grad.numpy() for k, v in tl.items()}, tx.grad.numpy()


def _close(a, b, atol):
    ao, al, ax = a
    bo, bl, bx = b
    np.testing.assert_allclose(ao, bo, atol=atol, rtol=0)
    np.testing.assert_allclose(ax, bx, atol=atol, rtol=0)
    for k in al:
        np.testing.assert_allclose(al[k], bl[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_block_dense_matches_jax(seed, cf):
    layer, x = _layer(seed), _x(seed)
    g = np.random.RandomState(seed + 7).randn(*x.shape).astype(np.float32)
    j = _vjp_jax(lambda lay, xx: jt._moe_block_dense(lay, xx, cf), layer, x, g)
    t = _vjp_torch(lambda lay, xx: tt._moe_block(lay, xx, cf), layer, x, g)
    _close(t, j, atol=1e-5)


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_block_dispatch_matches_jax_ep_and_dense(seed, cf):
    layer, x = _layer(seed), _x(seed)
    g = np.random.RandomState(seed + 9).randn(*x.shape).astype(np.float32)
    j = _vjp_jax(lambda lay, xx: _jax_ep(lay, xx, cf), layer, x, g)
    t = _vjp_torch(lambda lay, xx: tt._moe_block(lay, xx, cf), layer, x, g)
    _close(t, j, atol=1e-5)
    dense = _vjp_jax(lambda lay, xx: jt._moe_block_dense(lay, xx, cf), layer, x, g)
    _close(t, dense, atol=1e-5)


@pytest.mark.parametrize("form", ["dense", "dispatch"])
def test_rigged_router_drops_past_capacity_as_jax(form):
    """All 16 tokens pick expert 0; cf 1.0 gives it 4 slots, so the first 4
    tokens in order keep their output and 12 drop to zero, in the port and
    in either JAX form (tests/test_transformer.py:288)."""
    layer, x = _layer(3, rigged=True), _x(3, positive=True)
    jfn = jt._moe_block_dense if form == "dense" else (lambda lay, xx, cf: _jax_ep(lay, xx, cf))
    jo = np.asarray(jfn(jax.tree_util.tree_map(jnp.asarray, layer), jnp.asarray(x), 1.0))
    to = tt._moe_block({k: torch.from_numpy(v) for k, v in layer.items()}, torch.from_numpy(x),
                       1.0).numpy()
    rows = np.abs(to.reshape(-1, 8)).sum(1) > 1e-9
    assert rows.sum() == 4 and rows[:4].all()
    np.testing.assert_allclose(to, jo, atol=1e-6)


def test_route_ties_go_to_the_lowest_expert():
    """A router with identical columns ties every gate: argmax takes expert
    0 in both packages; slots count up in token order."""
    layer = {"router": torch.ones((4, 3)), "w1": torch.zeros((3, 4, 2))}
    t = torch.randn((10, 4), generator=torch.Generator().manual_seed(0))
    expert, slot, keep, gval, cap = tt.moe_route(layer, t, 1.25)
    assert cap == 4 and expert.tolist() == [0] * 10
    assert slot.tolist() == list(range(10)) and keep.tolist() == [True] * 4 + [False] * 6
    assert np.asarray(jnp.argmax(jnp.ones((10, 3)), axis=-1)).tolist() == [0] * 10
    np.testing.assert_allclose(gval.numpy(), 1.0 / 3.0, rtol=1e-6)


@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("remat", [False, True])
def test_moe_lm_loss_and_grads_match_jax(remat, loss_chunk):
    """lm_loss with n_experts=4: the JAX function with no mesh axes runs its
    dense MoE form, the port its one MoE block."""
    jcfg, tcfg = _cfgs(remat=remat, loss_chunk=loss_chunk)
    p = _params(jcfg, seed=2)
    rng = np.random.RandomState(3)
    tok = rng.randint(0, 32, size=(4, 16)).astype(np.int32)
    tgt = rng.randint(0, 32, size=(4, 16)).astype(np.int32)
    mask = (rng.rand(4, 16) > 0.1).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(tok), jnp.asarray(tgt), jnp.asarray(mask))
    )(jax.tree_util.tree_map(jnp.asarray, p))
    tp = tt.params_from_numpy(p, device="cpu")
    leaves = [t.requires_grad_(True) for t in tt.tree_leaves(tp)]
    tloss = tt.lm_loss(tcfg, tp, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
                       torch.from_numpy(mask))
    grads = torch.autograd.grad(tloss, leaves)
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for a, b in zip(jl, grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def test_moe_forward_and_classify_match_jax():
    jcfg, tcfg = _cfgs(objective="classify", n_classes=3, causal=False)
    p = _params(jcfg, seed=4)
    tok = np.random.RandomState(5).randint(0, 32, size=(3, 12)).astype(np.int32)
    labels = np.array([0, 2, 1], np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = tt.params_from_numpy(p, device="cpu")
    np.testing.assert_allclose(
        tt.transformer_forward(tcfg, tp, torch.from_numpy(tok).long()).detach().numpy(),
        np.asarray(jt.transformer_forward(jcfg, jp, jnp.asarray(tok))), atol=1e-5)
    jl = jt.classify_loss(jcfg, jp, jnp.asarray(tok), jnp.asarray(labels))
    tl = tt.classify_loss(tcfg, tp, torch.from_numpy(tok).long(), torch.from_numpy(labels).long())
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("loss_chunk", [0, 32])
def test_three_moe_trainer_steps_match_jax(loss_chunk, remat):
    """The JAX SeqTrainer on a one-device mesh runs the expert-parallel
    block (ep="dp"); the port's runs its one MoE block."""
    jcfg, tcfg = _cfgs(loss_chunk=loss_chunk, remat=remat)
    jtr = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=3e-3, seed=1)
    ttr = SeqTrainer(tcfg, device="cpu", lr=3e-3)
    ttr.load_numpy(jtr.host_params())
    rng = np.random.RandomState(0)
    for _ in range(3):
        base = rng.randint(1, 32, size=(4, 4))
        toks = np.tile(base, (1, 5))[:, :17]
        tok, tgt = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
        mask = (rng.rand(4, 16) > 0.1).astype(np.float32)
        jl = float(jtr.step(tok, tgt, mask))
        assert abs(float(ttr.step(tok, tgt, mask)) - jl) <= 1e-5
    jleaves = jax.tree_util.tree_leaves(jtr.host_params())
    tleaves = tt.tree_leaves(ttr.host_params())
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-4, rtol=0)
    assert int(ttr.opt["count"]) == int(np.asarray(jtr.opt["count"])) == 3


@pytest.mark.parametrize("n_experts", [0, 4])
def test_remat_equals_no_remat(n_experts):
    """Recomputing each block in the backward pass changes memory, not
    values: 3 steps with and without remat from the same start."""
    cfg = tt.TransformerConfig(**{**DIMS, "n_experts": n_experts, "loss_chunk": 16})
    a = SeqTrainer(cfg, device="cpu", lr=3e-3, seed=5)
    b = SeqTrainer(dataclasses.replace(cfg, remat=True), device="cpu", lr=3e-3, seed=5)
    rng = np.random.RandomState(6)
    for _ in range(3):
        tok = rng.randint(0, 32, size=(4, 16))
        tgt = rng.randint(0, 32, size=(4, 16))
        assert abs(float(a.step(tok, tgt)) - float(b.step(tok, tgt))) <= 1e-6
    for x, y in zip(tt.tree_leaves(a.params), tt.tree_leaves(b.params)):
        torch.testing.assert_close(y, x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("remat,fwd", [(False, 1), (True, 2)])
def test_remat_runs_the_flash_forward_again_in_the_backward(remat, fwd):
    """Under remat a step runs FlashAttention.forward twice a layer (the
    forward, then its recomputation) and its backward once a layer -- what
    the kernels' launch counters read on the card."""
    calls = {"forward": 0, "backward": 0}
    orig_f, orig_b = tatt.FlashAttention.forward, tatt.FlashAttention.backward

    def spy_f(ctx, *args):
        calls["forward"] += 1
        return orig_f(ctx, *args)

    def spy_b(ctx, g):
        calls["backward"] += 1
        return orig_b(ctx, g)

    cfg = tt.TransformerConfig(**{**MOE, "remat": remat})
    tr = SeqTrainer(cfg, device="cpu", seed=0)
    tatt.FlashAttention.forward, tatt.FlashAttention.backward = staticmethod(spy_f), \
        staticmethod(spy_b)
    try:
        tr.step(np.zeros((2, 8), np.int64), np.ones((2, 8), np.int64))
    finally:
        tatt.FlashAttention.forward = staticmethod(orig_f)
        tatt.FlashAttention.backward = staticmethod(orig_b)
    assert calls == {"forward": fwd * cfg.n_layers, "backward": cfg.n_layers}


def test_moe_params_carry_the_jax_tree():
    """init_transformer lays the MoE leaves out as the JAX package does, and
    a JAX MoE tree crosses params_from_numpy / params_to_numpy unchanged."""
    jcfg, tcfg = _cfgs()
    jp = _params(jcfg)
    tp = tt.init_transformer(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(tt.params_to_numpy(tp))
    for a, b in zip(jax.tree_util.tree_leaves(jp), tt.tree_leaves(tp)):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
    layer = tp["layers"][0]
    assert tuple(layer["router"].shape) == (32, 4)
    assert tuple(layer["w1"].shape) == (4, 32, 64) and tuple(layer["w2"].shape) == (4, 64, 32)
    back = tt.params_to_numpy(tt.params_from_numpy(jp, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_moe_bfloat16_trainer_within_working_type():
    """bf16 compute over float32 masters: the port's MoE block against
    the JAX expert-parallel block, losses within 2e-2 (bf16 rounding at
    other points of the two frameworks' products)."""
    jcfg = jt.TransformerConfig(**{**MOE, "loss_chunk": 16, "dtype": jnp.bfloat16})
    tcfg = tt.TransformerConfig(**{**MOE, "loss_chunk": 16, "dtype": "bfloat16"})
    jtr = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=3e-3, seed=2)
    ttr = SeqTrainer(tcfg, device="cpu", lr=3e-3)
    ttr.load_numpy(jtr.host_params())
    rng = np.random.RandomState(1)
    for _ in range(2):
        tok = rng.randint(0, 32, size=(4, 16)).astype(np.int32)
        tgt = rng.randint(0, 32, size=(4, 16)).astype(np.int32)
        assert abs(float(ttr.step(tok, tgt)) - float(jtr.step(tok, tgt))) <= 2e-2
    assert all(t.dtype == torch.float32 for t in tt.tree_leaves(ttr.params))
