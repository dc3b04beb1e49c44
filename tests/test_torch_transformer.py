"""The port's transformer and SeqTrainer against the JAX package, started
from the same parameters (JAX ``init_transformer`` carried across by
``params_from_numpy``), on the same numpy batches. On the CPU the port's
attention runs the kernels' plain twins; the JAX package runs its blockwise
attention.

Tolerances, float32: logits and losses atol 1e-5 (met: <= 5e-7), grads atol
1e-5 (met: ~1e-7), parameters after 3 Adam steps atol 1e-5 (met: 1.2e-7).
bfloat16 compute (rounding points differ between the frameworks' matmuls):
losses within 1e-2 (met: <= 5e-3), grads within 5% of their norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.models import transformer as jt
from omldm_tpu.parallel.seq_trainer import SeqTrainer as JaxSeqTrainer
from omldm_tpu.parallel.seq_trainer import make_seq_mesh
from omldm_tpu_torch.models import transformer as tt
from omldm_tpu_torch.ops import attention as tatt
from omldm_tpu_torch.parallel import SeqTrainer, adam_update, init_adam_state

DIMS = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64)


def _cfgs(**kw):
    jdt = {"bfloat16": jnp.bfloat16}.get(kw.get("dtype"), jnp.float32)
    return (jt.TransformerConfig(**{**DIMS, **kw, "dtype": jdt}),
            tt.TransformerConfig(**{**DIMS, **kw, "dtype": kw.get("dtype", "float32")}))


def _copy_batch(rng, b, l, vocab):
    """Repeating-pattern sequences: the next token is predictable."""
    base = rng.randint(1, vocab, size=(b, 4))
    toks = np.tile(base, (1, l // 4 + 1))[:, : l + 1]
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32),
            (rng.rand(b, l) > 0.1).astype(np.float32))


def _params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jt.init_transformer(jcfg, jax.random.PRNGKey(seed)))


def _leaves_close(a, b, atol):
    la, lb = jax.tree_util.tree_leaves(a), tt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=atol, rtol=0)


@pytest.mark.parametrize("objective", ["lm", "classify"])
def test_forward_matches_jax(objective):
    jcfg, tcfg = _cfgs(objective=objective, n_classes=3,
                       causal=objective == "lm")
    p = _params(jcfg)
    tokens = np.random.RandomState(1).randint(0, 32, size=(3, 24)).astype(np.int32)
    jl = jt.transformer_forward(jcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(tokens))
    tl = tt.transformer_forward(tcfg, tt.params_from_numpy(p, device="cpu"), torch.from_numpy(tokens).long())
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("loss_chunk", [0, 16, 40])
def test_lm_loss_and_grads_match_jax(loss_chunk):
    """Unfused loss, and the fused chunked loss with chunks that divide the
    token count and that leave a ragged last chunk."""
    jcfg, tcfg = _cfgs(loss_chunk=loss_chunk)
    p = _params(jcfg, seed=2)
    tok, tgt, mask = _copy_batch(np.random.RandomState(3), 4, 16, 32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(tok), jnp.asarray(tgt), jnp.asarray(mask))
    )(jax.tree_util.tree_map(jnp.asarray, p))
    tp = tt.params_from_numpy(p, device="cpu")
    leaves = [t.requires_grad_(True) for t in tt.tree_leaves(tp)]
    tloss = tt.lm_loss(tcfg, tp, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
                       torch.from_numpy(mask))
    grads = tt.tree_unflatten(tp, torch.autograd.grad(tloss, leaves))
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    _leaves_close(jgrads, grads, atol=1e-5)


def test_bfloat16_loss_and_grads_within_working_type():
    jcfg, tcfg = _cfgs(loss_chunk=16, dtype="bfloat16")
    p = _params(jcfg, seed=4)
    tok, tgt, mask = _copy_batch(np.random.RandomState(5), 4, 16, 32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jt.lm_loss(jcfg, p, jnp.asarray(tok), jnp.asarray(tgt), jnp.asarray(mask))
    )(jax.tree_util.tree_map(jnp.asarray, p))
    tp = tt.params_from_numpy(p, device="cpu")
    leaves = [t.requires_grad_(True) for t in tt.tree_leaves(tp)]
    tloss = tt.lm_loss(tcfg, tp, torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
                       torch.from_numpy(mask))
    grads = torch.autograd.grad(tloss, leaves)
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-2
    for jg, g in zip(jax.tree_util.tree_leaves(jgrads), grads):
        assert g.dtype == torch.float32  # master weights stay float32
        jg = np.asarray(jg, np.float32)
        assert np.linalg.norm(g.numpy() - jg) <= 0.05 * np.linalg.norm(jg) + 1e-6


def test_classify_loss_matches_jax():
    jcfg, tcfg = _cfgs(objective="classify", n_classes=3, causal=False)
    p = _params(jcfg, seed=6)
    rng = np.random.RandomState(7)
    tok = rng.randint(0, 32, size=(4, 12)).astype(np.int32)
    labels = rng.randint(0, 3, size=(4,)).astype(np.int32)
    jloss = jt.classify_loss(jcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(tok),
                             jnp.asarray(labels))
    tloss = tt.classify_loss(tcfg, tt.params_from_numpy(p, device="cpu"), torch.from_numpy(tok).long(),
                             torch.from_numpy(labels).long())
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5


@pytest.mark.parametrize("loss_chunk", [0, 32])
def test_three_trainer_steps_match_jax(loss_chunk):
    jcfg, tcfg = _cfgs(loss_chunk=loss_chunk)
    jtr = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=3e-3, seed=1)
    ttr = SeqTrainer(tcfg, device="cpu", lr=3e-3)
    ttr.load_numpy(jtr.host_params())
    rng = np.random.RandomState(0)
    for _ in range(3):
        tok, tgt, mask = _copy_batch(rng, 4, 16, 32)
        jl = float(jtr.step(tok, tgt, mask))
        tl = ttr.step(tok, tgt, mask)
        assert tl.shape == () and abs(float(tl) - jl) <= 1e-5
    assert ttr.fitted == jtr.fitted
    _leaves_close(jtr.host_params(), ttr.host_params(), atol=1e-5)
    count = int(np.asarray(jtr.opt["count"]))
    assert int(ttr.opt["count"]) == count == 3


def test_bfloat16_trainer_steps_within_working_type():
    jcfg, tcfg = _cfgs(loss_chunk=16, dtype="bfloat16")
    jtr = JaxSeqTrainer(jcfg, mesh=make_seq_mesh(1, 1, 1), lr=3e-3, seed=2)
    ttr = SeqTrainer(tcfg, device="cpu", lr=3e-3)
    ttr.load_numpy(jtr.host_params())
    rng = np.random.RandomState(1)
    for _ in range(3):
        tok, tgt, mask = _copy_batch(rng, 4, 16, 32)
        assert abs(float(ttr.step(tok, tgt, mask)) - float(jtr.step(tok, tgt, mask))) <= 1e-2
    assert all(t.dtype == torch.float32 for t in tt.tree_leaves(ttr.params))


def test_step_many_equals_sequential_steps():
    _, tcfg = _cfgs(loss_chunk=16)
    rng = np.random.RandomState(8)
    batches = [_copy_batch(rng, 2, 16, 32) for _ in range(3)]
    tok_s, tgt_s, mask_s = (np.stack(x) for x in zip(*batches))
    a, b = SeqTrainer(tcfg, device="cpu", seed=3), SeqTrainer(tcfg, device="cpu", seed=3)
    losses = a.step_many(tok_s, tgt_s, mask_s)
    seq = torch.stack([b.step(*batch) for batch in batches])
    assert losses.shape == (3,)
    torch.testing.assert_close(losses, seq, rtol=0, atol=0)
    for x, y in zip(tt.tree_leaves(a.params), tt.tree_leaves(b.params)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.fitted == b.fitted == int(mask_s.sum())


def test_trainer_learns_copy_task_and_keeps_jax_state():
    _, tcfg = _cfgs()
    tr = SeqTrainer(tcfg, device="cpu", lr=3e-3, seed=1)
    tok, tgt, mask = _copy_batch(np.random.RandomState(0), 8, 16, 32)
    first = float(tr.step(tok, tgt, None))
    for _ in range(40):
        loss = tr.step(tok, tgt, None)
    assert float(loss) < 0.5 * first
    assert tr.fitted == 41 * 8 * 16
    # a JAX optimizer state carries across too
    opt = {"mu": tr.host_params(), "nu": tr.host_params(), "count": np.int32(5)}
    tr.load_numpy(tr.host_params(), opt)
    assert int(tr.opt["count"]) == 5 and tr.opt["mu"]["embed"].dtype == torch.float32


def test_adam_update_matches_jax():
    from omldm_tpu.parallel.optim import adam_update as jax_adam

    rng = np.random.RandomState(9)
    p = {"a": rng.randn(3, 4).astype(np.float32), "b": [rng.randn(5).astype(np.float32)]}
    g = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), p)
    jopt = {"mu": jax.tree_util.tree_map(np.zeros_like, p),
            "nu": jax.tree_util.tree_map(np.zeros_like, p), "count": jnp.int32(0)}
    topt = init_adam_state(tt.params_from_numpy(p, device="cpu"))
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), tt.params_from_numpy(p, device="cpu")
    for _ in range(2):
        jp, jopt = jax_adam(jp, jax.tree_util.tree_map(jnp.asarray, g), jopt, 1e-2)
        tp, topt = adam_update(tp, tt.params_from_numpy(g, device="cpu"), topt, 1e-2)
    _leaves_close(jp, tp, atol=1e-7)
    _leaves_close(jopt["nu"], topt["nu"], atol=1e-7)
    assert int(topt["count"]) == 2


def test_attention_block_passes_strided_views():
    """q, k, v reach attention as views into the packed projection (no
    copy): unit stride on the head width, row stride 3 * d_model."""
    seen = []
    orig = tatt.FlashAttention.forward

    def spy(ctx, q, k, v, *args):
        seen.append((q.stride(), q.data_ptr() - k.data_ptr()))
        return orig(ctx, q, k, v, *args)

    _, tcfg = _cfgs()
    params = tt.init_transformer(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tatt.FlashAttention.forward = staticmethod(spy)
    try:
        tt.transformer_forward(tcfg, params, torch.zeros((2, 8), dtype=torch.long))
    finally:
        tatt.FlashAttention.forward = staticmethod(orig)
    d, dh = DIMS["d_model"], DIMS["d_model"] // DIMS["n_heads"]
    assert seen == [((8 * 3 * d, 3 * d, dh, 1), -d * 4)] * DIMS["n_layers"]


@pytest.mark.parametrize("change,name", [
    ({"n_experts": 4}, "decode supports dense transformer configs"),
    ({"causal": False}, "decode requires a causal lm config"),
])
def test_unported_options_raise(change, name):
    """What the model path still refuses, with the JAX package's reasons:
    decoding a mixture-of-experts config, and decoding a non-causal one.
    Training and the forward take both (MoE and remat are ported)."""
    from omldm_tpu_torch.models import decode as td

    cfg = tt.TransformerConfig(**{**DIMS, **change})
    params = tt.init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match=name):
        td.forward_with_cache(cfg, params, tok, td.init_kv_cache(cfg, 1, 8, device="cpu"))
    with pytest.raises(ValueError, match=name):
        td.generate(cfg, params, tok, 2)
    assert tt.transformer_forward(cfg, params, tok).shape == (1, 4, DIMS["vocab_size"])
    SeqTrainer(dataclasses.replace(cfg, remat=True), device="cpu").step(tok, tok)


@pytest.mark.parametrize("fn", ["transformer_hidden", "transformer_forward",
                                "lm_loss", "classify_loss"])
def test_mesh_axes_raise(fn):
    """The mesh axes are not ported: a caller that passes the JAX package's
    ``axes=AxisSpec(...)`` is refused, not run on one device."""
    _, tcfg = _cfgs()
    params = tt.init_transformer(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    args = {"transformer_hidden": (tok,), "transformer_forward": (tok,),
            "lm_loss": (tok, tok, torch.ones((1, 4))),
            "classify_loss": (tok, torch.zeros((1,), dtype=torch.long))}[fn]
    with pytest.raises(TypeError, match="axes"):
        getattr(tt, fn)(tcfg, params, *args, axes={"sp": "sp"})


def test_config_takes_dtype_names_and_init_shapes():
    cfg = tt.TransformerConfig(**{**DIMS, "dtype": "bfloat16"})
    assert cfg.dtype == torch.bfloat16
    p = tt.init_transformer(dataclasses.replace(cfg, dtype=torch.float32),
                            torch.Generator().manual_seed(0), device="cpu")
    jp = _params(_cfgs()[0])
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(tt.params_to_numpy(p))
    for a, b in zip(jax.tree_util.tree_leaves(jp), tt.tree_leaves(p)):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32


@pytest.mark.parametrize("knob", [{"seq_parallel": "ulysses"}, {"seq_parallel": "ring"}])
def test_jax_only_config_knobs_do_not_exist(knob):
    """The knob of the JAX TransformerConfig that only unported paths read
    (the sequence-parallel strategy: ring or Ulysses attention over
    devices) is not silently accepted, whichever value it is given."""
    with pytest.raises(TypeError):
        tt.TransformerConfig(**knob)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_model_helpers_want_cuda_by_default():
    """With no device the model helpers want CUDA, as every entry point of
    the port does, and raise without a card instead of running on the CPU
    unasked; asked for the CPU they build there."""
    from omldm_tpu_torch.models import decode as td

    tcfg = tt.TransformerConfig(**{**DIMS, "dtype": torch.float32})
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="init_transformer"):
        tt.init_transformer(tcfg, gen)
    with pytest.raises(RuntimeError, match="params_from_numpy"):
        tt.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="init_kv_cache"):
        td.init_kv_cache(tcfg, 1, 8)
    p = tt.init_transformer(tcfg, gen, device="cpu")
    assert all(t.device.type == "cpu" for t in tt.tree_leaves(p))
