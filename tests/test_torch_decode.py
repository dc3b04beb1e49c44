"""The port's KV-cache decoding against the JAX package, from the same
parameters: prefill and one-token logits within atol 1e-5 (float32; met:
< 1e-6), greedy tokens equal. Sampled decoding draws from torch's generator,
so its draws are not compared with JAX's, only their range and determinism."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.models import decode as jd
from omldm_tpu.models import transformer as jt
from omldm_tpu_torch.models import decode as td
from omldm_tpu_torch.models import transformer as tt
from omldm_tpu_torch.ops import attention as tatt

DIMS = dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=64)


def _setup(seed=0):
    jcfg = jt.TransformerConfig(**DIMS)
    tcfg = tt.TransformerConfig(**DIMS)
    jp = jt.init_transformer(jcfg, jax.random.PRNGKey(seed))
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_forward_with_cache_matches_jax():
    jcfg, tcfg, jp, tp = _setup()
    prompt = np.random.RandomState(1).randint(0, 48, size=(2, 7)).astype(np.int32)
    jlog, jcache = jd.forward_with_cache(jcfg, jp, jnp.asarray(prompt),
                                         jd.init_kv_cache(jcfg, 2, 16))
    tlog, tcache = td.forward_with_cache(tcfg, tp, torch.from_numpy(prompt).long(),
                                         td.init_kv_cache(tcfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    assert tcache["pos"] == int(jcache["pos"]) == 7
    nxt = np.array([[3], [5]], np.int32)
    jlog, _ = jd.forward_with_cache(jcfg, jp, jnp.asarray(nxt), jcache)
    tlog, _ = td.forward_with_cache(tcfg, tp, torch.from_numpy(nxt).long(), tcache)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    # the cached path equals a full causal forward over the same tokens
    full = tt.transformer_forward(tcfg, tp, torch.from_numpy(np.concatenate([prompt, nxt], 1)).long())
    np.testing.assert_allclose(tlog[:, 0].numpy(), full[:, -1].detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_jax(seed):
    jcfg, tcfg, jp, tp = _setup(seed)
    prompt = np.random.RandomState(seed + 2).randint(0, 48, size=(3, 5)).astype(np.int32)
    jtok = jd.generate(jcfg, jp, jnp.asarray(prompt), 12, max_len=32)
    before = dict(tatt.launches)
    ttok = td.generate(tcfg, tp, torch.from_numpy(prompt), 12, max_len=32)
    assert ttok.shape == (3, 12)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tatt.launches == before  # no kernel on the decode path


def test_sampled_generate_uses_its_generator():
    _, tcfg, _, tp = _setup()
    prompt = torch.zeros((2, 3), dtype=torch.long)
    a = td.generate(tcfg, tp, prompt, 8, temperature=1.0,
                    generator=torch.Generator().manual_seed(4))
    b = td.generate(tcfg, tp, prompt, 8, temperature=1.0,
                    generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == (2, 8)
    assert int(a.min()) >= 0 and int(a.max()) < DIMS["vocab_size"]


def test_generate_bounds():
    _, tcfg, _, tp = _setup()
    prompt = torch.zeros((1, 4), dtype=torch.long)
    assert td.generate(tcfg, tp, prompt, 0).shape == (1, 0)
    with pytest.raises(ValueError, match="positional table"):
        td.generate(tcfg, tp, prompt, 2, max_len=DIMS["max_len"] + 1)
    with pytest.raises(ValueError, match="exceeds max_len"):
        td.generate(tcfg, tp, prompt, 10, max_len=8)
    with pytest.raises(ValueError, match="cache overflow"):
        td.forward_with_cache(tcfg, tp, torch.zeros((1, 9), dtype=torch.long),
                              td.init_kv_cache(tcfg, 1, 8, device="cpu"))


@pytest.mark.parametrize("remat", [False, True])
def test_moe_decode_refused_as_in_jax(remat):
    """An MoE config is refused by both packages' decode with the same type
    and words; the JAX refusal is the reference."""
    dims = {**DIMS, "n_experts": 4, "remat": remat}
    jcfg, tcfg = jt.TransformerConfig(**dims), tt.TransformerConfig(**dims)
    tp = tt.init_transformer(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError) as jerr:
        jd.forward_with_cache(jcfg, {}, jnp.zeros((1, 3), jnp.int32), jd.init_kv_cache(jcfg, 1, 8))
    with pytest.raises(ValueError) as terr:
        td.forward_with_cache(tcfg, tp, torch.zeros((1, 3), dtype=torch.long),
                              td.init_kv_cache(tcfg, 1, 8, device="cpu"))
    assert str(terr.value) == str(jerr.value) == "decode supports dense transformer configs"
    with pytest.raises(ValueError, match="dense transformer configs"):
        td.generate(tcfg, tp, torch.zeros((1, 3), dtype=torch.long), 2)


def test_remat_config_decodes_as_the_plain_one():
    """remat changes training memory only: a remat config decodes the same
    greedy tokens as its plain twin and as the JAX package."""
    jcfg, tcfg, jp, tp = _setup(3)
    prompt = np.random.RandomState(4).randint(0, 48, size=(2, 5)).astype(np.int32)
    rcfg = tt.TransformerConfig(**{**DIMS, "remat": True})
    a = td.generate(rcfg, tp, torch.from_numpy(prompt), 6, max_len=16)
    b = td.generate(tcfg, tp, torch.from_numpy(prompt), 6, max_len=16)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.numpy(), np.asarray(jd.generate(jcfg, jp, jnp.asarray(prompt), 6,
                                                                    max_len=16)))
