"""The port's sparse ops (omldm_tpu_torch.ops.sparse) against the JAX
package's (omldm_tpu.ops.sparse) on the same numpy inputs, on the CPU, where
the scatter wrappers run their plain version (``index_add_`` on a clone).

Tolerances: the gather-dots within rtol=atol=1e-5 (float32 sums over K in
another order); every scatter formulation within rtol=atol=2e-5, the
envelope tests/test_sparse.py pins between the JAX formulations (the sum
order of duplicate indices differs, and the mxu form rounds each update's
low half to bf16). The plain scatter against the TPU kernel ``pallas_serial``
in interpret mode within 1e-5 absolute (float32 reordering only)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.ops import sparse as jsp
from omldm_tpu_torch.ops import sparse as tsp
from omldm_tpu_torch.ops import sparse_calibrate

ROOT = Path(__file__).resolve().parents[1]
SCATTER_TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(d, b, k, vocab, seed, c=None):
    """w, idx, coef, val with pad slots (idx 0, val 0), a whole-record
    duplicate and, when ``vocab`` is set, duplicate-heavy indices drawn from
    a pool of ``vocab`` values."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d).astype(np.float32) if c is None else rng.randn(d, c).astype(np.float32)
    if vocab:
        idx = rng.choice(rng.randint(0, d, size=vocab), size=(b, k)).astype(np.int32)
    else:
        idx = rng.randint(0, d, size=(b, k)).astype(np.int32)
    val = rng.randn(b, k).astype(np.float32)
    idx[:, -2:] = 0
    val[:, -2:] = 0.0
    idx[3] = idx[2]
    coef = rng.randn(b).astype(np.float32) if c is None else rng.randn(b, c).astype(np.float32)
    return w, idx, coef, val


def _both(fn_j, fn_t, *arrays):
    j = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    t = fn_t(*(torch.from_numpy(a) for a in arrays))
    assert t.dtype == torch.float32
    return j, t.numpy()


CASES = [(37, 5), (300, 0), (4096, 3), (4096, 500), (1 << 15, 7), (13 + (1 << 12), 0)]


@pytest.mark.parametrize("d,vocab", CASES)
def test_scatter_add_matches_jax(d, vocab):
    w, idx, coef, val = _inputs(d, 32, 9, vocab, seed=d + vocab)
    before = dict(tsp.launches)
    j, t = _both(jsp.sparse_scatter_add, tsp.sparse_scatter_add, w, idx, coef, val)
    np.testing.assert_allclose(t, j, **SCATTER_TOL)
    # the CPU path is the plain version: it never counts a kernel launch
    assert tsp.launches == before


@pytest.mark.parametrize("d,vocab", CASES)
def test_mxu_matches_jax_and_scatter(d, vocab):
    w, idx, coef, val = _inputs(d, 32, 9, vocab, seed=2 * d + vocab)
    j, t = _both(jsp.sparse_scatter_add_mxu, tsp.sparse_scatter_add_mxu, w, idx, coef, val)
    np.testing.assert_allclose(t, j, **SCATTER_TOL)
    _, plain = _both(jsp.sparse_scatter_add, tsp.sparse_scatter_add, w, idx, coef, val)
    np.testing.assert_allclose(t, plain, **SCATTER_TOL)


@pytest.mark.parametrize("d,vocab", CASES)
def test_segsum_matches_jax_and_scatter(d, vocab):
    w, idx, coef, val = _inputs(d, 32, 9, vocab, seed=3 * d + vocab)
    j, t = _both(jsp.sparse_scatter_add_segsum, tsp.sparse_scatter_add_segsum,
                 w, idx, coef, val)
    np.testing.assert_allclose(t, j, **SCATTER_TOL)
    _, plain = _both(jsp.sparse_scatter_add, tsp.sparse_scatter_add, w, idx, coef, val)
    np.testing.assert_allclose(t, plain, **SCATTER_TOL)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("d,vocab", [(300, 0), (4096, 7)])
def test_scatter_add_outer_matches_jax(d, vocab, c):
    w, idx, coef, val = _inputs(d, 24, 6, vocab, seed=d + c, c=c)
    j, t = _both(jsp.sparse_scatter_add_outer, tsp.sparse_scatter_add_outer, w, idx, coef, val)
    assert t.shape == (d, c)
    np.testing.assert_allclose(t, j, **SCATTER_TOL)


@pytest.mark.parametrize("outer", [False, True])
def test_out_of_range_updates_are_dropped(outer):
    """An index >= D is dropped, as the JAX scatter drops it; a negative one
    is dropped too (JAX would wrap it; no producer emits it)."""
    w, idx, coef, val = _inputs(64, 8, 5, 0, seed=5, c=2 if outer else None)
    idx[1, 0] = 64
    idx[4, 2] = 1 << 20
    j_fn = jsp.sparse_scatter_add_outer if outer else jsp.sparse_scatter_add
    t_fn = tsp.sparse_scatter_add_outer if outer else tsp.sparse_scatter_add
    j, t = _both(j_fn, t_fn, w, idx, coef, val)
    np.testing.assert_allclose(t, j, **SCATTER_TOL)
    idx[6, 1] = -3
    val[6, 1] = 0.0  # the reference without that update
    _, want = _both(j_fn, t_fn, w, idx, coef, val)
    val[6, 1] = 7.0
    got = t_fn(*(torch.from_numpy(a) for a in (w, idx, coef, val))).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_dots_and_helpers_match_jax():
    rng = np.random.RandomState(9)
    d, b, k, c = 500, 16, 11, 3
    idx = rng.randint(0, d, size=(b, k)).astype(np.int32)
    val = rng.randn(b, k).astype(np.float32)
    w = rng.randn(d).astype(np.float32)
    W = rng.randn(d, c).astype(np.float32)
    j, t = _both(jsp.sparse_matvec, tsp.sparse_matvec, w, idx, val)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    j, t = _both(jsp.sparse_matmat, tsp.sparse_matmat, W, idx, val)
    assert t.shape == (b, c)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    j, t = _both(jsp.sparse_sq_norm, tsp.sparse_sq_norm, val)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    ji, jv = jsp.append_bias_sparse(jnp.asarray(idx), jnp.asarray(val), d)
    ti, tv = tsp.append_bias_sparse(torch.from_numpy(idx), torch.from_numpy(val), d)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dispatch_precedence_env_and_config(monkeypatch):
    """_resolve_impl precedence: explicit config impl > env knob >
    calibration table > "scatter". The env knob rejects junk loudly."""
    monkeypatch.delenv("OMLDM_SPARSE_SCATTER", raising=False)
    assert tsp._resolve_impl(300, 40, impl="segsum") == "segsum"
    monkeypatch.setenv("OMLDM_SPARSE_SCATTER", "mxu")
    assert tsp._resolve_impl(300, 40) == "mxu"
    assert tsp._resolve_impl(300, 40, impl="scatter") == "scatter"
    monkeypatch.setenv("OMLDM_SPARSE_SCATTER", "bogus")
    with pytest.raises(ValueError, match="OMLDM_SPARSE_SCATTER"):
        tsp._resolve_impl(300, 40)
    with pytest.raises(ValueError, match="unknown sparse scatter"):
        tsp._resolve_impl(300, 40, impl="bogus")


def test_dispatch_table_is_the_ports_copy(monkeypatch):
    """The port reads its own table: its cpu section is the JAX package's
    (the same winner at every grid point), and its cuda section was
    measured on the card by the port's own calibration; a CUDA weight
    resolves by the cuda section, a CPU one by the cpu section."""
    monkeypatch.delenv("OMLDM_SPARSE_SCATTER", raising=False)
    monkeypatch.delenv(sparse_calibrate.ENV_TABLE, raising=False)
    path = Path(sparse_calibrate.table_path()).resolve()
    assert path.parent == ROOT / "omldm_tpu_torch" / "ops"
    ours = json.loads(path.read_text())["backends"]
    theirs = json.loads((ROOT / "omldm_tpu" / "ops" / "sparse_dispatch.json").read_text())
    assert set(ours) == {"cpu", "cuda"} and ours["cpu"] == theirs["backends"]["cpu"]
    for e in ours["cpu"]["entries"]:
        assert tsp._resolve_impl(e["d"], e["updates"], backend="cpu") == e["winner"]
    for e in ours["cuda"]["entries"]:
        assert tsp._resolve_impl(e["d"], e["updates"], backend="cuda") == e["winner"]
    # at D = 2^20 and 40,960 updates the cpu table picks segsum
    assert tsp._resolve_impl(1 << 20, 40960, backend="cpu") == "segsum"


def test_dispatch_table_env_override(monkeypatch, tmp_path):
    table = {"backends": {"cuda": {"entries": [{"d": 1024, "updates": 64, "winner": "mxu"}]}}}
    path = tmp_path / "table.json"
    path.write_text(json.dumps(table))
    monkeypatch.delenv("OMLDM_SPARSE_SCATTER", raising=False)
    monkeypatch.setenv(sparse_calibrate.ENV_TABLE, str(path))
    assert tsp._resolve_impl(2048, 100, backend="cuda") == "mxu"
    assert tsp._resolve_impl(2048, 100, backend="cpu") == "scatter"
    path.write_text("not json")
    os.utime(path, (1, 1))
    assert tsp._resolve_impl(2048, 100, backend="cuda") == "scatter"


@pytest.mark.parametrize("impl", ["scatter", "mxu", "segsum"])
def test_auto_dispatch_runs_the_named_formulation(impl):
    w, idx, coef, val = _inputs(300, 8, 5, 0, seed=11)
    args = [torch.from_numpy(a) for a in (w, idx, coef, val)]
    got = tsp.sparse_scatter_add_auto(*args, impl=impl)
    want = tsp.SCATTER_IMPLS[impl](*args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrappers_refuse_other_devices_and_bad_inputs():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.sparse_scatter_add(torch.zeros(8, **meta), torch.zeros((2, 3), dtype=torch.int32, **meta),
                               torch.zeros(2, **meta), torch.zeros((2, 3), **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.sparse_scatter_add_outer(torch.zeros((8, 2), **meta),
                                     torch.zeros((2, 3), dtype=torch.int32, **meta),
                                     torch.zeros((2, 2), **meta), torch.zeros((2, 3), **meta))


def test_zero_updates_change_nothing():
    """An all-zero coef (a fully masked batch) leaves w as it was."""
    w, idx, _, val = _inputs(128, 8, 5, 0, seed=4)
    out = tsp.sparse_scatter_add(*(torch.from_numpy(a) for a in (w, idx, np.zeros(8, np.float32), val)))
    np.testing.assert_array_equal(out.numpy(), w)


def test_plain_scatter_matches_pallas_serial_interpret(tmp_path):
    """The plain version against the TPU kernel itself, run in interpret
    mode in a subprocess: importing the experiment points JAX's persistent
    compile cache under $HOME, so HOME is the test's own directory. N is a
    multiple of the kernel's 1024-update block (it drops the tail)."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np, jax.numpy as jnp
        sys.path.insert(0, "benchmarks")
        import sparse_scatter_experiment as exp
        rng = np.random.RandomState(0)
        d, n = 4109, 2048
        w = rng.randn(d).astype(np.float32)
        idx = rng.randint(0, d, size=n).astype(np.int32)
        idx[:512] = rng.choice(idx[:8], size=512)   # duplicate-heavy block
        u = rng.randn(n).astype(np.float32)
        out = np.asarray(exp.pallas_serial(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(u)))
        np.savez(sys.argv[1], w=w, idx=idx, u=u, out=out)
    """)
    result = tmp_path / "pallas.npz"
    env = dict(os.environ, HOME=str(tmp_path), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code, str(result)], cwd=ROOT, env=env,
                   check=True, timeout=300)
    data = np.load(result)
    # the port's form: idx[N, 1], val[N, 1] = u, coef = 1 (exact products)
    n = data["idx"].shape[0]
    got = tsp.sparse_scatter_add(
        torch.from_numpy(data["w"]), torch.from_numpy(data["idx"].reshape(n, 1)),
        torch.ones(n), torch.from_numpy(data["u"].reshape(n, 1)),
    ).numpy()
    np.testing.assert_allclose(got, data["out"], rtol=0, atol=1e-5)
    ref = data["w"].copy()
    np.add.at(ref, data["idx"], data["u"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("outer", [False, True])
def test_inplace_plain_matches_jax(outer):
    """The in-place plain version (``index_add_`` on w itself) against
    ``w.at[idx].add`` in JAX, with duplicate indices, indices past D (dropped
    by both), zero updates (masked rows, pad slots) and a zero-width batch:
    it returns w itself, holding the result."""
    c = 2 if outer else None
    w, idx, coef, val = _inputs(300, 12, 7, 5, seed=21, c=c)
    idx[1, 0], idx[5, 3] = 300, 1 << 20
    coef[7] = 0.0
    u = val[:, :, None] * (coef[:, None, :] if outer else coef[:, None, None])
    keep = idx < 300
    want = jnp.asarray(w if outer else w[:, None]).at[jnp.asarray(idx[keep])].add(
        jnp.asarray(u[keep]))
    want = np.asarray(want if outer else want[:, 0])
    fn = tsp.sparse_scatter_add_outer if outer else tsp.sparse_scatter_add
    tw = torch.from_numpy(w.copy())
    got = fn(tw, *(torch.from_numpy(a) for a in (idx, coef, val)), inplace=True)
    assert got is tw
    np.testing.assert_allclose(tw.numpy(), want, **SCATTER_TOL)
    # out-of-range and zero updates only: w stays exactly as it was
    tw = torch.from_numpy(w.copy())
    idx2 = np.full_like(idx, 300)
    idx2[::2] = 4
    coef2 = coef.copy()
    coef2[::2] = 0.0
    fn(tw, *(torch.from_numpy(a) for a in (idx2, coef2, val)), inplace=True)
    np.testing.assert_array_equal(tw.numpy(), w)
    empty = torch.zeros((0, 7), dtype=torch.int32)
    zero_coef = torch.zeros((0, 2) if outer else (0,))
    assert fn(tw, empty, zero_coef, torch.zeros((0, 7)), inplace=True) is tw


@pytest.mark.parametrize("impl", ["scatter", "mxu", "segsum"])
def test_every_formulation_writes_in_place(impl):
    """``inplace=True`` on each formulation: w itself holds the same result
    as the copying call, which leaves its input alone."""
    w, idx, coef, val = _inputs(4096, 16, 9, 40, seed=13)
    args = [torch.from_numpy(a) for a in (idx, coef, val)]
    tw = torch.from_numpy(w.copy())
    want = tsp.SCATTER_IMPLS[impl](tw, *args)
    np.testing.assert_array_equal(tw.numpy(), w)
    got = tsp.sparse_scatter_add_auto(tw, *args, impl=impl, inplace=True)
    assert got is tw
    np.testing.assert_array_equal(tw.numpy(), want.numpy())
