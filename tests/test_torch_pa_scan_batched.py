"""The batched PA scan (``ops.pa_scan.pa_scan_update_batched``): C
independent scans, the members of a cohort or the workers of a fleet, in
one launch sequence on the card.

On the CPU the wrapper runs its plain version, a loop of
``pa_scan_reference`` over members; it is held to that loop bitwise (an
all-zero-mask member keeps its w as it is) and to the JAX Pallas kernel in
interpret mode, ``jax.vmap``-ed over the members as the JAX cohort runs it,
at tests/test_torch_pa_scan.py's tolerance: rtol=2e-4, atol=2e-5 on w,
1e-5 absolute on the loss. The card holds the kernel to the plain version
(``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omldm_tpu.ops.pa_scan import pa_scan_update as jax_pa_scan
from omldm_tpu_torch.api.requests import LearnerSpec, TrainingConfiguration
from omldm_tpu_torch.ops import pa_scan
from omldm_tpu_torch.parallel.mesh import Mesh
from omldm_tpu_torch.parallel.spmd import SPMDTrainer

W_RTOL, W_ATOL, LOSS_ATOL = 2e-4, 2e-5, 1e-5


def _inputs(C, B, D, seed, zero_member=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(C, B, D).astype(np.float32)
    x[..., -1] = 1.0
    w0 = (rng.randn(C, D) * 0.1).astype(np.float32)
    y = rng.randint(0, 2, (C, B)).astype(np.float32)
    mask = (rng.rand(C, B) > 0.2).astype(np.float32)
    if zero_member is not None:
        mask[zero_member] = 0.0
    return w0, x, y, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("variant", ["PA", "PA-I", "PA-II"])
@pytest.mark.parametrize("C,B,D", [(1, 16, 5), (5, 40, 7), (8, 64, 29)])
def test_plain_batched_equals_member_loop(C, B, D, variant):
    w0, x, y, mask = _inputs(C, B, D, seed=C * 100 + B, zero_member=C // 2 if C > 1 else None)
    tw, tl = pa_scan.pa_scan_update_batched(*_t(w0, x, y, mask), variant, 0.5)
    assert tw.shape == (C, D) and tl.shape == (C,)
    for m in range(C):
        rw, rl = pa_scan.pa_scan_reference(*_t(w0[m], x[m], y[m], mask[m]), variant, 0.5)
        if mask[m].any():
            assert torch.equal(tw[m], rw), m
        else:  # an all-zero-mask member keeps w bitwise
            assert torch.equal(tw[m], torch.from_numpy(w0[m])), m
        assert torch.equal(tl[m], rl), m
    # the CPU path never counts a kernel launch
    assert pa_scan.batched_launches == 0


@pytest.mark.parametrize("variant", ["PA-I", "PA-II"])
def test_batched_matches_vmapped_pallas_interpret(variant):
    """The JAX cohort's vmap of the member fit batches the Pallas call; the
    port's batched scan agrees with it member by member."""
    w0, x, y, mask = _inputs(4, 48, 9, seed=7, zero_member=1)
    jw, jl = jax.vmap(lambda w, a, b, m: jax_pa_scan(w, a, b, m, variant=variant, C=0.1,
                                                        interpret=True))(
        *(jnp.asarray(v) for v in (w0, x, y, mask)))
    tw, tl = pa_scan.pa_scan_update_batched(*_t(w0, x, y, mask), variant, 0.1)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOSS_ATOL)


def test_vmap_of_the_op_calls_the_batched_entry(monkeypatch):
    """``torch.func.vmap`` of ``pa_scan_op`` runs the batched entry ONCE for
    every member (what a cohort's vmap gang fit and a dp fleet launch),
    with w unbatched or batched, and gives the batched plain answer."""
    w0, x, y, mask = _inputs(6, 20, 5, seed=3, zero_member=2)
    calls = []
    real = pa_scan.pa_scan_update_batched

    def spy(*args):
        calls.append(tuple(args[1].shape))
        return real(*args)

    monkeypatch.setattr(pa_scan, "pa_scan_update_batched", spy)
    op = lambda w, a, b, m: pa_scan.pa_scan_op(w, a, b, m, "PA-I", 0.01)  # noqa: E731
    vw, vl = torch.func.vmap(op)(*_t(w0, x, y, mask))
    assert calls == [(6, 20, 5)]
    bw, bl = real(*_t(w0, x, y, mask), "PA-I", 0.01)
    assert torch.equal(vw, bw) and torch.equal(vl, bl)
    shared = torch.func.vmap(op, in_dims=(None, 0, 0, 0))(torch.from_numpy(w0[0]),
                                                          *_t(x, y, mask))
    assert calls[-1] == (6, 20, 5)
    sw, _ = real(torch.from_numpy(np.repeat(w0[:1], 6, 0)), *_t(x, y, mask), "PA-I", 0.01)
    assert torch.equal(shared[0], sw)


def test_batched_chunks_rows_past_the_limit():
    """Rows past the kernel's limit run as chunks, every member at once
    (pa_scan_chunked over the member axis): w equal to the whole batch's
    (the scan is sequential), the loss the masked mean over all rows; a
    member whose second chunk is wholly masked included."""
    w0, x, y, mask = _inputs(3, 30, 6, seed=5)
    mask[1, 7:14] = 0.0
    t = _t(w0, x, y, mask)
    rows = []

    def step(w, x, y, m):
        rows.append(x.shape[1])
        assert x.is_contiguous() and y.is_contiguous() and m.is_contiguous()
        return pa_scan.pa_scan_batched_reference(w, x, y, m, "PA-I", 0.5)

    cw, cl = pa_scan.pa_scan_chunked(step, *t, max_rows=7)
    assert rows == [7, 7, 7, 7, 2]
    rw, rl = pa_scan.pa_scan_batched_reference(*t, "PA-I", 0.5)
    np.testing.assert_allclose(cw.numpy(), rw.numpy(), rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(cl.numpy(), rl.numpy(), rtol=0, atol=LOSS_ATOL)


def _scratch_floats(B):
    """The kernel's scratch a member (omldm_pa_scan_scratch_floats): the
    Gram matrix Bp x Bp, base and coef, Bp = B rounded up to 32."""
    bp = -(-B // 32) * 32
    return bp * bp + 2 * bp


@pytest.mark.parametrize("C,B,launches", [
    (64, 256, 1),        # the cohort's gang step: one launch
    (128, 4096, 3),      # 67 MB a member: 63 a launch
    (128, 16384, 43),    # 1.07 GB a member: 3 a launch
    (32, 26944, 32),     # the row limit, 2.9 GB a member: one a launch
    (5, 0, 1),           # no rows, no scratch
])
def test_member_groups_keep_the_scratch_in_budget(C, B, launches):
    """The batched wrapper launches members in groups whose scratch fits
    SCRATCH_BUDGET_FLOATS (4 GiB): contiguous, in order, covering every
    member once, each group as large as the budget allows, and a member
    past the budget alone (its scratch is what one scan needs)."""
    per = _scratch_floats(B)
    groups = pa_scan.member_groups(C, per)
    assert len(groups) == launches
    assert groups[0][0] == 0 and groups[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    budget = pa_scan.SCRATCH_BUDGET_FLOATS
    for m0, m1 in groups:
        assert m1 > m0
        assert (m1 - m0) * per <= budget or m1 - m0 == 1
    # full groups could not take one more member
    assert all((m1 - m0 + 1) * per > budget for m0, m1 in groups[:-1])
    # without the groups, every member's Gram matrix at once
    unsplit_gb = C * per * 4 / 1e9
    assert launches == 1 or unsplit_gb > 4.29


def test_batched_refuses_what_the_kernel_cannot_take():
    w = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pa_scan.pa_scan_update_batched(w, torch.zeros((2, 4, 3), device="meta"),
                                       torch.zeros((2, 4), device="meta"),
                                       torch.zeros((2, 4), device="meta"))
    x = torch.zeros((2, 4, 3))
    assert pa_scan._validate(torch.zeros(2, 3), x, torch.zeros(2, 4), torch.zeros(2, 4),
                             "pa_scan_update_batched") == (2, 4, 3)
    with pytest.raises(ValueError, match="pa_scan_update_batched: mask shape"):
        pa_scan._validate(torch.zeros(2, 3), x, torch.zeros(2, 4), torch.zeros(3, 4),
                          "pa_scan_update_batched")


def test_spmd_dp4_per_record_is_one_batched_call_a_step(monkeypatch):
    """SPMDTrainer at dp 4 with perRecord PA runs its workers' scans as ONE
    batched call a step (one kernel launch on the card), not one a worker;
    the result equals the per-worker loop of the plain version."""
    calls = []
    real = pa_scan.pa_scan_update_batched

    def spy(*args):
        calls.append(tuple(args[1].shape))
        return real(*args)

    monkeypatch.setattr(pa_scan, "pa_scan_update_batched", spy)
    tc = TrainingConfiguration(protocol="Synchronous", per_record=True,
                               extra={"syncEvery": 2})
    trainer = SPMDTrainer(LearnerSpec("PA", hyper_parameters={"C": 1.0}), [], dim=7,
                          protocol="Synchronous", mesh=Mesh(4, 1, "cpu"),
                          training_configuration=tc, batch_size=16)
    rng = np.random.RandomState(0)
    ws = [np.zeros(8, np.float32) for _ in range(4)]
    for step in range(3):
        x = rng.randn(4, 16, 7).astype(np.float32)
        y = (x[..., 0] > 0).astype(np.float32)
        m = np.ones((4, 16), np.float32)
        m[step % 4] = 0.0
        trainer.step(x, y, m)
        for k in range(4):
            xb = np.concatenate([x[k], np.ones((16, 1), np.float32)], 1)
            nw, _ = pa_scan.pa_scan_reference(*_t(ws[k], xb, y[k], m[k]), "PA-I", 1.0)
            ws[k] = nw.numpy()
        if step % 2 == 1:  # the Synchronous round at syncEvery 2
            ws = [np.mean(ws, axis=0)] * 4
    assert calls == [(4, 16, 8)] * 3
    flats = trainer._flat(trainer.state["params"])[:, : trainer.n_params].numpy()
    np.testing.assert_allclose(flats, np.stack(ws), rtol=W_RTOL, atol=W_ATOL)
