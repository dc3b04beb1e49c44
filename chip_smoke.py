#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (omldm_tpu_torch) on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N] [--records N] [--parity-records N]
                          [--lm-steps N] [--profile DIR]

Phases (any failure raises and the script exits nonzero without a result):
  1. setup       card name and power limit, torch/CUDA versions, TF32 off;
  2. build       both kernel sources from omldm_tpu_torch/csrc/, one nvcc
                 each, started together (pa_scan.cu, flash_attention.cu);
  3. check       pa_scan against its plain PyTorch version on the card, at
                 (B, D+1) in {(1,29), (256,29), (256,1025), (255,4097)},
                 variants PA/PA-I/PA-II, C in {0.01, 0.5}, masks with trailing
                 and scattered zeros, labels in {0,1} and {-1,+1};
  4. time        pa_scan and its plain version at (256,29) and (256,1025);
  5. slice       StreamJob(parallelism=16, batch 256) on cuda: Create (PA-I,
                 StandardScaler, Asynchronous, perRecord), --records HIGGS-
                 shaped training records (28 features, a planted linear rule
                 plus noise) with every tenth record a forecast, a Query
                 halfway, termination; pa_scan must have launched once per
                 per-record fit;
  6. parity      the first --parity-records records through the port on cuda
                 and on cpu at parallelism 4, batch 256: >= 99% of predictions
                 equal, final parameters within rtol=2e-4, atol=2e-5;
  7. flash-check the flash forward, dQ and dK/dV kernels against their plain
                 twins (run one (b, h) head at a time) on FLASH_CHECKS: out,
                 dq, dk, dv within FLASH_TOL's relative L2 and per-element
                 limits, lse absolute;
  8. flash-time  device time a call (torch.profiler) of each flash kernel,
                 its plain twin and the PyTorch library call
                 (scaled_dot_product_attention, forward and autograd
                 backward) at FLASH_TIME_SHAPES, median of 3 turns, with
                 each kernel's bound;
  9. lm          SeqTrainer on cuda at the LM's full width (LM_CONFIG: vocab
                 8192, d 512, 4 heads, 4 layers, d_ff 2048, bf16, loss chunk
                 1024, Adam 1e-3), context 1024, batch 8: one warm-up step,
                 then --lm-steps steps through step_many on a seeded copy-task
                 stream; the loss falls, each flash kernel launched
                 n_layers x steps times; then greedy generate (no kernel);
 10. lm-parity   a small float32 config trained 3 steps on cuda and on cpu
                 from the same numpy parameters: parameters within
                 LM_PARITY_ATOL, greedy tokens equal.
With --profile DIR, after phase 10: the slice's stream under cProfile (host
time by function) and torch.profiler (device busy time), then 4 LM steps
under torch.profiler (device busy time, the flash kernels' share, the top
kernels); tables are written into DIR.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks, dense (the card's power limit is printed beside them)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
W_RTOL, W_ATOL, LOSS_ATOL = 2e-4, 2e-5, 1e-5
CHECK_SHAPES = [(1, 29), (256, 29), (256, 1025), (255, 4097)]
TIME_SHAPES = [(256, 29), (256, 1025)]
N_FEATURES = 28  # HIGGS


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# --- data -------------------------------------------------------------------


def higgs_like(n: int, rng):
    """HIGGS-shaped rows: 28 features -- positive momenta-like columns, angles
    in (-pi, pi), discrete b-tags, positive invariant-mass-like columns --
    and a binary label from a planted linear rule on the standardized
    features plus noise."""
    import numpy as np

    cols = []
    for k in range(N_FEATURES):
        if k in (5, 9, 13, 17):                       # b-tag weights
            cols.append(rng.choice([0.0, 1.0, 2.17], size=n))
        elif k % 2 == 0 and k < 21:                   # momenta
            cols.append(rng.lognormal(0.0, 0.5, size=n))
        elif k < 21:                                  # angles
            cols.append(rng.uniform(-np.pi, np.pi, size=n))
        else:                                         # high-level masses
            cols.append(rng.gamma(4.0, 0.25, size=n))
    x = np.stack(cols, axis=1)
    w = rng.randn(N_FEATURES)
    z = (x - x.mean(axis=0)) / x.std(axis=0)
    y = (z @ w + 0.5 * np.sqrt(N_FEATURES) * rng.randn(n) > 0).astype(np.float64)
    return np.round(x, 6), y


def make_events(n_train: int, seed: int, query_at: int | None):
    """Create + n_train training records, a forecast after every 9 training
    records (every tenth record), an optional Query."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n_fore = n_train // 9
    x, y = higgs_like(n_train + n_fore, rng)
    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.01, "variant": "PA-I"}},
        "preProcessors": [{"name": "StandardScaler"}],
        "trainingConfiguration": {"protocol": "Asynchronous", "perRecord": True},
    }
    events = [("requests", json.dumps(create))]
    f = n_train
    for i in range(n_train):
        events.append(("trainingData", json.dumps(
            {"numericalFeatures": x[i].tolist(), "target": float(y[i])}
        )))
        if i % 9 == 8 and f < x.shape[0]:
            events.append(("forecastingData", json.dumps(
                {"numericalFeatures": x[f].tolist()}
            )))
            f += 1
        if query_at is not None and i == query_at:
            events.append(("requests", json.dumps(
                {"id": 0, "request": "Query", "requestId": 1}
            )))
    return events


# --- phases -----------------------------------------------------------------


def phase_setup(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build(pa_scan, attention):
    """One nvcc per source, all started together, then waited for."""
    t0 = time.perf_counter()
    libraries = [("pa_scan.cu", pa_scan.LIBRARY), ("flash_attention.cu", attention.LIBRARY)]
    for _, lib in libraries:
        lib.start()
    for _, lib in libraries:
        lib.load()
    log(f"build: {len(libraries)} sources in {time.perf_counter() - t0:.2f} s wall")
    for name, lib in libraries:
        log(f"build: {name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if line.strip():
                log(f"  nvcc: {line.strip()}")


def _kernel_inputs(torch, B, D, labels, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, D), generator=g)
    x[:, -1] = 1.0  # the bias column
    w0 = torch.randn((D,), generator=g) * 0.1
    if labels == "01":
        y = torch.randint(0, 2, (B,), generator=g).float()
    else:
        y = torch.randint(0, 2, (B,), generator=g).float() * 2.0 - 1.0
    mask = (torch.rand((B,), generator=g) > 0.2).float()
    mask[-max(B // 8, 1):] = 0.0
    return [t.cuda().contiguous() for t in (w0, x, y, mask)]


def phase_check(torch, pa_scan):
    max_w = max_loss = 0.0
    n = 0
    for B, D in CHECK_SHAPES:
        for variant in ("PA", "PA-I", "PA-II"):
            for C in (0.01, 0.5):
                for labels in ("01", "pm1"):
                    w0, x, y, mask = _kernel_inputs(torch, B, D, labels, seed=B * 7 + D + n)
                    kw, kl = pa_scan.pa_scan_update(w0, x, y, mask, variant, C)
                    pw, pl = pa_scan.pa_scan_reference(w0, x, y, mask, variant, C)
                    torch.cuda.synchronize()
                    err_w = (kw - pw).abs().max().item()
                    err_l = abs(kl.item() - pl.item())
                    ok = torch.allclose(kw, pw, rtol=W_RTOL, atol=W_ATOL)
                    check(ok and err_l <= LOSS_ATOL,
                          f"pa_scan disagrees at B={B} D={D} {variant} C={C} "
                          f"labels={labels}: max|dw|={err_w} |dloss|={err_l}")
                    max_w, max_loss = max(max_w, err_w), max(max_loss, err_l)
                    n += 1
    log(f"check: {n} kernel-vs-plain cases pass; max|dw|={max_w:.3e} "
        f"max|dloss|={max_loss:.3e} (rtol={W_RTOL}, atol={W_ATOL}, loss {LOSS_ATOL})")
    return max_w


def _time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(B, D):
    """Least time for the same work: each input read once, each output
    written once, over HBM; fp32 operations (w.x, x.x, the update) over the
    non-tensor-core peak. Returns (ms, "bytes" | "operations")."""
    nbytes = (B * D + 2 * B + D + D + 1) * 4
    flops = 6 * B * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_time(torch, pa_scan):
    """Kernel ms from CUDA events over >= 1000 launches; plain ms over fewer.
    Turns: kernel, plain, kernel, plain (the reported numbers are the
    second of each)."""
    out = {}
    for B, D in TIME_SHAPES:
        w0, x, y, mask = _kernel_inputs(torch, B, D, "01", seed=99)
        kern = lambda: pa_scan.pa_scan_update(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
        plain = lambda: pa_scan.pa_scan_reference(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
        k1 = _time_ms(torch, kern, 1000)
        p1 = _time_ms(torch, plain, 10)
        k2 = _time_ms(torch, kern, 1000)
        p2 = _time_ms(torch, plain, 10)
        b, by = bound_ms(B, D)
        out[(B, D)] = {"ms": k2, "plain_ms": p2, "bound_ms": b, "bound_by": by}
        log(f"time: pa_scan B={B} D+1={D}: kernel {k1:.6f} / {k2:.6f} ms, plain "
            f"{p1:.4f} / {p2:.4f} ms, bound {b:.7f} ms ({by}-bound by the "
            f"roofline; the chain of {B} dependent reductions bounds it in fact), "
            f"library none")
    return out


def _pipelines(job):
    return [net.pipeline for spoke in job.spokes for net in spoke.nets.values()]


SLICE_CONFIG = dict(parallelism=16, batch_size=256)


def _run_slice(torch, events, device="cuda"):
    """The slice's job on ``events``; returns (job, report, wall seconds)."""
    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    job = StreamJob(JobConfig(**SLICE_CONFIG), device=device)
    t0 = time.perf_counter()
    report = job.run(events)
    torch.cuda.synchronize()
    return job, report, time.perf_counter() - t0


def phase_slice(torch, pa_scan, events, device="cuda"):
    n_fore = sum(1 for s, _ in events if s == "forecastingData")
    pa_scan.launches = 0
    job, report, wall = _run_slice(torch, events, device)
    launches = pa_scan.launches

    check(report is not None, "the job emitted no JobStatistics")
    [stats] = report.statistics
    fits = len(stats.learning_curve)
    # one holdout evaluation per worker for the Query and for termination
    evaluations = 2 * job.config.parallelism
    fits_by_launches = stats.program_launches - stats.forecasts_served - evaluations
    log(f"slice: {wall:.2f} s wall, {len(events) / wall:.0f} records/s, "
        f"fits {fits}, pa_scan launches {launches}, programLaunches "
        f"{stats.program_launches}, fitted {stats.fitted}, score {stats.score:.4f}, "
        f"serveLatencyP50Ms {stats.serve_latency_p50_ms:.4f}, "
        f"serveLatencyP99Ms {stats.serve_latency_p99_ms:.4f}")
    check(launches > 0, "pa_scan was never launched on the main path")
    check(launches == fits == fits_by_launches,
          f"pa_scan launches {launches} != per-record fits {fits} "
          f"(programLaunches accounting: {fits_by_launches})")
    for pipe in _pipelines(job):
        tensors = [pipe.state["fitted"], pipe.state["cum_loss"]]
        tensors += list(pipe.state["params"].values())
        tensors += [t for s in pipe.state["preps"] for t in s.values()]
        check(all(t.device.type == device for t in tensors),
              f"a pipeline state tensor is not on {device}")
    check(len(job.predictions) == n_fore,
          f"{len(job.predictions)} predictions for {n_fore} forecasting records")
    preds = [p.value for p in job.predictions]
    check(all(v in (-1.0, 1.0) for v in preds), "a prediction is not a sign")
    check(len(job.responses) == 1, f"{len(job.responses)} query responses, expected 1")
    values = job.responses[0].learner["parameters"]["values"]
    check(len(values) == N_FEATURES + 1, f"query returned {len(values)} parameters")
    check(stats.forecasts_served == n_fore, "forecastsServed != forecasting records")
    check(stats.score > 0.6, f"final holdout accuracy {stats.score} is not above chance")
    # host wall time inside the spokes' fit-flush and forecast-serve timers
    # (a fit returns before the device finishes, except at sync points)
    fit_s = sum(s.step_timer.total_ms for s in job.spokes) / 1e3
    serve_s = sum(s.serve_timer.total_ms for s in job.spokes) / 1e3
    log("slice: " + json.dumps({
        "records": len(events), "wall_s": wall, "records_per_s": len(events) / wall,
        "fit_flush_s": fit_s, "serve_s": serve_s,
        "fits": fits, "pa_scan_launches": launches, "score": stats.score,
        "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        "serveLatencyP99Ms": stats.serve_latency_p99_ms,
        "forecasts": n_fore,
    }))
    return launches, wall


def phase_parity(events, devices=("cuda", "cpu")):
    """``events``: the Create and the first records of the slice's stream."""
    import numpy as np

    from omldm_tpu_torch.config import JobConfig
    from omldm_tpu_torch.runtime import StreamJob

    runs = {}
    for device in devices:
        job = StreamJob(JobConfig(parallelism=4, batch_size=256), device=device)
        job.run(events)
        flats = [p.get_flat_params()[0] for p in _pipelines(job)]
        runs[device] = (np.array([p.value for p in job.predictions]), flats)
    (pc, fc), (pp, fp) = (runs[d] for d in devices)
    check(len(pc) == len(pp) > 0, "parity runs emitted different prediction counts")
    mismatches = int((pc != pp).sum())
    err = max(float(np.abs(a - b).max()) for a, b in zip(fc, fp))
    log(f"parity: {devices[0]} vs {devices[1]} on {len(events) - 1} records: prediction mismatches "
        f"{mismatches}/{len(pc)}, final params max|d|={err:.3e}")
    check(mismatches <= 0.01 * len(pc), "more than 1% of predictions differ")
    for a, b in zip(fc, fp):
        check(np.allclose(a, b, rtol=W_RTOL, atol=W_ATOL),
              f"final params differ between cuda and cpu: max|d|={np.abs(a - b).max()}")


# host functions whose cumulative time the profile phase reports:
# (label, file suffix, function name)
PROFILE_FUNCS = [
    ("job.run", "runtime/job.py", "run"),
    ("json parse (records)", "api/data.py", "parse"),
    ("json parse (requests)", "api/requests.py", "from_json"),
    ("job._handle_data", "runtime/job.py", "_handle_data"),
    ("spoke.handle_data", "runtime/spoke.py", "handle_data"),
    ("vectorize", "runtime/vectorizer.py", "vectorize"),
    ("spoke._train (holdout, batch)", "runtime/spoke.py", "_train"),
    ("flush_batch (fits, sync points)", "runtime/spoke.py", "flush_batch"),
    ("spoke._serve", "runtime/spoke.py", "_serve"),
    ("pipeline.predict", "pipelines/pipeline.py", "predict"),
    ("on_forecast_batch (predict + read back)", "protocols/base.py", "on_forecast_batch"),
    ("emit prediction", "runtime/job.py", "_emit_prediction"),
    ("job.terminate", "runtime/job.py", "terminate"),
]


def _dev_us(e):
    """A torch.profiler average's device time, microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def phase_profile(torch, events, out_dir: Path):
    """The slice's stream under cProfile, then under torch.profiler."""
    import cProfile
    import io
    import pstats

    out_dir.mkdir(parents=True, exist_ok=True)
    prof = cProfile.Profile()
    prof.enable()
    _, _, wall_c = _run_slice(torch, events)
    prof.disable()
    st = pstats.Stats(prof)
    st.dump_stats(str(out_dir / "slice.pstats"))
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
    (out_dir / "slice_cprofile.txt").write_text(buf.getvalue())
    host = {}
    for (path, _, name), (_, _, tt, ct, _) in st.stats.items():
        for label, suffix, fname in PROFILE_FUNCS:
            if name == fname and path.endswith(suffix):
                host[label] = host.get(label, 0.0) + ct
    top_self = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    log(f"profile: cProfile wall {wall_c:.3f} s (profiler overhead included); "
        "cumulative host seconds by function:")
    for label, _, _ in PROFILE_FUNCS:
        log(f"  {label}: {host.get(label, 0.0):.3f}")
    log("profile: top self time:")
    for (path, line, name), (_, nc, tt, _, _) in top_self:
        log(f"  {tt:.3f} s self, {nc} calls: {Path(path).name}:{line} {name}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        _, _, wall_t = _run_slice(torch, events)
    events_avg = tp.key_averages()
    (out_dir / "slice_torch.txt").write_text(
        events_avg.table(sort_by="self_cpu_time_total", row_limit=40)
    )

    from torch.autograd import DeviceType

    kernels = [e for e in events_avg if e.device_type == DeviceType.CUDA]
    busy_s = sum(_dev_us(e) for e in kernels) / 1e6
    log(f"profile: torch.profiler wall {wall_t:.3f} s (profiler overhead "
        f"included); device busy {busy_s:.4f} s in {len(kernels)} kernel "
        f"names, {sum(e.count for e in kernels)} launches")
    for e in sorted(kernels, key=lambda e: -_dev_us(e))[:8]:
        log(f"  {_dev_us(e) / 1e3:.3f} ms, {e.count} launches: {e.key[:90]}")
    host_ops = sorted(events_avg, key=lambda e: -e.self_cpu_time_total)[:10]
    log("profile: top host self time under torch.profiler:")
    for e in host_ops:
        log(f"  {e.self_cpu_time_total / 1e6:.3f} s, {e.count} calls: {e.key[:90]}")
    return busy_s


# --- flash attention -----------------------------------------------------------

# (name, B, Lq, Lk, H, Dh, dtype, q_offset, kv_offset); each runs causal and not
FLASH_CHECKS = [
    ("slice", 8, 1024, 1024, 4, 128, "bfloat16", 0, 0),
    ("lm4096", 2, 4096, 4096, 4, 128, "bfloat16", 0, 0),
    ("bench8192", 4, 8192, 8192, 8, 64, "bfloat16", 0, 0),
    ("ragged", 2, 1000, 1100, 4, 128, "bfloat16", 0, 0),
    ("q_offset256", 2, 512, 768, 4, 128, "bfloat16", 256, 0),
    ("masked_rows", 2, 256, 256, 4, 128, "bfloat16", 0, 100),
    ("f32", 2, 256, 256, 2, 64, "float32", 0, 0),
]
# Each kernel output against its twin, per tensor: the relative L2 error
# ||a - ref|| / ||ref||, and the worst element against its own size plus the
# tensor's rms, max |a - ref| / (|ref| + rms(ref)); lse absolute. Limits: a
# few times the largest reading of the sound kernels (PERF.md), far below
# what one wrong row tile or a mis-scaled P would give. bfloat16 is compared
# in its working type (both sides round out, dq, dk and dv to bf16, and P
# against another row max); float32 is held tightly.
FLASH_TOL = {"bfloat16": (1e-2, 1e-1, 1e-5), "float32": (2e-6, 2e-5, 4e-6)}  # l2, elem, lse
FLASH_TIME_SHAPES = [(8, 1024, 4, 128), (2, 4096, 4, 128)]


def _flash_inputs(torch, b, lq, lk, h, dh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda l: torch.randn((b, l, h, dh), generator=g, device="cuda").to(dt)  # noqa: E731
    return mk(lq), mk(lk), mk(lk), mk(lq)


def _per_head(torch, fn, *tensors):
    """Run a [B, L, H, Dh] -> tuple twin one (b, h) head at a time (so the
    [L, L] scores of L = 8192 fit) and reassemble [B, L, H, Dh] results and
    [B*H, Lq] rows."""
    b, h = tensors[0].shape[0], tensors[0].shape[2]
    outs = None
    for bi in range(b):
        for hi in range(h):
            part = fn(bi, hi, *[t[bi:bi + 1, :, hi:hi + 1] for t in tensors])
            if outs is None:
                outs = [[None] * (b * h) for _ in part]
            for slot, piece in zip(outs, part):
                slot[bi * h + hi] = piece
    result = []
    for pieces in outs:
        if pieces[0].dim() == 4:  # [1, L, 1, Dh] pieces -> [B, L, H, Dh]
            rows = [torch.cat(pieces[bi * h:(bi + 1) * h], dim=2) for bi in range(b)]
            result.append(torch.cat(rows, dim=0))
        else:                     # [1, L] pieces -> [B*H, L]
            result.append(torch.cat([x.reshape(1, -1) for x in pieces], dim=0))
    return result


def phase_flash_check(torch, attention):
    """Each kernel against its plain twin on the card. The backward kernels
    and twin share the kernel forward's lse and delta, so each comparison
    isolates one kernel."""
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkdv": 0.0}
    readings = {dtype: [0.0, 0.0, 0.0] for dtype in FLASH_TOL}  # l2, elem, lse
    n = 0
    for name, b, lq, lk, h, dh, dtype, qo, ko in FLASH_CHECKS:
        l2_tol, elem_tol, lse_atol = FLASH_TOL[dtype]
        for causal in (False, True):
            q, k, v, g = _flash_inputs(torch, b, lq, lk, h, dh, dtype, seed=n)
            out, lse = attention.flash_attention(q, k, v, causal, qo, ko, return_lse=True)
            delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(b * h, lq).contiguous()
            dq, dk, dv = attention.flash_attention_bwd(q, k, v, g, lse, delta, causal, qo, ko)
            torch.cuda.synchronize()
            lse2, delta2 = lse.reshape(b, h, lq), delta.reshape(b, h, lq)
            p_out, p_lse = _per_head(
                torch, lambda bi, hi, q, k, v: attention.flash_attention_reference(
                    q, k, v, causal, qo, ko), q, k, v)
            p_dq, p_dk, p_dv = _per_head(
                torch, lambda bi, hi, q, k, v, g: attention.flash_attention_bwd_reference(
                    q, k, v, g, lse2[bi, hi].contiguous(), delta2[bi, hi].contiguous(),
                    causal, qo, ko), q, k, v, g)
            pairs = [("flash_fwd", "out", out, p_out), ("flash_dq", "dq", dq, p_dq),
                     ("flash_dkdv", "dk", dk, p_dk), ("flash_dkdv", "dv", dv, p_dv)]
            errs = {}
            for kern, what, a, ref in pairs:
                check(bool(torch.isfinite(a).all()), f"{what} not finite at {name} causal={causal}")
                err, l2, elem = flash_errors(torch, a, ref)
                check(l2 <= l2_tol and elem <= elem_tol,
                      f"flash {what} disagrees at {name} causal={causal}: rel L2 {l2:.3e} "
                      f"(limit {l2_tol}), worst element {elem:.3e} (limit {elem_tol})")
                worst[kern] = max(worst[kern], err)
                readings[dtype][0] = max(readings[dtype][0], l2)
                readings[dtype][1] = max(readings[dtype][1], elem)
                errs[what] = f"{err:.3e}/{l2:.3e}/{elem:.3e}"
            lse_err = (lse.reshape(-1) - p_lse.reshape(-1)).abs().max().item()
            check(lse_err <= lse_atol, f"flash lse disagrees at {name} causal={causal}: "
                  f"max|d|={lse_err:.3e}")
            worst["flash_fwd"] = max(worst["flash_fwd"], lse_err)
            readings[dtype][2] = max(readings[dtype][2], lse_err)
            if name == "masked_rows" and causal:
                rows = out[:, :ko - qo].float()
                check(rows.abs().max().item() == 0.0 and dq[:, :ko - qo].abs().max().item() == 0.0,
                      "rows that see no key must have zero output and zero dq")
                check(lse.reshape(b, h, lq)[:, :, :ko - qo].max().item() < attention.NEG_INF / 2,
                      "rows that see no key must have an lse near NEG_INF")
            log(f"flash-check: {name} {(b, lq, lk, h, dh)} {dtype} causal={causal} "
                f"q_offset={qo} kv_offset={ko}: max|d|/relL2/element " + " ".join(
                    f"{w}={e}" for w, e in errs.items()) + f" lse={lse_err:.3e}")
            n += 1
            del q, k, v, g, out, lse, dq, dk, dv, p_out, p_lse, p_dq, p_dk, p_dv
            torch.cuda.empty_cache()
    log(f"flash-check: {n} cases pass; largest readings (rel L2, worst element, lse) "
        f"{readings} against the limits {FLASH_TOL}")
    return worst


def flash_errors(torch, a, ref):
    """(max |a - ref|, ||a - ref|| / ||ref||, max |a - ref| / (|ref| + rms(ref)))
    in float32."""
    a, ref = a.float(), ref.float()
    d = (a - ref).abs()
    rms = ref.square().mean().sqrt()
    return (d.max().item(), (d.norm() / ref.norm().clamp_min(1e-30)).item(),
            (d / (ref.abs() + rms.clamp_min(1e-30))).max().item())


def flash_bound_ms(kernel, b, lq, lk, h, dh, causal):
    """Least time for the same work on this card: the larger of the bf16
    tensor-core operations over 989 TFLOP/s and the bytes (each input read
    once, each output written once) over 3.35 TB/s. Operations count only
    the (query, key) pairs the causal mask keeps."""
    pairs = sum(min(lk, i + 1) for i in range(lq)) if causal else lq * lk
    products = {"flash_fwd": 2, "flash_dq": 3, "flash_dkdv": 4}[kernel]
    flops = 2 * products * dh * pairs * b * h
    tile = b * h * dh * 2  # one bf16 [B, L, H, Dh] row set per position
    rows = b * h * lq * 4  # one f32 value per query row
    nbytes = {
        "flash_fwd": tile * (lq + 2 * lk + lq) + rows,          # q, k, v -> out, lse
        "flash_dq": tile * (lq + 2 * lk + lq + lq) + 2 * rows,  # q, k, v, dO, lse, delta -> dq
        "flash_dkdv": tile * (lq + 2 * lk + lq + 2 * lk) + 2 * rows,  # ... -> dk, dv
    }[kernel]
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _device_ms(torch, fn, reps):
    """The card's busy time a call: every kernel, copy and memset that
    torch.profiler traces in ``reps`` calls after warm-up, over ``reps``;
    host work and the gaps between launches are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(_dev_us(e) for e in tp.key_averages() if e.device_type == DeviceType.CUDA)
    check(busy_us > 0, "torch.profiler traced no device time")
    return busy_us / 1e3 / reps


FLASH_TIME_TURNS = 3


def phase_flash_time(torch, attention):
    """Device time a call (torch.profiler) of each kernel over 100 launches
    after warm-up, of the plain twins over 5 calls, and of SDPA forward and
    its autograd backward (dQ, dK and dV in one call, reported for both
    backward kernels) over 100, in FLASH_TIME_TURNS turns of kernel, plain,
    library; the median turn is reported, the spread printed."""
    import statistics

    import torch.nn.functional as F

    out = {}
    for b, lq, h, dh in FLASH_TIME_SHAPES:
        q, k, v, g = _flash_inputs(torch, b, lq, lq, h, dh, "bfloat16", seed=123)
        o, lse = attention.flash_attention(q, k, v, True, return_lse=True)
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).reshape(b * h, lq).contiguous()
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        gt = g.transpose(1, 2).contiguous()
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        calls = {
            "flash_fwd": (100, lambda: attention.flash_attention(q, k, v, True, return_lse=True)),
            "flash_dq": (100, lambda: attention.flash_attention_dq(q, k, v, g, lse, delta, True)),
            "flash_dkdv": (100, lambda: attention.flash_attention_dkdv(
                q, k, v, g, lse, delta, True)),
            "plain_fwd": (5, lambda: attention.flash_attention_reference(q, k, v, True)),
            "plain_bwd": (5, lambda: attention.flash_attention_bwd_reference(
                q, k, v, g, lse, delta, True)),
            "lib_fwd": (100, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
            "lib_bwd": (100, lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                         retain_graph=True)),
        }
        turns = {key: [] for key in calls}
        for turn in range(FLASH_TIME_TURNS):
            for key, (reps, fn) in calls.items():
                turns[key].append(_device_ms(torch, fn, reps))
            log(f"flash-time: turn {turn} at {(b, lq, h, dh)} bf16 causal, device ms a call: "
                + " ".join(f"{key} {val[-1]:.6f}" for key, val in turns.items()))
        times = {key: statistics.median(val) for key, val in turns.items()}
        log(f"flash-time: at {(b, lq, h, dh)}, median (min-max) over {FLASH_TIME_TURNS} turns: "
            + "; ".join(f"{key} {times[key]:.6f} ({min(val):.6f}-{max(val):.6f})"
                        for key, val in turns.items()))
        for name in ("flash_fwd", "flash_dq", "flash_dkdv"):
            bound, by = flash_bound_ms(name, b, lq, lq, h, dh, True)
            bwd = name != "flash_fwd"
            out[(b, lq, h, dh, name)] = {
                "ms": times[name],
                "plain_ms": times["plain_bwd" if bwd else "plain_fwd"],
                "bound_ms": bound, "bound_by": by,
                "library_ms": times["lib_bwd" if bwd else "lib_fwd"],
            }
            log(f"flash-time: {name} at {(b, lq, h, dh)}: kernel {times[name]:.6f} ms, "
                f"bound {bound:.6f} ms ({by}), {bound / times[name]:.4f} of the bound; "
                f"plain {out[(b, lq, h, dh, name)]['plain_ms']:.6f} ms; library "
                f"{out[(b, lq, h, dh, name)]['library_ms']:.6f} ms")
        del q, k, v, g, o, lse, delta, qt, kt, vt, gt, ot, calls
        torch.cuda.empty_cache()
    return out


# --- the transformer LM ---------------------------------------------------------

LM_CONFIG = dict(vocab_size=8192, d_model=512, n_heads=4, n_layers=4, d_ff=2048,
                 max_len=2048, dtype="bfloat16", loss_chunk=1024)
LM_BATCH, LM_LEN, LM_LR = 8, 1024, 1e-3
LM_PARITY_CONFIG = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                        max_len=128, dtype="float32")
# a tenth of one Adam step (lr 1e-3): far above float32 reordering, far below
# an update whose sign flipped
LM_PARITY_ATOL = 1e-4


def copy_task_batches(n, b, l, vocab, seed, n_patterns=16):
    """[n, b, l] tokens, targets and masks: each sequence repeats a 4-token
    pattern drawn from a seeded pool of ``n_patterns``, so the next token is
    predictable and every batch draws on the same tokens."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pool = rng.randint(1, vocab, size=(n_patterns, 4))
    base = pool[rng.randint(0, n_patterns, size=(n, b))]
    toks = np.tile(base, (1, 1, l // 4 + 1))[:, :, : l + 1]
    return (toks[:, :, :-1].astype(np.int64), toks[:, :, 1:].astype(np.int64),
            np.ones((n, b, l), np.float32))


def _lm_trainer(seed, device="cuda", **cfg):
    from omldm_tpu_torch.models.transformer import TransformerConfig
    from omldm_tpu_torch.parallel import SeqTrainer

    return SeqTrainer(TransformerConfig(**cfg), device=device, lr=LM_LR, seed=seed)


def phase_lm(torch, attention, steps, seed):
    from omldm_tpu_torch.models import generate, lm_loss
    from omldm_tpu_torch.models.transformer import tree_leaves

    trainer = _lm_trainer(seed, **LM_CONFIG)
    cfg = trainer.cfg
    tok, tgt, mask = copy_task_batches(steps + 1, LM_BATCH, LM_LEN, cfg.vocab_size, seed)
    t0 = time.perf_counter()
    warm = float(trainer.step(tok[0], tgt[0], mask[0]))
    torch.cuda.synchronize()
    log(f"lm: warm-up step {time.perf_counter() - t0:.3f} s, loss {warm:.4f}")
    torch.cuda.reset_peak_memory_stats()
    for name in attention.launches:
        attention.launches[name] = 0
    t0 = time.perf_counter()
    losses = trainer.step_many(tok[1:], tgt[1:], mask[1:])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(attention.launches)
    losses = losses.float().cpu().tolist()
    tokens = steps * LM_BATCH * LM_LEN
    peak = torch.cuda.max_memory_allocated()
    log(f"lm: {steps} steps in {wall:.4f} s: {wall / steps * 1e3:.3f} ms/step, "
        f"{tokens / wall:.0f} tokens/s, peak memory {peak / 2**30:.3f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses) + f"; launches {launches}")
    check(all(x == x and abs(x) < float("inf") for x in losses), "an LM loss is not finite")
    # the warm-up batch's loss before any update, against the same batch's
    # loss after all of them
    with torch.no_grad():
        after = float(lm_loss(cfg, trainer.params, *(torch.as_tensor(a[0], device="cuda")
                                                     for a in (tok, tgt, mask))))
    log(f"lm: loss on the warm-up batch {warm:.4f} before training, {after:.4f} after")
    check(after < warm, f"the LM loss did not fall: {warm} -> {after}")
    want = cfg.n_layers * steps
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times in the LM phase, expected {want}")
    tensors = tree_leaves(trainer.params) + tree_leaves(trainer.opt)
    check(all(t.device.type == "cuda" for t in tensors),
          "a parameter or optimizer tensor is not on cuda")
    check(trainer.fitted == (steps + 1) * LM_BATCH * LM_LEN, "fitted token count is off")

    before = dict(attention.launches)
    t0 = time.perf_counter()
    prompt = torch.as_tensor(tok[0][:2, :64], device="cuda")
    gen = generate(cfg, trainer.params, prompt, 32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(gen.shape == (2, 32) and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size,
          "generate returned tokens out of range")
    check(attention.launches == before, "a flash kernel ran on the decode path")
    log(f"lm: greedy generate 2 x 32 tokens after a 64-token prompt in {gen_s:.3f} s "
        f"(no kernel launched); first row {gen[0, :12].tolist()}")
    log("lm: " + json.dumps({
        "steps": steps, "batch": LM_BATCH, "context": LM_LEN, "wall_s": wall,
        "ms_per_step": wall / steps * 1e3, "tokens_per_s": tokens / wall,
        "peak_memory_bytes": peak, "losses": losses, "warmup_batch_loss": [warm, after],
        "launches": launches,
    }))
    return launches, trainer


def phase_lm_parity(torch, seed):
    import numpy as np

    from omldm_tpu_torch.models import generate
    from omldm_tpu_torch.models.transformer import tree_leaves

    cfg = LM_PARITY_CONFIG
    tok, tgt, mask = copy_task_batches(3, 4, 128, cfg["vocab_size"], seed + 1)
    start = _lm_trainer(seed, device="cpu", **cfg).host_params()  # numpy parameters
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = _lm_trainer(seed, device=device, **cfg)
        trainer.load_numpy(start)
        losses = trainer.step_many(tok, tgt, mask).cpu().numpy()
        prompt = torch.as_tensor(tok[0][:, :16], device=device)
        gen = generate(trainer.cfg, trainer.params, prompt, 24).cpu().numpy()
        runs[device] = (losses, tree_leaves(trainer.host_params()), gen)
    (lc, pc, gc), (lp, pp, gp) = runs["cuda"], runs["cpu"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(pc, pp))
    log(f"lm-parity: float32 {cfg}, 3 steps cuda vs cpu: losses {lc.tolist()} vs "
        f"{lp.tolist()}, final params max|d|={err:.3e} (atol {LM_PARITY_ATOL}), greedy "
        f"tokens equal: {bool((gc == gp).all())}")
    check(err <= LM_PARITY_ATOL, f"LM params differ between cuda and cpu: {err}")
    check(bool((gc == gp).all()), "greedy tokens differ between cuda and cpu")


def phase_lm_profile(torch, attention, trainer, out_dir: Path, seed):
    """4 LM steps under torch.profiler: device busy time, the flash kernels'
    share, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tok, tgt, mask = copy_task_batches(4, LM_BATCH, LM_LEN, trainer.cfg.vocab_size, seed + 7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        trainer.step_many(tok, tgt, mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = tp.key_averages()
    (out_dir / "lm_torch.txt").write_text(avg.table(sort_by="self_cpu_time_total", row_limit=60))
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kernels) / 1e6
    flash = sum(_dev_us(e) for e in kernels if "flash_" in e.key) / 1e6
    log(f"lm-profile: 4 steps, wall {wall:.4f} s under the profiler; device busy "
        f"{busy:.4f} s ({busy / wall:.3f} of the wall), flash kernels {flash:.4f} s "
        f"({flash / max(busy, 1e-12):.3f} of busy); top kernels:")
    for e in sorted(kernels, key=lambda e: -_dev_us(e))[:12]:
        log(f"  {_dev_us(e) / 1e3:.3f} ms, {e.count} launches: {e.key[:100]}")
    return busy, flash, wall


FLASH_SOURCES = {
    "flash_fwd": "omldm_tpu/ops/attention.py:269",
    "flash_dq": "omldm_tpu/ops/attention.py:450",
    "flash_dkdv": "omldm_tpu/ops/attention.py:493",
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--records", type=int, default=100_000)
    parser.add_argument("--parity-records", type=int, default=5_000)
    parser.add_argument("--lm-steps", type=int, default=8)
    parser.add_argument("--profile", type=Path, default=None, metavar="DIR")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "omldm_tpu_torch" / "csrc" / "pa_scan.cu").exists():
        print(f"chip_smoke: no omldm_tpu_torch checkout beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from omldm_tpu_torch.ops import attention, pa_scan

    t_start = time.perf_counter()
    phase_setup(torch)
    phase_build(pa_scan, attention)
    max_err = phase_check(torch, pa_scan)
    times = phase_time(torch, pa_scan)
    t0 = time.perf_counter()
    events = make_events(args.records, args.seed, query_at=args.records // 2)
    log(f"slice: generated {len(events)} events ({args.records} training) "
        f"in {time.perf_counter() - t0:.2f} s")
    launches, wall = phase_slice(torch, pa_scan, events)
    phase_parity(events[: args.parity_records + 1])
    flash_err = phase_flash_check(torch, attention)
    flash_times = phase_flash_time(torch, attention)
    flash_launches, trainer = phase_lm(torch, attention, args.lm_steps, args.seed)
    phase_lm_parity(torch, args.seed)
    if args.profile is not None:
        busy_s = phase_profile(torch, events, args.profile)
        log(f"profile: device busy {busy_s:.4f} s against the unprofiled "
            f"slice's {wall:.3f} s wall: idle share {1.0 - busy_s / wall:.4f}")
        phase_lm_profile(torch, attention, trainer, args.profile, args.seed)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    main_shape = (256, N_FEATURES + 1)
    kernels = [{
        "name": "pa_scan",
        "route": "cuda",
        "source": "omldm_tpu_torch/csrc/pa_scan.cu",
        "replaces": "omldm_tpu/ops/pa_scan.py:27",
        "launches": launches,
        "max_abs_err": max_err,
        **times[main_shape],
        "library_ms": None,
    }]
    b, lq, h, dh = FLASH_TIME_SHAPES[0]  # the LM slice's shape
    for name, replaces in FLASH_SOURCES.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "omldm_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": flash_launches[name],
            "max_abs_err": flash_err[name],
            **flash_times[(b, lq, h, dh, name)],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
