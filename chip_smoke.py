#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (omldm_tpu_torch) on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N] [--records N] [--parity-records N]
                          [--lm-steps N] [--profile DIR]

Phases (any failure raises and the script exits nonzero without a result):
  1. setup       card name and power limit, torch/CUDA versions, TF32 off;
  2. build       every kernel source in omldm_tpu_torch/csrc/, one nvcc
                 each, started together (pa_scan.cu, flash_attention.cu,
                 scatter_add.cu); each pa_scan and flash kernel's registers,
                 spills and static shared memory from the -Xptxas -v log
                 (the Hopper flash kernels must not spill);
  3. check       pa_scan against its plain PyTorch version on the card, at
                 (B, D+1) in {(1,29), (256,29), (256,1025), (255,4097)},
                 variants PA/PA-I/PA-II, C in {0.01, 0.5}, masks with trailing
                 and scattered zeros, labels in {0,1} and {-1,+1}; then one
                 batch of CHUNKED_CHECK's 28,000 rows, past the kernel's row
                 limit, which the wrapper runs as two chunks;
  4. time        pa_scan at TIME_SHAPES: CUDA events over 1000 back-to-back
                 calls (host work included once it exceeds the kernel), the
                 host's own time a call, the device's busy time a call
                 (torch.profiler, the launches' sum), the device span a call
                 (first launch's start to last launch's end, from the same
                 kind of trace) and a CUDA graph's time a call (events around
                 replays of 100 captured calls: the launches and the gaps
                 between them, no host work), beside its plain version;
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
                 twins (run one (b, h) head at a time) on FLASH_CHECKS (among
                 them q, k and v as views into one packed [B, L, 3, H, Dh]
                 projection, L shorter than one tile, dh 64 with ragged L,
                 CTAs with no tile to sweep):
                 out, dq, dk, dv within FLASH_TOL's relative L2 and
                 per-element limits, lse absolute;
  8. flash-time  device time a call (torch.profiler) of each flash kernel,
                 its plain twin and the PyTorch library call
                 (scaled_dot_product_attention, forward and autograd
                 backward) at FLASH_TIME_SHAPES, median of 3 turns, with
                 each kernel's bound, TFLOP/s, share of the bound and ratio
                 to the library call, the dQ + dK/dV pair against the
                 library's backward, and each wrapper's host time a call;
  9. lm          SeqTrainer on cuda at the LM's full width (LM_CONFIG: vocab
                 8192, d 512, 4 heads, 4 layers, d_ff 2048, bf16, loss chunk
                 1024, Adam 1e-3), context 1024, batch 8: one warm-up step,
                 then --lm-steps steps through step_many on a seeded copy-task
                 stream; the loss falls, each flash kernel launched
                 n_layers x steps times; then greedy generate (no kernel);
 10. lm-parity   a small float32 config trained 3 steps on cuda and on cpu
                 from the same numpy parameters: parameters within
                 LM_PARITY_ATOL, greedy tokens equal;
 11. sparse-check the scatter_add kernel against its plain version on the
                 card at (B, K) in SPARSE_CHECKS into D = 13 + 2^18 and the
                 outer entry point at OUTER_CHECK (D = 2^20, C = 2), with
                 uniform, duplicate-heavy (a pool of 64) and Criteo-shaped
                 index draws, masked rows, pad slots and one out-of-range
                 index, each entry point copying (its input left alone) and
                 in place (on a clone, against the plain version in place):
                 every element within scatter_limit; then three fits of a
                 sparse PA-II (13 + 2^18) and a sparse Softmax (2^20)
                 through MLPipeline.fit, which must launch the kernel once a
                 fit and write into the donated weights' memory;
 12. sparse-time the kernel in place and in-place index_add_ at
                 SPARSE_TIME_SHAPES (Criteo, uniform and pool-of-64 draws),
                 as a CUDA graph of 200 calls and as device busy time a call
                 (torch.profiler), median (min-max) of 3 turns; at the stream
                 shapes also the plain version, the copying kernel and
                 torch.index_add; an empty kernel's launch as the floor;
                 the in-place bound (distinct touched rows) and the copying
                 form's;
 13. calibrate   python -m omldm_tpu_torch.ops.sparse_calibrate --smoke on
                 the card into a temporary table: a cuda section with every
                 formulation measured (mxu skipped by its cap);
 14. sparse      StreamJob(parallelism=16, batch 256) on cuda: a sparse
                 Create (PA-II, C 0.1, nFeatures 13 + 2^18, hashSpace 2^18,
                 maxNnz 40, Asynchronous), SPARSE_RECORDS Criteo-shaped
                 records (13 numerics, 26 hashed categoricals, a planted
                 linear rule on the numerics), every tenth a forecast, a
                 Query halfway; the formulation the calibration table picks
                 there is logged (scatterImpl pinned to the kernel if it
                 would launch none); scatter_add launched once per fit,
                 holdout accuracy > 0.6;
 15. sparse-parity the first --parity-records records of phase 14 on cuda
                 and on cpu at parallelism 4, as phase 6;
 16. avazu       AVAZU_RECORDS records of 21 hashed categoricals into
                 2^20 through a sparse Softmax (nClasses 2): the outer entry
                 point launched once per fit.
With --profile DIR, after phase 16: the slice's and the sparse stream's
runs under cProfile (host time by function) and torch.profiler (device
busy time), then 4 LM steps under torch.profiler (device busy time, the
flash kernels' share, the top kernels); tables are written into DIR.
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
# a batch past the kernel's row limit (26,944): the wrapper runs two chunks
CHUNKED_CHECK = (28_000, 29)
TIME_SHAPES = [(256, 29), (256, 1025), (255, 4097)]
N_FEATURES = 28  # HIGGS


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


_LAP = [time.perf_counter()]


def lap(label: str) -> None:
    """Logs the wall seconds since the previous lap: where the script's time
    goes against its limit."""
    now = time.perf_counter()
    log(f"lap: {label} {now - _LAP[0]:.1f} s")
    _LAP[0] = now


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


def phase_build(pa_scan, attention, sparse):
    """One nvcc per source, all started together, then waited for."""
    t0 = time.perf_counter()
    libraries = [("pa_scan.cu", pa_scan.LIBRARY), ("flash_attention.cu", attention.LIBRARY),
                 ("scatter_add.cu", sparse.LIBRARY)]
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
    for lib, prefix in ((pa_scan.LIBRARY, "_kernel"), (attention.LIBRARY, "flash_")):
        for kernel, info in ptxas_summary(lib.build_log, prefix).items():
            log(f"build: ptxas {kernel}: {info}")
            check("_sm90_kernel" not in kernel or info.get("spill_stores", 0) + info.get("spill_loads", 0) == 0,
                  f"{kernel} spills: {info}")


def ptxas_summary(build_log: str, prefix: str = "flash_") -> dict:
    """Registers, spills and static shared memory of each kernel instance
    whose name holds ``prefix``, from nvcc's -Xptxas -v report (names
    demangled by c++filt where the machine has it)."""
    import re
    import shutil

    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None or prefix not in name:
            continue
        info = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            info["spill_stores"], info["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            info["static_smem"] = int(m.group(1)) if m else 0
    if out and shutil.which("c++filt"):
        names = list(out)
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
        if len(plain) == len(names):
            out = {p.replace("(anonymous namespace)::", ""): out[n] for p, n in zip(plain, names)}
    return out


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
    B, D = CHUNKED_CHECK
    limit = pa_scan.LIBRARY.load().omldm_pa_scan_max_rows()
    check(B > limit, f"CHUNKED_CHECK B={B} is not past the row limit {limit}")
    w0, x, y, mask = _kernel_inputs(torch, B, D, "pm1", seed=5)
    before = pa_scan.launches
    t0 = time.perf_counter()
    kw, kl = pa_scan.pa_scan_update(w0, x, y, mask, "PA-II", 0.5)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    chunks = pa_scan.launches - before
    pw, pl = pa_scan.pa_scan_reference(w0, x, y, mask, "PA-II", 0.5)
    err_w = (kw - pw).abs().max().item()
    err_l = abs(kl.item() - pl.item())
    log(f"check: pa_scan B={B} D+1={D} past the row limit {limit}: {chunks} chunks "
        f"({k_s:.3f} s with the first call's scratch), max|dw|={err_w:.3e} |dloss|={err_l:.3e}")
    check(chunks == -(-B // limit), f"pa_scan ran {chunks} chunks for B={B}")
    check(torch.allclose(kw, pw, rtol=W_RTOL, atol=W_ATOL) and err_l <= LOSS_ATOL,
          f"pa_scan disagrees past the row limit: max|dw|={err_w} |dloss|={err_l}")
    return max(max_w, err_w)


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


def _call_latency(torch, fn, reps):
    """The device's time a call of ``fn`` with the gaps between its
    launches: (the median span from a call's first kernel start to its last
    kernel end in a torch.profiler trace of ``reps`` eager calls, the time a
    call of a CUDA graph of ``reps`` captured calls, by events around 5
    replays). Calls are told apart in the trace by launch order: every call
    launches the same number of kernels."""
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a session now and then comes back without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            tp.export_chrome_trace(str(trace))
            kern = sorted((e for e in json.loads(trace.read_text()).get("traceEvents", [])
                           if e.get("cat") == "kernel"), key=lambda e: e["ts"])
        if kern and len(kern) % reps == 0:
            break
        log(f"profile: session {attempt} traced {len(kern)} kernels for {reps} calls; "
            f"profiling again")
    check(kern and len(kern) % reps == 0,
          f"torch.profiler traced {len(kern)} kernels for {reps} calls in 3 sessions")
    per = len(kern) // reps
    spans = [kern[i + per - 1]["ts"] + kern[i + per - 1]["dur"] - kern[i]["ts"]
             for i in range(0, len(kern), per)]
    span_ms = statistics.median(spans) / 1e3
    return span_ms, _graph_ms(torch, fn, reps)


def _graph_ms(torch, fn, reps, replays=5):
    """The time a call of ``fn`` as a CUDA graph of ``reps`` captured calls,
    by events around ``replays`` replays: its launches and the gaps between
    them on the device, no host work (warmed up on a side stream first, as
    capture wants)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def phase_time(torch, pa_scan):
    """Kernel ms from CUDA events over 1000 back-to-back calls (once the
    kernel is shorter than the wrapper's host work, this times the host),
    plain ms over fewer, in turns kernel, plain, kernel, plain (the second
    of each is reported); the host's time a call (``_host_us``); the
    device's busy time a call (torch.profiler, 200 calls, median of 3
    turns: the three launches' sum); then the time a call with the gaps
    between its launches (``_call_latency``: the device span of an eager
    call and a CUDA graph's time a call). The kernel's ``ms`` is the graph's
    time a call: the launches and their gaps, without the host."""
    import statistics

    out = {}
    for B, D in TIME_SHAPES:
        w0, x, y, mask = _kernel_inputs(torch, B, D, "01", seed=99)
        kern = lambda: pa_scan.pa_scan_update(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
        plain = lambda: pa_scan.pa_scan_reference(w0, x, y, mask, "PA-I", 0.01)  # noqa: E731
        k1 = _time_ms(torch, kern, 1000)
        p1 = _time_ms(torch, plain, 10)
        k2 = _time_ms(torch, kern, 1000)
        p2 = _time_ms(torch, plain, 10)
        host = _host_us(torch, kern)
        parts = {}
        dev = [_device_ms(torch, kern, 200, parts) for _ in range(3)]
        d = statistics.median(dev)
        span, graph = _call_latency(torch, kern, 200)
        b, by = bound_ms(B, D)
        out[(B, D)] = {"ms": graph, "plain_ms": p2, "bound_ms": b, "bound_by": by}
        log(f"time: pa_scan B={B} D+1={D}: CUDA graph {graph:.6f} ms a call (launches and "
            f"their gaps); eager device span {span:.6f} ms a call (median); device busy "
            f"{d:.6f} ms a call (torch.profiler, {min(dev):.6f}-{max(dev):.6f} over 3 turns); "
            f"events {k1:.6f} / {k2:.6f} ms; host {host:.1f} us a call; "
            f"plain {p1:.4f} / {p2:.4f} ms, bound {b:.7f} ms ({by}-bound by the "
            f"roofline; the chain of {B} dependent rows bounds it in fact), "
            f"library none")
        log(f"time: pa_scan B={B} D+1={D}: its launches, device ms a call (last turn): " + "; ".join(
            f"{name.split('(')[0]} {ms:.6f}" for name, ms in parts.items()))
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
    ("sync point: flat params to the host", "pipelines/pipeline.py", "get_flat_params"),
    ("sync point: flat params to the device", "pipelines/pipeline.py", "set_flat_params"),
    ("hub fold (Asynchronous PS)", "protocols/async_ps.py", "receive"),
]


def _dev_us(e):
    """A torch.profiler average's device time, microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def phase_profile(torch, events, out_dir: Path, stream="slice"):
    """A stream (``stream``: slice or sparse) under cProfile, then under
    torch.profiler."""
    import cProfile
    import io
    import pstats

    out_dir.mkdir(parents=True, exist_ok=True)
    prof = cProfile.Profile()
    prof.enable()
    _, _, wall_c = _run_slice(torch, events)
    prof.disable()
    st = pstats.Stats(prof)
    st.dump_stats(str(out_dir / f"{stream}.pstats"))
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
    (out_dir / f"{stream}_cprofile.txt").write_text(buf.getvalue())
    host = {}
    for (path, _, name), (_, _, tt, ct, _) in st.stats.items():
        for label, suffix, fname in PROFILE_FUNCS:
            if name == fname and path.endswith(suffix):
                host[label] = host.get(label, 0.0) + ct
    top_self = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    log(f"profile[{stream}]: cProfile wall {wall_c:.3f} s (profiler overhead included); "
        "cumulative host seconds by function:")
    for label, _, _ in PROFILE_FUNCS:
        log(f"  {label}: {host.get(label, 0.0):.3f}")
    log(f"profile[{stream}]: top self time:")
    for (path, line, name), (_, nc, tt, _, _) in top_self:
        log(f"  {tt:.3f} s self, {nc} calls: {Path(path).name}:{line} {name}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        _, _, wall_t = _run_slice(torch, events)
    events_avg = tp.key_averages()
    (out_dir / f"{stream}_torch.txt").write_text(
        events_avg.table(sort_by="self_cpu_time_total", row_limit=40)
    )

    from torch.autograd import DeviceType

    kernels = [e for e in events_avg if e.device_type == DeviceType.CUDA]
    busy_s = sum(_dev_us(e) for e in kernels) / 1e6
    log(f"profile[{stream}]: torch.profiler wall {wall_t:.3f} s (profiler overhead "
        f"included); device busy {busy_s:.4f} s in {len(kernels)} kernel "
        f"names, {sum(e.count for e in kernels)} launches")
    for e in sorted(kernels, key=lambda e: -_dev_us(e))[:8]:
        log(f"  {_dev_us(e) / 1e3:.3f} ms, {e.count} launches: {e.key[:90]}")
    host_ops = sorted(events_avg, key=lambda e: -e.self_cpu_time_total)[:10]
    log(f"profile[{stream}]: top host self time under torch.profiler:")
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
    ("packed_qkv", 8, 1024, 1024, 4, 128, "bfloat16", 0, 0),
    ("short48", 2, 48, 48, 4, 128, "bfloat16", 0, 0),
    ("dh64_ragged", 2, 1000, 1000, 8, 64, "bfloat16", 0, 0),
    # causal: the first 128-row Q tile sees no key and the last key tile no
    # query, so both sm90 kernels have CTAs with nothing to sweep
    ("kv_offset200", 1, 256, 256, 2, 128, "bfloat16", 0, 200),
]
# cases whose q, k and v are views into one [B, L, 3, H, Dh] projection, as
# the transformer hands them over
FLASH_PACKED = {"packed_qkv"}
# Each kernel output against its twin, per tensor: the relative L2 error
# ||a - ref|| / ||ref||, and the worst element against its own size plus the
# tensor's rms, max |a - ref| / (|ref| + rms(ref)); lse absolute. Limits: a
# few times the largest reading of the sound kernels (PERF.md), far below
# what one wrong row tile or a mis-scaled P would give. bfloat16 is compared
# in its working type (both sides round out, dq, dk and dv to bf16, and P
# against another row max); float32 is held tightly.
FLASH_TOL = {"bfloat16": (1e-2, 1e-1, 1e-5), "float32": (2e-6, 2e-5, 4e-6)}  # l2, elem, lse
FLASH_TIME_SHAPES = [(8, 1024, 4, 128), (2, 4096, 4, 128)]


def _flash_inputs(torch, b, lq, lk, h, dh, dtype, seed, packed=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda").to(dt)  # noqa: E731
    if packed:  # transformer.py's qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert lq == lk
        qkv = mk(b, lq, 3, h, dh)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mk(b, lq, h, dh)
    return mk(b, lq, h, dh), mk(b, lk, h, dh), mk(b, lk, h, dh), mk(b, lq, h, dh)


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
        packed = name in FLASH_PACKED
        for causal in (False, True):
            q, k, v, g = _flash_inputs(torch, b, lq, lk, h, dh, dtype, seed=n, packed=packed)
            check(not packed or q.data_ptr() + h * dh * q.element_size() == k.data_ptr(),
                  "the packed case's k is not a view into the qkv projection")
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
            if causal and ko > qo:  # rows 0 .. ko - qo - 1 see no key
                rows = out[:, :ko - qo].float()
                check(rows.abs().max().item() == 0.0 and dq[:, :ko - qo].abs().max().item() == 0.0,
                      "rows that see no key must have zero output and zero dq")
                check(lse.reshape(b, h, lq)[:, :, :ko - qo].max().item() < attention.NEG_INF / 2,
                      "rows that see no key must have an lse near NEG_INF")
            log(f"flash-check: {name} {(b, lq, lk, h, dh)} {dtype} causal={causal} "
                f"q_offset={qo} kv_offset={ko}{' packed' if packed else ''}: "
                f"max|d|/relL2/element " + " ".join(
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


def flash_flops(kernel, b, lq, lk, h, dh, causal):
    """The bf16 tensor-core operations of one call: 2 per multiply-add of
    its products (forward 2, dQ 3, dK/dV 4), over the (query, key) pairs the
    causal mask keeps."""
    pairs = sum(min(lk, i + 1) for i in range(lq)) if causal else lq * lk
    products = {"flash_fwd": 2, "flash_dq": 3, "flash_dkdv": 4}[kernel]
    return 2 * products * dh * pairs * b * h


def flash_bound_ms(kernel, b, lq, lk, h, dh, causal):
    """Least time for the same work on this card: the larger of the bf16
    tensor-core operations over 989 TFLOP/s and the bytes (each input read
    once, each output written once) over 3.35 TB/s. Operations count only
    the (query, key) pairs the causal mask keeps."""
    flops = flash_flops(kernel, b, lq, lk, h, dh, causal)
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


def _device_ms(torch, fn, reps, by_name=None):
    """The card's busy time a call: every kernel, copy and memset that
    torch.profiler traces in ``reps`` calls after warm-up, over ``reps``;
    host work and the gaps between launches are left out. A dict given as
    ``by_name`` receives each kernel's ms a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a session now and then comes back without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in tp.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(_dev_us(e) for e in kernels)
        if busy_us > 0:
            break
        log(f"profile: session {attempt} traced no device time; profiling again")
    check(busy_us > 0, "torch.profiler traced no device time in 3 sessions")
    if by_name is not None:
        by_name.update({e.key: _dev_us(e) / 1e3 / reps for e in kernels})
    return busy_us / 1e3 / reps


FLASH_TIME_TURNS = 3


def _launch_attrs(torch, fn):
    """What the profiler recorded of each kernel a call of ``fn``
    launches: {name: {grid, block, registers per thread, shared memory}},
    read from its Chrome trace (the launch's own record: shared memory is
    static plus dynamic, a CTA)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
        for _ in range(3):  # a lone launch's record is sometimes missing from the trace
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        tp.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
    keys = ("grid", "block", "registers per thread", "shared memory")
    return {e["name"]: {k: e["args"][k] for k in keys if k in e.get("args", {})}
            for e in events if e.get("cat") == "kernel"}


def _host_us(torch, fn, batches=8, reps=50):
    """Host microseconds a call of a wrapper (checks, allocation, tensor
    maps, launch), the card's work left out (the queue never fills in
    ``reps`` calls of these kernels): the least mean over ``batches``
    batches, since the shared host only ever adds time."""
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / reps * 1e6


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
        names = {key: {} for key in calls}  # kernel names each call launched
        for turn in range(FLASH_TIME_TURNS):
            for key, (reps, fn) in calls.items():
                turns[key].append(_device_ms(torch, fn, reps, names[key]))
            log(f"flash-time: turn {turn} at {(b, lq, h, dh)} bf16 causal, device ms a call: "
                + " ".join(f"{key} {val[-1]:.6f}" for key, val in turns.items()))
        times = {key: statistics.median(val) for key, val in turns.items()}
        log(f"flash-time: at {(b, lq, h, dh)}, median (min-max) over {FLASH_TIME_TURNS} turns: "
            + "; ".join(f"{key} {times[key]:.6f} ({min(val):.6f}-{max(val):.6f})"
                        for key, val in turns.items()))
        host = {name: _host_us(torch, calls[name][1]) for name in ("flash_fwd", "flash_dq",
                                                                    "flash_dkdv")}
        for name in ("flash_fwd", "flash_dq", "flash_dkdv"):
            for kernel, attrs in _launch_attrs(torch, calls[name][1]).items():
                log(f"flash-time: {name} at {(b, lq, h, dh)} launches {kernel[:70]}: {attrs}")
            # bf16 at these widths runs the Hopper design for every pass
            check(any(f"{name}_sm90_kernel" in kernel for kernel in names[name]),
                  f"{name} at {(b, lq, h, dh)} launched {list(names[name])}, not {name}_sm90_kernel")
        for name in ("flash_fwd", "flash_dq", "flash_dkdv"):
            bound, by = flash_bound_ms(name, b, lq, lq, h, dh, True)
            bwd = name != "flash_fwd"
            lib = times["lib_bwd" if bwd else "lib_fwd"]
            out[(b, lq, h, dh, name)] = {
                "ms": times[name],
                "plain_ms": times["plain_bwd" if bwd else "plain_fwd"],
                "bound_ms": bound, "bound_by": by,
                "library_ms": lib,
            }
            tflops = flash_flops(name, b, lq, lq, h, dh, True) / (times[name] * 1e-3) / 1e12
            log(f"flash-time: {name} at {(b, lq, h, dh)}: kernel {times[name]:.6f} ms, "
                f"{tflops:.1f} TFLOP/s, bound {bound:.6f} ms ({by}), {bound / times[name]:.4f} "
                f"of the bound; plain {out[(b, lq, h, dh, name)]['plain_ms']:.6f} ms; library "
                f"{lib:.6f} ms ({'SDPA backward, dQ+dK+dV' if bwd else 'SDPA forward'}), "
                f"kernel / library {times[name] / lib:.3f}; host {host[name]:.1f} us a call")
        for which, name in (("fwd", "flash_fwd"), ("dq", "flash_dq"), ("dkdv", "flash_dkdv")):
            states = [s for _, tiles in attention.sm90_tile_plan(which, lq, lq, True)
                      for _, pair in tiles for s in pair]
            log(f"flash-time: {name} at {(b, lq, h, dh)}: a head's warpgroup tiles "
                + ", ".join(f"{s} {states.count(s)}" for s in ("full", "cut", "skip")))
        pair = times["flash_dq"] + times["flash_dkdv"]
        log(f"flash-time: backward pair dQ + dK/dV at {(b, lq, h, dh)}: {pair:.6f} ms against "
            f"SDPA's backward {times['lib_bwd']:.6f} ms: {pair / times['lib_bwd']:.3f}x")
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


# --- the sparse (padded-COO) path ------------------------------------------------

CRITEO_HASH = 1 << 18
CRITEO_DIM = 13 + CRITEO_HASH      # nFeatures: 13 numerics + the hashed space
CRITEO_NNZ = 40                    # maxNnz: 39 active slots and one pad
AVAZU_DIM = 1 << 20                # 21 categorical slots hashed into 2^20
AVAZU_SLOTS = 21
SPARSE_RECORDS, AVAZU_RECORDS = 100_000, 20_000  # phases 14 and 16
# (B, K) into w[CRITEO_DIM + 1]: one record and a micro-batch of the slice
# (K = maxNnz + the bias slot), and the experiment's 4096 x 39
SPARSE_CHECKS = [(1, CRITEO_NNZ + 1), (256, CRITEO_NNZ + 1), (4096, 39)]
# the outer entry point: (B, K, D, C) of a ragged Avazu Softmax batch
OUTER_CHECK = (255, AVAZU_SLOTS + 1, AVAZU_DIM + 1, 2)
# (name, B, K, D, C, draw) timed in place: the slice's shape (Criteo draw,
# then uniform), the experiment's (Criteo, uniform, a pool of 64) and the
# Avazu Softmax's; the first of each name feeds the kernels line
SPARSE_TIME_SHAPES = [
    ("slice", 256, CRITEO_NNZ + 1, CRITEO_DIM + 1, 1, "criteo"),
    ("slice", 256, CRITEO_NNZ + 1, CRITEO_DIM + 1, 1, "uniform"),
    ("experiment", 4096, 39, CRITEO_DIM, 1, "criteo"),
    ("experiment", 4096, 39, CRITEO_DIM, 1, "uniform"),
    ("experiment", 4096, 39, CRITEO_DIM, 1, "pool64"),
    ("avazu", 256, AVAZU_SLOTS + 1, AVAZU_DIM + 1, 2, "avazu"),
]
# what the stream shapes also time: the plain version in place and the
# copying forms (the kernel of PRs 3-5 and torch.index_add)
SPARSE_TIME_FULL = {("slice", "criteo"), ("avazu", "avazu")}
SPARSE_TIME_TURNS = 3


def _scatter_inputs(torch, b, k, d, c, draw, seed, device="cuda"):
    """w[d] (or [d, c]), idx[b, k] int32, coef[b] (or [b, c]), val[b, k] on
    the card. ``draw``: "uniform" indices in [0, d); "pool64", every index
    from a pool of 64; "criteo" and "avazu", the learners' layouts --
    hashed slots in [13, d - 1) after 13 numeric slots at 0..12 in every
    record (criteo) or in [0, d - 1) (avazu), then the bias slot d - 1 with
    value 1; criteo's maxNnz = 40 holds its 39 active slots and one pad
    slot (0, 0). Rows and pad slots are masked with zeros; index (0, 1)
    lies past d, with a large update, and must be dropped."""
    import numpy as np

    rng = np.random.RandomState(seed)
    val = rng.randn(b, k)
    if draw == "uniform":
        idx = rng.randint(0, d, size=(b, k))
    elif draw == "pool64":
        idx = rng.choice(rng.randint(0, d, size=64), size=(b, k))
    elif draw == "criteo":
        idx = rng.randint(13, d - 1, size=(b, k))
        idx[:, :13] = np.arange(13)
        idx[:, -2], val[:, -2] = 0, 0.0       # the pad slot
    else:
        idx = rng.randint(0, d - 1, size=(b, k))
    if draw in ("criteo", "avazu"):
        idx[:, -1], val[:, -1] = d - 1, 1.0   # the bias slot
    else:
        idx[::3, -1], val[::3, -1] = 0, 0.0   # pad slots
    cshape = (b,) if c == 1 else (b, c)
    coef = rng.randn(*cshape) * 0.1
    coef[rng.rand(b) < 0.2] = 0.0             # masked rows
    if b > 8:
        coef[-(b // 8):] = 0.0                # a ragged tail
    coef[0] = 1.5
    if k > 1:
        idx[0, 1], val[0, 1] = d + 7, 1000.0  # out of range: dropped
    w = rng.randn(*((d,) if c == 1 else (d, c)))
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)  # noqa: E731
    return (as_t(w, np.float32), as_t(idx, np.int32), as_t(coef, np.float32),
            as_t(val, np.float32))


def scatter_limit(torch, w, idx, coef, val):
    """Per-element limit of |kernel - plain|: two float32 sums of the same
    m + 1 terms (w and the m updates landing on the element) in other
    orders differ by at most 2 m 2^-24 (|w| + sum |u|) -- the worst case of
    recursive summation, so the sound kernel's atomics sit far inside it,
    while one update lost or added anywhere with few duplicates does not."""
    from omldm_tpu_torch.ops.sparse import sparse_scatter_add_reference

    absu = sparse_scatter_add_reference(torch.zeros_like(w), idx, coef.abs(), val.abs())
    ones = torch.ones_like(coef)
    hits = sparse_scatter_add_reference(torch.zeros_like(w), idx, ones, torch.ones_like(val))
    return 2.0 * (hits + 1.0) * 2.0 ** -24 * (w.abs() + absu)


def phase_sparse_check(torch, sparse):
    """The kernel (both entry points), copying and in place, against its
    plain version; then the sparse learners through ``MLPipeline.fit`` on the
    card, which must scatter into the donated w without a copy. Returns the
    largest |kernel - plain|."""
    cases = [(b, k, CRITEO_DIM + 1 if k == CRITEO_NNZ + 1 else CRITEO_DIM, 1, draw)
             for b, k in SPARSE_CHECKS for draw in ("uniform", "pool64", "criteo")]
    cases += [(*OUTER_CHECK, draw) for draw in ("uniform", "pool64", "avazu")]
    worst_abs = worst_ratio = 0.0
    n_checks = 0
    for n, (b, k, d, c, draw) in enumerate(cases):
        w, idx, coef, val = _scatter_inputs(torch, b, k, d, c, draw, seed=100 + n)
        entry = sparse.sparse_scatter_add if c == 1 else sparse.sparse_scatter_add_outer
        name = "scatter_add" if c == 1 else "scatter_add_outer"
        kept = w.clone()
        limit = scatter_limit(torch, w, idx, coef, val)
        plain = sparse.sparse_scatter_add_reference(w, idx, coef, val)
        plain_in = sparse.sparse_scatter_add_reference(w.clone(), idx, coef, val, inplace=True)
        copied = entry(w, idx, coef, val)
        w_in = w.clone()
        check(entry(w_in, idx, coef, val, inplace=True) is w_in,
              f"{name} in place did not return its w")
        torch.cuda.synchronize()
        check(torch.equal(w, kept), f"{name} (copying) wrote into its input at {(b, k, d, c, draw)}")
        for form, out, want in (("copy", copied, plain), ("in place", w_in, plain_in)):
            check(bool(torch.isfinite(out).all()), f"{name} {form} output not finite at "
                  f"{(b, k, d, c, draw)}")
            err = (out - want).abs()
            ratio = (err / limit).max().item()
            worst_abs, worst_ratio = max(worst_abs, err.max().item()), max(worst_ratio, ratio)
            n_checks += 1
            log(f"sparse-check: {name} {form} (B, K, D, C)={(b, k, d, c)} {draw}: "
                f"max|d|={err.max().item():.3e}, largest |d|/limit {ratio:.3e}")
            check(ratio <= 1.0, f"{name} {form} disagrees with its plain version at "
                  f"{(b, k, d, c, draw)}: |d|/limit {ratio:.3e}")
    log(f"sparse-check: {n_checks} checks ({len(cases)} cases, copying and in place) pass; "
        f"largest |d| {worst_abs:.3e}; largest reading |d| / (2 (m+1) 2^-24 (|w| + sum|u|)) "
        f"{worst_ratio:.3e} against the limit 1")
    _check_donated_fits(torch, sparse)
    return worst_abs


def _check_donated_fits(torch, sparse):
    """Three fits of a sparse PA-II pipeline at the Criteo width and of a
    sparse Softmax at Avazu's, through ``MLPipeline.fit`` on the card: one
    kernel launch a fit, the weights written where they lie (the same
    memory after every fit), the flat parameters taken before a fit left
    alone by it."""
    import numpy as np

    from omldm_tpu_torch.api.requests import LearnerSpec
    from omldm_tpu_torch.pipelines import MLPipeline

    for name, hp, width, k, entry, leaf in (
        ("PA", {"C": 0.1, "variant": "PA-II"}, CRITEO_DIM, CRITEO_NNZ, "scatter_add", "w"),
        ("Softmax", {"learningRate": 0.05, "nClasses": 2}, AVAZU_DIM, AVAZU_SLOTS,
         "scatter_add_outer", "W"),
    ):
        ds = {"sparse": True, "nFeatures": width, "hashSpace": width - 13 if name == "PA" else width,
              "maxNnz": k, "scatterImpl": "scatter"}
        pipe = MLPipeline(LearnerSpec(name, hyper_parameters=hp, data_structure=ds), dim=width,
                          device="cuda")
        rng = np.random.RandomState(17)
        ptr = pipe.state["params"][leaf].data_ptr()
        before = sparse.launches[entry]
        for _ in range(3):
            idx = rng.randint(0, width, size=(256, k)).astype(np.int32)
            val = rng.randn(256, k).astype(np.float32)
            y = rng.randint(0, 2, size=256).astype(np.float32)
            flat, _ = pipe.get_flat_params()
            kept = flat.copy()
            pipe.fit((idx, val), y, np.ones(256, np.float32))
            torch.cuda.synchronize()
            check(np.array_equal(flat, kept), f"sparse {name}: a fit changed flat params taken before it")
        launched = sparse.launches[entry] - before
        same = pipe.state["params"][leaf].data_ptr() == ptr
        log(f"sparse-check: MLPipeline.fit, sparse {name} at {width} + 1: {launched} {entry} "
            f"launches for 3 fits, weights {'written in place' if same else 'MOVED'}")
        check(launched == 3, f"sparse {name}: {launched} {entry} launches for 3 fits")
        check(same, f"sparse {name}: a donated fit did not write into its weights' memory")


def scatter_bound_ms(b, k, d, c):
    """The copying form's least time, its earlier bound: idx, val and coef
    read once, w read and written once, over 3.35 TB/s; the b k c products
    and adds over the float32 peak are far below it."""
    nbytes = (2 * b * k + b * c + 2 * d * c) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * k * c / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_inplace_bound_ms(b, k, c, touched):
    """The in-place work's least time: idx, val and coef read once, and each
    of the ``touched`` distinct in-range elements of w that a nonzero update
    lands on read and written once (C classes each), over 3.35 TB/s."""
    nbytes = (2 * b * k + b * c + 2 * touched * c) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * k * c / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _touched(torch, w, idx, coef, val):
    """Distinct in-range indices that at least one nonzero update lands on."""
    d = w.shape[0]
    u = coef[:, None] * val if coef.dim() == 1 else (val[:, :, None] * coef[:, None, :]).abs().amax(2)
    live = (idx >= 0) & (idx < d) & (u != 0)
    return int(torch.unique(idx[live]).numel())


def phase_sparse_time(torch, sparse):
    """Each SPARSE_TIME_SHAPES case in SPARSE_TIME_TURNS turns: the kernel in
    place and in-place ``index_add_`` (the same work in one PyTorch call,
    given the products u precomputed) as a CUDA graph of 200 calls (events
    around 5 replays: each call's launch and the gap before the next) and as
    device busy time a call (torch.profiler, 100 calls: the launch alone);
    at the stream shapes also the plain version in place, the copying
    kernel (PRs 3-5's form) and ``torch.index_add``. An empty kernel's
    launch, timed the same two ways, is the floor under one launch."""
    import statistics

    def timed(fn):
        return _graph_ms(torch, fn, 200), _device_ms(torch, fn, 100)

    def spread(v):
        return f"{statistics.median(v):.6f} ({min(v):.6f}-{max(v):.6f})"

    floor = {"graph": [], "busy": []}
    for _ in range(SPARSE_TIME_TURNS):
        g, b = timed(sparse.empty_launch)
        floor["graph"].append(g)
        floor["busy"].append(b)
    floor_ms = {key: statistics.median(v) for key, v in floor.items()}
    log(f"sparse-time: empty kernel launch (the floor of one launch), median (min-max) of "
        f"{SPARSE_TIME_TURNS} turns: CUDA graph {spread(floor['graph'])} ms a call; "
        f"device busy {spread(floor['busy'])} ms a call")
    out = {"floor": floor_ms}
    for name, b, k, d, c, draw in SPARSE_TIME_SHAPES:
        w, idx, coef, val = _scatter_inputs(torch, b, k, d, c, draw, seed=7)
        idx[0, 1] = 0  # in range: index_add_ takes no out-of-range index
        entry = sparse.sparse_scatter_add if c == 1 else sparse.sparse_scatter_add_outer
        flat = idx.reshape(-1).long()
        u = (coef[:, None] * val).reshape(-1) if c == 1 else \
            (val[:, :, None] * coef[:, None, :]).reshape(b * k, c)
        w_kernel, w_plain, w_library = w.clone(), w.clone(), w.clone()
        calls = {
            "kernel": lambda: entry(w_kernel, idx, coef, val, inplace=True),
            "index_add_": lambda: w_library.index_add_(0, flat, u),
        }
        if (name, draw) in SPARSE_TIME_FULL:
            calls.update({
                "plain": lambda: sparse.sparse_scatter_add_reference(
                    w_plain, idx, coef, val, inplace=True),
                "copying kernel": lambda: entry(w, idx, coef, val),
                "torch.index_add": lambda: torch.index_add(w, 0, flat, u),
            })
        turns = {key: {"graph": [], "busy": []} for key in calls}
        for _ in range(SPARSE_TIME_TURNS):
            for key, fn in calls.items():
                g, bz = timed(fn)
                turns[key]["graph"].append(g)
                turns[key]["busy"].append(bz)
        med = {key: {m: statistics.median(v) for m, v in t.items()} for key, t in turns.items()}
        touched = _touched(torch, w, idx, coef, val)
        bound, by = scatter_inplace_bound_ms(b, k, c, touched)
        old_bound, _ = scatter_bound_ms(b, k, d, c)
        kg = med["kernel"]["graph"]
        log(f"sparse-time: {name} (B, K, D, C)={(b, k, d, c)} {draw}, ms a call, median "
            f"(min-max) of {SPARSE_TIME_TURNS} turns: " + "; ".join(
                f"{key} graph {spread(t['graph'])} busy {spread(t['busy'])}"
                for key, t in turns.items())
            + f"; in-place bound {bound:.7f} ({by}; {touched} distinct touched rows), copying "
            f"form's bound {old_bound:.6f}; kernel at {bound / kg:.4f} of its bound by the graph, "
            f"{kg / floor_ms['graph']:.3f}x an empty launch (busy "
            f"{med['kernel']['busy'] / floor_ms['busy']:.3f}x); index_add_ / kernel "
            f"{med['index_add_']['graph'] / kg:.3f} (graph), "
            f"{med['index_add_']['busy'] / med['kernel']['busy']:.3f} (busy)")
        out[(name, draw)] = med
        if (name, draw) in SPARSE_TIME_FULL:
            out[name] = {"ms": kg, "plain_ms": med["plain"]["graph"], "bound_ms": bound,
                         "bound_by": by, "library_ms": med["index_add_"]["graph"]}
    for name, b in (("slice", 256), ("experiment", 4096)):
        base = out[(name, "uniform")]["kernel"]
        for draw in ("criteo", "pool64"):
            if (name, draw) in out:
                t = out[(name, draw)]["kernel"]
                log(f"sparse-time: {name} B={b}: the {draw} draw takes {t['graph'] / base['graph']:.3f}x "
                    f"the uniform draw's time (graph), {t['busy'] / base['busy']:.3f}x (busy)")
    return out


def phase_calibrate(torch):
    """The calibration CLI at --smoke on the card, into a temporary table
    (never the committed one): a cuda section with every formulation
    measured, or mxu skipped by its cap."""
    import tempfile

    from omldm_tpu_torch.ops import sparse_calibrate
    from omldm_tpu_torch.ops.sparse import MXU_LANES, SCATTER_IMPLS

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "sparse_dispatch.json"
        sparse_calibrate.main(["--smoke", "--out", str(out)])
        table = json.loads(out.read_text())
    section = table["backends"].get("cuda")
    check(bool(section), "calibrate: no cuda section written")
    grid = [(e["d"], e["batch"], e["nnz"]) for e in section["entries"]]
    check(grid == sparse_calibrate.SMOKE_GRID, f"calibrate: grid {grid}")
    for e in section["entries"]:
        rates = e["rates_updates_per_sec"]
        check(set(rates) == set(SCATTER_IMPLS), f"calibrate: formulations {sorted(rates)}")
        for impl, rate in rates.items():
            capped = impl == "mxu" and 2 * 2 * e["updates"] * (
                -(-e["d"] // MXU_LANES) + MXU_LANES) > sparse_calibrate.MXU_BYTES_CAP
            check((rate is None) == capped and (rate is None or rate > 0),
                  f"calibrate: {impl} at {e['d']}: {rate}")
    log(f"calibrate: cuda section of {len(section['entries'])} entries on {section['note']}: "
        + "; ".join(f"d={e['d']} -> {e['winner']}" for e in section["entries"]))


def criteo_events(n_records: int, seed: int, query_at: int | None, create: dict | None = None,
                  scatter_impl: str | None = None):
    """Create + n_records Criteo-shaped records, every tenth a forecast, an
    optional Query after record ``query_at``. A record: 13 numerics rounded
    to 6 places, 26 categoricals f{j}_v{0..999}, a target from a planted
    linear rule on the numerics (the generator of the JAX package's sparse
    stream benchmark, benchmarks/run_benchmarks.py). ``scatter_impl`` pins
    the Create's scatter formulation (dataStructure.scatterImpl)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    w = rng.randn(13)
    x = np.round(rng.randn(n_records, 13), 6)
    y = (x @ w > 0).astype(np.float64)
    cats = rng.randint(0, 1000, size=(n_records, 26))
    create = create or {
        "id": 0, "request": "Create",
        "learner": {"name": "PA", "hyperParameters": {"C": 0.1, "variant": "PA-II"},
                    "dataStructure": {"sparse": True, "nFeatures": CRITEO_DIM,
                                      "hashSpace": CRITEO_HASH, "maxNnz": CRITEO_NNZ}},
        "trainingConfiguration": {"protocol": "Asynchronous"},
    }
    if scatter_impl is not None:
        create["learner"]["dataStructure"]["scatterImpl"] = scatter_impl
    events = [("requests", json.dumps(create))]
    for i in range(n_records):
        rec = {"numericalFeatures": x[i].tolist(),
               "categoricalFeatures": [f"f{j}_v{v}" for j, v in enumerate(cats[i])]}
        if i % 10 == 9:
            events.append(("forecastingData", json.dumps(rec)))
        else:
            rec["target"] = float(y[i])
            events.append(("trainingData", json.dumps(rec)))
        if query_at is not None and i == query_at:
            events.append(("requests", json.dumps({"id": 0, "request": "Query", "requestId": 1})))
    return events


def avazu_events(n_records: int, seed: int):
    """Create (sparse Softmax, nClasses 2) + n_records records of 21 hashed
    categorical slots (a vocabulary of 1000 a slot), every tenth a
    forecast; the target is a planted rule: the sign of a sum of one hidden
    weight per (slot, value)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    hidden = rng.randn(AVAZU_SLOTS, 1000)
    cats = rng.randint(0, 1000, size=(n_records, AVAZU_SLOTS))
    y = (hidden[np.arange(AVAZU_SLOTS), cats].sum(axis=1) > 0).astype(np.float64)
    create = {
        "id": 0, "request": "Create",
        "learner": {"name": "Softmax", "hyperParameters": {"learningRate": 0.05, "nClasses": 2},
                    "dataStructure": {"sparse": True, "nFeatures": AVAZU_DIM,
                                      "hashSpace": AVAZU_DIM, "maxNnz": AVAZU_SLOTS}},
        "trainingConfiguration": {"protocol": "Asynchronous"},
    }
    events = [("requests", json.dumps(create))]
    for i in range(n_records):
        rec = {"categoricalFeatures": [f"c{j}_v{v}" for j, v in enumerate(cats[i])]}
        if i % 10 == 9:
            events.append(("forecastingData", json.dumps(rec)))
        else:
            rec["target"] = float(y[i])
            events.append(("trainingData", json.dumps(rec)))
    return events


def _run_sparse_stream(torch, sparse, events, entry, width, label):
    """One sparse stream on cuda with the kernel counts set to 0 just
    before; checks that ``entry`` launched once per fit and nothing else
    launched; returns (launches, stats, wall seconds)."""
    n_fore = sum(1 for s, _ in events if s == "forecastingData")
    n_query = sum(1 for s, p in events if s == "requests" and '"Query"' in p)
    for name in sparse.launches:
        sparse.launches[name] = 0
    job, report, wall = _run_slice(torch, events)
    launches = dict(sparse.launches)
    check(report is not None, f"{label}: the job emitted no JobStatistics")
    check(not job.dead_letter.entries, f"{label}: quarantined {list(job.dead_letter.entries)[:1]}")
    [stats] = report.statistics
    fits = len(stats.learning_curve)
    evaluations = (1 + n_query) * job.config.parallelism
    fits_by_launches = stats.program_launches - stats.forecasts_served - evaluations
    fit_s = sum(s.step_timer.total_ms for s in job.spokes) / 1e3
    serve_s = sum(s.serve_timer.total_ms for s in job.spokes) / 1e3
    log(f"{label}: " + json.dumps({
        "records": len(events), "wall_s": wall, "records_per_s": len(events) / wall,
        "fit_flush_s": fit_s, "serve_s": serve_s, "fits": fits, "launches": launches,
        "fitted": stats.fitted, "score": stats.score,
        "serveLatencyP50Ms": stats.serve_latency_p50_ms,
        "serveLatencyP99Ms": stats.serve_latency_p99_ms, "forecasts": n_fore,
    }))
    check(launches[entry] > 0, f"{label}: {entry} was never launched")
    check(launches[entry] == fits == fits_by_launches,
          f"{label}: {entry} launches {launches[entry]} != fits {fits} "
          f"(programLaunches accounting: {fits_by_launches})")
    check(all(n == 0 for name, n in launches.items() if name != entry),
          f"{label}: another entry point launched: {launches}")
    for pipe in _pipelines(job):
        for t in pipe.state["params"].values():
            check(t.device.type == job.device.type and bool(torch.isfinite(t).all()),
                  f"{label}: a parameter is not finite or not on {job.device}")
        check(pipe.state["params"][next(iter(pipe.state["params"]))].shape[0] == width + 1,
              f"{label}: the model is not {width} + 1 rows wide")
    check(len(job.predictions) == n_fore == stats.forecasts_served,
          f"{label}: {len(job.predictions)} predictions for {n_fore} forecasting records")
    check(all(p.value in (-1.0, 1.0) for p in job.predictions), f"{label}: a prediction is not a sign")
    return launches[entry], job, stats, wall


def stream_scatter_impl(sparse) -> str | None:
    """The formulation the calibration table picks on the card at the
    sparse stream's (D, updates) -- w[13 + 2^18 + 1], a batch of 256 x (40 +
    the bias slot) -- logged; None when it launches scatter_add (scatter, or
    segsum's final scatter), else "scatter", pinned so that the stream's
    launch count reads the kernel."""
    d, updates = CRITEO_DIM + 1, SLICE_CONFIG["batch_size"] * (CRITEO_NNZ + 1)
    pick = sparse._resolve_impl(d, updates, None, "cuda")
    pin = None if pick in ("scatter", "segsum") else "scatter"
    log(f"sparse: the table picks {pick!r} at (D, updates)=({d}, {updates}) on the card"
        + ("" if pin is None else f"; it launches no scatter_add, so the Create pins "
           f"scatterImpl {pin!r} for the launch count"))
    return pin


def phase_sparse(torch, sparse, events):
    launches, job, stats, wall = _run_sparse_stream(
        torch, sparse, events, "scatter_add", CRITEO_DIM, "sparse")
    check(len(job.responses) == 1, f"sparse: {len(job.responses)} query responses, expected 1")
    values = job.responses[0].learner["parameters"]["values"]
    check(len(values) == CRITEO_DIM + 1, f"sparse: query returned {len(values)} parameters")
    check(stats.score > 0.6, f"sparse: final holdout accuracy {stats.score} is not above chance")
    log(f"sparse: {wall:.2f} s wall, {len(events) / wall:.0f} records/s, scatter_add launches "
        f"{launches} (one a fit), score {stats.score:.4f}, serveLatencyP50Ms "
        f"{stats.serve_latency_p50_ms:.4f}, serveLatencyP99Ms {stats.serve_latency_p99_ms:.4f}")
    return launches, wall


def phase_avazu(torch, sparse, events):
    launches, _, stats, wall = _run_sparse_stream(
        torch, sparse, events, "scatter_add_outer", AVAZU_DIM, "avazu")
    log(f"avazu: {wall:.2f} s wall, {len(events) / wall:.0f} records/s, scatter_add_outer "
        f"launches {launches} (one a fit), score {stats.score:.4f}")
    return launches


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
    from omldm_tpu_torch.ops import attention, pa_scan, sparse

    t_start = time.perf_counter()
    lap("start-up")
    phase_setup(torch)
    phase_build(pa_scan, attention, sparse)
    lap("build")
    max_err = phase_check(torch, pa_scan)
    times = phase_time(torch, pa_scan)
    lap("pa_scan check and time")
    t0 = time.perf_counter()
    events = make_events(args.records, args.seed, query_at=args.records // 2)
    log(f"slice: generated {len(events)} events ({args.records} training) "
        f"in {time.perf_counter() - t0:.2f} s")
    launches, wall = phase_slice(torch, pa_scan, events)
    phase_parity(events[: args.parity_records + 1])
    lap("slice stream and parity")
    flash_err = phase_flash_check(torch, attention)
    lap("flash check")
    flash_times = phase_flash_time(torch, attention)
    lap("flash time")
    flash_launches, trainer = phase_lm(torch, attention, args.lm_steps, args.seed)
    phase_lm_parity(torch, args.seed)
    lap("lm and lm-parity")
    scatter_err = phase_sparse_check(torch, sparse)
    scatter_times = phase_sparse_time(torch, sparse)
    lap("sparse check and time")
    phase_calibrate(torch)
    lap("calibrate")
    t0 = time.perf_counter()
    sparse_events = criteo_events(SPARSE_RECORDS, args.seed, query_at=SPARSE_RECORDS // 2,
                                  scatter_impl=stream_scatter_impl(sparse))
    log(f"sparse: generated {len(sparse_events)} events in {time.perf_counter() - t0:.2f} s")
    scatter_launches, sparse_wall = phase_sparse(torch, sparse, sparse_events)
    phase_parity(sparse_events[: args.parity_records + 1])
    outer_launches = phase_avazu(torch, sparse, avazu_events(AVAZU_RECORDS, args.seed))
    lap("sparse stream, parity and avazu")
    if args.profile is not None:
        for name, stream_events, unprofiled in (("slice", events, wall),
                                                ("sparse", sparse_events, sparse_wall)):
            busy_s = phase_profile(torch, stream_events, args.profile, name)
            log(f"profile[{name}]: device busy {busy_s:.4f} s against the unprofiled "
                f"stream's {unprofiled:.3f} s wall: idle share {1.0 - busy_s / unprofiled:.4f}")
        phase_lm_profile(torch, attention, trainer, args.profile, args.seed)
        lap("profiles")
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
    for name, launched, shape in (("scatter_add", scatter_launches, "slice"),
                                  ("scatter_add_outer", outer_launches, "avazu")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "omldm_tpu_torch/csrc/scatter_add.cu",
            "replaces": "benchmarks/sparse_scatter_experiment.py:149",
            "launches": launched,
            "max_abs_err": scatter_err,
            **scatter_times[shape],
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
