"""Calibration of the sparse scatter dispatch: the table and its measurement.

Counterpart of ``omldm_tpu/ops/sparse_calibrate.py``.
``sparse_scatter_add_auto`` (ops/sparse.py) has three formulations of the
same w[idx] += coef*val update, with different cost models:

- ``scatter``: the CUDA kernel on the card (``csrc/scatter_add.cu``),
  ``index_add_`` on the CPU;
- ``mxu``: the kron-factored one-hot product, which trades ~2*2*D
  operations an update for the serialisation of duplicate indices;
- ``segsum``: a sort and a segmented pre-combine of duplicate indices, then
  one scatter of a total per distinct index.

:func:`lookup_winner` gives the fastest at the nearest measured (D,
updates) grid point of the active backend, the tensor's device type
(``cpu`` or ``cuda``). The port reads its own table, ``sparse_dispatch.json``
beside this file (or the file that ``OMLDM_SPARSE_SCATTER_TABLE`` names):
its ``cpu`` section is the JAX package's measured CPU section, its ``cuda``
section was measured on an H100 by this module. Re-run on new hardware:

    python -m omldm_tpu_torch.ops.sparse_calibrate            # full grid, on the card
    python -m omldm_tpu_torch.ops.sparse_calibrate --smoke    # a small grid
    python -m omldm_tpu_torch.ops.sparse_calibrate --device cpu

Each formulation is timed as ``steps`` in-place applications into one w: on
the card captured in one CUDA graph and replayed (the counterpart of the JAX
package's one jitted scan with w donated), on the CPU as a loop; the best
of 3 gives updates per second. A write merges per backend, so a ``cuda``
calibration leaves the ``cpu`` section as it was.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

DEFAULT_TABLE = os.path.join(os.path.dirname(__file__), "sparse_dispatch.json")
ENV_TABLE = "OMLDM_SPARSE_SCATTER_TABLE"

# skip the mxu formulation where its one-hot operands ([2n, D/512 + 512]
# bf16) would exceed this many bytes, as the JAX package skips it
MXU_BYTES_CAP = 1 << 28


def table_path() -> str:
    return os.environ.get(ENV_TABLE, "").strip() or DEFAULT_TABLE


_cache: Dict[str, object] = {"path": None, "mtime": None, "table": None}


def load_table(path: Optional[str] = None) -> Optional[dict]:
    """Cached table read (mtime-invalidated; None when absent/corrupt)."""
    path = path or table_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    if _cache["path"] == path and _cache["mtime"] == mtime:
        return _cache["table"]  # type: ignore[return-value]
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(table, dict) or "backends" not in table:
        return None
    _cache.update(path=path, mtime=mtime, table=table)
    return table


def lookup_winner(backend: str, d: int, n_updates: int) -> Optional[str]:
    """Winner at the nearest measured (D, updates) grid point for this
    backend -- log2-space nearest neighbour, since both axes are decade
    scales. None when the backend has no measured section."""
    table = load_table()
    if table is None:
        return None
    section = table.get("backends", {}).get(str(backend))
    if not section:
        return None
    best, best_dist = None, None
    ld, ln = math.log2(max(d, 1)), math.log2(max(n_updates, 1))
    for e in section.get("entries") or []:
        try:
            dist = abs(math.log2(max(int(e["d"]), 1)) - ld) + abs(
                math.log2(max(int(e["updates"]), 1)) - ln
            )
            winner = str(e["winner"])
        except (KeyError, TypeError, ValueError):
            continue
        if best_dist is None or dist < best_dist:
            best, best_dist = winner, dist
    return best


# --- measurement -------------------------------------------------------------


def _gen_updates(d: int, batch: int, nnz: int, seed: int = 0):
    """Hashed-categorical update profile: each COO slot draws from its own
    ~1k-value vocabulary inside [0, d) -- the duplicate structure of the
    Criteo/Avazu streams, which the segsum pre-combine exists to exploit.
    The JAX package's generator, draw for draw."""
    rng = np.random.RandomState(seed)
    vocab_n = min(1000, max(d // nnz, 2))
    idx = np.empty((batch, nnz), np.int32)
    for k in range(nnz):
        vocab = rng.randint(0, d, size=vocab_n)
        idx[:, k] = vocab[rng.randint(0, vocab_n, size=batch)]
    val = rng.randn(batch, nnz).astype(np.float32)
    coef = rng.randn(batch).astype(np.float32)
    return idx, val, coef


def _measure_kernel(fn, d: int, idx, val, coef, steps: int, device: torch.device,
                    repeats: int = 3) -> float:
    """Updates/sec for one formulation: ``steps`` in-place applications into
    one w, best of ``repeats``. On the card the steps are one CUDA graph (no
    host work between them) timed by events around a replay; on the CPU a
    loop timed by the host clock."""
    w = torch.zeros((d,), dtype=torch.float32, device=device)
    ii, vv, cc = (torch.from_numpy(a).to(device) for a in (idx, val, coef))

    def chain():
        for _ in range(steps):
            fn(w, ii, cc, vv, inplace=True)

    best = float("inf")
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            chain()  # warm-up (builds the kernel, fills the allocator) before capture
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chain()
        graph.replay()
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        del graph
    else:
        chain()
        for _ in range(repeats):
            t0 = time.perf_counter()
            chain()
            best = min(best, time.perf_counter() - t0)
    return steps * idx.size / best


def measure_entry(d: int, batch: int, nnz: int, steps: int, device="cuda") -> dict:
    """One grid point: every formulation's rate (None where the mxu cap
    skips it), the winner and the duplicate factor of the draw."""
    from omldm_tpu_torch.ops.sparse import MXU_LANES, SCATTER_IMPLS

    device = torch.device(device)
    idx, val, coef = _gen_updates(d, batch, nnz)
    n = idx.size
    rates: Dict[str, Optional[float]] = {}
    for name, fn in SCATTER_IMPLS.items():
        if name == "mxu":
            r = -(-d // MXU_LANES)
            est = 2 * (2 * n) * (r + MXU_LANES)  # bf16 one-hot operands
            if est > MXU_BYTES_CAP:
                rates[name] = None
                continue
        rates[name] = round(_measure_kernel(fn, d, idx, val, coef, steps, device), 1)
    measured = {k: v for k, v in rates.items() if v is not None}
    winner = max(measured, key=measured.get)  # type: ignore[arg-type]
    dup = n / max(len(np.unique(idx)), 1)
    return {
        "d": d,
        "batch": batch,
        "nnz": nnz,
        "updates": n,
        "duplicate_factor": round(dup, 2),
        "rates_updates_per_sec": rates,
        "winner": winner,
    }


FULL_GRID = [
    (d, batch, nnz)
    for d in (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20)
    for batch in (1024, 4096)
    for nnz in (8, 40)
]
# a few seconds: both sides of the JAX package's guessed 2^16 crossover
SMOKE_GRID = [(1 << 12, 256, 8), (1 << 16, 256, 8), (1 << 18, 256, 8)]


def device_note(device: torch.device) -> str:
    """What the section was measured on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, or the CPU."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    index = device.index if device.index is not None else torch.cuda.current_device()
    return smi.stdout.strip().splitlines()[index]


def calibrate(grid: List[tuple], steps: int, out: Optional[str] = None,
              tag: str = "", device="cuda") -> dict:
    """Measure the grid on ``device`` and merge its section (named by the
    device type) into the table at ``out``; other backends' sections are
    preserved."""
    device = torch.device(device)
    backend = device.type
    entries = []
    for d, batch, nnz in grid:
        e = measure_entry(d, batch, nnz, steps, device)
        entries.append(e)
        print(
            f"  d=2^{int(math.log2(d))} batch={batch} nnz={nnz} "
            f"dup={e['duplicate_factor']}x -> {e['winner']} "
            f"{e['rates_updates_per_sec']}", flush=True,
        )
    out = out or table_path()
    table = load_table(out) or {
        "version": 1,
        "note": (
            "sparse scatter dispatch table of omldm_tpu_torch, written by "
            "python -m omldm_tpu_torch.ops.sparse_calibrate; "
            "sparse_scatter_add_auto (ops/sparse.py) reads the nearest "
            "(d, updates) entry for the weight tensor's device type"
        ),
        "backends": {},
    }
    table["backends"][backend] = {
        "generated_by": (
            f"python -m omldm_tpu_torch.ops.sparse_calibrate {tag}".strip()
        ),
        "note": device_note(device),
        "steps_per_sample": steps,
        "entries": entries,
    }
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, out)
    _cache["path"] = None  # force a reload on the next lookup
    print(f"wrote {backend} section ({len(entries)} entries) -> {out}", flush=True)
    return table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a small grid: seconds, exercises the table format")
    ap.add_argument("--out", default=None, help="table path (default: "
                    "$OMLDM_SPARSE_SCATTER_TABLE or ops/sparse_dispatch.json)")
    ap.add_argument("--steps", type=int, default=None,
                    help="chained in-place applications per timing sample")
    ap.add_argument("--device", default="cuda",
                    help="device to measure (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sparse_calibrate: no CUDA card; pass --device cpu to "
                         "calibrate the CPU")
    grid = SMOKE_GRID if args.smoke else FULL_GRID
    steps = args.steps or (4 if args.smoke else 16)
    calibrate(grid, steps, out=args.out, tag="--smoke" if args.smoke else "",
              device=args.device)


if __name__ == "__main__":
    main()
