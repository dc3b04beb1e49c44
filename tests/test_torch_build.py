"""The port's kernel builder (omldm_tpu_torch.ops._build) and what the flash
attention source dispatches, checked on the CPU without nvcc.

- A library's cache name hashes its source, every shared header of
  ``csrc/`` and the nvcc flags, so a changed header or flag never reuses a
  stale library.
- ``run_dtype`` in ``csrc/flash_attention.cu`` dispatches every (dtype,
  head width) pair of ``KERNEL_DESIGNS`` (widths 1..512), pass by pass, to
  the design ``pass_design`` names at ``kernel_width`` (past 256 the
  cluster design's forward, dQ and dK/dV), takes the Hopper
  design only where the views fit its tensor maps (as ``kernel_design``
  does), the Hopper dispatch launches a Hopper kernel for
  each of the three passes, and the source's sm90 tile sizes are the ones
  ``sm90_tile_plan`` models; ``wide_fwd_plan`` and ``wide_bwd_plan``
  restate the cluster design's constants, shared memory and split of the
  width.
"""

import re
import shutil

import pytest
import torch

from omldm_tpu_torch.ops import _build
from omldm_tpu_torch.ops import attention as tatt


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ in a tmp directory; nvcc must not be reached."""
    def no_nvcc():
        raise AssertionError("the cache name must not need nvcc")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def _library(csrc, source="flash_attention.cu"):
    return _build.KernelLibrary(str(csrc / source), lambda lib: None)


def test_target_depends_on_content_not_location(csrc_copy):
    assert _library(csrc_copy)._target() == _build.KernelLibrary(
        "flash_attention.cu", lambda lib: None)._target()
    assert _library(csrc_copy)._target().parent == _build.BUILD_DIR


@pytest.mark.parametrize("source", ["flash_attention.cu", "pa_scan.cu", "scatter_add.cu"])
def test_changed_header_changes_target(csrc_copy, source):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "csrc/ has no shared header"
    before = _library(csrc_copy, source)._target()
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// one more line\n")
    after = _library(csrc_copy, source)._target()
    assert after != before and after.name.startswith(f"lib{source[:-3]}-")


def test_new_header_changes_target(csrc_copy):
    before = _library(csrc_copy)._target()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _library(csrc_copy)._target() != before


def test_changed_source_and_flags_change_target(csrc_copy, monkeypatch):
    base = _library(csrc_copy)._target()
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _library(csrc_copy)._target() != base
    monkeypatch.undo()
    assert _library(csrc_copy)._target() == base
    src = csrc_copy / "flash_attention.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _library(csrc_copy)._target() != base


def test_stop_ends_an_unfinished_build(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 60\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.KernelLibrary("pa_scan.cu", lambda lib: None)
    lib.stop()  # nothing started: a no-op
    lib.start()
    proc = lib._proc
    assert proc is not None and proc.poll() is None
    lib.stop()
    assert proc.returncode is not None and lib._proc is None
    assert not any((tmp_path / "build").glob("*.tmp.so"))
    lib.stop()


def _run_dtype_table(top=512):
    """{(dtype code, head width): {pass: (design, built width)}} for every
    width 1..top and each pass ("fwd", "dq", "dkdv"), read from run_dtype's
    `if (dh <= W) return ...` lines (every pass): the mma.sync instance at
    W, or the Hopper one where `dh % 8 == 0 && tma ?` picks it (for views
    that fit its tensor maps); then, for every wider width, its closing
    `return run_cluster<...>` line (all three passes)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    body = src[src.index("int run_dtype("):]
    body = body[:body.index("\n}\n")]
    assert "const bool tma = tma_fits(p);" in body
    table = {}
    for code, block in re.findall(r"dtype == (\d)\) \{(.*?)\n  \}", body, re.S):
        lo = 1
        for width, line in re.findall(r"if \(dh <= (\d+)\) return (.*?);\n", block + "\n"):
            width = int(width)
            assert f"<{width}>" in line or f", {width}>" in line, line
            for dh in range(lo, width + 1):
                sm90 = "dh % 8 == 0 && tma ? run_sm90<" in line and dh % 8 == 0
                design = ("sm90" if sm90 else "mma", width)
                table[(int(code), dh)] = {w: design for w in ("fwd", "dq", "dkdv")}
            lo = width + 1
        t = "bf16" if code == "1" else "float"
        rest = block[block.rindex("if (dh <= "):].split("\n", 1)[1]
        assert [line.strip() for line in rest.strip().splitlines()] == [
            f"return run_cluster<{t}>(which, p, BH, stream);"], rest
        for dh in range(lo, top + 1):
            table[(int(code), dh)] = {w: ("cluster", tatt.WIDE) for w in ("fwd", "dq", "dkdv")}
    return table


def test_dispatch_matches_kernel_head_dims_and_designs():
    table = _run_dtype_table()
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert set(table) == {(codes[dt], dh) for dt, dh in tatt.KERNEL_DESIGNS}
    for (dt, dh), design in tatt.KERNEL_DESIGNS.items():
        for which in ("fwd", "dq", "dkdv"):
            assert table[(codes[dt], dh)][which] == (
                tatt.pass_design(which, dt, dh), tatt.kernel_width(dh)), (dt, dh, which)
        assert table[(codes[dt], dh)]["fwd"][0] == design
    # the Hopper design is bf16 only, at the widths padded to 64 and 128
    # whose rows are whole 16-byte groups; float32 keeps its exact emulation
    assert {k for k, v in tatt.KERNEL_DESIGNS.items() if v == "sm90"} == {
        (torch.bfloat16, dh) for dh in range(40, 129, 8)}
    # past 256 every pass runs the cluster design, in both dtypes
    for which in ("fwd", "dq", "dkdv"):
        assert {(dt, dh) for dt, dh in tatt.KERNEL_DESIGNS
                if tatt.pass_design(which, dt, dh) == "cluster"} == {
            (dt, dh) for dt in (torch.bfloat16, torch.float32) for dh in range(257, 513)}


def _cluster_source():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    consts = {name: int(val) for name, val in
              re.findall(r"constexpr int (kSlice|kClusterMax|kClRows|kClThreads) = (\d+);", src)}
    tiles = dict(re.findall(r"struct ClTile<(bf16|float)> \{ static constexpr int value = (\d+); \}", src))
    return src, consts, {k: int(v) for k, v in tiles.items()}


def test_wide_bwd_plan_is_the_source_constants():
    """wide_bwd_plan restates the cluster design's constants, its shared
    memory layout and run_cluster's split of the width."""
    src, consts, tiles = _cluster_source()
    assert consts == {"kSlice": tatt.CLUSTER_SLICE, "kClusterMax": tatt.CLUSTER_MAX,
                      "kClRows": tatt.CLUSTER_ROWS, "kClThreads": tatt.CLUSTER_THREADS}
    assert tiles == {"bf16": tatt.CLUSTER_TILE[torch.bfloat16],
                     "float": tatt.CLUSTER_TILE[torch.float32]}
    layout = src[src.index("struct ClLayout {"):]
    layout = layout[:layout.index("\n};\n")]
    for line in ("LD = kSlice + 16 / sizeof(T);", "LDF = N + 4;", "LDP = N + 16 / sizeof(T);",
                 "kFixed = (size_t)kClRows * LD * sizeof(T);",
                 "kStream = (size_t)N * LD * sizeof(T);",
                 "kPartial = (size_t)kClRows * LDF * 4;",
                 "kOperand = (size_t)kClRows * LDP * sizeof(T);",
                 "kRows = 2 * 2 * kClRows * 4;",
                 "return 2 * kFixed + 4 * kStream + 2 * kPartial + (kv ? 2 : 1) * kOperand + kRows;"):
        assert line in layout, line
    run = src[src.index("int run_cluster("):]
    run = run[:run.index("\n}\n")]
    for line in ("const int n = (p.dh + kSlice - 1) / kSlice;",
                 "p.per_cta = (n + kClusterMax - 1) / kClusterMax;",
                 "const int cluster = (n + p.per_cta - 1) / p.per_cta;",
                 "attr[0].val.clusterDim.z = cluster;",
                 "cfg.gridDim = dim3(BH, tiles, cluster);",
                 "cfg.blockDim = dim3(kClThreads);",
                 "cfg.dynamicSmemBytes = which == 0 ? ClFwdLayout<T>::bytes() : "
                 "ClLayout<T>::bytes(which == 2);"):
        assert line in run, line
    # no CTA asks for more than the portable cluster: no non-portable attribute
    assert "NonPortableClusterSizeAllowed" not in src
    assert tatt.wide_bwd_plan(torch.bfloat16, 512)["smem"] == {"dq": 149_504, "dkdv": 158_720}
    assert tatt.wide_bwd_plan(torch.float32, 512)["smem"] == {"dq": 163_840, "dkdv": 173_056}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_bwd_plan_covers_every_width_once(dtype):
    """Every width 257..2048: the slices cover [0, dh) exactly once, each
    CTA's shared memory fits the card, the cluster is within the portable
    limit, and a CTA owns more than one slice only past the cluster's
    reach (8 slices of 128: dh 1024)."""
    for dh in range(257, 2049):
        plan = tatt.wide_bwd_plan(dtype, dh)
        spans = [span for cta in plan["columns"] for span in cta]
        assert spans[0][0] == 0 and spans[-1][1] == dh, dh
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:])), dh
        assert len(plan["columns"]) == plan["cluster"] <= tatt.CLUSTER_MAX
        assert all(1 <= len(cta) <= plan["per_cta"] for cta in plan["columns"])
        assert len(spans) == plan["slices"] == -(-dh // tatt.CLUSTER_SLICE)
        assert (plan["per_cta"] > 1) == (dh > tatt.CLUSTER_SLICE * tatt.CLUSTER_MAX)
        assert max(plan["smem"].values()) <= tatt.SMEM_LIMIT
    with pytest.raises(ValueError, match="not past"):
        tatt.wide_bwd_plan(dtype, 256)


def test_wide_fwd_plan_is_the_source_constants():
    """wide_fwd_plan restates the cluster forward's key tiles, its
    accumulators a sweep by dtype, its shared memory layout and run_cluster's
    forward branch: the same split of the width and grid as the backward,
    the cluster on grid z, ClFwdLayout's bytes, flash_fwd_cluster_kernel."""
    src, consts, _ = _cluster_source()
    tiles = dict(re.findall(r"struct ClFwdTile<(bf16|float)> \{ static constexpr int value = (\d+); \}", src))
    assert {k: int(v) for k, v in tiles.items()} == {
        "bf16": tatt.CLUSTER_FWD_TILE[torch.bfloat16], "float": tatt.CLUSTER_FWD_TILE[torch.float32]}
    acc = dict(re.findall(r"struct ClFwdAcc<(bf16|float)> \{ static constexpr int value = (\d+); \}", src))
    assert {k: int(v) for k, v in acc.items()} == {
        "bf16": tatt.CLUSTER_FWD_ACC[torch.bfloat16], "float": tatt.CLUSTER_FWD_ACC[torch.float32]}
    layout = src[src.index("struct ClFwdLayout {"):]
    layout = layout[:layout.index("\n};\n")]
    for line in ("N = ClFwdTile<T>::value;", "LD = ClLayout<T>::LD;", "LDF = N + 4;",
                 "LDP = N + 16 / sizeof(T);",
                 "kFixed = (size_t)kClRows * LD * sizeof(T);",
                 "kStream = (size_t)N * LD * sizeof(T);",
                 "kPartial = (size_t)kClRows * LDF * 4;",
                 "kOperand = (size_t)kClRows * LDP * sizeof(T);",
                 "kRows = 3 * kClRows * 4;",
                 "return kFixed + 4 * kStream + kPartial + kOperand + kRows;"):
        assert line in layout, line
    run = src[src.index("int run_cluster("):]
    run = run[:run.index("\n}\n")]
    for line in ("if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;",
                 "const int tiles = ((which == 2 ? p.Lk : p.Lq) + kClRows - 1) / kClRows;",
                 "attr[0].val.clusterDim.z = cluster;",
                 "cfg.gridDim = dim3(BH, tiles, cluster);",
                 "cfg.dynamicSmemBytes = which == 0 ? ClFwdLayout<T>::bytes() : "
                 "ClLayout<T>::bytes(which == 2);",
                 "return p.per_cta > 1 ? launch_cluster(flash_fwd_cluster_kernel<T, true>, cfg, p)",
                 ": launch_cluster(flash_fwd_cluster_kernel<T, false>, cfg, p);"):
        assert line in run, line
    # the forward's sweep bounds are the cluster's query tile's, as in dQ
    kernel = src[src.index("flash_fwd_cluster_kernel(const Params p) {"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "const int n_k = k_tiles_needed(p, q0, R, N);" in kernel
    assert kernel.rstrip().endswith("cluster.sync();  // no CTA leaves while a peer may still read its shared memory")
    assert tatt.wide_fwd_plan(torch.bfloat16, 512)["smem"] == 208_640
    assert tatt.wide_fwd_plan(torch.float32, 512)["smem"] == 204_544
    for dt in (torch.bfloat16, torch.float32):
        fwd, bwd = tatt.wide_fwd_plan(dt, 1100), tatt.wide_bwd_plan(dt, 1100)
        assert {k: fwd[k] for k in ("slice", "slices", "per_cta", "cluster", "columns")} == \
            {k: bwd[k] for k in ("slice", "slices", "per_cta", "cluster", "columns")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_fwd_plan_covers_every_width_once(dtype):
    """Every width 257..2048: the slices cover [0, dh) exactly once, the
    rows of the 64-row tile are shared out whole and exactly once, each
    CTA's shared memory fits the card, the cluster is within the portable
    limit, and a CTA sweeps once for each CLUSTER_FWD_ACC of its slices
    (bf16: once up to 2048, S computed once a tile; float32: once a
    slice, twice past 1024)."""
    for dh in range(257, 2049):
        plan = tatt.wide_fwd_plan(dtype, dh)
        spans = [span for cta in plan["columns"] for span in cta]
        assert spans[0][0] == 0 and spans[-1][1] == dh, dh
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:])), dh
        assert len(plan["columns"]) == plan["cluster"] <= tatt.CLUSTER_MAX
        assert len(spans) == plan["slices"] == -(-dh // tatt.CLUSTER_SLICE)
        assert plan["sweeps"] == -(-plan["per_cta"] // tatt.CLUSTER_FWD_ACC[dtype])
        assert plan["sweeps"] == (1 if dtype == torch.bfloat16 or dh <= 1024 else 2)
        rows = plan["rows"]
        assert len(rows) == plan["cluster"] and rows[0][0] == 0
        assert rows[-1][1] == tatt.CLUSTER_ROWS
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(rows, rows[1:])), dh
        assert plan["smem"] <= tatt.SMEM_LIMIT
        assert 0 < plan["exchange"] < plan["smem"]
    assert tatt.wide_fwd_plan(dtype, 2049)["sweeps"] == (2 if dtype == torch.bfloat16 else 3)
    with pytest.raises(ValueError, match="not past"):
        tatt.wide_fwd_plan(dtype, 256)


def test_wide_backward_is_the_cluster_design_only():
    """The loop design is gone in all three passes (its kernels, run_wide
    and what only they used); the three cluster kernels run past 256, one
    CTA of kClThreads an SM, launched with the cluster dimension after the
    occupancy query."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for gone in ("flash_dq_wide_kernel", "flash_dkdv_wide_kernel", "flash_fwd_wide_kernel",
                 "run_wide", "WideChunk", "load_chunk", "gemm_abt_add"):
        assert gone not in src, gone
    for kernel in ("flash_fwd_cluster_kernel", "flash_dq_cluster_kernel", "flash_dkdv_cluster_kernel"):
        assert f"__global__ void __launch_bounds__(kClThreads, 1) {kernel}" in src
    assert "cudaLaunchKernelEx" in src and "cudaOccupancyMaxActiveClusters" in src


def test_sm90_launches_all_three_kernels_and_never_falls_back():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    body = src[src.index("int run_sm90("):]
    body = body[:body.index("\n}\n")]
    # which == 1 (dQ) launches the Hopper dQ kernel, as 0 and 2 launch theirs
    dq = body[body.index("if (which == 1) {"):]
    dq = dq[:dq.index("\n  }\n")]
    assert "launch(flash_dq_sm90_kernel<DH>" in dq
    for kernel in ("flash_fwd_sm90_kernel<DH>", "flash_dq_sm90_kernel<DH>", "flash_dkdv_sm90_kernel<DH>"):
        assert kernel in body
    # no mma.sync kernel is reachable from the Hopper dispatch
    for kernel in ("flash_fwd_kernel<", "flash_dq_kernel<", "flash_dkdv_kernel<", "run_mma<", "run_dq<"):
        assert kernel not in body, kernel


def test_source_tiles_match_the_plan():
    src = (_build.CSRC / "flash_attention.cu").read_text()
    consts = {name: int(val) for name, val in re.findall(r"\b(k(?:Fwd|Bwd|Dq)[MN]) = (\d+)", src)}
    assert (consts["kFwdM"], consts["kFwdN"]) == tatt.SM90_FWD_TILE
    assert (consts["kDqM"], consts["kDqN"]) == tatt.SM90_DQ_TILE
    assert (consts["kBwdN"], consts["kBwdM"]) == tatt.SM90_DKDV_TILE


def test_tma_fits_mirrors_kernel_design():
    """run_dtype's tma_fits asks what kernel_design asks of the views: the
    rows of 16 bytes (p.vec, from rows_of_16) and byte strides below 2^40."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    body = src[src.index("bool tma_fits("):]
    body = body[:body.index("\n}\n")]
    assert "s * 2 >= (1LL << 40)" in body and "return p.vec != 0;" in body
    vec = src[src.index("p.vec = rows_of_16("):]
    vec = vec[:vec.index(";")]
    assert vec.count("rows_of_16(") == 4  # q, k, v and dout
