"""The port's kernel builder (omldm_tpu_torch.ops._build) and what the flash
attention source dispatches, checked on the CPU without nvcc.

- A library's cache name hashes its source, every shared header of
  ``csrc/`` and the nvcc flags, so a changed header or flag never reuses a
  stale library.
- ``run_dtype`` in ``csrc/flash_attention.cu`` dispatches every (dtype,
  head width) pair of ``KERNEL_DESIGNS`` (widths 1..512) to the design it
  names at ``kernel_width`` (the wide instance past 256), takes the Hopper
  design only where the views fit its tensor maps (as ``kernel_design``
  does), the Hopper dispatch launches a Hopper kernel for
  each of the three passes, and the source's sm90 tile sizes are the ones
  ``sm90_tile_plan`` models.
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
    """{(dtype code, head width): (design, built width)} for every width
    1..top, read from run_dtype's `if (dh <= W) return ...` lines: the
    mma.sync instance at W, or the Hopper one where `dh % 8 == 0 && tma ?`
    picks it (for views that fit its tensor maps); then its closing
    `return run_wide<...>` for every wider width."""
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
                table[(int(code), dh)] = ("sm90" if sm90 else "mma", width)
            lo = width + 1
        wide = re.findall(r"\n    return (run_wide<\w+>)\(which, p, BH, stream\);", block)
        assert wide == [f"run_wide<{'bf16' if code == '1' else 'float'}>"], block
        for dh in range(lo, top + 1):
            table[(int(code), dh)] = ("mma", tatt.WIDE)
    return table


def test_dispatch_matches_kernel_head_dims_and_designs():
    table = _run_dtype_table()
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert set(table) == {(codes[dt], dh) for dt, dh in tatt.KERNEL_DESIGNS}
    for (dt, dh), design in tatt.KERNEL_DESIGNS.items():
        assert table[(codes[dt], dh)] == (design, tatt.kernel_width(dh)), (dt, dh)
    # the Hopper design is bf16 only, at the widths padded to 64 and 128
    # whose rows are whole 16-byte groups; float32 keeps its exact emulation
    assert {k for k, v in tatt.KERNEL_DESIGNS.items() if v == "sm90"} == {
        (torch.bfloat16, dh) for dh in range(40, 129, 8)}


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
