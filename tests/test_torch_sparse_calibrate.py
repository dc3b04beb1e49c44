"""The port's sparse scatter calibration (omldm_tpu_torch.ops.sparse_calibrate):
its measuring half on the CPU at a tiny grid, the per-backend merge of the
table it writes, the committed table's two sections, and its isolation from
JAX. On the CPU the three formulations run their plain PyTorch versions;
the card's section of the committed table was measured on an H100 through
``python -m omldm_tpu_torch.ops.sparse_calibrate``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from omldm_tpu.ops import sparse_calibrate as jax_cal
from omldm_tpu_torch.ops import sparse_calibrate as cal
from omldm_tpu_torch.ops.sparse import SCATTER_IMPLS

ROOT = Path(__file__).resolve().parents[1]


def _table(backends):
    return {"version": 1, "note": "test", "backends": backends}


def _entry(d, updates, winner):
    return {"d": d, "batch": 1, "nnz": updates, "updates": updates, "winner": winner}


def test_gen_updates_is_the_jax_packages_draw():
    for args in ((256, 16, 4), (1 << 12, 64, 40)):
        for ours, theirs in zip(cal._gen_updates(*args), jax_cal._gen_updates(*args)):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("d,batch,nnz", [(256, 16, 4), (1 << 12, 32, 8)])
def test_measure_entry_covers_all_kernels(d, batch, nnz):
    e = cal.measure_entry(d, batch, nnz, steps=2, device="cpu")
    assert set(e["rates_updates_per_sec"]) == set(SCATTER_IMPLS)
    assert all(r is not None and r > 0 for r in e["rates_updates_per_sec"].values())
    assert e["winner"] in SCATTER_IMPLS
    assert e["updates"] == batch * nnz
    assert e["duplicate_factor"] >= 1.0


def test_measure_entry_skips_mxu_past_the_cap(monkeypatch):
    monkeypatch.setattr(cal, "MXU_BYTES_CAP", 1024)
    e = cal.measure_entry(256, 16, 4, steps=1, device="cpu")
    assert e["rates_updates_per_sec"]["mxu"] is None
    assert e["winner"] in ("scatter", "segsum")


def test_measure_chains_in_place_applications():
    """``steps`` applications land in one w: the chain's result is the
    applications' sum, so no step was dropped or run on a copy."""
    idx, val, coef = cal._gen_updates(64, 8, 3)
    seen = []

    def fn(w, ii, cc, vv, inplace):
        assert inplace
        seen.append(SCATTER_IMPLS["scatter"](w, ii, cc, vv, inplace=True))
        return w

    rate = cal._measure_kernel(fn, 64, idx, val, coef, steps=3, device=torch.device("cpu"),
                               repeats=2)
    assert rate > 0 and len(seen) == 3 * 3  # a warm-up chain, then two timed ones
    assert all(t is seen[0] for t in seen)
    once = SCATTER_IMPLS["scatter"](torch.zeros(64), *(torch.from_numpy(a) for a in (idx, coef, val)))
    np.testing.assert_allclose(seen[0].numpy(), 9 * once.numpy(), rtol=1e-5, atol=1e-5)


def test_calibrate_merges_per_backend(tmp_path, monkeypatch):
    """A cpu calibration writes its section and leaves the cuda one as it
    was."""
    path = tmp_path / "table.json"
    cuda = {"note": "a card", "entries": [_entry(1 << 18, 1 << 10, "segsum")]}
    path.write_text(json.dumps(_table({"cuda": cuda})))
    monkeypatch.delenv(cal.ENV_TABLE, raising=False)
    table = cal.calibrate([(256, 16, 4)], steps=2, out=str(path), device="cpu")
    on_disk = json.loads(path.read_text())
    assert on_disk == table
    assert on_disk["backends"]["cuda"] == cuda
    section = on_disk["backends"]["cpu"]
    assert section["note"] == "cpu" and section["steps_per_sample"] == 2
    [e] = section["entries"]
    assert e["winner"] in SCATTER_IMPLS and e["d"] == 256


def test_cli_writes_a_table(tmp_path):
    out = tmp_path / "t.json"
    cal.main(["--smoke", "--steps", "1", "--device", "cpu", "--out", str(out)])
    section = json.loads(out.read_text())["backends"]["cpu"]
    assert section["generated_by"].endswith("--smoke")
    assert [(e["d"], e["batch"], e["nnz"]) for e in section["entries"]] == cal.SMOKE_GRID


def test_cli_wants_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is measurable")
    with pytest.raises(SystemExit, match="no CUDA card"):
        cal.main(["--smoke", "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_committed_table_has_both_sections():
    """The cuda section was measured on the card over the full grid, and its
    note names the card and its power limit as nvidia-smi gives them."""
    table = json.loads(Path(cal.DEFAULT_TABLE).read_text())
    assert set(table["backends"]) == {"cpu", "cuda"}
    cuda = table["backends"]["cuda"]
    assert cuda["generated_by"] == "python -m omldm_tpu_torch.ops.sparse_calibrate"
    assert "H100" in cuda["note"] and cuda["note"].endswith(" W")
    grid = [(e["d"], e["batch"], e["nnz"]) for e in cuda["entries"]]
    assert grid == cal.FULL_GRID
    for e in cuda["entries"]:
        rates = e["rates_updates_per_sec"]
        assert set(rates) == set(SCATTER_IMPLS)
        measured = {k: v for k, v in rates.items() if v is not None}
        assert "scatter" in measured and "segsum" in measured
        assert e["winner"] == max(measured, key=measured.get)


def test_calibration_imports_no_jax():
    code = (
        "import sys, omldm_tpu_torch.ops.sparse_calibrate as c\n"
        "c.measure_entry(64, 8, 2, steps=1, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'omldm_tpu' or m.startswith('omldm_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
