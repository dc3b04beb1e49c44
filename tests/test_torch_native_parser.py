"""The port's copy of the native bulk parser (omldm_tpu_torch.ops.native)
against the JAX package's, on the same bytes.

Both libraries compile the same C++ source rules; the port's is a copy with
its own loader and build directory. Their (x, y, op, valid) outputs -- and
the sparse parser's (idx, val, y, op, valid) -- must be EXACTLY equal on
the fuzz cases of tests/test_parser_fuzz.py and tests/test_sparse_parser.py
(EOS markers, string numerics, categoricals, metadata, truncated lines,
``target: 0.0``), single-threaded and multithreaded. Rows the parser
drops or flags for the Python codec (valid != 1) leave x undefined in both,
so x is compared on kept rows only."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import omldm_tpu.ops.native as jax_native
import omldm_tpu_torch.ops.native as port_native
from omldm_tpu_torch.ops.native import loader
from test_parser_fuzz import make_lines as dense_lines
from test_sparse_parser import make_lines as sparse_lines

ROOT = Path(__file__).resolve().parents[1]
DIM = 8
DENSE, HASH, K = 6, 1 << 10, 8

# one line per named case, each also inside the fuzz blocks
CASES = {
    "plain": '{"numericalFeatures": [1.5, -2.25, 3.0], "target": 1.0}',
    "target_zero": '{"numericalFeatures": [0.5, 1.0], "target": 0.0}',
    "eos": "EOS",
    "eos_quoted": '"EOS"',
    "string_numerics": '{"numericalFeatures": ["1.5", null, 2], "target": "0"}',
    "categoricals": '{"numericalFeatures": [1.0], "categoricalFeatures": ["a", "b"], "target": 0.0}',
    "metadata": '{"numericalFeatures": [1.0], "metadata": {"a": [1, {"b": 2}]}, "target": 1.0}',
    "truncated": '{"numericalFeatures": [1.0, 2.0], "targ',
    "forecast": '{"numericalFeatures": [1.0, 2.0], "operation": "forecasting"}',
    "beyond_f32": '{"numericalFeatures": [1e308, -4e38], "target": 1e308}',
    "discrete": '{"numericalFeatures": [1.0], "discreteFeatures": [2, 3], "target": 1.0}',
    "garbage": "garbage {",
}


def _dense_equal(port, ref):
    (px, py, pop, pv), (rx, ry, rop, rv) = port, ref
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(pop, rop)
    keep = rv == 1
    np.testing.assert_array_equal(py[keep], ry[keep])
    np.testing.assert_array_equal(px[keep], rx[keep])
    return int(keep.sum())


def _sparse_equal(port, ref):
    (pi, pv_, py, pop, pvd), (ri, rv_, ry, rop, rvd) = port, ref
    np.testing.assert_array_equal(pvd, rvd)
    np.testing.assert_array_equal(pop, rop)
    keep = rvd == 1
    np.testing.assert_array_equal(py[keep], ry[keep])
    np.testing.assert_array_equal(pi[keep], ri[keep])
    np.testing.assert_array_equal(pv_[keep], rv_[keep])
    return int(keep.sum())


def test_both_parsers_build():
    assert port_native.fast_parser_available() and jax_native.fast_parser_available()
    path = loader.library_path()
    assert path.exists() and path.parent == loader.BUILD_DIR
    assert "omldm_tpu_torch" in path.parts and "build" in path.parts


@pytest.mark.parametrize("case", sorted(CASES))
def test_named_case_matches_reference(case):
    block = (CASES[case] + "\n").encode()
    _dense_equal(port_native.FastParser(DIM).parse(block),
                 jax_native.FastParser(DIM).parse(block))
    _sparse_equal(port_native.SparseFastParser(DENSE, HASH, K).parse(block),
                  jax_native.SparseFastParser(DENSE, HASH, K).parse(block))


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("seed", range(4))
def test_dense_fuzz_matches_reference(seed, n_threads):
    rng = np.random.RandomState(seed)
    block = ("\n".join(dense_lines(rng, 300)) + "\n").encode()
    kept = _dense_equal(port_native.FastParser(DIM, n_threads).parse(block),
                        jax_native.FastParser(DIM, n_threads).parse(block))
    assert kept > 50


@pytest.mark.parametrize("n_threads", [1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_sparse_fuzz_matches_reference(seed, n_threads):
    rng = np.random.RandomState(seed)
    block = ("\n".join(sparse_lines(rng, 300)) + "\n").encode()
    kept = _sparse_equal(
        port_native.SparseFastParser(DENSE, HASH, K, n_threads=n_threads).parse(block),
        jax_native.SparseFastParser(DENSE, HASH, K, n_threads=n_threads).parse(block))
    assert kept > 50


def test_parse_range_matches_reference():
    """The zero-copy entry over a slice of a reusable buffer."""
    rng = np.random.RandomState(11)
    body = ("\n".join(dense_lines(rng, 200)) + "\n").encode()
    buf = bytearray(b"xxxx\n" + body + b"partial line")
    start, stop = 5, 5 + len(body)
    _dense_equal(port_native.FastParser(DIM).parse_range(buf, start, stop),
                 jax_native.FastParser(DIM).parse_range(buf, start, stop))
    sbody = ("\n".join(sparse_lines(rng, 200)) + "\n").encode()
    sbuf = bytearray(b"yy\n" + sbody)
    _sparse_equal(
        port_native.SparseFastParser(DENSE, HASH, K).parse_range(sbuf, 3, 3 + len(sbody)),
        jax_native.SparseFastParser(DENSE, HASH, K).parse_range(sbuf, 3, 3 + len(sbody)))


def test_crc32_categoricals_match_zlib_rule():
    """Hashed slots follow zlib.crc32("{i}={cat}") with the signed rule,
    as SparseVectorizer does."""
    import zlib

    cats = ["red", "café", "=weird=", " ", "0"]
    line = json.dumps({"numericalFeatures": [2.5], "categoricalFeatures": cats,
                       "target": 1.0, "operation": "training"}, ensure_ascii=False) + "\n"
    idx, val, _, _, valid = port_native.SparseFastParser(DENSE, HASH, K).parse(line.encode())
    assert valid[0] == 1
    assert idx[0, 0] == 0 and val[0, 0] == 2.5
    for j, cat in enumerate(cats):
        h = zlib.crc32(f"{j}={cat}".encode())
        assert idx[0, 1 + j] == DENSE + h % HASH
        assert val[0, 1 + j] == (1.0 if (h >> 1) % 2 == 0 else -1.0)


def test_concurrent_builds_never_load_a_partial_library(tmp_path):
    """Three processes build into an empty directory at once (as pytest
    workers do): each compiles to its own temporary name and renames it
    into place, so every one loads a whole library and no temporary file
    is left behind."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from pathlib import Path
        from omldm_tpu_torch.ops.native import loader
        loader.BUILD_DIR = Path({str(tmp_path)!r})
        p = loader.FastParser(4, n_threads=1)
        x, y, op, valid = p.parse(b'{{"numericalFeatures": [1.0, 2.0], "target": 1.0}}\\n')
        assert valid.tolist() == [1] and x[0, :2].tolist() == [1.0, 2.0]
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(3)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0, 0]
    assert [f.name for f in tmp_path.iterdir()] == [loader.library_path().name]
