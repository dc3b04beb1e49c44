"""Lookup half of the sparse scatter calibration table.

Counterpart of the table reader in ``omldm_tpu/ops/sparse_calibrate.py``.
``sparse_scatter_add_auto`` (ops/sparse.py) asks :func:`lookup_winner` for
the fastest of its three formulations at the nearest measured (D, updates)
grid point of the active backend. The port reads its own copy of the table,
``sparse_dispatch.json`` beside this file (or the file that
``OMLDM_SPARSE_SCATTER_TABLE`` names): its ``cpu`` section is the JAX
package's measured CPU section, and it has no ``cuda`` section, so on the
card the dispatch falls through to the scatter kernel. The measuring half,
which would write a ``cuda`` section, is not ported.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

DEFAULT_TABLE = os.path.join(os.path.dirname(__file__), "sparse_dispatch.json")
ENV_TABLE = "OMLDM_SPARSE_SCATTER_TABLE"


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
