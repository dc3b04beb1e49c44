"""Valid-row accounting for staged batch trains.

A chained-training entry point (MLPipeline.fit_many) must bump the
host-side fitted counter (the reference's ``fitted`` watermark,
FlinkHub.scala:101-127) without forcing a device->host copy when the masks
are staged on device — callers pass precomputed ``valid_counts`` then.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def batch_valid_counts(
    masks, valid_counts: Optional[Sequence] = None
) -> List[int]:
    """Per-batch valid-row counts for a [T, ...] stacked mask array.

    Uses ``valid_counts`` verbatim when given (masks may then live on
    device untouched); otherwise sums the mask on host — which transfers
    ``masks`` if it is device-resident."""
    if valid_counts is not None:
        return [int(c) for c in valid_counts]
    m = np.asarray(masks)
    return [int(c) for c in m.sum(axis=tuple(range(1, m.ndim)))]
