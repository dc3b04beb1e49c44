"""Native (C++) host components, built on demand with the system toolchain.

The port's copy of the JAX package's bulk record parser: ``fastparse.cpp``
compiled with g++ into a shared object loaded through ctypes (no pybind11).
It packs JSON lines straight into numpy arrays -- dense rows for the packed
ingest route, padded COO for sparse records -- and flags the lines it
cannot take for the Python codec. Without a toolchain the callers fall back
to that codec.
"""

from omldm_tpu_torch.ops.native.loader import (
    FastParser,
    FusedStage,
    SparseFastParser,
    SparseFusedStage,
    fast_parser_available,
)

__all__ = [
    "FastParser",
    "FusedStage",
    "SparseFastParser",
    "SparseFusedStage",
    "fast_parser_available",
]
