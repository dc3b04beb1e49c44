"""Streaming feature preprocessors (ported so far: StandardScaler)."""

from omldm_tpu_torch.preprocessors.base import Preprocessor
from omldm_tpu_torch.preprocessors.registry import (
    PREPROCESSORS,
    REFERENCE_PREPROCESSORS,
    is_valid_preprocessor,
    make_preprocessor,
)
from omldm_tpu_torch.preprocessors.transforms import StandardScaler

__all__ = [
    "Preprocessor",
    "StandardScaler",
    "PREPROCESSORS",
    "REFERENCE_PREPROCESSORS",
    "is_valid_preprocessor",
    "make_preprocessor",
]
