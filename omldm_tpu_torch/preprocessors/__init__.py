"""Streaming feature preprocessors (the reference's mlAPI preprocessors)."""

from omldm_tpu_torch.preprocessors.base import Preprocessor
from omldm_tpu_torch.preprocessors.registry import (
    PREPROCESSORS,
    is_valid_preprocessor,
    make_preprocessor,
)
from omldm_tpu_torch.preprocessors.transforms import (
    MinMaxScaler,
    PolynomialFeatures,
    StandardScaler,
)

__all__ = [
    "Preprocessor",
    "MinMaxScaler",
    "PolynomialFeatures",
    "StandardScaler",
    "PREPROCESSORS",
    "is_valid_preprocessor",
    "make_preprocessor",
]
