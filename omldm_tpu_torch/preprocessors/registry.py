"""Preprocessor registry: the reference allowlist ``PolynomialFeatures,
StandardScaler, MinMaxScaler`` (PipelineMap.scala:67).

Counterpart of ``omldm_tpu/preprocessors/registry.py``.
"""

from __future__ import annotations

from typing import Dict, Type

from omldm_tpu_torch.api.requests import PreprocessorSpec
from omldm_tpu_torch.preprocessors.base import Preprocessor
from omldm_tpu_torch.preprocessors.transforms import (
    MinMaxScaler,
    PolynomialFeatures,
    StandardScaler,
)

PREPROCESSORS: Dict[str, Type[Preprocessor]] = {
    "PolynomialFeatures": PolynomialFeatures,
    "StandardScaler": StandardScaler,
    "MinMaxScaler": MinMaxScaler,
}


def is_valid_preprocessor(name: str) -> bool:
    return name in PREPROCESSORS


def make_preprocessor(spec: PreprocessorSpec) -> Preprocessor:
    return PREPROCESSORS[spec.name](spec.hyper_parameters)
