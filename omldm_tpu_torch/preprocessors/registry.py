"""Preprocessor registry. Ported so far: ``StandardScaler`` only.

Counterpart of ``omldm_tpu/preprocessors/registry.py``.
``REFERENCE_PREPROCESSORS`` is the reference allowlist
(PipelineMap.scala:67), kept so the control gate can tell a preprocessor
that is not ported yet from an unknown one.
"""

from __future__ import annotations

from typing import Dict, Type

from omldm_tpu_torch.api.requests import PreprocessorSpec
from omldm_tpu_torch.preprocessors.base import Preprocessor
from omldm_tpu_torch.preprocessors.transforms import StandardScaler

PREPROCESSORS: Dict[str, Type[Preprocessor]] = {
    "StandardScaler": StandardScaler,
}

REFERENCE_PREPROCESSORS = frozenset(
    {"PolynomialFeatures", "StandardScaler", "MinMaxScaler"}
)


def is_valid_preprocessor(name: str) -> bool:
    return name in PREPROCESSORS


def make_preprocessor(spec: PreprocessorSpec) -> Preprocessor:
    return PREPROCESSORS[spec.name](spec.hyper_parameters)
