"""Streaming preprocessor interface.

Counterpart of ``omldm_tpu/preprocessors/base.py``: a preprocessor is a
stateless module over an explicit state (a dict of tensors). Scalers update
their running statistics from each micro-batch before transforming it.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

State = Any


class Preprocessor:
    name: str = ""

    def __init__(self, hyper_parameters: Optional[Mapping[str, Any]] = None):
        self.hp = dict(hyper_parameters or {})

    def out_dim(self, dim: int) -> int:
        """Output feature dimension for an input dimension ``dim``."""
        return dim

    def init(self, dim: int, device: Optional[torch.device] = None) -> State:
        return {}

    def update(self, state: State, x: torch.Tensor, mask: torch.Tensor) -> State:
        """Learn running statistics from a masked micro-batch."""
        return state

    def transform(self, state: State, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def merge(self, states) -> State:
        """Merge the states of parallel pipeline copies."""
        return states[0]
