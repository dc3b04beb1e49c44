"""Device choice shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None, who: str = "omldm_tpu_torch") -> torch.device:
    """``None`` means CUDA. Asking for CUDA without a usable card raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: CUDA requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev
