"""ML pipeline composition (the reference's mlAPI.pipelines.MLPipeline)."""

from omldm_tpu_torch.pipelines.pipeline import (
    MLPipeline,
    fleet_state_from_numpy,
    state_from_numpy,
    state_to_numpy,
)

__all__ = ["MLPipeline", "fleet_state_from_numpy", "state_from_numpy", "state_to_numpy"]
