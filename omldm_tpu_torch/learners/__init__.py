"""Online learners (ported so far: PA)."""

from omldm_tpu_torch.learners.base import Learner, append_bias, masked_mean, sign_labels
from omldm_tpu_torch.learners.linear import PAClassifier
from omldm_tpu_torch.learners.registry import (
    LEARNERS,
    REFERENCE_LEARNERS,
    SINGLE_LEARNER_ONLY,
    is_valid_learner,
    make_learner,
)

__all__ = [
    "Learner",
    "append_bias",
    "masked_mean",
    "sign_labels",
    "PAClassifier",
    "LEARNERS",
    "REFERENCE_LEARNERS",
    "SINGLE_LEARNER_ONLY",
    "is_valid_learner",
    "make_learner",
]
