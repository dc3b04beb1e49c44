"""External JSON contract of the framework (the reference's ControlAPI POJOs).

The framework keeps the reference's external contract: JSON ``DataInstance`` /
``Request`` records in; ``Prediction`` / ``QueryResponse`` / ``JobStatistics``
out (SURVEY.md section 2.2, reference usage sites cited per class).
"""

from omldm_tpu_torch.api.data import DataInstance, Prediction
from omldm_tpu_torch.api.requests import (
    LearnerSpec,
    PreprocessorSpec,
    Request,
    RequestType,
    TrainingConfiguration,
)
from omldm_tpu_torch.api.responses import QueryResponse
from omldm_tpu_torch.api.stats import JobStatistics, Statistics

__all__ = [
    "DataInstance",
    "Prediction",
    "LearnerSpec",
    "PreprocessorSpec",
    "Request",
    "RequestType",
    "TrainingConfiguration",
    "QueryResponse",
    "Statistics",
    "JobStatistics",
]
