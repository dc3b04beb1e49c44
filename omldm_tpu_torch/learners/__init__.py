"""Online learners: the reference's allowlist plus Softmax, and the sparse
variants of PA, RegressorPA, SVM and Softmax."""

from omldm_tpu_torch.learners.base import Learner, append_bias, masked_mean, sign_labels
from omldm_tpu_torch.learners.hoeffding_tree import HoeffdingTree
from omldm_tpu_torch.learners.kmeans import KMeans
from omldm_tpu_torch.learners.linear import (
    ORR,
    PAClassifier,
    PARegressor,
    RFFSVM,
    SoftmaxClassifier,
)
from omldm_tpu_torch.learners.multiclass_pa import MultiClassPA
from omldm_tpu_torch.learners.nn import NeuralNetwork
from omldm_tpu_torch.learners.registry import (
    LEARNERS,
    SINGLE_LEARNER_ONLY,
    is_valid_learner,
    make_learner,
)
from omldm_tpu_torch.learners.sparse_linear import SPARSE_LEARNERS

__all__ = [
    "Learner",
    "append_bias",
    "masked_mean",
    "sign_labels",
    "HoeffdingTree",
    "KMeans",
    "MultiClassPA",
    "NeuralNetwork",
    "ORR",
    "PAClassifier",
    "PARegressor",
    "RFFSVM",
    "SoftmaxClassifier",
    "LEARNERS",
    "SINGLE_LEARNER_ONLY",
    "is_valid_learner",
    "make_learner",
    "SPARSE_LEARNERS",
]
