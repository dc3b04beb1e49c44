"""Learner registry: the reference's allowlist (PA, RegressorPA, ORR,
SVM, MultiClassPA, K-means, NN, HT) plus Softmax, and the sparse
(padded-COO) variants of PA, RegressorPA, SVM and Softmax.

Counterpart of ``omldm_tpu/learners/registry.py``.
"""

from __future__ import annotations

from typing import Dict, Type

from omldm_tpu_torch.api.requests import LearnerSpec
from omldm_tpu_torch.learners.base import Learner
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
from omldm_tpu_torch.learners.sparse_linear import SPARSE_LEARNERS

LEARNERS: Dict[str, Type[Learner]] = {
    "PA": PAClassifier,
    "RegressorPA": PARegressor,
    "ORR": ORR,
    "SVM": RFFSVM,
    "MultiClassPA": MultiClassPA,
    "K-means": KMeans,
    "NN": NeuralNetwork,
    "HT": HoeffdingTree,
    # extension beyond the reference allowlist
    "Softmax": SoftmaxClassifier,
}

# Learners the reference forces onto the SingleLearner protocol
# (FlinkSpoke.scala:203-210).
SINGLE_LEARNER_ONLY = frozenset({"HT", "K-means"})


def is_valid_learner(name: str) -> bool:
    return name in LEARNERS


def make_learner(spec: LearnerSpec) -> Learner:
    """Instantiate a learner from a request's LearnerSpec; raises KeyError on
    unknown names (the control gate rejects them first).

    ``dataStructure: {"sparse": true}`` selects the padded-COO variant: its
    inputs are (idx, val) pairs and its updates gather/scatter over a dense
    device weight vector."""
    if spec.data_structure and spec.data_structure.get("sparse"):
        cls = SPARSE_LEARNERS.get(spec.name)
        if cls is None:
            raise KeyError(
                f"learner {spec.name!r} has no sparse variant "
                f"(available: {sorted(SPARSE_LEARNERS)})"
            )
        return cls(spec.hyper_parameters, spec.data_structure)
    return LEARNERS[spec.name](spec.hyper_parameters, spec.data_structure)
