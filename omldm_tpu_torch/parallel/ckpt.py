"""Snapshot and restore of trainer state trees.

Counterpart of ``omldm_tpu/parallel/ckpt.py``, the trainer-side analogue of
the stream runtime's job checkpointing (``omldm_tpu_torch.checkpoint``,
mirroring Flink's operator snapshots, FlinkSpoke.scala:233-334). The JAX
package writes its trees with orbax, a JAX library; the port writes its
own format: the tree with every tensor leaf as a numpy array (dicts,
lists and tuples keep their nesting, so the leaf order is the tree's),
pickled into ``tree.pkl`` in the snapshot directory. numpy rather than
``torch.save`` of CPU tensors, because the job checkpoints are pickled
numpy trees too (the JAX package's own format, ``checkpoint.py``) and a
numpy tree names no device: a snapshot taken on the card loads on the CPU
and the other way round. The file is written to a temporary name and
renamed, so a crash mid-write never leaves a torn snapshot.
"""

from __future__ import annotations

import copy
import os
import pickle
from typing import Any

import numpy as np
import torch

from omldm_tpu_torch.models.transformer import tree_map

TREE_FILE = "tree.pkl"


def to_host(tree):
    """Every tensor leaf as a numpy copy; Python numbers as numpy values;
    other leaves (a host-side learner's tree nodes) pass through."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True).numpy()
        if isinstance(x, (bool, int, float)):
            return np.asarray(x)
        return x

    return tree_map(leaf, tree)


def place_tree(tree, device) -> Any:
    """Each array leaf of a host tree as a tensor of its own on ``device``
    (a fit may write into it, so no two calls share a buffer); other leaves
    are deep copies."""

    def leaf(x):
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(x)).to(device)
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=device, copy=True)
        return copy.deepcopy(x)

    return tree_map(leaf, tree)


def save_tree(directory: str, tree: Any) -> None:
    """Write ``tree`` (tensor leaves taken to the host) into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TREE_FILE)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(to_host(tree), f)
    os.replace(path + ".tmp", path)


def load_tree(directory: str) -> Any:
    """The host tree :func:`save_tree` wrote (numpy leaves)."""
    with open(os.path.join(directory, TREE_FILE), "rb") as f:
        return pickle.load(f)


def save_trainer_state(trainer: Any, directory: str) -> None:
    """Snapshot a trainer's ``{params, opt, fitted}`` (``SeqTrainer``;
    ``SPMDTrainer`` snapshots its fleet ``state``)."""
    save_tree(directory, {
        "params": trainer.params,
        "opt": trainer.opt,
        "fitted": np.int64(trainer.fitted),
    })


def load_trainer_state(trainer: Any, directory: str) -> None:
    """Restore :func:`save_trainer_state` output onto the trainer's device.
    Only the model config must match the saver's."""
    host = load_tree(directory)
    trainer.params = place_tree(host["params"], trainer.device)
    trainer.opt = place_tree(host["opt"], trainer.device)
    trainer._fitted = int(host["fitted"])
