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

A trainer on a ``("dp", "sp", "tp")`` mesh of processes holds slices of
some leaves (``Split``: a dimension cut into equal blocks over one axis).
Its snapshot is the GLOBAL tree, gathered over the mesh
(:func:`gather_tree`) and written by process 0; a restore keeps each
process's slices (:func:`shard_tree`), on any mesh shape: a trainer saved
at (1, 2, 2) loads at (1, 1, 1) or (2, 1, 2), and the other way round.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from omldm_tpu_torch.models.transformer import tree_leaves, tree_map, tree_unflatten
from omldm_tpu_torch.parallel import multihost

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


@dataclasses.dataclass(frozen=True)
class Split:
    """Where a leaf is cut over the mesh: ``dim`` into equal blocks over
    ``axis`` (the JAX ``PartitionSpec`` with that one axis named); block
    ``i`` is held by the processes at coordinate ``i`` on the axis. A leaf
    whose spec is None is held whole by every process."""
    dim: int
    axis: str


def _zip_map(fn, tree, specs):
    return tree_unflatten(tree, [fn(leaf, spec) for leaf, spec
                                 in zip(tree_leaves(tree), tree_leaves(specs))])


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This process's slices of a global tree (numpy or tensor leaves)."""

    def local(leaf, spec):
        if spec is None:
            return leaf
        size = leaf.shape[spec.dim] // mesh.shape[spec.axis]
        start = mesh.coords[spec.axis] * size
        return leaf[(slice(None),) * spec.dim + (slice(start, start + size),)]

    return _zip_map(local, tree, specs)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The global tree, as numpy, from every process's slices: one
    ``all_gather`` a split leaf over its axis's group (every process of the
    mesh calls it)."""

    def whole(leaf, spec):
        group = None if spec is None else mesh.groups[spec.axis]
        if group is not None:
            leaf = multihost.all_gather(leaf.detach(), group, dim=spec.dim)
        return to_host(leaf)

    return _zip_map(whole, tree, specs)


def save_trainer_state(trainer: Any, directory: str) -> None:
    """Snapshot a trainer's global ``{params, opt, fitted}`` (``SeqTrainer``;
    ``SPMDTrainer`` snapshots its fleet ``state``): gathered over its mesh,
    written by process 0, and every process waits until it is written."""
    host = gather_tree({"params": trainer.params, "opt": trainer.opt},
                       {"params": trainer._pspecs, "opt": trainer._ospecs}, trainer.mesh)
    if trainer.mesh.rank == 0:
        save_tree(directory, {**host, "fitted": np.int64(trainer.fitted)})
    if trainer.mesh.world > 1:
        dist.barrier()


def load_trainer_state(trainer: Any, directory: str) -> None:
    """Restore :func:`save_trainer_state` output onto the trainer's mesh and
    device: each process keeps its slices of the global snapshot, whatever
    mesh saved it. Only the model config must match the saver's."""
    host = load_tree(directory)
    trainer.params = place_tree(shard_tree(host["params"], trainer._pspecs, trainer.mesh),
                                trainer.device)
    trainer.opt = place_tree(shard_tree(host["opt"], trainer._ospecs, trainer.mesh),
                             trainer.device)
    trainer._fitted = int(host["fitted"])
