"""Hoeffding Tree (VFDT) classifier (``HT``).

A copy of ``omldm_tpu/learners/hoeffding_tree.py``'s numpy code. As in the
JAX package (and the reference, which forces the ``SingleLearner``
protocol for HT because the model is a mutable tree, not a parameter
vector), the model is a *host-side* structure: the tree lives in Python
and numpy and consumes micro-batches. Nothing of it goes to the card; the
pipeline keeps an HT pipeline's whole state on the host (``host_side``).

Numeric attributes are handled with per-leaf Gaussian sufficient statistics
(Welford mean/variance per (feature, class)), the standard MOA-style
approximation; split decisions use the Hoeffding bound
``eps = sqrt(R^2 ln(1/delta) / 2n)`` with ``R = log2(#classes)``.

Hyper-parameters: ``nClasses`` (default 2), ``delta`` (default 1e-7),
``tau`` (tie threshold, default 0.05), ``gracePeriod`` (records between
split attempts per leaf, default 200), ``maxDepth`` (default 20).
"""

from __future__ import annotations

import math

import numpy as np

from omldm_tpu_torch.learners.base import Learner, Params


def _norm_cdf(x):
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


class _Leaf:
    __slots__ = ("class_counts", "n", "mean", "m2", "seen_since_check", "depth")

    def __init__(self, n_classes: int, dim: int, depth: int):
        self.class_counts = np.zeros(n_classes)
        # per (class, feature) Welford stats
        self.n = np.zeros((n_classes, dim))
        self.mean = np.zeros((n_classes, dim))
        self.m2 = np.zeros((n_classes, dim))
        self.seen_since_check = 0
        self.depth = depth

    def observe(self, x: np.ndarray, y: int):
        self.class_counts[y] += 1
        self.n[y] += 1
        delta = x - self.mean[y]
        self.mean[y] += delta / self.n[y]
        self.m2[y] += delta * (x - self.mean[y])
        self.seen_since_check += 1

    def majority(self) -> int:
        return int(np.argmax(self.class_counts))

    def total(self) -> float:
        return float(self.class_counts.sum())


class _Split:
    __slots__ = ("feature", "threshold", "left", "right")

    def __init__(self, feature: int, threshold: float, left, right):
        self.feature = feature
        self.threshold = threshold
        self.left = left
        self.right = right


def _entropy(counts: np.ndarray) -> float:
    total = counts.sum()
    if total <= 0:
        return 0.0
    p = counts[counts > 0] / total
    return float(-(p * np.log2(p)).sum())


class HoeffdingTree(Learner):
    name = "HT"
    task = "classification"
    host_side = True  # model is a mutable host structure, not a device pytree

    def _n_classes(self) -> int:
        return int(self.hp.get("nClasses", self.ds.get("nClasses", 2)))

    def init(self, dim: int, generator=None, device=None) -> Params:
        return {
            "root": _Leaf(self._n_classes(), dim, depth=0),
            "dim": dim,
            "n_nodes": 1,
        }

    # --- routing ---

    def _leaf_for(self, node, x: np.ndarray):
        while isinstance(node, _Split):
            node = node.left if x[node.feature] <= node.threshold else node.right
        return node

    def _route_and_replace(self, params, x: np.ndarray, new_leaf_factory):
        """Find the leaf for x; if it should split, replace it in the tree."""
        parent, side = None, None
        node = params["root"]
        while isinstance(node, _Split):
            parent, side = node, ("left" if x[node.feature] <= node.threshold else "right")
            node = getattr(node, side)
        replacement = new_leaf_factory(node)
        if replacement is not node:
            if parent is None:
                params["root"] = replacement
            else:
                setattr(parent, side, replacement)
            params["n_nodes"] += 2
        return node

    # --- split evaluation ---

    def _gaussian_gain(self, leaf: _Leaf, feature: int, threshold: float) -> float:
        """Info gain of splitting `feature` at `threshold`, estimating per-class
        left/right counts via the fitted Gaussians."""
        counts = leaf.class_counts
        n = leaf.n[:, feature]
        mean = leaf.mean[:, feature]
        var = np.where(n > 1, leaf.m2[:, feature] / np.maximum(n - 1, 1), 1.0)
        std = np.sqrt(np.maximum(var, 1e-12))
        frac_left = np.where(
            n > 0, _norm_cdf((threshold - mean) / std), 0.5
        )
        left = counts * frac_left
        right = counts - left
        total = counts.sum()
        if total <= 0:
            return 0.0
        h0 = _entropy(counts)
        wl, wr = left.sum() / total, right.sum() / total
        return h0 - wl * _entropy(left) - wr * _entropy(right)

    def _try_split(self, leaf: _Leaf):
        n_classes = self._n_classes()
        total = leaf.total()
        if total < 2 or leaf.depth >= int(self.hp.get("maxDepth", 20)):
            return leaf
        delta = float(self.hp.get("delta", 1e-7))
        tau = float(self.hp.get("tau", 0.05))
        R = math.log2(max(n_classes, 2))
        eps = math.sqrt(R * R * math.log(1.0 / delta) / (2.0 * total))

        best, second, best_feat, best_thr = 0.0, 0.0, -1, 0.0
        dim = leaf.mean.shape[1]
        active = [k for k in range(n_classes) if leaf.class_counts[k] > 0]
        if len(active) < 2:
            return leaf
        for f in range(dim):
            # candidate thresholds: midpoints between class means
            means = sorted(leaf.mean[k, f] for k in active)
            for a, b in zip(means[:-1], means[1:]):
                thr = 0.5 * (a + b)
                g = self._gaussian_gain(leaf, f, thr)
                if g > best:
                    second, best, best_feat, best_thr = best, g, f, thr
                elif g > second:
                    second = g
        if best_feat >= 0 and (best - second > eps or eps < tau):
            dim = leaf.mean.shape[1]
            left = _Leaf(n_classes, dim, leaf.depth + 1)
            right = _Leaf(n_classes, dim, leaf.depth + 1)
            # seed child class priors from the parent's Gaussian estimates
            std = np.sqrt(
                np.maximum(
                    np.where(
                        leaf.n[:, best_feat] > 1,
                        leaf.m2[:, best_feat] / np.maximum(leaf.n[:, best_feat] - 1, 1),
                        1.0,
                    ),
                    1e-12,
                )
            )
            frac_left = np.where(
                leaf.n[:, best_feat] > 0,
                _norm_cdf((best_thr - leaf.mean[:, best_feat]) / std),
                0.5,
            )
            left.class_counts = leaf.class_counts * frac_left
            right.class_counts = leaf.class_counts * (1.0 - frac_left)
            return _Split(best_feat, best_thr, left, right)
        return leaf

    # --- Learner interface (numpy in, numpy out) ---

    def update(self, params, x, y, mask, donate=False):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y)
        mask = np.asarray(mask)
        grace = int(self.hp.get("gracePeriod", 200))
        errors, n_valid = 0.0, 0
        for i in range(x.shape[0]):
            if mask[i] <= 0:
                continue
            n_valid += 1
            xi = x[i]
            # clamp out-of-range labels instead of crashing on one bad record
            yi = min(max(int(y[i]), 0), self._n_classes() - 1)
            leaf = self._leaf_for(params["root"], xi)
            if leaf.majority() != yi and leaf.total() > 0:
                errors += 1.0
            leaf.observe(xi, yi)
            if leaf.seen_since_check >= grace:
                leaf.seen_since_check = 0
                self._route_and_replace(params, xi, self._try_split)
        loss = errors / max(n_valid, 1)
        return params, np.float32(loss)

    def update_per_record(self, params, x, y, mask, donate=False):
        return self.update(params, x, y, mask)

    def predict(self, params, x):
        x = np.asarray(x, dtype=np.float64)
        out = np.empty((x.shape[0],), dtype=np.float32)
        for i in range(x.shape[0]):
            out[i] = self._leaf_for(params["root"], x[i]).majority()
        return out

    def loss(self, params, x, y, mask):
        """0/1 misclassification rate over valid rows."""
        preds = self.predict(params, x)
        y = np.asarray(y, dtype=np.float32)
        mask = np.asarray(mask, dtype=np.float32)
        errs = (preds != y).astype(np.float32)
        total = max(float(mask.sum()), 1.0)
        return np.float32(float((errs * mask).sum()) / total)

    def score(self, params, x, y, mask):
        return np.float32(1.0) - self.loss(params, x, y, mask)

    def merge(self, params_list):
        """Trees are not parameter-averageable; keep the most-trained tree
        (the reference sidesteps merging by forcing SingleLearner for HT)."""
        def tree_total(p):
            def rec(node):
                if isinstance(node, _Split):
                    return rec(node.left) + rec(node.right)
                return node.total()
            return rec(p["root"])
        return max(params_list, key=tree_total)
