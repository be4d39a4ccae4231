"""Random-forest regressor (numpy): SMAC's surrogate model [18, 22].

A forest of CART regression trees over the unit-encoded knob space; the
across-tree spread provides the predictive variance the EI acquisition
needs.  Two growers produce bitwise-identical forests (the reference
package's two):

* ``mode="fast"`` (the default) -- :func:`~repro_torch.core.bo.forest_fast.
  fit_forest_fast`, level-synchronous vectorized growth emitting flat
  ``(T, max_nodes)`` arrays directly;
* ``mode="reference"`` -- the per-node recursive CART grower, kept as the
  executable specification, packed into the same flat arrays.

Randomness protocol (the reference's, so suggestion histories agree):
``fit`` draws the whole bootstrap matrix up front and a single feature-hash
seed; per-node feature subsets come from the counter-based
:func:`~repro_torch.core.bo.forest_fast.feature_subsets` hash of
``(seed, tree, heap-node)``, so build order (DFS vs BFS) cannot change the
forest.  Node means and the variance-floor termination come from
sequential cumsums in both growers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .forest_fast import (FlatForest, _MIN_NODE_VAR, _moments,
                          feature_subsets, fit_forest_fast, predict_forest)

DEFAULT_MODE = "fast"


def resolve_mode(mode: Optional[str] = None) -> str:
    """The grower a ``RandomForest``'s ``mode`` resolves to."""
    mode = mode or DEFAULT_MODE
    if mode not in ("reference", "fast"):
        raise ValueError(f"unknown surrogate mode {mode!r}; "
                         "expected 'reference' or 'fast'")
    return mode


@dataclasses.dataclass
class _Node:
    # leaf: value set, feature < 0
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class _Tree:
    """Reference CART regression tree: per-node recursion, DFS pre-order.

    Consumes NO sequential randomness — the feature subset for the split
    attempt at heap node ``h`` is ``feature_subsets(feat_seed, tree, h)``,
    the same deterministic hash the level-synchronous fast grower uses.
    """

    def __init__(self, max_depth: int, min_leaf: int, max_features: int,
                 tree_index: int, feat_seed: int):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.max_features = max_features
        self.tree_index = tree_index
        self.feat_seed = feat_seed
        self.nodes: List[_Node] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "_Tree":
        self.nodes = []
        self._build(X, y, depth=0, heap=1)
        return self

    def _build(self, X: np.ndarray, y: np.ndarray, depth: int,
               heap: int) -> int:
        idx = len(self.nodes)
        n = len(y)
        c1 = np.cumsum(y)
        c2 = np.cumsum(y * y)
        self.nodes.append(_Node(value=float(c1[-1] / n)))
        sse = c2[-1] - c1[-1] ** 2 / n
        if depth >= self.max_depth or n < 2 * self.min_leaf \
                or not (sse >= n * _MIN_NODE_VAR):
            return idx
        d = X.shape[1]
        feats = feature_subsets(self.feat_seed, self.tree_index, heap,
                                d, min(self.max_features, d))
        best = self._best_split(X, y, feats)
        if best is None:
            return idx
        f, thr, mask = best
        left = self._build(X[mask], y[mask], depth + 1, 2 * heap)
        right = self._build(X[~mask], y[~mask], depth + 1, 2 * heap + 1)
        node = self.nodes[idx]
        node.feature, node.threshold, node.left, node.right = f, thr, left, right
        return idx

    def _best_split(self, X, y, feats) -> Optional[Tuple[int, float, np.ndarray]]:
        n = len(y)
        best_score, best = np.inf, None
        for f in feats:
            xs = X[:, f]
            order = np.argsort(xs, kind="stable")
            xs_s, ys_s = xs[order], y[order]
            # candidate thresholds between distinct consecutive values
            csum = np.cumsum(ys_s)
            csum2 = np.cumsum(ys_s ** 2)
            total, total2 = csum[-1], csum2[-1]
            ks = np.arange(self.min_leaf, n - self.min_leaf + 1)
            if len(ks) == 0:
                continue
            valid = xs_s[ks - 1] < xs_s[np.minimum(ks, n - 1)]
            ks = ks[valid]
            if len(ks) == 0:
                continue
            left_sse = csum2[ks - 1] - csum[ks - 1] ** 2 / ks
            nr = n - ks
            right_sse = (total2 - csum2[ks - 1]) - (total - csum[ks - 1]) ** 2 / nr
            scores = left_sse + right_sse
            j = int(np.argmin(scores))
            if scores[j] < best_score:
                k = ks[j]
                thr = 0.5 * (xs_s[k - 1] + xs_s[k])
                best_score = scores[j]
                best = (int(f), float(thr), xs <= thr)
        return best

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Per-row walk — the oracle the flat descent is tested against."""
        out = np.empty(len(X))
        for i, x in enumerate(X):
            node = self.nodes[0]
            while node.feature >= 0:
                j = node.left if x[node.feature] <= node.threshold else node.right
                node = self.nodes[j]
            out[i] = node.value
        return out


def _pack_reference_trees(trees: List[_Tree], max_depth: int) -> FlatForest:
    """Flatten reference trees (nodes already in DFS pre-order) to the same
    padded ``(T, M)`` arrays the fast grower emits."""
    T = len(trees)
    counts = np.array([len(t.nodes) for t in trees], dtype=np.int64)
    M = int(counts.max())
    F = np.full((T, M), -1, dtype=np.int64)
    TH = np.zeros((T, M))
    LC = np.full((T, M), -1, dtype=np.int64)
    RC = np.full((T, M), -1, dtype=np.int64)
    V = np.zeros((T, M))
    for t, tree in enumerate(trees):
        k = len(tree.nodes)
        F[t, :k] = [nd.feature for nd in tree.nodes]
        TH[t, :k] = [nd.threshold for nd in tree.nodes]
        LC[t, :k] = [nd.left for nd in tree.nodes]
        RC[t, :k] = [nd.right for nd in tree.nodes]
        V[t, :k] = [nd.value for nd in tree.nodes]
    return FlatForest(feature=F, threshold=TH, left=LC, right=RC, value=V,
                      n_nodes=counts, max_depth=max_depth)


class RandomForest:
    """Bagged regression forest with mean/variance prediction.

    ``mode=None`` resolves via :func:`resolve_mode` at fit time; the
    resulting :class:`~repro_torch.core.bo.forest_fast.FlatForest` is
    ``self.forest`` (scored by :func:`~repro_torch.core.bo.forest_fast.
    suggest_topq` against the target normalization ``_y_mean``/``_y_std``),
    and all predictions run the flat batched descent on the host.
    """

    def __init__(self, n_trees: int = 24, max_depth: int = 12,
                 min_leaf: int = 2, max_features: Optional[int] = None,
                 seed: int = 0, mode: Optional[str] = None):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.max_features = max_features
        self.rng = np.random.default_rng(seed)
        self.mode = mode
        self.trees: List[_Tree] = []   # populated in reference mode only
        self.forest: Optional[FlatForest] = None
        self._y_mean = 0.0
        self._y_std = 1.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        n, d = X.shape
        mf = self.max_features or max(1, int(np.ceil(d * 5.0 / 6.0)))
        mf = min(mf, d)
        # shared randomness protocol: bootstraps + feature-hash seed drawn
        # up front, identically for both growers
        boot = self.rng.integers(0, n, size=(self.n_trees, n))
        feat_seed = int(self.rng.integers(2 ** 63))
        mode = resolve_mode(self.mode)
        if mode == "reference":
            self.trees = []
            for t in range(self.n_trees):
                tree = _Tree(self.max_depth, self.min_leaf, mf, t, feat_seed)
                tree.fit(X[boot[t]], yn[boot[t]])
                self.trees.append(tree)
            self.forest = _pack_reference_trees(self.trees, self.max_depth)
        else:
            self.trees = []
            self.forest = fit_forest_fast(X, yn, boot, feat_seed,
                                          self.max_depth, self.min_leaf, mf)
        return self

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (mean, std) per row, de-normalized."""
        return self.predict_batch(X)

    def predict_batch(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(mean, std) via the vectorized all-trees flat descent — one
        gather loop for the whole forest, the fast path for scoring large
        batched-EI candidate pools and importance sweeps."""
        X = np.asarray(X, dtype=np.float64)
        preds = predict_forest(self.forest, X)  # (T, N)
        return self._moments(preds)

    def _moments(self, preds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return _moments(preds, self._y_mean, self._y_std)
