"""Random-forest regressor (numpy): SMAC's surrogate model [18, 22].

A forest of CART regression trees over the unit-encoded knob space; the
across-tree spread provides the predictive variance the EI acquisition
needs.  Trees are grown by :func:`~repro_torch.core.bo.forest_fast.
fit_forest_fast` (level-synchronous, flat ``(T, max_nodes)`` arrays), the
reference package's default way to grow them.

Randomness protocol (the reference's, so suggestion histories agree):
``fit`` draws the whole bootstrap matrix up front and a single feature-hash
seed; per-node feature subsets come from the counter-based
:func:`~repro_torch.core.bo.forest_fast.feature_subsets` hash of
``(seed, tree, heap-node)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .forest_fast import FlatForest, fit_forest_fast


class RandomForest:
    """Bagged regression forest.  The fitted
    :class:`~repro_torch.core.bo.forest_fast.FlatForest` is ``self.forest``
    (scored by :func:`~repro_torch.core.bo.forest_fast.suggest_topq`
    against the target normalization ``_y_mean``/``_y_std``)."""

    def __init__(self, n_trees: int = 24, max_depth: int = 12,
                 min_leaf: int = 2, max_features: Optional[int] = None,
                 seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.max_features = max_features
        self.rng = np.random.default_rng(seed)
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
        boot = self.rng.integers(0, n, size=(self.n_trees, n))
        feat_seed = int(self.rng.integers(2 ** 63))
        self.forest = fit_forest_fast(X, yn, boot, feat_seed,
                                      self.max_depth, self.min_leaf, mf)
        return self
