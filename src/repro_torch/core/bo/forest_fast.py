"""Array-native random-forest fit + EI acquisition (the BO hot path), numpy.

A copy of the reference package's numpy path:

* :func:`fit_forest_fast` — level-synchronous CART growth: one vectorized
  numpy pass per depth level evaluates the exact best splits for all
  ``trees x frontier nodes x sampled features`` at once and emits flat
  ``(T, max_nodes)`` arrays (``feature/threshold/left/right/value``).
* :func:`predict_forest` — batched gather-based descent: every candidate
  row walks all ``T`` trees level-synchronously on the flat arrays.
* :func:`suggest_topq` — the acquisition: tree descent + mean/std moments
  + vectorized-erf Expected Improvement + top-q selection by stable sort.
  (The acquisition on the card is ROADMAP queue 1, item "BO acquisition
  on the GPU".)

Determinism contract (the ``surrogate="reference"|"fast"`` switch in
:mod:`repro_torch.core.bo.rf` relies on it): both growers consume
identical randomness — the bootstrap matrix is drawn up front by the
caller, and the per-node feature subsets come from :func:`feature_subsets`,
a counter-based splitmix64 hash of ``(seed, tree, heap-node)`` — so the
recursive reference grower (DFS order) and this level-synchronous grower
(BFS order) produce bit-identical trees.

EI scores are cast to float32 before top-q selection, as the reference
does, so ties break by candidate index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

#: node-variance floor below which a node is a leaf (matches the historical
#: ``y.std() < 1e-12`` termination: var < 1e-24)
_MIN_NODE_VAR = 1e-24

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


# ---------------------------------------------------------------------------
# counter-based feature subsets (shared by both growers)
# ---------------------------------------------------------------------------

_U = np.uint64


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on uint64 arrays (wrapping arithmetic)."""
    x = (x + _U(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> _U(30))) * _U(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U(27))) * _U(0x94D049BB133111EB)
    return x ^ (x >> _U(31))


def feature_subsets(feat_seed: int, tree, heap, d: int, mf: int) -> np.ndarray:
    """Deterministic feature subset for the split attempt at heap node
    ``heap`` (root = 1, children ``2h``/``2h+1``) of tree ``tree``.

    Returns the first ``mf`` positions of a pseudo-random permutation of
    ``range(d)`` — the SAME permutation regardless of the order nodes are
    visited in, which is what lets a DFS reference grower and the BFS
    fast grower agree bit-for-bit.  ``tree``/``heap`` may be scalars or
    equal-shape arrays; the result gains a trailing ``(mf,)`` axis.
    """
    tree = np.asarray(tree, dtype=np.uint64)
    heap = np.asarray(heap, dtype=np.uint64)
    j = np.arange(d, dtype=np.uint64)
    key = (_U(feat_seed)
           ^ _mix64(tree[..., None] * _U(0x9E3779B97F4A7C15)
                    + heap[..., None] * _U(0xC2B2AE3D27D4EB4F)
                    + j))
    order = np.argsort(_mix64(key), axis=-1, kind="stable")
    return order[..., :mf].astype(np.int64)


# ---------------------------------------------------------------------------
# flat forest container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlatForest:
    """A fitted forest as flat per-tree node arrays (DFS pre-order).

    Leaves have ``feature < 0``; padding slots beyond ``n_nodes[t]`` are
    leaves too and are never reached by descent (descent starts at node 0).
    """

    feature: np.ndarray    # (T, M) int64, -1 = leaf
    threshold: np.ndarray  # (T, M) float64
    left: np.ndarray       # (T, M) int64
    right: np.ndarray      # (T, M) int64
    value: np.ndarray      # (T, M) float64 (normalized-target leaf means)
    n_nodes: np.ndarray    # (T,) int64
    max_depth: int


# ---------------------------------------------------------------------------
# level-synchronous fit
# ---------------------------------------------------------------------------


def _pack_rows(mem: np.ndarray, cond: np.ndarray) -> Tuple[np.ndarray,
                                                           np.ndarray]:
    """Per row: member ids where ``cond``, packed left in order, -1 padded."""
    order = np.argsort(~cond, axis=1, kind="stable")
    packed = np.take_along_axis(mem, order, axis=1)
    sizes = cond.sum(axis=1)
    keep = np.arange(mem.shape[1])[None, :] < sizes[:, None]
    return np.where(keep, packed, -1), sizes


def fit_forest_fast(X: np.ndarray, y: np.ndarray, boot: np.ndarray,
                    feat_seed: int, max_depth: int, min_leaf: int,
                    max_features: int) -> FlatForest:
    """Grow all ``T`` trees level-synchronously from pre-drawn bootstraps.

    One vectorized pass per depth level: every frontier node of every tree
    sorts its samples along every feature, computes exact split SSE scores
    from padded sequential cumsums (bit-identical to the per-node reference
    arithmetic), picks the best (score, subset-position, position-in-sort)
    lexicographically, and partitions.  Nodes are emitted in creation (BFS)
    order and renumbered to DFS pre-order at the end so the flat arrays are
    directly comparable with a recursive reference grower's.
    """
    T, n = boot.shape
    d = X.shape[1]
    mf = min(max_features, d)
    Xb = X[boot]                      # (T, n, d)
    yb = y[boot]                      # (T, n)

    rec_tree, rec_feat, rec_thr = [], [], []
    rec_left, rec_right, rec_val = [], [], []
    next_id = T

    f_tree = np.arange(T, dtype=np.int64)
    f_heap = np.ones(T, dtype=np.uint64)
    f_mem = np.tile(np.arange(n, dtype=np.int64)[None, :], (T, 1))
    f_size = np.full(T, n, dtype=np.int64)

    depth = 0
    while f_tree.size:
        K, L = f_mem.shape
        ar = np.arange(K)
        valid = f_mem >= 0
        memc = np.maximum(f_mem, 0)
        yn = np.where(valid, yb[f_tree[:, None], memc], 0.0)
        c1 = np.cumsum(yn, axis=1)
        c2 = np.cumsum(yn * yn, axis=1)
        tot1 = c1[ar, f_size - 1]
        tot2 = c2[ar, f_size - 1]
        node_val = tot1 / f_size
        sse = tot2 - tot1 ** 2 / f_size
        attempt = ((depth < max_depth) & (f_size >= 2 * min_leaf)
                   & (sse >= f_size * _MIN_NODE_VAR))

        feat_out = np.full(K, -1, dtype=np.int64)
        thr_out = np.zeros(K)
        left_out = np.full(K, -1, dtype=np.int64)
        right_out = np.full(K, -1, dtype=np.int64)

        new_tree = new_heap = new_mem = new_size = None
        S = np.flatnonzero(attempt)
        if S.size:
            s = S.size
            sizes_s = f_size[S]
            feats = feature_subsets(feat_seed, f_tree[S], f_heap[S], d, mf)
            # gather ONLY each node's sampled feature columns: (s, L, mf)
            Xn = np.where(valid[S][:, :, None],
                          Xb[f_tree[S][:, None, None], memc[S][:, :, None],
                             feats[:, None, :]], np.inf)
            yn_s = yn[S]
            order = np.argsort(Xn, axis=1, kind="stable")
            xs = np.take_along_axis(Xn, order, axis=1)
            ys = np.take_along_axis(
                np.broadcast_to(yn_s[:, :, None], Xn.shape), order, axis=1)
            cs1 = np.cumsum(ys, axis=1)
            cs2 = np.cumsum(ys ** 2, axis=1)
            lastix = np.broadcast_to((sizes_s - 1)[:, None, None], (s, 1, mf))
            t1 = np.take_along_axis(cs1, lastix, axis=1)       # (s, 1, mf)
            t2 = np.take_along_axis(cs2, lastix, axis=1)

            kk = np.arange(1, L, dtype=np.int64)               # left counts
            nr = sizes_s[:, None] - kk[None, :]                # (s, L-1)
            nr_safe = np.maximum(nr, 1)
            left_sse = cs2[:, :-1, :] - cs1[:, :-1, :] ** 2 / kk[None, :, None]
            right_sse = ((t2 - cs2[:, :-1, :])
                         - (t1 - cs1[:, :-1, :]) ** 2
                         / nr_safe[:, :, None])
            ok = ((kk[None, :] >= min_leaf)
                  & (kk[None, :] <= sizes_s[:, None] - min_leaf))
            ok3 = ok[:, :, None] & (xs[:, :-1, :] < xs[:, 1:, :])
            scores = np.where(ok3, left_sse + right_sse, np.inf)

            jbest = np.argmin(scores, axis=1)                  # (s, mf)
            smin = np.take_along_axis(scores, jbest[:, None, :],
                                      axis=1)[:, 0, :]         # (s, mf)
            fpos = np.argmin(smin, axis=1)       # first-min in subset order
            best_score = smin[np.arange(s), fpos]
            has_split = np.isfinite(best_score)
            fbest = feats[np.arange(s), fpos]
            kbest = jbest[np.arange(s), fpos] + 1              # left count
            lo_x = xs[np.arange(s), kbest - 1, fpos]
            hi_x = xs[np.arange(s), kbest, fpos]
            thr = 0.5 * (lo_x + hi_x)

            S2 = np.flatnonzero(has_split)
            if S2.size:
                s2 = S2.size
                rowsS = S[S2]
                xf = np.take_along_axis(
                    Xn[S2], fpos[S2][:, None, None], axis=2)[:, :, 0]
                go_left = xf <= thr[S2][:, None]
                condL = valid[rowsS] & go_left
                condR = valid[rowsS] & ~go_left
                memL, nL = _pack_rows(f_mem[rowsS], condL)
                memR, nR = _pack_rows(f_mem[rowsS], condR)

                left_ids = next_id + 2 * np.arange(s2, dtype=np.int64)
                right_ids = left_ids + 1
                next_id += 2 * s2
                feat_out[rowsS] = fbest[S2]
                thr_out[rowsS] = thr[S2]
                left_out[rowsS] = left_ids
                right_out[rowsS] = right_ids

                Lnew = int(max(nL.max(), nR.max()))
                new_tree = np.repeat(f_tree[rowsS], 2)
                new_heap = np.empty(2 * s2, dtype=np.uint64)
                new_heap[0::2] = f_heap[rowsS] * _U(2)
                new_heap[1::2] = f_heap[rowsS] * _U(2) + _U(1)
                new_mem = np.empty((2 * s2, Lnew), dtype=np.int64)
                new_mem[0::2] = memL[:, :Lnew]
                new_mem[1::2] = memR[:, :Lnew]
                new_size = np.empty(2 * s2, dtype=np.int64)
                new_size[0::2] = nL
                new_size[1::2] = nR

        rec_tree.append(f_tree)
        rec_feat.append(feat_out)
        rec_thr.append(thr_out)
        rec_left.append(left_out)
        rec_right.append(right_out)
        rec_val.append(node_val)

        if new_tree is None:
            break
        f_tree, f_heap, f_mem, f_size = new_tree, new_heap, new_mem, new_size
        depth += 1

    tree_all = np.concatenate(rec_tree)
    feat_all = np.concatenate(rec_feat)
    thr_all = np.concatenate(rec_thr)
    left_all = np.concatenate(rec_left)
    right_all = np.concatenate(rec_right)
    val_all = np.concatenate(rec_val)

    # DFS pre-order renumbering, level-synchronously: subtree sizes flow
    # bottom-up, then pre-order indices top-down (left = parent + 1,
    # right = parent + 1 + size(left subtree)) — no per-node Python walk.
    level_ids = []
    start = 0
    for level in rec_tree:
        level_ids.append(np.arange(start, start + level.size))
        start += level.size
    split = feat_all >= 0
    size_all = np.ones(start, dtype=np.int64)
    for ids in reversed(level_ids):
        s = ids[split[ids]]
        size_all[s] = 1 + size_all[left_all[s]] + size_all[right_all[s]]
    dfs_all = np.zeros(start, dtype=np.int64)
    for ids in level_ids:
        s = ids[split[ids]]
        dfs_all[left_all[s]] = dfs_all[s] + 1
        dfs_all[right_all[s]] = dfs_all[s] + 1 + size_all[left_all[s]]

    counts = np.bincount(tree_all, minlength=T)
    M = int(counts.max())
    F = np.full((T, M), -1, dtype=np.int64)
    TH = np.zeros((T, M))
    LC = np.full((T, M), -1, dtype=np.int64)
    RC = np.full((T, M), -1, dtype=np.int64)
    V = np.zeros((T, M))
    F[tree_all, dfs_all] = feat_all
    TH[tree_all, dfs_all] = thr_all
    V[tree_all, dfs_all] = val_all
    LC[tree_all[split], dfs_all[split]] = dfs_all[left_all[split]]
    RC[tree_all[split], dfs_all[split]] = dfs_all[right_all[split]]
    return FlatForest(feature=F, threshold=TH, left=LC, right=RC, value=V,
                      n_nodes=counts.astype(np.int64), max_depth=max_depth)


# ---------------------------------------------------------------------------
# batched descent (numpy)
# ---------------------------------------------------------------------------


def predict_forest(forest: FlatForest, X: np.ndarray,
                   trees: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-tree predictions ``(T, N)`` via level-synchronous gather descent.

    All rows of ``X`` walk all trees at once; leaf assignment is identical
    to the per-row reference walk (the comparisons are the same).  ``trees``
    restricts descent to a subset of tree indices (used by the legacy
    per-tree scoring path kept for ablation).
    """
    F, TH = forest.feature, forest.threshold
    LC, RC, V = forest.left, forest.right, forest.value
    if trees is not None:
        F, TH = F[trees], TH[trees]
        LC, RC, V = LC[trees], RC[trees], V[trees]
    T = F.shape[0]
    N = X.shape[0]
    idx = np.zeros((T, N), dtype=np.int64)
    rows = np.arange(T)[:, None]
    cols = np.arange(N)[None, :]
    while True:
        f = F[rows, idx]
        live = f >= 0
        if not live.any():
            break
        xv = X[cols, np.maximum(f, 0)]
        nxt = np.where(xv <= TH[rows, idx], LC[rows, idx], RC[rows, idx])
        idx = np.where(live, nxt, idx)
    return V[rows, idx]


# ---------------------------------------------------------------------------
# vectorized erf / EI (numpy)
# ---------------------------------------------------------------------------


def erf(z: np.ndarray) -> np.ndarray:
    """Vectorized erf via Abramowitz-Stegun 7.1.26 (|error| <= 1.5e-7).

    Replaces the historical ``np.vectorize(math.erf)`` Python loop; the
    agreement with ``math.erf`` is pinned to <= 1e-6 in tests/test_bo.py.
    """
    z = np.asarray(z, dtype=np.float64)
    sign = np.sign(z)
    x = np.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592
                + t * (-0.284496736
                       + t * (1.421413741
                              + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * np.exp(-x * x))


def norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + erf(np.asarray(z, dtype=np.float64) / _SQRT2))


def norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) * _INV_SQRT_2PI


def expected_improvement(mean: np.ndarray, std: np.ndarray,
                         best: float) -> np.ndarray:
    """EI for *minimization* (vectorized; no Python loop per candidate)."""
    std = np.maximum(std, 1e-12)
    z = (best - mean) / std
    return (best - mean) * norm_cdf(z) + std * norm_pdf(z)


def _moments(preds: np.ndarray, y_mean: float,
             y_std: float) -> Tuple[np.ndarray, np.ndarray]:
    mean = preds.mean(axis=0) * y_std + y_mean
    std = preds.std(axis=0) * y_std
    return mean, np.maximum(std, 1e-9 * abs(y_std))


# ---------------------------------------------------------------------------
# acquisition: descent + moments + EI + top-q
# ---------------------------------------------------------------------------


def suggest_topq(forest: FlatForest, X: np.ndarray, best: float,
                 y_mean: float, y_std: float,
                 valid: Optional[np.ndarray] = None, q: int = 1
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Score a candidate pool and select the top-``q`` EI candidates.

    Returns ``(ei32, selected)`` where ``ei32`` is the float32 EI per pool
    row (the selection key) and ``selected`` are up to ``q`` row indices,
    ordered by EI descending with index tie-break — the prefix of
    ``np.argsort(-ei, kind="stable")`` over ``valid`` rows.
    """
    if valid is None:
        valid = np.ones(X.shape[0], dtype=bool)
    preds = predict_forest(forest, X)
    mean, std = _moments(preds, y_mean, y_std)
    ei32 = expected_improvement(mean, std, best).astype(np.float32)
    order = np.argsort(-ei32, kind="stable")
    picked = order[valid[order]][:q]
    return ei32, picked
