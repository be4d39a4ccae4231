"""SMAC-style Bayesian optimizer (§3.1), with batched suggestions (a copy
of the reference package's optimizer, whose model phase scores its pool on
the card).

Sequential Model-based Algorithm Configuration [18]: random-forest surrogate
+ Expected-Improvement acquisition, with (1) an initial random design and
(2) periodic random interleaving, exactly as the paper configures it
(budget 100, 20 initial random, 20 % random-config probability, §4.1).

Candidate generation follows SMAC's local-search-plus-random scheme: EI is
maximized over Gaussian neighbours of the best-seen configurations plus a
pool of fresh uniform samples.

**Batch mode** (:meth:`SMACOptimizer.ask_batch` / ``tell_batch``) suggests q
configurations per round so a vectorized objective
(:func:`repro_torch.core.simulator.run_simulation_batch`) can evaluate the
whole candidate batch in one simulator pass.  Exploration slots (the default
config, the initial random design and the random interleave) are filled
exactly as the sequential schedule would; the remaining slots take the
**top-q EI** candidates (deduplicated) from one shared candidate pool.
At ``q=1`` the batch path delegates to :meth:`ask`, so histories are
bit-identical to sequential runs.

The model phase is array-native: candidate pools are generated directly
as encoded unit-cube matrices (:meth:`KnobSpace.neighbors_batch` /
``sample_batch_encoded``), deduplicated in encoded space, and scored +
top-q-selected by one function
(:func:`repro_torch.core.bo.forest_fast.suggest_topq`: batched tree
descent, moments, EI and the exact top-q; on a CUDA ``device`` one torch
function ending in the ``select_topk`` kernel, on the CPU numpy); only the
q returned suggestions are decoded to dicts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Mapping, Optional

import numpy as np

from ..knobs import Config, KnobSpace
from . import forest_fast
from .rf import RandomForest


@dataclasses.dataclass
class Observation:
    config: Config
    value: float


class SMACOptimizer:
    def __init__(self, space: KnobSpace, seed: int = 0,
                 n_init: int = 20, random_prob: float = 0.20,
                 n_candidates: int = 512, n_local_parents: int = 4,
                 n_trees: int = 24, start_with_default: bool = True,
                 device="cuda"):
        """``device`` is where the model phase scores its candidate pool
        (:func:`~repro_torch.core.bo.forest_fast.acquisition_backend`):
        the card for a CUDA device, numpy on the host for the CPU."""
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_init = n_init
        self.random_prob = random_prob
        self.n_candidates = n_candidates
        self.n_local_parents = n_local_parents
        self.n_trees = n_trees
        self.start_with_default = start_with_default
        self.observations: List[Observation] = []
        self._surrogate: Optional[RandomForest] = None
        self.device = device
        #: cumulative surrogate-fit wall clock (the tuner's per-round
        #: fit/acquisition breakdown reads deltas of this)
        self.fit_s = 0.0

    # -- bookkeeping ---------------------------------------------------------
    @property
    def best(self) -> Observation:
        return min(self.observations, key=lambda o: o.value)

    def tell(self, config: Mapping[str, Any], value: float) -> None:
        self.observations.append(
            Observation(self.space.validate(config), float(value)))
        self._surrogate = None  # invalidate

    @staticmethod
    def _config_key(config: Mapping[str, Any]):
        return tuple(sorted(config.items()))

    def tell_batch(self, configs, values, crn: bool = False) -> None:
        """Record one batched evaluation round, in order.

        ``crn=True`` marks the round as evaluated under common random
        numbers (all configs shared one noise draw, e.g.
        ``SimOptions(crn=True)``).  If the round re-evaluated any
        already-observed config, the mean difference between its new and
        first recorded values estimates the round's shared noise offset,
        and the whole round is debiased by it before being recorded.
        Otherwise (or with ``crn=False``) values are recorded unchanged.
        """
        if len(configs) != len(values):
            raise ValueError("configs and values must have equal length")
        configs = [self.space.validate(c) for c in configs]
        offset = 0.0
        if crn and self.observations:
            recorded = {}
            for o in self.observations:
                recorded.setdefault(self._config_key(o.config), o.value)
            deltas = [float(v) - recorded[self._config_key(c)]
                      for c, v in zip(configs, values)
                      if self._config_key(c) in recorded]
            if deltas:
                offset = float(np.mean(deltas))
        for cfg, val in zip(configs, values):
            self.tell(cfg, float(val) - offset)

    # -- surrogate ------------------------------------------------------------
    def surrogate(self) -> RandomForest:
        if self._surrogate is None:
            t0 = time.perf_counter()
            X = np.stack([self.space.encode(o.config)
                          for o in self.observations])
            y = np.array([o.value for o in self.observations])
            self._surrogate = RandomForest(
                n_trees=self.n_trees,
                seed=int(self.rng.integers(2 ** 31))).fit(X, y)
            self.fit_s += time.perf_counter() - t0
        return self._surrogate

    # -- suggestion -----------------------------------------------------------
    def ask(self) -> Config:
        n_seen = len(self.observations)
        if n_seen == 0 and self.start_with_default:
            return self.space.default_config()  # paper: start from default
        if n_seen < self.n_init:
            return self.space.sample(self.rng)
        if self.rng.uniform() < self.random_prob:
            return self.space.sample(self.rng)  # forced random interleave

        model = self.surrogate()
        best_val = self.best.value
        X = self._candidate_pool_encoded(self.n_candidates)
        _, sel = forest_fast.suggest_topq(
            model.forest, X, best_val, model._y_mean, model._y_std, q=1,
            device=self.device)
        return self.space.decode_batch(X[sel])[0]

    def _candidate_pool_encoded(self, n_candidates: int) -> np.ndarray:
        """Local neighbours of the best parents + fresh uniform samples,
        generated directly as canonical encoded unit rows (no dicts)."""
        parents = sorted(self.observations, key=lambda o: o.value)
        parents = parents[:self.n_local_parents]
        blocks: List[np.ndarray] = []
        count = 0
        per_parent = max(4, n_candidates // (2 * len(parents)))
        for p in parents:
            x = self.space.encode(p.config)
            blocks.append(self.space.neighbors_batch(x, self.rng,
                                                     n=per_parent,
                                                     scale=0.12))
            blocks.append(self.space.neighbors_batch(x, self.rng,
                                                     n=per_parent // 2,
                                                     scale=0.35))
            count += per_parent + per_parent // 2
        blocks.append(self.space.sample_batch_encoded(
            self.rng, max(8, n_candidates - count)))
        return np.concatenate(blocks, axis=0)

    def ask_batch(self, q: int) -> List[Config]:
        """Suggest ``q`` configs for one batched evaluation round.

        Slots that the sequential schedule would spend on exploration
        (default config, initial random design, random interleaving) stay
        exploratory; the rest are the top-``q`` EI candidates from one
        shared pool.  ``q=1`` delegates to :meth:`ask`, preserving
        bit-identical sequential histories.
        """
        if q < 1:
            raise ValueError("q must be >= 1")
        if q == 1:
            return [self.ask()]
        out: List[Config] = []
        n_seen = len(self.observations)
        while len(out) < q and n_seen + len(out) < self.n_init:
            if n_seen + len(out) == 0 and self.start_with_default:
                out.append(self.space.default_config())
            else:
                out.append(self.space.sample(self.rng))
        n_model = 0
        for _ in range(q - len(out)):
            if len(self.observations) < 2 or \
                    self.rng.uniform() < self.random_prob:
                # forced interleave — or nothing observed yet to model
                out.append(self.space.sample(self.rng))
            else:
                n_model += 1
        if n_model == 0:
            return out
        model = self.surrogate()
        best_val = self.best.value
        X = self._candidate_pool_encoded(max(self.n_candidates,
                                             64 * n_model))
        # canonical rows are config fixpoints, so deduplication is a
        # first-occurrence mask in encoded space
        _, first = np.unique(X, axis=0, return_index=True)
        valid = np.zeros(len(X), dtype=bool)
        valid[first] = True
        _, sel = forest_fast.suggest_topq(
            model.forest, X, best_val, model._y_mean, model._y_std,
            valid=valid, q=n_model, device=self.device)
        out.extend(self.space.decode_batch(X[sel]))
        while len(out) < q:  # pool exhausted by dedup: fall back to random
            out.append(self.space.sample(self.rng))
        return out


class RandomSearch:
    """Unguided baseline the paper contrasts BO against (§3)."""

    def __init__(self, space: KnobSpace, seed: int = 0,
                 start_with_default: bool = True):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.start_with_default = start_with_default
        self.observations: List[Observation] = []

    @property
    def best(self) -> Observation:
        return min(self.observations, key=lambda o: o.value)

    def ask(self) -> Config:
        # default first, then uniform
        first = len(self.observations) == 0
        return (self.space.default_config()
                if first and self.start_with_default
                else self.space.sample(self.rng))

    def tell(self, config: Mapping[str, Any], value: float) -> None:
        self.observations.append(Observation(dict(config), float(value)))

    def ask_batch(self, q: int) -> List[Config]:
        out = []
        for j in range(q):
            first = len(self.observations) + j == 0
            out.append(self.space.default_config()
                       if first and self.start_with_default
                       else self.space.sample(self.rng))
        return out

    def tell_batch(self, configs, values, crn: bool = False) -> None:
        # crn is accepted for interface parity with SMACOptimizer; an
        # unguided search has no model to debias for
        if len(configs) != len(values):
            raise ValueError("configs and values must have equal length")
        for cfg, val in zip(configs, values):
            self.observations.append(Observation(dict(cfg), float(val)))
