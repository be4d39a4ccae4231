"""The numpy HeMem engine: a copy of the reference package's
``repro.core.engine`` (``BatchTieringEngine``, ``BatchHeMemEngine``, the
elementwise Poisson draw, and the ``TieringEngine`` / ``HeMemEngine``
``B = 1`` wrappers), trimmed to what
:class:`~repro_torch.core.tiered_params.TieredParamStore` uses: the
elementwise draw is the only sampler, and the simulator's telemetry
(migration costs, rate caps) is left out.

It consumes ``np.random.default_rng`` streams exactly as the reference
does, so placements and plans are bitwise equal to the reference's for the
same seed and trace.  :class:`~repro_torch.core.tiered_params.TieredParamStore`
drives it.  It is not registered in :mod:`repro_torch.core.registry`: the
names ``"hemem"`` and ``"elementwise"`` there belong to the compiled epoch
loop (:mod:`repro_torch.core.engine_torch`); import this module by name.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Sequence, Union

import numpy as np

from .pages import (BatchTierState, MigrationPlan, TierState,
                    migration_rate_pages)

SeedLike = Union[int, Sequence[int]]


def _elementwise_draw(rng: np.random.Generator, base: np.ndarray,
                      period: float) -> np.ndarray:
    """Per-page Poisson draws — bit-identical to the historical sampler."""
    return rng.poisson(base / period).astype(np.float64)


def _as_vec(value, batch: int, dtype=np.float64) -> np.ndarray:
    arr = np.asarray(value, dtype=dtype)
    if arr.ndim == 0:
        return np.full(batch, arr, dtype=dtype)
    assert arr.shape == (batch,), f"expected ({batch},), got {arr.shape}"
    return arr


# ---------------------------------------------------------------------------
# Batched protocol
# ---------------------------------------------------------------------------
class BatchTieringEngine:
    """Protocol: observe true per-page access counts, plan migrations — for a
    whole batch of configurations at once."""

    def __init__(self, configs: Sequence[Mapping[str, Any]],
                 btier: BatchTierState, seeds: SeedLike = 0):
        self.configs = [dict(c) for c in configs]
        self.batch = len(self.configs)
        assert self.batch == btier.batch, "one config per tier-state row"
        self.btier = btier
        self._draw = _elementwise_draw
        if np.ndim(seeds) == 0:
            seeds = [int(seeds)] * self.batch
        self.rngs = [np.random.default_rng(int(s)) for s in seeds]
        # per-epoch, per-config telemetry the simulator reads back
        self.samples_last_epoch = np.zeros(self.batch)
        self.cooling_events = np.zeros(self.batch, dtype=np.int64)

    def _knob(self, name: str, dtype=np.float64) -> np.ndarray:
        return np.array([c[name] for c in self.configs], dtype=dtype)

    def observe(self, reads: np.ndarray, writes: np.ndarray,
                epoch_ms) -> None:
        raise NotImplementedError

    def plan(self, epoch_ms, max_pages_this_epoch) -> List[MigrationPlan]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# HeMem — faithful to §3.2 + Table 2.
# ---------------------------------------------------------------------------
class BatchHeMemEngine(BatchTieringEngine):
    #: normalization of the cooling trigger: one trigger fires per
    #: ``cooling_threshold * n_pages / COOL_UNIT_PAGES`` sampled accesses
    COOL_UNIT_PAGES = 16.0

    def __init__(self, configs, btier, seeds: SeedLike = 0):
        super().__init__(configs, btier, seeds)
        B, n = self.batch, btier.n_pages
        self.read_counts = np.zeros((B, n), dtype=np.float64)
        self.write_counts = np.zeros((B, n), dtype=np.float64)
        self.sampling_period = self._knob("sampling_period")
        self.write_sampling_period = self._knob("write_sampling_period")
        self.read_hot = self._knob("read_hot_threshold")
        self.write_hot = self._knob("write_hot_threshold")
        self.cooling_threshold = self._knob("cooling_threshold")
        self.migration_period_ms = self._knob("migration_period")
        self.max_migration_rate_gibs = self._knob("max_migration_rate")
        self.cooling_pages = self._knob("cooling_pages", dtype=np.int64)
        self.hot_ring = self._knob("hot_ring_reqs_threshold", dtype=np.int64)
        self.cold_ring = self._knob("cold_ring_reqs_threshold", dtype=np.int64)
        # cooling sweep state: cursor into the page space + samples since the
        # last cooling trigger
        self._cool_cursor = np.zeros(B, dtype=np.int64)
        self._samples_since_cool = np.zeros(B)
        self._mig_credit_ms = np.zeros(B)
        self._trigger = np.maximum(
            self.cooling_threshold * n / self.COOL_UNIT_PAGES, 1.0)

    # -- monitoring (PEBS subsampling) -------------------------------------
    def observe(self, reads, writes, epoch_ms):
        # One PEBS sample per `sampling_period` load events (expected value,
        # Poisson-dispersed — the sampling noise is what makes low sampling
        # frequencies inaccurate for GUPS, §4.2).
        B, n = self.batch, self.btier.n_pages
        if not hasattr(self, "_sr"):
            self._sr = np.empty((B, n))
            self._sw = np.empty((B, n))
        sr, sw = self._sr, self._sw
        for b in range(B):
            rng = self.rngs[b]
            sr[b] = self._draw(rng, reads, self.sampling_period[b])
            sw[b] = self._draw(rng, writes, self.write_sampling_period[b])
        self.samples_last_epoch = sr.sum(axis=1) + sw.sum(axis=1)
        # cooling is checked while samples are processed (not by the
        # migration thread): every `cooling_threshold` worth of sampled
        # accesses (normalized per COOL_UNIT_PAGES pages of the working set)
        # fires the trigger, and each trigger cools ONE batch of
        # `cooling_pages` pages, advancing the sweep cursor.  Small
        # `cooling_pages` therefore stagger the sweep across triggers —
        # different pages observe the EMA at different phases — while
        # `cooling_pages >= n` cools everything synchronously ("all pages at
        # the same time", the Silo fix of §4.2).
        self._samples_since_cool += self.samples_last_epoch
        factor = np.ones(B)
        for b in range(B):
            k = int(self._samples_since_cool[b] // self._trigger[b])
            if k <= 0:
                continue
            # samples and cooling interleave within the epoch: a page that
            # gets halved k_eff times mid-accumulation retains factor
            # (2 - 2^-k_eff)/(k_eff + 1) of its newly-added counts
            k_eff = k * min(int(self.cooling_pages[b]), n) / n
            factor[b] = (2.0 - 2.0 ** (-k_eff)) / (k_eff + 1.0)
            # old counts see the k chunked halvings; the new samples arrive
            # interleaved, so they only retain `factor` of their mass
            for _ in range(k):
                self._samples_since_cool[b] -= self._trigger[b]
                self._cool_one_batch(b)
        if (factor != 1.0).any():  # x * 1.0 == x: skipping is exact
            sr *= factor[:, None]
            sw *= factor[:, None]
        self.read_counts += sr
        self.write_counts += sw

    # -- classification ------------------------------------------------------
    def hot_mask(self) -> np.ndarray:
        return (self.read_counts >= self.read_hot[:, None]) | (
            self.write_counts >= self.write_hot[:, None])

    # -- cooling (batched halving, §3.2) --------------------------------------
    def _cool_one_batch(self, b: int) -> None:
        n = self.btier.n_pages
        self.cooling_events[b] += 1
        cur = int(self._cool_cursor[b])
        start = cur if 0 <= cur < n else 0
        end = min(start + int(self.cooling_pages[b]), n)
        sl = slice(start, end)
        self.read_counts[b, sl] *= 0.5
        self.write_counts[b, sl] *= 0.5
        self._cool_cursor[b] = 0 if end >= n else end

    # -- migration thread -------------------------------------------------------
    def plan(self, epoch_ms, max_pages_this_epoch):
        B = self.batch
        epoch_ms = _as_vec(epoch_ms, B)
        max_pages = _as_vec(max_pages_this_epoch, B, dtype=np.int64)
        self._mig_credit_ms += epoch_ms
        runs = (self._mig_credit_ms // self.migration_period_ms).astype(
            np.int64)
        self._mig_credit_ms -= runs * self.migration_period_ms
        if not (runs > 0).any():
            return [MigrationPlan.empty() for _ in range(B)]

        tier = self.btier
        hot_all = self.hot_mask()
        heat_all = self.read_counts + self.write_counts
        fast_free = tier.fast_free
        # batch-wide candidate masks (one (B, n) pass instead of B passes)
        cand_p_mask = hot_all & ~tier.in_fast & tier.allocated
        cand_d_mask = ~hot_all & tier.in_fast
        # migration-rate limit (GiB/s) over the epoch
        rate_vec = migration_rate_pages(self.max_migration_rate_gibs,
                                        epoch_ms, tier.page_bytes)
        watermark = max(1, tier.fast_capacity // 50)
        plans = []
        for b in range(B):
            if runs[b] <= 0:
                plans.append(MigrationPlan.empty())
                continue
            heat = heat_all[b]

            # ring capacities scale with the number of thread runs this epoch
            hot_budget = int(self.hot_ring[b]) * int(runs[b])
            cold_budget = int(self.cold_ring[b]) * int(runs[b])
            rate_pages = min(int(rate_vec[b]), int(max_pages[b]))

            cand_p = np.flatnonzero(cand_p_mask[b])
            if len(cand_p) > hot_budget:  # ring keeps the hottest requests
                cand_p = cand_p[np.argsort(-heat[cand_p],
                                           kind="stable")[:hot_budget]]

            # demotions: HeMem keeps a free-page watermark in DRAM; cold pages
            # are demoted (coldest first) both to satisfy pending promotions
            # and to restore the watermark.  Only *cold* pages are candidates
            # — when the whole working set is hot (e.g. Graph500 BFS), nothing
            # is demoted and migration activity quiesces.
            room = int(fast_free[b])
            pressure = max(0, watermark - room)
            need = max(max(0, len(cand_p) - room), pressure)
            demote = np.zeros(0, dtype=np.int64)
            if need > 0:
                cand_d = np.flatnonzero(cand_d_mask[b])
                if len(cand_d):
                    order = np.argsort(heat[cand_d], kind="stable")
                    demote = cand_d[order[:min(need, cold_budget)]]

            # promotions bounded by (room + demotions) and the rate limit
            n_promote = min(len(cand_p), room + len(demote))
            total_allowed = max(0, rate_pages)
            if n_promote + len(demote) > total_allowed:
                # migration thread moves what the rate allows; demotions make
                # room first (HeMem frees before filling)
                n_demote = min(len(demote), total_allowed)
                demote = demote[:n_demote]
                n_promote = min(n_promote, room + n_demote,
                                total_allowed - n_demote)
            promote = cand_p[np.argsort(-heat[cand_p],
                                        kind="stable")[:n_promote]] \
                if n_promote > 0 else np.zeros(0, dtype=np.int64)
            plans.append(MigrationPlan(promote=promote, demote=demote))
        return plans


# ---------------------------------------------------------------------------
# Single-config wrappers (B=1)
# ---------------------------------------------------------------------------
class TieringEngine:
    """Single-config engine: a thin ``B=1`` wrapper over the batch engine."""

    batch_cls: type = None

    def __init__(self, config: Mapping[str, Any], tier: TierState,
                 seed: int = 0):
        self.config = dict(config)
        self.tier = tier
        self._b = self.batch_cls([self.config], tier.batch_state,
                                 seeds=seed)

    # per-epoch telemetry
    @property
    def samples_last_epoch(self) -> float:
        return float(self._b.samples_last_epoch[0])

    @property
    def cooling_events(self) -> int:
        return int(self._b.cooling_events[0])

    def observe(self, reads: np.ndarray, writes: np.ndarray,
                epoch_ms: float) -> None:
        self._b.observe(reads, writes, np.array([float(epoch_ms)]))

    def plan(self, epoch_ms: float, max_pages_this_epoch: int) -> MigrationPlan:
        return self._b.plan(np.array([float(epoch_ms)]),
                            np.array([int(max_pages_this_epoch)]))[0]


class HeMemEngine(TieringEngine):
    batch_cls = BatchHeMemEngine

    @property
    def read_counts(self) -> np.ndarray:
        return self._b.read_counts[0]

    @property
    def write_counts(self) -> np.ndarray:
        return self._b.write_counts[0]

    def hot_mask(self) -> np.ndarray:
        return self._b.hot_mask()[0]
