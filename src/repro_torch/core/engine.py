"""Tiering engines, batched over tuning candidates.

:class:`BatchHeMemEngine` is the faithful reimplementation of the mechanism
the paper tunes (§3.2): PEBS-subsampled per-page read/write counters, separate
read/write hotness thresholds, batched count cooling, and a periodic migration
thread with ring-capacity and migration-rate limits.  Every knob of paper
Table 2 is honoured.

:class:`BatchHMSDKEngine` models HMSDK's DAMON-based region monitor (§4.5):
the address space is split into ``nr_regions`` regions, one page per region is
probed per sampling interval, and whole regions are promoted/demoted.  DAMON's
core assumption — all pages of a region share an access frequency — is kept,
which is exactly what makes it fail on GUPS (paper Fig. 12).

:class:`BatchMemtisEngine` models the Memtis baseline (§4.6): the hot
threshold is *dynamically* adapted so the hot set matches fast-tier capacity,
a warm class is excluded from migration, but the cooling period, the migration
period and the (very high, 100k) write sampling period remain static.

:class:`BatchStaticEngine` (first-touch, never migrates) and
:class:`BatchOracleEngine` (clairvoyant placement, free migrations — a
CH_opt-style bound [49]) are the reference points.

Every engine carries a leading **batch axis**: state arrays are
``(B, n_pages)`` and per-config knobs are ``(B,)`` vectors, so one
``observe``/``plan`` round advances B tuning candidates through the same
workload trace.  The historical single-config classes (:class:`HeMemEngine`,
…) remain as thin ``B=1`` wrappers so existing callers don't change.

Two sampling backends are provided (``sampler=``):

* ``"elementwise"`` — per-page ``rng.poisson`` draws, bit-identical to the
  historical implementation (the default for single-config runs);
* ``"sparse"`` — exact-distribution Poisson via superposition: per-page draws
  only where the rate is high, plus total-count + inverse-CDF placement for
  the long cold tail.  Cost scales with *sampled events*, not pages, which is
  what makes batched tuning sweeps fast.

**Two-backend contract.**  The engines in this module are the **numpy
backend** (``backend="numpy"``): they consume sequential
``np.random.default_rng`` streams exactly as the reference package's do, so
every result is bitwise the reference's numpy backend (batch == sequential,
both samplers equal in distribution).  The default ``backend="torch"`` runs
the compiled re-implementation of the same six engines
(:mod:`repro_torch.core.engine_torch`): one epoch loop on a torch device,
with counter-based monitoring draws -- equal in distribution but not
stream-compatible, so cross-backend comparisons are statistical for the
sampled engines; migration-plan *selection* itself is exact (the
``select_topk`` kernel reproduces this module's stable sorts bit for bit).
Changes to the migration/classification logic here must be mirrored there.

Engines and samplers are looked up through :mod:`repro_torch.core.registry`
(``@register_engine`` / ``register_sampler``), so new policies plug into
``Study``/``make_batch_engine`` without touching any dispatch code here
(custom engines run on the numpy epoch loop; the compiled loop covers the
engines with a registered :class:`~repro_torch.core.engine_torch.EngineDef`).
:class:`~repro_torch.core.tiered_params.TieredParamStore` drives
:class:`HeMemEngine` directly.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Sequence, Union

import numpy as np

from .knobs import HEMEM_SPACE
from .pages import (BatchTierState, MigrationPlan, TierState,
                    migration_rate_pages)
from .registry import (ENGINES as ENGINE_REGISTRY, SAMPLERS, register_engine,
                       register_sampler)

SeedLike = Union[int, Sequence[int]]

#: rate at/above which the sparse sampler falls back to per-page draws
SPARSE_DENSE_LAM = 4.0


def sparse_poisson(rng: np.random.Generator, base: np.ndarray,
                   inv_period: float) -> np.ndarray:
    """Exact Poisson(``base * inv_period``) sample with cost ∝ events.

    Pages with rate >= :data:`SPARSE_DENSE_LAM` draw per-page Poisson; the
    cold tail draws one total count N ~ Poisson(Σλ) and places the N events
    by inverse-CDF lookup.  By Poisson superposition/splitting the joint
    distribution equals elementwise sampling exactly — only the
    random-stream consumption differs.
    """
    lam = base * inv_period
    n = lam.shape[0]
    if float(lam.sum()) > float(n):
        # not sparse for this config (aggressive sampling period): per-event
        # placement would cost more than per-page draws, so use elementwise
        # directly.  The branch depends only on this config's rates, so
        # per-config streams stay reproducible at any batch size.
        return rng.poisson(lam).astype(np.float64)
    out = np.zeros(n, dtype=np.float64)
    dense = lam >= SPARSE_DENSE_LAM
    idx_d = np.flatnonzero(dense)
    if idx_d.size:
        out[idx_d] = rng.poisson(lam[idx_d])
    lam_c = np.where(dense, 0.0, lam)
    csum = np.cumsum(lam_c)
    tot = float(csum[-1])
    if tot > 0.0:
        n_events = int(rng.poisson(tot))
        if n_events:
            u = rng.uniform(0.0, tot, size=n_events)
            pos = np.searchsorted(csum, u, side="right")
            np.clip(pos, 0, n - 1, out=pos)
            out += np.bincount(pos, minlength=n)
    return out


def _elementwise_draw(rng: np.random.Generator, base: np.ndarray,
                      period: float) -> np.ndarray:
    """Per-page Poisson draws — bit-identical to the historical sampler."""
    return rng.poisson(base / period).astype(np.float64)


def _sparse_draw(rng: np.random.Generator, base: np.ndarray,
                 period: float) -> np.ndarray:
    """Exact-distribution event-driven sampler (see :func:`sparse_poisson`)."""
    return sparse_poisson(rng, base, 1.0 / period)


register_sampler("elementwise", _elementwise_draw)
register_sampler("sparse", _sparse_draw)


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

    #: if True, the simulator charges no bandwidth/stall cost for migrations
    zero_cost_migrations = False

    def __init__(self, configs: Sequence[Mapping[str, Any]],
                 btier: BatchTierState, seeds: SeedLike = 0,
                 sampler: str = "elementwise"):
        self.configs = [dict(c) for c in configs]
        self.batch = len(self.configs)
        assert self.batch == btier.batch, "one config per tier-state row"
        self.btier = btier
        self._draw = SAMPLERS.get(sampler)
        self.sampler = sampler
        if np.ndim(seeds) == 0:
            seeds = [int(seeds)] * self.batch
        self.rngs = [np.random.default_rng(int(s)) for s in seeds]
        # per-epoch, per-config telemetry the simulator reads back
        self.samples_last_epoch = np.zeros(self.batch)
        self.overhead_ms_last_epoch = np.zeros(self.batch)
        self.cooling_events = np.zeros(self.batch, dtype=np.int64)

    def _knob(self, name: str, dtype=np.float64) -> np.ndarray:
        return np.array([c[name] for c in self.configs], dtype=dtype)

    def max_rates_gibs(self) -> np.ndarray:
        """Per-config migration-rate caps (GiB/s) for the simulator."""
        return np.array([float(c.get("max_migration_rate", 1e9))
                         for c in self.configs])

    def observe(self, reads: np.ndarray, writes: np.ndarray,
                epoch_ms) -> None:
        raise NotImplementedError

    def plan(self, epoch_ms, max_pages_this_epoch) -> List[MigrationPlan]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# HeMem — faithful to §3.2 + Table 2.
# ---------------------------------------------------------------------------
@register_engine("hemem")
class BatchHeMemEngine(BatchTieringEngine):
    #: normalization of the cooling trigger: one trigger fires per
    #: ``cooling_threshold * n_pages / COOL_UNIT_PAGES`` sampled accesses
    COOL_UNIT_PAGES = 16.0

    def __init__(self, configs, btier, seeds: SeedLike = 0,
                 sampler: str = "elementwise"):
        super().__init__(configs, btier, seeds, sampler)
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


def _mean_draw(rng, base, period):
    """Deterministic mean 'sampler': exactly ``base / period`` accesses per
    page, no dispersion.  The monitoring model of the tiered-KV serving
    engine, whose per-page access counts (attention mass) are measured
    exactly by the attention kernel rather than PEBS-sampled."""
    return np.asarray(base, dtype=np.float64) / float(period)


# ---------------------------------------------------------------------------
# kv-hemem — the TieredKVCache's HeMem analog (serving).  Same Table-2
# machinery as HeMem; monitoring is deterministic mean sampling (see
# _mean_draw).  The compiled counterpart is engine_torch.KVHeMemDef, so
# backend="torch" compiles this engine instead of warning and falling
# back.
# ---------------------------------------------------------------------------
@register_engine("kv-hemem", space=HEMEM_SPACE)
class BatchKVHeMemEngine(BatchHeMemEngine):
    """Batched kv-hemem: :class:`BatchHeMemEngine` with deterministic mean
    monitoring draws (the registered ``sampler`` is accepted but unused —
    serving measures its access counts exactly)."""

    def __init__(self, configs, btier, seeds: SeedLike = 0,
                 sampler: str = "elementwise"):
        super().__init__(configs, btier, seeds, sampler)
        self._draw = _mean_draw


# ---------------------------------------------------------------------------
# HMSDK / DAMON — region-based monitor (§4.5).
# ---------------------------------------------------------------------------
@register_engine("hmsdk")
class BatchHMSDKEngine(BatchTieringEngine):
    def __init__(self, configs, btier, seeds: SeedLike = 0,
                 sampler: str = "elementwise"):
        super().__init__(configs, btier, seeds, sampler)
        if sampler not in ("elementwise", "sparse"):
            # DAMON probes are region-Bernoulli draws, not the per-page
            # Poisson protocol custom samplers implement; reject rather than
            # silently ignoring the registered sampler
            raise ValueError(
                f"hmsdk supports only the builtin 'elementwise'/'sparse' "
                f"samplers, not {sampler!r}")
        B, n = self.batch, btier.n_pages
        self.nr_regions = np.minimum(self._knob("nr_regions", dtype=np.int64),
                                     n)
        self.sample_us = self._knob("sample_us")
        self.aggr_us = self._knob("aggr_us")
        self.hot_access_pct = self._knob("hot_access_pct")
        self.cold_aggr_intervals = self._knob("cold_aggr_intervals",
                                              dtype=np.int64)
        self.migration_period_ms = self._knob("migration_period")
        self.max_migration_rate_gibs = self._knob("max_migration_rate")
        # equal-size regions over the page index space (per config: region
        # counts differ, so the region maps are ragged across the batch)
        self.region_lo: List[np.ndarray] = []
        self.region_hi: List[np.ndarray] = []
        self.region_of_page: List[np.ndarray] = []
        self.nr_accesses: List[np.ndarray] = []
        self.idle_intervals: List[np.ndarray] = []
        for b in range(B):
            R = int(self.nr_regions[b])
            bounds = np.linspace(0, n, R + 1).astype(np.int64)
            self.region_lo.append(bounds[:-1])
            self.region_hi.append(bounds[1:])
            self.region_of_page.append(
                np.searchsorted(bounds[1:], np.arange(n), side="right"))
            self.nr_accesses.append(np.zeros(R, dtype=np.float64))
            self.idle_intervals.append(np.zeros(R, dtype=np.float64))
        self._mig_credit_ms = np.zeros(B)

    def observe(self, reads, writes, epoch_ms):
        # DAMON: every sample interval, probe ONE random page per region and
        # check its accessed bit.  Estimate: nr_accesses = hits per
        # aggregation interval.  P(accessed bit set) for a page with rate r
        # accesses/ms over a sample window of sample_ms: 1 - exp(-r*window).
        B = self.batch
        epoch_ms = _as_vec(epoch_ms, B)
        total = reads + writes
        for b in range(B):
            rng = self.rngs[b]
            sample_ms = self.sample_us[b] / 1e3
            # samples per epoch (epoch_ms / sample_ms), bounded for cost
            nr_samples = max(1, int(epoch_ms[b] / sample_ms))
            rate = total / max(float(epoch_ms[b]), 1e-9)  # accesses per ms
            p_hit = 1.0 - np.exp(-rate * sample_ms)
            R = int(self.nr_regions[b])
            K = min(nr_samples, 64)  # cap probes per epoch (DAMON cost cap)
            if self.sampler == "elementwise":
                # Monte-Carlo probe: one random page per region per sample
                lo, hi = self.region_lo[b], self.region_hi[b]
                hits = np.zeros(R)
                for _ in range(K):
                    offs = rng.integers(0, np.maximum(hi - lo, 1))
                    pages = np.minimum(lo + offs, hi - 1)
                    hits += rng.uniform(size=R) < p_hit[pages]
            else:
                # A probe is Bernoulli(p_hit[U]) with U uniform in the
                # region, i.e. Bernoulli(mean p_hit over the region); K iid
                # probes are exactly Binomial(K, p̄) — one vector draw.
                sizes = self.region_hi[b] - self.region_lo[b]
                pbar = np.add.reduceat(p_hit, self.region_lo[b]) / \
                    np.maximum(sizes, 1)
                hits = rng.binomial(K, np.clip(pbar, 0.0, 1.0)).astype(
                    np.float64)
            self.nr_accesses[b] = hits / K  # fraction of probes that hit
            self.idle_intervals[b] = np.where(
                self.nr_accesses[b] <= 0, self.idle_intervals[b] + 1, 0.0)
            self.samples_last_epoch[b] = float(nr_samples * R) / 50.0
            # DAMON PT-scanning is cheap vs PEBS interrupts; overhead scaled
            # down accordingly

    def plan(self, epoch_ms, max_pages_this_epoch):
        B = self.batch
        epoch_ms = _as_vec(epoch_ms, B)
        max_pages = _as_vec(max_pages_this_epoch, B, dtype=np.int64)
        self._mig_credit_ms += epoch_ms
        runs = (self._mig_credit_ms // self.migration_period_ms).astype(
            np.int64)
        self._mig_credit_ms -= runs * self.migration_period_ms
        tier = self.btier
        fast_free = tier.fast_free
        plans = []
        for b in range(B):
            if runs[b] <= 0:
                plans.append(MigrationPlan.empty())
                continue
            rng = self.rngs[b]
            region_of_page = self.region_of_page[b]
            in_fast = tier.in_fast[b]
            hot_regions = self.nr_accesses[b] >= \
                (self.hot_access_pct[b] / 100.0)
            cold_regions = self.idle_intervals[b] >= self.cold_aggr_intervals[b]
            hot_pages = hot_regions[region_of_page]
            cold_pages = cold_regions[region_of_page]

            rate_pages = migration_rate_pages(
                float(self.max_migration_rate_gibs[b]), float(epoch_ms[b]),
                tier.page_bytes)
            rate_pages = min(rate_pages, int(max_pages[b]))

            cand_p = np.flatnonzero(hot_pages & ~in_fast & tier.allocated[b])
            # regions with higher estimated rate first; saturated estimates
            # tie, so the order among them is effectively arbitrary — which
            # is what makes the default's migrations "erroneous" (§4.5: ~10M
            # unnecessary pages for XSBench)
            jitter = rng.uniform(0.0, 1e-6, size=int(self.nr_regions[b]))
            est = self.nr_accesses[b] + jitter
            if len(cand_p):
                order = np.argsort(-est[region_of_page[cand_p]],
                                   kind="stable")
                cand_p = cand_p[order]
            room = int(fast_free[b])
            need = max(0, min(len(cand_p), rate_pages) - room)
            demote = np.zeros(0, dtype=np.int64)
            if need > 0:
                cand_d = np.flatnonzero(cold_pages & in_fast)
                if len(cand_d) < need:  # fall back to coldest regions
                    extra = np.flatnonzero(~hot_pages & ~cold_pages & in_fast)
                    order = np.argsort(est[region_of_page[extra]],
                                       kind="stable")
                    cand_d = np.concatenate([cand_d, extra[order]])
                if len(cand_d) < need:
                    # HMSDK's DAMOS demotion scheme ranks regions by estimated
                    # coldness even when none is idle: under a saturated
                    # monitor the ranking is noise, so pages swap between
                    # tiers with no benefit.  This is the erroneous-migration
                    # mode the paper observes with default knobs.
                    rest = np.flatnonzero(hot_pages & in_fast)
                    order = np.argsort(est[region_of_page[rest]],
                                       kind="stable")
                    cand_d = np.concatenate([cand_d, rest[order]])
                demote = cand_d[:need]
            n_promote = min(len(cand_p), room + len(demote))
            total = n_promote + len(demote)
            if total > rate_pages:
                n_demote = min(len(demote), rate_pages)
                demote = demote[:n_demote]
                n_promote = max(0, min(n_promote, room + n_demote,
                                       rate_pages - n_demote))
            plans.append(MigrationPlan(promote=cand_p[:n_promote],
                                       demote=demote))
        return plans


# ---------------------------------------------------------------------------
# Memtis — dynamic hot threshold, static everything else (§4.6).
# ---------------------------------------------------------------------------
@register_engine("memtis")
class BatchMemtisEngine(BatchTieringEngine):
    #: extra kernel time charged per migrated page (ms) — the paper observes
    #: Memtis "spends a significant amount of time in the kernel for page
    #: allocations, page splitting and migrations".
    KERNEL_MS_PER_PAGE = 0.02

    def __init__(self, configs, btier, seeds: SeedLike = 0,
                 sampler: str = "elementwise"):
        super().__init__(configs, btier, seeds, sampler)
        B, n = self.batch, btier.n_pages
        self.read_counts = np.zeros((B, n), dtype=np.float64)
        self.write_counts = np.zeros((B, n), dtype=np.float64)
        self.sampling_period = self._knob("sampling_period")
        self.write_sampling_period = self._knob("write_sampling_period")
        self.cooling_period_ms = self._knob("cooling_period_ms")
        self.adaptation_period_ms = self._knob("adaptation_period_ms")
        self.migration_period_ms = self._knob("migration_period")
        self.max_migration_rate_gibs = self._knob("max_migration_rate")
        self.warm_pct = self._knob("warm_pct") / 100.0
        self.hot_threshold = np.full(B, 4.0)  # initial; adapted dynamically
        self._cool_credit = np.zeros(B)
        self._adapt_credit = np.zeros(B)
        self._mig_credit = np.zeros(B)

    def observe(self, reads, writes, epoch_ms):
        B, n = self.batch, self.btier.n_pages
        epoch_ms = _as_vec(epoch_ms, B)
        if not hasattr(self, "_sr"):
            self._sr = np.empty((B, n))
            self._sw = np.empty((B, n))
        sr, sw = self._sr, self._sw
        for b in range(B):
            rng = self.rngs[b]
            sr[b] = self._draw(rng, reads, self.sampling_period[b])
            sw[b] = self._draw(rng, writes, self.write_sampling_period[b])
        self.read_counts += sr
        self.write_counts += sw
        self.samples_last_epoch = sr.sum(axis=1) + sw.sum(axis=1)
        self._cool_credit += epoch_ms
        self._adapt_credit += epoch_ms
        cool = self._cool_credit >= self.cooling_period_ms
        if cool.any():
            self._cool_credit[cool] = 0.0
            self.read_counts[cool] *= 0.5
            self.write_counts[cool] *= 0.5
            self.cooling_events[cool] += 1
        adapt = self._adapt_credit >= self.adaptation_period_ms
        if adapt.any():
            self._adapt_credit[adapt] = 0.0
            self._adapt_threshold(np.flatnonzero(adapt))

    def _adapt_threshold(self, rows: np.ndarray) -> None:
        """Pick the smallest threshold whose hot set fits the fast tier."""
        heat = self.read_counts[rows] + self.write_counts[rows]
        cap = self.btier.fast_capacity
        if cap <= 0 or heat.shape[1] == 0:
            return
        k = min(cap, heat.shape[1] - 1)
        kth = heat.shape[1] - 1 - k
        part = np.partition(heat, kth, axis=1)[:, kth]
        self.hot_threshold[rows] = np.maximum(part, 1.0)

    def plan(self, epoch_ms, max_pages_this_epoch):
        B = self.batch
        epoch_ms = _as_vec(epoch_ms, B)
        max_pages = _as_vec(max_pages_this_epoch, B, dtype=np.int64)
        self._mig_credit += epoch_ms
        runs = (self._mig_credit // self.migration_period_ms).astype(np.int64)
        self.overhead_ms_last_epoch = np.zeros(B)
        self._mig_credit -= runs * self.migration_period_ms
        if not (runs > 0).any():
            return [MigrationPlan.empty() for _ in range(B)]
        tier = self.btier
        heat_all = self.read_counts + self.write_counts
        hot_all = heat_all >= self.hot_threshold[:, None]
        warm_all = (~hot_all) & (
            heat_all >= (self.hot_threshold * (1.0 - self.warm_pct))[:, None])
        fast_free = tier.fast_free
        # batch-wide candidate masks; never demote hot or warm pages (warm
        # class, Memtis improvement #2)
        cand_p_mask = hot_all & ~tier.in_fast & tier.allocated
        cand_d_mask = tier.in_fast & ~hot_all & ~warm_all
        rate_vec = migration_rate_pages(self.max_migration_rate_gibs,
                                        epoch_ms, tier.page_bytes)
        plans = []
        for b in range(B):
            if runs[b] <= 0:
                plans.append(MigrationPlan.empty())
                continue
            heat = heat_all[b]
            rate_pages = min(int(rate_vec[b]), int(max_pages[b]))

            cand_p = np.flatnonzero(cand_p_mask[b])
            if len(cand_p):
                cand_p = cand_p[np.argsort(-heat[cand_p], kind="stable")]
            room = int(fast_free[b])
            need = max(0, min(len(cand_p), rate_pages) - room)
            demote = np.zeros(0, dtype=np.int64)
            if need > 0:
                cand_d = np.flatnonzero(cand_d_mask[b])
                if len(cand_d):
                    order = np.argsort(heat[cand_d], kind="stable")
                    demote = cand_d[order[:need]]
            n_promote = min(len(cand_p), room + len(demote))
            total = n_promote + len(demote)
            if total > rate_pages:
                n_demote = min(len(demote), rate_pages)
                demote = demote[:n_demote]
                n_promote = max(0, min(n_promote, room + n_demote,
                                       rate_pages - n_demote))
            plan = MigrationPlan(promote=cand_p[:n_promote], demote=demote)
            self.overhead_ms_last_epoch[b] = plan.n_pages * \
                self.KERNEL_MS_PER_PAGE
            plans.append(plan)
        return plans


# ---------------------------------------------------------------------------
# Reference points.
# ---------------------------------------------------------------------------
@register_engine("static")
class BatchStaticEngine(BatchTieringEngine):
    """First-touch placement, never migrates."""

    def observe(self, reads, writes, epoch_ms):
        self.samples_last_epoch = np.zeros(self.batch)

    def plan(self, epoch_ms, max_pages_this_epoch):
        return [MigrationPlan.empty() for _ in range(self.batch)]


@register_engine("oracle")
class BatchOracleEngine(BatchTieringEngine):
    """Clairvoyant top-capacity placement with free migrations (CH_opt
    bound)."""

    zero_cost_migrations = True

    def __init__(self, configs, btier, seeds: SeedLike = 0,
                 sampler: str = "elementwise"):
        super().__init__(configs, btier, seeds, sampler)
        self._heat = np.zeros(btier.n_pages, dtype=np.float64)

    def observe(self, reads, writes, epoch_ms):
        self._heat = reads + writes  # perfect, instantaneous knowledge
        self.samples_last_epoch = np.zeros(self.batch)

    def plan(self, epoch_ms, max_pages_this_epoch):
        tier = self.btier
        fast_free = tier.fast_free
        plans = []
        for b in range(self.batch):
            alloc = np.flatnonzero(tier.allocated[b])
            if len(alloc) == 0:
                plans.append(MigrationPlan.empty())
                continue
            in_fast = tier.in_fast[b]
            cap = min(tier.fast_capacity, len(alloc))
            heat_alloc = self._heat[alloc]
            top = alloc[np.argsort(-heat_alloc, kind="stable")[:cap]]
            want = np.zeros(tier.n_pages, dtype=bool)
            want[top] = True
            promote = np.flatnonzero(want & ~in_fast)
            demote = np.flatnonzero(~want & in_fast)
            # demote exactly enough to fit the promotions, then cap the
            # promotions at the post-demotion free capacity so the plan can
            # never overflow the fast tier even when too few demotion
            # candidates exist
            need = max(0, len(promote) - int(fast_free[b]))
            demote = demote[:need] if need > 0 else np.zeros(0,
                                                             dtype=np.int64)
            promote = promote[:int(fast_free[b]) + len(demote)]
            plans.append(MigrationPlan(promote=promote, demote=demote))
        return plans


#: legacy alias of the engine registry, which replaced this hardcoded map.
#: Mostly dict-compatible, except bare ``.get(name)`` raises KeyError with a
#: did-you-mean hint; pass a default (``.get(name, None)``) for dict behavior.
BATCH_ENGINES = ENGINE_REGISTRY


def make_batch_engine(name: str, configs: Sequence[Mapping[str, Any]],
                      btier: BatchTierState, seeds: SeedLike = 0,
                      sampler: str = "elementwise") -> BatchTieringEngine:
    """Instantiate the registered batch engine ``name`` (registry-resolved)."""
    cls = ENGINE_REGISTRY.get(name)
    return cls(configs, btier, seeds=seeds, sampler=sampler)


# ---------------------------------------------------------------------------
# Single-config wrappers (B=1) — the historical interface.
# ---------------------------------------------------------------------------
class TieringEngine:
    """Single-config engine: a thin ``B=1`` wrapper over the batch engine."""

    batch_cls: type = None
    zero_cost_migrations = False

    def __init__(self, config: Mapping[str, Any], tier: TierState,
                 seed: int = 0, sampler: str = "elementwise"):
        self.config = dict(config)
        self.tier = tier
        self._b = self.batch_cls([self.config], tier.batch_state,
                                 seeds=seed, sampler=sampler)
        self.rng = self._b.rngs[0]

    @property
    def batch_engine(self) -> BatchTieringEngine:
        return self._b

    # per-epoch telemetry the simulator reads back
    @property
    def samples_last_epoch(self) -> float:
        return float(self._b.samples_last_epoch[0])

    @property
    def overhead_ms_last_epoch(self) -> float:
        return float(self._b.overhead_ms_last_epoch[0])

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


class HMSDKEngine(TieringEngine):
    batch_cls = BatchHMSDKEngine

    @property
    def nr_regions(self) -> int:
        return int(self._b.nr_regions[0])

    @property
    def nr_accesses(self) -> np.ndarray:
        return self._b.nr_accesses[0]

    @property
    def idle_intervals(self) -> np.ndarray:
        return self._b.idle_intervals[0]

    @property
    def region_of_page(self) -> np.ndarray:
        return self._b.region_of_page[0]


class MemtisEngine(TieringEngine):
    batch_cls = BatchMemtisEngine
    KERNEL_MS_PER_PAGE = BatchMemtisEngine.KERNEL_MS_PER_PAGE

    @property
    def read_counts(self) -> np.ndarray:
        return self._b.read_counts[0]

    @property
    def write_counts(self) -> np.ndarray:
        return self._b.write_counts[0]

    @property
    def hot_threshold(self) -> float:
        return float(self._b.hot_threshold[0])


class StaticEngine(TieringEngine):
    batch_cls = BatchStaticEngine


class OracleEngine(TieringEngine):
    batch_cls = BatchOracleEngine
    zero_cost_migrations = True


#: single-config (B=1) wrapper classes for the builtin engines; engines
#: registered only through
#: :func:`~repro_torch.core.registry.register_engine` get an auto-generated
#: wrapper from :func:`single_engine_cls`.  (Not named
#: ``ENGINES``: that is the batch-class registry of
#: :mod:`repro_torch.core.registry`.)
SINGLE_ENGINES = {
    "hemem": HeMemEngine,
    "hmsdk": HMSDKEngine,
    "memtis": MemtisEngine,
    "static": StaticEngine,
    "oracle": OracleEngine,
}


def single_engine_cls(name: str) -> type:
    """The ``B=1`` wrapper class for engine ``name`` (auto-generated for
    engines that registered only a batch class).  The registry is the
    source of truth: re-registering a name invalidates the cached wrapper,
    so the single-config path can never diverge from the batch path."""
    batch_cls = ENGINE_REGISTRY.get(name)
    cls = SINGLE_ENGINES.get(name)
    if cls is None or cls.batch_cls is not batch_cls:
        cls = type(f"Single{batch_cls.__name__}", (TieringEngine,), {
            "batch_cls": batch_cls,
            "zero_cost_migrations": batch_cls.zero_cost_migrations,
        })
        SINGLE_ENGINES[name] = cls
    return cls


def make_engine(name: str, config: Mapping[str, Any], tier: TierState,
                seed: int = 0, sampler: str = "elementwise") -> TieringEngine:
    """Deprecated single-config factory; resolves through the registry."""
    from ._deprecation import warn_deprecated
    warn_deprecated("repro_torch.core.engine.make_engine",
                    "repro_torch.core.registry.ENGINES / Study(spec).run()")
    return single_engine_cls(name)(config, tier, seed=seed, sampler=sampler)
