"""HMSDK on DAMON as the simulator models it, one configuration, plain
numpy.

Observe: the address space is split into ``nr_regions`` equal contiguous
regions.  Every ``sample_us`` of simulated time DAMON probes one uniform
page of each region (at most 64 probes an epoch are modelled); a probe
hits with the page's chance of an access within the sampling interval,
``1 - exp(-rate * interval)``, so a region's hits are Binomial(K, mean
chance over its pages).  A region's access rate is its hits over K; a
region with no hit ages one interval, one with a hit resets.

Plan: every ``migration_period`` ms, pages of regions whose rate reaches
``hot_access_pct`` are promoted, highest estimated rate first (a 1e-6
jitter per region breaks ties), within ``max_migration_rate``; room is
made by demoting, in order, pages of regions idle for at least
``cold_aggr_intervals``, then lukewarm pages by rate, then hot ones.
"""

from __future__ import annotations

import numpy as np

from ..core import (F32, S_JITTER, S_PROBE, U32, rate_pages, select,
                    truncate_to_rate)

PAGE_KNOBS = ("nr_regions",)
MAX_PROBES = 64


def probe_us(machine):
    """CPU microseconds per DAMON page-table probe."""
    return machine["scan_us"]


class Engine:
    ZERO_COST = False

    def __init__(self, c, n, fast_cap, q):
        self.q, self.n, self.fast_cap = q, n, fast_cap
        self.R = R = min(int(c["nr_regions"]), n)
        self.nr_regions = F32(R)
        self.sample_us = F32(c["sample_us"])
        self.hot_pct = F32(c["hot_access_pct"])
        self.cold_aggr = F32(c["cold_aggr_intervals"])
        self.period = F32(c["migration_period"])
        self.rate = F32(c.get("max_migration_rate", 1e9))
        bounds = np.linspace(0, n, R + 1).astype(np.int64)
        self.lo = bounds[:-1]
        self.sizes = np.diff(bounds).astype(F32)
        self.region_of_page = np.searchsorted(bounds[1:], np.arange(n),
                                              side="right")
        self.acc = np.zeros(R, F32)
        self.idle = np.zeros(R, F32)
        self.credit = F32(0.0)

    def observe(self, draws, e, reads, writes, est):
        q = self.q
        total = q(reads + writes)
        rate = q(total / max(est, F32(1e-9)))
        sample_ms = q(self.sample_us / F32(1e3))
        nr_samples = max(np.floor(q(est / sample_ms)), F32(1.0))
        p_hit = q(F32(1.0) - q(np.exp(-q(rate * sample_ms))))
        K = min(nr_samples, F32(MAX_PROBES))
        sums = q(np.add.reduceat(p_hit, self.lo, dtype=F32)) \
            if self.R else np.zeros(0, F32)
        pbar = np.clip(q(sums / np.maximum(self.sizes, F32(1.0))),
                       F32(0.0), F32(1.0))
        probes = np.arange(MAX_PROBES, dtype=U32)[:, None]
        regions = np.arange(self.R, dtype=U32)[None, :]
        u = draws.uniform(S_PROBE, e, probes, regions)
        active = probes.astype(F32) < K
        hits = ((u < pbar[None, :]) & active).sum(axis=0)
        self.acc = q(hits.astype(F32) / K)
        self.idle = np.where(self.acc <= F32(0.0), q(self.idle + F32(1.0)),
                             F32(0.0)).astype(F32)
        return q(q(nr_samples * self.nr_regions) / F32(50.0))

    def plan(self, draws, e, in_fast, allocated, est, max_pages):
        q = self.q
        credit = q(self.credit + est)
        runs = int(np.floor(q(credit / self.period)))
        self.credit = q(credit - q(F32(runs) * self.period))
        hot_r = self.acc >= q(self.hot_pct / F32(100.0))
        cold_r = self.idle >= self.cold_aggr
        jitter = q(draws.uniform(S_JITTER, e, np.arange(self.R, dtype=U32))
                   * F32(1e-6))
        est_r = q(self.acc + jitter)
        rop = self.region_of_page
        hp, cp, est_p = hot_r[rop], cold_r[rop], est_r[rop]
        cand_p = hp & ~in_fast & allocated
        cap = min(rate_pages(self.rate, est, q), max_pages)
        n_p = F32(cand_p.sum())
        room = F32(self.fast_cap - int(in_fast.sum()))
        need = max(q(min(n_p, cap) - room), F32(0.0))
        # demotion preference: idle-cold pages, then lukewarm by estimated
        # rate, then hot by estimated rate (one ascending key)
        lukewarm = ~hp & ~cp & in_fast
        hot_fast = hp & in_fast
        key_d = np.where(cp & in_fast, F32(0.0),
                         np.where(lukewarm, q(F32(10.0) + est_p),
                                  np.where(hot_fast, q(F32(20.0) + est_p),
                                           F32(40.0)))).astype(F32)
        n_d = min(F32(in_fast.sum()), need)
        n_promote = min(n_p, q(room + n_d))
        n_p2, n_d2 = truncate_to_rate(n_promote, n_d, room, cap, q)
        if runs <= 0:
            n_p2 = n_d2 = F32(0.0)
        pmask = select(cand_p, est_p, n_p2, descending=True)
        dmask = select(in_fast, key_d, n_d2, descending=False)
        return pmask, dmask, 0.0
