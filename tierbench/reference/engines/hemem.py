"""HeMem (Raybuck et al., SOSP 2021) as the simulator models it, one
configuration, plain numpy.

Observe: PEBS-style Poisson samples of each page's loads and stores
(periods ``sampling_period`` and ``write_sampling_period``) add to
per-page read and write counters.  Every ``cooling_threshold * n / 16``
samples trigger one cooling step, which halves the counters of the next
``cooling_pages`` pages of a sweep over the address space; the epoch's
triggers are applied at once, with the fresh samples weighted by the mean
factor ``(2 - 2**-k_eff) / (k_eff + 1)`` of the ``k_eff = k * pages / n``
sweeps they span.

Plan: the migration thread runs every ``migration_period`` ms of
simulated time (a credit carried across epochs).  A page is hot when its
read counter reaches ``read_hot_threshold`` or its write counter
``write_hot_threshold``.  Hot pages outside the fast tier are promoted,
hottest first, at most ``hot_ring_reqs_threshold`` per run; cold fast
pages are demoted, coldest first, at most ``cold_ring_reqs_threshold`` per
run, as far as promotions and a 2% free watermark need room; and both
within ``max_migration_rate`` GiB/s.
"""

from __future__ import annotations

import numpy as np

from ..core import (F32, S_READ, S_WRITE, rate_pages, select,
                    truncate_to_rate)

#: knobs counted in pages: scaled with the trace
PAGE_KNOBS = ("cooling_pages", "hot_ring_reqs_threshold",
              "cold_ring_reqs_threshold")
COOL_UNIT_PAGES = 16.0


def probe_us(machine):
    """CPU microseconds per monitoring sample."""
    return machine["sample_us"]


class Engine:
    ZERO_COST = False

    def __init__(self, c, n, fast_cap, q):
        self.q, self.n, self.fast_cap = q, n, fast_cap
        self.sp = F32(c["sampling_period"])
        self.wsp = F32(c["write_sampling_period"])
        self.read_hot = F32(c["read_hot_threshold"])
        self.write_hot = F32(c["write_hot_threshold"])
        self.period = F32(c["migration_period"])
        self.rate = F32(c.get("max_migration_rate", 1e9))
        self.pages = min(int(c["cooling_pages"]), n)
        self.hot_ring = int(c["hot_ring_reqs_threshold"])
        self.cold_ring = int(c["cold_ring_reqs_threshold"])
        self.trigger = q(max(q(q(F32(c["cooling_threshold"]) * F32(n))
                               / F32(COOL_UNIT_PAGES)), F32(1.0)))
        self.chunk = np.arange(n) // self.pages
        self.chunks = -(-n // self.pages)
        self.rc = np.zeros(n, F32)
        self.wc = np.zeros(n, F32)
        self.cursor = 0
        self.since = F32(0.0)
        self.credit = F32(0.0)

    def observe(self, draws, e, reads, writes, est):
        q = self.q
        sr = draws.monitor(S_READ, reads, self.sp)
        sw = draws.monitor(S_WRITE, writes, self.wsp)
        samples = q((sr + sw).sum(dtype=F32))
        since = q(self.since + samples)
        k = int(np.floor(q(since / self.trigger)))
        k_eff = q(q(F32(k) * F32(self.pages)) / F32(self.n))
        factor = q(q(F32(2.0) - q(np.exp2(-k_eff))) / q(k_eff + F32(1.0))) \
            if k > 0 else F32(1.0)
        M, m0 = self.chunks, self.cursor // self.pages
        halv = k // M + (((self.chunk - m0) % M) < (k % M))
        decay = np.exp2(-halv.astype(F32))
        self.rc = q(q(self.rc * decay) + q(sr * factor))
        self.wc = q(q(self.wc * decay) + q(sw * factor))
        self.cursor = ((m0 + k) % M) * self.pages
        self.since = q(since - q(F32(k) * self.trigger))
        return samples

    def plan(self, draws, e, in_fast, allocated, est, max_pages):
        q = self.q
        credit = q(self.credit + est)
        runs = int(np.floor(q(credit / self.period)))
        self.credit = q(credit - q(F32(runs) * self.period))
        hot = (self.rc >= self.read_hot) | (self.wc >= self.write_hot)
        heat = q(self.rc + self.wc)
        cand_p = hot & ~in_fast & allocated
        cand_d = ~hot & in_fast
        cap = min(rate_pages(self.rate, est, q), max_pages)
        n_p = min(int(cand_p.sum()), self.hot_ring * runs)
        room = self.fast_cap - int(in_fast.sum())
        watermark = max(1, self.fast_cap // 50)
        need = max(max(n_p - room, 0), max(watermark - room, 0))
        n_d = min(int(cand_d.sum()), min(need, self.cold_ring * runs))
        n_promote = min(n_p, room + n_d)
        n_p2, n_d2 = truncate_to_rate(n_promote, n_d, room,
                                      max(cap, F32(0.0)), q)
        if runs <= 0:
            n_p2 = n_d2 = F32(0.0)
        pmask = select(cand_p, heat, n_p2, descending=True)
        dmask = select(cand_d, heat, n_d2, descending=False)
        return pmask, dmask, 0.0
