"""The compiled epoch loop of the PyTorch port: the simulator's hot path.

The batch tiering engines are pure functions over ``(B, n_pages)``
tensors on one device, driven by a Python loop over epochs (the reference
package's ``lax.scan``).  Each epoch: first-touch allocation, the engine's
observe step (fused counter-hash Poisson monitoring draws), its plan step
(migration selection through the hand-written ``select_topk`` kernel on the
card, its plain version on the CPU), the tier update, and the access-cost
model.  No step reads a tensor back to the host, so on the card the loop
only enqueues work; results come back once, after the last epoch.

Randomness is counter-based: every monitoring draw is a hash of ``(seed,
batch row, epoch, draw site, page)``, so segmented and whole runs agree
bitwise, and ``crn=True`` (common random numbers) gives every row of the
batch the same draws.  The hash words are the reference package's, bit for
bit: they are held as int64 masked to 32 bits (this torch build lacks
shifts, additions and comparisons on ``torch.uint32``), relying on int64
arithmetic wrapping where a product exceeds 63 bits.

What differs from the JAX reference at the last bit (see the tests'
tolerances): ``torch.exp`` and XLA's ``exp`` disagree by one ulp on some
inputs, which can move an inverse-CDF Poisson count by one (about one draw
in a million), and float row sums are taken in another order.  Integer
results — hashes, selection masks, the deterministic engines' migrations —
are exact.

The scan carry ``(in_fast (B, n) bool, allocated (n,) bool, est_wall (B,)
f32, engine state dict, cum_migrations (B,) f32, row keys (B,))`` crosses to
the host in exactly the layout of the reference's ``carry_to_host``
(:func:`carry_to_host` / :func:`carry_from_host`), so a run checkpointed by
either package resumes in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .knobs import HEMEM_SPACE
from .registry import ENGINES, SAMPLERS, register_engine, register_sampler

register_sampler("elementwise", "fused counter-hash Poisson draw per page")
register_sampler("sparse", "fused counter-hash Poisson draw per page "
                 "(same distribution as 'elementwise')")

#: rate below which the fused Poisson draw inverts the CDF exactly; at and
#: above it the popcount-normal approximation takes over
POISSON_SWITCH = 5.0
#: pmf terms accumulated by the inverse-CDF branch
POISSON_KMAX = 16
#: 1/sigma of (popcount(u32) - 16 + uniform - 0.5): sqrt(8 + 1/12)
_POPCOUNT_NORM = 1.0 / 2.8431203

# draw-site identifiers folded into the counter hash (each draw also folds
# site+1 for its second hash word)
_S_READ = 0x11
_S_WRITE = 0x21
_S_PROBE = 0x31
_S_JITTER = 0x41

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MUL1 = 0x7FEB352D
_MUL2 = 0x846CA68B

#: page-count ceiling (the selection kernel packs two 16-bit counters)
MAX_PAGES = (1 << 16) - 1


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: a scalar operand that
    is exact in float32, so no op can round it differently."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Counter-based uniforms (lowbias32-style avalanche).  The functions take
# int64 tensors holding u32 values, or numpy uint32 arrays (which wrap
# natively; the masks are no-ops there).
# ---------------------------------------------------------------------------
def mix32(h):
    """Finalizing 32-bit avalanche (murmur3-style)."""
    h = h ^ (h >> 16)
    h = (h * _MUL1) & _M32
    h = h ^ (h >> 15)
    h = (h * _MUL2) & _M32
    h = h ^ (h >> 16)
    return h


def fold(h, w):
    """Fold word ``w`` into hash state ``h`` (boost::hash_combine-style);
    broadcasting shapes the output counter grid."""
    return mix32(h ^ ((w + _GOLDEN + ((h << 6) & _M32) + (h >> 2)) & _M32))


def counter_hash(key, *words):
    """Deterministic u32 hash of ``key`` and the counter ``words``."""
    h = key
    for w in words:
        h = fold(h, w)
    return h


def hash_uniform(h: torch.Tensor) -> torch.Tensor:
    """Map a hash word to a float32 uniform in (0, 1)."""
    return ((h >> 8).to(torch.float32) + 0.5) * _f32(1.0 / (1 << 24))


def counter_uniform(key, *words) -> torch.Tensor:
    return hash_uniform(counter_hash(key, *words))


def base_keys(seeds: Sequence[int], batch_offset: int, crn: bool) -> np.ndarray:
    """Per-row base hash keys (numpy uint32, on the host).  ``crn=False``
    folds ``(seed_b, global batch index)``; ``crn=True`` gives every row
    ``(seeds[0], 0)``, so all rows share every draw bitwise."""
    seeds = np.asarray(seeds, dtype=np.uint32)
    if crn:
        seeds = np.full_like(seeds, seeds[0])
        rows = np.zeros_like(seeds)
    else:
        rows = (np.arange(len(seeds)) + batch_offset).astype(np.uint32)
    h0 = np.full(len(seeds), 0xC0FFEE, dtype=np.uint32)
    return np.asarray(fold(fold(h0, seeds), rows), dtype=np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 value held in an int64 tensor (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


# ---------------------------------------------------------------------------
# Fused samplers
# ---------------------------------------------------------------------------
def _poisson_from_hash(lam, h1, h2):
    """Branchless Poisson(lam) from two hash words per element: exact
    inverse-CDF below :data:`POISSON_SWITCH`, popcount-normal above."""
    u1 = hash_uniform(h1)
    lam_s = torch.clamp(lam, max=POISSON_SWITCH)
    pmf = torch.exp(-lam_s)
    cdf = pmf
    k = (u1 > cdf).to(torch.float32)
    for i in range(1, POISSON_KMAX):
        pmf = pmf * (lam_s / float(i))
        cdf = cdf + pmf
        k = k + (u1 > cdf)
    z = (popcount32(h1).to(torch.float32) - 16.0 + hash_uniform(h2) - 0.5) \
        * _f32(_POPCOUNT_NORM)
    normal = torch.clamp(torch.floor(lam + torch.sqrt(lam) * z + 0.5), min=0.0)
    return torch.where(lam < POISSON_SWITCH, k, normal)


def monitor_draw(keys, epoch: int, site: int, base, period):
    """Fused PEBS monitoring draw: Poisson(base / period) for every page of
    every batch row, keyed by ``(row key, site, epoch, page)``."""
    n = base.shape[-1]
    pages = torch.arange(n, dtype=torch.int64, device=base.device)[None, :]
    h1 = counter_hash(keys[:, None], site, epoch, pages)
    h2 = counter_hash(keys[:, None], site + 1, epoch, pages)
    lam = base[None, :].to(torch.float32) / period[:, None]
    return _poisson_from_hash(lam, h1, h2)


def monitor_draw2(keys, epoch, reads, writes, sp, wsp):
    """Both monitoring draws (load + store PEBS sites)."""
    return (monitor_draw(keys, epoch, _S_READ, reads, sp),
            monitor_draw(keys, epoch, _S_WRITE, writes, wsp))


def kth_largest(values: torch.Tensor, k: int) -> torch.Tensor:
    """The value at ascending-sorted position ``n - 1 - k`` of each row
    (``np.partition`` semantics), as a float32 ``(B,)`` tensor."""
    n = values.shape[-1]
    return torch.kthvalue(values.to(torch.float32), n - k, dim=-1).values


# ---------------------------------------------------------------------------
# Engine definitions.  Each engine contributes:
#   knobs(configs)  -> dict of per-config numpy vectors / static arrays
#   init(kv)        -> state dict of (B, ...) tensors
#   observe(...)    -> (state, samples (B,))
#   plan(...)       -> (state, promote_mask, demote_mask, overhead_ms)
# ---------------------------------------------------------------------------
def _knob_vec(configs, name, default=None, dtype=np.float32):
    vals = [c.get(name, default) if default is not None else c[name]
            for c in configs]
    return np.asarray(vals, dtype=dtype)


def _runs_update(credit, period, est_wall):
    credit = credit + est_wall
    runs = torch.floor(credit / period).to(torch.int32)
    credit = credit - runs.to(torch.float32) * period
    return credit, runs


def _rate_pages(rate_gibs, est_wall, page_bytes):
    """Unscaled per-engine migration-rate cap (pages): ``rate * 2**30 *
    epoch_s / page_bytes``, truncated, in float32."""
    return torch.floor(rate_gibs * _f32(2 ** 30) * (est_wall / 1e3)
                       / page_bytes)


def _truncate_to_rate(n_promote, n_d, room, rate_pages):
    """The shared rate-cap truncation: demotions free room first,
    promotions take what remains."""
    n_promote = n_promote.to(torch.float32)
    n_d = n_d.to(torch.float32)
    room = room.to(torch.float32)
    over = (n_promote + n_d) > rate_pages
    n_d2 = torch.where(over, torch.minimum(n_d, rate_pages), n_d)
    n_p2 = torch.where(
        over,
        torch.clamp(torch.minimum(torch.minimum(n_promote, room + n_d2),
                                  rate_pages - n_d2), min=0.0),
        n_promote)
    return n_p2, n_d2


class EngineDef:
    """The pure functions defining one compiled engine.

    ``knobs(configs)`` builds numpy per-config vectors (uploaded once per
    run); ``init(kv)`` the initial state; ``observe`` folds one epoch of
    true access counts into the monitoring state and returns the per-row
    sampling volume; ``plan`` returns bool ``(B, n)`` selection masks and
    per-row overhead ms.  Class attributes: ``plans = False`` skips
    ``plan``; ``zero_cost = True`` charges no migration bandwidth.
    """

    zero_cost = False
    plans = True

    def __init__(self, B, n, fast_cap, device):
        self.B, self.n, self.fast_cap, self.device = B, n, fast_cap, device
        self.page_bytes = _f32(2 ** 21)  # set by _build_step

    def tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def zeros(self, *shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def knobs(self, configs) -> Dict[str, np.ndarray]:
        return {"rate": _knob_vec(configs, "max_migration_rate", default=1e9)}

    def upload(self, kv: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The knob arrays as tensors on the engine's device (once a run)."""
        return {k: self.tensor(v) for k, v in kv.items()}

    def init(self, kv):
        return {}

    def observe(self, st, kv, keys, e, reads, writes, est_wall):
        return st, self.zeros(self.B)


@register_engine("static")
class StaticDef(EngineDef):
    plans = False


@register_engine("oracle")
class OracleDef(EngineDef):
    zero_cost = True

    def plan(self, st, kv, keys, e, reads, writes, in_fast, allocated,
             est_wall, max_pages):
        B, n = self.B, self.n
        heat = (reads + writes).to(torch.float32)  # clairvoyant knowledge
        alloc = allocated[None, :].expand(B, n)
        cap = torch.clamp(alloc.sum(dim=-1), max=self.fast_cap)
        # want = the `cap` hottest allocated pages (ties by index)
        heat_b = heat[None, :].expand(B, n)
        none = self.zeros(B, n, dtype=torch.bool)
        want, _ = kernel_ops.select_topk(alloc, heat_b, none, heat_b,
                                         cap.to(torch.float32), self.zeros(B))
        prom_c = want & ~in_fast
        dem_c = ~want & in_fast
        free = self.fast_cap - in_fast.sum(dim=1)
        need = torch.clamp(prom_c.sum(dim=1) - free, min=0)
        # index-order prefixes, like the reference's flatnonzero slices
        cs_p = torch.cumsum(prom_c, dim=1)
        cs_d = torch.cumsum(dem_c, dim=1)
        d_sel = dem_c & (cs_d <= need[:, None])
        n_d = d_sel.sum(dim=1)
        p_sel = prom_c & (cs_p <= (free + n_d)[:, None])
        return st, p_sel, d_sel, self.zeros(B)


@register_engine("hemem")
class HeMemDef(EngineDef):
    COOL_UNIT_PAGES = 16.0

    def knobs(self, configs):
        kv = super().knobs(configs)
        kv.update(
            sp=_knob_vec(configs, "sampling_period"),
            wsp=_knob_vec(configs, "write_sampling_period"),
            read_hot=_knob_vec(configs, "read_hot_threshold"),
            write_hot=_knob_vec(configs, "write_hot_threshold"),
            period=_knob_vec(configs, "migration_period"),
            cool_pages=np.minimum(
                _knob_vec(configs, "cooling_pages", dtype=np.int32), self.n),
            hot_ring=_knob_vec(configs, "hot_ring_reqs_threshold",
                               dtype=np.int32),
            cold_ring=_knob_vec(configs, "cold_ring_reqs_threshold",
                                dtype=np.int32),
            trigger=np.maximum(
                _knob_vec(configs, "cooling_threshold") * self.n
                / self.COOL_UNIT_PAGES, 1.0).astype(np.float32),
        )
        p = kv["cool_pages"]
        # static per config: each page's cooling chunk and chunks per sweep
        kv["cj"] = (np.arange(self.n, dtype=np.int32)[None, :]
                    // p[:, None]).astype(np.int32)
        kv["M"] = ((self.n + p - 1) // p).astype(np.int32)
        return kv

    def init(self, kv):
        B, n = self.B, self.n
        return {"rc": self.zeros(B, n), "wc": self.zeros(B, n),
                "cursor": self.zeros(B, dtype=torch.int32),
                "since": self.zeros(B), "credit": self.zeros(B)}

    def _draws(self, kv, keys, e, reads, writes):
        """Monitoring-noise hook: sampled (reads, writes), both ``(B, n)``.
        The default is the fused counter-hash Poisson PEBS model;
        :class:`KVHeMemDef` overrides it with deterministic means."""
        return monitor_draw2(keys, e, reads, writes, kv["sp"], kv["wsp"])

    def observe(self, st, kv, keys, e, reads, writes, est_wall):
        sr, sw = self._draws(kv, keys, e, reads, writes)
        samples = (sr + sw).sum(dim=-1)
        since = st["since"] + samples
        k = torch.floor(since / kv["trigger"]).to(torch.int32)
        p = kv["cool_pages"]
        k_eff = k.to(torch.float32) * p.to(torch.float32) / self.n
        factor = torch.where(
            k > 0, (2.0 - torch.exp2(-k_eff)) / (k_eff + 1.0), 1.0)
        # the cooling sweep in closed form: k triggers from chunk m0 halve
        # chunk c exactly k//M + [(c - m0) mod M < k mod M] times
        M = kv["M"]
        m0 = st["cursor"] // p
        halv = (k // M)[:, None] + (
            ((kv["cj"] - m0[:, None]) % M[:, None]) < (k % M)[:, None])
        decay = torch.exp2(-halv.to(torch.float32))
        rc = st["rc"] * decay + sr * factor[:, None]
        wc = st["wc"] * decay + sw * factor[:, None]
        st = dict(st, rc=rc, wc=wc, cursor=((m0 + k) % M) * p,
                  since=since - k.to(torch.float32) * kv["trigger"])
        return st, samples

    def plan(self, st, kv, keys, e, reads, writes, in_fast, allocated,
             est_wall, max_pages):
        credit, runs = _runs_update(st["credit"], kv["period"], est_wall)
        st = dict(st, credit=credit)
        hot = (st["rc"] >= kv["read_hot"][:, None]) | \
            (st["wc"] >= kv["write_hot"][:, None])
        heat = st["rc"] + st["wc"]
        cand_p = hot & ~in_fast & allocated
        cand_d = ~hot & in_fast
        rate_pages = torch.minimum(
            _rate_pages(kv["rate"], est_wall, self.page_bytes), max_pages)
        n_p = torch.minimum(cand_p.sum(dim=1), kv["hot_ring"] * runs)
        room = self.fast_cap - in_fast.sum(dim=1)
        watermark = max(1, self.fast_cap // 50)
        pressure = torch.clamp(watermark - room, min=0)
        need = torch.maximum(torch.clamp(n_p - room, min=0), pressure)
        n_d = torch.minimum(cand_d.sum(dim=1),
                            torch.minimum(need, kv["cold_ring"] * runs))
        n_promote = torch.minimum(n_p, room + n_d)
        n_p2, n_d2 = _truncate_to_rate(n_promote, n_d, room,
                                       torch.clamp(rate_pages, min=0.0))
        gate = (runs > 0).to(torch.float32)
        pmask, dmask = kernel_ops.select_topk(cand_p, heat, cand_d, heat,
                                              n_p2 * gate, n_d2 * gate)
        return st, pmask, dmask, self.zeros(self.B)


@register_engine("kv-hemem", space=HEMEM_SPACE)
class KVHeMemDef(HeMemDef):
    """The tiered-KV cache's HeMem analog: :class:`HeMemDef`'s cooling,
    threshold, ring and rate machinery with **deterministic mean
    sampling** (``sampled = true_counts / sampling_period``).  The serving
    path measures per-page attention mass exactly, so there is no PEBS
    noise to emulate; determinism is also what lets the fused serving step
    match the per-page reference loop bitwise."""

    def _draws(self, kv, keys, e, reads, writes):
        sr = reads.to(torch.float32)[None, :] / kv["sp"][:, None]
        sw = writes.to(torch.float32)[None, :] / kv["wsp"][:, None]
        return sr, sw


@register_engine("memtis")
class MemtisDef(EngineDef):
    KERNEL_MS_PER_PAGE = 0.02

    def knobs(self, configs):
        kv = super().knobs(configs)
        kv.update(
            sp=_knob_vec(configs, "sampling_period"),
            wsp=_knob_vec(configs, "write_sampling_period"),
            cool_period=_knob_vec(configs, "cooling_period_ms"),
            adapt_period=_knob_vec(configs, "adaptation_period_ms"),
            period=_knob_vec(configs, "migration_period"),
            warm=_knob_vec(configs, "warm_pct") / np.float32(100.0),
        )
        return kv

    def init(self, kv):
        B, n = self.B, self.n
        return {"rc": self.zeros(B, n), "wc": self.zeros(B, n),
                "thr": torch.full((B,), 4.0, device=self.device),
                "cool": self.zeros(B), "adapt": self.zeros(B),
                "credit": self.zeros(B)}

    def observe(self, st, kv, keys, e, reads, writes, est_wall):
        sr, sw = monitor_draw2(keys, e, reads, writes, kv["sp"], kv["wsp"])
        rc = st["rc"] + sr
        wc = st["wc"] + sw
        samples = (sr + sw).sum(dim=-1)
        cool_c = st["cool"] + est_wall
        cool = cool_c >= kv["cool_period"]
        cool_c = torch.where(cool, 0.0, cool_c)
        rc = torch.where(cool[:, None], rc * 0.5, rc)
        wc = torch.where(cool[:, None], wc * 0.5, wc)
        adapt_c = st["adapt"] + est_wall
        adapt = adapt_c >= kv["adapt_period"]
        adapt_c = torch.where(adapt, 0.0, adapt_c)
        # smallest threshold whose hot set fits the fast tier
        part = kth_largest(rc + wc, min(self.fast_cap, self.n - 1))
        thr = torch.where(adapt, torch.clamp(part, min=1.0), st["thr"])
        st = dict(st, rc=rc, wc=wc, thr=thr, cool=cool_c, adapt=adapt_c)
        return st, samples

    def plan(self, st, kv, keys, e, reads, writes, in_fast, allocated,
             est_wall, max_pages):
        credit, runs = _runs_update(st["credit"], kv["period"], est_wall)
        st = dict(st, credit=credit)
        run_row = runs > 0
        heat = st["rc"] + st["wc"]
        hot = heat >= st["thr"][:, None]
        warm = ~hot & (heat >= (st["thr"] * (1.0 - kv["warm"]))[:, None])
        cand_p = hot & ~in_fast & allocated
        cand_d = in_fast & ~hot & ~warm
        rate_pages = torch.minimum(
            _rate_pages(kv["rate"], est_wall, self.page_bytes), max_pages)
        n_p = cand_p.sum(dim=1).to(torch.float32)
        room = self.fast_cap - in_fast.sum(dim=1)
        need = torch.clamp(torch.minimum(n_p, rate_pages) - room, min=0.0)
        n_d = torch.minimum(cand_d.sum(dim=1).to(torch.float32), need)
        n_promote = torch.minimum(n_p, room + n_d)
        n_p2, n_d2 = _truncate_to_rate(n_promote, n_d, room, rate_pages)
        gate = run_row.to(torch.float32)
        pmask, dmask = kernel_ops.select_topk(cand_p, heat, cand_d, heat,
                                              n_p2 * gate, n_d2 * gate)
        overhead = torch.where(
            run_row,
            (pmask.sum(dim=1) + dmask.sum(dim=1)).to(torch.float32)
            * _f32(self.KERNEL_MS_PER_PAGE), 0.0)
        return st, pmask, dmask, overhead


@register_engine("hmsdk")
class HMSDKDef(EngineDef):
    MAX_PROBES = 64  # DAMON cost cap, as in the reference

    def knobs(self, configs):
        kv = super().knobs(configs)
        nr = np.minimum(_knob_vec(configs, "nr_regions", dtype=np.int32),
                        self.n)
        kv.update(
            nr_regions=nr,
            sample_us=_knob_vec(configs, "sample_us"),
            hot_pct=_knob_vec(configs, "hot_access_pct"),
            cold_aggr=_knob_vec(configs, "cold_aggr_intervals"),
            period=_knob_vec(configs, "migration_period"),
        )
        # ragged equal-size region maps (contiguous page ranges), padded
        # to Rmax across the batch
        Rmax = int(nr.max())
        B, n = len(nr), self.n
        bounds = [np.linspace(0, n, int(R) + 1).astype(np.int64) for R in nr]
        region_of_page = np.zeros((B, n), dtype=np.int64)
        region_lo = np.zeros((B, Rmax), dtype=np.int64)
        sizes = np.zeros((B, Rmax), dtype=np.float32)
        valid = np.zeros((B, Rmax), dtype=bool)
        for b in range(B):
            R = int(nr[b])
            region_of_page[b] = np.searchsorted(bounds[b][1:], np.arange(n),
                                                side="right")
            region_lo[b, :R] = bounds[b][:-1]
            sizes[b, :R] = np.diff(bounds[b])
            valid[b, :R] = True
        kv.update(region_of_page=region_of_page, region_lo=region_lo,
                  sizes=sizes, valid=valid)
        self.Rmax = Rmax
        self.Smax = int(sizes.max())
        return kv

    def upload(self, kv):
        """Adds ``region_pages`` ``(B, Rmax * Smax)``, built on the device:
        each region's pages, padded with index n (a zero column).  A
        region's probe mass is then a fixed-order row sum — deterministic
        on every device, unlike a float scatter-add."""
        kv = super().upload(kv)
        slot = torch.arange(self.Smax, dtype=torch.int64, device=self.device)
        size = kv["sizes"].to(torch.int64)[:, :, None]
        kv["region_pages"] = torch.where(
            slot < size, kv.pop("region_lo")[:, :, None] + slot,
            self.n).view(self.B, -1)
        return kv

    def init(self, kv):
        B = self.B
        return {"acc": self.zeros(B, self.Rmax),
                "idle": self.zeros(B, self.Rmax), "credit": self.zeros(B)}

    def observe(self, st, kv, keys, e, reads, writes, est_wall):
        B, Rmax = self.B, self.Rmax
        total = (reads + writes).to(torch.float32)
        rate = total[None, :] / torch.clamp(est_wall, min=1e-9)[:, None]
        sample_ms = kv["sample_us"] / 1e3
        nr_samples = torch.clamp(torch.floor(est_wall / sample_ms), min=1.0)
        p_hit = 1.0 - torch.exp(-rate * sample_ms[:, None])
        K = torch.clamp(nr_samples, max=float(self.MAX_PROBES))
        # region-mean hit probability: K probes of a uniform page in the
        # region are Binomial(K, p̄), drawn as MAX_PROBES masked Bernoullis
        p_pad = torch.cat([p_hit, self.zeros(B, 1)], dim=1)
        pbar = torch.gather(p_pad, 1, kv["region_pages"]).view(
            B, Rmax, self.Smax).sum(dim=-1)
        pbar = torch.clamp(pbar / torch.clamp(kv["sizes"], min=1.0), 0.0, 1.0)
        probes = torch.arange(self.MAX_PROBES, dtype=torch.int64,
                              device=self.device)[None, :, None]
        regions = torch.arange(Rmax, dtype=torch.int64,
                               device=self.device)[None, None, :]
        u = counter_uniform(keys[:, None, None], _S_PROBE, e, probes, regions)
        active = probes.to(torch.float32) < K[:, None, None]
        hits = ((u < pbar[:, None, :]) & active).sum(dim=1)
        acc = hits.to(torch.float32) / K[:, None]
        acc = torch.where(kv["valid"], acc, 0.0)
        idle = torch.where(kv["valid"] & (acc <= 0.0), st["idle"] + 1.0, 0.0)
        samples = nr_samples * kv["nr_regions"].to(torch.float32) / 50.0
        return dict(st, acc=acc, idle=idle), samples

    def plan(self, st, kv, keys, e, reads, writes, in_fast, allocated,
             est_wall, max_pages):
        credit, runs = _runs_update(st["credit"], kv["period"], est_wall)
        st = dict(st, credit=credit)
        hot_r = st["acc"] >= (kv["hot_pct"] / 100.0)[:, None]
        cold_r = st["idle"] >= kv["cold_aggr"][:, None]
        regions = torch.arange(self.Rmax, dtype=torch.int64,
                               device=self.device)[None, :]
        jitter = counter_uniform(keys[:, None], _S_JITTER, e, regions) \
            * _f32(1e-6)
        est = st["acc"] + jitter
        rop = kv["region_of_page"]
        hp = torch.gather(hot_r, 1, rop)
        cp = torch.gather(cold_r, 1, rop)
        est_p = torch.gather(est, 1, rop)
        cand_p = hp & ~in_fast & allocated
        rate_pages = torch.minimum(
            _rate_pages(kv["rate"], est_wall, self.page_bytes), max_pages)
        n_p = cand_p.sum(dim=1).to(torch.float32)
        room = self.fast_cap - in_fast.sum(dim=1)
        need = torch.clamp(torch.minimum(n_p, rate_pages) - room, min=0.0)
        # demotion preference chain (idle-cold by page index, then lukewarm
        # by estimated rate, then hot by estimated rate) as one composite
        # ascending key
        class1 = ~hp & ~cp & in_fast
        class2 = hp & in_fast
        key_d = torch.where(cp & in_fast, 0.0,
                            torch.where(class1, 10.0 + est_p,
                                        torch.where(class2, 20.0 + est_p,
                                                    40.0)))
        cand_d = in_fast
        n_d = torch.minimum(cand_d.sum(dim=1).to(torch.float32), need)
        n_promote = torch.minimum(n_p, room + n_d)
        n_p2, n_d2 = _truncate_to_rate(n_promote, n_d, room, rate_pages)
        gate = (runs > 0).to(torch.float32)
        pmask, dmask = kernel_ops.select_topk(cand_p, est_p, cand_d, key_d,
                                              n_p2 * gate, n_d2 * gate)
        return st, pmask, dmask, self.zeros(self.B)


def supports(engine_name: str, sampler: str,
             n_pages: "int | None" = None) -> bool:
    """True if the epoch loop covers this (engine, sampler[, size])."""
    if engine_name not in ENGINES or sampler not in SAMPLERS:
        return False
    return n_pages is None or n_pages <= MAX_PAGES


# ---------------------------------------------------------------------------
# Epoch step, carry and the epoch loop
# ---------------------------------------------------------------------------
def _build_step(edef: EngineDef, const, page_bytes, scale, record_placement):
    from .simulator import _access_cost  # late: avoids a circular import
    B, n, fast_cap = edef.B, edef.n, edef.fast_cap
    edef.page_bytes = _f32(page_bytes)
    touch_floor = _f32(1.0 / max(n, 1))
    zero_cost = edef.zero_cost
    scale_f = _f32(scale)

    def step(carry, reads, writes, e, kv):
        in_fast, allocated, est_wall, eng_state, cum_mig, keys = carry
        # first-touch allocation: the trace is shared across the batch, so
        # `allocated` is one shared (n,) vector; only in_fast is per-row
        acc = reads + writes
        new = (acc > touch_floor) & ~allocated
        room = fast_cap - in_fast.sum(dim=1)
        rank_new = torch.cumsum(new, dim=0)
        in_fast = in_fast | (new[None, :] & (rank_new[None, :]
                                             <= room[:, None]))
        allocated = allocated | new

        eng_state, samples = edef.observe(
            eng_state, kv, keys, e, reads, writes, est_wall)
        max_pages = torch.floor(kv["rate"] * _f32(2 ** 30)
                                * (est_wall / 1e3) / edef.page_bytes
                                * scale_f)
        if edef.plans:
            eng_state, pmask, dmask, overhead_ms = edef.plan(
                eng_state, kv, keys, e, reads, writes, in_fast, allocated,
                est_wall, max_pages)
        else:
            pmask = edef.zeros(B, n, dtype=torch.bool)
            dmask = pmask
            overhead_ms = edef.zeros(B)
        n_promote = pmask.sum(dim=1).to(torch.float32)
        n_demote = dmask.sum(dim=1).to(torch.float32)
        in_fast = (in_fast & ~dmask) | pmask
        cum_mig = cum_mig + n_promote + n_demote

        acc_sum = acc.sum()
        inf_f = in_fast.to(torch.float32)
        reads_f = (inf_f * reads).sum(dim=1)
        writes_f = (inf_f * writes).sum(dim=1)
        acc_f = reads_f + writes_f
        reads_s = reads.sum() - reads_f
        writes_s = writes.sum() - writes_f
        if zero_cost:
            pb = db = w_mig = edef.zeros(B)
        else:
            pb = n_promote * edef.page_bytes
            db = n_demote * edef.page_bytes
            w_mig = ((pmask | dmask).to(torch.float32) * writes).sum(dim=1)
        wall_ms, stall_s, sampling_s, hit = _access_cost(
            acc_f, acc_sum - acc_f, reads_s, writes_s, pb, db, w_mig,
            est_wall, samples, overhead_ms, const)
        out = (wall_ms, cum_mig, hit, sampling_s * 1e3, stall_s * 1e3)
        if record_placement:
            out = out + (in_fast,)
        return (in_fast, allocated, wall_ms, eng_state, cum_mig, keys), out

    return step


def init_carry(edef: EngineDef, kv, keys: np.ndarray, est0: np.ndarray):
    """The epoch-0 carry: ``(in_fast (B, n), allocated (n,), est_wall (B,),
    engine state dict, cum_migrations (B,), row keys (B,))`` on the
    engine's device."""
    B, n = edef.B, edef.n
    return (edef.zeros(B, n, dtype=torch.bool),
            edef.zeros(n, dtype=torch.bool),
            edef.tensor(np.asarray(est0, np.float32)), edef.init(kv),
            edef.zeros(B), edef.tensor(keys.astype(np.int64)))


def carry_to_host(carry) -> Tuple:
    """A carry as numpy arrays, in exactly the layout of the reference
    package's ``engine_jax.carry_to_host``: keys as uint32, engine state as
    a dict of arrays with the reference's dtypes."""
    in_fast, allocated, est, eng, cum, keys = carry
    return (in_fast.cpu().numpy(), allocated.cpu().numpy(),
            est.cpu().numpy(), {k: v.cpu().numpy() for k, v in eng.items()},
            cum.cpu().numpy(), keys.cpu().numpy().astype(np.uint32))


def carry_from_host(host_carry, device) -> Tuple:
    """Tensors on ``device`` from a host carry written by
    :func:`carry_to_host` or by the reference's ``carry_to_host``."""
    in_fast, allocated, est, eng, cum, keys = host_carry

    def t(a, dtype=None):  # a copy: host carries may be read-only views
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return (t(in_fast, torch.bool), t(allocated, torch.bool),
            t(est, torch.float32), {k: t(v) for k, v in eng.items()},
            t(cum, torch.float32),
            t(np.asarray(keys, dtype=np.uint32).astype(np.int64)))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA where there is none raises
    (the port never carries on quietly on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return device


def run_epochs(workload, engine_name: str,
               sim_configs: Sequence[Mapping[str, Any]],
               const: Mapping[str, float], fast_cap: int, page_bytes: int,
               seeds: Sequence[int], sampler: str, crn: bool = False,
               batch_offset: int = 0, record_placement: bool = False,
               epoch_start: int = 0, epoch_stop: "int | None" = None,
               carry: Any = None, return_carry: bool = False,
               device="cuda") -> Dict[str, np.ndarray]:
    """Run the epoch loop on ``device``; returns per-epoch result arrays.

    ``sim_configs`` must already be scale-adjusted (``scale_config``).
    ``epoch_start``/``epoch_stop`` bound the evaluated range ``[start,
    stop)``; starting past epoch 0 requires ``carry``, a host carry from
    :func:`carry_to_host` or the reference's ``carry_to_host`` (returned
    as ``"carry"`` under ``return_carry=True``).  Draws are keyed by
    absolute epoch ids, so segmented runs equal the whole run bitwise.

    Output: ``wall_ms``/``cum_migrations``/``hit_rate``/``sampling_ms``/
    ``stall_ms`` as ``(n_epochs, B)`` float32 arrays (segment epochs
    only), ``in_fast`` ``(n_epochs, B, n)`` when ``record_placement``,
    ``carry`` when ``return_carry``, and the segment's trace.
    """
    device = resolve_device(device)
    B = len(sim_configs)
    n = workload.n_pages
    if not supports(engine_name, sampler, n):
        raise ValueError(
            f"the torch epoch loop does not cover engine={engine_name!r}, "
            f"sampler={sampler!r}, n_pages={n} (engines: {ENGINES.names()}, "
            f"samplers: {SAMPLERS.names()}, at most {MAX_PAGES} pages)")
    E = workload.n_epochs
    start = int(epoch_start)
    stop = E if epoch_stop is None else min(int(epoch_stop), E)
    if not 0 <= start < stop:
        raise ValueError(f"empty epoch segment [{start}, {stop}) "
                         f"(workload has {E} epochs)")
    if start > 0 and carry is None:
        raise ValueError("epoch_start > 0 requires the carry returned by "
                         "the previous segment (return_carry=True)")
    trace = [workload.epoch_access(e) for e in range(start, stop)]
    reads_np = np.stack([r for r, _ in trace]).astype(np.float32)
    writes_np = np.stack([w for _, w in trace]).astype(np.float32)
    # the trace goes to the device once per segment
    reads_t = torch.from_numpy(reads_np).to(device)
    writes_t = torch.from_numpy(writes_np).to(device)
    const = {k: _f32(v) for k, v in const.items()}

    edef = ENGINES.get(engine_name)(B, n, fast_cap, device)
    kv = edef.upload(edef.knobs(sim_configs))
    step = _build_step(edef, const, page_bytes, workload.scale,
                       record_placement)
    if carry is None:
        carry = init_carry(edef, kv, base_keys(seeds, batch_offset, crn),
                           np.full(B, workload.epoch_ms, dtype=np.float32))
    else:
        carry = carry_from_host(carry, device)
    outs = []
    for i, e in enumerate(range(start, stop)):
        carry, o = step(carry, reads_t[i], writes_t[i], e, kv)
        outs.append(o)
    names = ["wall_ms", "cum_migrations", "hit_rate", "sampling_ms",
             "stall_ms"]
    if record_placement:
        names.append("in_fast")
    out = {name: torch.stack([o[j] for o in outs]).cpu().numpy()
           for j, name in enumerate(names)}
    if return_carry:
        out["carry"] = carry_to_host(carry)
    out["trace_reads"] = reads_np
    out["trace_writes"] = writes_np
    return out
