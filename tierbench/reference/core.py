"""The plain reference of the tiering simulator: numpy, one loop over epochs.

It works out from the seed what the program under test computes: the
trace (``workloads/<name>.py``), the counter-hash monitoring draws, each
engine's observe and plan steps (``engines/<name>.py``), the exact top-k
migration selection and the access-cost model, for any subset of a pass's
configurations.  It imports nothing of the program.

Semantics (those of the paper's simulator, as the program documents them):

* Randomness is counter-based.  Every draw is a 32-bit hash of ``(base
  key, draw site, epoch, page)``; with common random numbers every row of
  a pass shares the base key ``fold(fold(0xC0FFEE, seed), 0)``, so rows
  are independent given the seed and any subset can be simulated alone.
* A monitoring draw is Poisson(rate / period): the inverse CDF over 16
  terms below a rate of 5, a popcount-normal above.
* Selection takes the top ``floor(k)`` candidates by priority, ties by
  page index ascending (descending priority to promote, ascending to
  demote).
* Floating-point state and arithmetic are float32, as the configuration
  states.  ``precision="bfloat16"`` rounds every floating-point result to
  bfloat16 instead: the control that the comparison has to reject.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Sequence

import numpy as np

from .. import load

F32 = np.float32
U32 = np.uint32

PAGE_BYTES = 2 * 1024 * 1024
CACHELINE = 64
#: draw sites (each draw folds site + 1 for its second hash word)
S_READ, S_WRITE, S_PROBE, S_JITTER = 0x11, 0x21, 0x31, 0x41
POISSON_SWITCH = 5.0
POISSON_KMAX = 16


# ---------------------------------------------------------------------------
# precision: float32, or every result rounded to bfloat16 (the control)
# ---------------------------------------------------------------------------
def _round_bf16(x):
    a = np.asarray(x, dtype=F32)
    bits = a.view(U32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(U32).view(F32).reshape(a.shape)


def rounder(precision: str) -> Callable:
    """``q(x)``: ``x`` as float32, or rounded to the nearest bfloat16."""
    if precision == "float32":
        return lambda x: np.asarray(x, dtype=F32)
    if precision == "bfloat16":
        return _round_bf16
    raise ValueError(f"precision must be float32 or bfloat16, got "
                     f"{precision!r}")


# ---------------------------------------------------------------------------
# counter hash (uint32 arithmetic wraps modulo 2**32)
# ---------------------------------------------------------------------------
_MUL1, _MUL2, _GOLDEN = U32(0x7FEB352D), U32(0x846CA68B), U32(0x9E3779B9)


def mix32(h):
    h = h ^ (h >> U32(16))
    h = h * _MUL1
    h = h ^ (h >> U32(15))
    h = h * _MUL2
    return h ^ (h >> U32(16))


def fold(h, w):
    h = np.asarray(h, dtype=U32)
    w = np.asarray(w, dtype=U32)
    with np.errstate(over="ignore"):
        return mix32(h ^ (w + _GOLDEN + (h << U32(6)) + (h >> U32(2))))


def counter_hash(key, *words):
    h = np.asarray(key, dtype=U32)
    for w in words:
        h = fold(h, w)
    return h


def base_key(seed: int) -> U32:
    """The shared base key of a pass under common random numbers."""
    return fold(fold(U32(0xC0FFEE), U32(seed % 2 ** 32)), U32(0))


def hash_uniform(h):
    """A hash word as a float32 uniform in (0, 1): 24 high bits."""
    return ((h >> U32(8)).astype(F32) + F32(0.5)) * F32(1.0 / (1 << 24))


def popcount32(x):
    """Set bits of each uint32 value (SWAR, in 64-bit words)."""
    x = x.astype(np.uint64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def poisson(lam, h1, h2, q):
    """Poisson(lam) from two hash words per element."""
    lam = q(lam)
    u1 = hash_uniform(h1)
    lam_s = q(np.minimum(lam, F32(POISSON_SWITCH)))
    pmf = q(np.exp(-lam_s))
    cdf = pmf
    k = (u1 > cdf).astype(F32)
    for i in range(1, POISSON_KMAX):
        pmf = q(pmf * q(lam_s / F32(i)))
        cdf = q(cdf + pmf)
        k = k + (u1 > cdf)
    z = q((popcount32(h1).astype(F32) - F32(16.0) + hash_uniform(h2)
           - F32(0.5)) * F32(1.0 / 2.8431203))
    normal = np.maximum(np.floor(q(lam + q(np.sqrt(lam) * z)) + F32(0.5)),
                        F32(0.0))
    return q(np.where(lam < F32(POISSON_SWITCH), k, normal))


class Draws:
    """One epoch's monitoring draws of a pass, shared by its rows: the hash
    words per page are computed once, the Poisson per distinct rate."""

    def __init__(self, key, epoch: int, n: int, q):
        self.key, self.epoch, self.n, self.q = key, epoch, n, q
        self._words: Dict[int, Any] = {}
        self._cache: Dict[Any, np.ndarray] = {}

    def _hash(self, site: int):
        h = self._words.get(site)
        if h is None:
            pages = np.arange(self.n, dtype=U32)
            h = counter_hash(self.key, site, self.epoch, pages)
            self._words[site] = h
        return h

    def monitor(self, site: int, base: np.ndarray, period) -> np.ndarray:
        """Poisson(base / period) for every page (one row's draw)."""
        key = (site, F32(period).tobytes())
        out = self._cache.get(key)
        if out is None:
            lam = self.q(base.astype(F32) / F32(period))
            out = poisson(lam, self._hash(site), self._hash(site + 1), self.q)
            self._cache[key] = out
        return out

    def uniform(self, *words) -> np.ndarray:
        return hash_uniform(counter_hash(self.key, *words))


# ---------------------------------------------------------------------------
# exact selection
# ---------------------------------------------------------------------------
def select(mask: np.ndarray, priority: np.ndarray, k,
           descending: bool) -> np.ndarray:
    """The ``floor(k)`` candidates of ``mask`` with the highest (or lowest)
    ``priority``, ties by page index ascending."""
    out = np.zeros(mask.shape, dtype=bool)
    k = int(math.floor(float(k)))
    if k <= 0:
        return out
    idx = np.flatnonzero(mask)
    if k >= len(idx):
        out[idx] = True
        return out
    p = priority[idx]
    order = np.argsort(-p if descending else p, kind="stable")[:k]
    out[idx[order]] = True
    return out


def truncate_to_rate(n_promote, n_d, room, rate_pages, q):
    """Demotions free room first; promotions take what the rate leaves."""
    n_promote, n_d, room = F32(n_promote), F32(n_d), F32(room)
    if n_promote + n_d > rate_pages:
        n_d2 = min(n_d, rate_pages)
        n_p2 = max(min(min(n_promote, room + n_d2), q(rate_pages - n_d2)),
                   F32(0.0))
        return F32(n_p2), F32(n_d2)
    return n_promote, n_d


def rate_raw(rate, est_wall, q):
    """Pages that ``rate`` GiB/s moves in an epoch of ``est_wall`` ms (not
    yet truncated)."""
    return q(q(q(F32(rate) * F32(2 ** 30)) * q(est_wall / F32(1e3)))
             / F32(PAGE_BYTES))


def rate_pages(rate, est_wall, q):
    """The engine's migration-rate cap in pages."""
    return np.floor(rate_raw(rate, est_wall, q))


# ---------------------------------------------------------------------------
# the access-cost model
# ---------------------------------------------------------------------------
def epoch_consts(cfg: Mapping[str, Any], wl: Mapping[str, Any],
                 probe_us: float) -> Dict[str, F32]:
    """The cost model's constants, from the configuration's machine table
    and the workload: parallel resources shrink with the scale."""
    m = cfg["machine_table"]
    threads, scale = wl["threads"], wl["scale"]
    near_bw = m["near_bw_gbs"] * 1e9 * scale
    far_bw_r = m["far_bw_read_gbs"] * 1e9 * scale
    far_bw_w = m["far_bw_write_gbs"] * 1e9 * scale
    c = {"near_bw": near_bw, "far_bw_r": far_bw_r, "far_bw_w": far_bw_w,
         "near_lat_s": m["near_lat_ns"] * 1e-9,
         "far_lat_s": m["far_lat_ns"] * 1e-9,
         "eff_par": threads * wl["mlp"] * scale,
         "page_copy_s": PAGE_BYTES / max(min(far_bw_r, near_bw), 1.0),
         "stall_denom": max(threads * scale, 1e-9),
         "probe_us": probe_us, "threads_floor": max(threads, 1),
         "compute_ms": wl["compute_ms"]}
    return {k: F32(v) for k, v in c.items()}


def access_cost(acc_f, acc_s, reads_s, writes_s, pb, db, w_mig, est_wall,
                samples, engine_ms, c, q):
    """One epoch's wall ms and fast-tier hit rate of one row: the larger of
    the bandwidth- and latency-bound times, floored by compute, plus
    write-protect stalls, sampling and engine time."""
    bytes_f = q(acc_f * F32(CACHELINE))
    t_near = q(q(q(bytes_f + pb) + db) / c["near_bw"])
    t_far = q(q(q(q(reads_s * F32(CACHELINE)) + pb) / c["far_bw_r"])
              + q(q(q(writes_s * F32(CACHELINE)) + db) / c["far_bw_w"]))
    t_lat = q(q(q(acc_f * c["near_lat_s"]) + q(acc_s * c["far_lat_s"]))
              / c["eff_par"])
    t_mem = max(max(t_near, t_far), t_lat)
    epoch_s = max(q(est_wall * F32(1e-3)), c["page_copy_s"])
    in_flight = min(q(c["page_copy_s"] / epoch_s), F32(1.0))
    if pb + db > 0:
        stall_s = q(q(q(w_mig * in_flight) * q(c["page_copy_s"] / F32(2.0)))
                    / c["stall_denom"])
    else:
        stall_s = F32(0.0)
    sampling_s = q(q(q(samples * c["probe_us"]) * F32(1e-6))
                   / c["threads_floor"])
    engine_s = q(engine_ms * F32(1e-3))
    wall = q(q(q(max(q(t_mem * F32(1e3)), c["compute_ms"])
                 + q(stall_s * F32(1e3))) + q(sampling_s * F32(1e3)))
             + q(engine_s * F32(1e3)))
    hit = q(acc_f / max(q(acc_f + acc_s), F32(1e-12)))
    return F32(wall), F32(hit)


# ---------------------------------------------------------------------------
# the pieces found by name
# ---------------------------------------------------------------------------
_MODULES: Dict[str, Any] = {}


def load_piece(kind: str, name: str):
    """``reference/<kind>/<name>.py`` (an engine or a workload), loaded
    once."""
    mod = _MODULES.get(f"{kind}/{name}")
    if mod is None:
        mod = _MODULES[f"{kind}/{name}"] = load(f"reference.{kind}", name)
    return mod


def build_workload(cfg: Mapping[str, Any], seed: int,
                   scale: "float | None" = None) -> Dict[str, Any]:
    """The configuration's trace, built from ``seed``."""
    mod = load_piece("workloads", cfg["workload"])
    return mod.build(cfg["input"], int(cfg["threads"]),
                     float(cfg["scale"] if scale is None else scale),
                     int(seed))


def fast_capacity(n: int, ratio: float) -> int:
    return max(1, int(round(n / (1.0 + ratio))))


def scale_config(engine, config: Mapping[str, Any],
                 scale: float) -> Dict[str, Any]:
    out = dict(config)
    for k in engine.PAGE_KNOBS:
        if k in out:
            out[k] = max(1, int(round(out[k] * scale)))
    return out


def simulate(cfg: Mapping[str, Any], configs: Sequence[Mapping[str, Any]],
             seed: int, *, scale: "float | None" = None,
             precision: str = "float32") -> List[Dict[str, Any]]:
    """Simulate ``configs`` (each alone) over the pass with seed ``seed``.

    Returns per config ``total_s`` (float64 sum of the float32 epoch
    walls, in seconds), ``epoch_wall_ms``, ``cum_migrations`` and
    ``fast_hit_rate`` per epoch."""
    q = rounder(precision)
    wl = build_workload(cfg, seed, scale)
    eng_mod = load_piece("engines", cfg["engine"])
    n, E = wl["n_pages"], wl["n_epochs"]
    fast_cap = fast_capacity(n, float(cfg["fast_slow_ratio"]))
    consts = epoch_consts(cfg, wl, eng_mod.probe_us(cfg["machine_table"]))
    key = base_key(seed)
    rows = []
    for c in configs:
        eng = eng_mod.Engine(scale_config(eng_mod, c, wl["scale"]), n,
                             fast_cap, q)
        rows.append({"eng": eng, "in_fast": np.zeros(n, dtype=bool),
                     "est": F32(wl["epoch_ms"]), "cum": F32(0.0),
                     "wall": [], "mig": [], "hit": []})
    allocated = np.zeros(n, dtype=bool)
    touch_floor = F32(1.0 / max(n, 1))
    scale_f = F32(wl["scale"])
    for e in range(E):
        r64, w64 = wl["epoch_access"](e)
        reads, writes = r64.astype(F32), w64.astype(F32)
        acc = reads + writes
        new = (acc > touch_floor) & ~allocated
        rank_new = np.cumsum(new)
        draws = Draws(key, e, n, q)
        acc_sum = q(acc.sum(dtype=F32))
        reads_sum, writes_sum = reads.sum(dtype=F32), writes.sum(dtype=F32)
        alloc_after = allocated | new
        for row in rows:
            in_fast = row["in_fast"]
            room = fast_cap - int(in_fast.sum())
            in_fast = in_fast | (new & (rank_new <= room))
            eng, est = row["eng"], row["est"]
            samples = eng.observe(draws, e, reads, writes, est)
            max_pages = np.floor(q(rate_raw(eng.rate, est, q) * scale_f))
            pmask, dmask, overhead = eng.plan(draws, e, in_fast, alloc_after,
                                              est, max_pages)
            n_p, n_d = int(pmask.sum()), int(dmask.sum())
            in_fast = (in_fast & ~dmask) | pmask
            row["in_fast"] = in_fast
            row["cum"] = F32(row["cum"] + F32(n_p + n_d))
            reads_f = q((reads * in_fast).sum(dtype=F32))
            writes_f = q((writes * in_fast).sum(dtype=F32))
            acc_f = q(reads_f + writes_f)
            if eng.ZERO_COST:
                pb = db = w_mig = F32(0.0)
            else:
                pb = q(F32(n_p) * F32(PAGE_BYTES))
                db = q(F32(n_d) * F32(PAGE_BYTES))
                w_mig = q(writes[pmask | dmask].sum(dtype=F32))
            wall, hit = access_cost(
                acc_f, q(acc_sum - acc_f), q(reads_sum - reads_f),
                q(writes_sum - writes_f), pb, db, w_mig, est, F32(samples),
                F32(overhead), consts, q)
            row["est"] = wall
            row["wall"].append(wall)
            row["mig"].append(row["cum"])
            row["hit"].append(hit)
        allocated = alloc_after
    out = []
    for row in rows:
        wall = np.asarray(row["wall"], dtype=np.float64)
        out.append({"total_s": float(wall.sum() / 1e3),
                    "epoch_wall_ms": wall,
                    "cum_migrations": np.asarray(row["mig"], np.float64),
                    "fast_hit_rate": np.asarray(row["hit"], np.float64)})
    return out
