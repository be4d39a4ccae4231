"""The paper's workload suite (Table 4) as synthetic access-trace generators
(numpy; a copy of the reference package's generators, so both packages
simulate identical traces).

Each workload produces, for every *epoch* (a fixed quantum of application
work, nominally ``epoch_ms`` of ideal-speed execution), the expected number of
cacheline accesses per 2 MiB page, split into reads and writes.  The patterns
encode exactly the behaviours the paper documents per workload:

* **GUPS** — scattered 8 GiB hot set inside 64 GiB, moving at half time;
  read-modify-write; hot pages uniformly spread over the address space
  (which is what defeats DAMON's region assumption, Fig. 12).
* **Silo / YCSB-C** — read-only; ~1 % of pages extremely hot, ~20 % warm
  (§4.2); Zipf-like within-group variation.
* **Silo / TPC-C** — insert-heavy; new pages are hot briefly and decay as the
  insert frontier advances (§4.3).
* **GapBS-BC** — iteration steps: a persistent hot core plus a per-iteration
  frontier set; Twitter input adds a tiny set of super-hot "popular node"
  pages that also take writes (§4.3, Fig. 8).
* **GapBS-PR / CC** — small hot core (rank arrays) + streaming scans over the
  cold edge pages with no reuse (§4.2, Fig. 4).
* **Btree** — write-heavy init phase growing the tree, then a uniform lookup
  phase with a small read-hot set of high-level node pages (§4.2).
* **XSBench** — small hot set allocated first (lands in fast tier by first
  touch) + a uniform bulk where every page has a similar, low access
  frequency (§4.2, Fig. 5).
* **Graph500** — construction writes then skew-free uniform BFS traffic: no
  tiering decision helps (the one workload with ~no tuning gain, Fig. 2).

``scale`` shrinks both the page count and the access volume by the same
factor (the simulator scales machine bandwidth identically) so per-page rates
— and therefore all threshold/cooling dynamics — are preserved while keeping
an f(θ) evaluation cheap enough for 100-iteration tuning sessions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Tuple

import numpy as np

from .pages import PAGE_BYTES
from .registry import WORKLOADS, register_workload

CACHELINE = 64
LINES_PER_PAGE = PAGE_BYTES // CACHELINE  # 32768 cachelines per 2 MiB page

#: accesses per second a single thread can issue at ideal (fast-tier) speed
BASE_RATE_PER_THREAD = 40e6


@dataclasses.dataclass
class Workload:
    name: str
    input_name: str
    rss_gib: float
    n_pages: int
    n_epochs: int
    epoch_ms: float
    threads: int
    mlp: float               # memory-level parallelism per thread
    compute_ms: float        # non-memory CPU floor per epoch
    scale: float
    epoch_access: Callable[[int], Tuple[np.ndarray, np.ndarray]]
    seed: int = 0            # build seed: (name, input, threads, scale, seed)
                             # fully determines the trace, so a workload can
                             # be rebuilt in batch-evaluation worker processes

    @property
    def key(self) -> str:
        return f"{self.name}:{self.input_name}" if self.input_name else self.name

    def total_accesses_per_epoch(self) -> float:
        return self.threads * BASE_RATE_PER_THREAD * (self.epoch_ms / 1e3) * self.scale


def _pages_for(rss_gib: float, scale: float) -> int:
    return max(64, int(rss_gib * (2 ** 30) / PAGE_BYTES * scale))


def _norm(weights: np.ndarray) -> np.ndarray:
    s = weights.sum()
    return weights / s if s > 0 else weights


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

@register_workload("gups", default_input="8GiB-hot")
def _gups(input_name: str, threads: int, scale: float, seed: int) -> Workload:
    rss = 64.03
    n = _pages_for(rss, scale)
    n_epochs = 60
    epoch_ms = 500.0
    rng = np.random.default_rng(seed + 17)
    hot_frac = 8.0 / 64.0
    n_hot = max(8, int(n * hot_frac))
    # hot pages scattered uniformly over the address space (defeats DAMON)
    hot1 = rng.choice(n, size=n_hot, replace=False)
    hot2 = rng.choice(n, size=n_hot, replace=False)
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale

    base = np.full(n, 0.10 / n)
    w1 = base.copy(); w1[hot1] += 0.90 / n_hot
    w2 = base.copy(); w2[hot2] += 0.90 / n_hot

    def epoch_access(e: int):
        w = w1 if e < n_epochs // 2 else w2
        acc = A * w
        # GUPS = read-modify-write updates: reads ~= writes
        return 0.5 * acc, 0.5 * acc

    return Workload("gups", input_name, rss, n, n_epochs, epoch_ms, threads,
                    mlp=8.0, compute_ms=40.0, scale=scale,
                    epoch_access=epoch_access, seed=seed)


@register_workload("silo", default_input="ycsb-c")
def _silo(input_name: str, threads: int, scale: float, seed: int) -> Workload:
    rss = 71.40 if input_name == "ycsb-c" else 75.68
    n = _pages_for(rss, scale)
    n_epochs = 100
    epoch_ms = 500.0
    rng = np.random.default_rng(seed + 23)
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale

    if input_name == "ycsb-c":
        # ~1% extremely hot, ~20% warm, rest cold (§4.2); read-only.
        # Exact group traffic shares: hot 0.75, warm 0.15, cold 0.10.
        n_hot = max(4, n // 100)
        n_warm = max(8, n // 5)
        perm = rng.permutation(n)
        hot, warm = perm[:n_hot], perm[n_hot:n_hot + n_warm]
        w = np.zeros(n)
        cold_mask = np.ones(n, dtype=bool)
        cold_mask[hot] = cold_mask[warm] = False
        w[cold_mask] = 0.10 / max(int(cold_mask.sum()), 1)
        vw = 1.0 + 0.5 * rng.uniform(size=n_warm)
        w[warm] = 0.15 * vw / vw.sum()
        vh = 1.0 / (1.0 + 0.05 * np.arange(n_hot))
        w[hot] = 0.75 * vh / vh.sum()
        w = _norm(w)

        def epoch_access(e: int):
            acc = A * w
            return 0.995 * acc, 0.005 * acc  # read-only workload

        compute = 60.0
    elif input_name == "tpc-c":
        # insert-heavy; hotness decays with page age as the frontier advances
        tau = n / 20.0

        def epoch_access(e: int):
            frontier = (e + 1) / n_epochs * n
            age = frontier - np.arange(n)
            w = np.where((age > 0), np.exp(-np.maximum(age, 0.0) / tau), 0.0)
            # pages just being written (age in [0, n/n_epochs)) are hottest
            w = _norm(w + 1e-9)
            acc = A * w
            return 0.55 * acc, 0.45 * acc

        compute = 150.0
    else:
        raise ValueError(f"unknown silo input {input_name!r}")

    return Workload("silo", input_name, rss, n, n_epochs, epoch_ms, threads,
                    mlp=6.0, compute_ms=compute, scale=scale,
                    epoch_access=epoch_access, seed=seed)


def _gapbs(kind: str, input_name: str, threads: int, scale: float,
           seed: int) -> Workload:
    rss = {
        ("bc", "kron"): 78.13, ("bc", "twitter"): 13.08,
        ("pr", "kron"): 71.29, ("pr", "twitter"): 12.32,
        ("cc", "kron"): 69.29, ("cc", "twitter"): 12.09,
    }[(kind, input_name)]
    n = _pages_for(rss, scale)
    n_iters = 8
    epochs_per_iter = 15 if kind == "bc" else 10
    n_epochs = n_iters * epochs_per_iter
    epoch_ms = 500.0
    rng = np.random.default_rng(seed + 31)
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale

    # persistent hot core: vertex/rank arrays (allocated first -> low indices)
    n_core = max(8, int(n * (0.20 if kind == "bc" else 0.03)))
    core = np.arange(n_core)
    # a handful of very hot pages (top-degree vertices' rank entries)
    n_super = max(4, n // 300)
    # per-iteration frontier sets (BC only): different random pages each iter
    frontiers = [rng.choice(np.arange(n_core, n), size=max(4, int(n * 0.08)),
                            replace=False) for _ in range(n_iters)]
    # twitter: tiny super-popular set, also written (centrality updates)
    n_pop = max(2, n // 200) if input_name == "twitter" else 0
    popular = rng.choice(n_core, size=n_pop, replace=False) if n_pop else None

    def epoch_access(e: int):
        it = min(e // epochs_per_iter, n_iters - 1)
        w = np.full(n, 1e-12)
        if kind == "bc":
            # the per-iteration frontier carries most of the traffic: placing
            # it fast AND on time is what separates good from bad configs
            w[:n_super] += 0.10 / n_super
            w[core] += 0.28 / n_core
            f = frontiers[it]
            w[f] += 0.46 / len(f)
            w += 0.16 / n
            reads, writes = 0.90, 0.10
        else:  # pr / cc: small hot core + streaming scan with no reuse
            w[core] += 0.30 / n_core
            w += 0.05 / n
            # streaming window over the cold region this epoch
            pos = e % epochs_per_iter
            cold_lo, cold_n = n_core, n - n_core
            win = max(1, cold_n // epochs_per_iter)
            lo = cold_lo + pos * win
            hi = min(lo + win, n)
            w[lo:hi] += 0.65 / max(hi - lo, 1)
            reads, writes = (0.85, 0.15) if kind == "pr" else (0.92, 0.08)
        if popular is not None:
            w[popular] += 0.25 / len(popular)
        w = _norm(w)
        acc = A * w
        return reads * acc, writes * acc

    return Workload(f"gapbs-{kind}", input_name, rss, n, n_epochs, epoch_ms,
                    threads, mlp=7.0, compute_ms=180.0, scale=scale,
                    epoch_access=epoch_access, seed=seed)


@register_workload("btree")
def _btree(input_name: str, threads: int, scale: float, seed: int) -> Workload:
    rss = 12.13
    n = _pages_for(rss, scale)
    n_epochs = 100
    init_epochs = int(n_epochs * 0.30)
    epoch_ms = 500.0
    rng = np.random.default_rng(seed + 41)
    # btree is pointer-chasing: low memory-level parallelism, moderate rate
    A = 0.4 * threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale
    # high-level node pages: created early (low indices -> fast tier by
    # first touch); 1% of pages take 50% of lookup reads
    n_top = max(4, n // 100)
    top = rng.choice(max(8, n // 5), size=n_top, replace=False)
    # random inserts cluster into "active split regions" that rotate:
    # those pages are write-hot for an epoch, then go quiet
    n_active = max(4, n // 26)
    actives = [rng.choice(n, size=n_active, replace=False)
               for _ in range(init_epochs)]

    def epoch_access(e: int):
        if e < init_epochs:
            # insert phase: inserts READ the lookup path (top-level nodes +
            # interior pages) but WRITE the rotating leaf/split regions: the
            # active pages are write-hot and read-cold, which is what makes
            # write_hot_threshold / write_sampling_period the decisive knobs
            # (§4.2: "decrease importance of write-heavy pages")
            grown = max(n_top * 2, int((e + 1) / init_epochs * n))
            wr = np.zeros(n)
            wr[:grown] = 0.55 / grown      # path reads over interior pages
            wr[top] += 0.45 / n_top        # top levels on every insert
            wr = _norm(wr)
            ww = np.zeros(n)
            act = actives[e][actives[e] < grown]
            if len(act) == 0:
                act = np.arange(min(grown, n_active))
            ww[act] = 0.80 / len(act)      # active split regions
            ww[:grown] += 0.20 / grown     # rebalance writes
            ww = _norm(ww)
            return 0.75 * A * wr, 0.25 * A * ww
        else:
            # lookup phase: top nodes very hot, leaves uniform
            w = np.full(n, 0.50 / n)
            w[top] += 0.50 / n_top
            w = _norm(w)
            acc = A * w
            return 0.98 * acc, 0.02 * acc

    return Workload("btree", input_name, rss, n, n_epochs, epoch_ms, threads,
                    mlp=4.0, compute_ms=60.0, scale=scale,
                    epoch_access=epoch_access, seed=seed)


@register_workload("xsbench")
def _xsbench(input_name: str, threads: int, scale: float, seed: int) -> Workload:
    rss = 64.97
    n = _pages_for(rss, scale)
    n_epochs = 80
    epoch_ms = 500.0
    rng = np.random.default_rng(seed + 47)
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale
    # unionized energy grid allocated first: hot pages are the low indices,
    # so first-touch already places them in the fast tier (§4.2, Fig. 5)
    n_hot = max(8, n * 2 // 100)
    # the bulk has "very similar" (but not identical) access counts — the
    # mild lognormal tail is what makes the default config keep promoting
    # bulk pages that are no better than the ones they displace
    bulk_w = np.exp(rng.normal(0.0, 0.3, size=n))
    bulk_w[:n_hot] = 0.0
    bulk_w = 0.55 * bulk_w / bulk_w.sum()
    base_w = bulk_w.copy()
    base_w[:n_hot] += 0.45 / n_hot
    base_w = _norm(base_w)

    def epoch_access(e: int):
        acc = A * base_w
        return 0.95 * acc, 0.05 * acc

    return Workload("xsbench", input_name, rss, n, n_epochs, epoch_ms, threads,
                    mlp=7.0, compute_ms=200.0, scale=scale,
                    epoch_access=epoch_access, seed=seed)


@register_workload("wset", default_input="f50")
def _wset(input_name: str, threads: int, scale: float, seed: int) -> Workload:
    """Parameterizable working-set workload (the drift zoo's growth/shrink
    base): input ``f<percent>`` sets the touched fraction of the address
    space (``f25`` = the first 25 % of pages are active).

    The active region is a PREFIX of the page range, so two builds at
    different fractions are strict sub/supersets of each other — exactly
    the semantics working-set growth needs (``DriftSpec.wset`` splices
    ``f25 -> f50 -> f100`` phases): when the set grows, the new pages are
    cold-start demand the tiering engine must notice and promote.  Per-page
    weights within the active set carry a mild lognormal skew drawn once
    over the FULL page range (seed-deterministic), so every fraction sees
    the same per-page weights on the shared prefix.
    """
    rss = 32.0
    n = _pages_for(rss, scale)
    n_epochs = 60
    epoch_ms = 500.0
    if not (len(input_name) > 1 and input_name[0] == "f"):
        raise ValueError(f"wset input must be 'f<percent>' (e.g. 'f25'), "
                         f"got {input_name!r}")
    frac = float(input_name[1:]) / 100.0
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"wset fraction must be in (0, 100], "
                         f"got {input_name!r}")
    rng = np.random.default_rng(seed + 53)
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale
    n_act = max(8, int(round(n * frac)))
    # one weight draw for the whole range; fractions share the prefix
    v = np.exp(rng.normal(0.0, 0.4, size=n))
    w = np.full(n, 0.05 / n)
    w[:n_act] += 0.95 * v[:n_act] / v[:n_act].sum()
    w = _norm(w)

    def epoch_access(e: int):
        acc = A * w
        return 0.90 * acc, 0.10 * acc

    return Workload("wset", input_name, rss, n, n_epochs, epoch_ms, threads,
                    mlp=7.0, compute_ms=80.0, scale=scale,
                    epoch_access=epoch_access, seed=seed)


@register_workload("graph500", default_input="kron")
def _graph500(input_name: str, threads: int, scale: float, seed: int) -> Workload:
    rss = 34.13
    n = _pages_for(rss, scale)
    n_epochs = 80
    build_epochs = int(n_epochs * 0.25)
    epoch_ms = 500.0
    A = threads * BASE_RATE_PER_THREAD * (epoch_ms / 1e3) * scale

    def epoch_access(e: int):
        if e < build_epochs:
            # construction: kronecker edges land at *random* positions, so the
            # build writes are scattered uniformly — no page is write-hot
            w = np.full(n, 1.0 / n)
            acc = 0.10 * A * w
            return 0.30 * acc, 0.70 * acc
        # BFS: skew-free uniform random — every page has the same frequency,
        # so every placement yields the same hit rate: nothing for tiering to
        # exploit (the one workload with ~no tuning gain, Fig. 2)
        w = np.full(n, 1.0 / n)
        acc = 0.12 * A * w
        return 0.97 * acc, 0.03 * acc

    return Workload("graph500", input_name, rss, n, n_epochs, epoch_ms,
                    threads, mlp=8.0, compute_ms=600.0, scale=scale,
                    epoch_access=epoch_access, seed=seed)


# ---------------------------------------------------------------------------
# registration (the gapbs generators share one parameterized function)
# ---------------------------------------------------------------------------
for _kind in ("bc", "pr", "cc"):
    register_workload(f"gapbs-{_kind}", default_input="kron")(
        functools.partial(_gapbs, _kind))

#: the paper's default benchmark set (Table 4) with its default inputs
PAPER_SUITE: List[Tuple[str, str]] = [
    ("gapbs-bc", "kron"), ("gapbs-pr", "kron"), ("gapbs-cc", "kron"),
    ("silo", "ycsb-c"), ("btree", ""), ("xsbench", ""),
    ("gups", "8GiB-hot"), ("graph500", "kron"),
]


def make_workload(name: str, input_name: str = "", threads: int = 12,
                  scale: float = 0.25, seed: int = 0) -> Workload:
    """Build the registered workload ``name`` (registry-resolved)."""
    return WORKLOADS.get(name)(input_name, threads, scale, seed)
