"""Knob (parameter) spaces for tiering engines (a copy of the reference
package's, trimmed to what the port's optimizer and knob importance
use).

Faithful to the paper:
  * Table 2 lists HeMem's 10 knobs with defaults and [min, max] ranges; those are
    reproduced verbatim in :data:`HEMEM_SPACE`.
  * Section 4.5 tunes HMSDK (DAMON-based); the DAMON monitoring knobs
    (``nr_regions``, sampling/aggregation intervals) plus HMSDK's migration knobs
    form :data:`HMSDK_SPACE`.

A :class:`KnobSpace` is the interface between the tiering engines and the
Bayesian optimizer: it knows how to sample random configurations, encode a
configuration as a numeric feature vector for the random-forest surrogate, and
generate local neighbours for SMAC-style local search.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

Config = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable parameter of a tiering engine.

    ``log`` marks knobs whose useful range spans orders of magnitude
    (e.g. ``migration_period`` in [10, 5000] ms); those are sampled and
    encoded in log-space so the optimizer explores the low end properly.
    """

    name: str
    default: float
    lo: float
    hi: float
    is_int: bool = True
    log: bool = False
    description: str = ""

    def clip(self, value: float) -> float:
        v = min(max(float(value), self.lo), self.hi)
        if self.is_int:
            v = float(int(round(v)))
        return v

    # --- unit-interval transforms (for surrogate encoding) ---------------
    def to_unit(self, value: float) -> float:
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi)
            return (math.log(max(value, self.lo)) - lo) / (hi - lo)
        return (value - self.lo) / (self.hi - self.lo)

    def from_unit(self, u: float) -> float:
        u = min(max(u, 0.0), 1.0)
        if self.log:
            lo, hi = math.log(self.lo), math.log(self.hi)
            return self.clip(math.exp(lo + u * (hi - lo)))
        return self.clip(self.lo + u * (self.hi - self.lo))


class KnobSpace:
    """An ordered collection of knobs; the domain Θ = Θ₁ × … × Θₙ of §3."""

    def __init__(self, knobs: Sequence[Knob]):
        self.knobs: List[Knob] = list(knobs)
        self._by_name = {k.name: k for k in self.knobs}
        if len(self._by_name) != len(self.knobs):
            raise ValueError("duplicate knob names")
        # vectorized knob bounds for the batched encode/decode paths
        self._lo = np.array([k.lo for k in self.knobs], dtype=np.float64)
        self._hi = np.array([k.hi for k in self.knobs], dtype=np.float64)
        self._log = np.array([k.log for k in self.knobs])
        self._int = np.array([k.is_int for k in self.knobs])
        self._lo_t = self._lo.copy()
        self._hi_t = self._hi.copy()
        self._lo_t[self._log] = np.log(self._lo[self._log])
        self._hi_t[self._log] = np.log(self._hi[self._log])

    # -- basic access ------------------------------------------------------
    def __len__(self) -> int:
        return len(self.knobs)

    def __iter__(self):
        return iter(self.knobs)

    def __getitem__(self, name: str) -> Knob:
        return self._by_name[name]

    def default_config(self) -> Config:
        return {k.name: (int(k.default) if k.is_int else k.default) for k in self.knobs}

    def validate(self, config: Mapping[str, Any]) -> Config:
        """Clip a config into the domain; unknown keys are rejected."""
        unknown = set(config) - set(self._by_name)
        if unknown:
            raise KeyError(f"unknown knobs: {sorted(unknown)}")
        out = self.default_config()
        for name, value in config.items():
            k = self._by_name[name]
            v = k.clip(value)
            out[name] = int(v) if k.is_int else v
        return out

    # -- sampling / encoding -----------------------------------------------
    def sample(self, rng: np.random.Generator) -> Config:
        cfg = {}
        for k in self.knobs:
            v = k.from_unit(float(rng.uniform()))
            cfg[k.name] = int(v) if k.is_int else v
        return cfg

    def encode(self, config: Mapping[str, Any]) -> np.ndarray:
        """Encode a config as a unit-interval feature vector for the surrogate."""
        return np.array(
            [k.to_unit(float(config[k.name])) for k in self.knobs], dtype=np.float64
        )

    # -- batched encoding (vectorized over configs) -------------------------
    def decode_batch(self, X: np.ndarray) -> List[Config]:
        """Decode an ``(N, len(self))`` unit matrix back into configs."""
        X = np.clip(np.asarray(X, dtype=np.float64), 0.0, 1.0)
        Vt = self._lo_t + X * (self._hi_t - self._lo_t)
        V = Vt.copy()
        V[:, self._log] = np.exp(Vt[:, self._log])
        V = np.clip(V, self._lo, self._hi)
        V = np.where(self._int, np.round(V), V)
        out: List[Config] = []
        for row in V:
            out.append({k.name: (int(v) if k.is_int else float(v))
                        for k, v in zip(self.knobs, row)})
        return out

    # -- array-native candidate generation (the BO hot path) -----------------
    def quantize_unit(self, X: np.ndarray) -> np.ndarray:
        """Snap unit-cube rows onto the knob grid: ``encode(decode(X))``
        without the per-config dict round-trip.

        Canonical rows are fixpoints, so two rows are equal iff they decode
        to the same config — which is what lets the batched optimizer dedup
        candidates in encoded space before scoring.
        """
        X = np.clip(np.asarray(X, dtype=np.float64), 0.0, 1.0)
        Vt = self._lo_t + X * (self._hi_t - self._lo_t)
        V = Vt.copy()
        V[..., self._log] = np.exp(Vt[..., self._log])
        V = np.clip(V, self._lo, self._hi)
        V = np.where(self._int, np.round(V), V)
        Ut = V.copy()
        Ut[..., self._log] = np.log(np.maximum(V[..., self._log],
                                               self._lo[self._log]))
        return (Ut - self._lo_t) / (self._hi_t - self._lo_t)

    def sample_batch_encoded(self, rng: np.random.Generator,
                             n: int) -> np.ndarray:
        """``n`` uniform random configs as canonical unit rows ``(n, d)`` —
        the encoded counterpart of :meth:`sample_batch`, decoded to dicts
        only for the suggestions the optimizer actually returns."""
        return self.quantize_unit(rng.uniform(size=(n, len(self))))

    def neighbors_batch(self, x: np.ndarray, rng: np.random.Generator,
                        n: int = 8, scale: float = 0.15) -> np.ndarray:
        """``n`` Gaussian local-search neighbours of encoded point ``x`` as
        canonical unit rows ``(n, d)`` (SMAC local search, batched)."""
        d = len(self)
        x = np.asarray(x, dtype=np.float64)
        U = rng.uniform(size=(n, d))
        mask = U < max(1.0 / d, 0.3)
        fix = rng.integers(d, size=n)
        empty = ~mask.any(axis=1)
        mask[empty, fix[empty]] = True
        Z = rng.normal(0.0, scale, size=(n, d))
        return self.quantize_unit(np.clip(x[None, :] + mask * Z, 0.0, 1.0))


# ---------------------------------------------------------------------------
# HeMem knob space — paper Table 2, verbatim.
# ---------------------------------------------------------------------------
HEMEM_SPACE = KnobSpace([
    Knob("sampling_period", 5000, 100, 10000, is_int=True, log=True,
         description="Number of memory load events to trigger sampling"),
    Knob("write_sampling_period", 10000, 1000, 20000, is_int=True, log=True,
         description="Number of store instructions to trigger sampling"),
    Knob("read_hot_threshold", 8, 1, 30, is_int=True,
         description="Minimum number of read access samples per page to classify it hot"),
    Knob("write_hot_threshold", 4, 1, 30, is_int=True,
         description="Minimum number of write samples per page to classify it hot"),
    Knob("cooling_threshold", 18, 4, 40, is_int=True,
         description="Number of sampled accesses to trigger page access count cooling"),
    Knob("migration_period", 10, 10, 5000, is_int=True, log=True,
         description="Interval of migration thread executions (ms)"),
    Knob("max_migration_rate", 10, 2, 20, is_int=True,
         description="Maximum migration rate allowed (GiB/s)"),
    Knob("cooling_pages", 8192, 1024, 65536, is_int=True, log=True,
         description="Number of pages cooled at a time"),
    Knob("hot_ring_reqs_threshold", 1024, 128, 4096, is_int=True, log=True,
         description="Number of hot pages processed at a time"),
    Knob("cold_ring_reqs_threshold", 32, 8, 256, is_int=True, log=True,
         description="Number of cold pages processed at a time"),
])


# ---------------------------------------------------------------------------
# HMSDK / DAMON knob space — §4.5. DAMON monitors via region sampling; HMSDK
# adds migration control. Ranges follow DAMON's documented limits.
# ---------------------------------------------------------------------------
HMSDK_SPACE = KnobSpace([
    Knob("nr_regions", 100, 10, 1000, is_int=True, log=True,
         description="Number of DAMON monitoring regions"),
    Knob("sample_us", 5000, 100, 100000, is_int=True, log=True,
         description="DAMON sampling interval (us); one page probed per region per sample"),
    Knob("aggr_us", 100000, 10000, 1000000, is_int=True, log=True,
         description="DAMON aggregation interval (us)"),
    Knob("hot_access_pct", 50, 5, 100, is_int=True,
         description="Region access rate (% of samples) to classify a region hot"),
    Knob("cold_aggr_intervals", 5, 1, 50, is_int=True,
         description="Aggregation intervals with zero accesses before a region is cold"),
    Knob("migration_period", 100, 10, 5000, is_int=True, log=True,
         description="Interval of HMSDK migration executions (ms)"),
    # HMSDK's DAMOS migration quota defaults are conservative
    Knob("max_migration_rate", 2, 1, 20, is_int=True,
         description="Maximum migration rate allowed (GiB/s, DAMOS quota)"),
])


# ---------------------------------------------------------------------------
# Memtis — §4.6. Memtis *dynamically* adapts the hot threshold; its remaining
# parameters are static in the original system. We expose them as a knob space
# too so the "tune Memtis as well" ablation is expressible, but the faithful
# MemtisEngine uses the defaults below (including the 100k write sampling
# period the paper calls out as a write-blindness cause).
# ---------------------------------------------------------------------------
MEMTIS_SPACE = KnobSpace([
    Knob("sampling_period", 4001, 100, 10000, is_int=True, log=True,
         description="PEBS sampling period for loads"),
    Knob("write_sampling_period", 100003, 1000, 200000, is_int=True, log=True,
         description="PEBS sampling period for stores (static 100k in Memtis)"),
    Knob("cooling_period_ms", 2000, 100, 10000, is_int=True, log=True,
         description="Static cooling period (ms)"),
    Knob("adaptation_period_ms", 1000, 100, 10000, is_int=True, log=True,
         description="Hot-threshold adaptation period (ms)"),
    Knob("migration_period", 100, 10, 5000, is_int=True, log=True,
         description="Interval of migration thread executions (ms)"),
    Knob("max_migration_rate", 10, 2, 20, is_int=True,
         description="Maximum migration rate allowed (GiB/s)"),
    Knob("warm_pct", 10, 0, 50, is_int=True,
         description="Percent of pages just below hot kept as 'warm' (not migrated)"),
])


SPACES: Dict[str, KnobSpace] = {
    "hemem": HEMEM_SPACE,
    "hmsdk": HMSDK_SPACE,
    "memtis": MEMTIS_SPACE,
}


def get_space(engine: str) -> KnobSpace:
    try:
        return SPACES[engine]
    except KeyError:
        raise KeyError(f"no knob space for engine {engine!r}; have {sorted(SPACES)}")
