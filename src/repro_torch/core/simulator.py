"""Epoch-based tiered-memory simulator of the PyTorch port: the black-box
f(θ) the optimizer tunes.

It executes a :class:`~repro_torch.core.workloads.Workload` against a
tiering engine on a :class:`Machine` and returns the workload's execution
time, modelling per epoch the bandwidth- and latency-bound access cost of
each tier, migration traffic on both tiers, write-protect stalls,
monitoring cost and engine overhead (the reference package's model,
unchanged).  :func:`run_simulation_batch` carries a batch of B candidate
configurations through one shared workload trace in the torch epoch loop
(:mod:`repro_torch.core.engine_torch`) on one device;
:func:`run_simulation_cells` runs several ``(workload, engine, configs)``
cells, one such pass each.

Scaling: ``workload.scale`` shrinks the page count and access volume while
time semantics stay real — effective bandwidth and memory-level parallelism
shrink by the same factor; knobs with page-count semantics are scaled by
:func:`scale_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from . import engine_torch
from .pages import PAGE_BYTES
from .registry import MACHINES as MACHINE_REGISTRY, register_machine
from .workloads import Workload

CACHELINE = 64


# ---------------------------------------------------------------------------
# Machines — paper Table 3
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    cores: int
    near_bw_gbs: float          # fast-tier bandwidth (GB/s)
    far_bw_read_gbs: float      # slow-tier read bandwidth (GB/s)
    far_bw_write_gbs: float     # slow-tier write bandwidth (GB/s)
    near_lat_ns: float
    far_lat_ns: float
    sample_us: float            # CPU time per PEBS sample
    scan_us: float              # CPU time per DAMON page-table probe
    default_threads: int


PMEM_LARGE = Machine("pmem-large", cores=24, near_bw_gbs=138.0,
                     far_bw_read_gbs=7.45, far_bw_write_gbs=2.25,
                     near_lat_ns=80.0, far_lat_ns=200.0,
                     sample_us=0.8, scan_us=0.05, default_threads=12)
PMEM_SMALL = Machine("pmem-small", cores=16, near_bw_gbs=46.0,
                     far_bw_read_gbs=6.8, far_bw_write_gbs=1.85,
                     near_lat_ns=80.0, far_lat_ns=200.0,
                     sample_us=0.8, scan_us=0.05, default_threads=4)
NUMA = Machine("numa", cores=20, near_bw_gbs=56.0,
               far_bw_read_gbs=36.0, far_bw_write_gbs=36.0,
               near_lat_ns=95.0, far_lat_ns=145.0,
               sample_us=0.8, scan_us=0.05, default_threads=12)

for _m in (PMEM_LARGE, PMEM_SMALL, NUMA):
    register_machine(_m)


def get_machine(name: str) -> Machine:
    """Look up a registered machine profile (did-you-mean on unknown names)."""
    return MACHINE_REGISTRY.get(name)


def _as_machine(machine: "Machine | str") -> Machine:
    if isinstance(machine, str):
        return get_machine(machine)
    if machine.name not in MACHINE_REGISTRY:
        register_machine(machine)
    return machine


# ---------------------------------------------------------------------------
# Config scaling (page-count-semantics knobs only)
# ---------------------------------------------------------------------------
_PAGE_SEMANTIC_KNOBS = {
    "hemem": ("cooling_pages", "hot_ring_reqs_threshold",
              "cold_ring_reqs_threshold"),
    "kv-hemem": ("cooling_pages", "hot_ring_reqs_threshold",
                 "cold_ring_reqs_threshold"),
    "hmsdk": ("nr_regions",),
    "memtis": (),
    "static": (),
    "oracle": (),
}


def scale_config(engine_name: str, config: Mapping[str, Any],
                 scale: float) -> Dict[str, Any]:
    out = dict(config)
    for k in _PAGE_SEMANTIC_KNOBS.get(engine_name, ()):
        if k in out:
            out[k] = max(1, int(round(out[k] * scale)))
    return out


@dataclasses.dataclass
class SimResult:
    workload: str
    engine: str
    machine: str
    config: Dict[str, Any]
    total_s: float
    epoch_wall_ms: np.ndarray       # per-epoch wall time
    cum_migrations: np.ndarray      # cumulative migrated pages over epochs
    fast_hit_rate: np.ndarray       # fraction of accesses served by fast tier
    sampling_ms: np.ndarray
    stall_ms: np.ndarray
    heatmap: Optional[np.ndarray] = None   # (epochs, heat_bins) access heat
    placement: Optional[np.ndarray] = None  # (epochs, heat_bins) frac in fast


# ---------------------------------------------------------------------------
# Access-cost math, on (B,) float32 tensors.  The arithmetic order is the
# reference's; torch.clamp stands in for maximum/minimum with a constant.
# ---------------------------------------------------------------------------
def _access_cost(acc_f, acc_s, reads_s, writes_s, promote_bytes,
                 demote_bytes, w_mig, est_wall_ms, samples, engine_ms,
                 const: Mapping[str, float]):
    """Per-config epoch wall-time model; ``const`` values are floats that
    are exact in float32."""
    bytes_f = acc_f * CACHELINE
    # bandwidth-bound terms (migration traffic shares the devices)
    t_near = (bytes_f + promote_bytes + demote_bytes) / const["near_bw"]
    t_far = ((reads_s * CACHELINE + promote_bytes) / const["far_bw_r"]
             + (writes_s * CACHELINE + demote_bytes) / const["far_bw_w"])
    # latency-bound term
    t_lat = (acc_f * const["near_lat_s"] + acc_s * const["far_lat_s"]) \
        / const["eff_par"]
    t_mem = torch.maximum(torch.maximum(t_near, t_far), t_lat)

    # write-protect stalls: only writes landing during a page's copy window
    # stall, each for half the copy time on average
    page_copy_s = const["page_copy_s"]
    epoch_s_est = torch.clamp(est_wall_ms * 1e-3, min=page_copy_s)
    frac_in_flight = torch.clamp(page_copy_s / epoch_s_est, max=1.0)
    stall_s = torch.where(
        (promote_bytes + demote_bytes) > 0,
        w_mig * frac_in_flight * (page_copy_s / 2.0) / const["stall_denom"],
        0.0)

    sampling_s = samples * const["probe_us"] * 1e-6 / const["threads_floor"]
    engine_s = engine_ms * 1e-3
    wall_ms = (torch.clamp(t_mem * 1e3, min=const["compute_ms"])
               + stall_s * 1e3 + sampling_s * 1e3 + engine_s * 1e3)
    hit_rate = acc_f / torch.clamp(acc_f + acc_s, min=1e-12)
    return wall_ms, stall_s, sampling_s, hit_rate


def _epoch_consts(workload: Workload, engine_name: str, machine: Machine,
                  page_bytes: int) -> Dict[str, float]:
    """The scalar constants of the access-cost model.  Effective parallel
    resources shrink with ``scale`` so time semantics stay real."""
    threads = workload.threads
    scale = workload.scale
    eff_bw = scale
    eff_par = threads * workload.mlp * scale
    near_bw = machine.near_bw_gbs * 1e9 * eff_bw
    far_bw_r = machine.far_bw_read_gbs * 1e9 * eff_bw
    far_bw_w = machine.far_bw_write_gbs * 1e9 * eff_bw
    # engines that sample pay per-sample CPU; DAMON pays per scan probe
    probe_us = machine.scan_us if engine_name == "hmsdk" else machine.sample_us
    return {
        "near_bw": near_bw, "far_bw_r": far_bw_r, "far_bw_w": far_bw_w,
        "near_lat_s": machine.near_lat_ns * 1e-9,
        "far_lat_s": machine.far_lat_ns * 1e-9,
        "eff_par": eff_par,
        "page_copy_s": page_bytes / max(min(far_bw_r, near_bw), 1.0),
        "stall_denom": max(threads * scale, 1e-9),
        "probe_us": probe_us, "threads_floor": max(threads, 1),
        "compute_ms": workload.compute_ms,
    }


def _fast_capacity(workload: Workload, fast_slow_ratio: float,
                   fast_capacity_pages: Optional[int]) -> int:
    if fast_capacity_pages is not None:
        return int(fast_capacity_pages)
    return max(1, int(round(workload.n_pages / (1.0 + fast_slow_ratio))))


def _run_batch(workload: Workload, engine_name: str,
               configs: Sequence[Mapping[str, Any]], machine: Machine,
               fast_slow_ratio: float, seeds, sampler: str,
               record_heatmap: bool, heat_bins: int,
               fast_capacity_pages: Optional[int], crn: bool,
               device) -> List[SimResult]:
    """One pass of the torch epoch loop over the whole batch."""
    B = len(configs)
    n = workload.n_pages
    fast_cap = _fast_capacity(workload, fast_slow_ratio, fast_capacity_pages)
    sim_cfgs = [scale_config(engine_name, c, workload.scale) for c in configs]
    const = _epoch_consts(workload, engine_name, machine, PAGE_BYTES)
    out = engine_torch.run_epochs(
        workload, engine_name, sim_cfgs, const, fast_cap, PAGE_BYTES,
        seeds, sampler, crn=crn, record_placement=record_heatmap,
        device=device)
    wall = np.asarray(out["wall_ms"], dtype=np.float64)
    cum_mig = np.asarray(out["cum_migrations"], dtype=np.float64)
    hit_rate = np.asarray(out["hit_rate"], dtype=np.float64)
    sampling_ms = np.asarray(out["sampling_ms"], dtype=np.float64)
    stall_ms = np.asarray(out["stall_ms"], dtype=np.float64)
    n_epochs = workload.n_epochs
    heat = place = None
    if record_heatmap:
        bin_of = np.arange(n) * heat_bins // n
        bin_sizes = np.maximum(np.bincount(bin_of, minlength=heat_bins), 1)
        heat = np.zeros((n_epochs, heat_bins))
        place = np.zeros((B, n_epochs, heat_bins))
        in_fast = out["in_fast"]
        acc_t = (out["trace_reads"] + out["trace_writes"]).astype(np.float64)
        for e in range(n_epochs):
            heat[e] = np.bincount(bin_of, weights=acc_t[e],
                                  minlength=heat_bins)
            for b in range(B):
                place[b, e] = np.bincount(
                    bin_of, weights=in_fast[e, b].astype(np.float64),
                    minlength=heat_bins) / bin_sizes
    return [SimResult(
        workload=workload.key, engine=engine_name, machine=machine.name,
        config=dict(configs[b]), total_s=float(wall[:, b].sum() / 1e3),
        epoch_wall_ms=wall[:, b].copy(), cum_migrations=cum_mig[:, b].copy(),
        fast_hit_rate=hit_rate[:, b].copy(),
        sampling_ms=sampling_ms[:, b].copy(),
        stall_ms=stall_ms[:, b].copy(),
        heatmap=heat if record_heatmap else None,
        placement=place[b] if record_heatmap else None) for b in range(B)]


def run_simulation_cells(cells,
                         machine: "Machine | str" = PMEM_LARGE,
                         fast_slow_ratio: float = 8.0,
                         seeds=0,
                         sampler: str = "elementwise",
                         record_heatmap: bool = False,
                         heat_bins: int = 128,
                         fast_capacity_pages: Optional[int] = None,
                         crn: bool = False,
                         device="cuda") -> List[List[SimResult]]:
    """Evaluate many ``(workload, engine_name, configs)`` *cells*, each as
    one pass of the epoch loop on ``device``, in input order; returns one
    ``List[SimResult]`` per cell.

    ``seeds`` is an int (shared by every config of every cell) or one seed
    sequence per cell (one seed per config).  ``crn=True`` is per cell:
    every row shares the cell's first seed.  (The reference spreads cells
    over a process pool; on one card they run one after another.)
    """
    machine = _as_machine(machine)
    cells = [(wl, eng, [dict(c) for c in cfgs]) for wl, eng, cfgs in cells]
    if np.ndim(seeds) == 0:
        cell_seeds = [[int(seeds)] * len(cfgs) for _, _, cfgs in cells]
    else:
        rows = list(seeds)
        if any(np.ndim(r) == 0 for r in rows):
            raise ValueError("seeds must be an int or one seed sequence "
                             "per cell (one seed per config); got a flat "
                             "sequence — wrap it per cell")
        cell_seeds = [[int(s) for s in row] for row in rows]
        if len(cell_seeds) != len(cells) or any(
                len(row) != len(cells[i][2])
                for i, row in enumerate(cell_seeds)):
            raise ValueError("seeds must be an int or one seed sequence "
                             "per cell (one seed per config)")
    if crn:
        cell_seeds = [[row[0]] * len(row) for row in cell_seeds]
    return [_run_batch(wl, eng, cfgs, machine, fast_slow_ratio, cell_seeds[i],
                       sampler, record_heatmap, heat_bins,
                       fast_capacity_pages, crn, device) if cfgs else []
            for i, (wl, eng, cfgs) in enumerate(cells)]


def run_simulation_batch(workload: Workload, engine_name: str,
                         configs: Sequence[Mapping[str, Any]],
                         machine: "Machine | str" = PMEM_LARGE,
                         fast_slow_ratio: float = 8.0,
                         seeds=0,
                         sampler: str = "elementwise",
                         record_heatmap: bool = False,
                         heat_bins: int = 128,
                         fast_capacity_pages: Optional[int] = None,
                         crn: bool = False,
                         device="cuda") -> List[SimResult]:
    """Simulate ``workload`` under B candidate configs in one pass on
    ``device`` (one cell of :func:`run_simulation_cells`).

    The trace is generated once and shared; engine state carries a leading
    batch axis.  ``seeds`` is an int (every config) or one seed per config;
    draws are keyed by ``(seed, batch row)``.  ``crn=True`` shares the
    monitoring noise bitwise across all B configs (every row uses the
    first seed), so within-batch comparisons see identical noise.
    """
    configs = list(configs)
    B = len(configs)
    if B == 0:
        return []
    if np.ndim(seeds) == 0:
        seeds = [int(seeds)] * B
    seeds = [int(s) for s in seeds]
    if len(seeds) != B:
        raise ValueError("seeds must be an int or one seed per config")
    return run_simulation_cells(
        [(workload, engine_name, configs)], machine, fast_slow_ratio,
        [seeds], sampler, record_heatmap, heat_bins, fast_capacity_pages,
        crn, device)[0]
