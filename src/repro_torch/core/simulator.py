"""Epoch-based tiered-memory simulator of the PyTorch port: the black-box
f(θ) the optimizer tunes.

It executes a :class:`~repro_torch.core.workloads.Workload` against a
tiering engine on a :class:`Machine` and returns the workload's execution
time, modelling per epoch the bandwidth- and latency-bound access cost of
each tier, migration traffic on both tiers, write-protect stalls,
monitoring cost and engine overhead (the reference package's model,
unchanged).  :func:`run_simulation_batch` carries a batch of B candidate
configurations through one shared workload trace;
:func:`run_simulation_cells` runs several ``(workload, engine, configs)``
cells; :func:`run_simulation_segment` evaluates an epoch range (the tune
service's and the online tuner's hook).

**Two backends** (``backend=``):

* ``"torch"`` (default) -- the compiled epoch loop
  (:mod:`repro_torch.core.engine_torch`) on ``device``, ``"cuda"`` unless
  the caller asks for the CPU.  Counter-based monitoring draws (equal in
  distribution to the numpy loop's, not stream-compatible), exact
  migration selection through the ``select_topk`` kernel
  (``exact_select=False``: the quantized ablation), ``crn=True`` for
  common random numbers across a batch, and checkpointable segments.  An
  engine or sampler it does not cover (a numpy engine registered without
  a compiled definition) runs the numpy epoch loop with the torch cost
  model on ``device``; one warning line per cause records the downgrade.
* ``"numpy"`` -- the reference package's numpy epoch loop, bitwise its
  results: per-config ``np.random.default_rng`` streams seeded exactly as
  the single-config path, so a batch equals B sequential runs with
  matched seeds and sampler.  ``workers=N`` (or ``"auto"``) shards a
  batch over a pool of spawned processes; sharding never changes results.

The deprecated loose-kwargs entry points (:func:`run_simulation`,
:func:`evaluate`, :func:`evaluate_batch`, :class:`Scenario`) remain as
shims over :class:`~repro_torch.core.study.Study` on the numpy backend,
bitwise the reference's shims.

Scaling: ``workload.scale`` shrinks the page count and access volume while
time semantics stay real — effective bandwidth and memory-level parallelism
shrink by the same factor; knobs with page-count semantics are scaled by
:func:`scale_config`.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..spans import span
from . import engine_torch
from ._deprecation import warn_deprecated
from .engine import make_batch_engine
from .knobs import get_space
from .pages import BatchTierState, PAGE_BYTES, migration_rate_pages
from .registry import (BACKENDS, ENGINES, MACHINES as MACHINE_REGISTRY,
                       SAMPLERS, WORKLOADS, register_backend,
                       register_machine)
from .workloads import Workload, make_workload

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
#: TPU v5e chip with host-DRAM offload over PCIe, the reference's modeled
#: two-tier system (a profile of the simulator, not a measurement).
#: "Threads" = the single decode stream; MLP comes from DMA queue depth.
TPU_V5E_HOST = Machine("tpu-v5e-host", cores=1, near_bw_gbs=819.0,
                       far_bw_read_gbs=16.0, far_bw_write_gbs=16.0,
                       near_lat_ns=600.0, far_lat_ns=2500.0,
                       sample_us=0.05, scan_us=0.05, default_threads=1)

for _m in (PMEM_LARGE, PMEM_SMALL, NUMA, TPU_V5E_HOST):
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
# Access-cost math, on (B,) arrays of an array module ``xp``: numpy float64
# on the host (the numpy backend) or torch float32 (the compiled loop).  The
# arithmetic order is the reference's; ``xp.clip`` with one open bound is
# its maximum/minimum with a constant (the same values on both modules).
# ---------------------------------------------------------------------------
def _access_cost(xp, acc_f, acc_s, reads_s, writes_s, promote_bytes,
                 demote_bytes, w_mig, est_wall_ms, samples, engine_ms,
                 const: Mapping[str, float]):
    """Per-config epoch wall-time model; on torch, ``const`` values are
    floats that are exact in float32."""
    bytes_f = acc_f * CACHELINE
    # bandwidth-bound terms (migration traffic shares the devices)
    t_near = (bytes_f + promote_bytes + demote_bytes) / const["near_bw"]
    t_far = ((reads_s * CACHELINE + promote_bytes) / const["far_bw_r"]
             + (writes_s * CACHELINE + demote_bytes) / const["far_bw_w"])
    # latency-bound term
    t_lat = (acc_f * const["near_lat_s"] + acc_s * const["far_lat_s"]) \
        / const["eff_par"]
    t_mem = xp.maximum(xp.maximum(t_near, t_far), t_lat)

    # write-protect stalls: only writes landing during a page's copy window
    # stall, each for half the copy time on average
    page_copy_s = const["page_copy_s"]
    epoch_s_est = xp.clip(est_wall_ms * 1e-3, page_copy_s, None)
    frac_in_flight = xp.clip(page_copy_s / epoch_s_est, None, 1.0)
    stall_s = xp.where(
        (promote_bytes + demote_bytes) > 0,
        w_mig * frac_in_flight * (page_copy_s / 2.0) / const["stall_denom"],
        0.0)

    sampling_s = samples * const["probe_us"] * 1e-6 / const["threads_floor"]
    engine_s = engine_ms * 1e-3
    wall_ms = (xp.clip(t_mem * 1e3, const["compute_ms"], None)
               + stall_s * 1e3 + sampling_s * 1e3 + engine_s * 1e3)
    hit_rate = acc_f / xp.clip(acc_f + acc_s, 1e-12, None)
    return wall_ms, stall_s, sampling_s, hit_rate


def _numpy_cost_fn():
    return functools.partial(_access_cost, np)


def _torch_cost(acc_f, acc_s, reads_s, writes_s, promote_bytes, demote_bytes,
                w_mig, est_wall_ms, samples, engine_ms,
                const: Mapping[str, float], device="cuda"):
    """The torch cost model on host ``(B,)`` arrays: float32 on
    ``device``, as the compiled loop computes it; numpy float32 out."""
    dev = engine_torch.resolve_device(device)
    args = [torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
            for a in (acc_f, acc_s, reads_s, writes_s, promote_bytes,
                      demote_bytes, w_mig, est_wall_ms, samples, engine_ms)]
    out = _access_cost(torch, *args, {k: engine_torch._f32(v)
                                      for k, v in const.items()})
    return tuple(o.cpu().numpy() for o in out)


def _torch_cost_fn():
    return _torch_cost


# backends are zero-argument factories returning the numpy epoch loop's
# vectorized cost callable: float64 numpy on the host, or the compiled
# loop's float32 torch model (on the run's device)
register_backend("numpy", _numpy_cost_fn)
register_backend("torch", _torch_cost_fn)


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
               device, batch_offset: int = 0,
               exact_select: bool = True) -> List[SimResult]:
    """One pass of the torch epoch loop over the whole batch."""
    B = len(configs)
    n = workload.n_pages
    fast_cap = _fast_capacity(workload, fast_slow_ratio, fast_capacity_pages)
    sim_cfgs = [scale_config(engine_name, c, workload.scale) for c in configs]
    const = _epoch_consts(workload, engine_name, machine, PAGE_BYTES)
    out = engine_torch.run_epochs(
        workload, engine_name, sim_cfgs, const, fast_cap, PAGE_BYTES,
        seeds, sampler, crn=crn, batch_offset=batch_offset,
        record_placement=record_heatmap, device=device,
        exact_select=exact_select)
    with span("repro_torch.sim.results"):
        wall = np.asarray(out["wall_ms"], dtype=np.float64)
        cum_mig = np.asarray(out["cum_migrations"], dtype=np.float64)
        hit_rate = np.asarray(out["hit_rate"], dtype=np.float64)
        sampling_ms = np.asarray(out["sampling_ms"], dtype=np.float64)
        stall_ms = np.asarray(out["stall_ms"], dtype=np.float64)
        n_epochs = workload.n_epochs
        heat = place = None
        if record_heatmap:
            bin_of = np.arange(n) * heat_bins // n
            bin_sizes = np.maximum(np.bincount(bin_of, minlength=heat_bins),
                                   1)
            heat = np.zeros((n_epochs, heat_bins))
            place = np.zeros((B, n_epochs, heat_bins))
            in_fast = out["in_fast"]
            acc_t = (out["trace_reads"]
                     + out["trace_writes"]).astype(np.float64)
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
            epoch_wall_ms=wall[:, b].copy(),
            cum_migrations=cum_mig[:, b].copy(),
            fast_hit_rate=hit_rate[:, b].copy(),
            sampling_ms=sampling_ms[:, b].copy(),
            stall_ms=stall_ms[:, b].copy(),
            heatmap=heat if record_heatmap else None,
            placement=place[b] if record_heatmap else None) for b in range(B)]


#: engines whose torch fallback was already warned about (one line each)
_TORCH_FALLBACK_WARNED: set = set()


def _warn_torch_fallback(engine_name: str) -> None:
    """One warning line when ``backend="torch"`` runs an engine with no
    compiled definition: the numpy epoch loop runs it instead (with the
    torch cost model on the run's device)."""
    if engine_name in _TORCH_FALLBACK_WARNED:
        return
    _TORCH_FALLBACK_WARNED.add(engine_name)
    logging.getLogger(__name__).warning(
        "backend='torch': engine %r has no compiled definition (compiled: "
        "%s); register an EngineDef under its name to compile it; falling "
        "back to the numpy epoch loop (torch cost model only)",
        engine_name, engine_torch.COMPILED.names())


def _run_batch_local(workload: Workload, engine_name: str,
                     configs: Sequence[Mapping[str, Any]],
                     machine: Machine, fast_slow_ratio: float,
                     seeds, sampler: str, record_heatmap: bool,
                     heat_bins: int, fast_capacity_pages: Optional[int],
                     backend: str, crn: bool = False,
                     batch_offset: int = 0,
                     exact_select: bool = True,
                     epoch_stop: Optional[int] = None,
                     device="cuda") -> List[SimResult]:
    """One batch on one backend, in this process: the compiled loop for an
    engine with a compiled definition under ``backend="torch"`` (which
    refuses a sampler or size it does not cover), else the numpy epoch
    loop (the reference's, with the backend's cost model)."""
    if backend == "torch":
        if engine_name in engine_torch.COMPILED:
            return _run_batch(workload, engine_name, configs, machine,
                              fast_slow_ratio, seeds, sampler,
                              record_heatmap, heat_bins,
                              fast_capacity_pages, crn, device,
                              batch_offset, exact_select)
        engine_torch.resolve_device(device)
        _warn_torch_fallback(engine_name)
    if crn:
        raise ValueError(
            "crn=True (common random numbers) requires the compiled torch "
            "loop (backend='torch' and an engine with a compiled "
            "definition): the numpy "
            "engines consume sequential RNG streams that cannot be shared "
            f"across configs (got backend={backend!r}, "
            f"engine={engine_name!r}, sampler={sampler!r}, "
            f"n_pages={workload.n_pages})")
    B = len(configs)
    n = workload.n_pages
    scale = workload.scale
    fast_capacity_pages = _fast_capacity(workload, fast_slow_ratio,
                                         fast_capacity_pages)
    tier = BatchTierState(B, n, fast_capacity_pages)
    sim_cfgs = [scale_config(engine_name, c, scale) for c in configs]
    engine = make_batch_engine(engine_name, sim_cfgs, tier, seeds=seeds,
                               sampler=sampler)

    page_bytes = tier.page_bytes
    const = _epoch_consts(workload, engine_name, machine, page_bytes)

    n_epochs = workload.n_epochs if epoch_stop is None \
        else min(int(epoch_stop), workload.n_epochs)
    wall = np.zeros((n_epochs, B))
    cum_mig = np.zeros((n_epochs, B))
    hit_rate = np.zeros((n_epochs, B))
    sampling_ms_a = np.zeros((n_epochs, B))
    stall_ms_a = np.zeros((n_epochs, B))
    heat = np.zeros((n_epochs, heat_bins)) if record_heatmap else None
    place = np.zeros((B, n_epochs, heat_bins)) if record_heatmap else None
    bin_of = (np.arange(n) * heat_bins // n) if record_heatmap else None
    bin_sizes = np.maximum(np.bincount(bin_of, minlength=heat_bins), 1) \
        if record_heatmap else None

    mig_cost_free = engine.zero_cost_migrations
    rates = engine.max_rates_gibs()
    est_wall_ms = np.full(B, workload.epoch_ms)  # running estimate
    total_mig = np.zeros(B)
    # per-config reduction buffers
    acc_f = np.zeros(B)
    reads_s = np.zeros(B)
    writes_s = np.zeros(B)
    w_mig = np.zeros(B)
    n_promote = np.zeros(B)
    n_demote = np.zeros(B)
    cost_fn = BACKENDS.get(backend)()
    if backend == "torch":
        cost_fn = functools.partial(cost_fn, device=device)

    for e in range(n_epochs):
        reads, writes = workload.epoch_access(e)
        touched = (reads + writes) > (1.0 / max(n, 1))
        tier.allocate_first_touch(touched)

        engine.observe(reads, writes, est_wall_ms)
        max_pages = migration_rate_pages(rates, est_wall_ms, page_bytes,
                                         scale)
        plans = engine.plan(est_wall_ms, max_pages)
        tier.apply(plans)

        acc = reads + writes
        acc_sum = float(acc.sum())
        # boolean-mask extraction sums, not matvecs: the float summation
        # order is the reference's, so batches equal sequential runs
        for b, plan in enumerate(plans):
            in_fast_b = tier.in_fast[b]
            acc_f[b] = float(acc[in_fast_b].sum())
            slow = ~in_fast_b
            reads_s[b] = float(reads[slow].sum())
            writes_s[b] = float(writes[slow].sum())
            n_promote[b] = len(plan.promote)
            n_demote[b] = len(plan.demote)
            total_mig[b] += plan.n_pages
            if plan.n_pages and not mig_cost_free:
                w_mig[b] = float(writes[plan.promote].sum()
                                 + writes[plan.demote].sum())
            else:
                w_mig[b] = 0.0
        cum_mig[e] = total_mig
        acc_s = acc_sum - acc_f
        if mig_cost_free:
            promote_bytes = np.zeros(B)
            demote_bytes = np.zeros(B)
        else:
            promote_bytes = n_promote * page_bytes
            demote_bytes = n_demote * page_bytes

        wall_ms, stall_s, sampling_s, hr = cost_fn(
            acc_f, acc_s, reads_s, writes_s, promote_bytes, demote_bytes,
            w_mig, est_wall_ms, engine.samples_last_epoch,
            engine.overhead_ms_last_epoch, const)
        wall[e] = wall_ms
        est_wall_ms = np.asarray(wall_ms, dtype=np.float64)
        hit_rate[e] = hr
        sampling_ms_a[e] = np.asarray(sampling_s) * 1e3
        stall_ms_a[e] = np.asarray(stall_s) * 1e3

        if record_heatmap:
            heat[e] = np.bincount(bin_of, weights=acc, minlength=heat_bins)
            for b in range(B):
                place[b, e] = (np.bincount(
                    bin_of, weights=tier.in_fast[b].astype(np.float64),
                    minlength=heat_bins) / bin_sizes)

    return [SimResult(
        workload=workload.key, engine=engine_name, machine=machine.name,
        config=dict(configs[b]), total_s=float(wall[:, b].sum() / 1e3),
        epoch_wall_ms=wall[:, b].copy(), cum_migrations=cum_mig[:, b].copy(),
        fast_hit_rate=hit_rate[:, b].copy(),
        sampling_ms=sampling_ms_a[:, b].copy(),
        stall_ms=stall_ms_a[:, b].copy(),
        # the access heatmap comes from the shared trace, so all B results
        # reference one array; placement is per config
        heatmap=heat if record_heatmap else None,
        placement=place[b] if record_heatmap else None) for b in range(B)]


# ---------------------------------------------------------------------------
# Process-pool sharding of numpy batches (workers=N)
# ---------------------------------------------------------------------------
_POOL = None
_POOL_SIZE = 0


def _get_pool(workers: int):
    """The shared pool of spawned simulator processes, grown (never
    shrunk) to ``workers``.  Always spawn: a forked child of a process
    whose torch runtime already started threads can hang."""
    global _POOL, _POOL_SIZE
    if _POOL is None or workers > _POOL_SIZE:
        import concurrent.futures
        import multiprocessing as mp
        if _POOL is None:
            import atexit
            atexit.register(shutdown_pool)
        else:
            _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("spawn"))
        _POOL_SIZE = workers
    return _POOL


def shutdown_pool() -> None:
    """Stop the shared pool's processes (the next sharded batch starts a
    new pool)."""
    global _POOL, _POOL_SIZE
    if _POOL is not None:
        _POOL.shutdown(wait=True, cancel_futures=True)
    _POOL = None
    _POOL_SIZE = 0


def _shard_worker(args):
    (wl_spec, components, engine_name, configs, machine, fast_slow_ratio,
     seeds, sampler, record_heatmap, heat_bins, fast_capacity_pages,
     backend) = args
    # a spawned worker starts from a fresh interpreter that only imported
    # this module, so components registered (or overridden) by user code
    # are unknown there; the parent's resolved objects shipped in the
    # payload are authoritative
    for reg, name, obj in ((ENGINES, engine_name, components[0]),
                           (WORKLOADS, wl_spec[0], components[1]),
                           (SAMPLERS, sampler, components[2]),
                           (BACKENDS, backend, components[3])):
        reg.register(name, obj, overwrite=True)
    wl = make_workload(*wl_spec)
    return _run_batch_local(wl, engine_name, configs, machine,
                            fast_slow_ratio, seeds, sampler, record_heatmap,
                            heat_bins, fast_capacity_pages, backend)


def _resolve_workers(workers, batch: int) -> int:
    if workers in ("auto", 0, None):
        workers = os.cpu_count() or 1
    return max(1, min(int(workers), batch))


def run_simulation_cells(cells,
                         machine: "Machine | str" = PMEM_LARGE,
                         fast_slow_ratio: float = 8.0,
                         seeds=0,
                         sampler: str = "elementwise",
                         record_heatmap: bool = False,
                         heat_bins: int = 128,
                         fast_capacity_pages: Optional[int] = None,
                         crn: bool = False,
                         device="cuda",
                         backend: str = "torch",
                         workers=1,
                         exact_select: bool = True) -> List[List[SimResult]]:
    """Evaluate many ``(workload, engine_name, configs)`` *cells*, in input
    order; returns one ``List[SimResult]`` per cell.

    ``backend="torch"``: each cell is one pass of the compiled epoch loop
    on ``device``, one after another.  ``backend="numpy"``: the
    reference's numpy loop; with ``workers > 1`` (or ``"auto"``) every
    cell is split into config shards and all shards of all cells go to
    one pool of spawned processes at once, so the pool stays saturated
    even when cells are smaller than the worker count.  Scheduling never
    changes results.

    ``seeds`` is an int (shared by every config of every cell) or one seed
    sequence per cell (one seed per config).  ``crn=True`` is per cell:
    every row shares the cell's first seed.
    """
    machine = _as_machine(machine)
    cells = [(wl, eng, [dict(c) for c in cfgs]) for wl, eng, cfgs in cells]
    if np.isscalar(seeds) or (isinstance(seeds, np.ndarray)
                              and seeds.ndim == 0):
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
        # per cell: every row shares the CELL's first seed, fixed before
        # any sharding so a shard never keys off its own first seed
        cell_seeds = [[row[0]] * len(row) for row in cell_seeds]
    total = sum(len(cfgs) for _, _, cfgs in cells)
    n_workers = _resolve_workers(workers, max(total, 1)) \
        if backend == "numpy" else 1
    if n_workers == 1:
        return [_run_batch_local(wl, eng, cfgs, machine, fast_slow_ratio,
                                 cell_seeds[i], sampler, record_heatmap,
                                 heat_bins, fast_capacity_pages, backend,
                                 crn=crn, exact_select=exact_select,
                                 device=device) if cfgs else []
                for i, (wl, eng, cfgs) in enumerate(cells)]
    if crn:
        raise ValueError("crn=True requires the compiled torch loop; the "
                         "numpy engines' sequential RNG streams cannot be "
                         "shared across configs")

    # one flat shard queue across all cells: shards target `n_workers`
    # equal slices of the total config count, never crossing a cell
    shard_size = max(1, -(-total // n_workers))
    pool = _get_pool(n_workers)
    futures = []
    for ci, (wl, eng, cfgs) in enumerate(cells):
        wl_spec = (wl.name, wl.input_name, wl.threads, wl.scale, wl.seed)
        # resolved components travel with the shard, so spawned workers
        # can serve names registered outside this module
        components = (ENGINES.get(eng), WORKLOADS.get(wl.name),
                      SAMPLERS.get(sampler), BACKENDS.get(backend))
        for lo in range(0, len(cfgs), shard_size):
            hi = min(lo + shard_size, len(cfgs))
            fut = pool.submit(_shard_worker, (
                wl_spec, components, eng, cfgs[lo:hi], machine,
                fast_slow_ratio, cell_seeds[ci][lo:hi], sampler,
                record_heatmap, heat_bins, fast_capacity_pages, backend))
            futures.append((ci, fut))
    out: List[List[SimResult]] = [[] for _ in cells]
    for ci, fut in futures:  # shards were submitted in config order per cell
        out[ci].extend(fut.result())
    return out


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
                         device="cuda",
                         backend: str = "torch",
                         workers=1,
                         exact_select: bool = True) -> List[SimResult]:
    """Simulate ``workload`` under B candidate configs in one pass (one
    cell of :func:`run_simulation_cells`).

    The trace is generated once and shared; engine state carries a leading
    batch axis.  ``seeds`` is an int (every config) or one seed per config.
    ``backend="torch"`` (default): the compiled loop on ``device``, draws
    keyed by ``(seed, batch row)``; ``crn=True`` shares the monitoring
    noise bitwise across all B configs; ``exact_select=False`` plans with
    the quantized ablation.  ``backend="numpy"``: the reference's numpy
    loop, bitwise its results (B sequential runs with matched seeds and
    sampler), sharded over ``workers`` spawned processes.
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
        crn, device, backend, workers, exact_select)[0]


def run_simulation_segment(workload: Workload, engine_name: str,
                           configs: Sequence[Mapping[str, Any]],
                           machine: "Machine | str" = PMEM_LARGE,
                           fast_slow_ratio: float = 8.0,
                           seeds=0,
                           sampler: str = "sparse",
                           fast_capacity_pages: Optional[int] = None,
                           crn: bool = False,
                           batch_offset: int = 0,
                           epoch_start: int = 0,
                           epoch_stop: Optional[int] = None,
                           carry: Any = None,
                           return_carry: bool = False,
                           device="cuda",
                           backend: str = "torch",
                           exact_select: bool = True) -> Dict[str, Any]:
    """Partial-epoch evaluation -- the tune service's checkpoint/restore
    hook.

    Evaluates epochs ``[epoch_start, epoch_stop)`` of the workload (the
    full range by default) and returns ``{"wall_ms": (seg, B) float64
    array, "carry": host carry or None, ...}``.  Per-epoch walls are
    bitwise equal to the matching rows of a whole
    :func:`run_simulation_batch` pass.

    On the compiled loop (``backend="torch"``) draws are keyed by absolute
    epoch: ``return_carry=True`` returns the host carry
    (:func:`~repro_torch.core.engine_torch.carry_to_host`, picklable, in
    the reference's layout), which the next segment takes as ``carry``
    with ``epoch_start`` at this segment's stop, and the result carries
    the segment's trace (``trace_reads``/``trace_writes``, ``(seg, n)``
    float32).  ``crn=True`` gives every row the first seed.  The numpy
    loop has sequential RNG state that cannot be checkpointed, so it runs
    only prefixes (``epoch_start=0``, no carry): exact, since a prefix of
    a whole run is bitwise its first rows.
    """
    configs = [dict(c) for c in configs]
    B = len(configs)
    machine = _as_machine(machine)
    if np.ndim(seeds) == 0:
        seeds = [int(seeds)] * B
    seeds = [int(s) for s in seeds]
    if len(seeds) != B:
        raise ValueError("seeds must be an int or one seed per config")
    if crn:
        seeds = [seeds[0]] * B
    if backend == "torch" and engine_name in engine_torch.COMPILED:
        fast_cap = _fast_capacity(workload, fast_slow_ratio,
                                  fast_capacity_pages)
        sim_cfgs = [scale_config(engine_name, c, workload.scale)
                    for c in configs]
        const = _epoch_consts(workload, engine_name, machine, PAGE_BYTES)
        out = engine_torch.run_epochs(
            workload, engine_name, sim_cfgs, const, fast_cap, PAGE_BYTES,
            seeds, sampler, crn=crn, batch_offset=batch_offset,
            epoch_start=epoch_start, epoch_stop=epoch_stop, carry=carry,
            return_carry=return_carry, device=device,
            exact_select=exact_select)
        return {"wall_ms": np.asarray(out["wall_ms"], dtype=np.float64),
                "carry": out.get("carry"),
                "trace_reads": out["trace_reads"],
                "trace_writes": out["trace_writes"]}
    if backend == "torch":
        engine_torch.resolve_device(device)
        _warn_torch_fallback(engine_name)
    if crn:
        raise ValueError(
            "crn=True requires the compiled torch loop; see "
            "run_simulation_batch")
    if epoch_start != 0 or carry is not None or return_carry:
        raise ValueError(
            "the numpy epoch loop has sequential RNG state and cannot be "
            "checkpointed mid-run: only prefix segments (epoch_start=0, no "
            "carry) are supported; use backend='torch' for resumable trials")
    results = _run_batch_local(
        workload, engine_name, configs, machine, fast_slow_ratio, seeds,
        sampler, False, 128, fast_capacity_pages, backend,
        batch_offset=batch_offset, exact_select=exact_select,
        epoch_stop=epoch_stop, device=device)
    wall = np.stack([np.asarray(r.epoch_wall_ms, dtype=np.float64)
                     for r in results], axis=1)
    return {"wall_ms": wall, "carry": None}


# ---------------------------------------------------------------------------
# Deprecated loose-kwargs shims over the typed Study API, on the numpy
# backend (their results are bitwise the reference shims').
# ---------------------------------------------------------------------------
def run_simulation(workload: Workload, engine_name: str,
                   config: Optional[Mapping[str, Any]] = None,
                   machine: "Machine | str" = PMEM_LARGE,
                   fast_slow_ratio: float = 8.0,
                   seed: int = 0,
                   record_heatmap: bool = False,
                   heat_bins: int = 128,
                   fast_capacity_pages: Optional[int] = None,
                   sampler: str = "elementwise") -> SimResult:
    """Deprecated ``B=1`` numpy run; use ``Study(spec).run()``.
    ``fast_slow_ratio`` r sets fast-tier capacity = RSS/(1+r) (the
    paper's "1:r memory size ratio"; default 1:8, §4.1)."""
    warn_deprecated("repro_torch.core.simulator.run_simulation",
                    "Study(ExperimentSpec(...)).run()")
    machine = _as_machine(machine)
    if config is None:
        config = get_space(engine_name).default_config() \
            if engine_name in ("hemem", "hmsdk", "memtis") else {}
    return _run_batch_local(workload, engine_name, [config], machine,
                            fast_slow_ratio, [seed], sampler, record_heatmap,
                            heat_bins, fast_capacity_pages, "numpy")[0]


def _legacy_study(engine_name: str, workload_name: str, input_name: str,
                  machine: "Machine | str", threads: Optional[int],
                  scale: float, fast_slow_ratio: float, seed: int,
                  sampler: str, workers="auto-off", backend: str = "numpy"):
    """The Study equivalent of the historical loose-kwargs call."""
    from .specs import EngineSpec, ExperimentSpec, SimOptions, WorkloadSpec
    from .study import Study
    machine = _as_machine(machine)
    spec = ExperimentSpec(
        engine=EngineSpec(engine_name),
        workload=WorkloadSpec(workload_name, input_name, threads=threads,
                              scale=scale),
        machine=machine.name, fast_slow_ratio=fast_slow_ratio,
        options=SimOptions(seed=seed, sampler=sampler,
                           workers=1 if workers == "auto-off" else workers,
                           backend=backend))
    # the resolved Machine wins: an ad-hoc instance whose name collides
    # with a registered profile is honoured
    return Study(spec, machine=machine)


def evaluate(engine_name: str, config: Mapping[str, Any], workload_name: str,
             input_name: str = "", machine: "Machine | str" = PMEM_LARGE,
             threads: Optional[int] = None, scale: float = 0.25,
             fast_slow_ratio: float = 8.0, seed: int = 0,
             sampler: str = "elementwise") -> float:
    """Execution time (seconds) of one workload run on the numpy backend
    -- the objective of §3.  Deprecated: use
    ``Study(ExperimentSpec(...)).run().total_s``."""
    warn_deprecated("repro_torch.core.simulator.evaluate",
                    "Study(ExperimentSpec(...)).run().total_s")
    study = _legacy_study(engine_name, workload_name, input_name, machine,
                          threads, scale, fast_slow_ratio, seed, sampler)
    if config is None:
        return study.run().total_s
    return study.run(configs=[config])[0].total_s


def evaluate_batch(engine_name: str, configs: Sequence[Mapping[str, Any]],
                   workload_name: str, input_name: str = "",
                   machine: "Machine | str" = PMEM_LARGE,
                   threads: Optional[int] = None, scale: float = 0.25,
                   fast_slow_ratio: float = 8.0, seed: int = 0,
                   sampler: str = "sparse", workers: int = 1,
                   backend: str = "numpy") -> List[float]:
    """Batched objective: execution times of all B candidate configs.
    Deprecated: use ``Study(ExperimentSpec(...)).run(configs=...)``."""
    warn_deprecated("repro_torch.core.simulator.evaluate_batch",
                    "Study(ExperimentSpec(...)).run(configs=...)")
    study = _legacy_study(engine_name, workload_name, input_name, machine,
                          threads, scale, fast_slow_ratio, seed, sampler,
                          workers=workers, backend=backend)
    return [r.total_s for r in study.run(configs=configs)]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A fully-specified tuning target: workload × input × machine ×
    setting.  Deprecated: :class:`repro_torch.core.specs.ExperimentSpec`
    composes the same information as typed sub-specs and round-trips
    through JSON."""
    workload: str
    input_name: str = ""
    machine: str = "pmem-large"
    threads: Optional[int] = None
    scale: float = 0.25
    fast_slow_ratio: float = 8.0
    seed: int = 0

    def __post_init__(self):
        warn_deprecated("repro_torch.core.simulator.Scenario",
                        "repro_torch.core.specs.ExperimentSpec",
                        stacklevel=4)

    def _study(self, engine_name: str, sampler: str = "elementwise",
               workers: int = 1, backend: str = "numpy"):
        return _legacy_study(engine_name, self.workload, self.input_name,
                             self.machine, self.threads, self.scale,
                             self.fast_slow_ratio, self.seed, sampler,
                             workers=workers, backend=backend)

    def objective(self, engine_name: str):
        study = self._study(engine_name)

        def f(config: Mapping[str, Any]) -> float:
            return study.run(configs=[config])[0].total_s
        return f

    def objective_batch(self, engine_name: str, sampler: str = "sparse",
                        workers: int = 1, backend: str = "numpy"):
        study = self._study(engine_name, sampler=sampler, workers=workers,
                            backend=backend)

        def f(configs: Sequence[Mapping[str, Any]]) -> List[float]:
            return [r.total_s for r in study.run(configs=configs)]
        return f

    @property
    def key(self) -> str:
        inp = f":{self.input_name}" if self.input_name else ""
        return f"{self.workload}{inp}@{self.machine}"
