"""Replayed request traffic through a ``TieredKVCache``: the serving
measurement and the tuning objective (the counterpart of the reference
package's ``benchmarks/serving_tiered_kv.py`` ``replay`` and
``serving_objective``).

:func:`replay` runs one arrival trace (:class:`~repro_torch.core.traffic.
TrafficSpec`) through a cache: every step decodes one token for each active
sequence (the fused step on the cache's device), every ``engine_every``
steps runs one engine epoch, and finished sequences are retired.  It
returns modeled per-token decode latency (p50/p99), attention-mass recall,
migrations and measured throughput.  :func:`serving_objective` turns that
into the lower-is-better score ``Study.tune(objective=...)`` minimizes::

    from repro_torch.core import ExperimentSpec, Study
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.serving_replay import replay, serving_objective

    traffic = TrafficSpec(pattern="bursty-diurnal", arrival_rate=64 / 24,
                          steps=256, decode_lo=256, decode_hi=1024)
    study = Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson"))
    result = study.tune(budget=8, objective=lambda cfg: serving_objective(
        replay(cfg, traffic, batch=64, max_pages=32, hbm_frac=1 / 8)))
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .core.tiered_kv import KVSpec, TieredKVCache
from .core.traffic import TrafficSpec, replay_schedule

#: the reference benchmark's small float32 spec (its ``SPEC``), the default
DEFAULT_SPEC = KVSpec(n_layers=2, kv_heads=2, head_dim=16, page_tokens=4,
                      dtype=torch.float32)

#: Modeled serving machine of the reference benchmark, kept as its model
#: inputs so the objective equals the reference's: fast-tier and host-link
#: bandwidth (GB/s) and a per-step compute floor (ms), with latency charged
#: at a 2 MiB page granule.  These are the benchmark's modeled-machine
#: parameters, not a measurement of any chip.
NEAR_GBS, FAR_GBS, COMPUTE_MS = 800.0, 32.0, 0.2
MODEL_PAGE_BYTES = 2 << 20


def _page_ms(pages, gbs: float, page_bytes: int = MODEL_PAGE_BYTES):
    return pages * page_bytes * 1e3 / (gbs * 1e9)


def replay(config, traffic: TrafficSpec, *, batch: int, max_pages: int,
           hbm_frac: float = 0.25, seed: int = 0, compiled: bool = True,
           engine_every: int = 8, dt_ms: float = 50.0,
           spec: KVSpec = DEFAULT_SPEC, q_heads: Optional[int] = None,
           device="cuda", record: bool = False) -> Dict:
    """Replay one arrival trace through a ``TieredKVCache`` on ``device``;
    returns latency/recall/throughput stats.  Deterministic in
    ``(config, traffic, seed, spec, q_heads)``.

    ``q_heads`` is the number of query heads (default ``spec.kv_heads``,
    as the reference benchmark uses).  The cache has ``max(2, int(batch *
    max_pages * hbm_frac))`` HBM pages.  The decode loop reads nothing
    back per step; each engine epoch reads its migration count, and the
    per-step page counts of the latency model come back once, after the
    loop.

    ``record=True`` adds ``outputs`` (every decoded step's attention
    output, stacked on the device) and ``epoch_slots`` (the slot of every
    logical page after each engine epoch, ``(epochs, pages)`` int), for
    comparing two replays; reading the slots costs one more host sync per
    epoch."""
    hbm_pages = max(2, int(batch * max_pages * hbm_frac))
    q_heads = spec.kv_heads if q_heads is None else q_heads
    sched = replay_schedule(traffic, batch, max_pages * spec.page_tokens,
                            seed)
    cache = TieredKVCache(spec, batch, max_pages, hbm_pages, config=config,
                          compiled=compiled, device=device)
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(batch, spec.n_layers, spec.kv_heads,
                         spec.head_dim)).astype(np.float32)
    q = rng.normal(size=(batch, q_heads, spec.head_dim)).astype(np.float32)
    dev = cache.device
    k_t = torch.from_numpy(k).to(dev)
    q_t = torch.from_numpy(q).to(dev)
    active_t = torch.from_numpy(sched["active"]).to(dev)
    done_t = torch.from_numpy(sched["done"]).to(dev)
    pages = []                # per decoded step: (res, tot, moved, active)
    outputs, epoch_slots = [], []
    tokens = 0
    steps = 0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for t in range(traffic.steps):
        active = sched["active"][t]
        if not active.any():
            continue
        out = cache.decode_step(k_t, k_t, q_t, active=active_t[t])
        moved = 0
        if t % engine_every == engine_every - 1:
            m0 = cache.migrations
            cache.step_engine(dt_ms)
            moved = cache.migrations - m0
            if record:
                epoch_slots.append(cache.slot_of.copy())
        res, tot = cache.last_step_page_tensors
        pages.append((res, tot, moved, active))
        tokens += int(active.sum())
        steps += 1
        if record:
            outputs.append(out)
        cache.reset_seqs(done_t[t])
    sync()
    wall = time.perf_counter() - t0
    lats = []
    if pages:
        res_all = torch.stack([p[0] for p in pages]).cpu().numpy()
        tot_all = torch.stack([p[1] for p in pages]).cpu().numpy()
        for (_, _, moved, active), res, tot in zip(pages, res_all, tot_all):
            res = np.asarray(res, np.float64)
            tot = np.asarray(tot, np.float64)
            # modeled per-sequence decode latency: compute floor + resident
            # pages over HBM + non-resident over the host link + migrations
            lat = (COMPUTE_MS + _page_ms(res, NEAR_GBS)
                   + _page_ms(tot - res, FAR_GBS)
                   + _page_ms(float(moved), FAR_GBS))
            lats.append(lat[active])
    lat = np.concatenate(lats) if lats else np.zeros(1)
    stats = {
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "recall": cache.recall(),
        "migrations": cache.migrations,
        "completed": int(sched["completed"]),
        "tokens": tokens,
        "steps": steps,
        "tokens_per_s": tokens / max(wall, 1e-9),
        "decode_ms_per_step": wall * 1e3 / max(steps, 1),
        "wall_s": wall,
    }
    if record:
        stats["outputs"] = torch.stack(outputs) if outputs else None
        stats["epoch_slots"] = np.stack(epoch_slots) if epoch_slots \
            else np.zeros((0, cache.n_logical), np.int64)
    return stats


def serving_objective(stats: Dict) -> float:
    """Lower-is-better serving score: tail latency penalized by recall."""
    return stats["p99_ms"] / max(stats["recall"], 1e-3)
