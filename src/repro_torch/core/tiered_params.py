"""TieredParamStore: MoE expert offload driven by the HeMem engine.

A port of the reference package's ``repro.core.tiered_params``.  A MoE
layer's experts live in host memory (float32) and the hot ones also in a
pool on the card (bf16, ``hbm_experts`` rows).  The access signal is the
router: every batch's expert-selection counts are the "reads".  The numpy
HeMem engine (:mod:`repro_torch.core.engine`, bitwise the reference's)
decides which experts are hot; cooling ages the counts, and the migration
thread swaps experts at a bounded rate.  Tokens routed to host-resident
experts take the slow path (a host to device copy).

The residency trajectory (``slot_of``, ``expert_of_slot``, ``migrations``
and the hit counts) depends only on the engine and the route stream, so it
is bitwise equal to the reference store's for the same seed and stream,
and equal on the card and on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .engine import HeMemEngine
from .knobs import HEMEM_SPACE
from .pages import TierState


def _ids(expert_ids) -> np.ndarray:
    if isinstance(expert_ids, torch.Tensor):
        expert_ids = expert_ids.detach().cpu().numpy()
    return np.asarray(expert_ids).ravel()


class TieredParamStore:
    def __init__(self, expert_weights: Mapping[str, Any], hbm_experts: int,
                 config: Optional[Mapping[str, Any]] = None, seed: int = 0,
                 device="cuda"):
        """expert_weights: dict of (E, ...) arrays or tensors sharing the
        leading dim E.  Host copies are float32 CPU tensors, pinned when
        ``device`` is a card; the pool is bf16 on ``device``."""
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.host: Dict[str, torch.Tensor] = {}
        for k, v in expert_weights.items():
            t = torch.as_tensor(v).detach().to("cpu", torch.float32)
            self.host[k] = t.pin_memory() if pin else t.contiguous()
        first = next(iter(self.host.values()))
        self.n_experts = first.shape[0]
        self.hbm_experts = int(hbm_experts)
        self.bytes_per_expert = sum(v[0].numel() * v.element_size()
                                    for v in self.host.values())

        self.slot_of = np.full(self.n_experts, -1, np.int64)
        self.expert_of_slot = np.full(self.hbm_experts, -1, np.int64)
        self.hbm: Dict[str, torch.Tensor] = {
            k: torch.zeros((self.hbm_experts,) + tuple(v.shape[1:]),
                           dtype=torch.bfloat16, device=self.device)
            for k, v in self.host.items()}

        cfg = HEMEM_SPACE.validate(dict(config or {}))
        self.tier = TierState(self.n_experts, self.hbm_experts,
                              page_bytes=max(self.bytes_per_expert, 1))
        self.tier.allocated[:] = True
        self.engine = HeMemEngine(cfg, self.tier, seed=seed)
        self._counts = np.zeros(self.n_experts)
        self.migrations = 0
        self.slow_hits = 0
        self.fast_hits = 0

        # first touch: experts 0..hbm_experts-1 start in the pool
        for e in range(min(self.hbm_experts, self.n_experts)):
            self._promote(e)

    # -- access accounting -------------------------------------------------
    def route(self, expert_ids):
        """Record a batch's routing decisions (a numpy array or a tensor of
        expert ids); returns the residency of each expert it names."""
        ids, cnt = np.unique(_ids(expert_ids), return_counts=True)
        self._counts[ids] += cnt
        resident = self.slot_of[ids] >= 0
        self.fast_hits += int(cnt[resident].sum())
        self.slow_hits += int(cnt[~resident].sum())
        return {int(e): bool(r) for e, r in zip(ids, resident)}

    def gather(self, name: str, expert_ids) -> torch.Tensor:
        """Weights of ``expert_ids`` stacked on the device, bf16: resident
        rows from the pool, the rest copied from the host and cast (the
        slow path)."""
        ids = _ids(expert_ids).astype(np.int64)
        pool, host = self.hbm[name], self.host[name]
        out = torch.empty((len(ids),) + tuple(pool.shape[1:]),
                          dtype=torch.bfloat16, device=self.device)
        slots = self.slot_of[ids]
        hit = slots >= 0
        if hit.any():
            where = torch.from_numpy(np.flatnonzero(hit)).to(self.device)
            out[where] = pool[torch.from_numpy(slots[hit]).to(self.device)]
        if not hit.all():
            where = torch.from_numpy(np.flatnonzero(~hit)).to(self.device)
            rows = host[torch.from_numpy(ids[~hit])]
            out[where] = rows.to(self.device).to(torch.bfloat16)
        return out

    # -- tiering -----------------------------------------------------------
    def step_engine(self, dt_ms: float):
        reads = self._counts.copy()
        self._counts[:] = 0.0
        self.engine.observe(reads, np.zeros_like(reads), dt_ms)
        plan = self.engine.plan(dt_ms,
                                max_pages_this_epoch=self.hbm_experts)
        for e in plan.demote:
            self._demote(int(e))
        for e in plan.promote:
            if self.tier.fast_free <= 0:
                break
            self._promote(int(e))
        # the plan's size, also when the promote loop stopped early
        self.migrations += plan.n_pages

    def _promote(self, e: int):
        if self.slot_of[e] >= 0:
            return
        free = np.flatnonzero(self.expert_of_slot < 0)
        if len(free) == 0:
            return
        slot = int(free[0])
        for k, pool in self.hbm.items():
            pool[slot].copy_(self.host[k][e], non_blocking=True)
        self.slot_of[e] = slot
        self.expert_of_slot[slot] = e
        self.tier.in_fast[e] = True

    def _demote(self, e: int):
        slot = int(self.slot_of[e])
        if slot < 0:
            return
        self.slot_of[e] = -1
        self.expert_of_slot[slot] = -1
        self.tier.in_fast[e] = False

    def hit_rate(self) -> float:
        tot = self.fast_hits + self.slow_hits
        return self.fast_hits / max(tot, 1)
