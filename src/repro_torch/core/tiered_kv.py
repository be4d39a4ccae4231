"""TieredKVCache — the paper's HeMem mechanism managing a paged KV cache
across a fast pool and a slow pool (the counterpart of the reference
package's ``core/tiered_kv.py``).

  fast tier = the HBM page pool, attended by the paged-attention kernel;
  slow tier = the host page pool.

The HeMem mechanism maps 1:1:
  PEBS access sampling  -> per-page attention-mass access counts (reads)
                           and appends (writes), subsampled by
                           sampling_period / write_sampling_period;
  hot/cold thresholds   -> the same read/write_hot_threshold knobs;
  cooling               -> the same batched halving (cooling_threshold,
                           cooling_pages);
  migration thread      -> step_engine(dt) promotes/demotes whole pages,
                           rate-limited by max_migration_rate and the ring
                           sizes; the copies go through the page_migrate
                           kernel.

Decode attends over the HBM-resident pages of each sequence; ``recall()``
reports the fraction of attention mass that was resident.  Every knob keeps
its Table-2 name, so the SMAC tuner drives this store through the same
``HEMEM_SPACE`` as the simulator.

Two modes share one engine decision function (``CompiledServing.
engine_decide``, the ``kv-hemem`` engine), so their residency sets and
migration counts agree bitwise:

* ``compiled=True`` — the fused path of :mod:`~repro_torch.core.
  serving_torch`: one decode step is a fixed sequence of tensor ops with
  one ``paged_attention`` launch, and an engine epoch moves pages with four
  ``page_migrate`` launches;
* ``compiled=False`` — the per-page reference loop: the readable
  specification, with the structural state on the host (numpy) and the
  host pool as float32 CPU tensors, as the reference keeps it.

``device`` selects where the pools and the engine live (``"cuda"`` by
default; the tests pass ``"cpu"``).  Asking for CUDA without a card raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .engine_torch import resolve_device
from .knobs import HEMEM_SPACE
from .serving_torch import get_serving, state_from_host, state_to_host
from .traffic import step_read_counts


@dataclasses.dataclass(frozen=True)
class KVSpec:
    n_layers: int
    kv_heads: int
    head_dim: int
    page_tokens: int = 64
    dtype: Any = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class KVModel:
    """A model's KV-cache widths: its :class:`KVSpec` and query heads."""

    name: str
    spec: KVSpec
    q_heads: int
    source: str


#: KV widths of the models the serving path is run at, copied from the
#: reference package's model configs (named in ``source``)
KV_MODELS = {
    "chatglm3-6b": KVModel(
        "chatglm3-6b",
        KVSpec(n_layers=28, kv_heads=2, head_dim=128, page_tokens=64,
               dtype=torch.bfloat16),
        q_heads=32, source="src/repro/configs/chatglm3_6b.py"),
}


class TieredKVCache:
    """Paged KV cache of a batch of B sequences sharing a two-tier page
    pool.  ``compiled=False`` runs the per-page reference loop;
    ``compiled=True`` the fused path (see module docstring)."""

    def __init__(self, spec: KVSpec, batch: int, max_pages_per_seq: int,
                 hbm_pages: int, config: Optional[Mapping[str, Any]] = None,
                 seed: int = 0, compiled: bool = False, device="cuda"):
        self.spec = spec
        self.batch = batch
        self.max_pages = max_pages_per_seq
        n_logical = batch * max_pages_per_seq
        self.n_logical = n_logical
        self.hbm_pages = hbm_pages
        self.compiled = compiled
        self.device = resolve_device(device)

        s = spec
        page_shape = (s.n_layers, s.page_tokens, s.kv_heads, s.head_dim)
        self.page_elems = int(np.prod(page_shape))
        self.page_shape = page_shape

        self.config = HEMEM_SPACE.validate(dict(config or {}))
        # the serving functions and the shared engine-decision function
        self._srv = get_serving(spec, batch, max_pages_per_seq, hbm_pages,
                                self.device)
        edef = self._srv.edef
        self._kv = edef.upload(edef.knobs([self.config]))
        self._epoch = 0
        self._last_pages: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

        if compiled:
            self._st = self._srv.fresh_state()
            return

        dev = self.device
        self.hbm_k = torch.zeros((hbm_pages,) + page_shape, dtype=s.dtype,
                                 device=dev)
        self.hbm_v = torch.zeros_like(self.hbm_k)
        self.host_k = torch.zeros((n_logical,) + page_shape,
                                  dtype=torch.float32)
        self.host_v = torch.zeros_like(self.host_k)

        # logical page -> hbm slot (-1 = host-resident)
        self._slot_of = np.full(n_logical, -1, np.int64)
        self._page_of_slot = np.full(hbm_pages, -1, np.int64)
        self._lengths = np.zeros(batch, np.int64)
        self._allocated = np.zeros(n_logical, bool)

        self._eng = edef.init(None)
        self._reads = np.zeros(n_logical, np.int64)
        self._writes = np.zeros(n_logical, np.int64)
        self._migrations = 0
        self._recall_num = 0.0
        self._recall_den = 0.0
        self._mass_fn = None

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- state views (identical API across modes) --------------------------
    # compiled-state reads are copies: the fused path updates its state in
    # place, so a view would change under the caller at the next step
    @property
    def lengths(self) -> np.ndarray:
        return self._st["lengths"].cpu().numpy().copy() if self.compiled \
            else self._lengths

    @property
    def slot_of(self) -> np.ndarray:
        return self._st["slot_of"][:self.n_logical].cpu().numpy().copy() \
            if self.compiled else self._slot_of

    @property
    def page_of_slot(self) -> np.ndarray:
        return self._st["page_of_slot"][:self.hbm_pages].cpu().numpy(
        ).copy() if self.compiled else self._page_of_slot

    @property
    def migrations(self) -> int:
        return int(self._st["migrations"]) if self.compiled \
            else self._migrations

    @migrations.setter
    def migrations(self, v: int):
        if self.compiled:
            self._st["migrations"].fill_(int(v))
        else:
            self._migrations = int(v)

    @property
    def last_step_pages(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(resident_pages, total_pages) per sequence for the most recent
        recorded step — the inputs of the serving latency model.  Read
        lazily: the fused decode loop never waits for the device unless
        the caller reads these."""
        if self._last_pages is None:
            return None
        return tuple(np.asarray(a.cpu()).copy() for a in self._last_pages)

    @property
    def last_step_page_tensors(self
                               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """:attr:`last_step_pages` as tensors on the cache's device (no
        host read)."""
        return self._last_pages

    # -- state bridge (compiled mode) --------------------------------------
    def host_state(self):
        """The fused path's state as numpy arrays, in the reference's
        layout (:func:`~repro_torch.core.serving_torch.state_to_host`)."""
        self._require_compiled("host_state")
        return state_to_host(self._st)

    def load_state(self, host_state) -> None:
        """Resume from a host state written by :meth:`host_state` or taken
        from the reference's compiled cache (its state through
        ``np.asarray``)."""
        self._require_compiled("load_state")
        self._st = state_from_host(host_state, self.device, self.spec.dtype)

    def _require_compiled(self, what: str) -> None:
        if not self.compiled:
            raise RuntimeError(f"{what} needs compiled=True: the reference "
                               "loop keeps its state in separate fields")

    # -- logical addressing ------------------------------------------------
    def _page_id(self, seq: int, page_idx: int) -> int:
        return seq * self.max_pages + page_idx

    def block_table(self) -> torch.Tensor:
        """(B, max_pages) of HBM slots; -1 where non-resident/unused."""
        tbl = self.slot_of.reshape(self.batch, self.max_pages)
        return self._tensor(tbl, torch.int32)

    def _active(self, active) -> np.ndarray:
        if active is None:
            return np.ones(self.batch, bool)
        if isinstance(active, torch.Tensor):
            return active.cpu().numpy().astype(bool)
        return np.asarray(active, bool)

    def _active_tensor(self, active) -> torch.Tensor:
        if active is None:
            return torch.ones(self.batch, dtype=torch.bool,
                              device=self.device)
        return self._tensor(active, torch.bool)

    # -- appends (writes) --------------------------------------------------
    def append(self, k_new, v_new, active=None):
        """k/v_new: (B, L, KV, D) — one token per (active) sequence.  New
        tokens land in the HBM tier first (first-touch), falling back to
        host."""
        if self.compiled:
            self._st = self._srv.append(self._st, self._tensor(k_new),
                                        self._tensor(v_new),
                                        self._active_tensor(active))
            return
        act = self._active(active)
        s = self.spec
        k_new = torch.as_tensor(k_new)
        v_new = torch.as_tensor(v_new)
        for b in range(self.batch):
            if not act[b]:
                continue
            t = int(self._lengths[b])
            pi, off = divmod(t, s.page_tokens)
            pid = self._page_id(b, pi)
            self._allocated[pid] = True
            self._writes[pid] += 1
            slot = int(self._slot_of[pid])
            if slot < 0 and off == 0:
                slot = self._grab_slot(pid)     # first touch -> fast tier
            if slot >= 0:
                self.hbm_k[slot, :, off] = k_new[b].to(self.device, s.dtype)
                self.hbm_v[slot, :, off] = v_new[b].to(self.device, s.dtype)
            else:
                self.host_k[pid, :, off] = k_new[b].cpu().float()
                self.host_v[pid, :, off] = v_new[b].cpu().float()
            self._lengths[b] = t + 1

    def _grab_slot(self, pid: int) -> int:
        free = np.flatnonzero(self._page_of_slot < 0)
        if len(free) == 0:
            return -1
        slot = int(free[0])
        self._page_of_slot[slot] = pid
        self._slot_of[pid] = slot
        return slot

    # -- attention (reads) -------------------------------------------------
    def attend(self, q, active=None) -> torch.Tensor:
        """q: (B, H, D) one decode step; attends the layer-0 view of the
        pools (the access statistics apply to the whole page).  Returns
        (B, H, D).  Records the step's attention-mass reads."""
        if self.compiled:
            self._st, out, res, tot = self._srv.attend(
                self._st, self._tensor(q), self._active_tensor(active))
            self._last_pages = (res, tot)
            return out
        act = self._active(active)
        out = ops.paged_attention(
            self._tensor(q, self.spec.dtype), self.hbm_k[:, 0],
            self.hbm_v[:, 0], self.block_table(),
            self._tensor(self._lengths, torch.int32))
        self.record_reads(active=act)
        return out

    def decode_step(self, k_new, v_new, q, active=None,
                    dt_ms: Optional[float] = None) -> torch.Tensor:
        """The fused serving step: append + attend + record (+ one engine
        epoch when ``dt_ms`` is given)."""
        if self.compiled:
            self._st, out, res, tot = self._srv.decode(
                self._st, self._tensor(k_new), self._tensor(v_new),
                self._tensor(q), self._active_tensor(active))
            self._last_pages = (res, tot)
        else:
            act = self._active(active)
            self.append(k_new, v_new, active=act)
            out = self.attend(q, active=act)
        if dt_ms is not None:
            self.step_engine(dt_ms)
        return out

    #: attention-mass -> access-count scale: one decode step reads each
    #: page's tokens across kv heads and layers
    @property
    def READ_SCALE(self) -> float:
        s = self.spec
        return float(s.page_tokens * s.kv_heads * s.n_layers * 64)

    def record_reads(self, active=None):
        """Attention-mass access accounting (the PEBS analogue), in integer
        counts (:func:`~repro_torch.core.traffic.step_read_counts`) so the
        reference loop and the fused step feed the engine the same bits.
        In compiled mode recording is fused into ``attend``/``decode_step``."""
        if self.compiled:
            raise RuntimeError(
                "compiled TieredKVCache fuses read recording into "
                "attend()/decode_step(); there is no separate record pass")
        act = self._active(active)
        scale = int(self.READ_SCALE)
        if self._mass_fn is not None:
            mass = np.asarray(self._mass_fn(), np.float64)
            counts_flat = np.rint(mass * scale).astype(np.int64)
            act_page = counts_flat.reshape(self.batch, self.max_pages) > 0
        else:
            counts, act_page = step_read_counts(
                self._lengths, self.max_pages, self.spec.page_tokens,
                scale, xp=np)
            counts = np.where(act[:, None], counts, 0)
            act_page = act_page & act[:, None]
            counts_flat = counts.reshape(self.n_logical).astype(np.int64)
            mass = counts_flat / scale
        resident = self._slot_of >= 0
        self._reads += counts_flat
        self._recall_num += float(mass[resident].sum())
        self._recall_den += float(mass.sum())
        res2 = resident.reshape(self.batch, self.max_pages)
        self._last_pages = (torch.from_numpy((res2 & act_page).sum(1)),
                            torch.from_numpy(act_page.sum(1)))

    def true_attention_mass(self) -> np.ndarray:
        """Per-logical-page attention mass for the current step (recency +
        sink-heavy profile, quantized to the engine's integer counts)."""
        counts, _ = step_read_counts(self.lengths, self.max_pages,
                                     self.spec.page_tokens,
                                     int(self.READ_SCALE), xp=np)
        return counts.reshape(self.n_logical) / self.READ_SCALE

    def set_mass_fn(self, fn):
        if self.compiled:
            raise RuntimeError("set_mass_fn is reference-mode only; the "
                               "compiled step bakes the serving profile in")
        self._mass_fn = fn

    # -- tiering (the kv-hemem engine) -------------------------------------
    def step_engine(self, dt_ms: float):
        """One engine epoch: observe accumulated access counts, plan, and
        apply the promote/demote masks.  The decision runs through the one
        function both modes share (``CompiledServing.engine_decide``); only
        the apply differs — batched ``page_migrate`` in compiled mode, the
        per-page loop here."""
        if self.compiled:
            self._st, _ = self._srv.engine_step(self._st, self._kv, dt_ms)
            return
        f32 = torch.float32
        self._eng, pmask, dmask = self._srv.engine_decide(
            self._eng, self._kv, self._tensor(self._reads, f32),
            self._tensor(self._writes, f32),
            self._tensor(self._slot_of >= 0), self._tensor(self._allocated),
            dt_ms, self._epoch)
        self._reads[:] = 0
        self._writes[:] = 0
        self._epoch += 1
        pmask, dmask = pmask.cpu().numpy(), dmask.cpu().numpy()
        moved = 0
        for pid in np.flatnonzero(dmask):
            if self._slot_of[pid] < 0:
                continue
            self._demote(int(pid))
            moved += 1
        # promote page ids ascending into free slots ascending — the same
        # pairing the batched compiled apply uses
        free = np.flatnonzero(self._page_of_slot < 0)
        j = 0
        for pid in np.flatnonzero(pmask):
            if self._slot_of[pid] >= 0 or not self._allocated[pid]:
                continue
            if j >= len(free):
                break
            self._promote(int(pid), int(free[j]))
            j += 1
            moved += 1
        self._migrations += moved

    def _demote(self, pid: int):
        slot = int(self._slot_of[pid])
        if slot < 0:
            return
        self.host_k[pid] = self.hbm_k[slot].cpu().float()
        self.host_v[pid] = self.hbm_v[slot].cpu().float()
        self._slot_of[pid] = -1
        self._page_of_slot[slot] = -1

    def _promote(self, pid: int, slot: int):
        # the device-side copy goes through the page-migration kernel; the
        # host row is cast to the pool's dtype first
        for pool, host in ((self.hbm_k, self.host_k),
                           (self.hbm_v, self.host_v)):
            row = host[pid].reshape(1, -1).to(self.device, self.spec.dtype)
            ops.page_migrate(pool.view(self.hbm_pages, -1), row, [slot], [0])
        self._slot_of[pid] = slot
        self._page_of_slot[slot] = pid

    # -- sequence lifecycle (traffic replay) -------------------------------
    def reset_seqs(self, done):
        """Retire finished sequences (boolean ``(B,)`` mask): zero their
        lengths, access counters and engine heat, free their HBM slots.
        Pool rows keep stale data; the next occupant overwrites them."""
        if self.compiled:
            self._st = self._srv.reset_seqs(self._st,
                                            self._tensor(done, torch.bool))
            return
        done = self._active(done)
        kill = np.repeat(done, self.max_pages)
        for pid in np.flatnonzero(kill & (self._slot_of >= 0)):
            self._page_of_slot[self._slot_of[pid]] = -1
        self._slot_of[kill] = -1
        self._allocated[kill] = False
        self._reads[kill] = 0
        self._writes[kill] = 0
        self._lengths[done] = 0
        km = self._tensor(kill)[None, :]
        self._eng = dict(self._eng,
                         rc=torch.where(km, 0.0, self._eng["rc"]),
                         wc=torch.where(km, 0.0, self._eng["wc"]))

    # -- metrics -----------------------------------------------------------
    def recall(self) -> float:
        """Fraction of true attention mass served from the fast tier."""
        if self.compiled:
            return float(self._st["recall_num"]) / \
                max(float(self._st["recall_den"]), 1e-12)
        return self._recall_num / max(self._recall_den, 1e-12)

    def hbm_utilization(self) -> float:
        return float((self.page_of_slot >= 0).mean())
