"""Fused tiered-KV serving: the decode step and the engine epoch on one
device (the counterpart of the reference package's ``core/serving_jax.py``).

This module is the backend behind ``TieredKVCache(compiled=True)``.  One
decode step — token append, paged attention over the HBM-resident pages,
and attention-mass read recording — is a fixed sequence of tensor ops over
``(B, pages)`` state; an engine epoch runs the shared decision function and
then moves pages with four :func:`~repro_torch.kernels.ops.page_migrate`
calls (K and V, demote then promote) instead of per-page Python loops.

Conformance with the per-page reference loop of
:mod:`~repro_torch.core.tiered_kv` is by construction:

* both modes call the ONE decision function :meth:`CompiledServing.
  engine_decide` (the ``kv-hemem`` engine's observe + plan) on the same
  device, so the float arithmetic is the same op by op;
* access accounting is integer (:func:`~repro_torch.core.traffic.
  step_read_counts`), so both modes feed the engine the same bits.

State is a dict of tensors on one device, in the reference's layout:
structural state (``slot_of``, ``page_of_slot``, ``lengths``) is int32;
both page pools carry one extra **dump row** (index ``H`` for HBM, ``n``
for host) that absorbs the appends of inactive or non-resident lanes, so
every append index is valid.  Unlike the reference, the functions update
the state in place (the reference donates its state to each jitted call):
the pools are written where they lie, never copied.  Page moves pass ``-1``
for empty lanes, so an epoch copies only the pages that move; rows other
than the dump rows are identical either way.  The decode step reads
nothing back to the host; :meth:`CompiledServing.engine_step` returns the
epoch's migration count as an int, one host sync per epoch.

:func:`state_to_host` / :func:`state_from_host` carry a state across in
exactly the layout of the reference's state converted to numpy (16-bit
float pools as ``uint16`` bit patterns, since numpy has no bfloat16), so a
run of either package resumes in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..kernels import ops
from .engine_torch import KVHeMemDef, _f32, resolve_device
from .traffic import step_read_counts


def read_scale(spec) -> int:
    """Attention-mass -> access-count scale (PEBS-knob units): one unit of
    mass is worth page_tokens x kv_heads x n_layers x 64 accesses."""
    return int(spec.page_tokens * spec.kv_heads * spec.n_layers * 64)


class CompiledServing:
    """The serving functions for one cache geometry on one device.

    Methods take a state dict (:meth:`fresh_state`) and update it in
    place.  Instances are cached per ``(spec, batch, max_pages, hbm_pages,
    device)`` by :func:`get_serving`, so every ``TieredKVCache`` of that
    geometry — the per-page reference loop included, which borrows
    :meth:`engine_decide` — shares one decision function.
    """

    def __init__(self, spec, batch: int, max_pages: int, hbm_pages: int,
                 device):
        self.spec = spec
        self.device = torch.device(device)
        self.B, self.mp, self.H = batch, max_pages, hbm_pages
        self.n = batch * max_pages
        self.pt = spec.page_tokens
        self.scale = read_scale(spec)
        self.page_shape = (spec.n_layers, spec.page_tokens, spec.kv_heads,
                           spec.head_dim)
        self.page_elems = int(np.prod(self.page_shape))
        self.edef = KVHeMemDef(1, self.n, hbm_pages, self.device)
        self.edef.page_bytes = _f32(self.page_elems * 2)
        self._max_pages = torch.full((1,), float(hbm_pages),
                                     dtype=torch.float32, device=self.device)

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int32, device=self.device)

    # -- state -------------------------------------------------------------
    def fresh_state(self) -> Dict[str, Any]:
        B, n, H, dt, dev = self.B, self.n, self.H, self.spec.dtype, \
            self.device
        ps = self.page_shape
        i32 = torch.int32

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "lengths": zeros(B, i32),
            "slot_of": torch.full((n + 1,), -1, dtype=i32, device=dev),
            "page_of_slot": torch.full((H + 1,), -1, dtype=i32, device=dev),
            "allocated": zeros(n, torch.bool),
            "reads": zeros(n, i32),
            "writes": zeros(n, i32),
            "hbm_k": zeros((H + 1,) + ps, dt),
            "hbm_v": zeros((H + 1,) + ps, dt),
            "host_k": zeros((n + 1,) + ps, dt),
            "host_v": zeros((n + 1,) + ps, dt),
            "eng": self.edef.init(None),
            "migrations": zeros((), i32),
            "epoch": zeros((), i32),
            "recall_num": zeros((), torch.float32),
            "recall_den": zeros((), torch.float32),
        }

    # -- decode-step pieces ------------------------------------------------
    def append(self, st, k_new, v_new, active):
        """Append one token per active sequence: first touch of a page
        grabs the lowest free HBM slot (the j-th needy sequence, ascending
        b, gets the j-th lowest free slot — the reference loop's repeated
        lowest-free-slot rule); tokens of pages without a slot go to the
        host pool.  ``k_new``/``v_new`` are ``(B, n_layers, kv_heads,
        head_dim)``, ``active`` bool ``(B,)``."""
        B, mp, n, H, pt = self.B, self.mp, self.n, self.H, self.pt
        t = st["lengths"]
        pi, off = t // pt, t % pt
        pid = (self._arange(B) * mp + pi).long()            # (B,) unique
        act_i = active.to(torch.int32)
        st["allocated"][pid] = st["allocated"][pid] | active
        st["writes"][pid] += act_i
        slot = st["slot_of"][pid]
        need = active & (slot < 0) & (off == 0)
        free = st["page_of_slot"][:H] < 0
        n_free = free.sum()
        free_slots = torch.sort(torch.where(free, self._arange(H), H),
                                stable=True).values
        rank = torch.cumsum(need.to(torch.int32), 0, dtype=torch.int32)
        got = need & (rank <= n_free)
        new_slot = free_slots[torch.clamp(rank - 1, 0, H - 1).long()]
        slot = torch.where(got, new_slot, slot)
        st["slot_of"][torch.where(got, pid, n)] = torch.where(got, new_slot,
                                                               -1)
        st["page_of_slot"][torch.where(got, new_slot, H).long()] = \
            torch.where(got, pid.to(torch.int32), -1)
        # token writes: resident rows to their slot, everything else to the
        # dump row of the respective pool.  (rows, :, off) puts the (B,)
        # index dimension first, as numpy does: the target is (B, L, KV, D)
        kt = k_new.to(self.spec.dtype)
        vt = v_new.to(self.spec.dtype)
        rows_hbm = torch.where(active & (slot >= 0), slot, H).long()
        rows_host = torch.where(active & (slot < 0), pid, n)
        off = off.long()
        st["hbm_k"][rows_hbm, :, off] = kt
        st["hbm_v"][rows_hbm, :, off] = vt
        st["host_k"][rows_host, :, off] = kt
        st["host_v"][rows_host, :, off] = vt
        st["lengths"] += act_i
        return st

    def attend(self, st, q, active):
        """Paged attention of ``q`` ``(B, H_q, head_dim)`` over the
        HBM-resident pages (layer-0 view of the pools, one kernel launch)
        plus the step's integer read recording.  Returns ``(state, out,
        resident_pages, total_pages)``."""
        B, mp, n = self.B, self.mp, self.n
        tbl = st["slot_of"][:n].reshape(B, mp)
        out = ops.paged_attention(q.to(self.spec.dtype), st["hbm_k"][:, 0],
                                  st["hbm_v"][:, 0], tbl, st["lengths"])
        counts, act_page = step_read_counts(st["lengths"], mp, self.pt,
                                            self.scale, xp=torch)
        counts = torch.where(active[:, None], counts, 0)
        act_page = act_page & active[:, None]
        flat = counts.reshape(n)
        resident = st["slot_of"][:n] >= 0
        mass = flat.to(torch.float32) / _f32(self.scale)
        st["reads"] += flat
        st["recall_num"] += torch.where(resident, mass, 0.0).sum()
        st["recall_den"] += mass.sum()
        res_pages = (resident.reshape(B, mp) & act_page).sum(1)
        tot_pages = act_page.sum(1)
        return st, out, res_pages, tot_pages

    def decode(self, st, k_new, v_new, q, active):
        """The fused serving step: append + paged attention + read/recall
        recording.  Returns ``(state, out, res_pages, tot_pages)``."""
        return self.attend(self.append(st, k_new, v_new, active), q, active)

    # -- engine epoch ------------------------------------------------------
    def engine_decide(self, eng, kv, reads_f, writes_f, in_fast, allocated,
                      dt_ms, e):
        """The ONE decision function both cache modes call: the kv-hemem
        engine's observe and plan for one epoch.  Returns ``(engine state,
        promote mask (n,), demote mask (n,))``."""
        keys = torch.zeros(1, dtype=torch.int64, device=self.device)
        est = torch.full((1,), _f32(dt_ms), dtype=torch.float32,
                         device=self.device)
        eng, _ = self.edef.observe(eng, kv, keys, e, reads_f, writes_f, est)
        eng, pm, dm, _ = self.edef.plan(
            eng, kv, keys, e, reads_f, writes_f, in_fast[None, :],
            allocated[None, :], est, self._max_pages)
        return eng, pm[0], dm[0]

    def _migrate(self, dst, src, dst_rows, src_rows):
        ops.page_migrate(dst.view(dst.shape[0], -1),
                         src.view(src.shape[0], -1), dst_rows, src_rows)

    def apply(self, st, pmask, dmask):
        """Apply one epoch's migration masks: batched demote (HBM -> host),
        then batched promote into the freed slots — promote page ids
        ascending paired with free slots ascending, the reference loop's
        lowest-free-slot rule.  Returns ``(state, moved)``, ``moved`` a
        0-d int tensor."""
        n, H = self.n, self.H
        arn = self._arange(n)
        slots = st["slot_of"][:n].clone()
        dm = dmask & (slots >= 0)
        d_ids = torch.sort(torch.where(dm, arn, n), stable=True).values[:H]
        d_valid = d_ids < n
        d_rows = torch.where(d_valid, d_ids, -1)
        d_slots = torch.where(
            d_valid, slots[torch.clamp(d_ids, max=n - 1).long()], -1)
        self._migrate(st["host_k"], st["hbm_k"], d_rows, d_slots)
        self._migrate(st["host_v"], st["hbm_v"], d_rows, d_slots)
        slots = torch.where(dm, -1, slots)
        posn = st["page_of_slot"][:H]
        owner = torch.clamp(posn, min=0).long()
        posn = torch.where((posn >= 0) & dm[owner], -1, posn)

        pm = pmask & (slots < 0) & st["allocated"]
        p_ids = torch.sort(torch.where(pm, arn, n), stable=True).values[:H]
        f_slots = torch.sort(torch.where(posn < 0, self._arange(H), H),
                             stable=True).values
        valid = (p_ids < n) & (f_slots < H)
        self._migrate(st["hbm_k"], st["host_k"],
                      torch.where(valid, f_slots, -1),
                      torch.where(valid, p_ids, -1))
        self._migrate(st["hbm_v"], st["host_v"],
                      torch.where(valid, f_slots, -1),
                      torch.where(valid, p_ids, -1))
        # bookkeeping scatters: invalid lanes write -1 into the dump entry
        slots_full = torch.cat([slots, st["slot_of"][n:]])
        slots_full[torch.where(valid, p_ids, n).long()] = \
            torch.where(valid, f_slots, -1)
        pos_full = torch.cat([posn, st["page_of_slot"][H:]])
        pos_full[torch.where(valid, f_slots, H).long()] = \
            torch.where(valid, p_ids, -1)
        st["slot_of"].copy_(slots_full)
        st["page_of_slot"].copy_(pos_full)
        moved = dm.sum(dtype=torch.int32) + valid.sum(dtype=torch.int32)
        st["reads"].zero_()
        st["writes"].zero_()
        st["migrations"] += moved
        st["epoch"] += 1
        return st, moved

    def engine_step(self, st, kv, dt_ms) -> Tuple[Dict[str, Any], int]:
        """One engine epoch on the state: shared decide + batched apply.
        Returns ``(state, moved)`` (one host sync, for ``moved``)."""
        in_fast = st["slot_of"][:self.n] >= 0
        eng, pmask, dmask = self.engine_decide(
            st["eng"], kv, st["reads"].to(torch.float32),
            st["writes"].to(torch.float32), in_fast, st["allocated"],
            dt_ms, st["epoch"])
        st["eng"] = eng
        st, moved = self.apply(st, pmask, dmask)
        return st, int(moved)

    # -- sequence completion ----------------------------------------------
    def reset_seqs(self, st, done):
        """Retire finished sequences (bool ``(B,)``): zero their lengths and
        access counters, free their HBM slots and engine heat.  Pool rows
        keep stale data; the next occupant's appends overwrite them."""
        n, H, mp = self.n, self.H, self.mp
        kill = done.repeat_interleave(mp)
        slots = st["slot_of"][:n]
        fs = kill & (slots >= 0)
        st["page_of_slot"][torch.where(fs, slots, H).long()] = -1
        eng = st["eng"]
        st["eng"] = dict(eng,
                         rc=torch.where(kill[None, :], 0.0, eng["rc"]),
                         wc=torch.where(kill[None, :], 0.0, eng["wc"]))
        st["lengths"].masked_fill_(done, 0)
        slots.masked_fill_(kill, -1)
        st["allocated"].masked_fill_(kill, False)
        st["reads"].masked_fill_(kill, 0)
        st["writes"].masked_fill_(kill, 0)
        return st


_CACHE: Dict[Tuple, CompiledServing] = {}


def get_serving(spec, batch: int, max_pages: int, hbm_pages: int,
                device="cuda") -> CompiledServing:
    """The cached :class:`CompiledServing` of one geometry on one
    device."""
    device = resolve_device(device)
    key = (spec, batch, max_pages, hbm_pages, str(device))
    srv = _CACHE.get(key)
    if srv is None:
        srv = _CACHE[key] = CompiledServing(spec, batch, max_pages,
                                            hbm_pages, device)
    return srv


# ---------------------------------------------------------------------------
# state bridge
# ---------------------------------------------------------------------------
_POOLS = ("hbm_k", "hbm_v", "host_k", "host_v")
_BITS = (torch.bfloat16, torch.float16)


def state_to_host(st) -> Dict[str, Any]:
    """A serving state as numpy arrays, in the layout of the reference's
    ``CompiledServing`` state converted to numpy: the same keys, shapes
    and integer/float dtypes, the engine state as a dict of arrays.  Pools
    of a 16-bit float dtype come as ``uint16`` bit patterns (numpy has no
    bfloat16); float32 pools as float32."""
    def host(t):  # a copy: on the CPU, .numpy() would share the live state
        return t.detach().cpu().clone().numpy()

    out: Dict[str, Any] = {}
    for key, val in st.items():
        if key == "eng":
            out[key] = {k: host(v) for k, v in val.items()}
        elif key in _POOLS and val.dtype in _BITS:
            out[key] = host(val.view(torch.int16)).view(np.uint16)
        else:
            out[key] = host(val)
    return out


def state_from_host(host_state, device, dtype=torch.bfloat16
                    ) -> Dict[str, Any]:
    """Tensors on ``device`` from a host state written by
    :func:`state_to_host` or by the reference (its ``CompiledServing``
    state through ``np.asarray``).  Pools of a 2-byte numpy dtype (the
    ``uint16`` bit patterns, or the reference's bfloat16 arrays) are
    reinterpreted bit for bit as ``dtype``; float32 pools stay float32."""
    device = resolve_device(device)

    def t(a):  # a copy: host arrays may be read-only views
        return torch.from_numpy(np.array(a)).to(device)

    out: Dict[str, Any] = {}
    for key, val in host_state.items():
        if key == "eng":
            out[key] = {k: t(v) for k, v in val.items()}
        elif key in _POOLS and np.asarray(val).dtype.itemsize == 2:
            bits = np.ascontiguousarray(np.asarray(val)).view(np.int16)
            out[key] = torch.from_numpy(bits.copy()).view(dtype).to(device)
        else:
            out[key] = t(val)
    return out
