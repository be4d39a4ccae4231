"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle every kernel is compared with on the card.

:func:`page_migrate_plain` and :func:`paged_attention_plain` follow the
reference package's ``page_migrate_ref`` and ``paged_attention_ref``, with
two documented differences in ``page_migrate``: it updates ``dst`` in place,
and a ``-1`` lane is a no-op in every case (the reference clamps an invalid
lane to row 0 and writes that row's old contents back after the valid
lanes, so ``dst_ids=[0, -1]`` loses the copy into row 0).

:func:`select_topk_ref` mirrors the reference package's pure-jnp
``select_topk_ref``: a dual 32-step bitwise search for each side's cutoff
key, the strict set taken wholesale, and the boundary tier filled in page
index order by a 17-step search over descending-index weights.  Keys are
order-preserving float32 bits held in int64 (this torch build has no
shifts or comparisons on ``torch.uint32``); every count is an exact integer.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_SIGN = 1 << 31


def order_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving unsigned 32-bit pattern held in int64
    (NaN-free inputs): larger float <=> larger pattern."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & _M32
    return torch.where(bits < _SIGN, bits | _SIGN, ~bits & _M32)


def pack_keys(p_mask, p_heat, d_mask, d_heat):
    """Selection keys: 0 marks a non-candidate; candidates map their heat
    to order bits, complemented on the demote side so colder ranks higher.
    Candidate keys are never 0 (only a NaN maps there)."""
    zero = torch.zeros((), dtype=torch.int64, device=p_heat.device)
    vp = torch.where(p_mask, order_bits(p_heat), zero)
    vd = torch.where(d_mask, ~order_bits(d_heat) & _M32, zero)
    return vp, vd


def select_topk_ref(p_mask, p_heat, d_mask, d_heat, n_promote, n_demote):
    """Exact top-``n_promote`` (by ``p_heat`` desc) / top-``n_demote`` (by
    ``d_heat`` asc) selection masks per row of a ``(B, n)`` batch, ties by
    page index ascending — bit-identical to ``np.argsort(kind="stable")``.

    Masks are bool ``(B, n)``, heats float ``(B, n)``, counts ``(B,)``
    integer-valued floats (floored, as the kernel does)."""
    n = p_mask.shape[-1]
    dev = p_mask.device
    kp = torch.floor(n_promote.to(torch.float32)).to(torch.int64)[:, None]
    kd = torch.floor(n_demote.to(torch.float32)).to(torch.int64)[:, None]
    vp, vd = pack_keys(p_mask, p_heat, d_mask, d_heat)

    def count_ge(v, t):
        return (v >= t).sum(dim=-1, keepdim=True)

    tp = torch.zeros_like(kp)
    td = torch.zeros_like(kd)
    for i in range(31, -1, -1):
        bit = 1 << i
        tp = torch.where(count_ge(vp, tp | bit) >= kp, tp | bit, tp)
        td = torch.where(count_ge(vd, td | bit) >= kd, td | bit, td)
    strict_p = vp > tp
    strict_d = vd > td
    bound_p = (vp == tp) & (vp > 0)
    bound_d = (vd == td) & (vd > 0)
    take_p = kp - strict_p.sum(dim=-1, keepdim=True)
    take_d = kd - strict_d.sum(dim=-1, keepdim=True)
    # boundary tier in index order: descending-index weights are distinct
    # per row, so the take-th largest weight selects exactly `take` pages
    iv = n - torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    wp = torch.where(bound_p, iv, 0)
    wd = torch.where(bound_d, iv, 0)
    sp = torch.zeros_like(tp)
    sd = torch.zeros_like(td)
    for i in range(16, -1, -1):
        bit = 1 << i
        sp = torch.where(count_ge(wp, sp | bit) >= take_p, sp | bit, sp)
        sd = torch.where(count_ge(wd, sd | bit) >= take_d, sd | bit, sd)
    pm = strict_p | (bound_p & (wp >= sp) & (take_p > 0))
    dm = strict_d | (bound_d & (wd >= sd) & (take_d > 0))
    return pm & (kp > 0), dm & (kd > 0)


def page_migrate_plain(dst, src, dst_ids, src_ids):
    """``dst[dst_ids[i]] = src[src_ids[i]]`` row by row, in place; a lane
    with ``dst_ids[i] < 0`` or ``src_ids[i] < 0`` is a no-op, and of lanes
    with the same destination the last one wins.  Rows are ``dst[r]`` and
    ``src[r]`` (dim 0); returns ``dst``."""
    dev = dst.device
    d = torch.as_tensor(dst_ids, device=dev).to(torch.int64).reshape(-1)
    s = torch.as_tensor(src_ids, device=dev).to(torch.int64).reshape(-1)
    lane = torch.arange(d.numel(), dtype=torch.int64, device=dev)
    valid = (d >= 0) & (s >= 0)
    # last lane wins: the largest lane index per destination row, an
    # order-free reduction, so the result does not depend on scatter order
    winner = torch.full((dst.shape[0],), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(valid, d, 0),
                           torch.where(valid, lane, -1), reduce="amax")
    keep = valid & (winner[torch.where(valid, d, 0)] == lane)
    dst[d[keep]] = src[s[keep]]
    return dst


def paged_attention_plain(q, k_pages, v_pages, block_table, lengths, *,
                          logit_softcap: float = 0.0):
    """One-token GQA decode attention over a paged KV pool, in float32.

    q ``(B, H, D)``; k/v_pages ``(P, page, KV, D)``; block_table ``(B,
    pages_per_seq)`` int page ids (``-1`` = not resident); lengths
    ``(B,)``.  Query head ``h`` reads KV head ``h // (H // KV)``.  A
    position attends iff it is below its sequence's length and its page is
    resident; a row with no such position gives zeros.  Returns ``(B, H,
    D)`` in q's dtype."""
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    ppseq = block_table.shape[1]
    scale = 1.0 / math.sqrt(D)
    table = block_table.to(torch.int64)
    idx = torch.clamp(table, min=0)
    kk = k_pages[idx].reshape(B, ppseq * page, KV, D).to(torch.float32)
    vv = v_pages[idx].reshape(B, ppseq * page, KV, D).to(torch.float32)
    qg = q.reshape(B, KV, G, D).to(torch.float32) * scale
    s = torch.einsum("bkgd,btkd->bkgt", qg, kk)
    if logit_softcap > 0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    pos = torch.arange(ppseq * page, device=q.device)
    valid = (pos[None, :] < lengths.to(torch.int64)[:, None]) \
        & (table[:, pos // page] >= 0)
    s = torch.where(valid[:, None, None], s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = torch.where(valid[:, None, None], p, 0.0)
    out = torch.einsum("bkgt,btkd->bkgd", p, vv) \
        / torch.clamp(p.sum(-1)[..., None], min=1e-30)
    return out.reshape(B, H, D).to(q.dtype)
