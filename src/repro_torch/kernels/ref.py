"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle every kernel is compared with on the card.

:func:`page_migrate_plain` and :func:`paged_attention_plain` follow the
reference package's ``page_migrate_ref`` and ``paged_attention_ref``, with
two documented differences in ``page_migrate``: it updates ``dst`` in place,
and a ``-1`` lane is a no-op in every case (the reference clamps an invalid
lane to row 0 and writes that row's old contents back after the valid
lanes, so ``dst_ids=[0, -1]`` loses the copy into row 0).

:func:`flash_attention_plain` follows the reference's
``flash_attention_ref``: the same online-softmax recurrence over 512-key
blocks, in float32.

:func:`select_topk_ref` mirrors the reference package's pure-jnp
``select_topk_ref``: a dual 32-step bitwise search for each side's cutoff
key, the strict set taken wholesale, and the boundary tier filled in page
index order by a 17-step search over descending-index weights.  Keys are
order-preserving float32 bits held in int64 (this torch build has no
shifts or comparisons on ``torch.uint32``); every count is an exact integer.

:func:`paged_attention_split_plain` and :func:`select_topk_sliced_plain`
are plain models of the split and cluster kernels' algorithms (softmax
partials over even shares of each sequence's resident pages, combined in
share order; per-slice radix histograms summed, boundary pages numbered by
slice offsets).  Only the tests use
them, to check that arithmetic on the CPU; nothing on a main path does.
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
    for i in range(max(n, 1).bit_length() - 1, -1, -1):  # weights <= n
        bit = 1 << i
        sp = torch.where(count_ge(wp, sp | bit) >= take_p, sp | bit, sp)
        sd = torch.where(count_ge(wd, sd | bit) >= take_d, sd | bit, sd)
    pm = strict_p | (bound_p & (wp >= sp) & (take_p > 0))
    dm = strict_d | (bound_d & (wd >= sd) & (take_d > 0))
    return pm & (kp > 0), dm & (kd > 0)


def select_topk_sliced_plain(p_mask, p_heat, d_mask, d_heat, n_promote,
                             n_demote, slices: int):
    """The cluster kernel's algorithm on ``slices`` contiguous slices of
    each row (``ceil(n / slices)`` pages each, the last ones shorter or
    empty): 4 radix passes of 8-bit digits whose histograms are built per
    slice and summed, a walk of the summed bins from the top, then the
    boundary tier numbered by each slice's offset (the boundary pages of
    the slices before it) plus its own running count.  Same masks as
    :func:`select_topk_ref`."""
    if slices < 1:
        raise ValueError(f"slices must be >= 1, got {slices}")
    B, n = p_mask.shape
    dev = p_mask.device
    width = max(1, -(-n // slices))
    which = torch.arange(n, device=dev) // width  # slice of each page
    vp, vd = pack_keys(p_mask, p_heat, d_mask, d_heat)

    def k_of(count):
        f = torch.floor(count.to(torch.float32))
        return torch.clamp(f, min=0, max=n).to(torch.int64)

    def cutoff(v, k):
        prefix = torch.zeros(B, dtype=torch.int64, device=dev)
        rank = k.clone()
        for shift in (24, 16, 8, 0):
            live = rank > 0
            if not bool(live.any()):
                break
            hi = 0 if shift == 24 else (_M32 << (shift + 8)) & _M32
            match = (v != 0) & ((v & hi) == prefix[:, None]) & live[:, None]
            bins = torch.where(match, (v >> shift) & 255, 256)
            hist = torch.zeros((B, slices, 257), dtype=torch.int64,
                               device=dev)
            hist.index_put_((torch.arange(B, device=dev)[:, None],
                             which.expand(B, n), bins),
                            torch.ones_like(bins), accumulate=True)
            total = hist[:, :, :256].sum(1)           # the cluster's sums
            desc = total.flip(-1)                     # bin 255 first
            incl = desc.cumsum(-1)
            above = incl - desc
            found = (above < rank[:, None]) & (rank[:, None] <= incl)
            j = found.to(torch.int64).argmax(-1)
            has = found.any(-1)
            digit = 255 - j
            over = above.gather(1, j[:, None])[:, 0]
            # fewer candidates than k: cutoff 0, take every candidate
            found_p = torch.where(has, prefix | digit << shift, 0)
            prefix = torch.where(live, found_p, prefix)
            rank = torch.where(live, torch.where(has, rank - over, 0), rank)
        return prefix, rank

    def side(v, k):
        t, take = cutoff(v, k)
        on = (k > 0)[:, None]
        strict = on & (v > t[:, None])
        bound = on & (v == t[:, None]) & (v > 0)
        # each slice scans its own pages (padded to `width`), then adds
        # the boundary pages of the slices of lower rank
        flags = torch.zeros((B, slices * width), dtype=torch.int64,
                            device=dev)
        flags[:, :n] = bound.to(torch.int64)
        flags = flags.reshape(B, slices, width)
        local = flags.cumsum(-1) - flags
        per = flags.sum(-1)
        offset = per.cumsum(1) - per
        before = (offset[:, :, None] + local).reshape(B, -1)[:, :n]
        return strict | (bound & (before < take[:, None]))

    return side(vp, k_of(n_promote)), side(vd, k_of(n_demote))


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


def paged_attention_split_plain(q, k_pages, v_pages, block_table, lengths,
                                *, logit_softcap: float = 0.0,
                                splits: int = 1):
    """The split kernel's algorithm in float32: each sequence's resident
    pages (in table order) cut into ``splits`` even shares, share ``s``
    holding ranks ``[s * n // splits, (s + 1) * n // splits)`` of its ``n``
    pages; each share's softmax partial ``(m, l, acc)`` (m = -inf and l = 0
    for an empty share), then the partials combined in share order.  Same
    function as :func:`paged_attention_plain`."""
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    ppseq = block_table.shape[1]
    f32 = torch.float32
    dev = q.device
    table = block_table.to(torch.int64)
    idx = torch.clamp(table, min=0)
    kk = k_pages[idx].reshape(B, ppseq * page, KV, D).to(f32)
    vv = v_pages[idx].reshape(B, ppseq * page, KV, D).to(f32)
    qg = q.reshape(B, KV, G, D).to(f32) * (1.0 / math.sqrt(D))
    s = torch.einsum("bkgd,btkd->bkgt", qg, kk)
    if logit_softcap > 0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    length = lengths.to(torch.int64)[:, None]
    entry = torch.arange(ppseq, device=dev)
    resident = (table >= 0) & (entry[None, :] * page < length)
    rank = resident.cumsum(1) - resident.to(torch.int64)
    n_res = resident.sum(1, keepdim=True)
    share = torch.zeros_like(rank)
    for sp in range(1, splits):
        share = torch.where(rank >= sp * n_res // splits, sp, share)
    pos = torch.arange(ppseq * page, device=dev)
    valid = (pos[None, :] < length) & resident[:, pos // page]
    s = torch.where(valid[:, None, None], s, -torch.inf)
    share_of = share[:, pos // page]
    m_all = torch.full((B, KV, G), -torch.inf, dtype=f32, device=dev)
    parts = []
    for sp in range(splits):
        mine = (valid & (share_of == sp))[:, None, None]
        sc = torch.where(mine, s, -torch.inf)
        m = sc.amax(-1)
        p = torch.where(mine, torch.exp(sc - torch.where(
            torch.isfinite(m), m, 0.0)[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bkgt,btkd->bkgd", p, vv)))
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros((B, KV, G), dtype=f32, device=dev)
    acc_all = torch.zeros((B, KV, G, D), dtype=f32, device=dev)
    for m, l, acc in parts:  # in share order
        f = torch.where(torch.isfinite(m), torch.exp(m - m_all), 0.0)
        l_all = l_all + l * f
        acc_all = acc_all + acc * f[..., None]
    out = torch.where((l_all > 0)[..., None],
                      acc_all / torch.clamp(l_all, min=1e-30)[..., None], 0.0)
    return out.reshape(B, H, D).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          logit_softcap: float = 0.0,
                          block_kv: int = 512) -> torch.Tensor:
    """Online-softmax GQA attention in float32.  q ``(B, S, H, D)``, k/v
    ``(B, T, KV, D)`` -> ``(B, S, H, D)`` in q's dtype.

    Query head ``h`` reads KV head ``h // (H // KV)``; q is scaled by
    ``1/sqrt(D)`` before the product; the softcap ``c * tanh(s / c)`` comes
    before the mask.  Key ``t`` is seen by query ``s`` iff ``t < T``, ``t <=
    s`` when causal, and ``t > s - window`` when ``window > 0`` (causal or
    not).  A row that sees no key gives zeros."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qg = q.reshape(B, S, KV, G, D).to(f32) * scale
    nblk = max(1, -(-T // block_kv))
    pad = nblk * block_kv - T
    kf = torch.nn.functional.pad(k.to(f32), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.to(f32), (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, S, KV, G), -torch.inf, dtype=f32, device=q.device)
    l = torch.zeros((B, S, KV, G), dtype=f32, device=q.device)
    acc = torch.zeros((B, S, KV, G, D), dtype=f32, device=q.device)
    for blk in range(nblk):
        start = blk * block_kv
        kb = kf[:, start:start + block_kv]
        vb = vf[:, start:start + block_kv]
        k_pos = start + torch.arange(block_kv, device=q.device)
        s = torch.einsum("bskgd,btkd->bskgt", qg, kb)
        if logit_softcap > 0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = (k_pos < T)[None, :].expand(S, block_kv)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        mask = mask[None, :, None, None]
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, S, H, D).to(q.dtype)
