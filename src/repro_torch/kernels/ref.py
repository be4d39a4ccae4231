"""Plain PyTorch versions of the port's kernels: the CPU path and the
oracle every kernel is compared with on the card.

:func:`select_topk_ref` mirrors the reference package's pure-jnp
``select_topk_ref``: a dual 32-step bitwise search for each side's cutoff
key, the strict set taken wholesale, and the boundary tier filled in page
index order by a 17-step search over descending-index weights.  Keys are
order-preserving float32 bits held in int64 (this torch build has no
shifts or comparisons on ``torch.uint32``); every count is an exact integer.
"""

from __future__ import annotations

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
