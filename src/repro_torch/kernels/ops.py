"""Kernel dispatch by tensor device.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, which launches or raises — there is no fallback
from a failed build or launch.  ``FORCE = "plain"`` routes CUDA tensors to
the plain version too: it exists for the card-side comparison of each
kernel with its plain version (``chip_smoke.py``), not for users.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as fak
from . import page_migrate as pmk
from . import paged_attention as pak
from . import ref as R
from . import select_topk as sk

#: None (dispatch by device) or "plain" (plain version on every device)
FORCE: Optional[str] = None

_KERNELS = {"select_topk": sk, "page_migrate": pmk, "paged_attention": pak,
            "flash_attention": fak}


def _use_kernel(t: torch.Tensor) -> bool:
    if FORCE not in (None, "plain"):
        raise ValueError(f"ops.FORCE must be None or 'plain', got {FORCE!r}")
    if t.device.type == "cpu" or FORCE == "plain":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {t.device}")


def select_topk(p_mask, p_heat, d_mask, d_heat, n_promote, n_demote):
    """Exact top-k promote/demote selection masks (stable index tie-break);
    see :mod:`repro_torch.kernels.select_topk`.  Inputs are brought to the
    kernel's dtypes and made contiguous here."""
    if not _use_kernel(p_mask):
        return R.select_topk_ref(p_mask, p_heat, d_mask, d_heat, n_promote,
                                 n_demote)
    f32 = torch.float32
    return sk.select_topk(
        p_mask.to(torch.bool).contiguous(), p_heat.to(f32).contiguous(),
        d_mask.to(torch.bool).contiguous(), d_heat.to(f32).contiguous(),
        n_promote.to(f32).contiguous(), n_demote.to(f32).contiguous())


def topk_mask(scores, k, valid=None):
    """Exact top-``k`` boolean mask over a 1-D score vector (descending,
    candidate-index tie-break): the promote side of :func:`select_topk`
    alone, on one ``(1, N)`` row.

    The BO acquisition's top-q-EI step
    (:func:`repro_torch.core.bo.forest_fast.suggest_topq`).  Scores are
    taken as float32 (the kernel's key dtype); ``k`` becomes the kernel's
    float32 count; ``valid`` (bool ``(N,)``, all rows when None) masks
    candidates out.  Dispatch by device as :func:`select_topk`: the
    kernel gets no demote side (it reads and writes the promote side
    only), the plain version an empty one; launches count as
    :func:`select_topk`'s."""
    s = scores.to(torch.float32).reshape(1, -1).contiguous()
    v = torch.ones_like(s, dtype=torch.bool) if valid is None \
        else valid.to(device=s.device, dtype=torch.bool).reshape(1, -1)
    n_promote = torch.full((1,), float(k), dtype=torch.float32,
                           device=s.device)
    if not _use_kernel(s):
        pm, _ = R.select_topk_ref(v, s, torch.zeros_like(v),
                                  torch.zeros_like(s), n_promote,
                                  torch.zeros_like(n_promote))
        return pm[0]
    pm, _ = sk.select_topk(v.contiguous(), s, None, None, n_promote, None)
    return pm[0]


def page_migrate(dst, src, dst_ids, src_ids):
    """``dst[dst_ids[i]] = src[src_ids[i]]`` for every lane, in place;
    negative ids are no-ops and the last lane wins a shared destination;
    returns ``dst``.  See :mod:`repro_torch.kernels.page_migrate`.

    ``src`` and ``dst`` must be different tensors of one dtype (callers
    cast before they call); ids may be any integer sequence and are
    brought to contiguous int32 on the pools' device here."""
    if dst.dtype != src.dtype:
        raise TypeError(f"page_migrate: dst is {dst.dtype} but src is "
                        f"{src.dtype}; cast before migrating")
    if dst.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        raise ValueError("page_migrate: src and dst share storage; they "
                         "must be different tensors")
    if dst.shape[1:].numel() != src.shape[1:].numel():
        raise ValueError(f"page_migrate: rows differ in size: "
                         f"{tuple(dst.shape)} vs {tuple(src.shape)}")
    d = torch.as_tensor(dst_ids, device=dst.device).to(torch.int32)
    s = torch.as_tensor(src_ids, device=dst.device).to(torch.int32)
    if not _use_kernel(dst):
        return R.page_migrate_plain(dst, src, d, s)
    return pmk.page_migrate(dst, src, d.contiguous(), s.contiguous())


def paged_attention(q, k_pages, v_pages, block_table, lengths, *,
                    logit_softcap: float = 0.0):
    """One-token GQA decode attention over a paged pool; see
    :mod:`repro_torch.kernels.paged_attention`.  q is made contiguous and
    the table and lengths int32 here; the pools are passed as they are."""
    if not _use_kernel(q):
        return R.paged_attention_plain(q, k_pages, v_pages, block_table,
                                       lengths, logit_softcap=logit_softcap)
    return pak.paged_attention(
        q.contiguous(), k_pages, v_pages,
        block_table.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), logit_softcap=logit_softcap)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0):
    """Tiled online-softmax GQA attention, q ``(B, S, H, D)`` and k/v
    ``(B, T, KV, D)`` -> ``(B, S, H, D)``; see
    :mod:`repro_torch.kernels.flash_attention`.  Tensors are passed as they
    are (the kernel reads through strides).

    The kernel has no backward pass: on a CUDA tensor, a call whose
    gradient autograd would need raises ``NotImplementedError`` (the
    reference's Pallas kernel has no gradient either; training runs with
    ``use_flash=False``).  On the CPU the plain version is differentiable,
    as the reference's ``flash_attention_ref`` is."""
    if not _use_kernel(q):
        return R.flash_attention_plain(q, k, v, causal=causal, window=window,
                                       logit_softcap=logit_softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no gradient on the card: the kernel has no "
            "backward pass, nor has the reference's Pallas kernel (jax.grad "
            "through it raises); train with use_flash=False")
    return fak.flash_attention(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def launch_counts_by_variant() -> Dict[str, Dict[str, int]]:
    """Launches by variant of the kernels that have several (select_topk,
    paged_attention, flash_attention) since the last reset."""
    return {name: dict(mod.launches_by_variant)
            for name, mod in _KERNELS.items()
            if hasattr(mod, "launches_by_variant")}


def reset_launch_counts() -> None:
    """Sets every kernel's launch count, and the counts by variant of the
    kernels that have several (``launches_by_variant``), to 0."""
    for mod in _KERNELS.values():
        mod.launches = 0
        if hasattr(mod, "launches_by_variant"):
            mod.launches_by_variant.update(
                dict.fromkeys(mod.launches_by_variant, 0))
