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

from . import ref as R
from . import select_topk as sk

#: None (dispatch by device) or "plain" (plain version on every device)
FORCE: Optional[str] = None


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


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {"select_topk": sk.launches}


def reset_launch_counts() -> None:
    sk.launches = 0
