"""Exact top-k page selection (the migration planner's sort) on the card.

:func:`select_topk` is the wrapper of the hand-written CUDA kernel
``csrc/select_topk.cu`` (built for ``sm_90a``; see that file for the design
and what bounds it).  It replaces the reference package's Pallas TPU kernel
``src/repro/kernels/select_topk.py::select_topk``.  Its plain PyTorch
version is :func:`repro_torch.kernels.ref.select_topk_ref`, re-exported here
as :func:`select_topk_plain`; :mod:`repro_torch.kernels.ops` picks between
the two by the device of the tensors.

The wrapper takes CUDA tensors only and launches the kernel or raises:
masks bool ``(B, n)``, heats float32 ``(B, n)``, counts float32 ``(B,)``,
all contiguous on one device, ``n <= 65535``.  It allocates the two bool
output masks, launches on the current stream, checks the launch, and adds
one to :data:`launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import select_topk_ref as select_topk_plain  # noqa: F401

#: the reference TPU kernel this replaces (file:line of its pallas_call)
REPLACES = "src/repro/kernels/select_topk.py:133"
SOURCE = "src/repro_torch/kernels/csrc/select_topk.cu"
#: page ceiling: the boundary scan packs two 16-bit counters
MAX_N = (1 << 16) - 1

#: kernel launches since the last reset (the main-path launch counter)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("select_topk").select_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"select_topk: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"select_topk: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"select_topk: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"select_topk: {name} must be contiguous")


def select_topk(p_mask, p_heat, d_mask, d_heat, n_promote, n_demote):
    """Launch the CUDA kernel: ``(promote_mask, demote_mask)`` bool
    ``(B, n)``, the top ``floor(n_promote)`` promote candidates by heat
    descending and the top ``floor(n_demote)`` demote candidates by heat
    ascending per row, ties by page index ascending."""
    global launches
    device = p_mask.device
    if device.type != "cuda":
        raise ValueError(f"select_topk kernel needs CUDA tensors, got "
                         f"{device}; the plain version serves the CPU")
    B, n = p_mask.shape
    if n > MAX_N:
        raise ValueError(f"select_topk takes rows of at most {MAX_N} pages, "
                         f"got {n}")
    for name, t, dtype, shape in (
            ("p_mask", p_mask, torch.bool, (B, n)),
            ("p_heat", p_heat, torch.float32, (B, n)),
            ("d_mask", d_mask, torch.bool, (B, n)),
            ("d_heat", d_heat, torch.float32, (B, n)),
            ("n_promote", n_promote, torch.float32, (B,)),
            ("n_demote", n_demote, torch.float32, (B,))):
        _check(name, t, dtype, shape, device)
    pm = torch.empty((B, n), dtype=torch.bool, device=device)
    dm = torch.empty((B, n), dtype=torch.bool, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(p_mask.data_ptr(), p_heat.data_ptr(), d_mask.data_ptr(),
                 d_heat.data_ptr(), n_promote.data_ptr(), n_demote.data_ptr(),
                 pm.data_ptr(), dm.data_ptr(), B, n, stream)
    if err != 0:
        raise RuntimeError(f"select_topk kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return pm, dm
