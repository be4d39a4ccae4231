"""Tiled online-softmax GQA attention (the prefill core) on the card.

:func:`flash_attention` is the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu`` (built for ``sm_90a``; see that file for the
design and what bounds it).  It replaces the reference package's Pallas TPU
kernel ``src/repro/kernels/flash_attention.py::flash_attention``.  Its plain
PyTorch version is :func:`repro_torch.kernels.ref.flash_attention_plain`,
re-exported here; :mod:`repro_torch.kernels.ops` picks between the two by
device.

The wrapper takes CUDA tensors only and launches the kernel or raises: q
``(B, S, H, D)`` and k/v ``(B, T, KV, D)`` of one dtype (bfloat16 on the
tensor cores, float32 on the FMA units), read through their strides — the
last dim contiguous, every stride and base address 16-byte aligned — with
``H`` a multiple of ``KV`` and ``D`` a multiple of 8 up to 256.  It
allocates the contiguous ``(B, S, H, D)`` output, launches on the current
stream, checks the launch, and adds one to :data:`launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import flash_attention_plain  # noqa: F401

#: the reference TPU kernel this replaces (file:line of its pallas_call)
REPLACES = "src/repro/kernels/flash_attention.py:102"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256
#: grid dims y (batch) and z (query tiles) are at most 65,535
MAX_GRID_YZ = 65535

#: kernel launches since the last reset (the main-path launch counter)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_longlong] * 9 + [ctypes.c_float] * 2 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_inputs(q, k, v) -> None:
    """Raise on any input the kernel does not take (device aside)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share one of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, S, H, D) and k/v "
                         f"one (B, T, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} in batch or head dim")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    if D % 8 or not 0 < D <= MAX_D:
        raise ValueError(f"flash_attention: head dim {D} must be a multiple "
                         f"of 8 and at most {MAX_D}")
    if B > MAX_GRID_YZ or -(-S // 32) > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {B} or {S} query rows "
                         f"exceed the launch grid")
    elt = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        if st[3] != 1 or t.data_ptr() % 16 \
                or any((s * elt) % 16 for s in st[:3]):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dim and 16-byte aligned base and "
                             f"strides, got strides {st}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0):
    """Launch the CUDA kernel; returns ``(B, S, H, D)`` in q's dtype."""
    global launches
    check_inputs(q, k, v)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{device}; the plain version serves the CPU")
    for name, t in (("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"expected {device}")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=device)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, S, T, H, KV, D,
                 qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                 1.0 / math.sqrt(D), float(logit_softcap), int(bool(causal)),
                 int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
