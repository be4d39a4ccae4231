"""Batched page migration between two page pools on the card.

:func:`page_migrate` is the wrapper of the hand-written CUDA kernel
``csrc/page_migrate.cu`` (built for ``sm_90a``; see that file for the
design and what bounds it).  It replaces the reference package's Pallas TPU
kernel ``src/repro/kernels/page_migrate.py::page_migrate``.  Its plain
PyTorch version is :func:`repro_torch.kernels.ref.page_migrate_plain`,
re-exported here as :func:`page_migrate_plain`; :mod:`repro_torch.kernels.
ops` validates the arguments and picks between the two by device.

The wrapper takes CUDA tensors only and launches the kernel or raises:
pools ``(P_dst, ...)`` and ``(P_src, ...)`` of one dtype whose rows
(everything after dim 0) are contiguous and of equal size, on one device,
and int32 id vectors ``(N,)``.  It updates ``dst`` in place, allocates the
kernel's winner scratch (one int32 per destination row), launches on the
current stream, checks the launch, and adds one to :data:`launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import page_migrate_plain  # noqa: F401

#: the reference TPU kernel this replaces (file:line of its pallas_call)
REPLACES = "src/repro/kernels/page_migrate.py:52"
SOURCE = "src/repro_torch/kernels/csrc/page_migrate.cu"
#: copy chunk of one block (bytes), as in the kernel source
CHUNK_BYTES = 32 * 1024
#: the kernel's grid carries row chunks in its y dimension
MAX_ROW_BYTES = 65535 * CHUNK_BYTES

#: kernel launches since the last reset (the main-path launch counter)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("page_migrate").page_migrate_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def page_migrate(dst, src, dst_ids, src_ids):
    """Launch the CUDA kernel: ``dst[dst_ids[i]] = src[src_ids[i]]`` in
    place (negative ids are no-ops, the last lane wins a shared
    destination); returns ``dst``."""
    global launches
    device = dst.device
    if device.type != "cuda":
        raise ValueError(f"page_migrate kernel needs CUDA tensors, got "
                         f"{device}; the plain version serves the CPU")
    if src.device != device or dst_ids.device != device \
            or src_ids.device != device:
        raise ValueError("page_migrate: pools and ids must share one device")
    if src.dtype != dst.dtype:
        raise TypeError(f"page_migrate: dst is {dst.dtype} but src is "
                        f"{src.dtype}")
    for name, ids in (("dst_ids", dst_ids), ("src_ids", src_ids)):
        if ids.dtype != torch.int32 or ids.dim() != 1 \
                or not ids.is_contiguous():
            raise TypeError(f"page_migrate: {name} must be a contiguous "
                            f"int32 vector, got {ids.dtype} "
                            f"{tuple(ids.shape)}")
    if dst_ids.numel() != src_ids.numel():
        raise ValueError("page_migrate: dst_ids and src_ids differ in "
                         "length")
    row_elems = math.prod(dst.shape[1:])
    row_bytes = row_elems * dst.element_size()
    for name, pool in (("dst", dst), ("src", src)):
        if pool.dim() < 2 or math.prod(pool.shape[1:]) != row_elems \
                or not pool[:1].is_contiguous() \
                or pool.stride(0) < row_elems:
            raise ValueError(f"page_migrate: {name} rows must be "
                             f"contiguous, not overlap, and hold "
                             f"{row_elems} elements")
    if row_bytes > MAX_ROW_BYTES:
        raise ValueError(f"page_migrate: rows of at most {MAX_ROW_BYTES} "
                         f"bytes, got {row_bytes}")
    n = dst_ids.numel()
    winner = torch.empty(max(dst.shape[0], 1), dtype=torch.int32,
                         device=device)
    elt = dst.element_size()
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), dst_ids.data_ptr(),
                 src_ids.data_ptr(), winner.data_ptr(), n, dst.shape[0],
                 src.shape[0], row_bytes, src.stride(0) * elt,
                 dst.stride(0) * elt, stream)
    if err != 0:
        raise RuntimeError(f"page_migrate kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return dst
