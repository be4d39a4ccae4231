"""Exact top-k page selection (the migration planner's sort) on the card.

:func:`select_topk` is the wrapper of the hand-written CUDA kernels in
``csrc/select_topk.cu`` (built for ``sm_90a``; see that file for the
designs and what bounds them).  They replace the reference package's Pallas
TPU kernel ``src/repro/kernels/select_topk.py::select_topk``.  Its plain
PyTorch version is :func:`repro_torch.kernels.ref.select_topk_ref`,
re-exported here as :func:`select_topk_plain`; :mod:`repro_torch.kernels.
ops` picks between the two by the device of the tensors.

Two kernels compute the same masks, bitwise, and :func:`pick_variant`
picks one from the row length:

* ``"cluster"``: rows of more than :data:`BLOCK_MAX_N` pages (the tuning
  loop's 32,783 and the KV replay's 2,048): one thread-block cluster of
  :data:`CLUSTER_SIZE` CTAs per row, each holding its slice's keys in
  shared memory, histograms summed through distributed shared memory.
* ``"block"``: shorter rows, which one block covers in a single tile: one
  1024-thread block per row.

The wrapper takes CUDA tensors only and launches a kernel or raises:
masks bool ``(B, n)``, heats float32 ``(B, n)``, counts float32 ``(B,)``,
all contiguous on one device, ``n <= MAX_N``.  The demote side may be
left out (``d_mask``, ``d_heat`` and ``n_demote`` all None): the kernel
then reads and writes the promote side only, and no demote mask is
returned.  It allocates the output masks, launches on the current stream,
checks the launch, and adds one to :data:`launches` and to the variant's
entry of :data:`launches_by_variant`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import select_topk_ref as select_topk_plain  # noqa: F401

#: the reference TPU kernel this replaces (file:line of its pallas_call)
REPLACES = "src/repro/kernels/select_topk.py:133"
SOURCE = "src/repro_torch/kernels/csrc/select_topk.cu"
#: the kernels of csrc/select_topk.cu
VARIANTS = ("block", "cluster")
#: longest row the rule gives the block kernel (one 1024-page tile).  On
#: an H100 the block kernel is faster up to 2,048 pages and the cluster
#: kernel from 4,096 (chip_smoke.py's sweep, PERF.md); rows in between,
#: the KV replay's 2,048 among them, take the cluster kernel for now
#: (ROADMAP queue 2)
BLOCK_MAX_N = 1024
#: CTAs of one cluster (a row) of the cluster kernel, kCluster in the
#: source: 16 needs the non-portable cluster size allowed; the portable 8
#: measured about 5% slower at the tuning shape (PERF.md)
CLUSTER_SIZE = 16
#: grid dim y (rows of the cluster kernel) is at most 65,535
MAX_GRID_Y = 65535
#: shared memory one block may use on an H100 (the opt-in maximum), bytes
SMEM_PER_BLOCK = 232_448
#: the cluster kernel's static shared memory (its 64-bit block scan's
#: storage, the histograms, their sums and the walk), bytes, as ptxas
#: reports it for sm_90a (``ptxas info`` in chip_smoke.py's build report)
CLUSTER_STATIC_SMEM = 10_576
#: page ceiling: a cluster kernel's CTA holds the two u32 key rows of its
#: slice, ceil(n / CLUSTER_SIZE) pages, in the shared memory its static
#: part leaves.  The boundary scan counts in 32-bit halves, so it sets no
#: lower ceiling; the block kernel takes the same rows
MAX_N = CLUSTER_SIZE * ((SMEM_PER_BLOCK - CLUSTER_STATIC_SMEM) // 8)

#: wrapper calls since the last reset (the main-path launch counter)
launches = 0
#: the same calls by variant; reset with :data:`launches`
launches_by_variant = dict.fromkeys(VARIANTS, 0)

_fns = {}


def _kernel(variant: str):
    fn = _fns.get(variant)
    if fn is None:
        lib = build.load("select_topk")
        fn = lib.select_topk_launch if variant == "block" else \
            lib.select_topk_cluster_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[variant] = fn
    return fn


def pick_variant(B: int, n: int) -> str:
    """The kernel that selects over ``B`` rows of ``n`` pages."""
    if B < 0 or not 0 <= n <= MAX_N:
        raise ValueError(f"select_topk takes rows of at most {MAX_N} pages, "
                         f"got ({B}, {n})")
    return "block" if n <= BLOCK_MAX_N else "cluster"


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


def select_topk(p_mask, p_heat, d_mask, d_heat, n_promote, n_demote, *,
                variant: Optional[str] = None):
    """Launch a CUDA kernel: ``(promote_mask, demote_mask)`` bool
    ``(B, n)``, the top ``floor(n_promote)`` promote candidates by heat
    descending and the top ``floor(n_demote)`` demote candidates by heat
    ascending per row, ties by page index ascending.  With ``d_mask``,
    ``d_heat`` and ``n_demote`` all None the demote side is left out and
    ``demote_mask`` is None.

    ``variant`` overrides :func:`pick_variant`'s choice; it exists to time
    one kernel against the other at the same shape on the card
    (chip_smoke.py), not for users."""
    global launches
    device = p_mask.device
    if device.type != "cuda":
        raise ValueError(f"select_topk kernel needs CUDA tensors, got "
                         f"{device}; the plain version serves the CPU")
    B, n = p_mask.shape
    if n > MAX_N:
        raise ValueError(f"select_topk takes rows of at most {MAX_N} pages, "
                         f"got {n}")
    demote = (d_mask, d_heat, n_demote)
    has_d = d_mask is not None
    if any((t is None) == has_d for t in demote):
        raise ValueError("select_topk: pass d_mask, d_heat and n_demote "
                         "together, or none of them")
    checks = [("p_mask", p_mask, torch.bool, (B, n)),
              ("p_heat", p_heat, torch.float32, (B, n)),
              ("n_promote", n_promote, torch.float32, (B,))]
    if has_d:
        checks += [("d_mask", d_mask, torch.bool, (B, n)),
                   ("d_heat", d_heat, torch.float32, (B, n)),
                   ("n_demote", n_demote, torch.float32, (B,))]
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, device)
    chosen = variant or pick_variant(B, n)
    if chosen not in VARIANTS:
        raise ValueError(f"select_topk: variant must be one of "
                         f"{list(VARIANTS)}, got {chosen!r}")
    if chosen == "cluster" and B > MAX_GRID_Y:
        raise ValueError(f"select_topk: {B} rows exceed the launch grid")
    pm = torch.empty((B, n), dtype=torch.bool, device=device)
    dm = torch.empty((B, n), dtype=torch.bool, device=device) if has_d \
        else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _kernel(chosen)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(p_mask.data_ptr(), p_heat.data_ptr(), ptr(d_mask),
                 ptr(d_heat), n_promote.data_ptr(), ptr(n_demote),
                 pm.data_ptr(), ptr(dm), B, n, stream)
    if err != 0:
        raise RuntimeError(f"select_topk {chosen} kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    launches_by_variant[chosen] += 1
    return pm, dm
