"""One-token GQA decode attention over a paged KV pool on the card.

:func:`paged_attention` is the wrapper of the hand-written CUDA kernels in
``csrc/paged_attention.cu`` (built for ``sm_90a``; see that file for the
designs and what bounds them).  They replace the reference package's Pallas
TPU kernel ``src/repro/kernels/paged_attention.py::paged_attention`` and
also take the logit softcap that the reference routes to its jnp version.
Its plain PyTorch version is :func:`repro_torch.kernels.ref.
paged_attention_plain`, re-exported here as :func:`paged_attention_plain`;
:mod:`repro_torch.kernels.ops` picks between the two by device.

Two kernels compute the same function, and :func:`pick_variant` picks one
from the dtype and shape:

* ``"split"``: bfloat16 and float16 at D = 64 or 128 with pages a multiple
  of 16 tokens (the serving path).  Split-K decoding on the tensor cores:
  one CTA per (sequence, KV head, 16 query rows, share of the sequence's
  resident pages), the number of shares chosen by :func:`split_plan`, and
  with several a second launch that merges their float32 partials in
  share order.
* ``"walk"``: everything else (float32, other D or pages): one block per
  (KV head, sequence) walks its table on the FMA units.

The wrapper takes CUDA tensors only and launches a kernel or raises: q
``(B, H, D)`` contiguous; k/v pools ``(P, page, KV, D)`` of q's dtype
(float32, bfloat16 or float16) read through their strides — the last dim
contiguous, every stride and the base address 16-byte aligned — so a layer
view of a multi-layer pool is never copied; block table int32 ``(B,
pages_per_seq)`` and lengths int32 ``(B,)``, contiguous.  ``H`` is a
multiple of ``KV`` and ``D`` a multiple of 16 bytes; the walk kernel takes
``(H // KV) * D <= 4096``.  It allocates the output (and the split
kernel's float32 partials), launches on the current stream, checks the
launch, and adds one to :data:`launches` and to the variant's entry of
:data:`launches_by_variant`.
"""

from __future__ import annotations

import ctypes
import math
import sys
from typing import Optional

import torch

from . import build
from .ref import paged_attention_plain  # noqa: F401

#: the reference TPU kernel this replaces (file:line of its pallas_call)
REPLACES = "src/repro/kernels/paged_attention.py:108"
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: as in the kernel source: threads per block x accumulators per thread
MAX_GROUP_ELEMS = 256 * 16
#: dynamic shared memory a block may use on Hopper
MAX_SMEM = 227 * 1024
#: grid dims y and z are at most 65,535
MAX_GRID_YZ = 65535

#: the kernels of csrc/paged_attention.cu
VARIANTS = ("walk", "split")
#: head dims and dtypes the split kernel is compiled for
SPLIT_D = (64, 128)
SPLIT_DTYPES = (torch.bfloat16, torch.float16)
#: tokens of one mma k-step: split pages are a multiple of this
SPLIT_UNIT = 16
#: resident pages one split CTA takes (one warp ballot)
MAX_SHARE = 32
#: 16-token units a split CTA should get before a sequence is split
#: further: below it, a CTA's fixed costs (its Q load, the merge, the
#: partial's write and the combine) outweigh the loads it overlaps.  Set
#: from two shapes timed by chip_smoke.py: the serving shape (1 split
#: beats 2, 4, 8) and 4 sequences of 64 resident pages (16 beat 4)
MIN_UNITS_PER_SPLIT = 16

#: wrapper calls since the last reset (the main-path launch counter; a
#: split call launches its combine kernel too when it has several splits)
launches = 0
#: the same calls by variant; reset with :data:`launches`
launches_by_variant = dict.fromkeys(VARIANTS, 0)

_fns = {}
_sms = {}


def _kernel(variant: str):
    fn = _fns.get(variant)
    if fn is None:
        lib = build.load("paged_attention")
        if variant == "walk":
            fn = lib.paged_attention_launch
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
                [ctypes.c_longlong] * 6 + [ctypes.c_float] * 2 + \
                [ctypes.c_longlong, ctypes.c_void_p]
        else:
            fn = lib.paged_attention_split_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + \
                [ctypes.c_longlong] * 6 + [ctypes.c_float] * 2 + \
                [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[variant] = fn
    return fn


def pick_variant(dtype: torch.dtype, G: int, D: int, page: int) -> str:
    """The kernel that computes attention for ``dtype`` at group size
    ``G`` (query heads per KV head), head dim ``D`` and ``page`` tokens a
    page: ``"split"`` where the mma tiles fit, else ``"walk"``."""
    if G <= 0 or D <= 0 or page <= 0:
        raise ValueError(f"paged_attention: no kernel for G={G}, D={D}, "
                         f"page={page}")
    if dtype in SPLIT_DTYPES and D in SPLIT_D and page % SPLIT_UNIT == 0:
        return "split"
    return "walk"


def split_plan(B: int, KV: int, pages_per_seq: int, page: int, n_sms: int,
               pool_pages: int) -> int:
    """The split kernel's splits per (sequence, KV head): CTA ``s`` takes
    the ``s``-th of ``splits`` even shares of the sequence's resident
    pages.  At most ``pool_pages`` pages are resident over ``B``
    sequences, so a sequence has about ``min(pages_per_seq,
    ceil(pool_pages / B))``.  Splits are as many as give each share
    :data:`MIN_UNITS_PER_SPLIT` units and the grid one CTA per SM, and at
    least ``ceil(pages_per_seq / MAX_SHARE)``, so a share fits the CTA's
    list (one warp ballot)."""
    if min(B, KV, pages_per_seq, page, n_sms) <= 0 or pool_pages < 0:
        raise ValueError(f"paged_attention: no split plan for B={B}, "
                         f"KV={KV}, pages_per_seq={pages_per_seq}, "
                         f"page={page}, n_sms={n_sms}, "
                         f"pool_pages={pool_pages}")
    resident = min(pages_per_seq, -(-pool_pages // B))
    by_work = resident * (page // SPLIT_UNIT) // MIN_UNITS_PER_SPLIT
    by_sms = n_sms // (B * KV)
    return max(-(-pages_per_seq // MAX_SHARE), min(by_work, by_sms), 1)


def _n_sms(device: torch.device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def smem_bytes(dtype: torch.dtype, G: int, D: int, page: int) -> int:
    """Dynamic shared memory of one block: padded K and V page tiles in
    the pool's dtype, then float32 query rows, scores and row state."""
    elt = torch.empty((), dtype=dtype).element_size()
    return 2 * page * (D + 16 // elt) * elt + 4 * (G * D + G * page + 3 * G)


def paged_attention(q, k_pages, v_pages, block_table, lengths,
                    logit_softcap: float = 0.0, *,
                    variant: Optional[str] = None,
                    splits: Optional[int] = None):
    """Launch a CUDA kernel; returns ``(B, H, D)`` in q's dtype.

    ``variant`` overrides :func:`pick_variant`'s choice and ``splits``
    :func:`split_plan`'s; they exist to time one kernel or plan against
    another at the same shape on the card (chip_smoke.py), not for
    users."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got "
                         f"{device}; the plain version serves the CPU")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"expected {device}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q, k and v must share one of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError("paged_attention: q must be a contiguous (B, H, D)")
    B, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != D:
        raise ValueError(f"paged_attention: k/v pools must be (P, page, KV, "
                         f"{D}), got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    P, page, KV, _ = k_pages.shape
    if KV == 0 or H % KV:
        raise ValueError(f"paged_attention: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    G = H // KV
    for name, t, shape in (("block_table", block_table, None),
                           ("lengths", lengths, (B,))):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"paged_attention: {name} must be contiguous "
                            f"int32, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"paged_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"paged_attention: block_table must be (B={B}, "
                         f"pages_per_seq), got {tuple(block_table.shape)}")
    elt = q.element_size()
    for name, pool in (("k_pages", k_pages), ("v_pages", v_pages)):
        strides = pool.stride()
        if strides[3] != 1 or (D * elt) % 16 or pool.data_ptr() % 16 \
                or any((s * elt) % 16 for s in strides[:3]):
            raise ValueError(f"paged_attention: {name} needs a contiguous "
                             f"last dim and 16-byte aligned base and "
                             f"strides, got strides {strides}")
    ppseq = block_table.shape[1]
    chosen = variant or pick_variant(q.dtype, G, D, page)
    if chosen not in VARIANTS:
        raise ValueError(f"paged_attention: variant must be one of "
                         f"{list(VARIANTS)}, got {chosen!r}")
    out = torch.empty_like(q)
    ks, vs = k_pages.stride(), v_pages.stride()
    scale = 1.0 / math.sqrt(D)
    if chosen == "split":
        if pick_variant(q.dtype, G, D, page) != "split" \
                or q.data_ptr() % 4:
            raise ValueError(f"paged_attention: the split kernel takes "
                             f"{SPLIT_DTYPES} at D in {SPLIT_D} with pages "
                             f"a multiple of {SPLIT_UNIT} tokens and a "
                             f"4-byte aligned q, got {q.dtype}, D={D}, "
                             f"page={page}")
        if splits is None:
            splits = split_plan(B, KV, max(ppseq, 1), page, _n_sms(device),
                                P)
        elif splits < max(1, -(-ppseq // MAX_SHARE)):
            raise ValueError(f"paged_attention: {ppseq} table entries need "
                             f"at least {-(-ppseq // MAX_SHARE)} splits, "
                             f"got {splits}")
        m_tiles = -(-G // SPLIT_UNIT)
        if KV * m_tiles > MAX_GRID_YZ or B > MAX_GRID_YZ:
            raise ValueError(f"paged_attention: {B} sequences or {KV} KV "
                             f"heads x {m_tiles} row tiles exceed the grid")
        part = [None, None, None]
        if splits > 1:
            # float32 partials, one allocation: m and l (B * H, splits),
            # then acc (B * H, splits, D)
            n = B * H * splits
            scratch = torch.empty(n * (D + 2), dtype=torch.float32,
                                  device=device)
            base = scratch.data_ptr()
            part = [base, base + 4 * n, base + 8 * n]
        fn = _kernel("split")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_table.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), *part, _DTYPES[q.dtype], B, KV, G, D,
                     page, ppseq, P, splits, ks[0], ks[1], ks[2],
                     vs[0], vs[1], vs[2], scale, float(logit_softcap), stream)
    else:
        if G * D > MAX_GROUP_ELEMS:
            raise ValueError(f"paged_attention: (H // KV) * D = {G * D} "
                             f"exceeds {MAX_GROUP_ELEMS}")
        smem = smem_bytes(q.dtype, G, D, page)
        if smem > MAX_SMEM:
            raise ValueError(f"paged_attention: a block would need {smem} "
                             f"bytes of shared memory (at most {MAX_SMEM})")
        fn = _kernel("walk")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_table.data_ptr(), lengths.data_ptr(),
                     out.data_ptr(), _DTYPES[q.dtype], B, KV, G, D, page,
                     ppseq, P, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                     scale, float(logit_softcap), smem, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention {chosen} kernel launch failed: "
                           f"CUDA error {err}")
    build.count_launch(sys.modules[__name__], chosen)
    return out
