"""One-token GQA decode attention over a paged KV pool on the card.

:func:`paged_attention` is the wrapper of the hand-written CUDA kernel
``csrc/paged_attention.cu`` (built for ``sm_90a``; see that file for the
design and what bounds it).  It replaces the reference package's Pallas TPU
kernel ``src/repro/kernels/paged_attention.py::paged_attention`` and also
takes the logit softcap that the reference routes to its jnp version.  Its
plain PyTorch version is :func:`repro_torch.kernels.ref.
paged_attention_plain`, re-exported here as :func:`paged_attention_plain`;
:mod:`repro_torch.kernels.ops` picks between the two by device.

The wrapper takes CUDA tensors only and launches the kernel or raises: q
``(B, H, D)`` contiguous; k/v pools ``(P, page, KV, D)`` of q's dtype
(float32, bfloat16 or float16) read through their strides — the last dim
contiguous, every stride and the base address 16-byte aligned — so a layer
view of a multi-layer pool is never copied; block table int32 ``(B,
pages_per_seq)`` and lengths int32 ``(B,)``, contiguous.  ``H`` is a
multiple of ``KV``, ``D`` a multiple of 16 bytes, ``(H // KV) * D <=
4096``.  It allocates the output, launches on the current stream, checks
the launch, and adds one to :data:`launches`.
"""

from __future__ import annotations

import ctypes
import math

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

#: kernel launches since the last reset (the main-path launch counter)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("paged_attention").paged_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
            [ctypes.c_longlong] * 6 + [ctypes.c_float] * 2 + \
            [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def smem_bytes(dtype: torch.dtype, G: int, D: int, page: int) -> int:
    """Dynamic shared memory of one block: padded K and V page tiles in
    the pool's dtype, then float32 query rows, scores and row state."""
    elt = torch.empty((), dtype=dtype).element_size()
    return 2 * page * (D + 16 // elt) * elt + 4 * (G * D + G * page + 3 * G)


def paged_attention(q, k_pages, v_pages, block_table, lengths,
                    logit_softcap: float = 0.0):
    """Launch the CUDA kernel; returns ``(B, H, D)`` in q's dtype."""
    global launches
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
    if H % KV:
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
    if G * D > MAX_GROUP_ELEMS:
        raise ValueError(f"paged_attention: (H // KV) * D = {G * D} exceeds "
                         f"{MAX_GROUP_ELEMS}")
    smem = smem_bytes(q.dtype, G, D, page)
    if smem > MAX_SMEM:
        raise ValueError(f"paged_attention: a block would need {smem} bytes "
                         f"of shared memory (at most {MAX_SMEM})")
    out = torch.empty_like(q)
    ks, vs = k_pages.stride(), v_pages.stride()
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, KV, G, D, page, block_table.shape[1], P,
                 ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                 1.0 / math.sqrt(D), float(logit_softcap), smem, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
