"""Tiled online-softmax GQA attention (the prefill core) on the card.

:func:`flash_attention` is the wrapper of the hand-written CUDA kernels in
``csrc/flash_attention.cu`` (built for ``sm_90a``; see that file for the
design).  They replace the reference package's Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention``.  Its plain PyTorch
version is :func:`repro_torch.kernels.ref.flash_attention_plain`,
re-exported here; :mod:`repro_torch.kernels.ops` picks between the two by
device.

Three kernels compute the same function, and :func:`pick_variant` picks one
from the dtype and head dim:

* ``"wgmma"``: bfloat16 at D = 64, 120, 128 or 256, the LM prefill paths
  (chatglm3-6b at 128, granite-moe at 64, h2o-danube-3-4b at 120,
  recurrentgemma-2b's local attention and gemma2-9b at 256).  Persistent
  blocks; in each, a TMA ring of K/V tiles filled by a producer warp and
  two consumer warpgroups of 64 query rows running ``wgmma`` with the
  online softmax in registers, overlapped with the previous tile's P V.
  The tile plan depends on D: at 64 and 128, key tiles of 128 and two Q
  buffers (D = 120 runs D = 128's plan, its tensor maps 120 columns wide,
  TMA filling the rest with zeros); at 256, key tiles of 64
  (S in 32 float registers a thread, O in 128), one 64 KB Q buffer through
  which each consumer also stages its output, and a 2-stage ring of 32 KB
  K and V tiles, 197,720 bytes of shared memory in all.  Bound by
  operations (4 * D flops per attended (query, key) pair, on the tensor
  cores at 989 TFLOP/s bf16 on an H100 SXM); its time beside that bound is
  in PERF.md.
* ``"mma"``: bfloat16 at any other D (16, 112, ...),
  ``mma.sync`` with synchronous tile loads; compiled for every D up to 256.
* ``"fma"``: float32 on the FMA units (tensor cores would round to TF32).

The wrapper takes CUDA tensors only and launches a kernel or raises: q
``(B, S, H, D)`` and k/v ``(B, T, KV, D)`` of one dtype, read through their
strides — the last dim contiguous, every stride and base address 16-byte
aligned (what TMA needs too) — with ``H`` a multiple of ``KV`` and ``D`` a
multiple of 8 up to 256.  It allocates the contiguous ``(B, S, H, D)``
output (and, for the wgmma kernel, its work counter, one zeroed int32),
launches on the current stream, checks the launch, and adds one to
:data:`launches` and to the variant's entry of :data:`launches_by_variant`.
There is no fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
import sys
from typing import Optional

import torch

from . import build
from .ref import flash_attention_plain  # noqa: F401

#: the reference TPU kernel this replaces (file:line of its pallas_call)
REPLACES = "src/repro/kernels/flash_attention.py:102"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: the kernels, by the code the C launcher takes
VARIANTS = {"fma": 0, "mma": 1, "wgmma": 2}
#: head dims the wgmma kernel takes (120 on the plan of 128)
WGMMA_D = (64, 120, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256
#: grid dims y (batch) and z (query tiles) are at most 65,535
MAX_GRID_YZ = 65535

#: kernel launches since the last reset (the main-path launch counter)
launches = 0
#: the same launches by variant; reset with :data:`launches`
launches_by_variant = dict.fromkeys(VARIANTS, 0)

_fn = None


def bind(lib: ctypes.CDLL):
    """``flash_attention_launch`` of a loaded library, its C types set."""
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_longlong] * 9 + [ctypes.c_float] * 2 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load("flash_attention"))
    return _fn


def pick_variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that computes attention for ``dtype`` at head dim ``D``:
    ``fma`` for float32; for bfloat16, ``wgmma`` at D in :data:`WGMMA_D`
    (64, 120, 128, 256) and ``mma`` at any other D (16, 112, ...)."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    return "wgmma" if D in WGMMA_D else "mma"


def _check_variant(name: str, dtype: torch.dtype, D: int) -> None:
    if name not in VARIANTS:
        raise ValueError(f"flash_attention: variant must be one of "
                         f"{list(VARIANTS)}, got {name!r}")
    if (name == "fma") != (dtype == torch.float32):
        raise ValueError(f"flash_attention: the {name} kernel does not take "
                         f"{dtype}")
    if name == "wgmma" and D not in WGMMA_D:
        raise ValueError(f"flash_attention: the wgmma kernel takes head dims "
                         f"{WGMMA_D}, got {D}")


def check_inputs(q, k, v, variant_name=None) -> None:
    """Raise on any input the kernel (``variant_name``, or the one
    :func:`pick_variant` picks) does not take, device aside."""
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
    if variant_name is not None:
        _check_variant(variant_name, q.dtype, D)
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


def launch(fn, q, k, v, variant: str, *, causal: bool, window: int,
           logit_softcap: float):
    """Launch ``fn`` (a ``flash_attention_launch`` of a built library) as
    ``variant`` on checked CUDA tensors; returns the new output."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    # the wgmma kernel's work counter, 0 at launch
    next_item = torch.zeros(1, dtype=torch.int32, device=q.device) \
        if variant == "wgmma" else None
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 VARIANTS[variant], B, S, T, H, KV, D,
                 qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                 1.0 / math.sqrt(D), float(logit_softcap), int(bool(causal)),
                 int(window),
                 None if next_item is None else next_item.data_ptr(), stream)
    if err != 0:
        what = ("a TMA tensor map could not be encoded" if err < 0
                else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           f"{what}")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    variant: Optional[str] = None):
    """Launch the CUDA kernel; returns ``(B, S, H, D)`` in q's dtype.

    ``variant`` overrides :func:`pick_variant`'s choice; it exists to time one
    kernel against another at the same shape on the card (chip_smoke.py),
    not for users."""
    check_inputs(q, k, v, variant)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{device}; the plain version serves the CPU")
    for name, t in (("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"expected {device}")
    chosen = variant or pick_variant(q.dtype, q.shape[3])
    out = launch(_kernel(), q, k, v, chosen, causal=causal, window=window,
                 logit_softcap=logit_softcap)
    build.count_launch(sys.modules[__name__], chosen)
    return out
