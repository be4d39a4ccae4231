"""Where the wgmma ``flash_attention`` kernel spends its time, by ablation.

Builds copies of ``csrc/flash_attention.cu`` with part of the softmax taken
out -- ``noexp`` (ex2 is the identity) and ``nosoftmax`` (nothing runs
between the two products but packing S to bf16) -- and times them beside
the kernel, the mma kernel and ``scaled_dot_product_attention`` at
chatglm3-6b's prefill shape (D = 128) and recurrentgemma-2b's (D = 256,
window 2,048; SDPA given the window's boolean mask and K/V repeated to the
query heads, not timed), in turns (the list forward, then backward).
Each time is the card's per call over runs of 10 back-to-back calls (see
:func:`cuda_ms`), unlike ``chip_smoke.py``'s one call per event pair, which
also counts the host's launch work.  The ablated copies compute wrong
results; they time what is left.  On a machine with a CUDA card, from the
root of a checkout:

    PYTHONPATH=src python -m repro_torch.kernels.flash_ablation
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

from . import build
from . import flash_attention as fak

#: (name, text of csrc/flash_attention.cu, what replaces it)
ABLATIONS = (
    ("noexp", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
     "y = x;"),
    ("nosoftmax", "  const auto softmax = [&](int k0) {\n",
     "  const auto softmax = [&](int k0) {\n"
     "    for (int j = 0; j < kSAcc; ++j) sm90::fence_operand(sc[j]);\n"
     "    return;\n"),
)
#: q (B, S, H, D) and k/v (B, S, KV, D), bf16, causal, and the window: the
#: prefills of chatglm3-6b and recurrentgemma-2b
SHAPES = {"chatglm3-6b": (4, 2048, 32, 2, 128, 0),
          "recurrentgemma-2b": (2, 4096, 10, 1, 256, 2048)}


def ablated_source(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"ablation text not found once in the kernel "
                           f"source: {old!r}")
    return text.replace(old, new)


def build_ablations():
    """{name: flash_attention_launch} of every ablated copy, built in
    parallel under ``build/``."""
    text = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, old, new in ABLATIONS:
        d = build.BUILD_DIR / f"ablate-{name}"
        d.mkdir(parents=True, exist_ok=True)
        for header in build.sources("flash_attention")[1:]:
            shutil.copy(header, d / header.name)
        (d / "flash_attention.cu").write_text(ablated_source(text, old, new))
        lib = d / "libflash_attention.so"
        cmd = [build._nvcc(), *build.flags("flash_attention"), "-o", str(lib),
               str(d / "flash_attention.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} failed to build:\n{log}")
        fns[name] = fak.bind(ctypes.CDLL(os.fspath(lib)))
    return fns


def cuda_ms(fn, reps: int = 10, per: int = 10, warmup: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``per`` back-to-back
    calls, divided by ``per``: the card's time per call, the host's launch
    work hidden behind the calls before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def time_shape(arch, shape, fns):
    """The kernel, its ablations, the mma kernel and SDPA at one prefill
    shape, in turns; ms per call and TFLOP/s of the attended pairs."""
    B, S, H, KV, D, window = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, KV, D), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, KV, D), generator=g, device="cuda").bfloat16()
    qt = q.transpose(1, 2).contiguous()
    kw = dict(causal=True, window=window, logit_softcap=0.0)
    if window:
        kt, vt = (x.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
                  for x in (k, v))
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)
    else:
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
    runs = {
        "wgmma": lambda: fak.flash_attention(q, k, v, variant="wgmma", **kw),
        **{name: (lambda fn=fn: fak.launch(fn, q, k, v, "wgmma", **kw))
           for name, fn in fns.items()},
        "mma": lambda: fak.flash_attention(q, k, v, variant="mma", **kw),
        "sdpa": sdpa,
    }
    turns = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        turns[name].append(cuda_ms(runs[name]))
    pos = torch.arange(S)
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    flops = 4 * D * int(keep.sum()) * B * H
    ms = {name: statistics.mean(t) for name, t in turns.items()}
    return {"arch": arch,
            "shape": {"q": [B, S, H, D], "kv": [B, S, KV, D],
                      "causal": True, "window": window},
            "ms": ms, "turns_ms": turns,
            "tflops": {n: flops / t / 1e9 for n, t in ms.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    fak._kernel()
    fns = build_ablations()
    print(card)
    for arch, shape in SHAPES.items():
        print(json.dumps(time_shape(arch, shape, fns)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
