"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Batched greedy decoding against the selected architecture with a live KV
cache, as the reference launcher does: random weights from a seed, a random
prompt, the prompt teacher-forced through decode steps one token at a time,
then ``--new-tokens`` greedy steps.  The cross-attention families
(whisper-base, llama-3.2-vision-11b) first prime their cross K/V from a
stub frontend input: numpy ``default_rng(1)`` normals times 0.02 of
``registry.extra_shape``.  The reference draws that input from
``jax.random.PRNGKey(1)``: the numbers differ, the shape and scale do not.
Runs on ``--device cuda`` unless asked for the CPU.  :func:`generate` is
the loop, for callers other than the command line.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import extra_shape
from repro_torch.serve.step import build_serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: T.Model, cfg: ModelConfig, prompt: torch.Tensor,
             new_tokens: int, keep_logits: bool = False,
             extra: Optional[torch.Tensor] = None) -> Dict:
    """Teacher-force ``prompt`` (B, P) through decode steps, then decode
    ``new_tokens`` greedily.  As in the reference launcher, the token
    chosen after the prompt is fed but not returned: ``tokens[:, t]`` is the
    argmax after step ``P + t``.  With ``extra`` (the frontend stub input
    of a cross-attention family) the cross K/V are primed from it after
    ``decode_init``; without it they stay zeros.

    Returns ``tokens`` (B, new_tokens) int32, ``prompt_logits`` (the logits
    after the last prompt token, (B, vocab)), ``logits`` ((B, new_tokens,
    vocab), with ``keep_logits``), ``prompt_s`` (the priming included) and
    ``decode_ms_per_token`` (host clock, ended by a synchronize on a
    card)."""
    B, P = prompt.shape
    device = prompt.device
    cache = T.decode_init(cfg, B, P + new_tokens + 1, device=device)
    step = build_serve_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    if extra is not None:
        with torch.inference_mode():
            cache = T.prime_cross_kv(params, cfg, cache, extra)
    for t in range(P):
        nxt, logits, cache = step(params, prompt[:, t:t + 1], t, cache)
    prompt_logits = logits[:, -1]
    _sync(device)
    t1 = time.perf_counter()
    tok, out, kept = nxt, [], []
    for t in range(new_tokens):
        tok, logits, cache = step(params, tok, P + t, cache)
        out.append(tok[:, 0])
        if keep_logits:
            kept.append(logits[:, -1])
    _sync(device)
    t2 = time.perf_counter()
    res = {"tokens": torch.stack(out, 1) if out else
           torch.zeros((B, 0), dtype=torch.int32, device=device),
           "prompt_logits": prompt_logits, "prompt_s": t1 - t0,
           "decode_ms_per_token": (t2 - t1) / max(new_tokens, 1) * 1e3}
    if keep_logits:
        res["logits"] = torch.stack(kept, 1) if kept else None
    return res


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int,
                device="cuda", seed: int = 0) -> torch.Tensor:
    """The launcher's prompt: numpy ``default_rng(seed)`` integers in
    ``[0, vocab)``, as the reference launcher draws it."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                            ).to(device)


def make_extra(cfg: ModelConfig, batch: int, device="cuda", seed: int = 1,
               scale: float = 0.02) -> Optional[torch.Tensor]:
    """The launcher's frontend stub input (None for an ``lm`` arch): numpy
    ``default_rng(seed)`` normals times ``scale``, float32, of
    ``registry.extra_shape``."""
    es = extra_shape(cfg, batch)
    if es is None:
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=es).astype(np.float32) * scale
                            ).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b",
                    help=f"one of: {', '.join(all_arch_ids())}")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    device = torch.device(args.device)
    params = T.init(0, cfg, device=device)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, device)
    extra = make_extra(cfg, args.batch, device)
    res = generate(params, cfg, prompt, args.new_tokens, extra=extra)
    res["prompt"], res["extra"] = prompt, extra
    gen = res["tokens"].cpu().numpy()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.arch}: generated {gen.shape} tokens "
          f"({res['decode_ms_per_token']:.1f} ms/token on {where}; prompt "
          f"of {args.prompt_len} in {res['prompt_s']:.2f} s)")
    for b in range(args.batch):
        print(f"  seq{b}: {gen[b][:16].tolist()}...")
    return res


if __name__ == "__main__":
    main()
