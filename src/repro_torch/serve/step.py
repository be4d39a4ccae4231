"""serve-side step builders.

* prefill_step: full-sequence forward, returns last-position logits (the
  full-vocab logits of a long prompt are never built).  It runs prefill
  attention through the flash kernel (``S >= 512``) and does not fill a
  decode cache, as in the reference.
* serve_step: one decode step against the KV cache (inline attention).

Both run under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def build_prefill_step(cfg: ModelConfig, use_flash: bool = True) -> Callable:
    """prefill_step(params, batch) -> (B, 1, vocab) logits of the last
    position; ``batch["tokens"]`` is (B, S)."""
    @torch.inference_mode()
    def prefill_step(params, batch):
        x, _ = T.hidden_forward(params, cfg, batch["tokens"],
                                batch.get("extra"), use_flash)
        return T.logits_from_hidden(params, cfg, x[:, -1:])
    return prefill_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, tokens (B,1), position int, cache) ->
    (next_tokens (B,1) int32, logits, cache)."""
    @torch.inference_mode()
    def serve_step(params, tokens, position, cache):
        logits, cache = T.decode_step(params, cfg, tokens, position, cache)
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)
        return nxt, logits, cache
    return serve_step
