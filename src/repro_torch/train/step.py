"""The train step: gradient accumulation over microbatches, global-norm
clipping and the optimizer update, in PyTorch.

A port of the reference package's ``repro.train.step``.  The reference's
step is a pure function of ``(state, batch)`` under ``jit``; here it runs
eagerly, takes the gradient with autograd and updates the parameters and
the optimizer's moments in place (``optim``), returning the same state
objects with the step advanced.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import clip_by_global_norm


class TrainState(NamedTuple):
    params: T.Model
    opt_state: Any
    step: int


def auto_microbatches(cfg: ModelConfig, global_batch: int, seq: int,
                      dp: int = 1) -> int:
    """Pick a microbatch count: bound per-microbatch tokens to ~128k while
    keeping micro_batch divisible by dp (1 on one card)."""
    if cfg.microbatch:
        return cfg.microbatch
    target_tokens = 131072
    n = max(1, (global_batch * seq) // target_tokens)
    # n must divide global_batch and keep global_batch//n divisible by dp
    while n > 1 and (global_batch % n or (global_batch // n) % dp):
        n -= 1
    return max(1, n)


def make_state(key, cfg: ModelConfig, optimizer, device="cuda") -> TrainState:
    """Random weights (``T.init``) with gradients on, and the optimizer's
    initial state, on ``device``."""
    params = T.init(key, cfg, device=device).requires_grad_(True)
    return TrainState(params, optimizer.init(dict(params.named_parameters())),
                      0)


def to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``SyntheticLM.batch_at``) as tensors on ``device``:
    tokens and labels int64, ``extra`` as it is."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.to(torch.int64) if k in ("tokens", "labels") else t
                  ).to(device)
    return out


def build_train_step(cfg: ModelConfig, optimizer, n_micro: int = 1,
                     max_grad_norm: float = 1.0,
                     use_flash: bool = True) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``{"tokens": (B, S), "labels": (B, S)}`` tensors on the
    parameters' device.  With ``n_micro == 1`` the gradients keep the
    parameters' dtype, as ``jax.value_and_grad`` leaves them; with more,
    each microbatch's gradients are added into float32 buffers, which are
    divided by ``n_micro``, as the reference's scan does.  Then the step
    clips, updates, and returns ``{"loss", "grad_norm", "step"}`` (0-dim
    float32 tensors and an int).  ``use_flash=True`` reaches the flash
    kernel for ``S >= 512``, which on a card has no gradient and raises."""

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model = state.params
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        B = batch["tokens"].shape[0]
        if n_micro == 1:
            loss = T.loss_fn(model, cfg, batch, use_flash=use_flash)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
            loss = loss.detach()
        else:
            mb = B // n_micro
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = 0.0
            for i in range(n_micro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                micro = T.loss_fn(model, cfg, part, use_flash=use_flash)
                micro.backward()
                with torch.no_grad():
                    for k, p in params.items():
                        grads[k].add_(p.grad.to(torch.float32))
                        p.grad = None
                loss = loss + micro.detach()
            for g in grads.values():
                g.div_(n_micro)
            loss = loss / n_micro
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        _, opt_state = optimizer.update(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None
        del grads
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "step": state.step + 1}
        return TrainState(model, opt_state, state.step + 1), metrics

    return train_step
