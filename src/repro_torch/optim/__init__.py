"""Optimizers, the learning-rate schedule and gradient clipping, in PyTorch.

A copy of the reference package's ``repro.optim`` for one card:

* AdamW: float32 moments, decoupled weight decay on tensors of two or more
  dimensions.
* Adafactor-lite: a factored second moment for tensors of two or more
  dimensions, no first moment, the update's RMS clipped to 1.
* the cosine schedule with linear warm-up, in float32 as the reference's
  ``jnp`` computes it.
* global-norm clipping.
* error-feedback int8 compression (``ef_compress``/``ef_decompress``).
  ``compressed_psum``, its all-reduce across pods, needs more than one card
  and is not ported (ROADMAP).

Parameters, gradients and moments are mappings from a name to a tensor
(``dict(model.named_parameters())`` for a model).  Unlike the reference's
pure functions, :meth:`AdamW.update` and :meth:`Adafactor.update` write the
parameters and the moments in place, one tensor at a time, so that the
float32 temporaries of one tensor are all they add to the card's memory;
they return the same parameter mapping and a state with the step advanced.

The reference stacks the layers of a pattern period into one leaf, so its
per-layer norm vectors are 2-D there and 1-D here: its AdamW decays them
and its Adafactor factors them across layers, where the port's, going by
the dimensions of its own tensors, does neither (ROADMAP queue 3 b).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

Tensors = Mapping[str, torch.Tensor]

# ---------------------------------------------------------------------------
# schedule and clipping
# ---------------------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], float]:
    """``lr(step)``: linear warm-up to ``base_lr`` over ``warmup`` steps,
    then a cosine down to ``min_frac * base_lr`` at ``total``.  Computed
    in float32 (numpy scalars), returned as a Python float."""
    f32 = np.float32
    base, mf, rest = f32(base_lr), f32(min_frac), f32(1 - min_frac)
    w, span = f32(max(warmup, 1)), f32(max(total - warmup, 1))

    def lr(step) -> float:
        s = f32(step)
        if s < f32(warmup):
            return float(base * min(s / w, f32(1.0)))
        prog = min(max((s - f32(warmup)) / span, f32(0.0)), f32(1.0))
        cos = mf + rest * f32(0.5) * (f32(1) + np.cos(
            f32(np.pi) * prog, dtype=np.float32))
        return float(base * cos)
    return lr


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient in place by ``min(1, max_norm / norm)``, the
    norm taken over float32 squares of all of them; each keeps its dtype
    (the product is rounded back to it, as the reference's cast).
    Returns ``(grads, norm)``, the norm a float32 0-dim tensor."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:   # the product in float32, then rounded once
            g.copy_(g.to(torch.float32).mul_(scale))
    return grads, gn


def _lr(lr, step: int) -> float:
    return lr(step) if callable(lr) else float(np.float32(lr))


def _bias_correction(beta: float, step: int) -> float:
    """``1 - beta ** step`` in float32."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(step))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Tensors) -> AdamWState:
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(0, {k: f32(p) for k, p in params.items()},
                          {k: f32(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors):
        step = state.step + 1
        lr = _lr(self.lr, step)
        b1, b2 = self.b1, self.b2
        bc1, bc2 = _bias_correction(b1, step), _bias_correction(b2, step)
        for name, p in params.items():
            g = grads[name].to(torch.float32, copy=True)
            m, v = state.m[name], state.v[name]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = torch.div(v, bc2, out=g).sqrt_().add_(self.eps)
            delta = torch.div(m, bc1).div_(denom)
            del g, denom
            p32 = p.to(torch.float32, copy=True)
            if p.ndim >= 2:   # decay matrices only
                delta.add_(p32, alpha=self.weight_decay)
            p.copy_(p32.sub_(delta, alpha=lr))
        return params, AdamWState(step, state.m, state.v)


# ---------------------------------------------------------------------------
# Adafactor-lite (factored second moment, momentum-free)
# ---------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    step: int
    vr: Dict[str, torch.Tensor]   # row factors (or the full v below 2-D)
    vc: Dict[str, torch.Tensor]   # column factors (a (1,) placeholder)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable | float = 1e-3
    decay: float = 0.99
    eps: float = 1e-30
    weight_decay: float = 0.0

    def init(self, params: Tensors) -> AdafactorState:
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        vr = {k: zeros(p.shape[:-1] if p.ndim >= 2 else p.shape, p)
              for k, p in params.items()}
        vc = {k: zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,),
                       p) for k, p in params.items()}
        return AdafactorState(0, vr, vc)

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdafactorState, params: Tensors):
        step = state.step + 1
        lr = _lr(self.lr, step)
        d, eps = self.decay, self.eps
        for name, p in params.items():
            g = grads[name].to(torch.float32)
            g2 = torch.mul(g, g).add_(eps)
            vr = state.vr[name]
            if p.ndim >= 2:
                vc = state.vc[name]
                vr.mul_(d).add_(g2.mean(dim=-1), alpha=1 - d)
                vc.mul_(d).add_(g2.mean(dim=-2), alpha=1 - d)
                row_mean = torch.clamp(vr.mean(dim=-1), min=eps)
                pre = torch.mul(vr[..., None], vc[..., None, :], out=g2)
                pre.div_(row_mean[..., None, None])
            else:
                vr.mul_(d).add_(g2, alpha=1 - d)
                pre = vr.clone()
                del g2
            pre.clamp_(min=eps).rsqrt_().mul_(g)
            del g
            # update clipping (RMS <= 1)
            rms = torch.sqrt(torch.mean(pre * pre) + 1e-12)
            pre.div_(torch.clamp(rms, min=1.0))
            new = p.to(torch.float32, copy=True).sub_(pre, alpha=lr)
            if self.weight_decay and p.ndim >= 2:
                new.sub_(p.to(torch.float32), alpha=lr * self.weight_decay)
            p.copy_(new)
        return params, AdafactorState(step, state.vr, state.vc)


def make_optimizer(name: str, lr_schedule=None, **kw):
    lr = lr_schedule if lr_schedule is not None else 3e-4
    if name == "adamw":
        return AdamW(lr=lr, **kw)
    if name == "adafactor":
        return Adafactor(lr=lr, **kw)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# error-feedback int8 gradient compression
# ---------------------------------------------------------------------------


def ef_compress(g: torch.Tensor, residual: torch.Tensor):
    """Returns ``(int8 payload, scale, new residual)``; a multi-card caller
    all-reduces the payload, then calls :func:`ef_decompress`."""
    x = g.to(torch.float32) + residual
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_residual = x - q.to(torch.float32) * scale
    return q, scale, new_residual


def ef_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


__all__ = ["AdamW", "AdamWState", "Adafactor", "AdafactorState",
           "clip_by_global_norm", "cosine_schedule", "ef_compress",
           "ef_decompress", "make_optimizer"]
