"""Optimizers, the learning-rate schedule and gradient clipping, in PyTorch.

A copy of the reference package's ``repro.optim``:

* AdamW: float32 moments, decoupled weight decay on tensors of two or more
  dimensions.
* Adafactor-lite: a factored second moment for tensors of two or more
  dimensions, no first moment, the update's RMS clipped to 1.
* the cosine schedule with linear warm-up, in float32 as the reference's
  ``jnp`` computes it.
* global-norm clipping.
* error-feedback int8 compression (``ef_compress``/``ef_decompress``)
  and ``compressed_psum``, its all-reduce over a process group (the
  reference's over a mesh axis, for "pod"); as in the reference, nothing
  on the train step calls it.
* ``state_specs``: each optimizer's state laid out as the parameters'
  specs say (Adafactor's row and column factors drop a dimension).

Parameters, gradients and moments are mappings from a name to a tensor
(``dict(model.named_parameters())`` for a model).  Unlike the reference's
pure functions, :meth:`AdamW.update` and :meth:`Adafactor.update` write the
parameters and the moments in place, one tensor at a time, so that the
float32 temporaries of one tensor are all they add to the card's memory;
they return the same parameter mapping and a state with the step advanced.
On a mesh the parameters and moments are DTensors: the update runs on
each rank's local shards (AdamW is elementwise; Adafactor's row and column
means and the update's RMS sum over the mesh axes that split those
dimensions), and the clipping norm sums every rank's squares once.

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

from repro_torch import distributed as D

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


def _local(t):
    return t.to_local() if D.is_dtensor(t) else t


def _sq(g, p) -> torch.Tensor:
    """This rank's share of ``sum(g ** 2)``: its shard's, divided by the
    number of ranks holding the same elements."""
    sq = torch.sum(torch.square(_local(g).to(torch.float32)))
    n = D.replicas(p if p is not None else g)
    return sq / n if n > 1 else sq


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float,
                        params: Tensors = None
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient in place by ``min(1, max_norm / norm)``, the
    norm taken over float32 squares of all of them; each keeps its dtype
    (the product is rounded back to it, as the reference's cast).
    Returns ``(grads, norm)``, the norm a float32 0-dim tensor.  A
    gradient may be a DTensor, or a rank's local shard of the DTensor
    parameter of the same name in ``params``: the squares are then
    summed over the mesh."""
    params = params or {}
    total = sum(_sq(g, params.get(k)) for k, g in grads.items())
    mesh = next((p.device_mesh for p in list(params.values()) +
                 list(grads.values()) if D.is_dtensor(p)), None)
    if mesh is not None and mesh.size() > 1:
        total = D._all_reduce(total, mesh, tuple(range(mesh.ndim)))
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g = _local(g)
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
            if D.is_dtensor(p):
                return torch.zeros_like(p.detach(), dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(0, {k: f32(p) for k, p in params.items()},
                          {k: f32(p) for k, p in params.items()})

    def state_specs(self, param_specs):
        """(step, m, v) laid out as the parameters."""
        return AdamWState((), dict(param_specs), dict(param_specs))

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors):
        step = state.step + 1
        lr = _lr(self.lr, step)
        b1, b2 = self.b1, self.b2
        bc1, bc2 = _bias_correction(b1, step), _bias_correction(b2, step)
        for name, p0 in params.items():
            p = _local(p0)
            g = _local(grads[name]).to(torch.float32, copy=True)
            m, v = _local(state.m[name]), _local(state.v[name])
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
        def zeros(shape, p, pl):
            if D.is_dtensor(p):
                return _dzeros(shape, p, pl(p.placements, p.ndim))
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        vr = {k: zeros(p.shape[:-1] if p.ndim >= 2 else p.shape, p,
                       _vr_placements) for k, p in params.items()}
        vc = {k: zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,),
                       p, _vc_placements) for k, p in params.items()}
        return AdafactorState(0, vr, vc)

    def state_specs(self, param_specs):
        """(step, vr, vc): a matrix's row factors drop its last dimension,
        its column factors the one before; a vector's vr is laid out as
        it, its (1,) vc replicated."""
        def vr_spec(s):
            return tuple(s)[:-1] if len(s) >= 2 else s

        def vc_spec(s):
            return tuple(s)[:-2] + tuple(s)[-1:] if len(s) >= 2 else (None,)
        return AdafactorState(
            (), {k: vr_spec(s) for k, s in param_specs.items()},
            {k: vc_spec(s) for k, s in param_specs.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdafactorState, params: Tensors):
        step = state.step + 1
        lr = _lr(self.lr, step)
        d, eps = self.decay, self.eps
        for name, p0 in params.items():
            p = _local(p0)
            g = _local(grads[name]).to(torch.float32)
            g2 = torch.mul(g, g).add_(eps)
            vr = _local(state.vr[name])
            if p.ndim >= 2:
                vc = _local(state.vc[name])
                vr.mul_(d).add_(_mean(g2, p0, -1), alpha=1 - d)
                vc.mul_(d).add_(_mean(g2, p0, -2), alpha=1 - d)
                row_mean = torch.clamp(_mean(vr, p0, -1, p0.ndim - 2),
                                       min=eps)
                pre = torch.mul(vr[..., None], vc[..., None, :], out=g2)
                pre.div_(row_mean[..., None, None])
            else:
                vr.mul_(d).add_(g2, alpha=1 - d)
                pre = vr.clone()
                del g2
            pre.clamp_(min=eps).rsqrt_().mul_(g)
            del g
            # update clipping (RMS <= 1)
            rms = torch.sqrt(_mean_all(pre * pre, p0) + 1e-12)
            pre.div_(torch.clamp(rms, min=1.0))
            new = p.to(torch.float32, copy=True).sub_(pre, alpha=lr)
            if self.weight_decay and p.ndim >= 2:
                new.sub_(p.to(torch.float32), alpha=lr * self.weight_decay)
            p.copy_(new)
        return params, AdafactorState(step, state.vr, state.vc)


def _vr_placements(pl, ndim):
    """A DTensor's row factors' placements: its last dimension gone."""
    from torch.distributed.tensor import Replicate, Shard
    if ndim < 2:
        return tuple(pl)
    return tuple(Replicate() if isinstance(x, Shard) and x.dim == ndim - 1
                 else x for x in pl)


def _vc_placements(pl, ndim):
    """Its column factors': the dimension before the last gone."""
    from torch.distributed.tensor import Replicate, Shard
    if ndim < 2:
        return tuple(Replicate() for _ in pl)
    out = []
    for x in pl:
        if isinstance(x, Shard) and x.dim == ndim - 2:
            out.append(Replicate())
        elif isinstance(x, Shard) and x.dim == ndim - 1:
            out.append(Shard(ndim - 2))
        else:
            out.append(x)
    return tuple(out)


def _dzeros(shape, p, pl):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = torch.Size(shape)
    local, _ = compute_local_shape_and_global_offset(shape, p.device_mesh,
                                                     pl, skip_offset=True)
    return DTensor.from_local(
        torch.zeros(local, dtype=torch.float32, device=_local(p).device),
        p.device_mesh, pl, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _mean(x, p0, dim: int, xdim: int = None):
    """``x.mean(dim)`` where ``x`` is a local shard laid out as parameter
    ``p0`` (``xdim``: the dimension of ``p0`` that ``x``'s ``dim`` is):
    over the mesh axes that split it, a sum divided by its global size."""
    pdim = dim % p0.ndim if xdim is None else xdim
    dims = D.sharded_dims(p0, pdim)
    if not dims:
        return x.mean(dim=dim)
    s = D.sum_over(x.sum(dim=dim), p0, dims)
    return s / p0.shape[pdim]


def _mean_all(x, p0):
    dims = tuple({i for d in range(p0.ndim)
                  for i in D.sharded_dims(p0, d)})
    if not dims:
        return torch.mean(x)
    return D.sum_over(x.sum(), p0, dims) / p0.numel()


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


def compressed_psum(g: torch.Tensor, residual: torch.Tensor, group=None):
    """EF-int8 all-reduce over ``group`` (a process group, or a ``(mesh,
    dim)`` pair; the reference's ``axis_name``, used for the pod axis):
    the int8 payloads summed in int32, the MAX of the scales, divided by
    the group's size.  Returns ``(mean gradient, new residual)``."""
    import torch.distributed._functional_collectives as fc
    q, scale, new_res = ef_compress(g, residual)
    q_sum = fc.all_reduce(q.to(torch.int32), "sum", group)
    scale_max = fc.all_reduce(scale, "max", group)
    n = fc.all_reduce(torch.ones((), dtype=torch.float32, device=g.device),
                      "sum", group)
    q_sum, scale_max, n = (D._wait(t) for t in (q_sum, scale_max, n))
    return q_sum.to(torch.float32) * scale_max / n, new_res


__all__ = ["AdamW", "AdamWState", "Adafactor", "AdafactorState",
           "clip_by_global_norm", "compressed_psum", "cosine_schedule",
           "ef_compress", "ef_decompress", "make_optimizer"]
