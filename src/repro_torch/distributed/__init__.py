"""Mesh-axis conventions, sharding specs and the sharded compute's
collectives, over a ``torch.distributed.device_mesh.DeviceMesh``.

A port of the reference package's ``repro.distributed``.  Physical mesh
axes:

  single pod:  ("data", "model")           = (16, 16)
  multi-pod:   ("pod", "data", "model")    = (2, 16, 16)

Logical convention used by every layer's specs:

  "data"  -- DP/FSDP: batch + parameter sharding (ZeRO-3 style: a layer's
            weights are all-gathered over "data" where the layer runs and
            their gradients reduce-scattered back)
  "model" -- TP/EP: attention heads, MLP hidden, expert and vocab dims
  "pod"   -- outer data parallelism: batch is additionally split across
            pods; parameters are replicated per pod, so gradients
            all-reduce over it (optionally EF-int8-compressed, see
            ``optim.compressed_psum``)

Params never mention "pod": unlisted mesh axes replicate, which is exactly
the per-pod replica layout.  Batches shard over ("pod", "data") jointly.

A spec is a plain tuple with one entry per tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (sharded over their
product, the first the slowest), as a ``PartitionSpec`` is in the
reference.  :func:`placements` turns it into DTensor placements and
:func:`distribute_model` makes every parameter a DTensor so.

The sharded forward computes on local tensors with explicit collectives
(:class:`ShardCtx`): each layer gathers its weights over the data axes as
it runs (:meth:`ShardCtx.weight`), splits heads, MLP hidden, experts and
the vocabulary over "model" where they divide (Megatron's column- and
row-parallel products, :meth:`ShardCtx.enter` and :meth:`ShardCtx.exit`),
and each data-parallel rank runs its own rows of the batch.  Each rank's
loss is its share of the global mean, so gradients are sums over the data
axes and equal over "model".  On a mesh of one rank every collective is
skipped and the computation is the unsharded one.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

DP_AXES_SINGLE = ("data",)
DP_AXES_MULTI = ("pod", "data")


# ---------------------------------------------------------------------------
# the reference's helpers
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def dp_axes(mesh) -> Tuple[str, ...]:
    return DP_AXES_MULTI if "pod" in axis_names(mesh) else DP_AXES_SINGLE


def batch_spec(mesh, extra_dims: int = 1) -> Spec:
    axes = dp_axes(mesh)    # one axis is named bare, as a PartitionSpec
    return (axes[0] if len(axes) == 1 else axes,) + (None,) * extra_dims


def dp_size(mesh) -> int:
    n = axis_size(mesh, "data")
    if "pod" in axis_names(mesh):
        n *= axis_size(mesh, "pod")
    return n


def tp_size(mesh) -> int:
    return axis_size(mesh, "model")


def validate_divisibility(cfg, shape, mesh) -> Optional[str]:
    """Explain-early check: does this (arch x shape x mesh) cell divide?"""
    dp = dp_size(mesh)
    if shape.global_batch % dp and shape.global_batch >= dp:
        return f"global_batch {shape.global_batch} % dp {dp} != 0"
    return None


def widen_dp(spec: Spec, mesh) -> Spec:
    """Activation and cache specs name only "data"; on the multi-pod mesh
    the batch dimension also spans "pod" (the reference dry-run's
    ``widen_dp``)."""
    if "pod" not in axis_names(mesh):
        return spec
    return tuple(DP_AXES_MULTI if a == "data" else a for a in spec)


def _axes(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that tensor dimension ``d`` names, ``Replicate()`` on
    the others.  A dimension sharded over several axes is split over the
    first, then each part over the next, as a ``PartitionSpec`` is."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in names:
                continue   # an axis this mesh lacks replicates
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """The largest shard of a ``shape`` tensor under ``spec`` on a mesh of
    ``mesh_shape`` (axis -> size): the spec's arithmetic, with no mesh."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            n = mesh_shape.get(a, 1)
            out[d] = -(-out[d] // n)
    return tuple(out)


_DTENSOR = []


def _dtensor():
    if not _DTENSOR:   # imported at the first call, kept for the next
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def is_dtensor(t) -> bool:
    return isinstance(t, _dtensor())


def local(t):
    """A DTensor's local shard; any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def local_bytes(t) -> int:
    """Bytes this rank holds of ``t`` (a DTensor's local shard)."""
    if is_dtensor(t):
        t = t.to_local()
    return t.numel() * t.element_size()


def _set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part) if not part.isdigit() \
            else module[int(part)]
    old = getattr(module, leaf) if not isinstance(module, nn.ParameterDict) \
        else module[leaf]
    p = nn.Parameter(value, requires_grad=old.requires_grad)
    if isinstance(module, nn.ParameterDict):
        module[leaf] = p
    else:
        setattr(module, leaf, p)


def distribute_model(model: nn.Module, specs: Dict[str, Spec], mesh,
                     src_data_rank: Optional[int] = None) -> nn.Module:
    """Replace every ``nn.Parameter`` of ``model`` by a DTensor parameter
    sharded by ``specs[name]`` on ``mesh``, and attach the mesh's
    :class:`ShardCtx` to the model and its blocks.  Every rank holds the
    same full weights (the same seed), so by default each keeps its shard
    with no communication (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        dt = distribute_tensor(p.detach(), mesh, placements(specs[name], mesh),
                               src_data_rank=src_data_rank)
        _set_param(model, name, dt)
    attach(model, ShardCtx(mesh))
    return model


def attach(model: nn.Module, ctx: Optional["ShardCtx"]) -> None:
    """Set ``shard`` on the model and each block it holds."""
    model.shard = ctx
    for m in model.modules():
        if hasattr(m, "kind"):
            m.shard = ctx


def abstract_params(cfg, mesh, specs: Optional[Dict[str, Spec]] = None):
    """The model on the ``meta`` device with its parameters DTensors on
    ``mesh`` (shapes, dtypes and placements; nothing allocated)."""
    from repro_torch.models import transformer as T
    model = T.shape_init(cfg)
    specs = specs if specs is not None else T.param_specs(cfg)
    for name, p in list(model.named_parameters()):
        _set_param(model, name, zeros_like_spec(p, specs[name], mesh, "meta"))
    attach(model, ShardCtx(mesh))
    return model


def cache_spec(spec: Spec, mesh, split_batch: bool = True) -> Spec:
    """A cache leaf's spec on ``mesh``: "data" widened to the data axes,
    or dropped where the batch does not divide over them."""
    if not split_batch:
        return tuple(None if a == "data" else a for a in spec)
    return widen_dp(spec, mesh)


def zeros_like_spec(t: torch.Tensor, spec: Spec, mesh, device):
    """A DTensor of zeros with ``t``'s global shape and dtype, laid out by
    ``spec``: only this rank's shard is allocated."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = placements(spec, mesh)
    shp, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl,
                                                 skip_offset=True)
    local = torch.zeros(shp, dtype=t.dtype, device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


# ---------------------------------------------------------------------------
# collectives with the sharded forward's gradient rules
# ---------------------------------------------------------------------------

def _fc():
    import torch.distributed._functional_collectives as fc
    return fc


def _wait(t):
    fc = _fc()
    return t.wait() if isinstance(t, fc.AsyncCollectiveTensor) else t


def _all_reduce(x, mesh, dims, op="sum"):
    for d in dims:
        if mesh.size(d) > 1:
            x = _wait(_fc().all_reduce(x.contiguous(), op, (mesh, d)))
    return x


def _all_gather(x, dim, mesh, dims):
    # inner dims first, so the result is ordered major-to-minor as the
    # axes are listed (("pod", "data"): pod-major).  The gathered
    # dimension is moved to the front: the ranks' parts then concatenate
    # along it as they arrive
    for d in reversed(list(dims)):
        if mesh.size(d) > 1:
            xm = x.movedim(dim, 0).contiguous()
            x = _wait(_fc().all_gather_tensor(xm, 0, (mesh, d))).movedim(
                0, dim)
    return x


def _reduce_scatter(x, dim, mesh, dims):
    for d in dims:
        if mesh.size(d) > 1:
            xm = x.movedim(dim, 0).contiguous()
            x = _wait(_fc().reduce_scatter_tensor(xm, "sum", 0,
                                                  (mesh, d))).movedim(0, dim)
    return x


def _slice(x, dim, mesh, dims):
    for d in dims:
        n = mesh.size(d)
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} "
                                 f"does not divide over {n} ranks")
            r = mesh.get_local_rank(d)
            x = x.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n)
    return x


class _Sum(torch.autograd.Function):
    """All-reduce (sum) forward; backward all-reduces too when the
    gradients downstream are per-rank parts (``partial``), else passes
    them (they are equal on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, dims, partial):
        ctx.args = (mesh, dims, partial)
        return _all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        mesh, dims, partial = ctx.args
        return (_all_reduce(g, mesh, dims) if partial else g), None, None, \
            None


class _Enter(torch.autograd.Function):
    """Identity forward; all-reduce backward (the input of a
    column-parallel product: each rank's gradient is a part)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.args = (mesh, dims)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, dims = ctx.args
        return _all_reduce(g, mesh, dims), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward reduce-scatters the
    gradient (``partial``) or takes this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dim, mesh, dims, partial):
        ctx.args = (dim, mesh, dims, partial)
        return _all_gather(x, dim, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, dims, partial = ctx.args
        g = _reduce_scatter(g, dim, mesh, dims) if partial else \
            _slice(g, dim, mesh, dims)
        return g, None, None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, mesh, dims):
        ctx.args = (dim, mesh, dims)
        return _reduce_scatter(x, dim, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, dims = ctx.args
        return _all_gather(g, dim, mesh, dims), None, None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` forward; all-gather backward (out
    of a replicated computation into a sequence-parallel stream)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, dims):
        ctx.args = (dim, mesh, dims)
        return _slice(x, dim, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, dims = ctx.args
        return _all_gather(g, dim, mesh, dims), None, None, None


class ShardCtx:
    """The mesh as the sharded forward sees it: the data-parallel mesh
    dimensions (``dp_dims``, pod first) and the tensor-parallel one
    (``tp_dim``), their sizes and this rank's place in them.  Without a
    mesh (``ShardCtx()``, a model that is not distributed) it is one rank:
    every weight is the parameter itself and every collective the
    identity."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.dp_dims = self.tp_dims = ()
            self.tp_dim = None
            self.tp = self.dp = 1
            self.tp_rank = self.dp_rank = 0
            return
        names = axis_names(mesh)
        self.dp_dims = tuple(names.index(a) for a in dp_axes(mesh)
                             if a in names)
        self.tp_dim = names.index("model") if "model" in names else None
        self.tp = mesh.size(self.tp_dim) if self.tp_dim is not None else 1
        self.tp_rank = mesh.get_local_rank(self.tp_dim) \
            if self.tp > 1 else 0
        self.dp = math.prod(mesh.size(d) for d in self.dp_dims)
        rank = 0
        for d in self.dp_dims:
            rank = rank * mesh.size(d) + (mesh.get_local_rank(d)
                                          if mesh.size(d) > 1 else 0)
        self.dp_rank = rank
        self.tp_dims = () if self.tp_dim is None else (self.tp_dim,)

    # -- weights -----------------------------------------------------------
    def weight(self, p, tp_dim: Optional[int] = None,
               grad: str = "replicated") -> torch.Tensor:
        """The local tensor a layer computes with: ``p`` gathered over
        every mesh axis but "model", and over "model" too unless
        ``tp_dim`` names the dimension "model" splits (which must be the
        one its spec shards).  ``grad`` says what the gradient of a
        weight gathered over "model" is on each rank: ``"replicated"``
        (a replicated computation: every rank has all of it) or
        ``"partial"`` (used inside a tensor-parallel part: each rank has a
        share, summed on the way back)."""
        if self.mesh is None or not is_dtensor(p):
            return p
        from torch.distributed.tensor import Partial, Replicate, Shard
        if self.mesh.size() == 1:   # nothing to gather: the shard is all
            return p.to_local()
        comp, grads = [], []
        for i in range(self.mesh.ndim):
            if i == self.tp_dim and tp_dim is not None and self.tp > 1:
                comp.append(Shard(tp_dim))
                grads.append(Shard(tp_dim))
            elif i == self.tp_dim:
                comp.append(Replicate())
                grads.append(Partial() if grad == "partial"
                             else Replicate())
            else:
                comp.append(Replicate())
                grads.append(Partial())
        return p.redistribute(self.mesh, comp).to_local(
            grad_placements=grads)

    def weights(self, params, tp: Dict[str, Optional[int]] = None,
                grad: str = "replicated") -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            return params
        tp = tp or {}
        return {k: self.weight(v, tp.get(k), grad) for k, v in params.items()}

    # -- activations over "model" --------------------------------------------
    def enter(self, x, sp: bool = False):
        """Into a tensor-parallel part (identity; gradients summed).
        ``sp``: ``x`` is this rank's slice of the sequence (dim 1), which
        is gathered (gradients reduce-scattered)."""
        if self.tp == 1:
            return x
        if sp:
            return _Gather.apply(x, 1, self.mesh, self.tp_dims, True)
        return _Enter.apply(x, self.mesh, self.tp_dims)

    def exit(self, x, sp: bool = False):
        """Out of a row-parallel product: the ranks' parts summed (``sp``:
        reduce-scattered over the sequence)."""
        if self.tp == 1:
            return x
        if sp:
            return _Scatter.apply(x, 1, self.mesh, self.tp_dims)
        return _Sum.apply(x, self.mesh, self.tp_dims, False)

    def rep_in(self, x, sp: bool):
        """Into a computation replicated over "model": a sequence-parallel
        stream is gathered (its gradient, equal on every rank, sliced)."""
        if self.tp == 1 or not sp:
            return x
        return _Gather.apply(x, 1, self.mesh, self.tp_dims, False)

    def rep_out(self, x, sp: bool):
        """Out of it: this rank's slice of the sequence."""
        if self.tp == 1 or not sp:
            return x
        return _Split.apply(x, 1, self.mesh, self.tp_dims)

    def sp_ok(self, x) -> bool:
        """Whether ``ACTIVATION_SPEC`` splits this (B, S, D) stream's
        sequence over "model" here (as the reference's ``_constrain``: 3
        dimensions and S > 1; and S dividing over the ranks)."""
        from repro_torch.models import transformer as T
        spec = T.ACTIVATION_SPEC
        return spec is not None and len(spec) > 1 and spec[1] == "model" \
            and self.tp > 1 and x.ndim == 3 and x.shape[1] > 1 \
            and x.shape[1] % self.tp == 0

    def tp_gather(self, x, dim: int, partial: bool):
        if self.tp == 1:
            return x
        return _Gather.apply(x, dim, self.mesh, self.tp_dims, partial)

    def tp_max(self, x):
        """Max over "model" (no gradient: a stabiliser)."""
        if self.tp == 1:
            return x
        return _all_reduce(x.detach(), self.mesh, self.tp_dims, "max")

    def tp_sum_nograd(self, x):
        if self.tp == 1:
            return x
        return _all_reduce(x, self.mesh, self.tp_dims)

    # -- activations over the data axes ---------------------------------------
    def dp_sum(self, x):
        """Sum over the data axes; each rank's gradient is its loss's
        part, so the backward sums too."""
        if self.dp == 1:
            return x
        return _Sum.apply(x, self.mesh, self.dp_dims, True)

    def dp_sum_nograd(self, x):
        if self.dp == 1:
            return x
        return _all_reduce(x, self.mesh, self.dp_dims)

    def dp_gather(self, x, dim: int = 0):
        """All-gather over the data axes in global batch order (no
        gradient)."""
        if self.dp == 1:
            return x
        return _all_gather(x, dim, self.mesh, self.dp_dims)

    def dp_gather_grad(self, x, dim: int):
        if self.dp == 1:
            return x
        return _Gather.apply(x, dim, self.mesh, self.dp_dims, True)

    def dp_scatter(self, x, dim: int):
        if self.dp == 1:
            return x
        return _Scatter.apply(x, dim, self.mesh, self.dp_dims)

    def batch_rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.dp:
            raise ValueError(f"global batch {n} does not divide over "
                             f"{self.dp} data-parallel ranks")
        b = n // self.dp
        return slice(self.dp_rank * b, (self.dp_rank + 1) * b)


def ctx_of(model) -> Optional[ShardCtx]:
    """The mesh's context of a distributed model, None for any other."""
    return getattr(model, "shard", None)


#: the context of a model that is not distributed
LOCAL = ShardCtx()


def shard_ctx(model) -> ShardCtx:
    """The context a model or block computes in: its mesh's, or
    :data:`LOCAL`."""
    ctx = getattr(model, "shard", None)
    return LOCAL if ctx is None else ctx


def global_offset(t, dim: int) -> int:
    """Where DTensor ``t``'s local shard starts along ``dim`` (0 for a
    plain tensor): DTensor's chunks, ``ceil(n / k)`` rows each and the
    last ones shorter or empty, split over each mesh dimension in turn."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(t):
        return 0
    dim %= t.ndim
    size, off = t.shape[dim], 0
    for i, pl in enumerate(t.placements):
        n = t.device_mesh.size(i)
        if isinstance(pl, Shard) and pl.dim == dim and n > 1:
            chunk = -(-size // n)
            start = min(t.device_mesh.get_local_rank(i) * chunk, size)
            off += start
            size = min(chunk, size - start)
    return off


def replicas(p) -> int:
    """How many ranks hold each element of DTensor ``p`` (1 for a plain
    tensor)."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(p):
        return 1
    return math.prod(p.device_mesh.size(i)
                     for i, pl in enumerate(p.placements)
                     if isinstance(pl, Replicate))


def sharded_dims(p, dim: int) -> Tuple[int, ...]:
    """The mesh dimensions that split tensor dimension ``dim`` of ``p``."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(p):
        return ()
    dim = dim % p.ndim
    return tuple(i for i, pl in enumerate(p.placements)
                 if isinstance(pl, Shard) and pl.dim == dim
                 and p.device_mesh.size(i) > 1)


def sum_over(x: torch.Tensor, p, dims: Iterable[int]) -> torch.Tensor:
    """Sum the local ``x`` over the mesh dimensions ``dims`` of ``p``'s
    mesh (no gradient)."""
    dims = tuple(dims)
    if not dims:
        return x
    return _all_reduce(x, p.device_mesh, dims)


def init_world(device_type: str = "cuda") -> None:
    """Initialise the default process group if it is not: from torchrun's
    environment when it is set, else a world of one over
    ``tcp://localhost`` on a free port.  NCCL on the card, gloo on the
    CPU."""
    import os
    import socket
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on cuda needs a card, and torch sees "
                           "none (ask for device_type='cpu')")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
        return
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


__all__ = ["LOCAL", "Spec", "ShardCtx", "abstract_params", "attach",
           "batch_spec", "ctx_of", "distribute_model", "dp_axes", "dp_size",
           "global_offset", "init_world", "is_dtensor", "local_bytes",
           "local_shape", "placements", "replicas", "shard_ctx",
           "sharded_dims", "sum_over", "tp_size", "validate_divisibility",
           "widen_dp"]
