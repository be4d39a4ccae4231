"""The layers' tensor-parallel parts: local weights, explicit collectives.

``transformer`` composes every model's layers from these functions.  A
model's ``distributed.ShardCtx`` (``distributed.shard_ctx``) says where it
runs: a distributed model's (``distributed.distribute_model``: the
parameters DTensors) names its mesh, and every other model has the
trivial one (one rank: each weight is the parameter itself and every
collective the identity), so one path serves both.  Each function takes
its weights as this rank computes with them (``ShardCtx.weight``:
gathered over the data axes, and split over "model" where the layer is
tensor-parallel) and runs the plain layer code on local tensors:

* attention: heads over "model" (Megatron: Q/K/V column-parallel, the
  output row-parallel, its parts summed); where there are fewer K/V heads
  than ranks, each rank takes the one K/V head its query heads read.
  Where the heads do not divide (whisper-base's 8 or recurrentgemma-2b's
  10 over 16) the layer runs replicated over "model";
* MLP: the hidden dimension over "model"; MoE: the experts
  (``layers.moe_apply(shard=...)``); RG-LRU: the recurrence's channels,
  its gates' products reading all channels (a gather over "model");
  mLSTM and sLSTM run replicated (4 heads do not divide 16 ways, and the
  sLSTM loop needs all of h at every step);
* under ``transformer.ACTIVATION_SPEC`` splitting the sequence over
  "model" (sequence parallelism, ``sp``): the residual stream between the
  sub-layers is each rank's slice of the sequence; a tensor-parallel part
  gathers it on entry and reduce-scatters its output (in place of the
  all-reduce), a replicated one gathers and slices, and the norms'
  gradients are per-rank parts;
* decode: the projections replicated, the KV cache's sequence over
  "model" (``layers.kv_cache_specs``), each rank's partial softmax terms
  combined by ``layers.attn_apply(..., seq_split=)`` (distributed
  flash-decode); recurrent states are gathered over "model" and split
  again.

DTensor's own sharding rules are not used for these: they have none for
the embedding's gather on a vocab-sharded table with batch-sharded tokens
(an ``IndexError``), MoE's stable sort and ``index_copy`` dispatch, the
log-depth scan's strided slices or the sLSTM loop, so every layer computes
on local shards with explicit collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import distributed as D
from . import layers as L


def norm(sh, n, sp: bool = False):
    """A norm's weights; on a sequence-parallel stream each rank's
    gradient is its slice's part."""
    if sh.mesh is None:
        return n
    grad = "partial" if sp else "replicated"
    if isinstance(n, torch.Tensor):
        return sh.weight(n, None, grad)
    return {k: sh.weight(v, None, grad) for k, v in n.items()}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_plan(acfg: L.AttnCfg, sh) -> Optional[Tuple[L.AttnCfg,
                                                     Optional[int]]]:
    """(the rank's attention config, the K/V head it takes or None when
    K/V heads split too), or None for a replicated layer."""
    H, KV, tp = acfg.n_heads, acfg.n_kv_heads, sh.tp
    if tp == 1 or H % tp:
        return None
    hl, G = H // tp, H // KV
    if KV % tp == 0:
        return dataclasses.replace(acfg, n_heads=hl,
                                   n_kv_heads=KV // tp), None
    if G % hl == 0:
        return dataclasses.replace(acfg, n_heads=hl, n_kv_heads=1), \
            (sh.tp_rank * hl) // G
    return None


def attn_weights(sh, w, acfg: L.AttnCfg):
    plan = attn_plan(acfg, sh)
    if plan is None:
        return None, sh.weights(w)
    lcfg, kvh = plan
    lw = {"wq": sh.weight(w["wq"], 1), "wo": sh.weight(w["wo"], 0)}
    if kvh is None:
        lw["wk"] = sh.weight(w["wk"], 1)
        lw["wv"] = sh.weight(w["wv"], 1)
    else:
        cols = slice(kvh * acfg.head_dim, (kvh + 1) * acfg.head_dim)
        lw["wk"] = sh.weight(w["wk"], None, "partial")[:, cols]
        lw["wv"] = sh.weight(w["wv"], None, "partial")[:, cols]
    return lcfg, lw


def self_attn(sh, w, acfg: L.AttnCfg, h, positions, use_flash: bool,
              sp: bool = False):
    lcfg, lw = attn_weights(sh, w, acfg)
    if lcfg is None:
        out = L.attn_apply(lw, acfg, sh.rep_in(h, sp), positions,
                           use_flash=use_flash)[0]
        return sh.rep_out(out, sp)
    out, _ = L.attn_apply(lw, lcfg, sh.enter(h, sp), positions,
                          use_flash=use_flash)
    return sh.exit(out, sp)


def decode_attn(sh, w, acfg: L.AttnCfg, h, positions, kv):
    """One decode step of a self-attention layer, the projections
    replicated over "model", against a cache whose sequence may be split
    over it (``layers.attn_apply``'s ``seq_split``)."""
    k_buf, v_buf, length = kv
    split = None
    if sh.tp > 1 and D.sharded_dims(k_buf, 1):
        split = (k_buf.shape[1], D.global_offset(k_buf, 1), sh.tp_max,
                 sh.tp_sum_nograd)
    out, (_, _, n) = L.attn_apply(sh.weights(w), acfg, h, positions,
                                  kv_cache=(D.local(k_buf), D.local(v_buf),
                                            length), seq_split=split)
    return out, (k_buf, v_buf, n)


# ---------------------------------------------------------------------------
# MLP, MoE, recurrences
# ---------------------------------------------------------------------------

def mlp(sh, w, h, act: str, sp: bool = False):
    dff = w["w_up"].shape[1]
    if sh.tp > 1 and dff % sh.tp == 0:
        lw = {k: sh.weight(v, 0 if k == "w_down" else 1)
              for k, v in w.items()}
        return sh.exit(L.mlp_apply(lw, sh.enter(h, sp), act), sp)
    return sh.rep_out(L.mlp_apply(sh.weights(w), sh.rep_in(h, sp), act), sp)


def moe(sh, w, h, cfg, sp: bool = False):
    """Experts over "model" where they divide (EP), else every rank runs
    them all."""
    E = cfg.moe_experts
    ep = 0 if E % sh.tp == 0 else None
    lw = {"router": sh.weight(w["router"])}
    for k in ("w_gate", "w_up", "w_down"):
        lw[k] = sh.weight(w[k], ep)
    return L.moe_apply(lw, h, E, cfg.moe_top_k, shard=sh, sp=sp)


_RGLRU_TP = {"w_x": 1, "w_y": 1, "conv_w": 1, "w_gate_a": 1, "w_gate_x": 1,
             "lambda_p": 0, "w_out": 0}


def rnn(sh, p, cfg, h, state, sp: bool = False):
    """The recurrence: RG-LRU's channels over "model" (prefill and
    training); every other case replicated over "model", the decode state
    gathered whole and split again."""
    R = p.rnn["w_x"].shape[1] if p.kind == "rglru" else 0
    if p.kind == "rglru" and state is None and sh.tp > 1 and R % sh.tp == 0:
        lw = {k: sh.weight(v, _RGLRU_TP[k]) for k, v in p.rnn.items()}
        out, st = L.rglru_apply(
            lw, sh.enter(h, sp), None,
            gather=lambda u: sh.tp_gather(u, -1, partial=True))
        return sh.exit(out, sp), st
    lw = sh.weights(p.rnn)
    h = sh.rep_in(h, sp)
    full = None if state is None else tuple(model_full(sh, t) for t in state)
    if p.kind == "rglru":
        out, new = L.rglru_apply(lw, h, full)
    elif p.kind == "mlstm":
        out, new = L.mlstm_apply(lw, h, cfg.n_heads, full)
    else:
        out, new = L.slstm_apply(lw, h, full)
    if state is not None:
        new = tuple(like(n, t) for n, t in zip(new, state))
    return sh.rep_out(out, sp), new


# ---------------------------------------------------------------------------
# cache tensors
# ---------------------------------------------------------------------------

def model_full(sh, t):
    """A cache DTensor's local rows, whole over "model"."""
    from torch.distributed.tensor import Replicate
    if not D.is_dtensor(t):
        return t
    if sh.tp_dim is None or sh.tp == 1:
        return t.to_local()
    pl = list(t.placements)
    pl[sh.tp_dim] = Replicate()
    return t.redistribute(t.device_mesh, pl).to_local()


def like(full_local, t):
    """``full_local`` (whole over "model") laid out as cache DTensor
    ``t`` is (each rank keeps its slice: no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not D.is_dtensor(t):
        return full_local
    pl = list(t.placements)
    rep = list(pl)
    for i in range(len(rep)):
        if t.device_mesh.mesh_dim_names[i] == "model":
            rep[i] = Replicate()
    full = DTensor.from_local(full_local.to(t.dtype), t.device_mesh, rep,
                              run_check=False, shape=t.shape,
                              stride=t.stride())
    return full.redistribute(t.device_mesh, pl)
