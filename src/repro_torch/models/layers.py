"""Neural-net layers of the decoder-only LMs, in PyTorch.

A copy of the reference package's ``repro.models.layers`` for the blocks of
the ``lm`` family: GQA attention (full / sliding-window, logit softcap,
RoPE incl. partial "2d"), RMS and layer norm, the SwiGLU, GeGLU and GeLU
MLPs, the top-k mixture of experts with sort-based dispatch, and the
recurrent blocks: RG-LRU (recurrentgemma; its linear recurrence through
:func:`associative_scan`, a log-depth scan), mLSTM (xLSTM's matrix memory,
chunkwise) and sLSTM (scalar memories, one step per position).  The
recurrences are PyTorch operations, as the reference computes them with
XLA operations outside any Pallas kernel; their float32 products must not
round to TF32, so nothing here sets ``allow_tf32``.
Parameters are mappings of tensors (plain dicts or
``nn.ParameterDict``); the casts sit where the reference has them, so that
bf16 rounds at the same places.  ``attn_apply`` runs prefill attention
through :func:`repro_torch.kernels.ops.flash_attention` under the
reference's threshold (``S >= 512`` and ``S * B <= 2**22``), and the inline
``_sdpa`` below it.  The flash kernel has no gradient on the card: training
passes ``use_flash=False`` and takes ``_sdpa``, as the reference's trainer
does.  Cross-attention (``attn_apply(cross_kv=...)``: the whisper decoder's
and llama-3.2-vision's image layers) attends without a mask over K/V
precomputed from the encoder or the projected patches, through ``_sdpa``,
as the reference computes it outside any Pallas kernel.

Each ``*_specs`` function gives a layer's sharding specs, the reference's
``PartitionSpec``s as plain tuples of mesh-axis names (``distributed``),
per layer (the reference stacks layers and prepends a ``None``).  On a
mesh, :func:`moe_apply` dispatches over the data-parallel ranks' global
slot order and runs this rank's experts (``shard``), and decode attention
combines the parts of a cache split over ranks (``attn_apply(...,
seq_split=)``); the other layers take their local weights from
``models.sharded``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

Params = Mapping[str, torch.Tensor]
#: decode cache of one attention layer: (k_buf, v_buf, length); the buffers
#: are (B, T, KV, D) and are written in place, length is a Python int
KVCache = Tuple[torch.Tensor, torch.Tensor, int]

# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Uniform(-1/sqrt(d_in), 1/sqrt(d_in)) in float32, cast to ``dtype``,
    made on ``device`` (the generator's device)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.rand((d_in, d_out), generator=gen, dtype=torch.float32,
                   device=device)
    return (w.mul_(2 * scale).sub_(scale)).to(dtype)


#: a layer norm's and an rms norm's specs: replicated
NORM_SPEC = (None,)


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dt)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0,
               rotary_dim: Optional[int] = None, device=None):
    """Inverse frequencies ``1 / theta ** (2i / rd)`` in float32, equal bit
    for bit to the reference's: torch's float32 ``pow`` is one ulp off
    XLA's at some exponents (D = 120 and 256), which grows to 3e-3 in the
    rotation at position 524,287, so the power is taken in float64 and
    rounded to float32 before the float32 reciprocal."""
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / (theta ** exps.double()).float()  # (rd/2,)


def apply_rope(x, positions, theta: float = 10000.0,
               rotary_frac: float = 1.0):
    """x: (..., S, H, D); positions: (..., S).  Rotates interleaved pairs
    ``(x[..., 0::2], x[..., 1::2])`` of the first ``rotary_frac`` of the
    dims (chatglm's 2d/partial RoPE); the rotation is float32."""
    D = x.shape[-1]
    rd = int(D * rotary_frac)
    rd -= rd % 2
    if rd == 0:
        return x
    inv = rope_freqs(D, theta, rd, device=x.device)
    ang = positions[..., :, None].to(torch.float32) * inv  # (..., S, rd/2)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA; causal / sliding-window / cross)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0
    window: int = 0              # 0 = full attention; >0 = sliding window
    logit_softcap: float = 0.0   # 0 = off (gemma2 uses 50.0)
    causal: bool = True
    use_rope: bool = True
    qk_norm: bool = False


def attn_init(gen, cfg: AttnCfg, dtype=torch.bfloat16, device="cuda"):
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, qd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, kvd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, kvd, dtype, device),
        "wo": dense_init(gen, qd, cfg.d_model, dtype, device),
    }


def attn_specs():
    """Q/K/V column-parallel over "model" (heads), the output
    row-parallel; the model dimension over "data" (FSDP)."""
    return {"wq": ("data", "model"), "wk": ("data", "model"),
            "wv": ("data", "model"), "wo": ("model", "data")}


def _sdpa(q, k, v, *, causal, window, cap, q_pos, k_pos, dtype):
    """q: (B,S,H,D), k/v: (B,T,KV,D) — grouped-query attention core,
    written out as the reference writes it (not a fused library call)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) \
        * scale
    if cap > 0:
        logits = softcap(logits, cap)
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
    else:
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=q.device)
    if window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    logits = torch.where(mask[None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D)


def attn_apply(params: Params, cfg: AttnCfg, x, positions,
               kv_cache: Optional[KVCache] = None,
               cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               use_flash: bool = True, seq_split=None):
    """Returns (out, new_kv_cache).

    * prefill: ``kv_cache=None`` -> full self-attention over x, through the
      flash kernel for ``S >= 512`` and ``S * B <= 2**22``.
    * decode: ``kv_cache=(k_buf, v_buf, length)`` -> append, attend.  The
      buffers are written in place (the reference returns updated copies).
      ``seq_split`` (distributed flash-decode): ``(T, offset, combine_max,
      combine_sum)`` where the buffers hold slots ``offset ..`` of a cache
      of ``T`` split over ranks: the new keys are written by the rank that
      holds their slots, and each rank's max, exponent sums and weighted
      values are combined by the two reductions.
    * cross-attention: ``cross_kv=(k, v)``, each (B, T, KV, D), precomputed
      from the encoder: q without RoPE, every key attended; no cache.
    """
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, D)
    if cross_kv is not None:
        k, v = cross_kv
        T = k.shape[1]
        out = _sdpa(q, k, v, causal=False, window=0, cap=cfg.logit_softcap,
                    q_pos=torch.arange(S, device=x.device),
                    k_pos=torch.arange(T, device=x.device), dtype=x.dtype)
        return out.reshape(B, S, H * D) @ params["wo"], None

    k = (x @ params["wk"]).reshape(B, S, KV, D)
    v = (x @ params["wv"]).reshape(B, S, KV, D)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_frac)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_frac)

    if kv_cache is None:
        if use_flash and S >= 512 and S * B <= (1 << 22):
            out = kops.flash_attention(q, k, v, causal=cfg.causal,
                                       window=cfg.window,
                                       logit_softcap=cfg.logit_softcap)
        else:
            out = _sdpa(q, k, v, causal=cfg.causal, window=cfg.window,
                        cap=cfg.logit_softcap, q_pos=positions[0],
                        k_pos=positions[0], dtype=x.dtype)
        return out.reshape(B, S, H * D) @ params["wo"], None

    # ---- decode: append to cache then attend over it ----
    # Sliding-window layers use the buffer as a ring (T == window): softmax
    # is permutation-invariant and keys carry their RoPE phase from write
    # time, so slot order does not matter.
    k_buf, v_buf, length = kv_cache
    tl = k_buf.shape[1]
    T, off = (tl, 0) if seq_split is None else seq_split[:2]
    idx = min(length % T, T - S)  # the reference's dynamic_update_slice clamp
    a, b = max(idx, off), min(idx + S, off + tl)   # the slots held here
    if a < b:
        k_buf[:, a - off:b - off] = k[:, a - idx:b - idx].to(k_buf.dtype)
        v_buf[:, a - off:b - off] = v[:, a - idx:b - idx].to(v_buf.dtype)
    k_pos = torch.arange(tl, device=x.device)
    if off:
        k_pos = k_pos + off
    valid = (k_pos <= length) | (length >= T)
    if cfg.window > 0 and T > cfg.window:
        valid = valid & (k_pos > length - cfg.window)
    qg = q.reshape(B, S, KV, H // KV, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k_buf).to(torch.float32)
    logits = logits * (1.0 / math.sqrt(D))
    if cfg.logit_softcap > 0:
        logits = softcap(logits, cfg.logit_softcap)
    logits = torch.where(valid[None, None, None, None, :], logits, -1e30)
    if seq_split is None:
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v_buf)
    else:
        combine_max, combine_sum = seq_split[2:]
        m = combine_max(logits.amax(-1, keepdim=True))
        e = torch.exp(logits - m)
        den = combine_sum(e.sum(-1, keepdim=True))
        out = combine_sum(torch.einsum("bkgst,btkd->bskgd", e / den,
                                       v_buf.to(torch.float32))).to(x.dtype)
    return out.reshape(B, S, H * D) @ params["wo"], (k_buf, v_buf,
                                                      length + S)


def kv_cache_init(cfg: AttnCfg, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device), 0)


def kv_cache_specs(decode_seq_shard: bool = True):
    """KV buffers: batch over data, cached sequence over model (distributed
    flash-decode: each rank's partial softmax terms are combined across
    "model"); the length is a host int, replicated."""
    seq = "model" if decode_seq_shard else None
    return (("data", seq, None, None), ("data", seq, None, None), ())


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model, d_ff, kind: str = "swiglu", dtype=torch.bfloat16,
             device="cuda"):
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
                "w_up": dense_init(gen, d_model, d_ff, dtype, device),
                "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device)}


def mlp_specs(kind: str = "swiglu"):
    if kind in ("swiglu", "geglu"):
        return {"w_gate": ("data", "model"), "w_up": ("data", "model"),
                "w_down": ("model", "data")}
    return {"w_up": ("data", "model"), "w_down": ("model", "data")}


def mlp_apply(params: Params, x, kind: str = "swiglu"):
    if kind == "swiglu":
        return (F.silu(x @ params["w_gate"]) *
                (x @ params["w_up"])) @ params["w_down"]
    if kind == "geglu":
        return (F.gelu(x @ params["w_gate"], approximate="tanh") *
                (x @ params["w_up"])) @ params["w_down"]
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts: top-k routing, sort-based dispatch into (E, C, D)
# expert buffers, three batched expert products, a gated combine
# ---------------------------------------------------------------------------


def moe_init(gen, d_model, d_ff, n_experts, dtype=torch.bfloat16,
             device="cuda"):
    """The router ``(d_model, E)`` in float32 whatever ``dtype`` is; the
    experts ``(E, d_model, d_ff)`` / ``(E, d_ff, d_model)`` in ``dtype``."""
    def einit(shape, fan_in):
        scale = 1.0 / math.sqrt(fan_in)
        w = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return w.mul_(2 * scale).sub_(scale).to(dtype)
    return {"router": dense_init(gen, d_model, n_experts, torch.float32,
                                 device),
            "w_gate": einit((n_experts, d_model, d_ff), d_model),
            "w_up": einit((n_experts, d_model, d_ff), d_model),
            "w_down": einit((n_experts, d_ff, d_model), d_ff)}


def moe_specs():
    """Experts over "model" (EP), their model dimension over "data"."""
    return {"router": ("data", None), "w_gate": ("model", "data", None),
            "w_up": ("model", "data", None),
            "w_down": ("model", None, "data")}


#: the reference's perf iteration #3: shard the (E, C, D) expert buffers'
#: slots C over the data axes as well, so that the dispatch's sum over
#: the data-parallel ranks is a reduce-scatter (each rank's experts then
#: run its share of the slots) instead of a full all-reduce.  A spec such
#: as ("model", "data", None); applied only where C % 8 == 0, as in the
#: reference, and where the slots divide over the data axes.
MOE_BUFFER_SPEC = None


def set_moe_buffer_sharding(spec):
    global MOE_BUFFER_SPEC
    MOE_BUFFER_SPEC = None if spec is None else tuple(spec)


def moe_capacity(tokens: int, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert: dropless (``T * k``) up to 4,096 slots (decode
    steps, small batches), else GShard's ``T * k * factor / E``."""
    if tokens * top_k <= 4096:
        return tokens * top_k
    return max(top_k, int(tokens * top_k * capacity_factor / n_experts))


def moe_route(router, xf, top_k: int):
    """Router in float32: (probs (T, E), gate values (T, k) renormalised
    to sum 1, gate indices (T, k)).  The top k come from a stable
    descending sort, so tied probabilities go to the lower expert index,
    as ``jax.lax.top_k`` breaks them."""
    probs = torch.softmax(xf.to(torch.float32) @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _counts(ids, n: int):
    """How often each of ``0..n-1`` occurs in ``ids``: integer adds, so
    exact in any order, and no host sync (``torch.bincount`` on a card
    reads the max back first)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


def moe_dispatch(gate_idx, n_experts: int, capacity: int):
    """Each slot's row of the flattened ``(E * C)`` expert buffer, in slot
    order (token-major), and whether it fits; a dropped slot's row is its
    expert's first, as the reference's clamped indices are.  Slots are
    ordered by a stable sort on their expert, so an expert keeps its first
    ``C`` slots in token order and drops the rest, as the reference's
    stable argsort and one-hot cumsum decide."""
    slot_expert = gate_idx.reshape(-1)
    sorted_expert, order = torch.sort(slot_expert, stable=True)
    counts = _counts(slot_expert, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(slot_expert.numel(), device=gate_idx.device) \
        - starts[sorted_expert]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < capacity
    return slot_expert * capacity + torch.where(keep, pos, 0), keep


def moe_experts(params: Params, buf):
    """The SwiGLU expert products on ``(E, C, D)`` buffers."""
    h = F.silu(torch.bmm(buf, params["w_gate"])) * \
        torch.bmm(buf, params["w_up"])
    return torch.bmm(h, params["w_down"])


def moe_combine(out_buf, rows, keep, gate_vals):
    """Each slot's expert output (0 where it was dropped) times its gate
    value cast to the activation dtype, summed over a token's k slots in
    rank order: a fixed order, so reruns on the card are bitwise."""
    T, k = gate_vals.shape
    E, C, D = out_buf.shape
    slot_out = torch.where(keep[:, None], out_buf.reshape(E * C, D)[rows], 0)
    weighted = slot_out * gate_vals.reshape(-1, 1).to(slot_out.dtype)
    return weighted.reshape(T, k, D).sum(1)


def moe_apply(params: Params, x, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, shard=None, sp: bool = False):
    """x: (B, S, D) -> ((B, S, D), the Switch load-balancing aux loss).

    ``shard`` (a ``distributed.ShardCtx`` with more than one rank): ``x``
    is this rank's rows of the batch and ``params`` hold its experts
    (``E / tp`` of them, or all where they do not divide over "model";
    the router whole); the capacity, the drops and
    the aux loss are the whole batch's, as one program computes them, and
    the aux loss returned is this data-parallel rank's share of it.
    ``sp``: ``x`` is this rank's slice of the sequence, and so is the
    output."""
    if shard is not None and (shard.dp > 1 or shard.tp > 1):
        return _moe_sharded(params, x, n_experts, top_k, capacity_factor,
                            shard, params["w_gate"].shape[0] < n_experts, sp)
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    probs, gate_vals, gate_idx = moe_route(params["router"], xf, top_k)
    C = moe_capacity(T, top_k, n_experts, capacity_factor)
    rows, keep = moe_dispatch(gate_idx, n_experts, C)
    # dropped slots are copied into a spare last row, cut off after
    spare = torch.where(keep, rows, n_experts * C)
    buf = xf.new_zeros((n_experts * C + 1, D)).index_copy(
        0, spare, xf.repeat_interleave(top_k, 0))
    buf = buf[:-1].reshape(n_experts, C, D)
    y = moe_combine(moe_experts(params, buf), rows, keep, gate_vals)
    density = _counts(gate_idx[:, 0], n_experts).to(torch.float32) / T
    aux = n_experts * torch.sum(density * probs.mean(0))
    return y.reshape(B, S, D).to(x.dtype), aux


def _split_slots(C: int, dp: int) -> bool:
    spec = MOE_BUFFER_SPEC
    return spec is not None and len(spec) > 1 and spec[1] is not None \
        and "data" in ((spec[1],) if isinstance(spec[1], str) else spec[1]) \
        and C % 8 == 0 and C % dp == 0 and dp > 1


def _moe_sharded(params: Params, x, n_experts: int, top_k: int,
                 capacity_factor: float, sh, ep: bool, sp: bool):
    """The dispatch of the whole batch, computed where its slots live:
    every rank learns the global slot order from the gathered gate
    indices; it copies its own tokens' slots bound for its experts into a
    partial (E / tp, C, D) buffer, which is summed over the data axes (or
    reduce-scattered over C under :data:`MOE_BUFFER_SPEC`); its experts
    run; each token's slots on this rank's experts are combined and the
    parts summed over "model".  Without ``ep`` every rank runs every
    expert (replicated over "model")."""
    xr = sh.rep_in(x, sp)           # the router sees every token
    B, S, D = xr.shape
    T = B * S
    probs, gate_vals, gate_idx = moe_route(params["router"],
                                           xr.reshape(T, D), top_k)
    k = top_k
    tg = T * sh.dp
    C = moe_capacity(tg, k, n_experts, capacity_factor)
    rows_g, keep_g = moe_dispatch(sh.dp_gather(gate_idx), n_experts, C)
    mine = slice(sh.dp_rank * T * k, (sh.dp_rank + 1) * T * k)
    rows, keep = rows_g[mine], keep_g[mine]
    el = n_experts // sh.tp if ep else n_experts
    lo = sh.tp_rank * el * C if ep else 0
    enter = sh.enter if ep else (lambda t: t)
    local = keep & (rows >= lo) & (rows < lo + el * C)
    rows_l = torch.where(local, rows - lo, el * C)
    xe = (sh.enter(x, sp) if ep else xr).reshape(T, D)
    part = xe.new_zeros((el * C + 1, D)).index_copy(
        0, rows_l, xe.repeat_interleave(k, 0))[:-1].reshape(el, C, D)
    split = _split_slots(C, sh.dp)
    buf = sh.dp_scatter(part, 1) if split else sh.dp_sum(part)
    out = moe_experts(params, buf)
    if split:
        out = sh.dp_gather_grad(out, 1)
    slot_out = torch.where(local[:, None],
                           out.reshape(el * C, D)[torch.where(local, rows_l,
                                                              0)], 0)
    # the gate values feed every rank's part of the combine: their
    # gradient is summed over "model" like the tokens'
    gv = enter(gate_vals)
    weighted = slot_out * gv.reshape(-1, 1).to(slot_out.dtype)
    y = weighted.reshape(T, k, D).sum(1).reshape(B, S, D).to(x.dtype)
    y = sh.exit(y, sp) if ep else sh.rep_out(y, sp)
    counts = sh.dp_sum_nograd(_counts(gate_idx[:, 0], n_experts))
    density = counts.to(torch.float32) / tg
    pmean = sh.dp_sum(probs.sum(0)) / tg
    aux = n_experts * torch.sum(density * pmean) / sh.dp
    return y, aux


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma): a gated linear recurrence over a log-depth scan
# ---------------------------------------------------------------------------


def rglru_init(gen, d_model, d_rnn, n_heads, conv_width=4,
               dtype=torch.bfloat16, device="cuda"):
    """The input and gate branches, a ``(conv_width, d_rnn)`` depthwise
    conv, the recurrence's gates and ``lambda_p`` (float32, 4 to 9).
    ``n_heads`` is unused, as in the reference."""
    conv = torch.randn((conv_width, d_rnn), generator=gen,
                       dtype=torch.float32, device=device)
    return {
        "w_x": dense_init(gen, d_model, d_rnn, dtype, device),
        "w_y": dense_init(gen, d_model, d_rnn, dtype, device),
        "conv_w": (conv * 0.02).to(dtype),
        "w_gate_a": dense_init(gen, d_rnn, d_rnn, dtype, device),
        "w_gate_x": dense_init(gen, d_rnn, d_rnn, dtype, device),
        "lambda_p": torch.linspace(4.0, 9.0, d_rnn, dtype=torch.float32,
                                   device=device),
        "w_out": dense_init(gen, d_rnn, d_model, dtype, device),
    }


def rglru_specs():
    return {"w_x": ("data", "model"), "w_y": ("data", "model"),
            "conv_w": (None, "model"), "w_gate_a": ("data", "model"),
            "w_gate_x": ("data", "model"), "lambda_p": ("model",),
            "w_out": ("model", "data")}


def _combine(a1, b1, a2, b2):
    """``(a1, b1)`` then ``(a2, b2)``: the affine maps ``h -> a h + b``
    composed."""
    return a1 * a2, b1 * a2 + b2


def _interleave(even, odd):
    """``even[0], odd[0], even[1], ...`` along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    out = torch.stack((even[:, :n], odd), 2).flatten(1, 2)
    return torch.cat((out, even[:, n:]), 1) if even.shape[1] > n else out


def associative_scan(a, b):
    """Inclusive scan of the pairs ``(a_t, b_t)`` along dim 1 under
    :func:`_combine`: ``(prod_{s<=t} a_s, h_t)`` with ``h_t = a_t h_{t-1} +
    b_t`` from ``h_{-1} = 0``.

    ``jax.lax.associative_scan``'s odd/even recursion, so the same tree of
    combinations (and float32 rounds where it does): combine neighbouring
    pairs, scan those recursively, fill in the even positions; log2(S)
    levels of elementwise passes in place of S sequential steps."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat((a[:, :1], ea), 1)
    eb = torch.cat((b[:, :1], eb), 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_core(params: Params, u, h0=None, gather=None):
    """u: (B, S, R) after the conv.  Float32 gates of bf16 products, the
    recurrence in float32 from ``h0``; returns (h in u's dtype, float32
    h of the last position).  ``gather`` (tensor-parallel): ``u`` holds
    this rank's channels, the gates' products need all of them."""
    B, S, R = u.shape
    ug = u if gather is None else gather(u)
    r = torch.sigmoid((ug @ params["w_gate_a"]).to(torch.float32))
    i = torch.sigmoid((ug @ params["w_gate_x"]).to(torch.float32))
    log_a = -8.0 * r * F.softplus(params["lambda_p"])
    a = torch.exp(log_a)
    gated_x = u.to(torch.float32) * i * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    if h0 is None:
        h0 = torch.zeros((B, R), dtype=torch.float32, device=u.device)
    aa, bb = associative_scan(a, gated_x)
    h = aa * h0[:, None, :] + bb
    return h.to(u.dtype), h[:, -1]


def rglru_apply(params: Params, x, state=None, gather=None):
    """x: (B, S, D).  ``state``: (conv tail (B, W-1, R), h (B, R) float32)
    for decode.  Returns (out, (new tail, h of the last position)).  The
    causal depthwise conv is the reference's left-to-right sum of W shifted
    products, so bf16 rounds where it rounds."""
    u = x @ params["w_x"]
    gate_y = F.gelu(x @ params["w_y"], approximate="tanh")
    W = params["conv_w"].shape[0]
    if state is None:
        conv_tail = u.new_zeros((x.shape[0], W - 1, u.shape[-1]))
        h0 = None
    else:
        conv_tail, h0 = state
    upad = torch.cat([conv_tail, u], 1)
    S = u.shape[1]
    uc = sum(upad[:, i:i + S] * params["conv_w"][i] for i in range(W))
    y, h_last = _rglru_core(params, uc, h0, gather)
    out = (y * gate_y) @ params["w_out"]
    new_tail = upad[:, -(W - 1):] if W > 1 else conv_tail
    return out, (new_tail, h_last)


def rglru_state_init(batch, d_rnn, conv_width=4, dtype=torch.bfloat16,
                     device="cuda"):
    return (torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                        device=device),
            torch.zeros((batch, d_rnn), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
# memories, a sequential loop)
# ---------------------------------------------------------------------------


def mlstm_init(gen, d_model, n_heads, dtype=torch.bfloat16, device="cuda"):
    """q/k are d_model wide, v and the output ``2 d_model``; the input and
    forget gates' ``w_if`` is float32 whatever ``dtype`` is."""
    d_inner = 2 * d_model
    return {
        "w_up": dense_init(gen, d_model, d_inner, dtype, device),
        "w_q": dense_init(gen, d_model, d_model, dtype, device),
        "w_k": dense_init(gen, d_model, d_model, dtype, device),
        "w_v": dense_init(gen, d_model, d_inner, dtype, device),
        "w_if": dense_init(gen, d_model, 2 * n_heads, torch.float32, device),
        "w_down": dense_init(gen, d_inner, d_model, dtype, device),
    }


def mlstm_specs():
    return {"w_up": ("data", "model"), "w_q": ("data", "model"),
            "w_k": ("data", "model"), "w_v": ("data", "model"),
            "w_if": ("data", None), "w_down": ("model", "data")}


def mlstm_apply(params: Params, x, n_heads: int, state=None,
                chunk: int = 256):
    """Chunkwise-parallel mLSTM: within a chunk the quadratic form with
    relative decay, across chunks the carried matrix state (C, n) per
    head; float32 throughout.  ``chunk = S`` when S is not a multiple of
    ``chunk`` (decode, short prompts), as in the reference.

    As in the reference, the within-chunk decay weights are clamped
    (``exp(min(g, 0))``) while the carried state's are not, so a chunk of
    S tokens and S chunks of one compute different functions (ROADMAP
    queue 3 b); decode is the latter."""
    B, S, D = x.shape
    u = x @ params["w_up"]
    di = u.shape[-1]
    H = n_heads
    hd, hv = D // H, di // H
    f32 = torch.float32
    q = (x @ params["w_q"]).reshape(B, S, H, hd) / math.sqrt(hd)
    k = (x @ params["w_k"]).reshape(B, S, H, hd) / math.sqrt(hd)
    v = (x @ params["w_v"]).reshape(B, S, H, hv)
    gates = (x.to(f32) @ params["w_if"]).reshape(B, S, H, 2)
    log_f = -F.softplus(-gates[..., 0])     # forget gate in log space
    log_i = gates[..., 1]                   # input gate (exp gating)
    if S % chunk != 0:
        chunk = S
    if state is None:
        C = torch.zeros((B, H, hd, hv), dtype=f32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=f32, device=x.device)
    else:
        C, n = state
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    outs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        lib = log_i[:, sl]
        cs_f = torch.cumsum(log_f[:, sl], 1)            # (B, c, H)
        total_f = cs_f[:, -1]
        dec_in = torch.exp(cs_f)[..., None]
        # within the chunk: attention with relative decay, clamped
        g = cs_f[:, :, None, :] - cs_f[:, None, :, :] + lib[:, None, :, :]
        g = torch.where(mask, g, -math.inf)
        sw = torch.einsum("bthd,bshd->btsh", qb, kb) * \
            torch.exp(torch.clamp(g, max=0.0))
        intra = torch.einsum("btsh,bshd->bthd", sw, vb)
        nor_i = sw.sum(2)
        # from the carried state
        inter = torch.einsum("bthd,bhde->bthe", qb * dec_in, C)
        nor_c = torch.einsum("bthd,bhd->bth", qb * dec_in, n)
        nor = torch.clamp(torch.abs(nor_i + nor_c), min=1.0)
        outs.append((intra + inter) / nor[..., None])
        # the carried state, unclamped
        dec_out = torch.exp(total_f[:, None, :] - cs_f + lib)   # (B, c, H)
        kd = kb * dec_out[..., None]
        decay = torch.exp(total_f)
        C = C * decay[..., None, None] + \
            torch.einsum("bshd,bshe->bhde", kd, vb)
        n = n * decay[..., None] + kd.sum(1)
    y = torch.cat(outs, 1).reshape(B, S, di).to(x.dtype)
    y = y * F.silu(u)
    return y @ params["w_down"], (C, n)


def mlstm_state_init(batch, d_model, n_heads, device="cuda"):
    """(C (B, H, hd, hv), n (B, H, hd)), float32 zeros."""
    hd = d_model // n_heads        # q/k head dim
    hv = 2 * d_model // n_heads    # v head dim
    return (torch.zeros((batch, n_heads, hd, hv), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, n_heads, hd), dtype=torch.float32,
                        device=device))


def slstm_init(gen, d_model, n_heads, dtype=torch.bfloat16, device="cuda"):
    """Input and recurrent weights of the four gates, the output
    projection and an rms ``norm`` (float32).  ``n_heads`` is unused, as in
    the reference."""
    return {
        "w_in": dense_init(gen, d_model, 4 * d_model, dtype, device),
        "r_in": dense_init(gen, d_model, 4 * d_model, dtype, device),
        "w_down": dense_init(gen, d_model, d_model, dtype, device),
        "norm": torch.zeros((d_model,), dtype=torch.float32, device=device),
    }


def slstm_specs():
    return {"w_in": ("data", "model"), "r_in": ("data", "model"),
            "w_down": ("data", "model"), "norm": (None,)}


def slstm_apply(params: Params, x, state=None):
    """sLSTM: a sequential loop over positions (scalar memories, exp
    gating stabilised by the running max ``m``), float32 from a state
    ``(h, c, n, m)`` (zeros, ``n`` ones); ``-softplus(-f)`` is the
    forget gate's log-sigmoid, as the reference writes it.  The input
    products and ``r_in`` are cast to float32 once per call."""
    B, S, D = x.shape
    zf = (x @ params["w_in"]).to(torch.float32)        # (B, S, 4D)
    if state is None:
        h, c, m = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
                   for _ in range(3))
        n = torch.ones((B, D), dtype=torch.float32, device=x.device)
    else:
        h, c, n, m = state
    r_in = params["r_in"].to(torch.float32)
    hs = []
    for t in range(S):
        z, i, f, o = (zf[:, t] + h @ r_in).chunk(4, -1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        log_f = -F.softplus(-f)
        m_new = torch.maximum(log_f + m, i)
        ig = torch.exp(i - m_new)
        fg = torch.exp(log_f + m - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        h = o * (c / torch.clamp(n, min=1.0))
        m = m_new
        hs.append(h)
    y = rms_norm(torch.stack(hs, 1).to(x.dtype), params["norm"])
    return y @ params["w_down"], (h, c, n, m)


def slstm_state_init(batch, d_model, device="cuda"):
    """(h, c, n, m): float32 zeros, ``n`` ones."""
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return (z, z.clone(), torch.ones_like(z), z.clone())
