"""The unified model, in PyTorch: decoder-only LMs, the whisper-style
encoder-decoder and llama-3.2-vision's cross-attention layers.

A port of the reference package's ``repro.models.transformer``.  Decoder
layers are attention blocks (``attn``, ``attn_local``) for chatglm3-6b,
gemma2-9b, h2o-danube-3-4b and command-r-plus-104b, with a mixture of
experts in place of the MLP (``cfg.moe_experts``) for granite-moe-1b-a400m
and kimi-k2-1t-a32b, and recurrent blocks (``rglru``, ``mlstm``, ``slstm``)
for recurrentgemma-2b (RG-LRU with local attention) and xlstm-1.3b.  Only
attention blocks carry an MLP, as in the reference.  The cross families add
a cross-attention sub-layer (``norm_x``, ``cross``, scaled by
``tanh(gate_x)``) to the layers of ``_cross_layers``: every decoder layer of
whisper-base (``family="encdec"``), which attends over its encoder's output
(``_encode``: non-causal attention and MLP blocks over precomputed frame
embeddings, the conv frontend being a stub), and every
``cross_attn_every``-th layer of llama-3.2-vision-11b (``family="vlm"``),
which attends over patch embeddings through ``vision_proj``.  The model is
an ``nn.Module`` (:class:`Model`: the embedding, a ``ModuleList`` of
:class:`Block`, the final norm, and the encoder or the vision projection
where the family has one); a Python loop over the layers takes the
place of the reference's ``lax.scan`` over stacked layer groups.  Weights
are made without gradients, for serving; training turns them on with
``model.requires_grad_(True)`` (``train.step.make_state`` does).  With
``cfg.remat`` and gradients enabled, each layer is recomputed in the
backward pass (``torch.utils.checkpoint``), the counterpart of the
reference's ``jax.checkpoint`` of a layer group.

API (functions over the model, as in the reference):
  init(key, cfg, device)                -> Model   (weights made on device)
  params_from_jax(params_np, cfg)       -> Model   (the reference's weights)
  forward / hidden_forward              -> (logits / hidden, aux)
  loss_fn(params, cfg, batch)           -> scalar loss (+ 0.01 x aux)
  decode_init(cfg, batch, max_len)      -> cache   (a list, one per layer)
  prime_cross_kv(params, cfg, cache, extra) -> cache (cross K/V filled)
  decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
  shape_init(cfg)                       -> Model   (on ``meta``)
  param_specs(cfg)                      -> {parameter name: spec}
  cache_specs(cfg)                      -> one {leaf: spec} per layer

Every layer is composed of ``models.sharded``'s parts, which run in the
model's ``distributed.ShardCtx``: one rank for a model that is not
distributed.  On a mesh (``distributed.distribute_model``: the parameters
DTensors, the model's ``shard`` set) the same functions run sharded:
``tokens`` and ``extra`` are then this rank's rows of the global batch,
``loss_fn`` returns this data-parallel rank's share of the global mean
(the shares sum to it), ``forward`` and ``decode_step`` every rank's
logits of its rows over the whole vocabulary, and ``decode_init(...,
mesh=)`` a cache of DTensors laid out by :func:`cache_specs`.

``aux`` is the sum over MoE layers of the Switch load-balancing loss (0.0
without MoE).  A decode cache entry is ``{"kv": ...}`` for an attention
layer and ``{"state": ...}`` for a recurrent one; a cross layer's entry
adds ``"cross_kv"``.  ``extra`` is the frontend stub's input
(``registry.extra_shape``): frame embeddings for ``encdec``, patch
embeddings for ``vlm``; an ``lm`` model ignores it, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import distributed as D
from . import layers as L
from . import sharded as SH
from .config import ModelConfig

#: the recurrent block kinds
RNN_KINDS = ("rglru", "mlstm", "slstm")
#: the model families: decoder-only, encoder-decoder, vision cross-attention
FAMILIES = ("lm", "encdec", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family or a block kind the model does
    not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch}: unknown family {cfg.family!r}")
    unknown = set(cfg.pattern) - {"attn", "attn_local", *RNN_KINDS}
    if unknown:
        raise ValueError(f"{cfg.arch}: unknown block kinds {sorted(unknown)}")


# ---------------------------------------------------------------------------
# pattern periodicity
# ---------------------------------------------------------------------------

def _cross_layers(cfg: ModelConfig):
    if cfg.family == "encdec":
        return set(range(cfg.n_layers))          # every decoder layer
    if cfg.family == "vlm" and cfg.cross_attn_every:
        return set(range(cfg.cross_attn_every - 1, cfg.n_layers,
                         cfg.cross_attn_every))
    return set()


def pattern_period(cfg: ModelConfig) -> int:
    """Smallest period of (block kind, has-cross) over the layer stack."""
    pat = cfg.pattern
    cross = _cross_layers(cfg)
    n = cfg.n_layers
    for p in range(1, n + 1):
        if n % p:
            continue
        if all(pat[i] == pat[i % p] and ((i in cross) == ((i % p) in cross))
               for i in range(n)):
            return p
    return n


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _attn_cfg(cfg: ModelConfig, kind: str) -> L.AttnCfg:
    local = kind == "attn_local"
    return L.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope_theta=cfg.rope_theta,
        rotary_frac=cfg.rotary_frac,
        window=cfg.window if local or (cfg.window and kind == "attn") else 0,
        logit_softcap=cfg.attn_softcap, causal=True)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _norm_module(p):
    """An rms weight as a parameter, a layer norm's {"w", "b"} as a dict."""
    if isinstance(p, Mapping):
        return nn.ParameterDict({k: _frozen(v) for k, v in p.items()})
    return _frozen(p)


def _params(p: Optional[Mapping[str, torch.Tensor]]):
    return None if p is None else nn.ParameterDict(
        {k: _frozen(v) for k, v in p.items()})


class Block(nn.Module):
    """One layer: norm1, then attention (``attn*`` kinds) or a recurrence
    (``rnn``: RG-LRU, mLSTM or sLSTM); a cross layer adds ``norm_x``, the
    cross-attention's ``cross`` weights and its float32 scalar gate
    ``gate_x``; attention layers with ``d_ff > 0`` add norm2 and an MLP or
    a mixture of experts."""

    #: the mesh's ``distributed.ShardCtx`` once the model is distributed
    shard = None

    def __init__(self, kind: str, norm1,
                 attn: Optional[Mapping[str, torch.Tensor]] = None,
                 norm2=None, mlp: Optional[Mapping[str, torch.Tensor]] = None,
                 moe: Optional[Mapping[str, torch.Tensor]] = None,
                 rnn: Optional[Mapping[str, torch.Tensor]] = None, *,
                 norm_x=None,
                 cross: Optional[Mapping[str, torch.Tensor]] = None,
                 gate_x: Optional[torch.Tensor] = None):
        super().__init__()
        self.kind = kind
        self.norm1 = _norm_module(norm1)
        self.attn = _params(attn)
        self.rnn = _params(rnn)
        self.norm_x = None if norm_x is None else _norm_module(norm_x)
        self.cross = _params(cross)
        self.gate_x = None if gate_x is None else _frozen(gate_x)
        self.norm2 = None if norm2 is None else _norm_module(norm2)
        self.mlp = _params(mlp)
        self.moe = _params(moe)


class Model(nn.Module):
    """Embedding (``padded_vocab x d_model``), blocks and the final norm;
    ``unembed`` only when the config does not tie embeddings; ``encoder``
    (attention and MLP blocks) and ``enc_norm_f`` for ``encdec``,
    ``vision_proj`` (``vision_dim x d_model``) for ``vlm``, else None."""

    shard = None

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, norm_f,
                 blocks: Sequence[Block],
                 unembed: Optional[torch.Tensor] = None, *,
                 encoder: Optional[Sequence[Block]] = None,
                 enc_norm_f=None,
                 vision_proj: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.unembed = None if unembed is None else _frozen(unembed)
        self.norm_f = _norm_module(norm_f)
        self.blocks = nn.ModuleList(blocks)
        self.encoder = None if encoder is None else nn.ModuleList(encoder)
        self.enc_norm_f = None if enc_norm_f is None else \
            _norm_module(enc_norm_f)
        self.vision_proj = None if vision_proj is None else \
            _frozen(vision_proj)


def _norm_init(cfg: ModelConfig, d: int, device):
    if cfg.norm == "rms":
        return torch.zeros((d,), dtype=torch.float32, device=device)
    return {"w": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def _apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rms":
        return L.rms_norm(x, p)
    return L.layer_norm(x, p["w"], p["b"])


def _d_rnn(cfg: ModelConfig) -> int:
    """RG-LRU's recurrence width: 1.5 d_model."""
    return int(cfg.d_model * 1.5)


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's blocks: attention and a dense MLP."""
    return dataclasses.replace(cfg, family="lm", moe_experts=0)


def init_layer(gen, cfg: ModelConfig, kind: str, device,
               cross: bool = False) -> Block:
    dt = cfg.tdtype
    attn = rnn = norm2 = mlp = moe = None
    xp = {}
    if kind.startswith("attn"):
        attn = L.attn_init(gen, _attn_cfg(cfg, kind), dt, device)
    elif kind == "rglru":
        rnn = L.rglru_init(gen, cfg.d_model, _d_rnn(cfg), cfg.n_heads,
                           dtype=dt, device=device)
    elif kind == "mlstm":
        rnn = L.mlstm_init(gen, cfg.d_model, cfg.n_heads, dt, device)
    else:
        rnn = L.slstm_init(gen, cfg.d_model, cfg.n_heads, dt, device)
    if cross:
        xp = {"norm_x": _norm_init(cfg, cfg.d_model, device),
              "cross": L.attn_init(gen, _attn_cfg(cfg, "attn"), dt, device),
              "gate_x": torch.zeros((), dtype=torch.float32, device=device)}
    if cfg.d_ff > 0 and kind.startswith("attn"):
        norm2 = _norm_init(cfg, cfg.d_model, device)
        if cfg.moe_experts:
            moe = L.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts, dt,
                             device)
        else:
            mlp = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device)
    return Block(kind, _norm_init(cfg, cfg.d_model, device), attn, norm2, mlp,
                 moe, rnn, **xp)


def init(key, cfg: ModelConfig, device="cuda") -> Model:
    """Random weights made on ``device``.  ``key`` is a ``torch.Generator``
    on that device or an int seed.  The numbers differ from the reference's
    ``init`` (another generator); :func:`params_from_jax` carries those.
    Every cross layer's ``gate_x`` starts at 0, as in the reference, so the
    cross path adds nothing until it is set."""
    check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "meta":
        gen = None      # shapes only
    else:
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=device).manual_seed(int(key))
    dt = cfg.tdtype
    embed = L.dense_init(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    unembed = None if cfg.tie_embeddings else \
        L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt, device)
    norm_f = _norm_init(cfg, cfg.d_model, device)
    cross = _cross_layers(cfg)
    blocks = [init_layer(gen, cfg, kind, device, i in cross)
              for i, kind in enumerate(cfg.pattern)]
    extra = {}
    if cfg.family == "encdec":
        extra["encoder"] = [init_layer(gen, _enc_cfg(cfg), "attn", device)
                            for _ in range(cfg.enc_layers)]
        extra["enc_norm_f"] = _norm_init(cfg, cfg.d_model, device)
    if cfg.family == "vlm":
        extra["vision_proj"] = L.dense_init(gen, cfg.vision_dim, cfg.d_model,
                                            dt, device)
    return Model(cfg, embed, norm_f, blocks, unembed, **extra)


def shape_init(cfg: ModelConfig) -> Model:
    """The model on the ``meta`` device: shapes and dtypes, no storage."""
    return init(0, cfg, device="meta")


# ---------------------------------------------------------------------------
# sharding specs: the reference's, per layer
# ---------------------------------------------------------------------------

def _norm_specs(cfg: ModelConfig, name: str, out: Dict[str, Any]) -> None:
    if cfg.norm == "rms":
        out[name] = L.NORM_SPEC
    else:
        out[f"{name}.w"] = out[f"{name}.b"] = L.NORM_SPEC


def _layer_specs(cfg: ModelConfig, kind: str, cross: bool, prefix: str,
                 out: Dict[str, Any]) -> None:
    def put(sub, specs):
        for k, v in specs.items():
            out[f"{prefix}{sub}.{k}"] = v
    _norm_specs(cfg, f"{prefix}norm1", out)
    if kind.startswith("attn"):
        put("attn", L.attn_specs())
    elif kind == "rglru":
        put("rnn", L.rglru_specs())
    elif kind == "mlstm":
        put("rnn", L.mlstm_specs())
    else:
        put("rnn", L.slstm_specs())
    if cross:
        _norm_specs(cfg, f"{prefix}norm_x", out)
        put("cross", L.attn_specs())
        out[f"{prefix}gate_x"] = ()
    if cfg.d_ff > 0 and kind.startswith("attn"):
        _norm_specs(cfg, f"{prefix}norm2", out)
        if cfg.moe_experts:
            put("moe", L.moe_specs())
        else:
            put("mlp", L.mlp_specs(cfg.act))


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Every parameter's spec, by its name in ``Model.named_parameters()``:
    the reference's (``init``'s specs), whose layer-stacked leaves carry a
    leading ``None`` that a per-layer leaf drops."""
    check_supported(cfg)
    out: Dict[str, Any] = {"embed": ("model", "data")}
    if not cfg.tie_embeddings:
        out["unembed"] = ("data", "model")
    _norm_specs(cfg, "norm_f", out)
    cross = _cross_layers(cfg)
    for i, kind in enumerate(cfg.pattern):
        _layer_specs(cfg, kind, i in cross, f"blocks.{i}.", out)
    if cfg.family == "encdec":
        for i in range(cfg.enc_layers):
            _layer_specs(_enc_cfg(cfg), "attn", False, f"encoder.{i}.", out)
        _norm_specs(cfg, "enc_norm_f", out)
    if cfg.family == "vlm":
        out["vision_proj"] = (None, "data")
    return out


def cache_specs(cfg: ModelConfig) -> List[Dict[str, Any]]:
    """Each layer's decode-cache specs, as :func:`decode_init`'s entries
    are laid out (the reference's ``decode_init`` specs, per layer)."""
    check_supported(cfg)
    cross = _cross_layers(cfg)
    out = []
    for i, kind in enumerate(cfg.pattern):
        if kind.startswith("attn"):
            e = {"kv": L.kv_cache_specs()}
        elif kind == "rglru":
            e = {"state": (("data", None, "model"), ("data", "model"))}
        elif kind == "mlstm":
            # matrix memory (B, H, hd, hv): H is small (4), so the first
            # memory dim goes over "model" instead of the head dim
            e = {"state": (("data", None, "model", None),
                           ("data", None, "model"))}
        else:
            e = {"state": tuple([("data", "model")] * 4)}
        if i in cross:
            e["cross_kv"] = (("data", None, None, None),
                             ("data", None, None, None))
        out.append(e)
    return out


# ---------------------------------------------------------------------------
# weights from the reference
# ---------------------------------------------------------------------------

def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 as ml_dtypes.bfloat16, bits kept) as a tensor;
    a 0-d array stays 0-d."""
    a = np.asarray(a)
    shape = a.shape
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.reshape(shape).to(device)


def _tree(p, fn):
    if isinstance(p, Mapping):
        return {k: _tree(v, fn) for k, v in p.items()}
    return fn(p)


def params_from_jax(params_np: Mapping[str, Any], cfg: ModelConfig,
                    device="cuda") -> Model:
    """The reference's parameter tree (as numpy arrays) as the port's model.

    ``params_np["blocks"][k]`` holds pattern offset ``k`` stacked over
    ``n_layers // period`` groups; group ``g`` becomes layer
    ``g * period + k``.  A cross offset's tree adds ``cross``, ``norm_x``
    and ``gate_x``; ``encoder`` is stacked over ``enc_layers``."""
    check_supported(cfg)
    period = pattern_period(cfg)
    n_groups = cfg.n_layers // period

    def conv(a):
        return _tensor(a, device)

    def block(kind, stacked, g):
        p = _tree(stacked, lambda a: conv(np.asarray(a)[g]))
        return Block(kind, p["norm1"], p.get("attn"), p.get("norm2"),
                     p.get("mlp"), p.get("moe"), p.get("rnn"),
                     norm_x=p.get("norm_x"), cross=p.get("cross"),
                     gate_x=p.get("gate_x"))

    blocks: List[Optional[Block]] = [None] * cfg.n_layers
    for k in range(period):
        for g in range(n_groups):
            blocks[g * period + k] = block(cfg.pattern[k],
                                           params_np["blocks"][k], g)
    extra = {}
    if cfg.family == "encdec":
        extra["encoder"] = [block("attn", params_np["encoder"], i)
                            for i in range(cfg.enc_layers)]
        extra["enc_norm_f"] = _tree(params_np["enc_norm_f"], conv)
    if cfg.family == "vlm":
        extra["vision_proj"] = conv(params_np["vision_proj"])
    unembed = params_np.get("unembed")
    return Model(cfg, conv(params_np["embed"]),
                 _tree(params_np["norm_f"], conv), blocks,
                 None if unembed is None else conv(unembed), **extra)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _cross(p: Block, cfg: ModelConfig, x, positions, memory=None,
           cross_kv=None, sp: bool = False):
    """The cross sub-layer: x + tanh(gate_x) * cross-attention of
    norm_x(x) over ``memory`` (prefill: its K/V made here, on a mesh the
    heads split over "model" where they divide) or over the cache's
    ``cross_kv`` (decode: replicated over "model")."""
    sh = D.shard_ctx(p)
    hx = _apply_norm(cfg, SH.norm(sh, p.norm_x, sp), x)
    acfg = _attn_cfg(cfg, "attn")
    gate = sh.weight(p.gate_x, None, "partial" if sp else "replicated")
    if cross_kv is not None:
        out, _ = L.attn_apply(sh.weights(p.cross), acfg, hx, positions,
                              cross_kv=tuple(D.local(t) for t in cross_kv))
    else:
        lcfg, lw = SH.attn_weights(sh, p.cross, acfg)
        if lcfg is None:
            out, _ = L.attn_apply(lw, acfg, sh.rep_in(hx, sp), positions,
                                  cross_kv=_make_cross_kv(cfg, lw, memory))
            out = sh.rep_out(out, sp)
        else:
            out, _ = L.attn_apply(lw, lcfg, sh.enter(hx, sp), positions,
                                  cross_kv=_make_cross_kv(
                                      cfg, lw, sh.enter(memory)))
            out = sh.exit(out, sp)
    return x + torch.tanh(gate).to(x.dtype) * out


def _layer(p: Block, cfg: ModelConfig, x, positions,
           entry: Optional[Dict[str, Any]] = None, use_flash: bool = True,
           memory=None, sp: bool = False):
    """One layer; prefill without a cache entry (a cross layer attends
    over ``memory`` where there is one), decode with one (a cross layer
    over the entry's ``cross_kv``).  Returns (x, the layer's new entry or
    None, its MoE aux loss or 0.0; on a mesh this data-parallel rank's
    share of it).  ``sp`` (on a mesh): ``x`` is this rank's slice of the
    sequence (:func:`_constrain`)."""
    sh = D.shard_ctx(p)
    h = _apply_norm(cfg, SH.norm(sh, p.norm1, sp), x)
    if p.attn is not None:
        acfg = _attn_cfg(cfg, p.kind)
        if entry is None:
            out = SH.self_attn(sh, p.attn, acfg, h, positions, use_flash, sp)
            new = {"kv": None}
        else:
            out, kv = SH.decode_attn(sh, p.attn, acfg, h, positions,
                                     entry["kv"])
            new = {"kv": kv}
    else:
        out, state = SH.rnn(sh, p, cfg, h,
                            None if entry is None else entry["state"], sp)
        new = {"state": state}
    x = x + out
    if p.cross is not None:
        if entry is None and memory is not None:
            x = _cross(p, cfg, x, positions, memory=memory, sp=sp)
        elif entry is not None and "cross_kv" in entry:
            x = _cross(p, cfg, x, positions, cross_kv=entry["cross_kv"])
            new["cross_kv"] = entry["cross_kv"]
    aux = 0.0
    if p.norm2 is not None:
        h2 = _apply_norm(cfg, SH.norm(sh, p.norm2, sp), x)
        if p.moe is not None:
            out2, aux = SH.moe(sh, p.moe, h2, cfg, sp)
        else:
            out2 = SH.mlp(sh, p.mlp, h2, cfg.act, sp)
        x = x + out2
    return x, None if entry is None else new, aux


def _make_cross_kv(cfg: ModelConfig, w, memory):
    """A cross layer's K and V, each (B, T, KV, hd), from ``memory``
    (B, T, d_model) and its cross weights ``w`` (on a mesh, this rank's
    heads)."""
    B, T, _ = memory.shape
    k = (memory @ w["wk"]).reshape(B, T, -1, cfg.hd)
    v = (memory @ w["wv"]).reshape(B, T, -1, cfg.hd)
    return k, v


def _encode(params: Model, cfg: ModelConfig, enc_input):
    """The whisper encoder over precomputed frame embeddings (the conv
    frontend is a stub): non-causal attention without RoPE, never through
    the flash kernel, and an MLP per layer, then ``enc_norm_f``."""
    sh = D.shard_ctx(params)
    x = enc_input.to(cfg.tdtype)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device).expand(B, T)
    acfg = L.AttnCfg(d_model=cfg.d_model, n_heads=cfg.n_heads,
                     n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                     causal=False, use_rope=False)
    for p in params.encoder:
        h = _apply_norm(cfg, SH.norm(sh, p.norm1), x)
        x = x + SH.self_attn(sh, p.attn, acfg, h, positions, False)
        h2 = _apply_norm(cfg, SH.norm(sh, p.norm2), x)
        x = x + SH.mlp(sh, p.mlp, h2, cfg.act)
    return _apply_norm(cfg, SH.norm(sh, params.enc_norm_f), x)


def _memory(params: Model, cfg: ModelConfig, extra):
    """What the cross layers attend over: the encoder's output (``encdec``)
    or the projected patches (``vlm``); None for ``lm``, which ignores
    ``extra``."""
    if cfg.family == "lm":
        return None
    if extra is None:
        raise ValueError(f"{cfg.arch}: the {cfg.family!r} family needs its "
                         f"frontend stub input, extra")
    if cfg.family == "encdec":
        return _encode(params, cfg, extra)
    return extra.to(cfg.tdtype) @ D.shard_ctx(params).weight(
        params.vision_proj)


def _vocab_part(sh, n: int):
    """(first row, rows) of this rank's part of a vocabulary of ``n``
    split over "model"."""
    if n % sh.tp:
        raise ValueError(f"a vocabulary of {n} does not divide over "
                         f"{sh.tp} ranks")
    return sh.tp_rank * (n // sh.tp), n // sh.tp


def _embed(params: Model, cfg: ModelConfig, tokens):
    """The lookup; on a mesh vocab-parallel: each rank's rows of the
    table, masked, summed over "model" (one rank adds the row, the others
    zeros)."""
    sh = D.shard_ctx(params)
    tab = sh.weight(params.embed, 0)
    if sh.tp == 1:
        x = tab[tokens]
    else:
        lo, vl = _vocab_part(sh, params.embed.shape[0])
        mine = (tokens >= lo) & (tokens < lo + vl)
        x = tab[torch.clamp(tokens - lo, 0, vl - 1)] * \
            mine[..., None].to(tab.dtype)
        x = sh.exit(x)
    if cfg.norm == "rms":  # sqrt(d_model) rounded to the activation dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(cfg.tdtype)


def _logits_local(params: Model, cfg: ModelConfig, x):
    """Logits of this rank's vocabulary slice (all of it off a mesh); the
    final softcap in float32."""
    sh = D.shard_ctx(params)
    if params.unembed is not None:
        w = sh.weight(params.unembed, 1)
    else:
        w = sh.weight(params.embed, 0).T
    logits = sh.enter(x) @ w
    if cfg.final_softcap > 0:
        logits = L.softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits


def logits_from_hidden(params: Model, cfg: ModelConfig, x):
    """Unembed hidden states (tied or not); the final softcap in float32.
    On a mesh every rank gets its rows' logits over the whole
    vocabulary."""
    return D.shard_ctx(params).tp_gather(_logits_local(params, cfg, x), -1,
                                         partial=False)


def _layer_out(p: Block, cfg: ModelConfig, x, positions, use_flash: bool,
               memory, sp: bool = False):
    x, _, aux = _layer(p, cfg, x, positions, use_flash=use_flash,
                       memory=memory, sp=sp)
    return x, aux


#: sequence parallelism (the reference's perf iteration #1): a spec such
#: as ("data", "model", None) splits the residual stream between the
#: sub-layers over "model" along the sequence, so that each
#: tensor-parallel part gathers it on entry and reduce-scatters its output
#: (half the bytes of the all-reduce) and activations are stored split.
#: Set with :func:`set_activation_sharding`; it applies on a mesh whose
#: "model" axis divides the sequence.
ACTIVATION_SPEC: Optional[tuple] = None

def set_activation_sharding(spec: Optional[tuple]):
    global ACTIVATION_SPEC
    ACTIVATION_SPEC = None if spec is None else tuple(spec)


def _constrain(params: Model, x):
    """(x, sp): the residual stream as :data:`ACTIVATION_SPEC` lays it out
    -- this rank's slice of the sequence (``sp`` True) where it splits the
    sequence over the mesh's "model" axis, else ``x`` as it is."""
    if not D.shard_ctx(params).sp_ok(x):
        return x, False
    return params.shard.rep_out(x, True), True


def hidden_forward(params: Model, cfg: ModelConfig, tokens, extra=None,
                   use_flash: bool = True):
    """Embed -> layers -> final norm.  Returns (hidden, aux); aux is the
    sum of the MoE layers' balance losses, 0.0 without MoE.  The cross
    families attend over ``extra``'s encoding or projection, made once.
    Under ``cfg.remat`` a layer keeps only its input for the backward pass
    and runs again there."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    memory = _memory(params, cfg, extra)
    remat = cfg.remat and torch.is_grad_enabled()
    x, sp = _constrain(params, x)
    aux = 0.0
    for blk in params.blocks:
        if remat:
            x, a = checkpoint(_layer_out, blk, cfg, x, positions, use_flash,
                              memory, sp, use_reentrant=False)
        else:
            x, a = _layer_out(blk, cfg, x, positions, use_flash, memory, sp)
        aux = aux + a
    x = _apply_norm(cfg, SH.norm(D.shard_ctx(params), params.norm_f, sp),
                    x)
    if sp:    # the whole sequence again for the unembedding
        x = params.shard.rep_in(x, True)
    return x, aux


def forward(params: Model, cfg: ModelConfig, tokens, extra=None,
            use_flash: bool = True):
    x, aux = hidden_forward(params, cfg, tokens, extra, use_flash)
    return logits_from_hidden(params, cfg, x), aux


def _chunk_loss(params: Model, cfg: ModelConfig, x, labels):
    """Summed negative log-likelihood of the labelled positions of one
    chunk, and their count.  The label logit is gathered (the reference
    contracts with a one-hot: the same number, exactly); on a mesh the
    vocabulary is split over "model": a vocab-parallel label logit and
    log-sum-exp."""
    sh = D.shard_ctx(params)
    lg = _logits_local(params, cfg, x).to(torch.float32)
    lbl = torch.clamp(labels, min=0)
    if sh.tp == 1:
        label_logit = torch.gather(lg, -1, lbl[..., None])[..., 0]
        ll = label_logit - torch.logsumexp(lg, dim=-1)
    else:
        lo, vl = _vocab_part(sh, params.embed.shape[0])
        mine = (lbl >= lo) & (lbl < lo + vl)
        part = torch.gather(lg, -1, torch.clamp(lbl - lo, 0, vl - 1)[
            ..., None])[..., 0]
        label_logit = sh.exit(torch.where(mine, part, 0.0))
        m = sh.tp_max(lg.amax(-1, keepdim=True))
        se = sh.exit(torch.exp(lg - m).sum(-1))
        ll = label_logit - (m[..., 0] + torch.log(se))
    mask = (labels >= 0).to(torch.float32)
    return -(ll * mask).sum(), mask.sum()


def loss_fn(params: Model, cfg: ModelConfig, batch: Mapping[str, Any],
            use_flash: bool = True, seq_chunk: int = 2048):
    """Next-token loss: the mean over positions whose label is not -1,
    plus 0.01 x aux.  For ``S > seq_chunk`` with ``S % seq_chunk == 0`` the
    unembed and softmax run chunk by chunk over the sequence, as the
    reference's scan does.  ``batch`` holds ``tokens`` and ``labels``
    (B, S) integer tensors on the model's device, and ``extra`` where the
    family has a frontend."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    x, aux = hidden_forward(params, cfg, tokens, batch.get("extra"),
                            use_flash)
    if S > seq_chunk and S % seq_chunk == 0:
        tot = cnt = 0.0
        for c in range(S // seq_chunk):
            sl = slice(c * seq_chunk, (c + 1) * seq_chunk)
            t, n = _chunk_loss(params, cfg, x[:, sl], labels[:, sl])
            tot, cnt = tot + t, cnt + n
    else:
        tot, cnt = _chunk_loss(params, cfg, x, labels)
    # on a mesh this rank's share of the global mean
    cnt = D.shard_ctx(params).dp_sum_nograd(cnt)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _entry_init(cfg: ModelConfig, kind: str, has_cross: bool, batch: int,
                max_len: int, device) -> Dict[str, Any]:
    if kind.startswith("attn"):
        acfg = _attn_cfg(cfg, kind)
        eff = min(max_len, cfg.window) if acfg.window else max_len
        entry = {"kv": L.kv_cache_init(acfg, batch, eff, cfg.tdtype,
                                       device)}
    elif kind == "rglru":
        entry = {"state": L.rglru_state_init(batch, _d_rnn(cfg),
                                             dtype=cfg.tdtype, device=device)}
    elif kind == "mlstm":
        entry = {"state": L.mlstm_state_init(batch, cfg.d_model, cfg.n_heads,
                                             device)}
    else:
        entry = {"state": L.slstm_state_init(batch, cfg.d_model, device)}
    if has_cross:
        shape = (batch, cfg.enc_ctx if cfg.family == "encdec"
                 else cfg.n_patches, cfg.n_kv_heads, cfg.hd)
        entry["cross_kv"] = tuple(
            torch.zeros(shape, dtype=cfg.tdtype, device=device)
            for _ in range(2))
    return entry


def decode_init(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda", mesh=None) -> List[Dict[str, Any]]:
    """One entry per layer: ``{"kv": (k_buf, v_buf, length)}`` for
    attention (sliding-window layers keep a ring of ``min(max_len,
    window)`` slots), ``{"state": ...}`` for a recurrence (RG-LRU: the conv
    tail and h; mLSTM: C and n; sLSTM: h, c, n and m); a cross layer's
    entry adds ``"cross_kv"``, zeros of (batch, enc_ctx or n_patches, KV,
    hd) until :func:`prime_cross_kv` fills them.

    With ``mesh``, ``batch`` is the global batch and every tensor is a
    DTensor laid out by :func:`cache_specs` (this rank allocates only its
    shard); a batch that does not divide over the data axes is
    replicated over them (the reference's dry-run keeps "model"'s
    sequence split there), and so is a KV cache's sequence (its ring's
    slots) that does not divide over "model"."""
    check_supported(cfg)
    cross = _cross_layers(cfg)
    if mesh is None:
        return [_entry_init(cfg, kind, i in cross, batch, max_len, device)
                for i, kind in enumerate(cfg.pattern)]
    split_batch = batch % D.dp_size(mesh) == 0
    out = []
    for i, kind in enumerate(cfg.pattern):
        like = _entry_init(cfg, kind, i in cross, batch, max_len, "meta")
        spec = cache_specs(cfg)[i]
        if "kv" in like and like["kv"][0].shape[1] % D.tp_size(mesh):
            spec = dict(spec, kv=tuple(
                tuple(None if a == "model" else a for a in sp)
                for sp in spec["kv"]))
        entry = {}
        for k, v in like.items():
            entry[k] = tuple(
                t if not isinstance(t, torch.Tensor) else D.zeros_like_spec(
                    t, D.cache_spec(sp, mesh, split_batch), mesh, device)
                for t, sp in zip(v, spec[k]))
        if kind == "slstm":   # n starts at ones
            entry["state"][2].to_local().fill_(1.0)
        out.append(entry)
    return out


def prime_cross_kv(params: Model, cfg: ModelConfig, cache, extra):
    """Fill each cross layer's ``cross_kv`` from ``extra`` (the encoder's
    output or the projected patches; prefill-time).  An ``lm`` cache comes
    back as it is."""
    memory = _memory(params, cfg, extra)
    if memory is None:
        return cache
    cache = list(cache)
    for i in sorted(_cross_layers(cfg)):
        cache[i] = dict(cache[i])
        blk = params.blocks[i]
        kv = _make_cross_kv(cfg, D.shard_ctx(blk).weights(blk.cross),
                            memory)
        cache[i]["cross_kv"] = tuple(
            SH.like(t, old) for t, old in zip(kv, cache[i]["cross_kv"]))
    return cache


def decode_step(params: Model, cfg: ModelConfig, tokens, position, cache):
    """tokens: (B, S); position: an int (every token at it) or a (B, S)
    tensor.  Returns (logits, cache); the KV buffers are updated in place,
    recurrent states replaced, cross K/V carried.  MoE layers' aux losses
    are dropped."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    if isinstance(position, torch.Tensor) and position.dim() > 0:
        positions = position
    else:
        positions = torch.full((B, S), int(position), device=x.device)
    new_cache = []
    for blk, entry in zip(params.blocks, cache):
        x, entry, _ = _layer(blk, cfg, x, positions, entry)
        new_cache.append(entry)
    x = _apply_norm(cfg, SH.norm(D.shard_ctx(params), params.norm_f), x)
    return logits_from_hidden(params, cfg, x), new_cache
