"""The decoder-only LM, in PyTorch.

A port of the reference package's ``repro.models.transformer`` for
``family="lm"``: attention blocks (``attn``, ``attn_local``) for chatglm3-6b,
gemma2-9b, h2o-danube-3-4b and command-r-plus-104b, with a mixture of
experts in place of the MLP (``cfg.moe_experts``) for granite-moe-1b-a400m
and kimi-k2-1t-a32b, and recurrent blocks (``rglru``, ``mlstm``, ``slstm``)
for recurrentgemma-2b (RG-LRU with local attention) and xlstm-1.3b.  Only
attention blocks carry an MLP, as in the reference.  The model is an
``nn.Module`` (:class:`Model`: the embedding, a ``ModuleList`` of
:class:`Block` and the final norm); a Python loop over the layers takes the
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
  decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)

``aux`` is the sum over MoE layers of the Switch load-balancing loss (0.0
without MoE).  A decode cache entry is ``{"kv": ...}`` for an attention
layer and ``{"state": ...}`` for a recurrent one.  The encoder-decoder and
vision families (cross-attention) raise ``NotImplementedError`` (ROADMAP
queue 1 item 6).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import ModelConfig

#: the ROADMAP queue 1 item that ports what the port does not run yet
_NOT_PORTED = "ROADMAP.md queue 1 item 6: cross-attention (encdec, vlm)"
#: the recurrent block kinds
RNN_KINDS = ("rglru", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    the encoder-decoder and vision families."""
    if cfg.family != "lm":
        raise NotImplementedError(
            f"{cfg.arch}: {cfg.family!r} is not ported to repro_torch yet "
            f"({_NOT_PORTED})")
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
    """One decoder layer: norm1, then attention (``attn*`` kinds) or a
    recurrence (``rnn``: RG-LRU, mLSTM or sLSTM); attention layers with
    ``d_ff > 0`` add norm2 and an MLP or a mixture of experts."""

    def __init__(self, kind: str, norm1,
                 attn: Optional[Mapping[str, torch.Tensor]] = None,
                 norm2=None, mlp: Optional[Mapping[str, torch.Tensor]] = None,
                 moe: Optional[Mapping[str, torch.Tensor]] = None,
                 rnn: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        self.kind = kind
        self.norm1 = _norm_module(norm1)
        self.attn = _params(attn)
        self.rnn = _params(rnn)
        self.norm2 = None if norm2 is None else _norm_module(norm2)
        self.mlp = _params(mlp)
        self.moe = _params(moe)


class Model(nn.Module):
    """Embedding (``padded_vocab x d_model``), blocks and the final norm;
    ``unembed`` only when the config does not tie embeddings."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, norm_f,
                 blocks: Sequence[Block],
                 unembed: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.unembed = None if unembed is None else _frozen(unembed)
        self.norm_f = _norm_module(norm_f)
        self.blocks = nn.ModuleList(blocks)


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


def init_layer(gen, cfg: ModelConfig, kind: str, device) -> Block:
    dt = cfg.tdtype
    attn = rnn = norm2 = mlp = moe = None
    if kind.startswith("attn"):
        attn = L.attn_init(gen, _attn_cfg(cfg, kind), dt, device)
    elif kind == "rglru":
        rnn = L.rglru_init(gen, cfg.d_model, _d_rnn(cfg), cfg.n_heads,
                           dtype=dt, device=device)
    elif kind == "mlstm":
        rnn = L.mlstm_init(gen, cfg.d_model, cfg.n_heads, dt, device)
    else:
        rnn = L.slstm_init(gen, cfg.d_model, cfg.n_heads, dt, device)
    if cfg.d_ff > 0 and kind.startswith("attn"):
        norm2 = _norm_init(cfg, cfg.d_model, device)
        if cfg.moe_experts:
            moe = L.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe_experts, dt,
                             device)
        else:
            mlp = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, device)
    return Block(kind, _norm_init(cfg, cfg.d_model, device), attn, norm2, mlp,
                 moe, rnn)


def init(key, cfg: ModelConfig, device="cuda") -> Model:
    """Random weights made on ``device``.  ``key`` is a ``torch.Generator``
    on that device or an int seed.  The numbers differ from the reference's
    ``init`` (another generator); :func:`params_from_jax` carries those."""
    check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(key))
    dt = cfg.tdtype
    embed = L.dense_init(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    unembed = None if cfg.tie_embeddings else \
        L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt, device)
    norm_f = _norm_init(cfg, cfg.d_model, device)
    blocks = [init_layer(gen, cfg, kind, device) for kind in cfg.pattern]
    return Model(cfg, embed, norm_f, blocks, unembed)


# ---------------------------------------------------------------------------
# weights from the reference
# ---------------------------------------------------------------------------

def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 as ml_dtypes.bfloat16, bits kept) as a tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(p, fn):
    if isinstance(p, Mapping):
        return {k: _tree(v, fn) for k, v in p.items()}
    return fn(p)


def params_from_jax(params_np: Mapping[str, Any], cfg: ModelConfig,
                    device="cuda") -> Model:
    """The reference's parameter tree (as numpy arrays) as the port's model.

    ``params_np["blocks"][k]`` holds pattern offset ``k`` stacked over
    ``n_layers // period`` groups; group ``g`` becomes layer
    ``g * period + k``."""
    check_supported(cfg)
    period = pattern_period(cfg)
    n_groups = cfg.n_layers // period

    def conv(a):
        return _tensor(a, device)

    blocks: List[Optional[Block]] = [None] * cfg.n_layers
    for k in range(period):
        stacked = params_np["blocks"][k]
        for g in range(n_groups):
            p = _tree(stacked, lambda a, g=g: conv(np.asarray(a)[g]))
            blocks[g * period + k] = Block(
                cfg.pattern[k], p["norm1"], p.get("attn"), p.get("norm2"),
                p.get("mlp"), p.get("moe"), p.get("rnn"))
    unembed = params_np.get("unembed")
    return Model(cfg, conv(params_np["embed"]),
                 _tree(params_np["norm_f"], conv), blocks,
                 None if unembed is None else conv(unembed))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _rnn_apply(p: Block, cfg: ModelConfig, h, state):
    """The layer's recurrence from ``state`` (None: from zeros); returns
    (out, new state)."""
    if p.kind == "rglru":
        return L.rglru_apply(p.rnn, h, state)
    if p.kind == "mlstm":
        return L.mlstm_apply(p.rnn, h, cfg.n_heads, state)
    return L.slstm_apply(p.rnn, h, state)


def _layer(p: Block, cfg: ModelConfig, x, positions,
           entry: Optional[Dict[str, Any]] = None, use_flash: bool = True):
    """One layer; prefill without a cache entry, decode with one.  Returns
    (x, the layer's new entry or None, its MoE aux loss or 0.0)."""
    h = _apply_norm(cfg, p.norm1, x)
    if p.attn is not None:
        out, kv = L.attn_apply(p.attn, _attn_cfg(cfg, p.kind), h, positions,
                               kv_cache=None if entry is None else
                               entry["kv"], use_flash=use_flash)
        new = {"kv": kv}
    else:
        out, state = _rnn_apply(p, cfg, h,
                                None if entry is None else entry["state"])
        new = {"state": state}
    x = x + out
    aux = 0.0
    if p.norm2 is not None:
        h2 = _apply_norm(cfg, p.norm2, x)
        if p.moe is not None:
            out2, aux = L.moe_apply(p.moe, h2, cfg.moe_experts,
                                    cfg.moe_top_k)
        else:
            out2 = L.mlp_apply(p.mlp, h2, cfg.act)
        x = x + out2
    return x, None if entry is None else new, aux


def _embed(params: Model, cfg: ModelConfig, tokens, extra):
    if extra is not None:
        raise NotImplementedError(f"{cfg.arch}: no modality frontend in "
                                  f"repro_torch ({_NOT_PORTED})")
    x = params.embed[tokens]
    if cfg.norm == "rms":  # sqrt(d_model) rounded to the activation dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(cfg.tdtype)


def logits_from_hidden(params: Model, cfg: ModelConfig, x):
    """Unembed hidden states (tied or not); the final softcap in float32."""
    w = params.unembed if params.unembed is not None else params.embed.T
    logits = x @ w
    if cfg.final_softcap > 0:
        logits = L.softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits


def _layer_out(p: Block, cfg: ModelConfig, x, positions, use_flash: bool):
    x, _, aux = _layer(p, cfg, x, positions, use_flash=use_flash)
    return x, aux


def hidden_forward(params: Model, cfg: ModelConfig, tokens, extra=None,
                   use_flash: bool = True):
    """Embed -> layers -> final norm.  Returns (hidden, aux); aux is the
    sum of the MoE layers' balance losses, 0.0 without MoE.  Under
    ``cfg.remat`` a layer keeps only its input for the backward pass and
    runs again there."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, extra)
    positions = torch.arange(S, device=x.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for blk in params.blocks:
        if remat:
            x, a = checkpoint(_layer_out, blk, cfg, x, positions, use_flash,
                              use_reentrant=False)
        else:
            x, a = _layer_out(blk, cfg, x, positions, use_flash)
        aux = aux + a
    return _apply_norm(cfg, params.norm_f, x), aux


def forward(params: Model, cfg: ModelConfig, tokens, extra=None,
            use_flash: bool = True):
    x, aux = hidden_forward(params, cfg, tokens, extra, use_flash)
    return logits_from_hidden(params, cfg, x), aux


def _chunk_loss(params: Model, cfg: ModelConfig, x, labels):
    """Summed negative log-likelihood of the labelled positions of one
    chunk, and their count.  The label logit is gathered (the reference
    contracts with a one-hot: the same number, exactly)."""
    logits = logits_from_hidden(params, cfg, x).to(torch.float32)
    lbl = torch.clamp(labels, min=0)
    label_logit = torch.gather(logits, -1, lbl[..., None])[..., 0]
    ll = label_logit - torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).to(torch.float32)
    return -(ll * mask).sum(), mask.sum()


def loss_fn(params: Model, cfg: ModelConfig, batch: Mapping[str, Any],
            use_flash: bool = True, seq_chunk: int = 2048):
    """Next-token loss: the mean over positions whose label is not -1,
    plus 0.01 x aux.  For ``S > seq_chunk`` with ``S % seq_chunk == 0`` the
    unembed and softmax run chunk by chunk over the sequence, as the
    reference's scan does.  ``batch`` holds ``tokens`` and ``labels``
    (B, S) integer tensors on the model's device."""
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
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _entry_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                device) -> Dict[str, Any]:
    if kind.startswith("attn"):
        acfg = _attn_cfg(cfg, kind)
        eff = min(max_len, cfg.window) if acfg.window else max_len
        return {"kv": L.kv_cache_init(acfg, batch, eff, cfg.tdtype, device)}
    if kind == "rglru":
        return {"state": L.rglru_state_init(batch, _d_rnn(cfg),
                                            dtype=cfg.tdtype, device=device)}
    if kind == "mlstm":
        return {"state": L.mlstm_state_init(batch, cfg.d_model, cfg.n_heads,
                                            device)}
    return {"state": L.slstm_state_init(batch, cfg.d_model, device)}


def decode_init(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> List[Dict[str, Any]]:
    """One entry per layer: ``{"kv": (k_buf, v_buf, length)}`` for
    attention (sliding-window layers keep a ring of ``min(max_len,
    window)`` slots), ``{"state": ...}`` for a recurrence (RG-LRU: the conv
    tail and h; mLSTM: C and n; sLSTM: h, c, n and m)."""
    check_supported(cfg)
    return [_entry_init(cfg, kind, batch, max_len, device)
            for kind in cfg.pattern]


def decode_step(params: Model, cfg: ModelConfig, tokens, position, cache):
    """tokens: (B, S); position: an int (every token at it) or a (B, S)
    tensor.  Returns (logits, cache); the KV buffers are updated in place,
    recurrent states replaced.  MoE layers' aux losses are dropped."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, None)
    if isinstance(position, torch.Tensor) and position.dim() > 0:
        positions = position
    else:
        positions = torch.full((B, S), int(position), device=x.device)
    new_cache = []
    for blk, entry in zip(params.blocks, cache):
        x, entry, _ = _layer(blk, cfg, x, positions, entry)
        new_cache.append(entry)
    x = _apply_norm(cfg, params.norm_f, x)
    return logits_from_hidden(params, cfg, x), new_cache
