"""ModelConfig: one dataclass covering all 10 assigned architectures (a copy
of the reference package's, with the activation dtype as a torch dtype)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                    # "lm" | "encdec" | "vlm"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"            # "swiglu" | "gelu"
    norm: str = "rms"              # "rms" | "ln"
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0       # chatglm3: 0.5 ("2d" partial rotary)
    window: int = 0                # sliding-window width for local layers
    layer_pattern: Tuple[str, ...] = ()   # per-layer block kinds
    moe_experts: int = 0
    moe_top_k: int = 0
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    tie_embeddings: bool = True
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_ctx: int = 1500            # audio frames after the conv frontend stub
    # vision (llama-3.2-vision)
    cross_attn_every: int = 0      # insert cross-attn each k-th layer
    n_patches: int = 1601
    vision_dim: int = 1280
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    # training-shape scan/microbatching knob (see train.step)
    microbatch: int = 0            # 0 = auto
    # whether long-context decode is sub-quadratic (SWA/recurrent)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables are padded to a multiple of 256 so the vocab dim
        divides the 16-way 'model' axis (standard vocab padding)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern:
            assert len(self.layer_pattern) == self.n_layers
            return self.layer_pattern
        return tuple(["attn"] * self.n_layers)

    @property
    def tdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def param_count(self) -> int:
        """Analytic parameter count (dense equivalents; for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.pattern:
            if kind.startswith("attn"):
                total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            elif kind == "rglru":
                r = int(d * 1.5)
                total += 2 * d * r + 2 * r * r + r * d
            elif kind == "mlstm":
                di = 2 * d
                total += d * di + 2 * d * d + d * di + di * d
            elif kind == "slstm":
                total += 8 * d * d + d * d
            if self.d_ff > 0 and kind.startswith("attn"):
                n_mats = 3 if self.act in ("swiglu", "geglu") else 2
                if self.moe_experts:
                    total += self.moe_experts * n_mats * d * self.d_ff \
                        + d * self.moe_experts
                else:
                    total += n_mats * d * self.d_ff
        if self.family == "encdec":
            # encoder layers (self-attn + mlp) + decoder cross-attn
            per_enc = 4 * d * d + 2 * d * self.d_ff
            total += self.enc_layers * per_enc + self.n_layers * 4 * d * d
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (4 * d * self.n_heads * self.hd) \
                + self.vision_dim * d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of experts)."""
        if not self.moe_experts:
            return self.param_count()
        d = self.d_model
        n_mats = 3 if self.act == "swiglu" else 2
        dense = self.param_count() - sum(
            self.moe_experts * n_mats * d * self.d_ff
            for k in self.pattern if k.startswith("attn"))
        active_moe = sum(self.moe_top_k * n_mats * d * self.d_ff
                         for k in self.pattern if k.startswith("attn"))
        return dense + active_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (arch x shape grid)."""
    name: str                      # train_4k / prefill_32k / decode_32k / long_500k
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
