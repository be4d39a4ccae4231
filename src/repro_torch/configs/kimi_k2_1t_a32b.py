"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2 paper-table]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="kimi-k2-1t-a32b", family="lm",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112, act="swiglu", norm="rms",
    moe_experts=384, moe_top_k=8)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=256, moe_experts=8, moe_top_k=2, remat=False)
