"""granite-moe-1b-a400m [moe]: 32 experts top-8 [hf:ibm-granite]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-1b-a400m", family="lm",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64, act="swiglu", norm="rms",
    moe_experts=32, moe_top_k=8)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab=256, moe_experts=4, moe_top_k=2, remat=False)
