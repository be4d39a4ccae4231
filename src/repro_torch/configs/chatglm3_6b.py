"""chatglm3-6b [dense]: 2d (partial) RoPE, GQA kv=2 [arXiv:2406.12793]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="chatglm3-6b", family="lm",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128, act="swiglu", norm="rms",
    rotary_frac=0.5)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, remat=False)
