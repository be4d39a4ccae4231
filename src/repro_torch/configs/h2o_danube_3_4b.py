"""h2o-danube-3-4b [dense]: llama+mistral mix, sliding-window attention
[arXiv:2401.16818] -> sub-quadratic, long_500k runs."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="h2o-danube-3-4b", family="lm",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab=32000, head_dim=120, act="swiglu", norm="rms",
    window=4096, layer_pattern=tuple(["attn_local"] * 24),
    subquadratic=True)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=32, layer_pattern=("attn_local",) * 2,
        remat=False)
