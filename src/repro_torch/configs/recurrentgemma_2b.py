"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2
[arXiv:2402.19427] -> sub-quadratic, long_500k runs."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-2b", family="lm",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, act="geglu", norm="rms",
    window=2048,
    layer_pattern=tuple("attn_local" if i % 3 == 2 else "rglru"
                        for i in range(26)),
    subquadratic=True)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, window=32,
        layer_pattern=("rglru", "rglru", "attn_local"), remat=False)
