"""gemma2-9b [dense]: local+global alternating, logit softcap
[arXiv:2408.00118]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="gemma2-9b", family="lm",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab=256000, head_dim=256, act="geglu", norm="rms",
    window=4096,
    layer_pattern=tuple("attn_local" if i % 2 == 0 else "attn"
                        for i in range(42)),
    attn_softcap=50.0, final_softcap=30.0)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, window=32,
        layer_pattern=("attn_local", "attn"), remat=False)
