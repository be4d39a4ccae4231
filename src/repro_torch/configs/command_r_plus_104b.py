"""command-r-plus-104b [dense]: GQA, no-bias [hf:CohereForAI]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="command-r-plus-104b", family="lm",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab=256000, head_dim=128, act="swiglu", norm="rms",
    tie_embeddings=True)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab=256, remat=False)
