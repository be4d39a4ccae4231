"""llama-3.2-vision-11b [vlm]: cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].  Vision frontend is a stub:
input_specs provides precomputed patch embeddings."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, act="swiglu", norm="rms",
    cross_attn_every=5, n_patches=1601, vision_dim=1280)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, cross_attn_every=2, n_patches=16, vision_dim=32,
        remat=False)
