"""whisper-base [audio]: enc-dec, conv frontend stub [arXiv:2212.04356].

The audio frontend (mel conv stack) is a STUB: input_specs() provides
precomputed frame embeddings of shape (batch, enc_ctx, d_model).
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, head_dim=64, act="gelu", norm="ln",
    enc_layers=6, enc_ctx=1500, tie_embeddings=True)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, enc_ctx=32, remat=False)
