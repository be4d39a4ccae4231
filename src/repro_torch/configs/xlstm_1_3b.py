"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517] ->
recurrent, long_500k runs.  Attention-free: KV tiering inapplicable
(DESIGN.md §Arch-applicability)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="xlstm-1.3b", family="lm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=512, act="swiglu", norm="rms",
    layer_pattern=tuple("slstm" if i % 8 == 7 else "mlstm"
                        for i in range(48)),
    subquadratic=True)


def smoke_config():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab=256, layer_pattern=("mlstm", "slstm"), remat=False)
