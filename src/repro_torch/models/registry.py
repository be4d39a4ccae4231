"""--arch <id> resolution: config + model functions + input builders."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig


def list_archs():
    return all_arch_ids()


def get_model(arch: str, smoke: bool = False):
    cfg = get_config(arch, smoke=smoke)
    return cfg, T


def extra_shape(cfg: ModelConfig, batch: int):
    """Shape of the modality-frontend stub input, if any."""
    if cfg.family == "encdec":
        return (batch, cfg.enc_ctx, cfg.d_model)
    if cfg.family == "vlm":
        return (batch, cfg.n_patches, cfg.vision_dim)
    return None


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               key: Union[None, int, np.random.Generator,
                          torch.Generator] = None,
               device="cuda"):
    """Concrete (smoke-test) batch: int64 tokens in ``[0, vocab)`` (labels
    the same), and the frontend stub input where the family has one.
    ``key`` is a numpy or torch generator or an int seed (numpy)."""
    if not isinstance(key, torch.Generator):
        rng = key if isinstance(key, np.random.Generator) \
            else np.random.default_rng(0 if key is None else key)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))
                                  ).to(device)
        es = extra_shape(cfg, batch)
        extra = None if es is None else torch.from_numpy(
            rng.normal(size=es).astype(np.float32) * 0.02).to(device)
    else:
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=key,
                               device=key.device).to(device)
        es = extra_shape(cfg, batch)
        extra = None if es is None else (torch.randn(
            es, generator=key, device=key.device) * 0.02).to(device)
    out = {"tokens": tokens, "labels": tokens}
    if extra is not None:
        out["extra"] = extra
    return out


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SWA/hybrid/recurrent)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
