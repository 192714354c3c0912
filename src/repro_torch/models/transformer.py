"""Decoder layer of the dense family."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    attention_block,
    attn_specs,
    mlp_block,
    mlp_specs,
    norm_spec,
    rms_norm,
)


def dense_layer_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    return {
        "attn_norm": norm_spec(cfg.d_model),
        "attn": attn_specs(cfg),
        "mlp_norm": norm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg, d_ff=d_ff),
    }


def dense_layer(lp, x, cfg: ArchConfig, *, mode: str, cache=None, pos=None):
    """Pre-norm attention + MLP with residuals.  Returns (x, new_cache)."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, new_cache = attention_block(lp["attn"], h, cfg, mode=mode,
                                   cache=cache, pos=pos)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    x = x + mlp_block(lp["mlp"], h, cfg)
    return x, new_cache
