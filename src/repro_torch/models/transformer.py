"""Decoder layers of the dense and MoE families."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_mod
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


def moe_layer_specs(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": norm_spec(cfg.d_model),
        "attn": attn_specs(cfg),
        "mlp_norm": norm_spec(cfg.d_model),
        "moe": moe_mod.moe_specs(cfg),
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


def moe_layer(lp, x, cfg: ArchConfig, *, mode: str, cache=None, pos=None):
    """Pre-norm attention + MoE FFN with residuals.  Returns (x,
    new_cache); the serving modes drop the load-balance loss."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, new_cache = attention_block(lp["attn"], h, cfg, mode=mode,
                                   cache=cache, pos=pos)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    y, _aux = moe_mod.moe_block(lp["moe"], h, cfg, train=False)
    return x + y, new_cache
