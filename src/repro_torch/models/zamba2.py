"""Zamba2 hybrid: Mamba-2 backbone + a weight-shared attention block.

Every ``cfg.hybrid_attn_every`` SSM layers, one shared transformer block
(attention + MLP) is applied to ``concat(x, x0)`` (x0 = the embedding-layer
output, the Zamba concat trick), projected back to d_model and added to the
residual stream.  The shared block's weights serve every invocation; each
invocation keeps its own KV cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    KVSlice,
    attention_block,
    attn_specs,
    mlp_block,
    mlp_specs,
    norm_spec,
    rms_norm,
)
from repro_torch.models.mamba2 import MambaState, mamba_block, mamba_specs
from repro_torch.models.param import PSpec
from repro_torch.sharding.collectives import relayout
from repro_torch.sharding.rules import P


def shared_block_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "proj_in": PSpec((2 * d, d), ("embed", None), ("normal", 0)),
        "attn_norm": norm_spec(d),
        "attn": attn_specs(cfg),
        "mlp_norm": norm_spec(d),
        "mlp": mlp_specs(cfg),
        "proj_out": PSpec((d, d), (None, "embed"), ("normal", 0)),
    }


def mamba_layer_specs(cfg: ArchConfig) -> dict:
    return {"norm": norm_spec(cfg.d_model), "mamba": mamba_specs(cfg)}


class ZambaGroupCache(NamedTuple):
    mamba: MambaState          # stacked over the group's SSM layers
    shared: KVSlice            # this invocation's KV cache


def shared_block(sp, x, x0, cfg: ArchConfig, *, mode: str,
                 cache: Optional[KVSlice] = None, pos=None, ctx=None
                 ) -> Tuple[torch.Tensor, Optional[KVSlice]]:
    if ctx is not None and ctx.sharded:
        sp = {**sp, **{k: relayout(sp[k], P(None, None))
                       for k in ("proj_in", "proj_out")}}
    h = torch.cat([x, x0], dim=-1) @ sp["proj_in"]
    h1 = rms_norm(h, sp["attn_norm"], cfg.rms_eps)
    a, new_cache = attention_block(sp["attn"], h1, cfg, mode=mode,
                                   cache=cache, pos=pos, ctx=ctx)
    h = h + a
    h2 = rms_norm(h, sp["mlp_norm"], cfg.rms_eps)
    h = h + mlp_block(sp["mlp"], h2, cfg, ctx)
    return x + h @ sp["proj_out"], new_cache


def mamba_layer(lp, x, cfg: ArchConfig, *, mode: str,
                state: Optional[MambaState] = None, mask=None,
                ckpt_every: Optional[int] = None,
                ckpt_out: Optional[MambaState] = None, ctx=None):
    """Pre-norm residual Mamba layer: (x + mamba(norm(x)), new state)."""
    h = rms_norm(x, lp["norm"], cfg.rms_eps)
    y, new_state = mamba_block(lp["mamba"], h, cfg, mode=mode, state=state,
                               mask=mask, ckpt_every=ckpt_every,
                               ckpt_out=ckpt_out, ctx=ctx)
    return x + y, new_state
