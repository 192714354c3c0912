"""Encoder-decoder layers (SeamlessM4T backbone): the port of
``repro/models/encdec.py``.

Encoder: bidirectional self-attention + MLP over precomputed source frame
embeddings (the audio frontend is a stub), pad frames masked by the row's
``src_len``.  Decoder: causal self-attention (the KV of any cache plane:
dense or paged) + cross-attention to the encoder output + MLP.

Cross-attention reads a non-positional memory of ``src_len`` valid
frames.  On a CUDA tensor it runs the port's kernels: a query block
(prefill, extend) through the flash kernel, bidirectional under the
key-length mask, and one query a row (decode) through the dense split
decode kernel, whose live slots are ``[0, min(S_src, src_len))``; on a
CPU tensor the plain ``chunked_attention`` with the same mask, as JAX.

Over a mesh (a sharded ``ctx``) every layer runs tensor-parallel as the
decoder layers of the dense family do: the encoder's bidirectional
self-attention through ``attention_sharded`` under its ``kv_len`` mask,
cross-attention column-parallel on heads (``wq``, ``wk``, ``wv``) with a
row-parallel ``wo`` and a ``psum``, over cross memory laid out by heads
(each position its Hkv/m heads), and every MLP as ``mlp_block(ctx)``.
When the heads do not divide the model axis, attention runs replicated.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    _attn_want,
    attention_block,
    attn_specs,
    attn_tp,
    chunked_attention,
    decode_attention,
    flash_attention,
    mlp_block,
    mlp_specs,
    norm_spec,
    rms_norm,
)
from repro_torch.models.param import PSpec
from repro_torch.sharding.collectives import psum, relayout


def cross_attn_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": PSpec((d, hq, dh), ("embed", "heads", None), ("normal", 0)),
        "wk": PSpec((d, hkv, dh), ("embed", "kv_heads", None), ("normal", 0)),
        "wv": PSpec((d, hkv, dh), ("embed", "kv_heads", None), ("normal", 0)),
        "wo": PSpec((hq, dh, d), ("heads", None, "embed"), ("normal", 0)),
    }


def enc_layer_specs(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": norm_spec(cfg.d_model),
        "attn": attn_specs(cfg),
        "mlp_norm": norm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ArchConfig) -> dict:
    return {
        "attn_norm": norm_spec(cfg.d_model),
        "attn": attn_specs(cfg),
        "cross_norm": norm_spec(cfg.d_model),
        "cross": cross_attn_specs(cfg),
        "mlp_norm": norm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


class DecCache(NamedTuple):
    """The decoder's cache (per layer, or stacked (L, ...) in front).

    ``self_kv`` is the KV node (a KVSlice, or a PagedKVCache view); the
    cross memory and ``src_len`` are the *resident* part that stays dense
    per slot.  ``src_len`` 0 (the init value) masks every frame."""
    self_kv: Any
    cross_k: Any             # (B, S_src, Hkv, Dh)
    cross_v: Any
    src_len: Any             # (B,) int32 valid source frames


def enc_layer(lp, x, cfg: ArchConfig, src_len: Optional[torch.Tensor] = None,
              ctx=None):
    """Bidirectional encoder layer; ``src_len`` (B,) masks pad frames out
    of self-attention, so a row's encoding does not depend on how far its
    batch was padded (outputs AT pad frames are garbage, masked
    downstream by the same ``src_len``)."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, _ = attention_block(lp["attn"], h, cfg, mode="train", causal=False,
                           kv_len=src_len, ctx=ctx)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + mlp_block(lp["mlp"], h, cfg, ctx)


def _cross_local(cp, cfg: ArchConfig, ctx):
    """(cross weights in their compute layout: heads over ``model`` under
    TP, else whole; is it TP?)."""
    tp = attn_tp(cfg, ctx)
    return {k: relayout(v, _attn_want(k, v.dim(), tp, ctx.model_axis))
            for k, v in cp.items()}, tp


def cross_attend(cp, x, ck, cv, cfg: ArchConfig, src_len: torch.Tensor,
                 ctx=None):
    """x: (B, Sq, D); ck/cv: (B, S_src, Hkv, Dh) precomputed (over a mesh:
    each position's heads); attention over each row's first ``src_len``
    frames."""
    if ctx is not None and ctx.sharded:
        cl, tp = _cross_local(cp, cfg, ctx)
        y = cross_attend(cl, x, ck, cv, cfg, src_len)
        return psum(y, ctx.model_axis) if tp else y
    q = torch.einsum("bsd,dhk->bshk", x, cp["wq"])
    if not x.is_cuda:
        out = chunked_attention(q, ck, cv, causal=False,
                                q_chunk=cfg.attn_q_chunk,
                                kv_chunk=cfg.attn_kv_chunk, kv_len=src_len)
    elif q.shape[1] == 1 and not q.requires_grad:
        out = decode_attention(q, ck, cv, src_len)
    else:
        out = flash_attention(q, ck, cv, causal=False, kv_len=src_len)
    return torch.einsum("bshk,hkd->bsd", out, cp["wo"])


def cross_kv(cp, memory, cfg: Optional[ArchConfig] = None, ctx=None):
    """The cross memory (B, S_src, Hkv, Dh) K and V of encoder output
    ``memory``; over a mesh (``cfg`` and a sharded ``ctx``) each
    position's heads, all of them when attention runs replicated."""
    if ctx is not None and ctx.sharded:
        cp = _cross_local(cp, cfg, ctx)[0]
    ck = torch.einsum("bsd,dhk->bshk", memory, cp["wk"])
    cv = torch.einsum("bsd,dhk->bshk", memory, cp["wv"])
    return ck, cv


def dec_layer(lp, x, cfg: ArchConfig, *, mode: str,
              cache: Optional[DecCache] = None, pos=None, memory=None,
              src_len: Optional[torch.Tensor] = None, ctx=None):
    """One decoder layer over ``cache``, a per-layer DecCache of views.
    Cross-attention reads the cross memory and ``src_len`` the cache
    holds in every serving mode (``Model.encode_cross_into`` writes them),
    so the mask that shaped prefill cross-attention is replayed at every
    decode step; the self KV is updated in place by its attention mode.
    Returns (x, cache).  ``mode="train"`` takes no cache: the layer
    projects its cross K/V from the encoder ``memory`` (B, S_src, D),
    ``src_len`` (B,) masking its pad frames (None: all valid), and returns
    (x, None).  A sharded ``ctx`` runs the layer tensor-parallel (in
    every mode)."""
    if mode == "train":
        ck, cv = cross_kv(lp["cross"], memory, cfg, ctx)
        if src_len is None:
            src_len = torch.full((x.shape[0],), memory.shape[1],
                                 dtype=torch.int32, device=x.device)
        self_kv = None
    else:
        ck, cv, src_len = cache.cross_k, cache.cross_v, cache.src_len
        self_kv = cache.self_kv
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, _ = attention_block(lp["attn"], h, cfg, mode=mode, cache=self_kv,
                           pos=pos, ctx=ctx)
    x = x + a
    h = rms_norm(x, lp["cross_norm"], cfg.rms_eps)
    x = x + cross_attend(lp["cross"], h, ck, cv, cfg, src_len, ctx)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + mlp_block(lp["mlp"], h, cfg, ctx), cache
