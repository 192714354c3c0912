"""Distributed flash-decode: attention over a sequence-sharded KV cache.

With ``decode_kv_shard_seq`` the cache's sequence dim is sharded over the
model (and, for batch-1 long-context cells, also the data) axis.  Without
this module the port does what GSPMD does: it all-gathers the per-layer
cache every step (``layers._decode_seq_gathered``), about the cache's
bytes per position per layer per token.  Here each position computes a
*partial* softmax (m, l, acc) over its local KV rows and the positions
merge with an LSE combine, ``pmax`` of the max and ``psum`` of (l, acc):
O(B*H*Dh) bytes instead of O(B*S*H*Dh).  The cache-slot write is local too
(only the owning shard writes).  The port of
``repro/models/sharded_decode.py``: its ``shard_map`` body runs per
position on :class:`~repro_torch.sharding.sharded.Sharded` values.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import NEG_INF, KVSlice
from repro_torch.sharding.collectives import axis_index, pmax, psum

F32 = torch.float32


def seq_axes(ctx, cache: KVSlice) -> Tuple[str, ...]:
    """Mesh axes the cache's seq dim (dim 1) is sharded over under the
    rules (``batch``, ``kv_seq``): () when it is not."""
    return ctx.pspec(("batch", "kv_seq", None, None),
                     cache.k.global_shape).axes_of(1)


def owner_write(ctx, cache: KVSlice, new_k, new_v, pos, *,
                window: Optional[int] = None):
    """Write each row's new token (new_k / new_v (B, 1, Hkv, Dh), every
    head) into its slot of a cache split on its sequence dim, in place:
    only the position whose block holds the slot writes.  Rows and
    positions are batch-local Sharded values."""
    axes = cache.k.spec.axes_of(1)
    S_c = cache.k.global_shape[1]
    B_l, S_loc = cache.k.shape[:2]
    if window is not None and S_c <= window:
        slot = pos.long() % S_c
    else:
        slot = pos.long().clamp(max=S_c - 1)
    idx = slot.sub(axis_index(ctx.mesh, axes), alpha=S_loc)
    mine = (idx >= 0) & (idx < S_loc)
    safe = idx.clamp(0, S_loc - 1)
    bidx = torch.arange(B_l, device=new_k.device)
    for dst, new in ((cache.k, new_k[:, 0]), (cache.v, new_v[:, 0]),
                     (cache.slot_pos, pos.to(cache.slot_pos.dtype))):
        mask = mine.reshape(mine.shape + (1,) * (new.dim() - 1))
        dst[bidx, safe] = torch.where(mask, new, dst[bidx, safe])


def sharded_decode_attention(ctx, q, cache: KVSlice, new_k, new_v, pos, *,
                             window: Optional[int] = None):
    """q: (B,1,Hq,Dh) every head; cache k/v: (B,S_c,Hkv,Dh) sharded on seq
    (local (B_l, S_loc, Hkv, Dh)); new_k/v: (B,1,Hkv,Dh); pos: (B,)
    absolute positions, all batch-local Sharded values.  Writes the new
    token in place at its owning shard and returns (out (B,1,Hq,Dh), the
    cache)."""
    axes = seq_axes(ctx, cache)
    if not axes:
        raise ValueError("cache seq dim is not sharded; use the ref path")
    B_l, _, Hkv, Dh = cache.k.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    owner_write(ctx, cache, new_k, new_v, pos, window=window)
    k_c, v_c, sp = cache

    # --- local partial softmax -----------------------------------------
    qg = q[:, 0].reshape(B_l, Hkv, G, Dh).to(F32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_c.to(F32)) * scale
    kv_len = pos + 1
    valid = (sp >= 0) & (sp < kv_len[:, None])
    if window is not None:
        valid &= sp > (kv_len[:, None] - 1 - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m_l = s.amax(dim=-1)                                     # (B,Hkv,G)
    p_ = torch.exp(s - m_l[..., None])
    p_ = torch.where(valid[:, None, None], p_, 0.0)
    l_l = p_.sum(dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p_, v_c.to(F32))

    # --- LSE combine across seq shards ----------------------------------
    m_g = pmax(m_l, axes)
    corr = torch.exp(m_l - m_g)
    l_g = psum(l_l * corr, axes)
    acc_g = psum(acc * corr[..., None], axes)
    out = acc_g / l_g.clamp(min=1e-30)[..., None]
    return out.reshape(B_l, 1, Hq, Dh).to(q.dtype), cache
