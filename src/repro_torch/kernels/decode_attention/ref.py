"""Plain PyTorch versions of the dense and paged decode kernels.

The CPU path of ``ops.py`` and the yardstick the CUDA kernels are held
against on the card.  Same signatures and layouts as the JAX oracles
``repro/kernels/decode_attention/ref.py::decode_attention_ref`` (extended
by the ``slot_pos`` and ``window`` masks of
``repro/models/layers.py::decode_attention_ref``) and
``::paged_decode_attention_ref``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import gather_pages_ref

F32 = torch.float32
NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, kv_len, *, slot_pos=None,
                         window: Optional[int] = None):
    """q: (B, Hq, Dh); k/v_cache: (B, S, Hkv, Dh); kv_len: (B,) valid
    count; slot_pos: (B, S) int32 absolute position per slot (-1 empty),
    or None meaning slot i holds position i; window: attend only the last
    ``window`` positions.  A slot counts iff its position p has
    ``0 <= p < kv_len[b]`` and, with a window, ``p > kv_len[b]-1-window``.
    Returns (B, Hq, Dh)."""
    B, S, Hkv, Dh = k_cache.shape
    Hq = q.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Dh).to(F32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(F32)) / math.sqrt(Dh)
    if slot_pos is None:
        pos = torch.arange(S, device=q.device)[None].expand(B, S)
    else:
        pos = slot_pos
    kl = kv_len.long()[:, None]
    valid = (pos >= 0) & (pos < kl)
    if window is not None:
        valid &= pos > kl - 1 - window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(F32))
    return out.reshape(B, Hq, Dh).to(q.dtype)


def paged_decode_attention_ref(q, k_arena, v_arena, slot_pos, block_table,
                               kv_len, layer: int, *, k_scale=None,
                               v_scale=None):
    """q: (B, Hq, Dh); k/v_arena: (N, P, L, Hkv, Dh); slot_pos: (N, P, L);
    block_table: (B, n_log) int32, entries >= N unmapped; kv_len: (B,);
    layer: arena layer.  k/v_scale: (N, L) per-(page, layer) int8 scales
    or None.  A slot is attended iff its stored position is in
    [0, kv_len).  Returns (B, Hq, Dh)."""
    B, Hq, Dh = q.shape
    k, v, sp = gather_pages_ref(k_arena, v_arena, slot_pos, block_table,
                                layer, k_scale, v_scale)
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Dh).to(F32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.to(F32)) / math.sqrt(Dh)
    valid = (sp >= 0) & (sp < kv_len.long()[:, None])
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.to(F32))
    return out.reshape(B, Hq, Dh).to(q.dtype)
