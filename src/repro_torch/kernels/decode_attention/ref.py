"""Plain PyTorch version of the paged decode kernel.

The CPU path of ``ops.py`` and the yardstick the CUDA kernel is held
against on the card.  Same signature and layout as the JAX oracle
``repro/kernels/decode_attention/ref.py::paged_decode_attention_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import gather_pages_ref

F32 = torch.float32
NEG_INF = -1e30


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
