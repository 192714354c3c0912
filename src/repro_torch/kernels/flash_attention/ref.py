"""Plain PyTorch versions of the flash-attention kernels.

The CPU path of ``ops.py`` and the yardstick the CUDA kernels are held
against on the card.  Same signatures and layouts as the JAX oracles in
``repro/kernels/flash_attention/ref.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

F32 = torch.float32
NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, kv_len=None):
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh) -> (B, Hq, Sq, Dh).

    GQA by head grouping (head h uses kv head h // (Hq//Hkv)); q positions
    are aligned to the end of the keys (offset Skv - Sq).  ``kv_len``
    (B,): key ``kp`` of row b counts iff ``kp < kv_len[b]``; a row left
    with no key gets the mean of V over all Skv keys, as JAX's finite
    ``NEG_INF`` gives it (the kernels store 0 there)."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kf = k.repeat_interleave(G, dim=1).to(F32)
    vf = v.repeat_interleave(G, dim=1).to(F32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), kf) / math.sqrt(Dh)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask = mask & (k_pos < kv_len.to(q.device).long()[:, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)


def gather_pages_ref(k_arena, v_arena, slot_pos, block_table, layer,
                     k_scale=None, v_scale=None):
    """Walk a block table: dense (B, n_log*P, Hkv, Dh) K/V and (B, n_log*P)
    slot positions of one arena layer.  Sentinel entries (>= N) read the
    clamped page with every slot masked (-1); int8 arenas dequantise with
    their per-(page, layer) scales."""
    N, P = k_arena.shape[0], k_arena.shape[1]
    B, n_log = block_table.shape
    bt = block_table.long()
    btc = bt.clamp(max=N - 1)
    k = k_arena[:, :, layer][btc]                      # (B, n_log, P, Hkv, Dh)
    v = v_arena[:, :, layer][btc]
    sp = slot_pos[:, :, layer][btc]                    # (B, n_log, P)
    if k_scale is not None:
        ks = k_scale[:, layer][btc]                    # (B, n_log)
        vs = v_scale[:, layer][btc]
        k = k.to(F32) * ks[..., None, None, None]
        v = v.to(F32) * vs[..., None, None, None]
    sp = torch.where((bt < N)[:, :, None], sp, -1)
    Hkv, Dh = k.shape[3], k.shape[4]
    return (k.reshape(B, n_log * P, Hkv, Dh), v.reshape(B, n_log * P, Hkv, Dh),
            sp.reshape(B, n_log * P))


def paged_extend_attention_ref(q, k_arena, v_arena, slot_pos, block_table,
                               pos, layer: int, *, k_scale=None,
                               v_scale=None):
    """Plain version of the paged extend kernel (same signature).

    q: (B, Hq, Sq, Dh); k/v_arena: (N, P, L, Hkv, Dh); slot_pos: (N, P, L);
    block_table: (B, n_log) int32 (>= N unmapped); pos: (B,) absolute
    offset of each row's first query; layer: arena layer.  A slot is
    attended iff its stored position is >= 0 and <= the query's absolute
    position.  Returns (B, Hq, Sq, Dh)."""
    B, Hq, Sq, Dh = q.shape
    k, v, sp = gather_pages_ref(k_arena, v_arena, slot_pos, block_table,
                                layer, k_scale, v_scale)
    G = Hq // k.shape[2]
    k = k.repeat_interleave(G, dim=2).to(F32)
    v = v.repeat_interleave(G, dim=2).to(F32)
    s = torch.einsum("bhqd,bkhd->bhqk", q.to(F32), k) / math.sqrt(Dh)
    q_pos = pos.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    valid = (sp[:, None, :] >= 0) & (sp[:, None, :] <= q_pos[:, :, None])
    s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v)
    return out.to(q.dtype)
