"""Plain PyTorch versions of the flash-attention kernels.

The CPU path of ``ops.py`` and the yardstick the CUDA kernels are held
against on the card.  Same signatures and layouts as the JAX oracles in
``repro/kernels/flash_attention/ref.py``; ``flash_attention_bwd_ref`` is
the gradient of ``attention_ref`` written out (what ``jax.vjp`` of the
oracle gives), the plain version of ``csrc/flash_attention_bwd.cu``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

F32 = torch.float32
NEG_INF = -1e30


def _scores(q, k, causal, window, kv_len):
    """float32 scaled scores (B, Hq, Sq, Skv) with the masked entries at
    ``NEG_INF``, and the (B or 1, 1, Sq, Skv) mask of valid entries."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kf = k.repeat_interleave(Hq // Hkv, dim=1).to(F32)
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
    else:
        mask = mask[None, None]
    return torch.where(mask, s, NEG_INF), mask


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, kv_len=None,
                  return_lse: bool = False):
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh) -> (B, Hq, Sq, Dh).

    GQA by head grouping (head h uses kv head h // (Hq//Hkv)); q positions
    are aligned to the end of the keys (offset Skv - Sq).  ``kv_len``
    (B,): key ``kp`` of row b counts iff ``kp < kv_len[b]``; a row left
    with no key gets the mean of V over all Skv keys, as JAX's finite
    ``NEG_INF`` gives it (the kernels store 0 there).  ``return_lse``:
    also the float32 (B, Hq, Sq) log-sum-exp of each row's scaled scores,
    what the backward reads."""
    G = q.shape[1] // k.shape[1]
    s, _ = _scores(q, k, causal, window, kv_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p,
                       v.repeat_interleave(G, dim=1).to(F32)).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                            window: Optional[int] = None, kv_len=None):
    """The gradient of :func:`attention_ref`, written out: (dq, dk, dv) in
    the dtypes of q, k, v, from ``out``, its cotangent ``dout`` (both (B,
    Hq, Sq, Dh)) and the forward's ``lse`` (B, Hq, Sq).  P = exp(s - lse)
    is recomputed, D = rowsum(dout * out), dS = P (dout V^T - D) on the
    valid entries, dq = scale dS K, dk = scale dS^T Q and dv = P^T dout,
    summed over the G q heads of each kv head; float32 throughout.  A row
    with no valid key has P = 1/Skv on every key (JAX's finite
    ``NEG_INF`` softmax), so it adds dout/Skv to every dv row and nothing
    to dq or dk; the kernel adds nothing there."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    s, mask = _scores(q, k, causal, window, kv_len)
    mask = mask.expand(s.shape)
    any_valid = mask.any(dim=-1, keepdim=True)
    p = torch.where(any_valid, torch.exp(s - lse.to(F32)[..., None]),
                    1.0 / Skv)
    do = dout.to(F32)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    vf = v.repeat_interleave(G, dim=1).to(F32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    D = (do * out.to(F32)).sum(dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - D), 0.0) / math.sqrt(Dh)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds,
                      k.repeat_interleave(G, dim=1).to(F32))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(F32))

    def fold(t):      # (B, Hq, Skv, Dh) -> the sum over each kv head's G
        return t.view(B, Hkv, G, Skv, Dh).sum(dim=2)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


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
