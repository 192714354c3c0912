"""Dense and paged decode attention: dispatch by device, plus the LSE
combine.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the hand-written kernel in ``csrc/decode_attention.cu`` or raises.  There
is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._paged import arena_args
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
)


def decode_attention(q, k_cache, v_cache, kv_len, *, slot_pos=None,
                     window: Optional[int] = None):
    """q: (B, 1, Hq, Dh) vs dense per-slot caches -> (B, 1, Hq, Dh).

    k/v_cache: (B, S, Hkv, Dh); kv_len: (B,); slot_pos: (B, S) int32
    absolute position per slot (-1 empty; a rolling buffer), or None
    meaning slot i holds position i; window: attend only positions
    ``> kv_len-1-window``.  ``decode_attention.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return decode_attention_ref(q[:, 0], k_cache, v_cache, kv_len,
                                    slot_pos=slot_pos, window=window)[:, None]
    if q.device.type != "cuda":
        raise ValueError(f"no decode kernel for device {q.device}")
    B, S1, Hq, Dh = q.shape
    _, S, Hkv, _ = k_cache.shape
    if (S1 != 1 or k_cache.shape != (B, S, Hkv, Dh) or Hq % Hkv
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if v_cache.stride() != k_cache.stride():
        raise ValueError("k and v caches must share strides")
    if k_cache.dtype != q.dtype or q.dtype not in (torch.float32,
                                                  torch.bfloat16):
        raise ValueError(f"q {q.dtype} and cache {k_cache.dtype} must share "
                         "a float32 or bfloat16 dtype")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1:
        raise ValueError("the head dim of q and the caches must be contiguous")
    if slot_pos is not None and (slot_pos.shape != (B, S)
                                 or slot_pos.dtype != torch.int32):
        raise ValueError("slot_pos must be an int32 (B, S) tensor")
    for t in (k_cache, v_cache, slot_pos):
        if t is not None and t.device != q.device:
            raise ValueError(f"tensor on {t.device}, q on {q.device}")
    if kv_len.shape != (B,):
        raise ValueError("kv_len needs one entry per query row")
    kl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    sp_strides = slot_pos.stride() if slot_pos is not None else (0, 0)
    out = torch.empty((B, 1, Hq, Dh), dtype=q.dtype, device=q.device)
    fn = _build.kernel("rt_decode_attention", "PLLI PPLLL PLL PI PLL IIIII P")
    rc = fn(q.data_ptr(), q.stride(0), q.stride(2), _build.DTYPE_CODE[q.dtype],
            k_cache.data_ptr(), v_cache.data_ptr(), *k_cache.stride()[:3],
            _build.ptr(slot_pos), *sp_strides, kl.data_ptr(),
            -1 if window is None else int(window),
            out.data_ptr(), out.stride(0), out.stride(2),
            B, Hkv, Hq // Hkv, Dh, S, _build.stream_ptr(q.device))
    decode_attention.launches += 1
    _build.check(rc, "decode_attention")
    return out


decode_attention.launches = 0


def paged_decode_attention(q, k_arena, v_arena, slot_pos, block_table,
                           kv_len, layer: int, *, k_scale=None, v_scale=None):
    """q: (B, 1, Hq, Dh) vs a paged arena -> (B, 1, Hq, Dh).

    k/v_arena: (N, P, L, Hkv, Dh) float, or int8 with (N, L) float32
    ``k_scale``/``v_scale``; slot_pos: (N, P, L) int32; block_table:
    (B, n_log) with entries >= N unmapped; kv_len: (B,); layer: the arena
    layer to read.  ``paged_decode_attention.launches`` counts kernel
    launches."""
    layer = int(layer)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q[:, 0], k_arena, v_arena, slot_pos, block_table, kv_len, layer,
            k_scale=k_scale, v_scale=v_scale)[:, None]
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    B, S, Hq, Dh = q.shape
    if S != 1:
        raise ValueError(f"decode takes one query per row, got {S}")
    N, P, _L, Hkv, _ = k_arena.shape
    arena, scales, bt = arena_args(q, k_arena, v_arena, slot_pos,
                                   block_table, layer, k_scale, v_scale)
    if bt.shape[0] != B or kv_len.shape != (B,):
        raise ValueError("block_table and kv_len need one row per query row")
    kl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, 1, Hq, Dh), dtype=q.dtype, device=q.device)
    fn = _build.kernel("rt_paged_decode_attention",
                       "PLLI PPI LLLL PLLL PLI PI PPLL PLL IIIIII P")
    rc = fn(q.data_ptr(), q.stride(0), q.stride(2),
            _build.DTYPE_CODE[q.dtype], *arena, kl.data_ptr(), layer,
            *scales, out.data_ptr(), out.stride(0), out.stride(2),
            B, Hkv, Hq // Hkv, Dh, N, P, _build.stream_ptr(q.device))
    paged_decode_attention.launches += 1
    _build.check(rc, "paged_decode_attention")
    return out


paged_decode_attention.launches = 0


def lse_combine(ms, ls, accs):
    """Merge per-split softmax partials (the split-KV combine).

    ms/ls: (n_split, ...), accs: (n_split, ..., Dh)."""
    m = ms.max(dim=0).values
    w = torch.exp(ms - m[None])
    l = (ls * w).sum(dim=0)
    acc = (accs * w[..., None]).sum(dim=0)
    return acc / l.clamp(min=1e-30)[..., None]
