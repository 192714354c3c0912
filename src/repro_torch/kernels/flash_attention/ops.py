"""Prefill flash attention and paged extend attention: dispatch by device.

Both wrappers take the model's (B, S, H, Dh) layout.  A CPU tensor takes
the plain version in ``ref.py``; a CUDA tensor launches the hand-written
kernel in ``csrc/flash_attention.cu`` or raises.  There is no fallback
from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._paged import arena_args
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    paged_extend_attention_ref,
)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q: (B, Sq, Hq, Dh); k/v: (B, Skv, Hkv, Dh) -> (B, Sq, Hq, Dh).

    Any Sq and Skv >= Sq; q positions align to the end of the keys.
    ``flash_attention.launches`` counts kernel launches."""
    if q.device.type == "cpu":
        return attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Skv, Hkv, Dh) or v.shape != k.shape or Hq % Hkv
            or Skv < Sq):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype == torch.int8:
        raise ValueError("q, k and v must share one float dtype")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    out = torch.empty((B, Sq, Hq, Dh), dtype=q.dtype, device=q.device)
    fn = _build.kernel("rt_flash_attention",
                       "PLLL PLLL PLLL PLLL IIIIIIIII P")
    rc = fn(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], out.data_ptr(), *out.stride()[:3],
            B, Hq, Hkv, Sq, Skv, Dh, int(causal),
            -1 if window is None else int(window),
            _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q.device))
    flash_attention.launches += 1
    _build.check(rc, "flash_attention")
    return out


flash_attention.launches = 0


def paged_extend_attention(q, k_arena, v_arena, slot_pos, block_table, pos,
                           layer: int, *, k_scale=None, v_scale=None):
    """q: (B, S, Hq, Dh) suffix queries at absolute positions pos[b] + i
    vs a paged arena (see ``paged_decode_attention``) -> (B, S, Hq, Dh).
    ``paged_extend_attention.launches`` counts kernel launches."""
    layer = int(layer)
    if q.device.type == "cpu":
        return paged_extend_attention_ref(
            q.transpose(1, 2), k_arena, v_arena, slot_pos, block_table, pos,
            layer, k_scale=k_scale, v_scale=v_scale).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"no paged extend kernel for device {q.device}")
    B, S, Hq, Dh = q.shape
    N, P, _L, Hkv, _ = k_arena.shape
    arena, scales, bt = arena_args(q, k_arena, v_arena, slot_pos,
                                   block_table, layer, k_scale, v_scale)
    if bt.shape[0] != B or pos.shape != (B,):
        raise ValueError("block_table and pos need one row per query row")
    ps = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, S, Hq, Dh), dtype=q.dtype, device=q.device)
    fn = _build.kernel("rt_paged_extend_attention",
                       "PLLLI PPI LLLL PLLL PLI PI PPLL PLLL IIIIIII P")
    rc = fn(q.data_ptr(), *q.stride()[:3], _build.DTYPE_CODE[q.dtype],
            *arena, ps.data_ptr(), layer, *scales,
            out.data_ptr(), *out.stride()[:3],
            B, Hq, Hkv, S, Dh, N, P, _build.stream_ptr(q.device))
    paged_extend_attention.launches += 1
    _build.check(rc, "paged_extend_attention")
    return out


paged_extend_attention.launches = 0
