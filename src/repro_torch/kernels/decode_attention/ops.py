"""Paged decode attention: dispatch by device, plus the LSE combine.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the hand-written kernel in ``csrc/decode_attention.cu`` or raises.  There
is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._paged import arena_args
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref


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
