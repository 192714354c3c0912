"""Argument checks shared by the two paged-attention wrappers."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import DTYPE_CODE, ptr


def arena_args(q: torch.Tensor, k_arena, v_arena, slot_pos, block_table,
               layer: int, k_scale: Optional[torch.Tensor],
               v_scale: Optional[torch.Tensor]
               ) -> Tuple[tuple, tuple, torch.Tensor]:
    """Validate a paged arena against the query and flatten it into the
    C arguments.  Returns ``(arena, scales, bt)``: ``arena`` is (k, v,
    kv dtype code, 4 arena strides, slot_pos, its 3 strides, block table,
    its row stride, n_log), ``scales`` is (k_scale, v_scale, 2 scale
    strides), and ``bt`` the int32 block table the kernel reads (kept
    alive by the caller until the launch is enqueued)."""
    dev = q.device
    N, P, L, Hkv, Dh = k_arena.shape
    if v_arena.shape != k_arena.shape or v_arena.stride() != k_arena.stride():
        raise ValueError("k and v arenas must share shape and strides")
    if k_arena.stride(-1) != 1 or q.stride(-1) != 1:
        raise ValueError("the head dim of q and the arena must be contiguous")
    if q.shape[-1] != Dh or q.shape[-2] % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit arena "
                         f"{tuple(k_arena.shape)}")
    if P > 128:
        raise ValueError(f"page size {P} above the kernels' 128 threads")
    if slot_pos.shape != (N, P, L) or slot_pos.dtype != torch.int32:
        raise ValueError("slot_pos must be an int32 (N, P, L) tensor")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the arena's {L} layers")
    quant = k_arena.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 arenas need k_scale and v_scale; float "
                         "arenas take none")
    if not quant and k_arena.dtype != q.dtype:
        raise ValueError(f"arena dtype {k_arena.dtype} != q dtype {q.dtype}")
    if q.dtype not in DTYPE_CODE or q.dtype == torch.int8:
        raise ValueError(f"unsupported q dtype {q.dtype}")
    if quant and (k_scale.shape != (N, L) or k_scale.dtype != torch.float32
                  or v_scale.stride() != k_scale.stride()):
        raise ValueError("k/v_scale must be float32 (N, L) with equal strides")
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    for t in (k_arena, v_arena, slot_pos, k_scale, v_scale):
        if t is not None and t.device != dev:
            raise ValueError(f"tensor on {t.device}, q on {dev}")
    sc_strides = k_scale.stride() if quant else (0, 0)
    args = (ptr(k_arena), ptr(v_arena), DTYPE_CODE[k_arena.dtype],
            *k_arena.stride()[:4],
            ptr(slot_pos), *slot_pos.stride(),
            ptr(bt), bt.stride(0), bt.shape[1])
    scales = (ptr(k_scale), ptr(v_scale), *sc_strides)
    return args, scales, bt
