"""Gradient compression for data-parallel reduction (int8 + error feedback),
the port of ``repro/train/grad_compress.py``.

``apply_ef_compression`` is the form the train step uses: quantize ->
dequantize (+ error feedback) of the whole gradient, numerically what
compressing before a linear all-reduce gives.  Each leaf is quantized to
int8 with one per-tensor scale; the dequantization error is carried to
the next step in an error-feedback buffer, so the sum over steps stays
unbiased.  JAX's ``compressed_psum`` (the collective form, int8 on the
wire inside ``shard_map``) comes with training under a mesh (ROADMAP
queue 1 item 13c).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.param import DTYPES, jax_leaves, jax_unflatten, tree_map

F32 = torch.float32
INT8_MAX = 127.0


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) with scale = max|x| / 127 (at least
    1e-12) and codes = round(x / scale), half to even as ``jnp.round``."""
    x32 = x.to(F32)
    scale = torch.clamp(torch.max(torch.abs(x32)) / INT8_MAX, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.to(F32) * scale


@torch.no_grad()
def apply_ef_compression(grads, ef_state):
    """grads, ef_state: trees of one structure.  Returns (the compressed
    grads in their dtypes, the new error-feedback buffers in theirs)."""
    def one(g, e):
        g32 = g.to(F32) + e.to(F32)
        deq = dequantize_int8(*quantize_int8(g32))
        return deq.to(g.dtype), (g32 - deq).to(e.dtype)

    out = [one(g, e) for g, e in zip(jax_leaves(grads), jax_leaves(ef_state))]
    return (jax_unflatten(grads, [g for g, _ in out]),
            jax_unflatten(ef_state, [e for _, e in out]))


def init_ef_state(params, dtype: str = "bfloat16"):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=DTYPES[dtype],
                                          device=p.device), params)
