"""Gradient compression for data-parallel reduction (int8 + error feedback),
the port of ``repro/train/grad_compress.py``.

``apply_ef_compression`` is the form the train step uses: quantize ->
dequantize (+ error feedback) of the whole gradient, numerically what
compressing before a linear all-reduce gives.  Each leaf is quantized to
int8 with one per-tensor scale; the dequantization error is carried to
the next step in an error-feedback buffer, so the sum over steps stays
unbiased.  Over a mesh the gradient is a tree of
:class:`~repro_torch.sharding.sharded.Sharded` leaves and the scale is the
global one, as JAX's on its global gradient: each position's max
``pmax``-ed over the axes its leaf's layout splits.

``compressed_psum`` is the collective form (JAX's, inside ``shard_map``):
each position quantizes its own ``x + ef`` with the group's shared scale
(the ``pmax`` of the positions' scales), the int8 codes are ``psum``-ed in
int32, and the sum is dequantized with the shared scale; the residual of
each position's quantization is its new error-feedback buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.param import DTYPES, jax_leaves, jax_unflatten, tree_map
from repro_torch.sharding.collectives import pmax, psum
from repro_torch.sharding.sharded import Sharded
from repro_torch.train.optimizer import split_axes

F32 = torch.float32
INT8_MAX = 127.0


def quantize_int8(x, axes=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) with scale = max|x| / 127 (at least
    1e-12) and codes = round(x / scale), half to even as ``jnp.round``.
    A Sharded ``x`` takes the max over the positions along ``axes``
    (``pmax``): one scale for the group."""
    x32 = x.to(F32)
    amax = torch.max(torch.abs(x32))
    if axes:
        amax = pmax(amax, axes)
    scale = torch.clamp(amax / INT8_MAX, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.to(F32) * scale


@torch.no_grad()
def apply_ef_compression(grads, ef_state):
    """grads, ef_state: trees of one structure.  Returns (the compressed
    grads in their dtypes, the new error-feedback buffers in theirs);
    Sharded leaves keep their layouts, each quantized with its logical
    tensor's scale."""
    def one(g, e):
        g32 = g.to(F32) + e.to(F32)
        sharded = isinstance(g, Sharded)
        deq = dequantize_int8(*quantize_int8(
            g32, split_axes(g) if sharded else ()))
        out, res = deq.to(g.dtype), (g32 - deq).to(e.dtype)
        if sharded:
            out.spec, res.spec = g.spec, e.spec
        return out, res

    out = [one(g, e) for g, e in zip(jax_leaves(grads), jax_leaves(ef_state))]
    return (jax_unflatten(grads, [g for g, _ in out]),
            jax_unflatten(ef_state, [e for _, e in out]))


@torch.no_grad()
def compressed_psum(x: Sharded, axes, ef: Sharded):
    """``psum`` of ``x`` over ``axes`` with int8 on the wire: each
    position quantizes ``x + ef`` with the group's shared scale, the codes
    are summed in int32 and dequantized with that scale.  Returns (the
    reduced value in float32, the new error-feedback buffers in ``ef``'s
    dtype)."""
    x32 = x.to(F32) + ef.to(F32)
    q, scale = quantize_int8(x32, axes)
    new_ef = (x32 - dequantize_int8(q, scale)).to(ef.dtype)
    return psum(q.to(torch.int32), axes).to(F32) * scale, new_ef


def init_ef_state(params, dtype: str = "bfloat16"):
    """Zero error-feedback buffers shaped (over a mesh, laid out) as
    ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=DTYPES[dtype]),
                    params)
