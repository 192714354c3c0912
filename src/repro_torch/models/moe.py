"""Mixture-of-experts FFN block.

The port of ``repro/models/moe.py``.  On one device one position holds
every expert.  Over a mesh (a sharded ``ctx``) the block runs as JAX's
``shard_map`` body does, per position on Sharded values: **EP** when
``E % model == 0`` (each position owns ``E_local`` experts, tokens are
replicated over ``model``, a position keeps only the choices routed to
its experts) and **TP-in-expert** otherwise (every expert, its ffn dim
split); expert weights split over the data axes (FSDP) are all-gathered
first, and the combine is a ``psum_scatter`` over the embed dim when
``D % model == 0`` (re-gathered into the replicated residual stream),
else a ``psum``.  Capacity is reckoned from the position's own token
count, as JAX's ``_capacity(cfg, T_local, ...)``.

Dispatch is scatter-based, as in JAX: each of a token's top-k choices
takes the next capacity slot of its expert (a cumsum over one-hots, in
row-major (token, choice) order, so the tokens a full expert drops are the
ones JAX drops).  The expert SwiGLU runs the grouped GEMM
(``kernels/moe_gmm``) three times over the (E, C, D) capacity layout,
where JAX wrote einsums; ``counts[e] = min(tokens routed to e, C)`` stays
on the device, so routing reads nothing back to the host.  In training the
block is differentiable on both devices: the grouped GEMM's gradient is
the plain ``gmm_bwd_ref`` on the CPU and the hand-written backward kernels
(dX and dW, ``kernels/moe_gmm/ops.py::gmm_bwd``) on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.param import PSpec
from repro_torch.sharding.collectives import (
    all_gather,
    axis_index,
    pmean,
    psum,
    psum_scatter,
    relayout,
)
from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import per_position

F32 = torch.float32

#: the grouped GEMM's wrapper, run once per position on Sharded arguments
gmm = per_position(gmm_ops.gmm)


def use_ep(cfg: ArchConfig, ctx) -> bool:
    """Expert parallelism: the experts split over the model axis."""
    return cfg.moe.num_experts % max(
        ctx.model_size() if ctx is not None else 1, 1) == 0


def moe_specs(cfg: ArchConfig, ctx=None) -> dict:
    """Router, routed experts (E, D, F) and, for DeepSeekMoE, the shared
    experts; expert-parallel axes when ``use_ep`` (always on one
    device), else TP-in-expert axes, as JAX's."""
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_expert, m.num_experts
    if use_ep(cfg, ctx):
        w_axes = {"w_gate": ("expert", "embed", None),
                  "w_up": ("expert", "embed", None),
                  "w_down": ("expert", None, "embed")}
    else:
        w_axes = {"w_gate": (None, "embed", "expert_ffn"),
                  "w_up": (None, "embed", "expert_ffn"),
                  "w_down": (None, "expert_ffn", "embed")}
    specs = {
        "router": PSpec((d, e), (None, None), ("normal", 0), dtype="float32"),
        "w_gate": PSpec((e, d, fe), w_axes["w_gate"], ("normal", 1)),
        "w_up": PSpec((e, d, fe), w_axes["w_up"], ("normal", 1)),
        "w_down": PSpec((e, fe, d), w_axes["w_down"], ("normal", 1)),
    }
    if m.num_shared:
        fs = m.num_shared * m.d_shared
        specs["ws_gate"] = PSpec((d, fs), ("embed", "ffn"), ("normal", 0))
        specs["ws_up"] = PSpec((d, fs), ("embed", "ffn"), ("normal", 0))
        specs["ws_down"] = PSpec((fs, d), ("ffn", "embed"), ("normal", 0))
    return specs


def _capacity(cfg: ArchConfig, t_local: int, train: bool) -> int:
    """Slots per expert: dropless (T) for inference batches of at most 64
    tokens, else ``ceil(k * T * cf / E)`` with cf >= 2 at inference."""
    m = cfg.moe
    if not train and t_local <= 64:
        return t_local
    cf = m.capacity_factor if train else max(m.capacity_factor, 2.0)
    c = int(math.ceil(m.top_k * t_local * cf / m.num_experts))
    return max(min(c, t_local), 1)


def _one_hot(idx, n: int):
    """(..., n) int64 one-hot rows; unlike ``F.one_hot`` it reads no value
    back to the host to validate ``idx``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _moe_local(xf, router, w_gate, w_up, w_down, *, cfg: ArchConfig,
               train: bool, ep_rank: Optional[int] = None,
               stats: bool = False):
    """xf: (T, D) tokens; w_*: (E_local, D, F) / (E_local, F, D).
    Returns (y (T, D), the Switch load-balance loss when ``train``, else
    None).  ``ep_rank``: this position owns experts [ep_rank * E_local,
    (ep_rank + 1) * E_local) and keeps only the choices routed there.
    ``stats``: the loss's two means (f_e, P_e) in its place, for a caller
    that averages them over the data axes before the product."""
    m = cfg.moe
    T, D = xf.shape
    E, K = m.num_experts, m.top_k

    # ---- routing (fp32); torch.topk orders like jax.lax.top_k
    probs = torch.softmax(xf.to(F32) @ router.to(F32), dim=-1)   # (T, E)
    topv, topi = torch.topk(probs, K, dim=-1)                    # (T, K)
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    aux = None
    if train:
        f_e = _one_hot(topi, E).to(F32).sum(1).mean(0)
        aux = ((f_e, probs.mean(0)) if stats
               else E * torch.sum(f_e * probs.mean(0)))

    # ---- capacity slots
    C = _capacity(cfg, T, train)
    flat_e = topi.reshape(-1)                                    # (T*K,)
    oh = _one_hot(flat_e, E)
    slot = (torch.cumsum(oh, dim=0) * oh).sum(-1) - 1            # within expert
    keep = slot < C
    counts = oh.sum(0).clamp(max=C)                              # (E,)
    if ep_rank is not None:
        # ---- EP filter: the choices routed to this position's experts
        E = w_gate.shape[0]
        lo = ep_rank * E
        keep = keep & (flat_e >= lo) & (flat_e < lo + E)
        flat_e = (flat_e - lo).clamp(0, E - 1)
        counts = counts[lo:lo + E]
    # row e*C + slot of a flat (E*C + 1, D) buffer; dropped choices land in
    # the extra last row, which nothing reads.  Every row below
    # counts[e] of each expert is written, and the GEMM reads no row past
    # it, so a serving buffer needs no zeroing.
    dest = torch.where(keep, flat_e * C + slot, E * C)
    # in training the rows past counts[e] are zeros, as JAX's buffer: the
    # grouped GEMM's weight gradient multiplies every row by its (zero)
    # output gradient, and uninitialised rows could hold NaNs
    buf = (torch.zeros if train else torch.empty)(
        (E * C + 1, D), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, dest, xf.repeat_interleave(K, dim=0))
    buf = buf[:E * C].view(E, C, D)

    # ---- expert FFN (SwiGLU) through the grouped GEMM
    h = F.silu(gmm(buf, w_gate, counts)) * gmm(buf, w_up, counts)
    out = gmm(h, w_down, counts).view(E * C, D)

    # ---- combine: the K choices of token t are rows t*K .. t*K+K-1
    gate = torch.where(keep, topv.reshape(-1), 0.0).to(xf.dtype)
    gathered = out.index_select(0, torch.where(keep, dest, 0)) * gate[:, None]
    return gathered.view(T, K, D).sum(1).to(xf.dtype), aux


def moe_block(p, x, cfg: ArchConfig, ctx=None, *, train: bool):
    """x: (B, S, D).  Returns (y, aux loss or None).  A sharded ``ctx``
    runs :func:`moe_block_sharded`."""
    if ctx is not None and ctx.sharded:
        return moe_block_sharded(p, x, cfg, ctx, train=train)
    B, S, D = x.shape
    y, aux = _moe_local(x.reshape(B * S, D), p["router"], p["w_gate"],
                        p["w_up"], p["w_down"], cfg=cfg, train=train)
    y = y.reshape(B, S, D)
    if cfg.moe.num_shared:
        h = F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
        y = y + h @ p["ws_down"]
    return y, aux


def moe_block_sharded(p, x, cfg: ArchConfig, ctx, *, train: bool):
    """:func:`moe_block` over a mesh: ``x`` (B_l, S, D) batch-local,
    replicated over ``model``; the expert weights Sharded.  Returns (y
    replicated over ``model``, aux loss or None, the same on every
    position)."""
    B, S, D = x.shape
    mx = ctx.model_axis
    msz = ctx.model_size()
    ep = use_ep(cfg, ctx)
    e_ax = mx if ep else None
    f_ax = None if ep or cfg.moe.d_expert % msz else mx
    want = {"router": P(None, None),
            "w_gate": P(e_ax, None, f_ax), "w_up": P(e_ax, None, f_ax),
            "w_down": P(e_ax, f_ax, None)}
    w = {k: relayout(p[k], want[k]) for k in want}
    ranks = axis_index(ctx.mesh, mx) if ep and msz > 1 else None
    y, aux = per_position(_moe_local)(
        x.reshape(B * S, D), w["router"], w["w_gate"], w["w_up"],
        w["w_down"], cfg=cfg, train=train, ep_rank=ranks, stats=True)
    if train:
        # f_e and P_e are global means: averaged over the data axes
        # before their product
        f_e, p_e = (pmean(a, ctx.batch_axes) for a in aux)
        aux = cfg.moe.num_experts * torch.sum(f_e * p_e)
    if (ep or f_ax) and msz > 1:
        if D % msz == 0:
            y = all_gather(psum_scatter(y, mx, dim=1), mx, dim=1)
        else:
            y = psum(y, mx)
    y = y.reshape(B, S, D)
    if cfg.moe.num_shared:
        fs = p["ws_up"].global_shape[1]
        s_ax = mx if fs % msz == 0 else None
        ws = {k: relayout(p[k], P(s_ax, None) if k == "ws_down"
                          else P(None, s_ax))
              for k in ("ws_gate", "ws_up", "ws_down")}
        h = F.silu(x @ ws["ws_gate"]) * (x @ ws["ws_up"])
        sh = h @ ws["ws_down"]
        y = y + (psum(sh, mx) if s_ax else sh)
    return y, aux
