"""Mixture-of-experts FFN block on one device.

The port of ``repro/models/moe.py`` without its ``shard_map``, expert-
parallel filter, FSDP gather and psum: one device holds every expert.
Dispatch is scatter-based, as in JAX: each of a token's top-k choices
takes the next capacity slot of its expert (a cumsum over one-hots, in
row-major (token, choice) order, so the tokens a full expert drops are the
ones JAX drops).  The expert SwiGLU runs the grouped GEMM
(``kernels/moe_gmm``) three times over the (E, C, D) capacity layout,
where JAX wrote einsums; ``counts[e] = min(tokens routed to e, C)`` stays
on the device, so routing reads nothing back to the host.  In training the
block is differentiable on the CPU (the plain grouped GEMM); on the card
the grouped GEMM kernel has no backward yet and raises (ROADMAP queue 2
item 7).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_gmm.ops import gmm
from repro_torch.models.param import PSpec

F32 = torch.float32


def moe_specs(cfg: ArchConfig) -> dict:
    """Router, routed experts (E, D, F) and, for DeepSeekMoE, the shared
    experts; the layout JAX uses on one device (expert-parallel axes)."""
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_expert, m.num_experts
    specs = {
        "router": PSpec((d, e), (None, None), ("normal", 0), dtype="float32"),
        "w_gate": PSpec((e, d, fe), ("expert", "embed", None), ("normal", 1)),
        "w_up": PSpec((e, d, fe), ("expert", "embed", None), ("normal", 1)),
        "w_down": PSpec((e, fe, d), ("expert", None, "embed"), ("normal", 1)),
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
               train: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """xf: (T, D) tokens; w_*: (E, D, F) / (E, F, D).  Returns (y (T, D),
    the Switch load-balance loss when ``train``, else None)."""
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
        aux = E * torch.sum(f_e * probs.mean(0))

    # ---- capacity slots
    C = _capacity(cfg, T, train)
    flat_e = topi.reshape(-1)                                    # (T*K,)
    oh = _one_hot(flat_e, E)
    slot = (torch.cumsum(oh, dim=0) * oh).sum(-1) - 1            # within expert
    keep = slot < C
    counts = oh.sum(0).clamp(max=C)                              # (E,)
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


def moe_block(p, x, cfg: ArchConfig, *, train: bool):
    """x: (B, S, D).  Returns (y, aux loss or None)."""
    B, S, D = x.shape
    y, aux = _moe_local(x.reshape(B * S, D), p["router"], p["w_gate"],
                        p["w_up"], p["w_down"], cfg=cfg, train=train)
    y = y.reshape(B, S, D)
    if cfg.moe.num_shared:
        h = F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
        y = y + h @ p["ws_down"]
    return y, aux
