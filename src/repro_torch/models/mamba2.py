"""Mamba-2 (SSD, state-space duality) blocks.

The scan runs in the chunked matmul form of the SSD paper
[arXiv:2405.21060]: intra-chunk products plus a cheap inter-chunk
recurrence over per-chunk states.  ``mamba_block`` calls
``kernels.ssd_scan.ops.ssd`` (one launch of the hand-written scan on the
card, its plain version on the CPU; in training its gradient is the
hand-written backward ``ops.ssd_bwd``, one call a layer); ``ssd_chunked``
is the plain oracle of the whole scan, kept for the tests, as the JAX
package's ``mamba_block`` runs it (JAX trains through its ``jax.grad``).  Group dims (ngroups) are kept un-broadcast, so B/C are never
materialised per head.

Bucket-padded (chunked) prefill is exact: a (B, S_pad) validity mask makes
pad tokens identity state updates (``dt`` zeroed: zero log-decay, zero
dt-weighted input) and the causal-conv state is snapshotted at each row's
last real token.

Layout (per block):
  in projections  wz, wx : (D, d_inner)   wB, wC : (D, G*N)   wdt : (D, H)
  causal conv (k taps) over [x, B, C] segments (separate weights per segment)
  SSD over heads (H = d_inner / head_dim)
  gated RMSNorm (norm(y * silu(z))), out projection d_inner -> D.

Over a mesh (a sharded ``ctx``) the block runs tensor-parallel when the
SSD heads divide the model axis and there is one group: position r holds
its slice of ``inner`` (wz, wx, conv_x, gate_norm, out_proj) and of
``ssm_heads`` (wdt, dt_bias, A_log, D_skip), wB, wC, conv_B and conv_C
whole, and runs the one-device body on its H/m heads (its config's
``ssm.inner``: :func:`local_ssm_cfg`).  Two steps look across positions:
the gated RMSNorm's sum of squares over the whole ``d_inner`` (a ``psum``
of float32 partial sums, what GSPMD inserts for JAX) and the row-parallel
``out_proj`` (a ``psum``).  Its state is laid out by position: conv (B,
K-1, d_inner/m + 2·G·N) = [x_r | B | C], ssm (B, H/m, P, N).  Otherwise
the block runs replicated, every position the whole one-device block.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_tiling_chunk
from repro_torch.models.layers import rms_norm
from repro_torch.models.param import PSpec
from repro_torch.sharding.collectives import psum, relayout
from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import per_position

F32 = torch.float32

# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
def mamba_dims(cfg: ArchConfig):
    """(d_inner, H, G, N, K): the inner width ``expand * d_model``, or the
    local ``ssm.inner`` of one mesh position, and its SSD heads."""
    s = cfg.ssm
    d_inner = s.inner if s.inner is not None else s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.ngroups, s.d_state, s.d_conv


def mamba_tp(cfg: ArchConfig, ctx) -> bool:
    """Does a Mamba layer run tensor-parallel over ``ctx``'s model axis?
    Its SSD heads must divide the axis (then so does ``inner``), and one
    group of B and C must serve every head; else it runs replicated, as
    attention does when its heads do not divide."""
    m = ctx.model_size()
    _, H, G, _, _ = mamba_dims(cfg)
    return m > 1 and H % m == 0 and G == 1


def local_ssm_cfg(cfg: ArchConfig, ctx) -> ArchConfig:
    """The config one position's Mamba layers see: ``inner / m`` under
    TP, else the config as it is."""
    if cfg.ssm is None or not mamba_tp(cfg, ctx):
        return cfg
    d_inner = mamba_dims(cfg)[0]
    return cfg.replace(ssm=cfg.ssm.replace(inner=d_inner // ctx.model_size()))


def mamba_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_inner, H, G, N, K = mamba_dims(cfg)
    return {
        "wz": PSpec((d, d_inner), ("embed", "inner"), ("normal", 0)),
        "wx": PSpec((d, d_inner), ("embed", "inner"), ("normal", 0)),
        "wB": PSpec((d, G * N), ("embed", None), ("normal", 0)),
        "wC": PSpec((d, G * N), ("embed", None), ("normal", 0)),
        "wdt": PSpec((d, H), ("embed", "ssm_heads"), ("normal", 0)),
        "dt_bias": PSpec((H,), ("ssm_heads",), ("dt_bias",), dtype="float32"),
        "A_log": PSpec((H,), ("ssm_heads",), ("alog",), dtype="float32"),
        "D_skip": PSpec((H,), ("ssm_heads",), ("const", 1.0), dtype="float32"),
        "conv_x": PSpec((K, d_inner), (None, "inner"), ("normal", 0)),
        "conv_B": PSpec((K, G * N), (None, None), ("normal", 0)),
        "conv_C": PSpec((K, G * N), (None, None), ("normal", 0)),
        "gate_norm": PSpec((d_inner,), ("inner",), ("const", 1.0)),
        "out_proj": PSpec((d_inner, d), ("inner", "embed"), ("normal", 0)),
    }


class MambaState(NamedTuple):
    """Decode-time state for one layer (or a layer stack)."""
    conv: torch.Tensor   # (B, K-1, d_inner + 2*G*N) trailing pre-conv inputs
    ssm: torch.Tensor    # (B, H, P, N) float32


def init_mamba_state(cfg: ArchConfig, batch: int, dtype,
                     device="cpu") -> MambaState:
    d_inner, H, G, N, K = mamba_dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, K - 1, d_inner + 2 * G * N), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, H, cfg.ssm.head_dim, N), dtype=F32,
                        device=device),
    )


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) exactly, with no switch to the
    identity above a threshold as ``torch.nn.functional.softplus`` has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# --------------------------------------------------------------------------
# SSD: the plain oracle of the whole scan, and the one-token step
# --------------------------------------------------------------------------
def ssd_chunked(x, dt, A_log, B_in, C_in, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                checkpoints: bool = False):
    """SSD in chunked matmul form, in plain PyTorch.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus, > 0); A_log: (H,) (A =
    -exp(A_log)); B_in, C_in: (B, S, G, N); mask: optional (B, S) bool
    validity mask (a masked step has ``dt`` zeroed: identity update).
    Returns (y (B, S, H, P), final state (B, H, P, N) float32) and, with
    ``checkpoints``, the state after every chunk (B, nc, H, P, N)."""
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros_like(dt))
    Bb, S, H, P_ = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    HG = H // G
    Q = ssd_tiling_chunk(S, chunk)
    nc = S // Q

    A = -torch.exp(A_log.to(F32))                          # (H,)
    dA = dt.to(F32) * A                                    # (B,S,H) log-decay
    xw = x.to(F32) * dt.to(F32)[..., None]                 # dt-weighted input

    xc = xw.reshape(Bb, nc, Q, G, HG, P_)
    dAc = dA.reshape(Bb, nc, Q, H).permute(0, 3, 1, 2)    # (B,H,nc,Q)
    dAc = dAc.reshape(Bb, G, HG, nc, Q)
    Bc = B_in.to(F32).reshape(Bb, nc, Q, G, N)
    Cc = C_in.to(F32).reshape(Bb, nc, Q, G, N)
    A_cs = torch.cumsum(dAc, dim=-1)                       # (B,G,HG,nc,Q)

    # 1) intra-chunk (diagonal blocks)
    diff = A_cs[..., :, None] - A_cs[..., None, :]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(tril, diff, -torch.inf))     # (B,G,HG,nc,Q,Q)
    scores = torch.einsum("bcqgn,bckgn->bgcqk", Cc, Bc)    # (B,G,nc,Q,K)
    M = scores[:, :, None] * L                             # (B,G,HG,nc,Q,K)
    y_diag = torch.einsum("bghcqk,bckghp->bcqghp", M, xc)

    # 2) per-chunk states
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)        # (B,G,HG,nc,Q)
    states = torch.einsum("bcqgn,bghcq,bcqghp->bcghpn", Bc, decay_states, xc)

    # 3) inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(A_cs[..., -1])                 # (B,G,HG,nc)
    h = (torch.zeros((Bb, G, HG, P_, N), dtype=F32, device=x.device)
         if initial_state is None
         else initial_state.to(F32).reshape(Bb, G, HG, P_, N))
    prev, after = [], []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[..., c, None, None] + states[:, c]
        after.append(h)
    prev = torch.stack(prev, dim=1)                        # (B,nc,G,HG,P,N)
    final = h.reshape(Bb, H, P_, N)

    # 4) state -> output
    out_decay = torch.exp(A_cs)                            # (B,G,HG,nc,Q)
    y_off = torch.einsum("bcqgn,bcghpn,bghcq->bcqghp", Cc, prev, out_decay)
    y = (y_diag + y_off).reshape(Bb, S, H, P_)
    if checkpoints:
        ck = torch.stack(after, dim=1).reshape(Bb, nc, H, P_, N)
        return y, final, ck
    return y, final


def ssd_decode_step(state, x, dt, A_log, B_in, C_in):
    """One-token SSD update.  x: (B, 1, H, P); state: (B, H, P, N) float32.
    Returns (y (B, 1, H, P), new state)."""
    Bb, _, H, P_ = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    HG = H // G
    A = -torch.exp(A_log.to(F32))
    dA = torch.exp(dt[:, 0].to(F32) * A)                   # (B,H)
    xg = (x[:, 0].to(F32) * dt[:, 0][..., None]).reshape(Bb, G, HG, P_)
    dBx = torch.einsum("bgn,bghp->bghpn", B_in[:, 0].to(F32), xg)
    new_state = state * dA[..., None, None] + dBx.reshape(Bb, H, P_, N)
    y = torch.einsum("bgn,bghpn->bghp", C_in[:, 0].to(F32),
                     new_state.reshape(Bb, G, HG, P_, N))
    return y.reshape(Bb, 1, H, P_), new_state


# --------------------------------------------------------------------------
# full block
# --------------------------------------------------------------------------
def _causal_conv(seq, w, conv_state=None, length=None, boundary_every=None):
    """Depthwise causal conv.  seq: (B, S, C); w: (K, C).  Returns (y,
    new_state), or (y, new_state, bstates) with ``boundary_every``.

    ``length`` (B,): the returned conv state is snapshotted at each row's
    last REAL token: ``new_state[b]`` holds the K-1 inputs before position
    ``length[b]`` (a length-0 row keeps its seeded state).
    ``boundary_every`` R: also the K-1 inputs before every position
    ``(c+1)*R``, (B, S//R, K-1, C): what a suffix restored from a
    chunk-boundary snapshot must see."""
    K = w.shape[0]
    Bb, S, C = seq.shape
    if conv_state is None:
        pad = torch.zeros((Bb, K - 1, C), dtype=seq.dtype, device=seq.device)
    else:
        pad = conv_state.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)                    # (B, S+K-1, C)
    y = sum(full[:, i:i + S] * w[i] for i in range(K))
    if K <= 1:
        new_state = torch.zeros_like(pad)
    elif length is None:
        new_state = full[:, -(K - 1):]
    else:
        # position p sits at full index p + K-1: the window of the K-1
        # inputs before position length[b] is full[b, length[b]:length[b]+K-1]
        idx = (length.long()[:, None]
               + torch.arange(K - 1, device=seq.device)[None, :])
        new_state = full.gather(1, idx[:, :, None].expand(Bb, K - 1, C))
    if boundary_every is None:
        return y, new_state
    R = boundary_every
    # windows starting at R, 2R, ..., S: (B, S//R, C, K-1) -> (B, S//R, K-1, C)
    bstates = full[:, R:].unfold(1, K - 1, R).transpose(2, 3)
    return y, new_state, bstates


# the dim of each Mamba weight a tensor-parallel position holds a slice of
_TP_DIM = {"wz": 1, "wx": 1, "conv_x": 1, "wdt": 1, "gate_norm": 0,
           "out_proj": 0, "dt_bias": 0, "A_log": 0, "D_skip": 0}


def mamba_block(p, x, cfg: ArchConfig, *, mode: str,
                state: Optional[MambaState] = None,
                mask: Optional[torch.Tensor] = None,
                ckpt_every: Optional[int] = None,
                ckpt_out: Optional[MambaState] = None, ctx=None
                ) -> Tuple[torch.Tensor, object]:
    """x: (B, S, D).  Returns (y (B, S, D), new state or None).

    ``mask`` (B, S) bool (prefill / extend) marks the real tokens of each
    bucket-padded row: pad positions make no state update and the conv
    state is snapshotted at each row's last real token.  ``mode="extend"``
    continues from ``state`` (a restored snapshot): its conv state seeds
    the left pad and its ssm state seeds the recurrence.  ``mode="decode"``
    takes one token per row; ``mode="train"`` starts from zero state and
    returns None for it.  ``ckpt_every`` (prefill only): the new state
    becomes ``(state, checkpoints)`` with checkpoints a MambaState of the
    states after every ``ckpt_every`` positions, conv (B, nb, K-1, C) and
    ssm (B, nb, H, P, N) with nb = S // ckpt_every.  ``ckpt_out``, a
    MambaState of tensors of those shapes (contiguous, ssm float32): the
    checkpoints are written into it, the SSD scan's straight from the
    kernel, and it is returned as the checkpoints.  A sharded ``ctx`` runs
    the block over its mesh (see the module doc)."""
    kw = dict(mode=mode, state=state, mask=mask, ckpt_every=ckpt_every,
              ckpt_out=ckpt_out)
    if ctx is not None and ctx.sharded:
        return _mamba_sharded(p, x, cfg, ctx, **kw)
    y, new_state = mamba_mix(p, x, cfg, **kw)
    y = rms_norm(y, p["gate_norm"], cfg.rms_eps)
    return y @ p["out_proj"], new_state


def _mamba_sharded(p, x, cfg: ArchConfig, ctx, **kw):
    """:func:`mamba_block` over a mesh: the one-device mix per position
    (its local heads under TP, every head replicated), then the gated
    RMSNorm over the whole ``d_inner`` and ``out_proj``, each followed by
    a ``psum`` under TP."""
    tp = mamba_tp(cfg, ctx)
    m = ctx.model_axis if tp else None

    def want(name, t):
        parts = [None] * t.dim()
        if m and name in _TP_DIM:
            parts[_TP_DIM[name]] = m
        return P(*parts)
    pl = {k: relayout(v, want(k, v)) for k, v in p.items()}
    y, new_state = _mix_per_position(pl, x, local_ssm_cfg(cfg, ctx), **kw)
    if not tp:
        y = rms_norm(y, pl["gate_norm"], cfg.rms_eps)
        return y @ pl["out_proj"], new_state
    # the gated RMSNorm reduces over the whole d_inner: float32 partial
    # sums of squares, one psum, then each position scales its slice
    y32 = y.to(F32)
    ss = psum((y32 * y32).sum(dim=-1, keepdim=True), ctx.model_axis)
    y32 = y32 * torch.rsqrt(ss / mamba_dims(cfg)[0] + cfg.rms_eps)
    y = (y32 * pl["gate_norm"].to(F32)).to(y.dtype)
    return psum(y @ pl["out_proj"], ctx.model_axis), new_state


def mamba_mix(p, x, cfg: ArchConfig, *, mode: str,
              state: Optional[MambaState] = None,
              mask: Optional[torch.Tensor] = None,
              ckpt_every: Optional[int] = None,
              ckpt_out: Optional[MambaState] = None):
    """The block up to its gated RMSNorm: (``y * silu(z)`` (B, S,
    d_inner) in x's dtype, new state); the arguments as
    :func:`mamba_block`'s."""
    s = cfg.ssm
    d_inner, H, G, N, K = mamba_dims(cfg)
    P_ = s.head_dim
    Bb, S, _ = x.shape

    z = x @ p["wz"]                                        # (B,S,d_inner)
    xs = x @ p["wx"]
    Bm = x @ p["wB"]                                       # (B,S,G*N)
    Cm = x @ p["wC"]
    dt_raw = x @ p["wdt"]                                  # (B,S,H)
    dt = softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))

    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    conv_in = (state.conv if (state is not None
                              and mode in ("decode", "extend")) else None)
    length = None
    if mask is not None and mode in ("prefill", "extend"):
        length = mask.to(torch.int32).sum(dim=1)
    conv_ck = None
    if ckpt_every is not None and mode == "prefill":
        xbc_conv, new_conv, conv_ck = _causal_conv(
            xbc, conv_w, conv_in, length=length, boundary_every=ckpt_every)
    else:
        xbc_conv, new_conv = _causal_conv(xbc, conv_w, conv_in, length=length)
    xbc_conv = F.silu(xbc_conv)
    xs_c = xbc_conv[..., :d_inner]
    Bm_c = xbc_conv[..., d_inner:d_inner + G * N].reshape(Bb, S, G, N)
    Cm_c = xbc_conv[..., d_inner + G * N:].reshape(Bb, S, G, N)
    xh = xs_c.reshape(Bb, S, H, P_)

    if mode == "decode":
        y, new_ssm = ssd_decode_step(state.ssm, xh, dt, p["A_log"], Bm_c, Cm_c)
        new_state = MambaState(conv=new_conv, ssm=new_ssm)
    else:
        init = state.ssm if state is not None else None
        if conv_ck is not None:
            # checkpoints land on SSD chunk boundaries, so the scan runs at
            # the checkpoint granularity: exact at any chunk size
            y, final, ssm_ck = ssd(
                xh, dt, p["A_log"], Bm_c, Cm_c, chunk=ckpt_every,
                initial_state=init, mask=mask, checkpoints=True,
                ckpt_out=None if ckpt_out is None else ckpt_out.ssm)
            if ckpt_out is not None:
                conv_ck = ckpt_out.conv.copy_(conv_ck)
            new_state = (MambaState(conv=new_conv, ssm=final),
                         MambaState(conv=conv_ck, ssm=ssm_ck))
        else:
            y, final = ssd(xh, dt, p["A_log"], Bm_c, Cm_c, chunk=s.chunk,
                           initial_state=init, mask=mask)
            # training keeps no state, as JAX's train mode
            new_state = (None if mode == "train"
                         else MambaState(conv=new_conv, ssm=final))

    y = y + xh.to(F32) * p["D_skip"][None, None, :, None].to(F32)
    y = y.reshape(Bb, S, d_inner).to(x.dtype)
    return y * F.silu(z.to(F32)).to(x.dtype), new_state


# one position's mix on its own shards (over a mesh every op, the SSD
# kernel's launch among them, is that position's one-device call)
_mix_per_position = per_position(mamba_mix)
