"""Plain PyTorch versions of the SSD scan.

``ssd_ref`` is the CPU path of ``ops.ssd`` and the yardstick the CUDA scan
is held against on the card: the per-chunk ``ssd_chunk_ref`` (the oracle
of the TPU kernel ``_ssd_chunk_kernel``), the inter-chunk recurrence and
the state -> output term, as ``repro.kernels.ssd_scan.ops.ssd`` wraps the
Pallas kernel.  ``ssd_scan_ref`` follows the CUDA scan's own order of
work (sub-chunks of 16 steps, the running state carried between them),
and ``ssd_bwd_ref``, the gradient, that of the CUDA backward's bf16 route
(``csrc/ssd_scan_bwd.cu``): the adjoint state at every sub-chunk's end
by a short scan backwards, then every sub-chunk's body in parallel.
"""
from __future__ import annotations

import math
import warnings

import torch

F32 = torch.float32
#: steps of one sub-chunk of the CUDA scan, at most
SUB = 16


def ssd_tiling_chunk(S: int, chunk: int) -> int:
    """Largest usable SSD chunk that tiles ``S`` exactly: ``chunk`` capped
    at S, degraded to ``gcd(S, chunk)`` (with a warning: a degenerate gcd
    is a per-step recurrence) when it does not divide S."""
    Q = min(chunk, S)
    if S % Q:
        Q = math.gcd(S, Q)
        warnings.warn(f"ssd: S={S} is not a multiple of chunk={chunk}; "
                      f"degrading to chunk {Q}", stacklevel=3)
    return Q


def ssd_chunk_ref(x, dA, B, C):
    """Per-chunk SSD: intra-chunk output, chunk state and chunk decay.

    x:  (Bb, H, nc, Q, P)   dt-weighted inputs
    dA: (Bb, H, nc, Q)      per-step log decays (dt * A, negative)
    B, C: (Bb, G, nc, Q, N) group-shared input / output projections

    Pad steps arrive with dA = 0 and x = 0 (the wrapper masks ``dt``), an
    identity state update, so no mask is needed here.  Any strides are
    accepted.  Returns (y_diag (Bb, H, nc, Q, P), states (Bb, H, nc, P,
    N), decay (Bb, H, nc)), all float32.
    """
    Bb, H, nc, Q, P = x.shape
    HG = H // B.shape[1]
    x, dA, B, C = (t.to(F32) for t in (x, dA, B, C))
    cs = torch.cumsum(dA, dim=-1)                              # (Bb,H,nc,Q)
    diff = cs[..., :, None] - cs[..., None, :]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # exp of -inf above the diagonal: 0 with a zero gradient (exp(diff)
    # there can overflow, and where() would pass inf * 0 back)
    L = torch.exp(torch.where(tril, diff, -torch.inf))
    Bh = B.repeat_interleave(HG, dim=1)                        # (Bb,H,nc,Q,N)
    Ch = C.repeat_interleave(HG, dim=1)
    scores = torch.einsum("bhcqn,bhckn->bhcqk", Ch, Bh) * L
    y_diag = torch.einsum("bhcqk,bhckp->bhcqp", scores, x)
    decay_states = torch.exp(cs[..., -1:] - cs)                # (Bb,H,nc,Q)
    states = torch.einsum("bhcqp,bhcqn,bhcq->bhcpn", x, Bh, decay_states)
    decay = torch.exp(cs[..., -1])                             # (Bb,H,nc)
    return y_diag, states, decay


def _weighted(x, dt, A_log, mask):
    """(x dt, dt A) in float32 with ``dt`` zeroed at masked steps: pad
    steps become identity state updates (dA = 0, no input)."""
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(A_log.to(F32))
    return x.to(F32) * dt.to(F32)[..., None], dt.to(F32) * A


def ssd_ref(x, dt, A_log, B_in, C_in, *, chunk: int = 256,
            initial_state=None, mask=None, checkpoints: bool = False,
            ckpt_out=None):
    """The chunked SSD scan in plain PyTorch (``ops.ssd``'s contract):
    ``ssd_chunk_ref`` over chunks of Q steps, then the recurrence ``h =
    states[c] + h * decay[c]`` chunk by chunk and the state -> output term.
    A row of pad steps has decay 1 and state 0, so its state passes
    through bit for bit.  ``ckpt_out`` (B, nc, H, P, N): the checkpoints
    are copied into it, and it is returned as the checkpoints."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    HG = H // G
    Q = ssd_tiling_chunk(S, chunk)
    nc = S // Q
    xw, dA = _weighted(x, dt, A_log, mask)
    xk = xw.view(Bb, nc, Q, H, P).permute(0, 3, 1, 2, 4)      # (B,H,nc,Q,P)
    dAk = dA.view(Bb, nc, Q, H).permute(0, 3, 1, 2)           # (B,H,nc,Q)
    Bk = B_in.to(F32).reshape(Bb, nc, Q, G, N).permute(0, 3, 1, 2, 4)
    Ck = C_in.to(F32).reshape(Bb, nc, Q, G, N).permute(0, 3, 1, 2, 4)

    y_diag, states, decay = ssd_chunk_ref(xk, dAk, Bk, Ck)

    # inter-chunk recurrence: hs[c] is the state entering chunk c, hs[nc]
    # the final state
    # (a list, so that autograd can run through it in training)
    hs = [torch.zeros((Bb, H, P, N), dtype=F32, device=x.device)
          if initial_state is None else initial_state.to(F32)]
    for c in range(nc):
        hs.append(torch.addcmul(states[:, :, c], hs[c],
                                decay[:, :, c, None, None]))
    hs = torch.stack(hs)

    # state -> output: y_off[b,h,c,q,p] = exp(cs) * sum_n C[q,n] prev[p,n]
    cs = torch.cumsum(dAk, dim=-1)                             # (B,H,nc,Q)
    prev = hs[:nc].view(nc, Bb, G, HG, P, N)
    y_off = torch.einsum("bgcqn,cbghpn->bghcqp", Ck, prev)
    y_off = y_off.reshape(Bb, H, nc, Q, P) * torch.exp(cs)[..., None]
    y = (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(Bb, S, H, P)
    if checkpoints:
        ck = hs[1:].transpose(0, 1)
        return y, hs[nc], ck if ckpt_out is None else ckpt_out.copy_(ck)
    return y, hs[nc]


def ssd_scan_ref(x, dt, A_log, B_in, C_in, *, chunk: int = 256,
                 initial_state=None, mask=None, checkpoints: bool = False):
    """The CUDA scan's order of work in plain PyTorch, same contract as
    ``ssd_ref``: each row walked in sub-chunks of at most ``SUB`` steps
    that never straddle a checkpoint (chunks of Q steps when
    ``checkpoints``, else the whole row), with the running state h carried
    from one to the next.  Per sub-chunk, with cs the cumsum of dt A over
    its steps: ``y_i = exp(cs_i) C_i h^T + sum_{j <= i} (C_i . B_j)
    exp(cs_i - cs_j) x'_j``, then ``h = exp(cs_T) h + sum_j exp(cs_T -
    cs_j) x'_j^T B_j``."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    HG = H // G
    Q = ssd_tiling_chunk(S, chunk)
    span = Q if checkpoints else S
    xw, dA = _weighted(x, dt, A_log, mask)
    Bh = B_in.to(F32).repeat_interleave(HG, dim=2)             # (B,S,H,N)
    Ch = C_in.to(F32).repeat_interleave(HG, dim=2)
    h = (torch.zeros((Bb, H, P, N), dtype=F32, device=x.device)
         if initial_state is None else initial_state.to(F32).clone())
    y = torch.empty((Bb, S, H, P), dtype=F32, device=x.device)
    ck = []
    for c0 in range(0, S, span):
        for s0 in range(c0, c0 + span, SUB):
            s1 = min(s0 + SUB, c0 + span)
            T = s1 - s0
            cs = torch.cumsum(dA[:, s0:s1], dim=1)                 # (B,T,H)
            tril = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                         device=x.device))[None, :, :, None]
            L = torch.where(tril, torch.exp(cs[:, :, None] - cs[:, None]),
                            0.0)                                   # (B,Ti,Tj,H)
            Cs, Bs, xs = Ch[:, s0:s1], Bh[:, s0:s1], xw[:, s0:s1]
            scores = torch.einsum("bihn,bjhn->bijh", Cs, Bs) * L
            y_diag = torch.einsum("bijh,bjhp->bihp", scores, xs)
            y_off = torch.einsum("bihn,bhpn->bihp", Cs, h)
            y[:, s0:s1] = torch.exp(cs)[..., None] * y_off + y_diag
            w = torch.exp(cs[:, -1:] - cs)                         # (B,T,H)
            h = (h * torch.exp(cs[:, -1])[..., None, None]
                 + torch.einsum("bjhp,bjhn,bjh->bhpn", xs, Bs, w))
        ck.append(h)
    if checkpoints:
        return y, h, torch.stack(ck, dim=1)
    return y, h


def ssd_bwd_span(S: int, chunk: int) -> int:
    """Steps of one sub-chunk of the backward: ``gcd(Q, SUB)`` for the
    forward's chunk ``Q = ssd_tiling_chunk(S, chunk)``, so that it divides
    S and, when Q is a multiple of ``SUB``, the forward's sub-chunks are
    the backward's.  The backward reads the state entering each one."""
    return math.gcd(ssd_tiling_chunk(S, chunk), SUB)


def ssd_bwd_ref(x, dt, A_log, B_in, C_in, dy, d_final=None, *,
                chunk: int = 256, initial_state=None, mask=None):
    """The gradient of ``ssd``'s (y, final state) in plain PyTorch, with
    no autograd, in the order of work of the CUDA backward's bf16 route
    (``csrc/ssd_scan_bwd.cu``), in sub-chunks of K = ``ssd_bwd_span(S,
    chunk)`` steps.  Per sub-chunk c, with g = dy, x' = x dt', cs the
    cumsum of a = dt' A over its steps, T its last step and L_ij =
    exp(cs_i - cs_j) for j <= i:

    1. the states h0 entering each sub-chunk, from a forward walk (the
       states the forward keeps on the card);
    2. per sub-chunk, in parallel: U_c = sum_i exp(cs_i) g_i C_i^T and the
       decay exp(cs_T);
    3. the adjoint H_c (dL/d the state at sub-chunk c's end) by a short
       scan backwards over the sub-chunks, H_{c-1} = exp(cs_T) H_c + U_c
       from ``d_final`` (or zero); d initial_state is H before the first;
    4. per sub-chunk, in parallel, from its h0 and H:

       * dx'_j = sum_{i >= j} (C_i . B_j) L_ij g_i + exp(cs_T - cs_j) H B_j;
       * dB_j = sum_{i >= j} (g_i . x'_j) L_ij C_i + exp(cs_T - cs_j)
         H^T x'_j;
       * dC_i = sum_{j <= i} (g_i . x'_j) L_ij B_j + exp(cs_i) h0^T g_i;
       * da_k, the gradient of a_k through every product whose decay
         spans step k: the outputs i >= k against h0 (exp(cs_i) g_i . h0
         C_i), the state against h0 and the inputs j < k (exp(cs_T) <H,
         h0>, exp(cs_T - cs_j) x'_j . H B_j), and the pairs i >= k > j
         ((C_i . B_j)(g_i . x'_j) L_ij), each a sum of what the
         recurrence carries across k (the derivative of cs summed
         backwards would cancel terms a pair adds to one step and takes
         from another).

    dx = dx' dt', ddt = mask (dx' . x + A da), dA_log = A sum dt' da, and
    dB, dC summed over each group's heads.  Returns (dx (B, S, H, P), ddt
    (B, S, H), dA_log (H,), dB, dC (B, S, G, N), d initial_state (B, H, P,
    N)), all float32; where dt' is zero, dx, ddt and dB are exactly 0."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    HG = H // G
    K = ssd_bwd_span(S, chunk)
    nc = S // K
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros_like(dt))
    dtm = dt.to(F32)
    A = -torch.exp(A_log.to(F32))
    xr = x.to(F32)
    xw = xr * dtm[..., None]                                   # (B,S,H,P)
    Bh = B_in.to(F32).repeat_interleave(HG, dim=2)             # (B,S,H,N)
    Ch = C_in.to(F32).repeat_interleave(HG, dim=2)

    def chunks(t):                                   # (B,S,...) -> (B,nc,K,...)
        return t.reshape(Bb, nc, K, *t.shape[2:])
    xs, gs, Bs, Cs = (chunks(t) for t in (xw, dy.to(F32), Bh, Ch))
    cs = torch.cumsum(chunks(dtm * A), dim=2)                  # (B,nc,K,H)
    ec = torch.exp(cs)
    dec = torch.exp(cs[:, :, -1])                              # (B,nc,H)
    wt = torch.exp(cs[:, :, -1:] - cs)

    # 1. the states entering each sub-chunk
    st = torch.einsum("bckhp,bckhn,bckh->bchpn", xs, Bs, wt)
    h = (torch.zeros((Bb, H, P, N), dtype=F32, device=x.device)
         if initial_state is None else initial_state.to(F32))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * dec[:, c, :, None, None] + st[:, c]
    h_in = torch.stack(h_in, 1)                                # (B,nc,H,P,N)

    # 2. U_c; 3. the adjoint at every sub-chunk's end, scanned backwards
    u_c = torch.einsum("bckh,bckhp,bckhn->bchpn", ec, gs, Cs)
    hb = (torch.zeros((Bb, H, P, N), dtype=F32, device=x.device)
          if d_final is None else d_final.to(F32))
    h_end = [None] * nc
    for c in reversed(range(nc)):
        h_end[c] = hb
        hb = hb * dec[:, c, :, None, None] + u_c[:, c]
    h_end = torch.stack(h_end, 1)                              # (B,nc,H,P,N)

    # 4. the sub-chunks' bodies
    tril = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                 device=x.device))[:, :, None]
    L = torch.where(tril, torch.exp(cs[:, :, :, None] - cs[:, :, None]),
                    0.0)                                       # (B,nc,Ki,Kj,H)
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cs, Bs)
    gx = torch.einsum("bcihp,bcjhp->bcijh", gs, xs)
    sc, ml = cb * L, gx * L
    z = torch.einsum("bchpn,bcihp->bcihn", h_in, gs)           # h0^T g_i
    w = torch.einsum("bchpn,bcjhp->bcjhn", h_end, xs)          # H^T x'_j
    v = torch.einsum("bchpn,bcjhn->bcjhp", h_end, Bs)          # H B_j
    dxw = torch.einsum("bcijh,bcihp->bcjhp", sc, gs) + wt[..., None] * v
    dBh = torch.einsum("bcijh,bcihn->bcjhn", ml, Cs) + wt[..., None] * w
    dCh = torch.einsum("bcijh,bcjhn->bcihn", ml, Bs) + ec[..., None] * z
    yo = ec * (Cs * z).sum(-1)                                 # (B,nc,K,H)
    u = wt * (Bs * w).sum(-1)
    steps = torch.arange(K, device=x.device)
    # spans[k, i, j]: the pair (i, j) crosses step k (i >= k > j)
    spans = ((steps[None, :, None] >= steps[:, None, None])
             & (steps[None, None, :] < steps[:, None, None])).to(F32)
    da = ((dec * (h_end * h_in).sum((-2, -1)))[:, :, None]
          + torch.cumsum(u, 2) - u
          + torch.flip(torch.cumsum(torch.flip(yo, (2,)), 2), (2,))
          + torch.einsum("bcijh,kij->bckh", sc * gx, spans))

    dxw, dBh, dCh = (t.reshape(Bb, S, H, -1) for t in (dxw, dBh, dCh))
    da = da.reshape(Bb, S, H)
    ddt = (dxw * xr).sum(-1) + A * da
    if mask is not None:
        ddt = torch.where(mask[..., None], ddt, torch.zeros_like(ddt))
    dA_log = A * (dtm * da).sum((0, 1))
    return (dxw * dtm[..., None], ddt, dA_log,
            dBh.view(Bb, S, G, HG, N).sum(3), dCh.view(Bb, S, G, HG, N).sum(3),
            hb)


def ssd_dA_log_scale(x, dt, mask, dx, ddt):
    """The scale of dA_log = A sum_{b, s} dt' da, a sum whose terms cancel:
    |A| sum |dt' da| by head (H,), from the gradients ``dx`` = dx' dt' and
    ``ddt`` = dx' . x + A da of the same call (steps with dt' = 0 add
    nothing).  A float32 evaluation of dA_log carries errors of about
    float32's epsilon times this, whatever its order of work, so gradients
    are held against each other relative to it."""
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros_like(dt))
    dt = dt.to(torch.float64)
    live = dt != 0
    dxp = dx.to(torch.float64) / torch.where(live, dt, 1.0)[..., None]
    a_da = ddt.to(torch.float64) - (dxp * x.to(torch.float64)).sum(-1)
    return torch.where(live, dt * a_da, 0.0).abs().sum((0, 1))
