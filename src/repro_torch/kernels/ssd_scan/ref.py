"""Plain PyTorch version of the per-chunk SSD computation (the oracle of
``csrc/ssd_scan.cu``)."""
from __future__ import annotations

import torch

F32 = torch.float32


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
    L = torch.where(tril, torch.exp(diff), 0.0)
    Bh = B.repeat_interleave(HG, dim=1)                        # (Bb,H,nc,Q,N)
    Ch = C.repeat_interleave(HG, dim=1)
    scores = torch.einsum("bhcqn,bhckn->bhcqk", Ch, Bh) * L
    y_diag = torch.einsum("bhcqk,bhckp->bhcqp", scores, x)
    decay_states = torch.exp(cs[..., -1:] - cs)                # (Bb,H,nc,Q)
    states = torch.einsum("bhcqp,bhcqn,bhcq->bhcpn", x, Bh, decay_states)
    decay = torch.exp(cs[..., -1])                             # (Bb,H,nc)
    return y_diag, states, decay
