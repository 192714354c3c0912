"""Mamba-2 SSD: the per-chunk kernel's dispatch and the full scan around it.

``ssd_chunks`` dispatches by device: a CPU tensor takes the plain version
in ``ref.py``; a CUDA tensor launches the hand-written kernel in
``csrc/ssd_scan.cu`` or raises.  There is no fallback from one to the
other.  ``ssd`` is the scan the model calls, as ``repro.kernels.ssd_scan.
ops.ssd`` wraps the Pallas kernel: the dt mask, the per-chunk kernel, the
inter-chunk recurrence and the state -> output term, plus the state after
every chunk on request (``checkpoints``), which the snapshot cache plane
interns.
"""
from __future__ import annotations

import math
import warnings

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

F32 = torch.float32


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


def ssd_chunks(x, dA, B, C):
    """x: (Bb, H, nc, Q, P); dA: (Bb, H, nc, Q); B/C: (Bb, G, nc, Q, N),
    float32, any strides -> (y_diag (Bb, H, nc, Q, P), states (Bb, H, nc,
    P, N), decay (Bb, H, nc)).  On the card y_diag is a view of a
    contiguous (Bb, nc, Q, H, P) buffer, the model's (B, S, H, P) layout.
    ``ssd_chunks.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dA, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    Bb, H, nc, Q, P = x.shape
    G, N = B.shape[1], B.shape[4]
    if (dA.shape != (Bb, H, nc, Q) or B.shape != (Bb, G, nc, Q, N)
            or C.shape != B.shape or H % G):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dA "
                         f"{tuple(dA.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)}")
    if P % 4 or N % 4 or P > 256:
        raise ValueError(f"the SSD kernel takes P and N that are multiples "
                         f"of 4 and P <= 256, got P {P} N {N}")
    for t in (x, dA, B, C):
        if t.dtype != F32:
            raise ValueError(f"the SSD kernel takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    y = torch.empty((Bb, nc, Q, H, P), dtype=F32,
                    device=x.device).permute(0, 3, 1, 2, 4)
    states = torch.empty((Bb, H, nc, P, N), dtype=F32, device=x.device)
    decay = torch.empty((Bb, H, nc), dtype=F32, device=x.device)
    fn = _build.kernel("rt_ssd_chunks",
                       "PLLLLL PLLLL PLLLLL PLLLLL PLLLLL PP IIIIIII P")
    rc = fn(x.data_ptr(), *x.stride(), dA.data_ptr(), *dA.stride(),
            B.data_ptr(), *B.stride(), C.data_ptr(), *C.stride(),
            y.data_ptr(), *y.stride(), states.data_ptr(), decay.data_ptr(),
            Bb, H, G, nc, Q, P, N, _build.stream_ptr(x.device))
    ssd_chunks.launches += 1
    _build.check(rc, "ssd_chunks")
    return y, states, decay


ssd_chunks.launches = 0


def ssd(x, dt, A_log, B_in, C_in, *, chunk: int = 256, initial_state=None,
        mask=None, checkpoints: bool = False):
    """The chunked SSD scan.  x: (B, S, H, P); dt: (B, S, H) (post-softplus);
    A_log: (H,) (A = -exp(A_log)); B_in/C_in: (B, S, G, N).

    ``mask`` (B, S) bool zeroes ``dt`` at pad steps before the kernel, so
    they enter it as identity state updates (dA = 0, no input) and the
    final state is the state at each row's last real step.
    ``initial_state`` (B, H, P, N) seeds the recurrence.  Returns (y (B,
    S, H, P) float32, final state (B, H, P, N) float32), and with
    ``checkpoints`` also the state after every chunk, (B, nc, H, P, N),
    the contract of ``ssd_chunked(checkpoints=True)``.

    The inter-chunk recurrence is a loop over the nc chunks (two
    elementwise ops per chunk on the card, no host sync): ``h = states[c]
    + h * decay[c]``.  A row of pad steps has decay 1 and state 0, so its
    state passes through bit for bit.
    """
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    HG = H // G
    Q = ssd_tiling_chunk(S, chunk)
    nc = S // Q
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(A_log.to(F32))
    dA = dt.to(F32) * A                                        # (B,S,H)
    xw = x.to(F32) * dt.to(F32)[..., None]                     # (B,S,H,P)
    xk = xw.view(Bb, nc, Q, H, P).permute(0, 3, 1, 2, 4)      # (B,H,nc,Q,P)
    dAk = dA.view(Bb, nc, Q, H).permute(0, 3, 1, 2)           # (B,H,nc,Q)
    Bk = B_in.to(F32).reshape(Bb, nc, Q, G, N).permute(0, 3, 1, 2, 4)
    Ck = C_in.to(F32).reshape(Bb, nc, Q, G, N).permute(0, 3, 1, 2, 4)

    y_diag, states, decay = ssd_chunks(xk, dAk, Bk, Ck)

    # inter-chunk recurrence: hs[c] is the state entering chunk c, hs[nc]
    # the final state
    hs = torch.empty((nc + 1, Bb, H, P, N), dtype=F32, device=x.device)
    if initial_state is None:
        hs[0].zero_()
    else:
        hs[0].copy_(initial_state)
    for c in range(nc):
        torch.addcmul(states[:, :, c], hs[c], decay[:, :, c, None, None],
                      out=hs[c + 1])

    # state -> output: y_off[b,h,c,q,p] = exp(cs) * sum_n C[q,n] prev[p,n]
    cs = torch.cumsum(dAk, dim=-1)                             # (B,H,nc,Q)
    prev = hs[:nc].view(nc, Bb, G, HG, P, N)
    y_off = torch.einsum("bgcqn,cbghpn->bghcqp", Ck, prev)
    y_off = y_off.reshape(Bb, H, nc, Q, P) * torch.exp(cs)[..., None]
    # in place: on the card y_diag already lies in the (B, S, H, P) layout
    y = y_diag.add_(y_off).permute(0, 2, 3, 1, 4).reshape(Bb, S, H, P)
    if checkpoints:
        return y, hs[nc], hs[1:].transpose(0, 1)
    return y, hs[nc]
