"""Mamba-2 SSD: the chunked scan the model calls, dispatched by device.

``ssd`` is the scan as ``repro.kernels.ssd_scan.ops.ssd`` wraps the Pallas
kernel: the dt mask, the per-chunk SSD, the inter-chunk recurrence and the
state -> output term, plus the state after every chunk on request
(``checkpoints``), which the snapshot cache plane interns.  A CPU tensor
takes the plain version ``ref.ssd_ref``; a CUDA tensor launches the
hand-written scan in ``csrc/ssd_scan.cu``, one launch a call, or raises.
There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_tiling_chunk

F32 = torch.float32
#: why training an ssm or hybrid model on the card raises
GRAD_ITEM = ("the SSD scan kernel has no backward yet: training an ssm or "
             "hybrid model on the card comes with ROADMAP queue 2 item 8")


def ssd(x, dt, A_log, B_in, C_in, *, chunk: int = 256, initial_state=None,
        mask=None, checkpoints: bool = False, ckpt_out=None):
    """The chunked SSD scan.  x: (B, S, H, P); dt: (B, S, H) (post-softplus);
    A_log: (H,) (A = -exp(A_log)); B_in/C_in: (B, S, G, N).

    ``mask`` (B, S) bool zeroes ``dt`` at pad steps, so they are identity
    state updates (dA = 0, no input) and the final state is the state at
    each row's last real step.  ``initial_state`` (B, H, P, N) seeds the
    recurrence.  Returns (y (B, S, H, P) float32, final state (B, H, P, N)
    float32), and with ``checkpoints`` also the state after every chunk of
    ``ssd_tiling_chunk(S, chunk)`` steps, (B, nc, H, P, N), the contract of
    ``ssd_chunked(checkpoints=True)``.  A row of pad steps keeps its state
    bit for bit.  ``ckpt_out``, a contiguous float32 (B, nc, H, P, N)
    tensor on x's device (with ``checkpoints`` only): the checkpoints are
    written into it (on the card by the kernel itself) and it is returned
    as the checkpoints.

    On the card x, B_in and C_in are read as stored when they share a
    float32 or bfloat16 dtype (else they are cast to float32 first), the
    mask and the strides as given; P and N must be multiples of 4, P and N
    at most 256, else ``ValueError``.  The kernel has no backward: on the
    card a call that autograd would record raises ``NotImplementedError``
    (the CPU's plain version is differentiable).  ``ssd.launches`` counts
    kernel launches."""
    Bb, S, H, P = x.shape
    if ckpt_out is not None:
        want = (Bb, S // ssd_tiling_chunk(S, chunk), H, P, B_in.shape[3])
        if (not checkpoints or ckpt_out.shape != want
                or ckpt_out.dtype != F32 or not ckpt_out.is_contiguous()
                or ckpt_out.device != x.device):
            raise ValueError(f"ckpt_out must be a contiguous float32 {want} "
                             f"tensor on {x.device} (with checkpoints), got "
                             f"{ckpt_out.dtype} {tuple(ckpt_out.shape)} on "
                             f"{ckpt_out.device}")
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A_log, B_in, C_in, chunk=chunk,
                       initial_state=initial_state, mask=mask,
                       checkpoints=checkpoints, ckpt_out=ckpt_out)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A_log, B_in, C_in, initial_state)):
        raise NotImplementedError(GRAD_ITEM)
    G, N = B_in.shape[2], B_in.shape[3]
    if (dt.shape != (Bb, S, H) or A_log.shape != (H,)
            or B_in.shape != (Bb, S, G, N) or C_in.shape != B_in.shape
            or H % G):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A_log {tuple(A_log.shape)} B {tuple(B_in.shape)} "
                         f"C {tuple(C_in.shape)}")
    if P % 4 or N % 4 or P > 256 or N > 256:
        raise ValueError(f"the SSD kernel takes P and N that are multiples "
                         f"of 4 and at most 256, got P {P} N {N}")
    if mask is not None and mask.shape != (Bb, S):
        raise ValueError(f"mask {tuple(mask.shape)} is not (B, S)")
    if initial_state is not None and initial_state.shape != (Bb, H, P, N):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is not "
                         f"(B, H, P, N)")
    for t in (dt, A_log, B_in, C_in, mask, initial_state):
        if t is not None and t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    Q = ssd_tiling_chunk(S, chunk)
    if (x.dtype not in (F32, torch.bfloat16) or B_in.dtype != x.dtype
            or C_in.dtype != x.dtype):
        x, B_in, C_in = x.to(F32), B_in.to(F32), C_in.to(F32)
    dt, A_log = dt.to(F32), A_log.to(F32).contiguous()
    if mask is not None:
        mask = mask.to(torch.bool)
    if initial_state is not None:
        initial_state = initial_state.to(F32)
    dev = x.device
    y = torch.empty((Bb, S, H, P), dtype=F32, device=dev)
    final = torch.empty((Bb, H, P, N), dtype=F32, device=dev)
    ck = ckpt_out
    if checkpoints and ck is None:
        ck = torch.empty((Bb, S // Q, H, P, N), dtype=F32, device=dev)
    fn = _build.kernel("rt_ssd_scan", "PLLLLI PLLLP PLLLL PLLLL PLL PLLLL "
                                      "PPP IIIIIII P")
    rc = fn(x.data_ptr(), *x.stride(), _build.DTYPE_CODE[x.dtype],
            dt.data_ptr(), *dt.stride(), A_log.data_ptr(),
            B_in.data_ptr(), *B_in.stride(), C_in.data_ptr(), *C_in.stride(),
            _build.ptr(mask), *(mask.stride() if mask is not None else (0, 0)),
            _build.ptr(initial_state),
            *(initial_state.stride() if initial_state is not None
              else (0, 0, 0, 0)),
            y.data_ptr(), final.data_ptr(), _build.ptr(ck),
            Bb, S, H, G, P, N, Q if checkpoints else S,
            _build.stream_ptr(dev))
    ssd.launches += 1
    _build.check(rc, "ssd")
    if checkpoints:
        return y, final, ck
    return y, final


ssd.launches = 0
_build.count_launches(ssd, "launches")
