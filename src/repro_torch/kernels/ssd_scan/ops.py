"""Mamba-2 SSD: the chunked scan the model calls, dispatched by device.

``ssd`` is the scan as ``repro.kernels.ssd_scan.ops.ssd`` wraps the Pallas
kernel: the dt mask, the per-chunk SSD, the inter-chunk recurrence and the
state -> output term, plus the state after every chunk on request
(``checkpoints``), which the snapshot cache plane interns.  A CPU tensor
takes the plain version ``ref.ssd_ref``; a CUDA tensor launches the
hand-written scan in ``csrc/ssd_scan.cu``, one launch a call, or raises.
There is no fallback from one to the other.  ``ssd_bwd`` is its
gradient: ``ref.ssd_bwd_ref`` on the CPU, the hand-written backward in
``csrc/ssd_scan_bwd.cu`` on the card (chunk-parallel: bf16 x, B and C
on the tensor cores, float32 on CUDA cores); a call of ``ssd`` that
autograd would record goes through the autograd Function ``_SSD``, which
joins the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import PLAIN_DEVICES
from repro_torch.kernels.ssd_scan.ref import (
    ssd_bwd_ref,
    ssd_bwd_span,
    ssd_ref,
    ssd_tiling_chunk,
)

F32 = torch.float32
#: sub-chunks of one span of the backward, bf16 and float32 routes: its
#: first kernel keeps the adjoint state at every span's end, its second
#: runs the spans in parallel (float32: 4, so that a row of 8 sub-chunks,
#: S 128, still makes two spans)
BWD_SPAN = 8
BWD_SPAN_F32 = 4


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
    at most 256, else ``ValueError``.  ``ssd.launches`` counts kernel
    launches.

    Differentiable in x, dt, A_log, B_in, C_in and ``initial_state``
    through y and the final state (the checkpoints are not): when grad is
    enabled and one of them requires it, the call goes through ``_SSD``,
    whose forward also keeps the state entering every sub-chunk of
    ``ssd_bwd_span(S, chunk)`` steps (on the card from the same single
    launch, as its checkpoints) for :func:`ssd_bwd`.  Under ``no_grad`` or
    ``inference_mode`` it is the serving call, nothing kept."""
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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A_log, B_in, C_in, initial_state)):
        out = _SSD.apply(x, dt, A_log, B_in, C_in, initial_state, mask,
                         chunk, checkpoints)
        if ckpt_out is not None:
            return out[0], out[1], ckpt_out.copy_(out[2])
        return out
    return _ssd_forward(x, dt, A_log, B_in, C_in, chunk, initial_state, mask,
                        checkpoints, ckpt_out)


def _ssd_forward(x, dt, A_log, B_in, C_in, chunk, initial_state, mask,
                 checkpoints, ckpt_out):
    """``ssd`` without autograd: the plain version on the CPU, one launch
    of the scan on the card."""
    Bb, S, H, P = x.shape
    if x.device.type in PLAIN_DEVICES:
        return ssd_ref(x, dt, A_log, B_in, C_in, chunk=chunk,
                       initial_state=initial_state, mask=mask,
                       checkpoints=checkpoints, ckpt_out=ckpt_out)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
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


class _SSD(torch.autograd.Function):
    """``ssd`` with its hand-written backward.  On the card the forward is
    one launch of the scan with a checkpoint at every sub-chunk of K =
    ``ssd_bwd_span(S, chunk)`` steps: those states (B, S / K, H, P, N)
    float32 are kept for the backward (336 MB at mamba2-2.7b's training
    microbatch B 4, S 512), and the caller's checkpoints, when asked for,
    are every (Q / K)-th of them.  On the CPU the forward is ``ssd_ref``
    and the backward ``ssd_bwd_ref``, which walks the states again."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B_in, C_in, initial_state, mask, chunk,
                checkpoints):
        S = x.shape[1]
        states = None
        if x.device.type in PLAIN_DEVICES:
            out = ssd_ref(x, dt, A_log, B_in, C_in, chunk=chunk,
                          initial_state=initial_state, mask=mask,
                          checkpoints=checkpoints)
        else:
            K = ssd_bwd_span(S, chunk)
            y, final, states = _ssd_forward(x, dt, A_log, B_in, C_in, K,
                                            initial_state, mask, True, None)
            out = (y, final)
            if checkpoints:
                every = ssd_tiling_chunk(S, chunk) // K
                out += (states[:, every - 1::every].contiguous(),)
        if checkpoints:
            ctx.mark_non_differentiable(out[2])
        ctx.save_for_backward(x, dt, A_log, B_in, C_in, initial_state, mask,
                              states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, d_final, *_):
        x, dt, A_log, B_in, C_in, init, mask, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=F32, device=x.device)
        dx, ddt, dA, dB, dC, d_init = ssd_bwd(
            x, dt, A_log, B_in, C_in, dy, d_final, chunk=ctx.chunk,
            initial_state=init, mask=mask, states=states)
        return (dx, ddt, dA, dB, dC,
                d_init if ctx.needs_input_grad[5] else None, None, None, None)


def ssd_bwd(x, dt, A_log, B_in, C_in, dy, d_final=None, *, chunk: int = 256,
            initial_state=None, mask=None, states=None):
    """The gradient of :func:`ssd`: (dx, ddt, dA_log, dB_in, dC_in, d
    initial_state) in the dtypes of x, dt, A_log, B_in, C_in and
    ``initial_state`` (float32 without one), from the cotangents ``dy``
    (B, S, H, P) of y and ``d_final`` (B, H, P, N, or None for zero) of
    the final state, under the forward's ``chunk``, ``initial_state`` and
    ``mask``.  A CPU tensor takes ``ref.ssd_bwd_ref``; a CUDA tensor
    launches ``rt_ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``), then the sums
    over heads, P tiles and blocks in a fixed order, so two calls are
    bitwise equal.  Both routes keep the adjoint at every span's end, then
    run the spans in parallel.  Routes by dtype: bf16 x, B and C take the
    tensor cores in split precision, spans of ``BWD_SPAN`` sub-chunks
    (``ssd_bwd.launches_tc`` counts them); float32 takes CUDA cores, every
    product an exact float32 ``fmaf``, spans of ``BWD_SPAN_F32``.
    ``states``, on the card: the forward's state after every sub-chunk of
    ``ssd_bwd_span(S, chunk)`` steps, (B, S / K, H, P, N) contiguous
    float32 (``_SSD`` keeps them); without them one launch of the scan
    computes them first.  The card takes what the forward takes (P and N
    multiples of 4 up to 256), else ``ValueError``.
    ``ssd_bwd.launches`` counts its calls on the card."""
    Bb, S, H, P = x.shape
    if x.device.type in PLAIN_DEVICES:
        out = ssd_bwd_ref(x, dt, A_log, B_in, C_in, dy, d_final, chunk=chunk,
                          initial_state=initial_state, mask=mask)
        return _grad_dtypes(out, (x, dt, A_log, B_in, C_in, initial_state))
    if x.device.type != "cuda":
        raise ValueError(f"no SSD backward for device {x.device}")
    G, N = B_in.shape[2], B_in.shape[3]
    if (dt.shape != (Bb, S, H) or A_log.shape != (H,)
            or B_in.shape != (Bb, S, G, N) or C_in.shape != B_in.shape
            or dy.shape != x.shape or H % G
            or (d_final is not None and d_final.shape != (Bb, H, P, N))):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A_log {tuple(A_log.shape)} B {tuple(B_in.shape)} "
                         f"C {tuple(C_in.shape)} dy {tuple(dy.shape)}")
    if P % 4 or N % 4 or P > 256 or N > 256:
        raise ValueError(f"the SSD backward takes P and N that are multiples "
                         f"of 4 and at most 256, got P {P} N {N}")
    if mask is not None and mask.shape != (Bb, S):
        raise ValueError(f"mask {tuple(mask.shape)} is not (B, S)")
    if initial_state is not None and initial_state.shape != (Bb, H, P, N):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is not "
                         f"(B, H, P, N)")
    for t in (dt, A_log, B_in, C_in, dy, d_final, mask, initial_state,
              states):
        if t is not None and t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    K = ssd_bwd_span(S, chunk)
    if states is None:
        states = _ssd_forward(x, dt, A_log, B_in, C_in, K, initial_state,
                              mask, True, None)[2]
    if (states.shape != (Bb, S // K, H, P, N) or states.dtype != F32
            or not states.is_contiguous()):
        raise ValueError(f"states must be contiguous float32 "
                         f"{(Bb, S // K, H, P, N)}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    like = (x, dt, A_log, B_in, C_in, initial_state)
    if (x.dtype not in (F32, torch.bfloat16) or B_in.dtype != x.dtype
            or C_in.dtype != x.dtype):
        x, B_in, C_in = x.to(F32), B_in.to(F32), C_in.to(F32)
    dt, A_log, dy = dt.to(F32), A_log.to(F32).contiguous(), dy.to(F32)
    if mask is not None:
        mask = mask.to(torch.bool)
    if initial_state is not None:
        initial_state = initial_state.to(F32)
    if d_final is not None:
        d_final = d_final.to(F32)
    dev = x.device
    npt = -(-P // 64)                    # P tiles of the kernel's blocks
    tc = x.dtype == torch.bfloat16
    span = BWD_SPAN if tc else BWD_SPAN_F32
    n_span = -(-(S // K) // span)
    # the kernels stage rows with 16-byte copies (bf16 x, B and C 8-byte)
    x, B_in, C_in = (_rows(t, 8 if tc else 16) for t in (x, B_in, C_in))
    dy = _rows(dy, 16)

    def empty(*shape, dtype=F32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # dx, dB and dC in x's dtype (the kernels round bf16 ones), the rest
    # float32
    dx, d_init = empty(Bb, S, H, P, dtype=x.dtype), empty(Bb, H, P, N)
    ddt, dA = empty(Bb, S, H), empty(H)
    dB, dC = empty(Bb, S, G, N, dtype=x.dtype), empty(Bb, S, G, N, dtype=x.dtype)
    # per (head, P tile) and per block partials, summed by the last kernel
    dtp, dbp, dcp, dap = empty(Bb, S, H, npt), empty(Bb, S, H, npt, N), \
        empty(Bb, S, H, npt, N), empty(Bb, n_span, H, npt)
    hs = empty(Bb, n_span, H, P, N)
    fn = _build.kernel("rt_ssd_scan_bwd", "PLLLLI PLLLP PLLLL PLLLL PLL "
                                          "PLLLL PLLLL PLLLL PP PPPPPP PPPP "
                                          "IIIIIIII P")
    strides = lambda t, n: t.stride() if t is not None else (0,) * n  # noqa: E731
    rc = fn(x.data_ptr(), *x.stride(), _build.DTYPE_CODE[x.dtype],
            dt.data_ptr(), *dt.stride(), A_log.data_ptr(),
            B_in.data_ptr(), *B_in.stride(), C_in.data_ptr(), *C_in.stride(),
            _build.ptr(mask), *strides(mask, 2),
            _build.ptr(initial_state), *strides(initial_state, 4),
            dy.data_ptr(), *dy.stride(),
            _build.ptr(d_final), *strides(d_final, 4),
            states.data_ptr(), hs.data_ptr(), dx.data_ptr(), dtp.data_ptr(),
            dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), d_init.data_ptr(),
            ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
            Bb, S, H, G, P, N, K, span, _build.stream_ptr(dev))
    ssd_bwd.launches += 1
    ssd_bwd.launches_tc += tc
    _build.check(rc, "ssd_bwd")
    return _grad_dtypes((dx, ddt, dA, dB, dC, d_init), like)


ssd_bwd.launches = 0
ssd_bwd.launches_tc = 0
_build.count_launches(ssd_bwd, "launches", "launches_tc")


def _rows(t, align: int):
    """``t`` with unit stride in its last dimension and its start and
    every other stride on ``align`` bytes: itself, or a contiguous copy
    (whose rows are on 16 bytes for float32 with P a multiple of 4, on 8
    for bf16)."""
    e = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % align == 0
            and all(st * e % align == 0 for st, n in zip(t.stride()[:-1],
                                                          t.shape[:-1]) if n > 1)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _grad_dtypes(grads, like):
    """The float32 gradients cast to the dtypes of their inputs ``like``
    (float32 for an absent initial state)."""
    return tuple(g if t is None else g.to(t.dtype)
                 for g, t in zip(grads, like))
