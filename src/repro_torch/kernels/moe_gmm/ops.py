"""Grouped expert GEMM and its gradient: dispatch by device.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the hand-written kernels in ``csrc/moe_gmm.cu`` or raises.  There is no
fallback from one to the other.  ``gmm_bwd`` is the gradient of ``gmm``;
a call of ``gmm`` that autograd would record goes through the autograd
Function ``_GMM``, which joins the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm.ref import gmm_bwd_ref, gmm_ref


def gmm(x, w, counts):
    """x: (E, C, D) capacity layout; w: (E, D, F); counts: (E,) int ->
    (E, C, F) with ``out[e, c] = x[e, c] @ w[e]`` for ``c < counts[e]`` and
    0 past it.  ``counts`` stays on the device: the kernel reads it there,
    so nothing is synchronised.  On the card the route is by dtype alone:
    bfloat16 launches the tensor-core kernel, float32 the CUDA-core kernel,
    whose products stay exact float32.  Differentiable in x and w: when
    grad is enabled and one of them requires it, the call goes through
    ``_GMM`` (the same launch, with :func:`gmm_bwd` as its backward); else
    it is the serving call.  ``gmm.launches`` counts kernel launches,
    ``gmm.launches_tc`` those of the tensor-core kernel, and
    ``gmm.launches_by_capacity`` all launches by C."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GMM.apply(x, w, counts)
    return _gmm(x, w, counts)


def _check(x, w, counts, what: str):
    """The shape, dtype and device checks of a card call; returns (E, C,
    D, F) and counts as contiguous int32."""
    if x.device.type != "cuda":
        raise ValueError(f"no grouped GEMM kernel for device {x.device}")
    E, C, D = x.shape
    F = w.shape[2]
    if w.shape != (E, D, F) or counts.shape != (E,):
        raise ValueError(f"{what}: bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} counts {tuple(counts.shape)}")
    if w.dtype != x.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x {x.dtype} and w {w.dtype} must share a float32 "
                         "or bfloat16 dtype")
    for t in (w, counts):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    return (E, C, D, F), counts.to(dtype=torch.int32).contiguous()


def _gmm(x, w, counts):
    """The forward without autograd: ``gmm_ref`` on the CPU, one launch of
    ``rt_gmm`` on the card."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, counts)
    (E, C, D, F), cnt = _check(x, w, counts, "gmm")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    fn = _build.kernel("rt_gmm", "PPPP IIIII P")
    rc = fn(x.data_ptr(), w.data_ptr(), cnt.data_ptr(), out.data_ptr(),
            E, C, D, F, _build.DTYPE_CODE[x.dtype],
            _build.stream_ptr(x.device))
    gmm.launches += 1
    gmm.launches_tc += x.dtype == torch.bfloat16
    gmm.launches_by_capacity[C] = gmm.launches_by_capacity.get(C, 0) + 1
    _build.check(rc, "gmm")
    return out


gmm.launches = 0
gmm.launches_tc = 0
gmm.launches_by_capacity = {}
_build.count_launches(gmm, "launches", "launches_tc",
                      "launches_by_capacity")


class _GMM(torch.autograd.Function):
    """``gmm`` with its hand-written backward: the forward's launch (or
    ``gmm_ref`` on the CPU) keeps x, w and counts; the backward computes
    the parts autograd asks for with :func:`gmm_bwd`.  counts gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return _gmm(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dx, dw = gmm_bwd(x, w, counts, dy, dx=ctx.needs_input_grad[0],
                         dw=ctx.needs_input_grad[1])
        return dx, dw, None


def gmm_bwd(x, w, counts, dy, *, dx: bool = True, dw: bool = True):
    """The gradient of :func:`gmm` from the cotangent ``dy`` (E, C, F) of
    its output: (dx (E, C, D), dw (E, D, F)) in x's dtype, each None when
    not asked for.  ``dx[e, c] = dy[e, c] @ w[e]^T`` for c < counts[e] and
    exact zeros past it; ``dw[e] = x[e, :counts[e]]^T @ dy[e, :counts[e]]``,
    zeros for an expert with no token; slots at or past counts[e] are never
    read.  A CPU tensor takes ``ref.gmm_bwd_ref``; a CUDA tensor launches
    ``rt_gmm_bwd`` (``csrc/moe_gmm.cu``): bf16 on the tensor cores (dX the
    forward's tile over w as it lies, dW a grouped product over each
    expert's count), float32 on CUDA cores with exact float32 products;
    float32 accumulation, one fixed order, so two calls are bitwise equal.
    ``gmm_bwd.launches`` counts calls that launched, ``launches_tc`` those
    on the tensor cores, ``launches_dx`` and ``launches_dw`` each part's
    launches."""
    if x.device.type == "cpu":
        return gmm_bwd_ref(x, w, counts, dy, dx=dx, dw=dw)
    (E, C, D, F), cnt = _check(x, w, counts, "gmm_bwd")
    if dy.shape != (E, C, F) or dy.device != x.device:
        raise ValueError(f"gmm_bwd: dy {tuple(dy.shape)} on {dy.device}, "
                         f"want {(E, C, F)} on {x.device}")
    if not (dx or dw):
        return None, None
    x, w = x.contiguous(), w.contiguous()
    dy = dy.to(x.dtype).contiguous()
    gx = (torch.empty((E, C, D), dtype=x.dtype, device=x.device)
          if dx else None)
    gw = (torch.empty((E, D, F), dtype=x.dtype, device=x.device)
          if dw else None)
    fn = _build.kernel("rt_gmm_bwd", "PPPPPP IIIII P")
    rc = fn(x.data_ptr(), w.data_ptr(), cnt.data_ptr(), dy.data_ptr(),
            _build.ptr(gx), _build.ptr(gw), E, C, D, F,
            _build.DTYPE_CODE[x.dtype], _build.stream_ptr(x.device))
    gmm_bwd.launches += 1
    gmm_bwd.launches_tc += x.dtype == torch.bfloat16
    gmm_bwd.launches_dx += dx
    gmm_bwd.launches_dw += dw
    _build.check(rc, "gmm_bwd")
    return gx, gw


gmm_bwd.launches = 0
gmm_bwd.launches_tc = 0
gmm_bwd.launches_dx = 0
gmm_bwd.launches_dw = 0
_build.count_launches(gmm_bwd, "launches", "launches_tc", "launches_dx",
                      "launches_dw")
