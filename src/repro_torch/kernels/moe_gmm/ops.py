"""Grouped expert GEMM: dispatch by device.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the hand-written kernel in ``csrc/moe_gmm.cu`` or raises.  There is no
fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm.ref import gmm_ref

#: why training a moe model on the card raises
GRAD_ITEM = ("the grouped GEMM kernel has no backward yet: training a moe "
             "model on the card comes with ROADMAP queue 2 item 7")


def gmm(x, w, counts):
    """x: (E, C, D) capacity layout; w: (E, D, F); counts: (E,) int ->
    (E, C, F) with ``out[e, c] = x[e, c] @ w[e]`` for ``c < counts[e]`` and
    0 past it.  ``counts`` stays on the device: the kernel reads it there,
    so nothing is synchronised.  On the card the route is by dtype alone:
    bfloat16 launches the tensor-core kernel, float32 the CUDA-core kernel,
    whose products stay exact float32.  The kernel has no backward: on
    the card a call that autograd would record raises
    ``NotImplementedError`` (the CPU's plain version is differentiable).
    ``gmm.launches`` counts kernel
    launches, ``gmm.launches_tc`` those of the tensor-core kernel, and
    ``gmm.launches_by_capacity`` all launches by C."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, counts)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped GEMM kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(GRAD_ITEM)
    E, C, D = x.shape
    F = w.shape[2]
    if w.shape != (E, D, F) or counts.shape != (E,):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"counts {tuple(counts.shape)}")
    if w.dtype != x.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x {x.dtype} and w {w.dtype} must share a float32 "
                         "or bfloat16 dtype")
    for t in (w, counts):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, x on {x.device}")
    x, w = x.contiguous(), w.contiguous()
    cnt = counts.to(dtype=torch.int32).contiguous()
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
