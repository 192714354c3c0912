"""Plain PyTorch version of the grouped expert GEMM and its gradient.

The CPU path of ``ops.py`` and the yardstick the CUDA kernels are held
against on the card.  ``gmm_ref`` has the signature and layout of the JAX
oracle ``repro/kernels/moe_gmm/ref.py::gmm_ref``; ``gmm_bwd_ref`` is its
gradient written out.
"""
from __future__ import annotations

import torch


def _valid(counts, C: int):
    """(E, C, 1) bool: slot c of expert e holds a token (c < counts[e])."""
    return (torch.arange(C, device=counts.device)[None, :]
            < counts[:, None])[..., None]


def gmm_ref(x, w, counts):
    """x: (E, C, D) dispatched tokens; w: (E, D, F); counts: (E,) valid
    rows per expert.  Returns (E, C, F) in x's dtype, products in float32,
    rows at or past ``counts[e]`` zero (padding slots)."""
    out = torch.bmm(x.float(), w.float())
    return torch.where(_valid(counts, x.shape[1]), out, 0.0).to(x.dtype)


def gmm_bwd_ref(x, w, counts, dy, *, dx: bool = True, dw: bool = True):
    """The gradient of :func:`gmm_ref` from the cotangent ``dy`` (E, C, F)
    of its output: (dx (E, C, D) in x's dtype, dw (E, D, F) in w's), in
    float32 and rounded once; a part not asked for is None.  ``dx[e, c] =
    dy[e, c] @ w[e]^T`` for c < counts[e] and 0 past it; ``dw[e] = x[e,
    :counts[e]]^T @ dy[e, :counts[e]]``.  Slots at or past counts[e] enter
    neither (they are masked, not multiplied by a zero cotangent), as the
    kernels never read them."""
    valid = _valid(counts, x.shape[1])
    g = torch.where(valid, dy.float(), 0.0)
    gx = torch.bmm(g, w.float().transpose(1, 2)).to(x.dtype) if dx else None
    gw = (torch.bmm(torch.where(valid, x.float(), 0.0).transpose(1, 2), g)
          .to(w.dtype) if dw else None)
    return gx, gw
