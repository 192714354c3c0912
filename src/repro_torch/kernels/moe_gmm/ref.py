"""Plain PyTorch version of the grouped expert GEMM.

The CPU path of ``ops.py`` and the yardstick the CUDA kernel is held
against on the card.  Same signature and layout as the JAX oracle
``repro/kernels/moe_gmm/ref.py::gmm_ref``.
"""
from __future__ import annotations

import torch


def gmm_ref(x, w, counts):
    """x: (E, C, D) dispatched tokens; w: (E, D, F); counts: (E,) valid
    rows per expert.  Returns (E, C, F) in x's dtype, products in float32,
    rows at or past ``counts[e]`` zero (padding slots)."""
    C = x.shape[1]
    out = torch.bmm(x.float(), w.float())
    valid = torch.arange(C, device=x.device)[None, :] < counts[:, None]
    return torch.where(valid[..., None], out, 0.0).to(x.dtype)
