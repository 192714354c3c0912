"""Live resharding: move a tree of tensors onto a cell's device.

This is the mechanical core of "resizing a subOS": a cell's params and
caches are re-placed on the new zone's device.  ``Tensor.to(device,
non_blocking=True)`` performs the transfer (NVLink or PCIe between
cards); no checkpoint round-trip is involved — mirroring the paper's
observation that the *elastic resize* path must be shorter than the
failure path.  A tensor already on its target is not copied, so a resize
between zones of one card moves nothing.
"""
from __future__ import annotations

import time
from typing import Any, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reshard_tree(tree: Any, device) -> Tuple[Any, dict]:
    """Place every tensor leaf of ``tree`` on ``device``.  Returns (tree,
    stats): the bytes of the tree, the seconds the move took (to the
    transfers' end) and the rate."""
    device = torch.device(device)
    t0 = time.monotonic()
    nbytes = tree_bytes(tree)
    out = tree_map(lambda t: t.to(device, non_blocking=True)
                   if isinstance(t, torch.Tensor) else t, tree)
    for src in {t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)} | {device}:
        _sync(src)
    dt = time.monotonic() - t0
    return out, {"bytes": nbytes, "seconds": dt,
                 "gbps": nbytes / max(dt, 1e-9) / 1e9}
