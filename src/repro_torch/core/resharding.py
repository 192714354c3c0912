"""Live resharding: re-lay a tree of tensors onto a cell's zone.

This is the mechanical core of "resizing a subOS": a cell's params and
caches are re-placed on the new zone.  Onto one device,
``Tensor.to(device, non_blocking=True)`` performs the transfer (NVLink or
PCIe between cards); a tensor already on its target is not copied, so a
resize between zones of one card moves nothing.  Onto a mesh (a sharded
``ShardCtx`` and the tree's PartitionSpecs), each leaf is gathered and
laid out anew, one leaf at a time.  A Sharded source leaf is *donated*:
its shards are dropped once the leaf is re-laid, the counterpart of JAX's
``device_put(..., donate=True)``, so the old layout's memory returns as
the new one fills.  No checkpoint round-trip is involved — mirroring the
paper's observation that the *elastic resize* path must be shorter than
the failure path.
"""
from __future__ import annotations

import time
from typing import Any, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.sharding.sharded import relay_leaf


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reshard_tree(tree: Any, target, pspecs=None) -> Tuple[Any, dict]:
    """Place every tensor leaf of ``tree`` on ``target``: a device, or a
    sharded ``ShardCtx`` with ``pspecs`` (the tree's PartitionSpecs, as
    ``Model.params_pspecs`` gives them).  Sharded source leaves are
    donated.  Returns (tree, stats): the bytes of the tree, the seconds
    the move took (to the transfers' end) and the rate."""
    t0 = time.monotonic()
    nbytes = tree_bytes(tree)
    srcs = {t.device for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}
    if pspecs is None:
        device = torch.device(target)
        out = tree_map(lambda t: relay_leaf(t, device), tree)
        dsts = {device}
    else:
        out = tree_map(lambda t, s: relay_leaf(t, target.mesh, s), tree,
                       pspecs)
        dsts = set(target.mesh.positions)
    for dev in srcs | dsts:
        _sync(dev)
    dt = time.monotonic() - t0
    return out, {"bytes": nbytes, "seconds": dt,
                 "gbps": nbytes / max(dt, 1e-9) / 1e9}
