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
the new one fills.  Byte counts are logical, as JAX's are: each logical
array once, however many positions hold it.  No checkpoint round-trip
is involved — mirroring the paper's observation that the *elastic
resize* path must be shorter than the failure path.
"""
from __future__ import annotations

import time
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.sharding.sharded import Sharded, relay_leaf


def _leaf_bytes(t) -> int:
    """A leaf's logical bytes: a Sharded leaf's logical tensor (by its
    layout; a Sharded without one, a replicated value, its shard), a
    tensor's own, nothing for anything else."""
    if isinstance(t, Sharded):
        shard = t.shards[0]
        n = (int(np.prod(t.global_shape)) if t.spec is not None
             else shard.numel())
        return n * shard.element_size()
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


def tree_bytes(tree) -> int:
    """The logical bytes of a tree, as JAX counts them: each logical
    array once, however many positions hold a copy or a part of it."""
    out = [0]

    def add(t):
        out[0] += _leaf_bytes(t)
    tree_map(add, tree)
    return out[0]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reshard_tree(tree: Any, target, pspecs=None) -> Tuple[Any, dict]:
    """Place every tensor leaf of ``tree`` on ``target``: a device, or a
    sharded ``ShardCtx`` with ``pspecs`` (the tree's PartitionSpecs, as
    ``Model.params_pspecs`` gives them).  Sharded source leaves are
    donated.  Returns (tree, stats): the logical bytes of the tree, the seconds
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
