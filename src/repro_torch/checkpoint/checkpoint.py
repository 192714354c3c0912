"""Async, atomic checkpointing of tensor trees (the port of
``repro/checkpoint/checkpoint.py``), in the JAX package's on-disk layout:

    <dir>/step_<N>/
        meta.json       shapes and dtypes of the leaves
        leaf_<i>.npy    one file per leaf; bfloat16 stored as a raw u2 view

Leaves are numbered in JAX's flatten order (dict keys sorted, NamedTuple
fields in order, ``None`` holding no leaf: ``models.param.jax_leaves``),
so a checkpoint written by either package restores in the other.
``restore`` places the leaves on the device asked for, or lays them out
over a mesh leaf by leaf: a checkpoint written by a cell on one device
or mesh restores onto another (the failure-recovery path).  A tree laid out over a mesh is saved as its
logical tensors: each :class:`~repro_torch.sharding.sharded.Sharded` leaf
is gathered to the host.  Saves run on a thread pool (``blocking=False``)
and are atomic via a tmp-dir rename; ``latest_step`` sees completed
checkpoints only.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.param import jax_leaves, jax_unflatten, tree_map
from repro_torch.sharding.sharded import Sharded, gather_leaf, shard_leaf

_POOL = ThreadPoolExecutor(max_workers=2)

# dtype names as numpy (and ml_dtypes) spell them in meta.json
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _host(t) -> np.ndarray:
    """A copy of a leaf on the host as it is stored: bfloat16 as its raw
    uint16 (a copy even on the CPU: the caller may update the leaf in
    place while an async save writes); a Sharded leaf gathered whole."""
    if isinstance(t, Sharded):
        t = gather_leaf(t, torch.device("cpu"))
    else:
        t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored leaf back as a tensor of its recorded dtype."""
    arr = np.require(arr, requirements="C")      # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype_name), copy=False))


def save(ckpt_dir: str, step: int, tree: Any, *,
         blocking: bool = True) -> Optional[Future]:
    """Save a tree of tensors: copied to the host on the calling thread
    (so the caller may update them in place afterwards), then written
    under ``step_<step>`` by an atomic rename.  Returns the directory, or
    with ``blocking=False`` a Future of it."""
    leaves = jax_leaves(tree)
    host = [_host(t) for t in leaves]
    meta = {
        "treedef": f"repro_torch tree of {len(leaves)} leaves",
        "leaves": [{"shape": list(h.shape), "dtype": _NAMES[t.dtype]}
                   for h, t in zip(host, leaves)],
    }

    def write():
        final = os.path.join(ckpt_dir, f"step_{step}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for i, arr in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final

    if blocking:
        return write()
    return _POOL.submit(write)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target: Any, device="cpu",
            pspecs: Any = None) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors, real
    or on the ``meta`` device), each leaf in its target's dtype, on
    ``device``; or, given ``pspecs`` (the target's PartitionSpecs), laid
    out over ``device``, a Mesh: each leaf is read to the host and split
    over the positions as it is read, so the host holds one whole leaf
    at a time and no position more than its shards.  Raises
    ``ValueError`` when the leaf counts differ."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves = jax_leaves(target)
    if len(leaves) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, target has "
            f"{len(leaves)}")

    def load(i, ref, on="cpu"):
        t = _tensor(np.load(os.path.join(d, f"leaf_{i}.npy")),
                    meta["leaves"][i]["dtype"])
        return t.to(device=on, dtype=ref.dtype)
    if pspecs is None:
        return jax_unflatten(target, [load(i, ref, device)
                                      for i, ref in enumerate(leaves)])
    index = jax_unflatten(target, range(len(leaves)))
    return tree_map(lambda i, ref, spec: shard_leaf(load(i, ref), spec,
                                                    device),
                    index, target, pspecs)
