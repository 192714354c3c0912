"""Async, atomic checkpointing of tensor trees (the port of
``repro/checkpoint/checkpoint.py``), in the JAX package's on-disk layout:

    <dir>/step_<N>/
        meta.json       shapes and dtypes of the leaves
        leaf_<i>.npy    one file per leaf; bfloat16 stored as a raw u2 view

Leaves are numbered in JAX's flatten order (dict keys sorted, NamedTuple
fields in order, ``None`` holding no leaf: ``models.param.jax_leaves``),
so a checkpoint written by either package restores in the other.
``restore`` places the leaves on the device asked for: a checkpoint
written by a cell on one device restores onto another (the
failure-recovery path).  Saves run on a thread pool (``blocking=False``)
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

from repro_torch.models.param import jax_leaves, jax_unflatten

_POOL = ThreadPoolExecutor(max_workers=2)

# dtype names as numpy (and ml_dtypes) spell them in meta.json
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a leaf on the host as it is stored: bfloat16 as its raw
    uint16 (a copy even on the CPU: the caller may update the leaf in
    place while an async save writes)."""
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
    meta = {
        "treedef": f"repro_torch tree of {len(leaves)} leaves",
        "leaves": [{"shape": list(t.shape), "dtype": _NAMES[t.dtype]}
                   for t in leaves],
    }
    host = [_host(t) for t in leaves]

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


def restore(ckpt_dir: str, step: int, target: Any, device="cpu") -> Any:
    """Restore into the structure of ``target`` (a tree of tensors, real
    or on the ``meta`` device), each leaf in its target's dtype, on
    ``device``.  Raises ``ValueError`` when the leaf counts differ."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves = jax_leaves(target)
    if len(leaves) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, target has "
            f"{len(leaves)}")
    out = []
    for i, ref in enumerate(leaves):
        t = _tensor(np.load(os.path.join(d, f"leaf_{i}.npy")),
                    meta["leaves"][i]["dtype"])
        out.append(t.to(device=device, dtype=ref.dtype))
    return jax_unflatten(target, out)
