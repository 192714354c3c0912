"""Parameter specification trees.

A model is described by a tree (nested dicts, lists, tuples and
NamedTuples) of :class:`PSpec` leaves.  From that one tree come the real
initialised parameters, shape-only stand-ins on the ``meta`` device, and
the parameter count.  ``params_from_numpy`` is the weight bridge: it turns
a parameter tree of numpy arrays (for example a JAX ``Model.init`` tree
converted by the caller) into the port's tensors with the same keys,
shapes and layer-stacked ``(L, ...)`` leaves; ``shard_tree`` lays such a
tree out over a mesh (one :class:`~repro_torch.sharding.sharded.Sharded`
leaf per tensor) and ``gather_tree`` inverts it exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.sharded import Sharded, gather_leaf, relay_leaf

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class PSpec:
    """One parameter: shape + logical axes + initializer."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim
    # ("normal", fan_in_axis) | ("const", v) | ("alog",) | ("dt_bias",)
    init: Tuple[Any, ...] = ("normal", -2)
    dtype: Optional[str] = None          # None -> model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest, is_leaf=None):
    """Map ``fn`` over the leaves of one or more trees of the same
    structure (dicts, lists, tuples, NamedTuples; ``None`` stays None)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves in flatten order; a Sharded leaf gives its shards."""
    out = []

    def add(x):
        if isinstance(x, Sharded):
            out.extend(x.shards)
        else:
            out.append(x)
    tree_map(add, tree, is_leaf=is_leaf)
    return out


def jax_leaves(tree) -> list:
    """The leaves in JAX's flatten order: dict keys sorted, sequences and
    NamedTuple fields in order, ``None`` holding no leaf.  A tree written
    by one package and read by the other lines up leaf by leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in jax_leaves(v)]
    return [tree]


def jax_unflatten(tree, leaves):
    """``tree`` with its leaves replaced by ``leaves``, given in
    :func:`jax_leaves` order (dicts keep their own key order)."""
    leaves = list(leaves)
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    n = len(jax_leaves(tree))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    return build(tree)


def tree_map_pspec(fn, tree):
    return tree_map(fn, tree, is_leaf=is_pspec)


def resolve_dtype(spec: PSpec, default_dtype: str) -> torch.dtype:
    return DTYPES[spec.dtype or default_dtype]


def abstract_params(spec_tree, default_dtype: str):
    """Tree of ``meta``-device tensors: shapes and dtypes, no storage."""
    return tree_map_pspec(
        lambda s: torch.empty(s.shape, dtype=resolve_dtype(s, default_dtype),
                              device="meta"),
        spec_tree)


def _init_leaf(spec: PSpec, generator, dtype: torch.dtype, device):
    kind = spec.init[0]
    if kind == "normal":
        if generator is None:
            raise ValueError("normal-initialised parameters need a generator")
        fan_in = spec.shape[spec.init[1]]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        # drawn in float32 one leading slice at a time, so the float32
        # temporary is one layer's, not the whole stack's (deepseek-moe-16b's
        # routed experts are 5 G values per stack)
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        for part in (out if out.dim() > 1 else [out]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device, dtype=torch.float32)
                       .mul_(scale))
        return out
    if kind == "const":
        return torch.full(spec.shape, spec.init[1], dtype=dtype, device=device)
    if kind in ("alog", "dt_bias"):
        if generator is None:
            raise ValueError(f"{kind}-initialised parameters need a generator")
        u = torch.rand(spec.shape, generator=generator, device=device,
                       dtype=torch.float32)
        if kind == "alog":
            # Mamba A_log: A ~ Uniform[1, 16), stored as log
            return torch.log(u * 15.0 + 1.0).to(dtype)
        # Mamba dt bias: softplus^-1 of dt ~ LogUniform[1e-3, 1e-1]
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                       + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(spec_tree, generator: Optional[torch.Generator],
                dtype: str, device):
    """Materialise parameters on ``device``.  ``normal`` leaves draw from
    ``generator`` (which must live on ``device``) in tree order with a
    1/sqrt(fan_in) scale; the Mamba ``alog`` and ``dt_bias`` leaves draw
    uniforms from it; ``const`` leaves need no generator."""
    return tree_map_pspec(
        lambda s: _init_leaf(s, generator, resolve_dtype(s, dtype), device),
        spec_tree)


def count_params(spec_tree) -> int:
    return int(sum(math.prod(s.shape)
                   for s in tree_leaves(spec_tree, is_leaf=is_pspec)))


def params_from_numpy(tree, *, dtype: torch.dtype, device, specs=None):
    """The weight bridge: a tree of numpy arrays -> the same tree of
    tensors on ``device``.  Floating leaves become ``dtype``, except where
    ``specs`` (the model's PSpec tree) pins a leaf's own dtype, as it pins
    the MoE router to float32; integer leaves keep theirs.  The caller
    hands floats over as float32, because ``torch.from_numpy`` takes no
    bfloat16."""
    def leaf(a, spec=None):
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point():
            t = t.to(DTYPES[spec.dtype] if spec is not None and spec.dtype
                     else dtype)
        return t.to(device)
    if specs is None:
        return tree_map(leaf, tree)
    return tree_map(leaf, tree, specs)


def shard_tree(tree, pspecs, ctx):
    """Lay a tree of full tensors out over ``ctx.mesh``: each leaf becomes
    a Sharded whose position ``r`` holds its slice under the leaf's
    PartitionSpec in ``pspecs`` (a tree of the same structure, as
    ``ShardCtx.params_pspecs`` gives it), a new tensor on position r's
    device.  A leaf that is Sharded already is gathered first, and
    donated (:func:`~repro_torch.sharding.sharded.relay_leaf`)."""
    return tree_map(lambda t, spec: relay_leaf(t, ctx.mesh, spec), tree,
                    pspecs)


def gather_tree(tree, device=None):
    """The full tensors of a sharded tree (Sharded leaves gathered onto
    ``device``, default each leaf's position 0's); plain leaves as they
    are.  ``gather_tree(shard_tree(t, ...))`` is ``t`` bit for bit."""
    return tree_map(lambda t: gather_leaf(t, device)
                    if isinstance(t, Sharded) else t, tree)
