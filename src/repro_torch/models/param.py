"""Parameter specification trees.

A model is described by a tree (nested dicts, lists, tuples and
NamedTuples) of :class:`PSpec` leaves.  From that one tree come the real
initialised parameters, shape-only stand-ins on the ``meta`` device, and
the parameter count.  ``params_from_numpy`` is the weight bridge: it turns
a parameter tree of numpy arrays (for example a JAX ``Model.init`` tree
converted by the caller) into the port's tensors with the same keys,
shapes and layer-stacked ``(L, ...)`` leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class PSpec:
    """One parameter: shape + logical axes + initializer."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical axis name per dim
    init: Tuple[Any, ...] = ("normal", -2)  # ("normal", fan_in_axis) | ("const", v)
    dtype: Optional[str] = None          # None -> model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def _is_namedtuple(x) -> bool:
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
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


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
    raise NotImplementedError(
        f"init {spec.init!r} comes with the ssm port (ROADMAP queue 1 "
        "item 8)")


def init_params(spec_tree, generator: Optional[torch.Generator],
                dtype: str, device):
    """Materialise parameters on ``device``.  ``normal`` leaves draw from
    ``generator`` (which must live on ``device``) in tree order with a
    1/sqrt(fan_in) scale; ``const`` leaves need no generator."""
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
