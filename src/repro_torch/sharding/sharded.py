"""Sharded tensors: one local shard per mesh position, in one process.

A :class:`Sharded` holds the shards of one logical tensor, one per
position of a :class:`~repro_torch.sharding.rules.Mesh`, laid out by a
:class:`~repro_torch.sharding.rules.P` (``spec``; None for a value whose
layout nobody needs, such as an intermediate activation).  Every torch
operation on a Sharded runs once per position on that position's shard:
``torch.einsum(eq, x, w)`` with ``x`` and ``w`` Sharded is the local
einsum at each position, a plain tensor argument is read by every
position (moved to a position's device when it lies on another), and the
results come back as a Sharded.  That is the local half of JAX's
``shard_map``: the body of a sharded layer is the one-device code run
per position, and only the collectives (``sharding/collectives.py``)
look across positions.  Indexing, in-place writes (``x[i] = v``,
``index_copy_``) and methods map the same way; attributes other than
methods and tensors (``shape``, ``dtype``, ``is_cuda``) are position
0's, which every position shares, since layouts split dims evenly.
Functions that are not torch operations (a kernel's wrapper, which reads
data pointers) run per position through :func:`per_position`.

The shards of a layout that does not split a dim hold the same values;
they are still distinct tensors (a position writes only its own), and a
value replicated over every position is read from position 0
(:func:`first`).
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.sharding.rules import P, Mesh

#: functions whose result keeps the layout of their first Sharded operand
_KEEPS_LAYOUT = {torch.empty_like, torch.zeros_like, torch.ones_like,
                 torch.full_like, torch.clone, torch.Tensor.clone,
                 torch.Tensor.to, torch.Tensor.contiguous,
                 torch.Tensor.detach}
_KEEPS_LAYOUT_METHODS = {"clone", "to", "contiguous", "detach", "float",
                         "bfloat16"}


class Sharded:
    """One logical tensor as per-position shards (see the module doc)."""

    __slots__ = ("shards", "mesh", "spec")

    def __init__(self, shards: Sequence, mesh: Mesh, spec: Optional[P] = None):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size} positions")
        self.shards: List = list(shards)
        self.mesh = mesh
        self.spec = None if spec is None else P(*spec)

    # -- what every position shares -----------------------------------
    @property
    def shape(self) -> torch.Size:
        """The local shape (every position's)."""
        return self.shards[0].shape

    @property
    def global_shape(self) -> tuple:
        """The logical shape under ``spec``."""
        if self.spec is None:
            raise ValueError("a Sharded without a layout has no global shape")
        sizes = self.mesh.shape
        out = []
        for d, n in enumerate(self.shape):
            k = 1
            for a in self.spec.axes_of(d):
                k *= sizes[a]
            out.append(n * k)
        return tuple(out)

    def dim(self) -> int:
        return self.shards[0].dim()

    def __repr__(self) -> str:
        return (f"Sharded({self.mesh.size} x {tuple(self.shape)} "
                f"{self.shards[0].dtype}, spec={self.spec})")

    def __bool__(self):
        raise TypeError("the truth value of a Sharded is per position")

    # -- per-position dispatch ------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        first = _first(args, kwargs or {})
        spec = first.spec if func in _KEEPS_LAYOUT else None
        return _map(func, first, args, kwargs or {}, spec)

    def __getattr__(self, name: str):
        if name.startswith("__") or name in Sharded.__slots__:
            raise AttributeError(name)
        attr = getattr(self.shards[0], name)
        if isinstance(attr, torch.Tensor):      # .T, .mT: per position
            return Sharded([getattr(s, name) for s in self.shards],
                           self.mesh)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            out = _map(lambda s, *a, **k: getattr(s, name)(*a, **k), self,
                       (self,) + args, kwargs,
                       self.spec if name in _KEEPS_LAYOUT_METHODS else None)
            # an in-place method returns its own operand
            return self if name.endswith("_") and isinstance(
                out, Sharded) else out
        return call

    def __getitem__(self, index):
        out = _map(lambda s, i: s[i], self, (self, index), {})
        if isinstance(out, Sharded) and self.spec is not None:
            out.spec = _index_spec(self.spec, index, self.dim())
        return out

    def __setitem__(self, index, value):
        _map(lambda s, i, v: s.__setitem__(i, v), self, (self, index, value),
             {})


def _index_spec(spec: P, index, ndim: int) -> Optional[P]:
    """The layout of ``x[index]`` for indices of ints and full slices over
    unsplit dims (the layer slices of a stacked leaf); None otherwise."""
    idx = index if isinstance(index, tuple) else (index,)
    parts = list(spec) + [None] * (ndim - len(spec))
    out = []
    for d, i in enumerate(idx):
        if isinstance(i, int):
            if parts[d] is not None:
                return None
        elif isinstance(i, slice) and i == slice(None):
            out.append(parts[d])
        else:
            return None
    return P(*(out + parts[len(idx):]))


def _binop(name: str):
    def op(self, *args):
        return _map(getattr(torch.Tensor, name), self, (self,) + args, {})
    op.__name__ = name
    return op


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
              "__mod__", "__pow__", "__matmul__", "__rmatmul__", "__neg__",
              "__lt__", "__le__", "__gt__", "__ge__", "__and__", "__or__",
              "__xor__", "__invert__", "__abs__"):
    setattr(Sharded, _name, _binop(_name))


# --------------------------------------------------------------------------
# the per-position map
# --------------------------------------------------------------------------
def _walk(x, found: list):
    if isinstance(x, Sharded):
        found.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _walk(y, found)
            if found:
                return
    elif isinstance(x, dict):
        for y in x.values():
            _walk(y, found)
            if found:
                return


def _first(args, kwargs) -> Optional[Sharded]:
    found: list = []
    _walk(args, found)
    if not found:
        _walk(kwargs, found)
    return found[0] if found else None


def _local(x, r: int, dev):
    """Position ``r``'s view of an argument: its shard, a plain tensor on
    the position's device, containers rebuilt."""
    if isinstance(x, Sharded):
        return x.shards[r]
    if isinstance(x, torch.Tensor):
        if dev is not None and x.device != dev and x.dim() > 0:
            return x.to(dev, non_blocking=True)
        return x
    if isinstance(x, tuple):
        items = [_local(y, r, dev) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, list):
        return [_local(y, r, dev) for y in x]
    if isinstance(x, dict):
        return {k: _local(v, r, dev) for k, v in x.items()}
    return x


def _assemble(outs: list, mesh: Mesh, spec):
    """Per-position results -> one result: tensors become a Sharded,
    containers are rebuilt, anything else is position 0's."""
    o = outs[0]
    if isinstance(o, torch.Tensor):
        return Sharded(outs, mesh, spec)
    if isinstance(o, tuple):
        items = [_assemble([x[i] for x in outs], mesh, None)
                 for i in range(len(o))]
        return type(o)(*items) if hasattr(o, "_fields") else tuple(items)
    if isinstance(o, list):
        return [_assemble([x[i] for x in outs], mesh, None)
                for i in range(len(o))]
    return o


def _map(fn: Callable, first: Sharded, args, kwargs, spec=None):
    mesh = first.mesh
    outs = []
    for r in range(mesh.size):
        shard = first.shards[r]
        dev = shard.device if isinstance(shard, torch.Tensor) else None
        args_r, kwargs_r = _local(args, r, dev), _local(kwargs, r, dev)
        if mesh.multi_card:
            # a kernel launches on the current device's streams
            with torch.cuda.device(mesh.positions[r]):
                outs.append(fn(*args_r, **kwargs_r))
        else:
            outs.append(fn(*args_r, **kwargs_r))
    return _assemble(outs, mesh, spec)


def per_position(fn: Callable) -> Callable:
    """``fn`` run once per position when a top-level argument is Sharded
    (each call sees position-local tensors), as itself otherwise: how a
    kernel's wrapper runs on every position's shard."""
    @functools.wraps(fn, updated=())   # the counters stay on ``fn``
    def wrapped(*args, **kwargs):
        # only the top level is looked at: a kernel's wrapper takes its
        # tensors there, and a one-position call pays no walk
        for a in args:
            if isinstance(a, Sharded):
                return _map(fn, a, args, kwargs)
        for a in kwargs.values():
            if isinstance(a, Sharded):
                return _map(fn, a, args, kwargs)
        return fn(*args, **kwargs)
    return wrapped


# --------------------------------------------------------------------------
# layouts
# --------------------------------------------------------------------------
def local_slices(mesh: Mesh, spec: P, shape: Sequence[int], r: int) -> tuple:
    """Position ``r``'s slice of a tensor of global ``shape`` under
    ``spec``: the dims' even split, ranked major to minor over each dim's
    axes."""
    sizes = mesh.shape
    out = []
    for d, n in enumerate(shape):
        axes = spec.axes_of(d)
        k = 1
        for a in axes:
            k *= sizes[a]
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({k})")
        c = n // k
        i = mesh.rank(r, axes)
        out.append(slice(i * c, (i + 1) * c))
    return tuple(out)


def shard_leaf(t: torch.Tensor, spec, mesh: Mesh) -> Sharded:
    """``t`` laid out over ``mesh`` by ``spec``: each position's slice as
    a new contiguous tensor on its device."""
    spec = P(*(tuple(spec) + (None,) * (t.dim() - len(spec))))
    shards = []
    for r, dev in enumerate(mesh.positions):
        part = t[local_slices(mesh, spec, t.shape, r)]
        out = torch.empty(part.shape, dtype=t.dtype, device=dev)
        out.copy_(part)
        shards.append(out)
    return Sharded(shards, mesh, spec)


def gather_leaf(s: Sharded, device=None) -> torch.Tensor:
    """The logical tensor of ``s`` (by its ``spec``) on ``device``
    (default position 0's), read from the first position holding each
    slice."""
    if s.spec is None:
        raise ValueError("a Sharded without a layout cannot be gathered")
    shape = s.global_shape
    dev = s.shards[0].device if device is None else device
    out = torch.empty(shape, dtype=s.shards[0].dtype, device=dev)
    seen = set()
    for r in range(s.mesh.size):
        sl = local_slices(s.mesh, s.spec, shape, r)
        key = tuple((x.start, x.stop) for x in sl)
        if key not in seen:
            seen.add(key)
            out[sl].copy_(s.shards[r])
    return out


def relay_leaf(t, target=None, spec=None, *, into=None):
    """One leaf laid out anew: over ``target`` (a Mesh) by ``spec``, onto
    ``target`` (a device) whole, or copied into ``into`` (a leaf already
    in the new layout, which is returned).  A Sharded source is donated:
    its shards are dropped once it is gathered, so the old layout's
    memory returns as the new one fills (JAX's ``donate=True``).
    Anything but a tensor comes back as it is."""
    if into is not None:
        sharded = isinstance(into, Sharded)
        target = into.mesh if sharded else into.device
        spec = into.spec if sharded else None
    on_mesh = isinstance(target, Mesh)
    dev = target.positions[0] if on_mesh else torch.device(target)
    if isinstance(t, Sharded):
        full = gather_leaf(t, dev)
        t.shards.clear()
    elif isinstance(t, torch.Tensor):
        full = t
    else:
        return t
    if into is None:
        return (shard_leaf(full, spec, target) if on_mesh
                else full.to(dev, non_blocking=True))
    if on_mesh:
        for r, shard in enumerate(into.shards):
            shard.copy_(full[local_slices(target, spec, full.shape, r)])
    else:
        into.copy_(full)
    return into


def split(t: torch.Tensor, spec, mesh: Mesh) -> Sharded:
    """A read-only input laid out by ``spec``: each position's slice of
    ``t`` as a view (a copy on another device)."""
    spec = P(*(tuple(spec) + (None,) * (t.dim() - len(spec))))
    out = []
    for r, d in enumerate(mesh.positions):
        part = t[local_slices(mesh, spec, t.shape, r)]
        out.append(part.to(d, non_blocking=True) if part.device != d
                   else part)
    return Sharded(out, mesh, spec)


def empty_like_global(like: Sharded, spec, shape=None) -> Sharded:
    """Uninitialised shards of ``like``'s logical shape (or ``shape``)
    laid out by ``spec``, on ``like``'s positions."""
    shape = like.global_shape if shape is None else tuple(shape)
    spec = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
    out = []
    for r, s in enumerate(like.shards):
        sl = local_slices(like.mesh, spec, shape, r)
        out.append(torch.empty(tuple(x.stop - x.start for x in sl),
                               dtype=s.dtype, device=s.device))
    return Sharded(out, like.mesh, spec)


def first(x):
    """A replicated value read at position 0 (a plain value as it is)."""
    return x.shards[0] if isinstance(x, Sharded) else x


def zip_positions(trees: Sequence, mesh: Mesh, global_tree=None,
                  batch_axes=()):
    """Per-position trees of equal structure -> one tree of Sharded
    leaves.  ``global_tree`` (the same structure; leaves with the logical
    ``shape``: tensors, or PSpecs naming their dims) gives each leaf's
    layout: a dim a position holds less of is split over ``batch_axes``
    when its PSpec names it ``batch``, else over ``model``; without it the
    leaves have no layout."""
    from repro_torch.models.param import is_pspec, tree_leaves, tree_map
    if global_tree is None:
        return tree_map(lambda *xs: Sharded(list(xs), mesh), trees[0],
                        *trees[1:])
    b_ax = tuple(batch_axes)
    b_ax = b_ax[0] if len(b_ax) == 1 else (b_ax or None)

    def spec(local, gl):
        names = gl.logical if is_pspec(gl) else (None,) * len(gl.shape)
        return P(*((b_ax if name == "batch" else "model") if n < g else None
                   for n, g, name in zip(local.shape, gl.shape, names)))
    specs = [spec(x, g) for x, g in
             zip(tree_leaves(trees[0]), tree_leaves(global_tree,
                                                    is_leaf=is_pspec))]
    it = iter(specs)
    return tree_map(lambda *xs: Sharded(list(xs), mesh, next(it)),
                    trees[0], *trees[1:])
