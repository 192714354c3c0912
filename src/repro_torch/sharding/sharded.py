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
(:func:`first`).  Each shard is an autograd leaf of its own when it
requires grad, with its own ``.grad``: training differentiates a
replicated loss at position 0, and the collectives' backwards carry the
cotangent to every position (``train/train_step.py``).

The host moves rows of a batch dim (a serving cache's slots, a prefill's
rows) by their global numbers through :func:`move_rows`,
:func:`take_rows` and :func:`row_owners`: a dim split over the batch
axes holds row ``i`` of ``n`` on the positions of batch rank ``i // (n /
R)`` at local row ``i % (n / R)`` (R the product of the axes' sizes), as
:func:`split` lays it out; a row is read where it lies and written only
where its destination lies.
"""
from __future__ import annotations

import functools
import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.sharding.rules import P, Mesh, Segments

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
            e = self.spec[d] if d < len(self.spec) else None
            if isinstance(e, Segments):
                out.append(sum(size for size, _ in e))
                continue
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
    """The layout of ``x[index]`` for indices of ints and slices: full
    slices keep any dim's layout, ints and other slices need an unsplit
    dim (the layer slices of a stacked leaf, the rows of a state); None
    otherwise."""
    idx = index if isinstance(index, tuple) else (index,)
    parts = list(spec) + [None] * (ndim - len(spec))
    out = []
    for d, i in enumerate(idx):
        if isinstance(i, slice) and i == slice(None):
            out.append(parts[d])
        elif not isinstance(i, (int, slice)) or parts[d] is not None:
            return None
        elif isinstance(i, slice):
            out.append(None)
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
        # a 0-d tensor on the CPU mixes with any device's as a scalar;
        # one on another card does not
        if dev is not None and x.device != dev and (
                x.dim() > 0 or x.device.type != "cpu"):
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
def _segments(entry, n: int) -> tuple:
    """A :class:`P` entry over a dim of global size ``n`` as segments
    ``((size, axes), ...)``."""
    if isinstance(entry, Segments):
        if sum(size for size, _ in entry) != n:
            raise ValueError(f"{entry} does not cover a dim of {n}")
        return tuple(entry)
    if entry is None:
        return ((n, ()),)
    return ((n, entry if isinstance(entry, tuple) else (entry,)),)


def _dim_parts(mesh: Mesh, entry, n: int, r: int, what: str) -> list:
    """Position ``r``'s parts of a dim of global size ``n``: (global
    slice, local slice) per segment, each segment split evenly, ranked
    major to minor over its axes."""
    sizes = mesh.shape
    out, g0, l0 = [], 0, 0
    for size, axes in _segments(entry, n):
        k = 1
        for a in axes:
            k *= sizes[a]
        if size % k:
            raise ValueError(f"{what} does not split over {axes} ({k})")
        c = size // k
        i = mesh.rank(r, axes)
        out.append((slice(g0 + i * c, g0 + (i + 1) * c), slice(l0, l0 + c)))
        g0, l0 = g0 + size, l0 + c
    return out


def _pieces(mesh: Mesh, spec: P, shape: Sequence[int], r: int) -> list:
    """Position ``r``'s pieces of a tensor of global ``shape`` under
    ``spec``: (global index, local index) pairs, one per combination of
    its dims' segments (one piece unless a dim is :class:`Segments`)."""
    per_dim = [_dim_parts(mesh, spec[d] if d < len(spec) else None, n, r,
                          f"dim {d} of {tuple(shape)}")
               for d, n in enumerate(shape)]
    return [(tuple(g for g, _ in combo), tuple(lo for _, lo in combo))
            for combo in itertools.product(*per_dim)]


def local_shape(mesh: Mesh, spec: P, shape: Sequence[int]) -> tuple:
    """Every position's shape of a tensor of global ``shape`` under
    ``spec``."""
    return tuple(sum(lo.stop - lo.start for _, lo in
                     _dim_parts(mesh, spec[d] if d < len(spec) else None,
                                n, 0, f"dim {d} of {tuple(shape)}"))
                 for d, n in enumerate(shape))


def local_slices(mesh: Mesh, spec: P, shape: Sequence[int], r: int) -> tuple:
    """Position ``r``'s slice of a tensor of global ``shape`` under
    ``spec`` (a layout without :class:`Segments`): the dims' even split,
    ranked major to minor over each dim's axes."""
    (g, _), = _pieces(mesh, spec, shape, r)
    return g


def _full_spec(spec, ndim: int) -> P:
    return P(*(tuple(spec) + (None,) * (ndim - len(spec))))


def shard_leaf(t: torch.Tensor, spec, mesh: Mesh) -> Sharded:
    """``t`` laid out over ``mesh`` by ``spec``: each position's part as
    a new contiguous tensor on its device."""
    spec = _full_spec(spec, t.dim())
    shards = []
    for r, dev in enumerate(mesh.positions):
        out = torch.empty(local_shape(mesh, spec, t.shape), dtype=t.dtype,
                          device=dev)
        for g, lo in _pieces(mesh, spec, t.shape, r):
            out[lo].copy_(t[g])
        shards.append(out)
    return Sharded(shards, mesh, spec)


def gather_leaf(s: Sharded, device=None) -> torch.Tensor:
    """The logical tensor of ``s`` (by its ``spec``) on ``device``
    (default position 0's), read from the first position holding each
    piece."""
    if s.spec is None:
        raise ValueError("a Sharded without a layout cannot be gathered")
    shape = s.global_shape
    dev = s.shards[0].device if device is None else device
    out = torch.empty(shape, dtype=s.shards[0].dtype, device=dev)
    seen = set()
    for r in range(s.mesh.size):
        for g, lo in _pieces(s.mesh, s.spec, shape, r):
            key = tuple((x.start, x.stop) for x in g)
            if key not in seen:
                seen.add(key)
                out[g].copy_(s.shards[r][lo])
    return out


def relay_leaf(t, target=None, spec=None, *, into=None, donate=True):
    """One leaf laid out anew: over ``target`` (a Mesh) by ``spec``, onto
    ``target`` (a device) whole, or copied into ``into`` (a leaf already
    in the new layout, which is returned).  A Sharded source is donated:
    its shards are dropped once it is gathered, so the old layout's
    memory returns as the new one fills (JAX's ``donate=True``).  With
    ``donate=False`` the source is left intact and the result is always
    a copy, also of a plain tensor already on ``target`` (a channel's
    transfer: the sender keeps serving from its tensors).  Anything but
    a tensor comes back as it is."""
    if into is not None:
        sharded = isinstance(into, Sharded)
        target = into.mesh if sharded else into.device
        spec = into.spec if sharded else None
    on_mesh = isinstance(target, Mesh)
    dev = target.positions[0] if on_mesh else torch.device(target)
    if isinstance(t, Sharded):
        full = gather_leaf(t, dev)
        if donate:
            t.shards.clear()
    elif isinstance(t, torch.Tensor):
        full = t
    else:
        return t
    if into is None:
        if on_mesh:
            return shard_leaf(full, spec, target)
        return full.to(dev, non_blocking=True,
                       copy=not donate and full is t)
    if on_mesh:
        for r, shard in enumerate(into.shards):
            for g, lo in _pieces(target, spec, full.shape, r):
                shard[lo].copy_(full[g])
    else:
        into.copy_(full)
    return into


def same_mesh(a: Mesh, b: Mesh) -> bool:
    """Do two meshes name the same positions in the same shape (so a
    layout over one is a layout over the other)?"""
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and a.positions == b.positions)


def to_layout(t, like):
    """``t`` in ``like``'s layout (its mesh and spec, or its device):
    ``t`` itself when it is in it already, else a copy (the source left
    intact)."""
    if isinstance(like, Sharded):
        if (isinstance(t, Sharded) and same_mesh(t.mesh, like.mesh)
                and t.spec == like.spec):
            return t
        return relay_leaf(t, like.mesh, like.spec, donate=False)
    if isinstance(t, torch.Tensor) and t.device == like.device:
        return t
    return relay_leaf(t, like.device, donate=False)


def split(t: torch.Tensor, spec, mesh: Mesh) -> Sharded:
    """A read-only input laid out by ``spec`` (without
    :class:`Segments`): each position's slice of ``t`` as a view (a copy
    on another device)."""
    spec = _full_spec(spec, t.dim())
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
    spec = _full_spec(spec, len(shape))
    local = local_shape(like.mesh, spec, shape)
    out = [torch.empty(local, dtype=s.dtype, device=s.device)
           for s in like.shards]
    return Sharded(out, like.mesh, spec)


def first(x):
    """A replicated value read at position 0 (a plain value as it is)."""
    return x.shards[0] if isinstance(x, Sharded) else x


def zip_positions(trees: Sequence, mesh: Mesh, global_tree=None,
                  batch_axes=()):
    """Per-position trees of equal structure -> one tree of Sharded
    leaves.  ``global_tree`` (the same structure; leaves with the logical
    ``shape``: tensors, or PSpecs naming their dims) gives each leaf's
    layout (:func:`position_pspecs`).  Without ``global_tree`` the leaves
    have no layout."""
    from repro_torch.models.param import tree_leaves, tree_map
    if global_tree is None:
        return tree_map(lambda *xs: Sharded(list(xs), mesh), trees[0],
                        *trees[1:])
    it = iter(tree_leaves(position_pspecs(trees[0], global_tree, mesh,
                                          batch_axes),
                          is_leaf=lambda x: isinstance(x, P)))
    return tree_map(lambda *xs: Sharded(list(xs), mesh, next(it)),
                    trees[0], *trees[1:])


def position_pspecs(local_tree, global_tree, mesh: Mesh, batch_axes=()):
    """The layout by position of a tree whose leaves one position holds
    with the shapes of ``local_tree`` (tensors or PSpecs) and whose
    logical shapes are ``global_tree``'s (the same structure; tensors, or
    PSpecs naming their dims): a tree of :class:`P`.  A dim a position
    holds less of is split over ``batch_axes`` when its PSpec names it
    ``batch``, else over ``model``; a dim it holds more than 1/m of (m
    the model axis' size) is a prefix split over ``model`` before a
    suffix every position holds whole (:class:`Segments`: the Mamba conv
    state's [x_r | B | C])."""
    from repro_torch.models.param import is_pspec, tree_map
    b_ax = tuple(batch_axes)
    b_ax = b_ax[0] if len(b_ax) == 1 else (b_ax or None)
    m = mesh.shape.get("model", 1)

    def entry(n, g, name):
        if n >= g:
            return None
        if name == "batch":
            return b_ax
        if n * m == g:
            return "model"
        # n = s / m + (g - s) for a split prefix of s
        s, rem = divmod((g - n) * m, m - 1) if m > 1 else (0, 1)
        if rem or not 0 < s <= g or s % m:
            raise ValueError(f"a dim of {n} of {g} is no layout over "
                             f"{m} positions")
        return Segments((s, ("model",)), (g - s, ()))

    def spec(local, gl):
        names = gl.logical if is_pspec(gl) else (None,) * len(gl.shape)
        return P(*(entry(n, g, name)
                   for n, g, name in zip(local.shape, gl.shape, names)))
    return tree_map(spec, local_tree, global_tree, is_leaf=is_pspec)


# --------------------------------------------------------------------------
# rows of a batch dim, moved by their global numbers
# --------------------------------------------------------------------------
def shard_at(x, r: int):
    """Position ``r``'s part of ``x``: its shard, or a plain value
    itself."""
    return x.shards[r] if isinstance(x, Sharded) else x


def row_axes(x, dim: int) -> tuple:
    """The mesh axes of size above 1 that split dim ``dim`` of ``x`` (()
    for a plain tensor, a whole dim or a Sharded without a layout)."""
    if not isinstance(x, Sharded) or x.spec is None:
        return ()
    sizes = x.mesh.shape
    return tuple(a for a in x.spec.axes_of(dim) if sizes[a] > 1)


def row_home(mesh: Mesh, axes: Sequence[str], n: int, row: int) -> tuple:
    """(rank along ``axes``, local row) of global row ``row`` of a dim of
    ``n`` rows split evenly over ``axes``."""
    k = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    per = n // k
    return row // per, row % per


def _with_rank(mesh: Mesh, r: int, axes: Sequence[str], rank: int) -> int:
    """The position that differs from ``r`` only along ``axes``, where
    its rank is ``rank``."""
    if not axes:
        return r
    coords, sizes = mesh.coords(r), mesh.shape
    for a in reversed(axes):
        coords[a] = rank % sizes[a]
        rank //= sizes[a]
    return int(np.ravel_multi_index([coords[a] for a in mesh.axis_names],
                                    mesh.devices.shape))


def _rows_of(x, dim: int) -> tuple:
    """(split axes, global row count) of dim ``dim`` of ``x``."""
    ax = row_axes(x, dim)
    return ax, (x.global_shape[dim] if ax else x.shape[dim])


def row_owners(x, dim: int, row: int) -> list:
    """(position, shard, local row) of each position holding global row
    ``row`` of dim ``dim`` of ``x``: every position when the dim is whole;
    ``[(0, x, row)]`` for a plain tensor."""
    if not isinstance(x, Sharded):
        return [(0, x, row)]
    ax, n = _rows_of(x, dim)
    k, lo = row_home(x.mesh, ax, n, row)
    return [(r, s, lo) for r, s in enumerate(x.shards)
            if x.mesh.rank(r, ax) == k]


def _idx(rows, device) -> torch.Tensor:
    return torch.as_tensor(list(rows), dtype=torch.long, device=device)


def _select(t: torch.Tensor, dim: int, rows: list) -> torch.Tensor:
    """Rows ``rows`` of dim ``dim`` of ``t``: ``t`` itself when they are
    all of its rows in order."""
    if rows == list(range(t.shape[dim])):
        return t
    return t.index_select(dim, _idx(rows, t.device))


def move_rows(dst, dim: int, dst_rows: Sequence[int], src,
              src_rows: Optional[Sequence[int]] = None):
    """Write ``src``'s rows ``src_rows`` (default ``0 .. len(dst_rows)``)
    of dim ``dim`` into ``dst``'s rows ``dst_rows``, in place, by global
    row numbers.  Over a mesh each destination row is written only on the
    positions that hold it, and each source row is read from the position
    that holds it among those that differ from the writer only along the
    source's batch axes (the writer's own copy when the source's dim is
    whole), so a row crosses data rows only when its two homes differ.
    Returns ``dst``."""
    dst_rows = list(dst_rows)
    src_rows = (list(range(len(dst_rows))) if src_rows is None
                else list(src_rows))
    if not isinstance(dst, Sharded):
        vals = _select(shard_at(src, 0), dim, src_rows)
        dst.index_copy_(dim, _idx(dst_rows, dst.device),
                        vals.to(dst.device, dst.dtype))
        return dst
    mesh = dst.mesh
    d_ax, n_d = _rows_of(dst, dim)
    s_ax, n_s = _rows_of(src, dim) if isinstance(src, Sharded) else ((), 0)
    for r, shard in enumerate(dst.shards):
        mine = mesh.rank(r, d_ax)
        by_holder: dict = {}            # holder position -> (dst, src) rows
        for d, s in zip(dst_rows, src_rows):
            k, lo = row_home(mesh, d_ax, n_d, d)
            if k != mine:
                continue
            sk, s_lo = row_home(mesh, s_ax, n_s, s) if s_ax else (0, s)
            held = by_holder.setdefault(_with_rank(mesh, r, s_ax, sk),
                                        ([], []))
            held[0].append(lo)
            held[1].append(s_lo)
        for h, (d_lo, s_lo) in by_holder.items():
            vals = _select(shard_at(src, h), dim, s_lo)
            shard.index_copy_(dim, _idx(d_lo, shard.device),
                              vals.to(shard.device, shard.dtype))
    return dst


def take_rows(src, dim: int, rows: Sequence[int]):
    """``src``'s rows ``rows`` of dim ``dim`` as a new leaf (a copy) of
    ``len(rows)`` rows, whole on every position: a dim split over the
    batch axes gathers each row from where it lies
    (:func:`move_rows`), a whole dim is read locally."""
    rows = list(rows)
    if not isinstance(src, Sharded):
        return src.index_select(dim, _idx(rows, src.device))
    if not row_axes(src, dim):
        return Sharded([s.index_select(dim, _idx(rows, s.device))
                        for s in src.shards], src.mesh, src.spec)
    shape = list(src.shape)
    shape[dim] = len(rows)
    spec = _full_spec(src.spec, src.dim())
    out = Sharded([torch.empty(shape, dtype=s.dtype, device=s.device)
                   for s in src.shards], src.mesh,
                  P(*(None if d == dim else e for d, e in enumerate(spec))))
    return move_rows(out, dim, range(len(rows)), src, rows)
