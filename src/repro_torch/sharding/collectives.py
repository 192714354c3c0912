"""Collectives over the axes of a mesh, on :class:`Sharded` values.

The counterpart of the XLA collectives JAX's code calls inside
``shard_map``: ``psum``, ``pmax``, ``pmean``, ``all_gather``,
``psum_scatter`` and ``axis_index``, each over the positions that differ
only along the named axes (``Mesh.groups``), in one process.  A peer's
shard crosses over by ``Tensor.to(device, non_blocking=True)``: a plain
device copy between positions on one card, a peer copy between cards,
which PyTorch orders after the producer's work on its stream and before
the consumer's.  Sums run in float32 (for floating operands) in position
order and are rounded once to the operand's dtype, so every position of a
replicated result holds the same bits; each position gets its own tensor.

Each call records its per-position output bytes under XLA's op names
(``all-reduce`` for psum / pmax / pmean, ``all-gather``,
``reduce-scatter``), what JAX's ``collective_bytes`` reads off a
compiled program's HLO, into every open :func:`recording`.  A
collective over axes of size 1 is no collective and records nothing.

Autograd goes through ``psum``, ``pmean``, ``all_gather`` and
``psum_scatter`` as one node over every position (``_Collective``) whose
backward is the dual collective under the same rule: ``psum``'s is a
``psum`` of the cotangents (``pmean``'s their mean), ``all_gather``'s a
``psum_scatter``, ``psum_scatter``'s an ``all_gather``, each recording
its bytes under its own op name.  A cotangent read at one position (a
loss replicated by a ``psum``, differentiated once) thereby reaches every
position's operand once.  ``pmax`` passes no gradient (a softmax's
shift, a quantiser's scale).  Without a shard that requires grad the
collectives run on the tensors as they are.
:func:`relayout` re-lays a value from one PartitionSpec to another:
gathers over the axes it leaves, local slices for the axes it takes.
"""
from __future__ import annotations

import contextlib
import functools
import math
from collections import defaultdict
from typing import Dict, List, Sequence, Union

import torch

from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import Sharded

OP_NAMES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")

#: the logs of the open ``recording`` blocks
_OPEN: List[Dict[str, int]] = []

#: run each collective under a profiler range ``collective::<op>`` (a
#: profiled step's collective time; off, no range is opened)
ANNOTATE = False

AxesArg = Union[str, Sequence[str]]


def record(op: str, nbytes: int):
    """Add ``nbytes`` (per position) under ``op``."""
    if op not in OP_NAMES:
        raise ValueError(f"unknown collective {op!r}")
    for log in _OPEN:
        log[op] += int(nbytes)


@contextlib.contextmanager
def recording():
    """``with recording() as log:`` — ``log`` ({op: bytes per position})
    gathers what the collectives inside the block moved."""
    log: Dict[str, int] = defaultdict(int)
    _OPEN.append(log)
    try:
        yield log
    finally:
        _OPEN.remove(log)


def _axes(x: Sharded, axes: AxesArg) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = x.mesh.shape
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _place(t: torch.Tensor, device, first: bool) -> torch.Tensor:
    """``t`` for a position on ``device``: a copy unless it is the first
    on ``t``'s own device, so no two positions share a tensor."""
    if t.device != device:
        return t.to(device, non_blocking=True)
    return t if first else t.clone()


def _sum(parts: list, op: str = "sum", n: int = 1) -> torch.Tensor:
    """The parts' sum (max; mean over ``n``) in float32 for floating
    operands, in order, rounded once to their dtype."""
    dtype = parts[0].dtype
    wide = torch.float32 if dtype.is_floating_point else dtype
    acc = parts[0].to(wide)
    for t in parts[1:]:
        acc = (torch.maximum(acc, t.to(wide)) if op == "max"
               else acc + t.to(wide))
    if op == "mean":
        acc = acc / n
    return acc.to(dtype)


def _gathered(shards: list, g: list, dev) -> list:
    """The group ``g``'s shards on ``dev``, in rank order."""
    return [shards[r].to(dev, non_blocking=True) for r in g]


# --------------------------------------------------------------------------
# the collectives on per-position lists of tensors (no autograd)
# --------------------------------------------------------------------------
def _annotated(op: str):
    """A list collective run under the profiler range of ``op`` while
    :data:`ANNOTATE` is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args):
            if not ANNOTATE:
                return fn(*args)
            with torch.profiler.record_function(f"collective::{op}"):
                return fn(*args)
        return run
    return wrap


@_annotated("all-reduce")
def _reduce_list(shards: list, mesh, live: tuple, op: str) -> list:
    """Each group's reduction, on every position of the group."""
    out = [None] * mesh.size
    for g in mesh.groups(live):
        res = _sum(_gathered(shards, g, shards[g[0]].device), op, len(g))
        for i, r in enumerate(g):
            out[r] = _place(res, shards[r].device, i == 0)
    record("all-reduce", _nbytes(out[0]))
    return out


@_annotated("all-gather")
def _gather_list(shards: list, mesh, live: tuple, dim: int,
                 tiled: bool) -> list:
    out = [None] * mesh.size
    for g in mesh.groups(live):
        parts = _gathered(shards, g, shards[g[0]].device)
        res = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        for i, r in enumerate(g):
            out[r] = _place(res, shards[r].device, i == 0)
    record("all-gather", _nbytes(out[0]))
    return out


@_annotated("reduce-scatter")
def _scatter_list(shards: list, mesh, live: tuple, dim: int,
                  tiled: bool) -> list:
    out = [None] * mesh.size
    for g in mesh.groups(live):
        res = _sum(_gathered(shards, g, shards[g[0]].device))
        if res.shape[dim] % len(g):
            raise ValueError(f"dim {dim} of {tuple(res.shape)} does not split "
                             f"over {len(g)} positions")
        for r, b in zip(g, res.chunk(len(g), dim)):
            b = b if tiled else b.squeeze(dim)
            out[r] = b.to(shards[r].device, non_blocking=True,
                          copy=True).contiguous()
    record("reduce-scatter", _nbytes(out[0]))
    return out


def _out_shape(shape, kind: str, dim: int, tiled: bool, n: int) -> tuple:
    """A position's result shape of collective ``kind`` over a group of
    ``n`` on a shard of ``shape``."""
    s = list(shape)
    if kind == "gather":
        if tiled:
            s[dim] *= n
        else:
            s.insert(dim, n)
    elif kind == "scatter":
        if tiled:
            s[dim] //= n
        else:
            del s[dim]
    return tuple(s)


class _Collective(torch.autograd.Function):
    """A collective autograd records as one node over every position: its
    backward is its dual under the same rule (float32 in position order,
    rounded once), ``psum`` <-> ``psum`` (``pmean`` its mean),
    ``all_gather`` <-> ``psum_scatter``, so a cotangent read at any
    position reaches each position's operand once.  A position whose
    result nothing read gives a zero cotangent.  The backward
    collectives record their bytes as the forward ones do."""

    @staticmethod
    def forward(ctx, kind, mesh, live, dim, tiled, *shards):
        ctx.set_materialize_grads(False)
        ctx.meta = (kind, mesh, live, dim, tiled)
        n = math.prod(mesh.shape[a] for a in live)
        ctx.out_like = [(_out_shape(s.shape, kind, dim, tiled, n), s.dtype,
                         s.device) for s in shards]
        return tuple(_apply(kind, list(shards), mesh, live, dim, tiled))

    @staticmethod
    def backward(ctx, *grads):
        kind, mesh, live, dim, tiled = ctx.meta
        if all(g is None for g in grads):
            return (None,) * (5 + mesh.size)
        full = [torch.zeros(*w[:1], dtype=w[1], device=w[2]) if g is None
                else g for g, w in zip(grads, ctx.out_like)]
        return (None,) * 5 + tuple(_apply(_DUAL[kind], full, mesh, live,
                                          dim, tiled))


#: each collective's dual: the collective its backward runs
_DUAL = {"sum": "sum", "mean": "mean", "gather": "scatter",
         "scatter": "gather"}


def _apply(kind: str, shards: list, mesh, live: tuple, dim: int,
           tiled: bool) -> list:
    """Collective ``kind`` (a reduction's op, "gather" or "scatter") on
    per-position ``shards``."""
    if kind == "gather":
        return _gather_list(shards, mesh, live, dim, tiled)
    if kind == "scatter":
        return _scatter_list(shards, mesh, live, dim, tiled)
    return _reduce_list(shards, mesh, live, kind)


def _run(kind: str, x: Sharded, axes: AxesArg, dim: int = 0,
         tiled: bool = True) -> Sharded:
    """Collective ``kind`` on ``x``'s shards over ``axes`` (``x`` itself
    over axes of size 1): through autograd when a shard requires it,
    else on the tensors as they are.  A reduction keeps ``x``'s
    layout."""
    live = _axes(x, axes)
    if not live:
        return x
    if torch.is_grad_enabled() and any(s.requires_grad for s in x.shards):
        out = list(_Collective.apply(kind, x.mesh, live, dim, tiled,
                                     *x.shards))
    else:
        out = _apply(kind, x.shards, x.mesh, live, dim, tiled)
    return Sharded(out, x.mesh, x.spec if kind in ("sum", "mean") else None)


def psum(x: Sharded, axes: AxesArg) -> Sharded:
    return _run("sum", x, axes)


def pmax(x: Sharded, axes: AxesArg) -> Sharded:
    """The group's max; no gradient flows through it (a softmax's shift,
    a quantiser's scale)."""
    live = _axes(x, axes)
    if not live:
        return x
    with torch.no_grad():
        out = _reduce_list(x.shards, x.mesh, live, "max")
    return Sharded(out, x.mesh, x.spec)


def pmean(x: Sharded, axes: AxesArg) -> Sharded:
    return _run("mean", x, axes)


def all_gather(x: Sharded, axes: AxesArg, dim: int = 0,
               tiled: bool = True) -> Sharded:
    """Each position gets its group's shards in rank order, concatenated
    along ``dim`` (``tiled``) or stacked on a new ``dim``."""
    if not tiled and not _axes(x, axes):
        return Sharded([s.unsqueeze(dim) for s in x.shards], x.mesh)
    return _run("gather", x, axes, dim, tiled)


def psum_scatter(x: Sharded, axes: AxesArg, dim: int = 0,
                 tiled: bool = True) -> Sharded:
    """The group's sum, split along ``dim`` into one block per rank: rank
    ``i`` keeps block ``i`` (``tiled``; else the dim, of the group's size,
    is dropped)."""
    if not tiled and not _axes(x, axes):
        return Sharded([s.squeeze(dim) for s in x.shards], x.mesh)
    return _run("scatter", x, axes, dim, tiled)


def axis_index(mesh, axes: AxesArg) -> Sharded:
    """Each position's rank along ``axes`` (major to minor), a Python
    int per position."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    return Sharded([mesh.rank(r, axes) for r in range(mesh.size)], mesh)


def relayout(x: Sharded, want, have=None) -> Sharded:
    """``x`` (laid out by ``have``, default ``x.spec``) laid out by
    ``want``: an all-gather along each dim whose axes ``want`` does not
    keep, then each position's slice along each dim ``want`` splits.  A
    value already in ``want`` comes back as it is."""
    have = P(*(x.spec if have is None else have))
    nd = x.dim()
    have = P(*(tuple(have) + (None,) * (nd - len(have))))
    want = P(*(tuple(want) + (None,) * (nd - len(want))))
    if tuple(have) == tuple(want):
        return x if x.spec == want else Sharded(x.shards, x.mesh, want)
    cur, cur_spec = x, list(have)
    for d in range(nd):
        ha = have.axes_of(d)
        if ha and ha != want.axes_of(d):
            cur = all_gather(cur, ha, dim=d, tiled=True)
            cur_spec[d] = None
    shards = list(cur.shards)
    sizes = x.mesh.shape
    for d in range(nd):
        wa = want.axes_of(d)
        if wa and cur_spec[d] is None:
            k = 1
            for a in wa:
                k *= sizes[a]
            for r in range(x.mesh.size):
                n = shards[r].shape[d] // k
                shards[r] = shards[r].narrow(d, x.mesh.rank(r, wa) * n, n)
            cur_spec[d] = want[d]
    return Sharded(shards, x.mesh, want)

