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
:func:`relayout` re-lays a value from one PartitionSpec to another:
gathers over the axes it leaves, local slices for the axes it takes.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Sequence, Union

import torch

from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import Sharded

OP_NAMES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")

#: the logs of the open ``recording`` blocks
_OPEN: List[Dict[str, int]] = []

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


def _group_results(x: Sharded, live: tuple, op: str):
    """(group, its reduced value on its first position's device) per
    group: float32 (for floating operands) in rank order, rounded once."""
    out = []
    for g in x.mesh.groups(live):
        dev = x.shards[g[0]].device
        parts = [x.shards[r].to(dev, non_blocking=True) for r in g]
        dtype = parts[0].dtype
        wide = torch.float32 if dtype.is_floating_point else dtype
        acc = parts[0].to(wide)
        for t in parts[1:]:
            acc = (torch.maximum(acc, t.to(wide)) if op == "max"
                   else acc + t.to(wide))
        if op == "mean":
            acc = acc / len(g)
        out.append((g, acc.to(dtype)))
    return out


def _reduce(x: Sharded, axes: AxesArg, op: str) -> Sharded:
    live = _axes(x, axes)
    if not live:
        return x
    out = [None] * x.mesh.size
    for g, res in _group_results(x, live, op):
        for i, r in enumerate(g):
            out[r] = _place(res, x.shards[r].device, i == 0)
    record("all-reduce", _nbytes(out[0]))
    return Sharded(out, x.mesh, x.spec)


def psum(x: Sharded, axes: AxesArg) -> Sharded:
    return _reduce(x, axes, "sum")


def pmax(x: Sharded, axes: AxesArg) -> Sharded:
    return _reduce(x, axes, "max")


def pmean(x: Sharded, axes: AxesArg) -> Sharded:
    return _reduce(x, axes, "mean")


def all_gather(x: Sharded, axes: AxesArg, dim: int = 0,
               tiled: bool = True) -> Sharded:
    """Each position gets its group's shards in rank order, concatenated
    along ``dim`` (``tiled``) or stacked on a new ``dim``."""
    live = _axes(x, axes)
    if not live:
        return x if tiled else Sharded([s.unsqueeze(dim) for s in x.shards],
                                       x.mesh)
    out = [None] * x.mesh.size
    for g in x.mesh.groups(live):
        dev = x.shards[g[0]].device
        parts = [x.shards[r].to(dev, non_blocking=True) for r in g]
        res = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        for i, r in enumerate(g):
            out[r] = _place(res, x.shards[r].device, i == 0)
    record("all-gather", _nbytes(out[0]))
    return Sharded(out, x.mesh)


def psum_scatter(x: Sharded, axes: AxesArg, dim: int = 0,
                 tiled: bool = True) -> Sharded:
    """The group's sum, split along ``dim`` into one block per rank: rank
    ``i`` keeps block ``i`` (``tiled``; else the dim, of the group's size,
    is dropped)."""
    live = _axes(x, axes)
    if not live:
        return x if tiled else Sharded([s.squeeze(dim) for s in x.shards],
                                       x.mesh)
    out = [None] * x.mesh.size
    for g, res in _group_results(x, live, "sum"):
        if res.shape[dim] % len(g):
            raise ValueError(f"dim {dim} of {tuple(res.shape)} does not split "
                             f"over {len(g)} positions")
        for i, (r, b) in enumerate(zip(g, res.chunk(len(g), dim))):
            b = b if tiled else b.squeeze(dim)
            out[r] = b.to(x.shards[r].device, non_blocking=True,
                          copy=True).contiguous()
    record("reduce-scatter", _nbytes(out[0]))
    return Sharded(out, x.mesh)


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

