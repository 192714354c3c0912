"""Logical-axis -> mesh-axis sharding rules, over the port's own mesh.

Every parameter / activation dim carries a *logical* axis name; the rules
below map it to (tuples of) mesh axes.  Resolution is divisibility-aware:
an axis that does not divide the dim is dropped (safe fallback to
replication).  The rules and their resolution are JAX's
(``repro/sharding/rules.py``) unchanged:

  batch     -> ("pod", "data")      DP over pods and the data axis
  vocab     -> "model"              vocab-parallel embedding / logits
  heads     -> "model"              Megatron TP for attention
  kv_heads  -> "model"              (dropped when n_kv < model-axis size)
  ffn       -> "model"              Megatron TP for MLPs
  expert    -> "model"              EP when E divides the model axis
  expert_ffn-> "model"              TP-in-expert when EP not divisible
  inner/ssm_heads -> "model"        Mamba d_inner / SSD head parallelism
  embed     -> "data"               ZeRO-3/FSDP weight sharding
  kv_seq    -> ("data", "model")    decode KV cache sequence sharding (SP)

A :class:`Mesh` is an array of mesh *positions* with axis names, each
position a ``torch.device``; positions may repeat a device (eight
positions on ``cpu`` in tests, two on ``cuda:0`` on one card).  The
program that runs over it is single-controller: one process holds every
position's shard (``sharding/sharded.py``) and the collectives
(``sharding/collectives.py``) move data between them, the counterpart of
JAX's ``shard_map`` with XLA's collectives.  :class:`P` is the port's
PartitionSpec: a tuple with one entry per dim, each None, an axis name,
a tuple of axis names (major to minor), or :class:`Segments` for a dim
whose consecutive parts are laid out each on its own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Axes = Tuple[str, ...]


class Segments(tuple):
    """A :class:`P` entry for a dim made of consecutive segments, each
    laid out on its own: ``((size, axes), ...)``, each segment's global
    size and the axes it is split over evenly (``()``: whole on every
    position).  A position holds its part of every segment, in order: the
    Mamba conv state's channels [x | B | C], laid out by position as
    [x_r | B | C] (x over ``model``, B and C whole)."""

    def __new__(cls, *segs):
        return super().__new__(cls, tuple((int(n), tuple(a))
                                          for n, a in segs))

    @property
    def axes(self) -> Axes:
        """Every axis some segment is split over."""
        return tuple(dict.fromkeys(a for _, axes in self for a in axes))

    def __repr__(self) -> str:
        return f"Segments{tuple.__repr__(self)}"


class P(tuple):
    """PartitionSpec: one entry per dim (None, an axis, axes, or
    :class:`Segments`)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes_of(self, dim: int) -> Axes:
        """The mesh axes dim ``dim`` is split over (major to minor; for
        :class:`Segments`, those of any segment)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        if isinstance(e, Segments):
            return e.axes
        return e if isinstance(e, tuple) else (e,)


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An n-d array of mesh positions with axis names.  ``devices`` holds
    the ``torch.device`` of each position (``devices.shape`` is the mesh
    shape, as JAX's ``Mesh.devices``); position ``r`` is the ``r``-th in
    row-major order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_canonical(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names: Axes = tuple(axis_names)
        # positions on distinct cards: work on a position runs under its
        # card's device guard (``sharding/sharded.py``)
        self.multi_card = len({d for d in self.positions
                               if d.type == "cuda"}) > 1
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> List[torch.device]:
        """The device of each position, in position order."""
        return list(self.devices.reshape(-1))

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.positions))

    def coords(self, r: int) -> Dict[str, int]:
        """Position ``r``'s index along each axis."""
        idx = np.unravel_index(r, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def rank(self, r: int, axes: Sequence[str]) -> int:
        """Position ``r``'s rank along ``axes`` (major to minor)."""
        c, sizes = self.coords(r), self.shape
        out = 0
        for a in axes:
            out = out * sizes[a] + c[a]
        return out

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The positions that differ only along ``axes``, one list per
        group, each ordered by rank along ``axes``: the participants of a
        collective over ``axes``."""
        axes = tuple(a for a in axes if a in self.axis_names)
        ids = np.arange(self.size).reshape(self.devices.shape)
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        moved = np.transpose(ids, keep + [self.axis_names.index(a)
                                          for a in axes])
        n = int(np.prod([self.shape[a] for a in axes])) if axes else 1
        return [list(map(int, g)) for g in moved.reshape(-1, n)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.distinct_devices()})"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Per-cell sharding context: the cell's mesh + axis roles.

    ``dp_over_model``: ZeRO-3 layout — the model axis joins the batch axes
    (DP over every axis), weights keep FSDP sharding, and only the vocab
    head stays model-parallel."""

    mesh: Mesh
    batch_axes: Axes = ("data",)
    model_axis: Optional[str] = "model"
    fsdp: bool = True
    dp_over_model: bool = False

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape))

    @property
    def sharded(self) -> bool:
        """Does the mesh hold more than one position?"""
        return self.mesh.size > 1

    def dp_size(self) -> int:
        sizes = self.axis_sizes
        axes = self.rules()["batch"]
        return int(np.prod([sizes[a] for a in axes]))

    def model_size(self) -> int:
        if self.model_axis is None:
            return 1
        return self.axis_sizes[self.model_axis]

    # ---- rules ------------------------------------------------------------
    def rules(self) -> Dict[str, Axes]:
        m = (self.model_axis,) if self.model_axis else ()
        fsdp_axes: Axes = (
            tuple(a for a in ("pod", "data") if a in self.axis_sizes)
            if self.fsdp else ()
        )
        if self.dp_over_model:
            return {
                "batch": self.batch_axes + m,
                "batch_head": self.batch_axes,
                "vocab": m,
                "heads": (), "kv_heads": (), "ffn": (),
                "expert": (), "expert_ffn": (), "inner": (), "ssm_heads": (),
                "embed": fsdp_axes,
                "kv_seq": (),
                "act_seq": (), "act_embed": (),
            }
        return {
            "batch": self.batch_axes,
            "batch_head": self.batch_axes,
            "vocab": m,
            "heads": m,
            "kv_heads": m,
            "ffn": m,
            "expert": m,
            "expert_ffn": m,
            "inner": m,
            "ssm_heads": m,
            # serve mode (fsdp off): embed falls back to the model axis, and
            # resolves last, so a TP dim keeps the model axis when it can
            "embed": fsdp_axes if self.fsdp else m,
            "kv_seq": tuple(a for a in ("data",) + m if a in self.axis_sizes),
            "act_seq": m,
            "act_embed": m,
        }

    # ---- resolution -------------------------------------------------------
    # batch dims bind first (the decode cache's batch dim wins the data
    # axis over kv_seq), then TP dims, then "embed"
    _PRIORITY = {"batch": 0, "batch_head": 0, "embed": 2}

    def pspec(self, logical: Sequence[Optional[str]],
              shape: Sequence[int]) -> P:
        """Resolve logical axes to a :class:`P`, divisibility-aware."""
        rules = self.rules()
        sizes = self.axis_sizes
        used: set = set()
        parts: list = [None] * len(shape)
        order = sorted(range(len(shape)),
                       key=lambda i: (self._PRIORITY.get(logical[i], 1), i))
        for i in order:
            dim, name = shape[i], logical[i]
            if name is None or name not in rules:
                continue
            chosen = []
            prod = 1
            for ax in rules[name]:
                if ax in used or ax not in sizes:
                    continue
                if dim % (prod * sizes[ax]) == 0:
                    chosen.append(ax)
                    prod *= sizes[ax]
            if not chosen:
                continue
            parts[i] = chosen[0] if len(chosen) == 1 else tuple(chosen)
            used.update(chosen)
        return P(*parts)

    def params_pspecs(self, spec_tree):
        """P tree for a PSpec tree."""
        from repro_torch.models.param import tree_map_pspec
        return tree_map_pspec(lambda s: self.pspec(s.logical, s.shape),
                              spec_tree)


def single_device_ctx(device="cpu") -> ShardCtx:
    """A one-position ctx (the unsharded path)."""
    return ShardCtx(mesh=Mesh(np.array([[device]], dtype=object),
                              ("data", "model")))


def make_ctx(mesh: Mesh, fsdp: bool = True,
             dp_over_model: bool = False) -> ShardCtx:
    """Infer axis roles from mesh axis names (pod/data/model)."""
    names = mesh.axis_names
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    model_axis = "model" if "model" in names else None
    return ShardCtx(mesh=mesh, batch_axes=batch_axes or (names[0],),
                    model_axis=model_axis, fsdp=fsdp,
                    dp_over_model=dp_over_model)
