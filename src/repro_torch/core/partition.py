"""Elastic physical partitions: Zones + the PartitionTable.

The paper's supervisor shares one tiny lock-free structure with all
subOSes: the *descriptions of physical partitions*.  Here that is the
:class:`PartitionTable` — an **immutable, epoch-versioned snapshot**.
Readers (cells) never lock; every mutation publishes a new table with
``epoch + 1``.  A cell binds its compiled programs to the epoch it was
created under; the BoundaryGuard rejects stale-epoch executions after a
resize (the analogue of Security guard bounding ``mov-to-cr3`` by the
partition descriptions).

Resource model: the cluster is a grid of devices ``(pods, R, C)``.  The
isolation granularity is one **column** (R chips sharing an ICI ring) so a
zone = a contiguous column range on one or more pods; all collectives of a
cell stay inside its own columns/rows (the "TLB shootdown confined to a
subOS" analogue).  Column 0 of pod 0 is reserved for the supervisor, like
the paper's firstly-booted instance.

The port's grid holds ``torch.device``s where the JAX package's holds JAX
devices, and ``DeviceGrid.zone_mesh`` builds the port's own ``Mesh``
over a zone, as JAX's builds a ``jax.sharding.Mesh``: (R, ncols) ->
(``data``, ``model``), and with pods (``pod``, ``data``, ``model``).  How
many positions that mesh has is the grid's to say:

* a grid whose entries were stated one by one (``from_flat`` given at
  least as many devices as entries, repeats allowed: ``["cpu"] * 8``)
  gets one mesh position per entry;
* a grid cycled from fewer devices (``from_flat(..., allow_reuse=True)``
  given fewer devices than entries) holds the logical columns of a
  machine's cards: a zone whose entries all name one card is one
  position, the one-device cell it always was (several columns, one
  card), and a zone over more than one distinct device gets one
  position per entry.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.rules import Mesh


class PartitionError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Zone:
    """A contiguous sub-grid: columns [c0, c1) on each pod in ``pods``."""

    name: str
    pods: Tuple[int, ...]
    c0: int
    c1: int

    @property
    def ncols(self) -> int:
        return self.c1 - self.c0

    def columns(self) -> FrozenSet[Tuple[int, int]]:
        return frozenset((p, c) for p in self.pods for c in range(self.c0, self.c1))


@dataclasses.dataclass(frozen=True)
class PartitionTable:
    """Immutable snapshot of the cluster partitioning."""

    grid_shape: Tuple[int, int, int]          # (pods, R, C)
    epoch: int = 0
    zones: Tuple[Zone, ...] = ()
    failed_columns: FrozenSet[Tuple[int, int]] = frozenset()

    # ---- queries ----------------------------------------------------------
    def zone(self, name: str) -> Zone:
        for z in self.zones:
            if z.name == name:
                return z
        raise PartitionError(f"no zone {name!r}")

    def has_zone(self, name: str) -> bool:
        return any(z.name == name for z in self.zones)

    def used_columns(self) -> FrozenSet[Tuple[int, int]]:
        out: set = set()
        for z in self.zones:
            cols = z.columns()
            if out & cols:
                raise PartitionError("overlapping zones (corrupt table)")
            out |= cols
        return frozenset(out)

    def free_columns(self, pods: Sequence[int]) -> Dict[int, list]:
        """Free (non-failed) columns per pod, ascending."""
        used = self.used_columns() | self.failed_columns
        P_, R, C = self.grid_shape
        return {
            p: [c for c in range(C) if (p, c) not in used] for p in pods
        }

    def check_invariants(self):
        P_, R, C = self.grid_shape
        used = self.used_columns()               # raises on overlap
        for (p, c) in used:
            if not (0 <= p < P_ and 0 <= c < C):
                raise PartitionError(f"zone column ({p},{c}) outside grid")
        if used & self.failed_columns:
            raise PartitionError("zone includes failed column")

    # ---- mutations (all return a new epoch) --------------------------------
    def _bump(self, zones: Tuple[Zone, ...], failed=None) -> "PartitionTable":
        t = PartitionTable(
            grid_shape=self.grid_shape,
            epoch=self.epoch + 1,
            zones=zones,
            failed_columns=self.failed_columns if failed is None else failed,
        )
        t.check_invariants()
        return t

    def carve(self, name: str, ncols: int, pods: Sequence[int] = (0,)) -> Tuple["PartitionTable", Zone]:
        """First-fit a contiguous [c0,c1) range free on every requested pod."""
        if self.has_zone(name):
            raise PartitionError(f"zone {name!r} exists")
        if ncols < 1:
            raise PartitionError("ncols must be >= 1")
        P_, R, C = self.grid_shape
        used = self.used_columns() | self.failed_columns
        for c0 in range(0, C - ncols + 1):
            cols = [(p, c) for p in pods for c in range(c0, c0 + ncols)]
            if not any(col in used for col in cols):
                z = Zone(name=name, pods=tuple(pods), c0=c0, c1=c0 + ncols)
                return self._bump(self.zones + (z,)), z
        raise PartitionError(
            f"no contiguous {ncols}-column range free on pods {list(pods)}"
        )

    def release(self, name: str) -> "PartitionTable":
        self.zone(name)                  # raises on unknown zone
        return self._bump(tuple(x for x in self.zones if x.name != name))

    def resize(self, name: str, new_ncols: int, *, shrink_side: str = "right"
               ) -> Tuple["PartitionTable", Zone]:
        """Grow/shrink a zone; falls back to re-carving when the adjacent
        columns are taken (production note: a real allocator would migrate;
        the cell reshards its state either way).  ``shrink_side`` picks the
        edge released when shrinking (the transfer path frees the edge
        adjacent to the taker)."""
        z = self.zone(name)
        if new_ncols == z.ncols:
            return self, z
        used = (self.used_columns() - z.columns()) | self.failed_columns
        P_, R, C = self.grid_shape
        if new_ncols < z.ncols:
            if shrink_side == "left":
                nz = Zone(z.name, z.pods, z.c1 - new_ncols, z.c1)
            else:
                nz = Zone(z.name, z.pods, z.c0, z.c0 + new_ncols)
            zones = tuple(nz if x.name == name else x for x in self.zones)
            return self._bump(zones), nz
        # try growing right, then left
        grow = new_ncols - z.ncols
        right_ok = z.c1 + grow <= C and not any(
            (p, c) in used for p in z.pods for c in range(z.c1, z.c1 + grow)
        )
        if right_ok:
            nz = Zone(z.name, z.pods, z.c0, z.c1 + grow)
        else:
            left_ok = z.c0 - grow >= 0 and not any(
                (p, c) in used for p in z.pods for c in range(z.c0 - grow, z.c0)
            )
            if left_ok:
                nz = Zone(z.name, z.pods, z.c0 - grow, z.c1)
            else:
                t = self.release(name)
                return t.carve(name, new_ncols, z.pods)
        zones = tuple(nz if x.name == name else x for x in self.zones)
        return self._bump(zones), nz

    def transfer(self, src: str, dst: str, ncols: int) -> Tuple["PartitionTable", Zone, Zone]:
        """Move columns from one zone to another (the paper's CPU handoff).

        Frees the donor edge adjacent to the taker when they neighbor each
        other; if the shapes still don't fit, relocates both zones (the
        cells live-reshard onto their new zones either way)."""
        s = self.zone(src)
        if s.ncols - ncols < 1:
            raise PartitionError(f"{src!r} would drop below 1 column")
        d = self.zone(dst)
        side = "left" if s.c0 >= d.c1 else "right"
        try:
            t, ns = self.resize(src, s.ncols - ncols, shrink_side=side)
            t, nd = t.resize(dst, d.ncols + ncols)
            return t, ns, nd
        except PartitionError:
            pass
        # relocate both zones within the union of their columns + free space
        t = self.release(src).release(dst)
        t, nd = t.carve(dst, d.ncols + ncols, d.pods)
        t, ns = t.carve(src, s.ncols - ncols, s.pods)
        return t, ns, nd

    def mark_failed(self, pod: int, col: int) -> "PartitionTable":
        """Record a failed column; zones using it must be re-carved."""
        failed = self.failed_columns | {(pod, col)}
        zones = tuple(
            z for z in self.zones if (pod, col) not in z.columns()
        )
        t = PartitionTable(
            grid_shape=self.grid_shape, epoch=self.epoch + 1,
            zones=zones, failed_columns=failed,
        )
        t.check_invariants()
        return t

    def mark_restored(self, pod: int, col: int) -> "PartitionTable":
        """Return a failed column to the allocatable pool (quarantine is
        reversible: a repaired host rejoins; no-op when not failed)."""
        if (pod, col) not in self.failed_columns:
            return self
        return self._bump(self.zones, failed=self.failed_columns - {(pod, col)})


# ---------------------------------------------------------------------------
# device grids
# ---------------------------------------------------------------------------
def _canonical(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: ``"cuda"`` names
    the current card, as a tensor placed there reports it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceGrid:
    """Physical device array (pods, R, C) of ``torch.device``s -> the
    devices and meshes of zones.  ``explicit``: every entry is a mesh
    position (see the module doc)."""

    def __init__(self, devices: np.ndarray, explicit: bool = True):
        if devices.ndim != 3:
            raise PartitionError("expect a (pods, R, C) device array")
        self.devices = devices
        self.explicit = explicit

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.devices.shape)  # type: ignore[return-value]

    @classmethod
    def from_flat(cls, devices: Sequence, pods: int, rows: int, cols: int,
                  allow_reuse: bool = False) -> "DeviceGrid":
        need = pods * rows * cols
        devs = [_canonical(d) for d in devices]
        explicit = len(devs) >= need
        if not explicit:
            if not allow_reuse:
                raise PartitionError(f"need {need} devices, have {len(devs)}")
            devs = list(itertools.islice(itertools.cycle(devs), need))
        arr = np.empty(need, dtype=object)
        arr[:] = devs[:need]
        return cls(arr.reshape(pods, rows, cols), explicit)

    def zone_devices(self, zone: Zone) -> np.ndarray:
        sub = self.devices[list(zone.pods), :, zone.c0:zone.c1]
        return sub  # (npods, R, ncols)

    def distinct_devices(self, zone: Zone) -> List[torch.device]:
        """The zone's distinct devices, in grid order."""
        return list(dict.fromkeys(self.zone_devices(zone).flat))

    def zone_mesh(self, zone: Zone) -> Mesh:
        """The zone's mesh: (``data``, ``model``) over (R, ncols), or
        (``pod``, ``data``, ``model``) over several pods; one position
        for a cycled grid's zone on one device."""
        sub = self.zone_devices(zone)
        if not self.explicit and len(set(sub.flat)) == 1:
            return Mesh(sub.reshape(-1)[:1].reshape(1, 1), ("data", "model"))
        if sub.shape[0] == 1:
            return Mesh(sub[0], ("data", "model"))
        return Mesh(sub, ("pod", "data", "model"))


def single_device_grid(device) -> DeviceGrid:
    """1x1x1 grid over ``device`` (logical zones on one card, or the CPU
    in tests)."""
    return DeviceGrid.from_flat([device], 1, 1, 1)
