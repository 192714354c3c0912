"""BoundaryGuard — the Security-guard analogue.

The paper's Security guard maps the partition descriptions read-only and
checks privileged operations (page-table updates, ``mov-to-cr3``) against
them.  Here the "privileged operation" is *running a cell's program*: a
step graph of one of the cell's batchers, with every tensor the graph
captured (params, arena, resident rows, caches, static inputs).  The
guard checks that

1. every such tensor lies on one of the zone's devices (physical
   confinement; the JAX package reads the devices off a compiled
   executable's shardings), and
2. the graph was captured under the cell's current zone epoch (no stale
   graph survives a resize — the resize is the analogue of a page-table
   change).

Like the paper (whose implementation omits enforcement), this is a
validation layer: it raises on violation rather than confining CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import torch


class BoundaryViolation(Exception):
    pass


@dataclasses.dataclass
class Program:
    """One program of a cell: ``tensors`` are what it reads and writes;
    ``epoch`` is the zone epoch it was captured at (None: not a graph,
    the batcher's eager state, bound to no epoch)."""

    name: str
    tensors: Sequence[torch.Tensor]
    epoch: Optional[int] = None


def program_devices(program: Program) -> set:
    """Devices a program's tensors lie on (the counterpart of the JAX
    package's ``executable_device_ids``)."""
    return {t.device for t in program.tensors}


class BoundaryGuard:
    def __init__(self, table_provider):
        """table_provider: zero-arg callable returning the current table."""
        self._table = table_provider

    def validate_devices(self, program: Program,
                         zone_devices: Iterable[torch.device],
                         cell_name: str):
        used = program_devices(program)
        allowed = set(zone_devices)
        extra = used - allowed
        if extra:
            raise BoundaryViolation(
                f"cell {cell_name!r}: program {program.name!r} touches "
                f"devices {sorted(map(str, extra))} outside its zone "
                f"{sorted(map(str, allowed))}"
            )

    def validate_epoch(self, cell_name: str, bound_epoch: int):
        table = self._table()
        # A cell's programs bind to the epoch at capture time.  Any table
        # mutation that touched this cell's zone bumps its bound epoch via
        # the supervisor; mismatch => stale program.
        current = table.epoch
        if bound_epoch > current:
            raise BoundaryViolation(
                f"cell {cell_name!r}: program bound to future epoch {bound_epoch} > {current}"
            )

    def validate(self, cell, program: Program):
        self.validate_devices(program, cell.devices, cell.name)
        if program.epoch is not None and program.epoch != cell.zone_epoch:
            raise BoundaryViolation(
                f"cell {cell.name!r}: program {program.name!r} captured at "
                f"epoch {program.epoch} but zone changed at epoch "
                f"{cell.zone_epoch} (stale graph)"
            )
