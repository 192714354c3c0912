"""Supervisor — discovers, monitors, and provisions; never on the step path.

Owns the PartitionTable (epoch-versioned) and the cell registry.  Two API
layers:

* **Declarative control plane** (the one applications use):
  :meth:`Supervisor.apply` adopts a :class:`~repro_torch.core.spec.ClusterSpec`
  as the desired state and :meth:`Supervisor.reconcile` continuously
  converges the cluster toward it — diffing desired vs. observed (cells,
  zones, health) and executing an ordered plan of primitive ops.  Elastic
  policies (:class:`~repro_torch.core.elastic.ReconcilePolicy`) never call
  primitives; they rewrite the spec's desired ``ncols`` from live
  TTFT/TPOT accounting and reconcile.
* **Primitive plan-executor layer** (the paper's verbs): create /
  destroy / resize / transfer (preemption), fault detection via
  heartbeats, failed-column quarantine + checkpoint-restore recovery,
  ``restore_column`` to lift a quarantine, and straggler mitigation by
  resizing away from slow columns.  The reconciler is their only
  in-tree caller outside benchmarks of the primitives themselves.

Every operation is timestamped into an event log (the Table-4 elasticity
measurements read from it).

The port's supervisor keeps every verb of the JAX package's, the restore
of a cell from its checkpoint directory by role (``restore_from_ckpt``,
``recover_cell(ckpt_dir=)``) among them.  A new table is committed only
once the cell has bound its new zone, so a zone that a cell refuses (one
over more than one distinct device) leaves the table as it was.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cell import Cell, CellError
from repro_torch.core.channels import ArrayChannel, ControlPlane
from repro_torch.core.guard import BoundaryGuard
from repro_torch.core.partition import DeviceGrid, PartitionError, PartitionTable
from repro_torch.core.reconciler import Plan, Reconciler
from repro_torch.core.spec import ClusterSpec, SpecError
from repro_torch.train.optimizer import OptConfig, init_adam_state
from repro_torch.train.train_step import TrainState, train_state_pspecs


class Supervisor:
    def __init__(self, grid: DeviceGrid, *, heartbeat_timeout: float = 30.0):
        self.grid = grid
        self.table = PartitionTable(grid_shape=grid.shape)
        self.cells: Dict[str, Cell] = {}
        self.control = ControlPlane()
        self.control.register("supervisor")
        self.guard = BoundaryGuard(lambda: self.table)
        self.heartbeat_timeout = heartbeat_timeout
        self.events: List[dict] = []
        self.channels: List[ArrayChannel] = []
        self.desired: Optional[ClusterSpec] = None
        # drain-before-destroy hooks: each is called with the doomed
        # cell's name while the cell and its channels are still live —
        # the serving plane's chance to hand state (hot KV pages,
        # in-flight requests) to survivors before the zone is released
        # (the paper's live subOS resize; see serve/cacheplane.py)
        self.drain_hooks: List = []

    # ------------------------------------------------------------------
    # declarative control plane
    # ------------------------------------------------------------------
    def apply(self, spec: ClusterSpec) -> Plan:
        """Adopt ``spec`` as the desired state and reconcile toward it.

        The spec is total: cells it does not name are destroyed.  Returns
        the executed :class:`~repro_torch.core.reconciler.Plan`.
        """
        self._validate_tenancy(spec)
        self.desired = spec
        self._log("apply", cells=[c.name for c in spec.cells])
        return self.reconcile()

    @staticmethod
    def _validate_tenancy(spec: ClusterSpec):
        """Tenancy is a property of a serving SURFACE, not one cell: a kv
        channel makes its two ends (prefill feeding decode) one surface,
        so a tenant contract declared on both ends must be identical —
        otherwise admission and quota decisions would disagree about the
        same request depending on which cell looks at it.  Declaring the
        contract on only one end is fine (the surface adopts it)."""
        for ch in spec.channels:
            if ch.kind != "kv":
                continue
            a, b = spec.cell(ch.src), spec.cell(ch.dst)
            if a.tenants and b.tenants and a.tenants != b.tenants:
                raise SpecError(
                    f"kv-joined cells {a.name!r} and {b.name!r} declare "
                    "conflicting tenant contracts — one serving surface, "
                    "one contract")

    def reconcile(self) -> Plan:
        """Converge observed state toward the last applied spec.

        Safe to call in a loop: an empty plan means converged; degraded
        cells keep a pending grow that lands once columns free up.
        """
        plan = Reconciler(self).reconcile(self.desired)
        if not plan.empty:
            self._log("reconcile", plan=plan.summary())
        return plan

    # ------------------------------------------------------------------
    def _log(self, op: str, **kw):
        evt = {"ts": time.monotonic(), "op": op, "epoch": self.table.epoch, **kw}
        self.events.append(evt)
        return evt

    # ------------------------------------------------------------------
    # lifecycle primitives
    # ------------------------------------------------------------------
    def create_cell(
        self,
        name: str,
        arch: ArchConfig,
        role: str,
        *,
        ncols: int = 1,
        pods: Sequence[int] = (0,),
        opt_cfg: Optional[OptConfig] = None,
        parent: Optional[str] = None,
    ) -> Cell:
        t0 = time.monotonic()
        table, zone = self.table.carve(name, ncols, pods)
        cell = Cell(
            name, zone, self.grid, arch, role,
            epoch=table.epoch, opt_cfg=opt_cfg, parent=parent,
        )
        self.table = table
        self.cells[name] = cell
        self.control.register(name)
        self._log("create", cell=name, ncols=ncols, seconds=time.monotonic() - t0)
        return cell

    def destroy_cell(self, name: str):
        t0 = time.monotonic()
        cell = self.cells.pop(name)
        cell.destroy()
        for ch in self.channels:
            if ch.open and (ch.src is cell or ch.dst is cell):
                ch.close()
        if self.table.has_zone(name):   # a failed cell's zone is already gone
            self.table = self.table.release(name)
        self.control.unregister(name)
        self._log("destroy", cell=name, seconds=time.monotonic() - t0)

    def resize_cell(self, name: str, new_ncols: int) -> dict:
        t0 = time.monotonic()
        cell = self.cells[name]
        table, zone = self.table.resize(name, new_ncols)
        stats = cell.resize_to(zone, table.epoch)
        self.table = table
        stats["seconds_total"] = time.monotonic() - t0
        self._log("resize", cell=name, **stats)
        return stats

    def transfer_columns(self, src: str, dst: str, ncols: int = 1) -> dict:
        """Preemption path: move columns from a donor to a taker cell."""
        t0 = time.monotonic()
        table, zs, zd = self.table.transfer(src, dst, ncols)
        s1 = self.cells[src].resize_to(zs, table.epoch)
        s2 = self.cells[dst].resize_to(zd, table.epoch)
        self.table = table
        out = {
            "seconds_total": time.monotonic() - t0,
            "shrink": s1, "grow": s2,
        }
        # beside JAX's keys: each side's resize, the seconds of its move
        self._log("transfer", src=src, dst=dst, ncols=ncols,
                  seconds=out["seconds_total"],
                  resize_seconds={"shrink": s1["seconds"],
                                  "grow": s2["seconds"]})
        return out

    def spawn_child(self, parent_name: str, child_name: str, arch: ArchConfig,
                    role: str, ncols: int = 1) -> Cell:
        """Fork-like spawn: the child's zone is carved out of the parent's."""
        parent = self.cells[parent_name]
        if parent.zone.ncols - ncols < 1:
            raise CellError("parent too small to fork")
        table, pz = self.table.resize(parent_name, parent.zone.ncols - ncols)
        parent.resize_to(pz, table.epoch)
        self.table = table
        child = self.create_cell(
            child_name, arch, role, ncols=ncols, pods=parent.zone.pods,
            parent=parent_name,
        )
        self._log("spawn_child", parent=parent_name, child=child_name)
        return child

    # ------------------------------------------------------------------
    # health / fault tolerance
    # ------------------------------------------------------------------
    def check_health(self) -> List[str]:
        now = time.monotonic()
        dead = [
            c.name for c in self.cells.values()
            if c.status == "running" and now - c.last_heartbeat > self.heartbeat_timeout
        ]
        for name in dead:
            self._log("dead_cell", cell=name)
        return dead

    def fail_column(self, pod: int, col: int) -> List[str]:
        """A column (host/ICI ring) failed: evict affected cells."""
        affected = [
            z.name for z in self.table.zones if (pod, col) in z.columns()
        ]
        self.table = self.table.mark_failed(pod, col)
        for name in affected:
            cell = self.cells.get(name)
            if cell:
                cell.status = "failed"
        self._log("fail_column", pod=pod, col=col, affected=affected)
        return affected

    def restore_column(self, pod: int, col: int) -> bool:
        """Lift the quarantine from ``fail_column``/``mitigate_straggler``.

        Returns True when the column was quarantined.  The column is only
        made allocatable again — run :meth:`reconcile` afterwards to grow
        degraded cells back to their desired widths.
        """
        restored = (pod, col) in self.table.failed_columns
        self.table = self.table.mark_restored(pod, col)
        if restored:
            self._log("restore_column", pod=pod, col=col)
        return restored

    def recover_cell(self, name: str, *, ncols: Optional[int] = None,
                     ckpt_dir: Optional[str] = None) -> Cell:
        """Re-carve a zone for a failed cell and restore from checkpoint."""
        t0 = time.monotonic()
        old = self.cells[name]
        arch, role, opt_cfg = old.arch, old.role, old.opt_cfg
        pods = old.zone.pods
        for ch in self.channels:     # channels bound to the dead cell object
            if ch.open and (ch.src is old or ch.dst is old):
                ch.close()
        want = ncols if ncols is not None else old.zone.ncols
        if self.table.has_zone(name):
            self.table = self.table.release(name)
        del self.cells[name]
        self.control.unregister(name)
        cell = None
        for try_cols in range(want, 0, -1):
            try:
                cell = self.create_cell(name, arch, role, ncols=try_cols,
                                        pods=pods, opt_cfg=opt_cfg)
                break
            except PartitionError:
                continue
        if cell is None:
            raise PartitionError(
                f"cannot recover {name!r}: no free columns on pods {list(pods)}"
            )
        if cell.zone.ncols < want:
            self._log("recover_degraded", cell=name, want=want,
                      got=cell.zone.ncols)
        if ckpt_dir is not None:
            self.restore_from_ckpt(cell, ckpt_dir)
        self._log("recover", cell=name, seconds=time.monotonic() - t0)
        return cell

    def restore_from_ckpt(self, cell: Cell, ckpt_dir: str) -> bool:
        """Restore a cell's state from its latest checkpoint, by role.

        Train cells restore a full TrainState (params, AdamW moments; no
        error-feedback buffers, as JAX's target has none); serve cells
        checkpoint bare params (``snapshot_state``), so restoring those
        as a TrainState would raise on the leaf-count mismatch.  The
        leaves land on the cell's device; over a mesh each is read to the
        host and laid out over it as it is read (a TrainState by
        ``train_state_pspecs``, bare params by the model's rules), so no
        position ever holds a whole state.  Returns True when a checkpoint
        was restored; when none exists the cell comes back empty and
        ``recover_no_ckpt`` is logged so a misconfigured ``ckpt_dir`` is
        visible, not silent."""
        from repro_torch.checkpoint import checkpoint as ckpt
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            self._log("recover_no_ckpt", cell=cell.name, ckpt_dir=ckpt_dir)
            return False
        params = cell.model.abstract_params()
        train = cell.role == "train"
        target = (TrainState(params=params,
                             opt=init_adam_state(params, cell.opt_cfg))
                  if train else params)
        if cell.ctx is None:
            out = ckpt.restore(ckpt_dir, step, target, cell.device)
        else:
            pspecs = (train_state_pspecs(cell.model) if train
                      else cell.model.params_pspecs())
            out = ckpt.restore(ckpt_dir, step, target, cell.ctx.mesh, pspecs)
        if train:
            cell.state = out
        else:
            cell.serve_params = out
        cell.step = step
        cell.status = "running"
        self._log("restore_ckpt", cell=cell.name, ckpt_dir=ckpt_dir, step=step)
        return True

    def mitigate_straggler(self, name: str, slow_col: int) -> dict:
        """Straggler policy: shrink the cell off a slow column and re-grow
        elsewhere (resize-away)."""
        cell = self.cells[name]
        pod = cell.zone.pods[0]
        affected = self.fail_column(pod, slow_col)  # quarantine slow column
        if name in affected:
            return {"action": "recovered", "cell": self.recover_cell(name).name}
        return {"action": "none"}

    def add_drain_hook(self, fn):
        """Register a drain-before-destroy hook (``fn(cell_name)``), run
        by the reconciler right before ``destroy_cell`` executes."""
        self.drain_hooks.append(fn)

    # ------------------------------------------------------------------
    # channels (on-demand sharing)
    # ------------------------------------------------------------------
    def open_channel(self, src: str, dst: str, kind: str = "array") -> ArrayChannel:
        """Open an on-demand data channel between two cells.

        ``kind`` is a label for the event log / introspection: "array" for
        generic tensor-tree transfer (weight sync), "kv" for the
        disaggregated prefill->decode KV handoff (``serve/disagg.py``),
        "pages" for replica-to-replica KV page migration
        (``serve/cacheplane.py``).
        """
        ch = ArrayChannel(self.cells[src], self.cells[dst], kind=kind)
        self.channels.append(ch)
        self._log("open_channel", src=src, dst=dst, cid=ch.cid, kind=kind)
        return ch

    def find_channel(self, src: str, dst: str, kind: str = "array"
                     ) -> Optional[ArrayChannel]:
        """First still-open channel matching (src, dst, kind), else None."""
        for ch in self.channels:
            if (ch.open and ch.kind == kind
                    and ch.src.name == src and ch.dst.name == dst):
                return ch
        return None

    # ------------------------------------------------------------------
    def lineage(self, name: str) -> List[str]:
        """Fork ancestry of a cell: [name, parent, grandparent, ...]."""
        out = [name]
        cell = self.cells[name]
        while cell is not None and cell.parent is not None:
            out.append(cell.parent)
            cell = self.cells.get(cell.parent)
        return out

    def validate_cell_programs(self, name: str) -> int:
        """Run the BoundaryGuard over a cell's programs.

        Every program (the serve weights, each batcher's state, each
        captured step graph with its static inputs) is checked for device
        confinement, and each graph for epoch freshness.  Returns the
        number validated.
        """
        cell = self.cells[name]
        checked = 0
        for prog in cell.programs():
            self.guard.validate(cell, prog)
            checked += 1
        self.guard.validate_epoch(name, cell.bound_epoch)
        return checked
