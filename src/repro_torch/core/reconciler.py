"""Reconciler — diffs desired state (ClusterSpec) against observed cells.

``Supervisor.apply(spec)`` / ``Supervisor.reconcile()`` run through here:
the reconciler reads the supervisor's observed world (cells, their zones
and health) and the desired :class:`~repro_torch.core.spec.ClusterSpec`, and
emits an ordered :class:`Plan` of primitive ops

    destroy -> shrink -> transfer -> grow -> create -> recover -> open_channel

executed via the supervisor's existing primitives (``destroy_cell``,
``resize_cell``, ``transfer_columns``, ``create_cell``, ``recover_cell``,
``open_channel``) — those verbs are now the *plan-executor layer*, no
caller outside ``core/`` sequences them by hand.

Convergence properties:

* **Idempotent**: once observed == desired, ``plan()`` is empty.
* **Degrading**: grows/creates that cannot be satisfied (no free
  columns) land as many columns as fit and stay in the plan — the cell
  re-expands on a later reconcile when columns free up (e.g. after
  ``Supervisor.restore_column`` lifts a quarantine).
* **Pairing**: a shrink on one cell and a grow on another become one
  ``transfer`` (the paper's CPU-handoff path, live reshard both sides).

The reconciler only needs a duck-typed supervisor (``cells`` mapping +
the primitive verbs), so pure-bookkeeping supervisors (the Table-5
simulation, unit tests) reuse the exact planning/execution logic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.partition import PartitionError
from repro_torch.core.spec import CellSpec, ClusterSpec

VERB_ORDER = ("destroy", "shrink", "transfer", "grow", "create", "recover",
              "open_channel")


@dataclasses.dataclass
class PlanOp:
    """One primitive step of a plan."""

    verb: str                          # one of VERB_ORDER
    cell: Optional[str] = None         # target (dst for transfer)
    args: dict = dataclasses.field(default_factory=dict)
    status: str = "pending"            # pending | ok | degraded | blocked
    result: Optional[dict] = None

    def __repr__(self):
        extra = f" {self.args}" if self.args else ""
        return f"<{self.verb} {self.cell or ''}{extra} [{self.status}]>"


@dataclasses.dataclass
class Plan:
    """Ordered op list + per-op execution results."""

    ops: List[PlanOp] = dataclasses.field(default_factory=list)
    epoch: Optional[int] = None        # table epoch the plan was computed at

    @property
    def empty(self) -> bool:
        return not self.ops

    def by_verb(self, verb: str) -> List[PlanOp]:
        return [op for op in self.ops if op.verb == verb]

    def summary(self) -> str:
        counts: Dict[str, int] = {}
        for op in self.ops:
            counts[op.verb] = counts.get(op.verb, 0) + 1
        return " ".join(f"{v}:{counts[v]}" for v in VERB_ORDER if v in counts) or "noop"


class Reconciler:
    """Plans and executes the desired-vs-observed diff for a supervisor."""

    def __init__(self, supervisor):
        self.sup = supervisor

    # ------------------------------------------------------------------
    # planning (pure: reads observed state, emits ops, mutates nothing)
    # ------------------------------------------------------------------
    def plan(self, spec: Optional[ClusterSpec]) -> Plan:
        table = getattr(self.sup, "table", None)
        out = Plan(epoch=getattr(table, "epoch", None))
        if spec is None:
            return out
        desired = spec.instance_specs()
        observed = dict(self.sup.cells)

        # cells the spec no longer names — and existing cells whose
        # arch/role changed, which must be recreated
        recreate = set()
        for name, cell in observed.items():
            if name not in desired:
                out.ops.append(PlanOp("destroy", name))
            elif (getattr(cell, "role", None) != desired[name].role
                  or getattr(cell, "arch", None) is not desired[name].arch
                  and getattr(cell, "arch", None) != desired[name].arch):
                out.ops.append(PlanOp("destroy", name))
                recreate.add(name)

        # column deltas for healthy cells that stay
        deltas: Dict[str, int] = {}
        for name, cs in desired.items():
            cell = observed.get(name)
            if cell is None or name in recreate:
                continue
            if getattr(cell, "status", "running") == "failed":
                continue                           # handled by recover below
            deltas[name] = cs.ncols - cell.zone.ncols

        donors = [[n, -d] for n, d in deltas.items() if d < 0]
        takers = [[n, d] for n, d in deltas.items() if d > 0]
        shrinks, transfers, grows = [], [], []
        transferred: Dict[str, int] = {}     # donor -> cols leaving by transfer
        for taker in takers:
            for donor in donors:
                if taker[1] == 0:
                    break
                n = min(donor[1], taker[1])
                if n > 0:
                    transfers.append(PlanOp(
                        "transfer", taker[0],
                        {"src": donor[0], "dst": taker[0], "ncols": n},
                    ))
                    donor[1] -= n
                    taker[1] -= n
                    transferred[donor[0]] = transferred.get(donor[0], 0) + n
            if taker[1] > 0:
                grows.append(PlanOp(
                    "grow", taker[0], {"ncols": desired[taker[0]].ncols}))
        for donor in donors:
            if donor[1] > 0:
                # shrink only the residual: transfers execute AFTER this op
                # and take the remaining surplus, landing the donor exactly
                # on its desired width
                target = desired[donor[0]].ncols + transferred.get(donor[0], 0)
                shrinks.append(PlanOp("shrink", donor[0], {"ncols": target}))
        out.ops.extend(shrinks)
        out.ops.extend(transfers)
        out.ops.extend(grows)

        # new cells / failed cells to re-carve; recover threads the spec's
        # ckpt_dir through so the cell comes back with state, not just a zone
        for name, cs in desired.items():
            cell = observed.get(name)
            if cell is None or name in recreate:
                out.ops.append(PlanOp("create", name, {"ncols": cs.ncols}))
            elif getattr(cell, "status", "running") == "failed":
                out.ops.append(PlanOp(
                    "recover", name,
                    {"ncols": cs.ncols, "ckpt_dir": cs.ckpt_dir}))

        # declared channels not yet open — or whose endpoint is being
        # recreated this plan (destroy closes its channels mid-execution,
        # so an open channel observed NOW will be gone by then)
        find = getattr(self.sup, "find_channel", None)
        if find is not None:
            refreshed = {op.cell for op in out.ops
                         if op.verb in ("create", "recover")}
            live = {name for name in desired if name in observed} | refreshed
            for src, dst, kind in spec.instance_channels():
                if src not in live or dst not in live:
                    continue
                if (src in refreshed or dst in refreshed
                        or find(src, dst, kind) is None):
                    out.ops.append(PlanOp(
                        "open_channel", dst, {"src": src, "dst": dst, "kind": kind}))
        return out

    # ------------------------------------------------------------------
    # execution (runs the primitives; degrades instead of failing)
    # ------------------------------------------------------------------
    def execute(self, plan: Plan, spec: Optional[ClusterSpec]) -> Plan:
        desired = spec.instance_specs() if spec is not None else {}
        for op in plan.ops:
            try:
                if op.verb == "destroy":
                    # drain-before-destroy: the serving plane may hand the
                    # doomed cell's state to survivors while its channels
                    # are still open (live subOS resize — cacheplane)
                    for hook in getattr(self.sup, "drain_hooks", ()):
                        hook(op.cell)
                    op.result = self.sup.destroy_cell(op.cell) or {}
                    op.status = "ok"
                elif op.verb == "shrink":
                    op.result = self.sup.resize_cell(op.cell, op.args["ncols"])
                    op.status = "ok"
                elif op.verb == "transfer":
                    op.result = self.sup.transfer_columns(
                        op.args["src"], op.args["dst"], op.args["ncols"])
                    op.status = "ok"
                elif op.verb == "grow":
                    op.status, op.result = self._grow(op.cell, op.args["ncols"])
                elif op.verb == "create":
                    op.status, op.result = self._create(desired[op.cell], op.cell)
                elif op.verb == "recover":
                    cell = self.sup.recover_cell(
                        op.cell, ncols=op.args["ncols"],
                        ckpt_dir=op.args.get("ckpt_dir"))
                    op.status = ("ok" if cell.zone.ncols >= op.args["ncols"]
                                 else "degraded")
                    op.result = {"ncols": cell.zone.ncols}
                elif op.verb == "open_channel":
                    src, dst = op.args["src"], op.args["dst"]
                    if src not in self.sup.cells or dst not in self.sup.cells:
                        # an endpoint's create was blocked earlier in this
                        # plan; retry on a later reconcile
                        op.status = "blocked"
                        op.result = {"error": f"endpoint missing: "
                                     f"{src if src not in self.sup.cells else dst}"}
                    else:
                        ch = self.sup.open_channel(src, dst, kind=op.args["kind"])
                        op.status = "ok"
                        op.result = {"cid": ch.cid}
            except PartitionError as e:
                op.status = "blocked"
                op.result = {"error": str(e)}
        return plan

    def _grow(self, name: str, want: int):
        have = self.sup.cells[name].zone.ncols
        for n in range(want, have, -1):
            try:
                stats = self.sup.resize_cell(name, n)
                return ("ok" if n == want else "degraded"), stats
            except PartitionError:
                continue
        return "blocked", {"ncols": have}

    def _create(self, cs: CellSpec, instance: str):
        # degrade below min_ncols rather than not exist at all (mirrors
        # recover_cell); later reconciles grow the cell back to spec
        for n in range(cs.ncols, 0, -1):
            try:
                cell = self.sup.create_cell(
                    instance, cs.arch, cs.role, ncols=n, pods=cs.pods,
                    opt_cfg=cs.opt_cfg,
                )
                # boot from checkpoint when the spec declares one: a failed
                # cell whose recover could not re-carve degrades to a
                # create on a later reconcile, and must still come back
                # with its state
                restore = getattr(self.sup, "restore_from_ckpt", None)
                if cs.ckpt_dir is not None and restore is not None:
                    restore(cell, cs.ckpt_dir)
                return ("ok" if n == cs.ncols else "degraded"), \
                    {"ncols": cell.zone.ncols}
            except PartitionError:
                continue
        return "blocked", {}

    # ------------------------------------------------------------------
    def reconcile(self, spec: Optional[ClusterSpec]) -> Plan:
        return self.execute(self.plan(spec), spec)
