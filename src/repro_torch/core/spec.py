"""Declarative desired state: CellSpec / ClusterSpec.

The paper's supervisor "can create, destroy, resize a subOS on-the-fly";
the declarative layer turns those verbs into *state*: an application
writes down the cells it wants (arch, role, column bounds, replicas, SLO
targets) and the reconciler (``repro_torch.core.reconciler``) continuously
diffs that desired state against the observed cluster and executes the
primitive ops that close the gap.  Nothing here touches devices — specs
are plain immutable data, cheap to copy and diff.

Conventions:

* A :class:`CellSpec` with ``replicas == N > 1`` materializes as N
  cells named ``"{name}/0" .. "{name}/N-1"`` — uniform instances that
  share arch/role/bounds (the Nanvix-style "density from uniform
  lifecycle" pattern); ``DisaggServer`` routes requests across them.
  Replica-BOUNDED specs (``max_replicas >= 2``) keep the indexed names
  even at ``replicas == 1``, so autoscaling only ever adds/removes
  instances and never renames the survivors; only an unbounded
  single-replica spec materializes as the bare ``spec.name``.
* ``ncols`` is the *desired* column count; ``min_ncols``/``max_ncols``
  bound what any policy may request and what a degraded cell may shrink
  to.  Policies never call resize primitives — they rewrite ``ncols``
  (see :class:`~repro_torch.core.elastic.ReconcilePolicy`) and reconcile.
  ``replicas`` is bounded the same way by ``min_replicas``/
  ``max_replicas`` — the second elastic axis.
* ``ckpt_dir`` names where the cell's state checkpoints live.  It is
  *recovery metadata*: the reconciler threads it into the ``recover``
  op, so a re-carved cell comes back with its latest checkpointed state
  (train state for ``role="train"``, params for ``role="serve"``) —
  not just an empty zone.  Whoever runs the cell is still responsible
  for writing checkpoints there; the spec only says where to look on
  recovery.
* A :class:`ChannelSpec` between replicated specs expands to the cross
  product of instances (one prefill cell fanning out to N decode cells
  declares a single channel spec).

Tenancy — the subOS model one level up the stack: a serving
:class:`CellSpec` may carry :class:`TenantSpec`\\ s, and each tenant is
to the cell what a subOS is to the machine.  *Isolate first*: a tenant's
``page_quota`` is a physical-resource partition of the cell's KV pool (a
pocket it can exhaust without ever touching another tenant's pages), its
``rate``/``burst`` token bucket bounds the work it may inject, and its
``weight`` sets its deficit-round-robin share of decode slots.  *Then
share*: the only cross-tenant surface is the pool's **public prefix
namespace** (e.g. a common system prompt) — a read-only, explicitly
granted mapping (``share_public``), the exact analogue of the paper's
supervisor-mediated inter-subOS memory grant.  Per-tenant ``slo``
targets feed :class:`~repro_torch.core.elastic.ReconcilePolicy` so autoscale
defends the tenant that is out of SLO, not the aggregate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.train.optimizer import OptConfig


class SpecError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Latency objectives a serving cell should hold (seconds).

    ``ttft_p99``/``tpot_p99`` are upper bounds on the tail over the
    policy window; a reconcile policy grows the cell while the tail is
    above target and shrinks it when comfortably below (hysteresis is
    the policy's, not the target's).
    """

    ttft_p99: Optional[float] = None
    tpot_p99: Optional[float] = None


#: reserved pocket/namespace names (see ``repro_torch.serve.tenancy``)
RESERVED_TENANTS = ("__public__", "__shared__")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Per-tenant QoS contract carried on a serving :class:`CellSpec`.

    * ``weight`` — deficit-round-robin share of decode slots / prefill
      batches (relative to the other tenants on the cell).
    * ``page_quota`` — fraction of the cell's KV pool reserved as this
      tenant's private pocket; the tenant can exhaust its pocket but
      never the pool.  ``None`` = the tenant draws from the shared
      leftover commons.
    * ``rate``/``burst`` — token-bucket admission: at most ``burst``
      tokens of queued work admitted instantly, refilling at ``rate``
      tokens/second (a token ≈ one prompt or output position).
      ``rate=None`` = unthrottled.
    * ``slo`` — this tenant's own latency objective; feeds per-tenant
      :class:`~repro_torch.core.elastic.ReconcilePolicy` windows.
    * ``share_public`` — the supervisor grant: may this tenant map the
      pool's public prefix namespace read-only?
    """

    name: str
    weight: float = 1.0
    page_quota: Optional[float] = None
    rate: Optional[float] = None
    burst: Optional[float] = None
    slo: Optional[SLOTarget] = None
    share_public: bool = True

    def __post_init__(self):
        if not self.name or "/" in self.name:
            raise SpecError(f"bad tenant name {self.name!r}")
        if self.name in RESERVED_TENANTS:
            raise SpecError(f"tenant name {self.name!r} is reserved")
        if not self.weight > 0:
            raise SpecError(f"tenant {self.name}: weight must be > 0")
        if self.page_quota is not None and not 0.0 < self.page_quota <= 1.0:
            raise SpecError(
                f"tenant {self.name}: page_quota must be in (0, 1]")
        if self.rate is not None and not self.rate > 0:
            raise SpecError(f"tenant {self.name}: rate must be > 0")
        if self.burst is not None and not self.burst > 0:
            raise SpecError(f"tenant {self.name}: burst must be > 0")
        if self.burst is not None and self.rate is None:
            raise SpecError(
                f"tenant {self.name}: burst without rate builds no bucket "
                "— declare the rate it caps, or drop it")


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Desired state of one (possibly replicated) cell."""

    name: str
    arch: Any                          # ArchConfig (opaque to the spec layer)
    role: str                          # "train" | "serve"
    ncols: int = 1
    min_ncols: int = 1
    max_ncols: Optional[int] = None
    pods: Tuple[int, ...] = (0,)
    replicas: int = 1
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    opt_cfg: Optional[OptConfig] = None
    slo: Optional[SLOTarget] = None
    ckpt_dir: Optional[str] = None
    tenants: Tuple[TenantSpec, ...] = ()

    def __post_init__(self):
        if self.tenants:
            if self.role != "serve":
                raise SpecError(
                    f"{self.name}: tenants only apply to serve cells")
            names = [t.name for t in self.tenants]
            if len(names) != len(set(names)):
                raise SpecError(f"{self.name}: duplicate tenants {names}")
            reserved = sum(t.page_quota or 0.0 for t in self.tenants)
            if reserved > 1.0 + 1e-9:
                raise SpecError(
                    f"{self.name}: tenant page quotas sum to {reserved:.3f} "
                    "> 1.0 — pockets may never oversubscribe the pool")
        if "/" in self.name:
            raise SpecError(f"cell name {self.name!r} may not contain '/' "
                            "(reserved for replica instances)")
        if self.min_replicas < 1:
            raise SpecError(f"{self.name}: min_replicas must be >= 1")
        if self.max_replicas is not None and self.max_replicas < self.min_replicas:
            raise SpecError(f"{self.name}: max_replicas < min_replicas")
        if not (self.min_replicas <= self.replicas
                <= (self.max_replicas if self.max_replicas is not None
                    else self.replicas)):
            raise SpecError(
                f"{self.name}: replicas={self.replicas} outside "
                f"[{self.min_replicas}, {self.max_replicas}]"
            )
        if self.min_ncols < 1:
            raise SpecError(f"{self.name}: min_ncols must be >= 1")
        if self.max_ncols is not None and self.max_ncols < self.min_ncols:
            raise SpecError(f"{self.name}: max_ncols < min_ncols")
        if not (self.min_ncols <= self.ncols
                <= (self.max_ncols if self.max_ncols is not None else self.ncols)):
            raise SpecError(
                f"{self.name}: ncols={self.ncols} outside "
                f"[{self.min_ncols}, {self.max_ncols}]"
            )

    # ------------------------------------------------------------------
    def clamp(self, ncols: int) -> int:
        hi = self.max_ncols if self.max_ncols is not None else ncols
        return max(self.min_ncols, min(ncols, hi))

    def with_ncols(self, ncols: int) -> "CellSpec":
        return dataclasses.replace(self, ncols=self.clamp(ncols))

    def clamp_replicas(self, replicas: int) -> int:
        hi = self.max_replicas if self.max_replicas is not None else replicas
        return max(self.min_replicas, min(replicas, hi))

    def with_replicas(self, replicas: int) -> "CellSpec":
        return dataclasses.replace(self, replicas=self.clamp_replicas(replicas))

    def instances(self) -> List[str]:
        """Concrete cell names this spec materializes as.

        Replica-BOUNDED specs (``max_replicas >= 2``) use indexed names
        even at ``replicas == 1``: scaling then only ever adds or
        removes ``name/i`` instances, never renames the survivors — a
        rename would force the reconciler to destroy every live replica
        for a nominal +-1 step.  Only unbounded single-replica specs
        keep the bare name."""
        if self.replicas == 1 and (self.max_replicas is None
                                   or self.max_replicas == 1):
            return [self.name]
        return [f"{self.name}/{i}" for i in range(self.replicas)]

    def tenant(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise SpecError(f"{self.name}: no tenant spec {name!r}")

    def has_tenant(self, name: str) -> bool:
        return any(t.name == name for t in self.tenants)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Desired on-demand channel between two cell specs (by spec name)."""

    src: str
    dst: str
    kind: str = "array"                # "array" | "kv" | "pages"


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The whole desired world: named cell specs + channels between them.

    ``Supervisor.apply(spec)`` adopts this as the desired state; every
    ``reconcile()`` afterwards converges the cluster toward it.  Cells
    not named here are destroyed by reconcile — the spec is total, not
    additive.
    """

    cells: Tuple[CellSpec, ...] = ()
    channels: Tuple[ChannelSpec, ...] = ()

    def __post_init__(self):
        names = [c.name for c in self.cells]
        if len(names) != len(set(names)):
            raise SpecError(f"duplicate cell specs: {names}")
        for ch in self.channels:
            for end in (ch.src, ch.dst):
                if end not in names:
                    raise SpecError(f"channel endpoint {end!r} names no cell spec")

    # ---- queries ----------------------------------------------------------
    def cell(self, name: str) -> CellSpec:
        for c in self.cells:
            if c.name == name:
                return c
        raise SpecError(f"no cell spec {name!r}")

    def has_cell(self, name: str) -> bool:
        return any(c.name == name for c in self.cells)

    def instance_specs(self) -> Dict[str, CellSpec]:
        """Expand replicas: concrete cell name -> its (shared) spec."""
        out: Dict[str, CellSpec] = {}
        for c in self.cells:
            for inst in c.instances():
                out[inst] = c
        return out

    def instance_channels(self) -> List[Tuple[str, str, str]]:
        """Expand channels over replica instances: (src, dst, kind).

        A self-referential spec (``src == dst``, e.g. a replicated decode
        cell's peer "pages" mesh) expands to every ORDERED pair of
        distinct instances — a channel from an instance to itself is
        meaningless and is skipped."""
        out = []
        for ch in self.channels:
            for s in self.cell(ch.src).instances():
                for d in self.cell(ch.dst).instances():
                    if s == d:
                        continue
                    out.append((s, d, ch.kind))
        return out

    # ---- functional updates ----------------------------------------------
    def with_cell(self, spec: CellSpec) -> "ClusterSpec":
        """Add or replace the spec with the same name."""
        rest = tuple(c for c in self.cells if c.name != spec.name)
        return dataclasses.replace(self, cells=rest + (spec,))

    def without_cell(self, name: str) -> "ClusterSpec":
        cells = tuple(c for c in self.cells if c.name != name)
        channels = tuple(ch for ch in self.channels
                         if ch.src != name and ch.dst != name)
        return dataclasses.replace(self, cells=cells, channels=channels)

    def with_channel(self, channel: ChannelSpec) -> "ClusterSpec":
        return dataclasses.replace(self, channels=self.channels + (channel,))

    def scale(self, name: str, ncols: int) -> "ClusterSpec":
        """Set a cell spec's desired ncols (clamped to its bounds)."""
        return self.with_cell(self.cell(name).with_ncols(ncols))

    def scale_by(self, name: str, delta: int) -> Tuple["ClusterSpec", int]:
        """Adjust desired ncols by ``delta`` within bounds.

        Returns ``(new_spec, applied_delta)`` — applied_delta is 0 when
        the spec is already pinned at the relevant bound.
        """
        c = self.cell(name)
        new = c.clamp(c.ncols + delta)
        if new == c.ncols:
            return self, 0
        return self.with_cell(dataclasses.replace(c, ncols=new)), new - c.ncols

    def scale_replicas_by(self, name: str, delta: int) -> Tuple["ClusterSpec", int]:
        """Adjust desired replica count by ``delta`` within
        ``[min_replicas, max_replicas]``; same contract as :meth:`scale_by`."""
        c = self.cell(name)
        new = c.clamp_replicas(c.replicas + delta)
        if new == c.replicas:
            return self, 0
        return (self.with_cell(dataclasses.replace(c, replicas=new)),
                new - c.replicas)
