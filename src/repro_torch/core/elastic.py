"""SLO-driven continuous elasticity — paper Fig 10/11, declaratively.

The paper bounds a latency-critical workload's tail latency with two
thresholds: if the tail over the last window exceeds ``ut``, a CPU moves
from the batch OS instance to the serving instance; if it falls below
``lt``, one moves back.  Here the policy never touches a transfer
primitive — it rewrites *desired state* and reconciles — and it scales
TWO axes of a :class:`~repro_torch.core.spec.CellSpec`:

* **columns** (``ncols``): :class:`ReconcilePolicy` pulls live
  per-request TTFT/TPOT samples out of the server cell's
  :class:`~repro_torch.core.accounting.CellAccounting`, and when the tail
  crosses a threshold it moves one desired column between the server
  and a donor spec (within their ``[min_ncols, max_ncols]`` bounds);
  the reconciler turns the +1/-1 into a single column ``transfer`` with
  live resharding on both cells.
* **replicas** (``replicas``): with a ``replica_policy`` configured,
  queue depth plus the TPOT tail drive the desired replica count of the
  server spec within ``[min_replicas, max_replicas]`` — reconcile then
  creates/destroys uniform decode instances and an attached server's
  ``sync`` live-attaches/detaches them (``serve/disagg.py``).

Threshold bands need not be hand-picked: :meth:`ElasticPolicy.from_slo`
derives ``(lt, ut)`` from the spec's declared
:class:`~repro_torch.core.spec.SLOTarget` — ``ut`` is the target itself and
``lt = hysteresis * ut``, so the policy grows while out of SLO and only
shrinks once comfortably inside it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

VALID_METRICS = ("ttft", "tpot")


@dataclasses.dataclass
class ElasticPolicy:
    """Threshold band + windowing for a :class:`ReconcilePolicy` axis.

    Column/replica bounds live on the :class:`~repro_torch.core.spec.CellSpec`
    (``min_ncols``/``max_ncols``, ``min_replicas``/``max_replicas``),
    not here — the policy can only move the desired state inside what
    the spec allows.
    """

    lt: float                    # lower tail-latency threshold (seconds)
    ut: float                    # upper threshold
    window: int = 50             # samples in the sliding window
    percentile: float = 99.0
    cooldown: float = 0.0        # min seconds between actions
    metric: str = "ttft"         # "ttft" | "tpot" (CellAccounting fields)

    def __post_init__(self):
        if self.metric not in VALID_METRICS:
            raise ValueError(
                f"metric {self.metric!r} is not one of {VALID_METRICS} — "
                "a typo here would make pull() ingest nothing and silently "
                "disable elasticity"
            )
        if self.lt > self.ut:
            raise ValueError(f"lt={self.lt} > ut={self.ut}: the band is empty")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")

    @classmethod
    def from_slo(cls, slo, *, metric: str = "ttft", hysteresis: float = 0.5,
                 **kw) -> "ElasticPolicy":
        """Derive the threshold band from a declared SLO target.

        ``ut`` is the spec's ``{metric}_p99`` (the latency objective
        itself: above it the cell is out of SLO and must grow) and
        ``lt = hysteresis * ut`` (only shrink once the tail sits
        comfortably inside the objective — the hysteresis gap prevents
        grow/shrink oscillation around a single threshold).
        """
        target = getattr(slo, f"{metric}_p99", None) if slo is not None else None
        if target is None:
            raise ValueError(
                f"SLOTarget declares no {metric}_p99 to derive a band from")
        if not 0.0 < hysteresis < 1.0:
            raise ValueError(f"hysteresis must be in (0, 1), got {hysteresis}")
        return cls(lt=hysteresis * target, ut=target, metric=metric, **kw)


class ReconcilePolicy:
    """Continuous elasticity: accounting -> spec ``ncols``/``replicas``
    -> reconcile.

    Reads new request samples from the server spec's cell(s) — all
    replica instances feed one window — and on a threshold crossing
    rewrites the desired spec, then ``Supervisor.apply``s it.  Zero
    direct primitive calls; the reconciler owns execution.

    Axes (either or both):

    * ``donor`` + ``policy``: move one desired *column* between the
      ``server`` and ``donor`` specs on a tail-latency crossing.
    * ``replica_policy`` (+ optional ``queue_depth`` callable, e.g.
      ``lambda: len(disagg_server.pending)``): grow the server spec's
      desired *replicas* when the queue backs up past ``queue_high`` or
      the TPOT tail exceeds the band; shrink when the queue is empty
      and the tail is comfortably low.
    """

    def __init__(self, supervisor, server: str, donor: Optional[str] = None,
                 policy: Optional[ElasticPolicy] = None, *,
                 replica_policy: Optional[ElasticPolicy] = None,
                 queue_depth: Optional[Callable[[], int]] = None,
                 queue_high: int = 4,
                 pool_occupancy: Optional[Callable[[], float]] = None,
                 occupancy_high: float = 0.9,
                 tenant: Optional[str] = None):
        if policy is None and replica_policy is None:
            raise ValueError("need at least one of policy / replica_policy")
        if policy is not None and donor is None:
            raise ValueError("the column axis needs a donor spec to fund it")
        if not 0.0 < occupancy_high <= 1.0:
            raise ValueError(
                f"occupancy_high must be in (0, 1], got {occupancy_high}")
        self.sup = supervisor
        self.server = server
        self.donor = donor
        self.policy = policy
        self.replica_policy = replica_policy
        self.queue_depth = queue_depth
        self.queue_high = queue_high
        # third replica-scaling signal: committed KV-pool pressure (e.g.
        # ``DisaggServer.pool_occupancy``) — latency tails lag a memory
        # squeeze, but a near-full pool blocks admissions RIGHT NOW
        self.pool_occupancy = pool_occupancy
        self.occupancy_high = occupancy_high
        # tenant-scoped elasticity: only that tenant's request samples
        # feed the window, so the cell grows for the tenant whose SLO is
        # actually violated — a noisy co-tenant's good latency can't mask
        # a victim's bad tail (and vice versa).  None = all traffic.
        self.tenant = tenant
        window = policy.window if policy is not None else replica_policy.window
        self.samples: Deque[float] = deque(maxlen=window)
        self.replica_samples: Deque[float] = deque(
            maxlen=replica_policy.window if replica_policy is not None else 1)
        self.last_action_ts = -1e9
        self.actions: List[dict] = []
        # per-instance cursor: (accounting identity, read offset)
        self._cursors: Dict[str, Tuple[int, int]] = {}

    # ------------------------------------------------------------------
    def _server_instances(self) -> List[str]:
        spec = getattr(self.sup, "desired", None)
        if spec is not None and spec.has_cell(self.server):
            return spec.cell(self.server).instances()
        return [self.server]

    def pull(self) -> int:
        """Ingest new TTFT/TPOT samples from the server cells' accounting."""
        n = 0
        for inst in self._server_instances():
            cell = self.sup.cells.get(inst)
            if cell is None:
                continue
            reqs = cell.accounting.requests
            # cursors are keyed on the accounting log's identity, not just
            # its length: a recovered cell restarts with a FRESH log that
            # may already have grown past the old cursor — a length check
            # alone would silently skip those samples forever.  uid is a
            # never-reused counter (id() can be recycled after GC).
            ident = getattr(cell.accounting, "uid", id(cell.accounting))
            prev_ident, start = self._cursors.get(inst, (ident, 0))
            if prev_ident != ident or len(reqs) < start:
                start = 0
            for r in reqs[start:]:
                if (self.tenant is not None
                        and getattr(r, "tenant", None) != self.tenant):
                    continue
                if self.policy is not None:
                    v = getattr(r, self.policy.metric, None)
                    if v is not None:
                        self.samples.append(float(v))
                        n += 1
                if self.replica_policy is not None and r.tpot is not None:
                    self.replica_samples.append(float(r.tpot))
                    if self.policy is None:
                        n += 1
            self._cursors[inst] = (ident, len(reqs))
        return n

    def observe(self, latency: float):
        """Directly feed one sample (simulation / external metric path)."""
        self.samples.append(latency)

    def _tail_of(self, samples: Deque[float], policy: ElasticPolicy
                 ) -> Optional[float]:
        if len(samples) < max(5, policy.window // 5):
            return None
        return float(np.percentile(np.asarray(samples), policy.percentile))

    def tail(self) -> Optional[float]:
        if self.policy is None:
            return None
        return self._tail_of(self.samples, self.policy)

    def replica_tail(self) -> Optional[float]:
        if self.replica_policy is None:
            return None
        return self._tail_of(self.replica_samples, self.replica_policy)

    # ------------------------------------------------------------------
    def _rescale(self, delta: int):
        """Move ``delta`` desired columns per server replica, donor-funded.

        Total columns are conserved: a server spec with R replicas takes
        ``delta * R`` columns in aggregate, so the donor spec absorbs
        exactly that many (scaled by its own replica count).  Returns the
        executed plan, or None when either side is pinned at a bound or
        the exchange cannot balance — desired state never changes unless
        the whole swap fits."""
        spec = self.sup.desired
        if spec is None or not (spec.has_cell(self.server)
                                and spec.has_cell(self.donor)):
            return None                   # a later apply() dropped a cell
        r_server = spec.cell(self.server).replicas
        r_donor = spec.cell(self.donor).replicas
        spec2, applied = spec.scale_by(self.server, delta)
        if applied == 0:
            return None
        need = -applied * r_server        # aggregate columns the donor funds
        if need % r_donor != 0:
            return None
        spec3, compensated = spec2.scale_by(self.donor, need // r_donor)
        if compensated != need // r_donor:
            return None
        plan = self.sup.apply(spec3)
        if plan.ops and all(op.status == "blocked" for op in plan.ops):
            # nothing could move (e.g. no adjacent free columns): roll the
            # desired state back so the miss is neither logged as an action
            # nor arms the cooldown; observed state is unchanged
            self.sup.desired = spec
            return None
        return plan

    def _rescale_replicas(self, delta: int):
        """Adjust the server spec's desired replica count within bounds."""
        spec = self.sup.desired
        if spec is None or not spec.has_cell(self.server):
            return None
        spec2, applied = spec.scale_replicas_by(self.server, delta)
        if applied == 0:
            return None
        old = set(spec.cell(self.server).instances())
        new = set(spec2.cell(self.server).instances())
        if not (old <= new or new <= old):
            # an UNBOUNDED spec crossing the instance-naming boundary
            # ("name" <-> "name/i") would make the reconciler destroy
            # every live replica and start cold — a full teardown (and a
            # zero-capacity window) is never worth a nominal +-1 step.
            # Replica-bounded specs use indexed names throughout (see
            # CellSpec.instances) and never hit this; crossing the
            # boundary stays an explicit apply().
            return None
        plan = self.sup.apply(spec2)
        if plan.ops and all(op.status == "blocked" for op in plan.ops):
            self.sup.desired = spec
            return None
        return plan

    # ------------------------------------------------------------------
    def _ncols(self) -> Optional[int]:
        spec = self.sup.desired
        if spec is not None and spec.has_cell(self.server):
            return spec.cell(self.server).ncols
        return None

    def _nreplicas(self) -> Optional[int]:
        spec = self.sup.desired
        if spec is not None and spec.has_cell(self.server):
            return spec.cell(self.server).replicas
        return None

    def _maybe_scale_cols(self, now: float) -> Optional[dict]:
        if self.policy is None:
            return None
        if now - self.last_action_ts < self.policy.cooldown:
            return None
        p = self.tail()
        if p is None:
            return None
        pct = self.policy.percentile
        metric = self.policy.metric
        if p > self.policy.ut:
            old = self._ncols()
            plan = self._rescale(+1)
            if plan is not None:
                self.samples.clear()   # fresh window after topology change
                return {"kind": "grow_server", "p_tail": p,
                        "cell": self.server,
                        "reason": (f"grow {self.server} cols "
                                   f"{old}->{self._ncols()}: "
                                   f"{metric}_p{pct:g} {p:.4f} > "
                                   f"ut {self.policy.ut:.4f}"),
                        "plan": plan.summary()}
        elif p < self.policy.lt:
            old = self._ncols()
            plan = self._rescale(-1)
            if plan is not None:
                self.samples.clear()
                return {"kind": "shrink_server", "p_tail": p,
                        "cell": self.server,
                        "reason": (f"shrink {self.server} cols "
                                   f"{old}->{self._ncols()}: "
                                   f"{metric}_p{pct:g} {p:.4f} < "
                                   f"lt {self.policy.lt:.4f}"),
                        "plan": plan.summary()}
        return None

    def _maybe_scale_replicas(self, now: float) -> Optional[dict]:
        rp = self.replica_policy
        if rp is None:
            return None
        if now - self.last_action_ts < rp.cooldown:
            return None
        qd = int(self.queue_depth()) if self.queue_depth is not None else 0
        occ = (float(self.pool_occupancy())
               if self.pool_occupancy is not None else None)
        tail = self.replica_tail()
        # grow on queue pressure alone (no decode samples flow while every
        # replica is saturated or gone), an out-of-band TPOT tail, OR a
        # near-exhausted KV pool (admissions are about to block)
        if (qd > self.queue_high
                or (tail is not None and tail > rp.ut)
                or (occ is not None and occ > self.occupancy_high)):
            # which signal(s) actually tripped — the audit's "why"
            why = []
            if qd > self.queue_high:
                why.append(f"queue_depth {qd} > {self.queue_high}")
            if tail is not None and tail > rp.ut:
                why.append(f"tpot_p{rp.percentile:g} {tail:.4f} > "
                           f"ut {rp.ut:.4f}")
            if occ is not None and occ > self.occupancy_high:
                why.append(f"pool_occupancy {occ:.2f} > "
                           f"{self.occupancy_high:.2f}")
            old = self._nreplicas()
            plan = self._rescale_replicas(+1)
            if plan is not None:
                self.replica_samples.clear()
                return {"kind": "grow_replicas", "p_tail": tail,
                        "queue_depth": qd, "pool_occupancy": occ,
                        "cell": self.server,
                        "reason": (f"scale replicas {old}->"
                                   f"{self._nreplicas()}: "
                                   + " | ".join(why)),
                        "plan": plan.summary()}
        elif (qd == 0 and tail is not None and tail < rp.lt
                and (occ is None or occ < self.occupancy_high / 2)):
            # never shrink into a memory squeeze: the surviving replicas
            # would inherit the victim's requeued requests' pages
            old = self._nreplicas()
            plan = self._rescale_replicas(-1)
            if plan is not None:
                self.replica_samples.clear()
                return {"kind": "shrink_replicas", "p_tail": tail,
                        "queue_depth": qd, "pool_occupancy": occ,
                        "cell": self.server,
                        "reason": (f"scale replicas {old}->"
                                   f"{self._nreplicas()}: queue empty, "
                                   f"tpot_p{rp.percentile:g} {tail:.4f} < "
                                   f"lt {rp.lt:.4f}"),
                        "plan": plan.summary()}
        return None

    def maybe_act(self, now: Optional[float] = None) -> Optional[dict]:
        now = time.monotonic() if now is None else now
        self.pull()
        action = self._maybe_scale_cols(now)
        if action is None:
            action = self._maybe_scale_replicas(now)
        if action:
            action["ts"] = now
            if self.tenant is not None:
                action["tenant"] = self.tenant
            self.last_action_ts = now
            self.actions.append(action)
        return action
