"""Supervisor daemon — the closed control loop over the declarative plane.

The paper's supervisor "can create, destroy, resize a subOS on-the-fly";
the reconciler makes those verbs converge from declared state, but
convergence only happens when a caller remembers to tick ``reconcile()``
or ``maybe_act()`` by hand.  :class:`SupervisorDaemon` closes the loop: one
``tick()`` runs the whole management cycle, and ``start()`` runs it on a
timer, so the cluster self-heals and autoscales with ZERO manual
primitive calls — the application only ever declares specs.

Tick order (each stage feeds the next):

1. **health** — ``Supervisor.check_health()`` finds heartbeat-stale
   cells; the daemon marks them ``failed`` so the planner sees them.
2. **reconcile** — converge observed -> desired: failed cells are
   re-carved (``recover``), restoring state from the spec's ``ckpt_dir``
   when one is declared; degraded cells regrow; replica-count changes
   materialize as create/destroy.
3. **policies** — registered :class:`~repro_torch.core.elastic.ReconcilePolicy`
   instances pull live TTFT/TPOT accounting and may rewrite + re-apply
   the spec (columns and/or replicas).  Threshold bands come from the
   spec's declared :class:`~repro_torch.core.spec.SLOTarget` via
   :meth:`add_slo_policy` — the application states its latency
   objective, not scaling thresholds.  A policy-driven scale-down
   executes its ``destroy`` ops INSIDE this stage (apply -> reconcile),
   so drain-before-detach cannot wait for stage 4: the supervisor's
   ``drain_hooks`` fire from the reconciler's destroy branch while the
   doomed cell and its channels are still live, letting a migrating
   ``DisaggServer`` (``migrate=True``) hand the victim's hot KV pages
   and in-flight slots to survivors (``serve/cacheplane.py``).
4. **sync** — attached servers (a
   :class:`~repro_torch.serve.disagg.DisaggServer`, or anything with
   ``sync(spec, base)`` and ``_decode_base``) converge their live replica surface to the (possibly rescaled) spec:
   fresh decode instances attach, vanished ones detach with their
   requests requeued.

Ticks are re-entrant-free and cheap when converged (an empty plan plus a
few deque reads), so interleaving ``tick()`` with traffic — e.g.
``DisaggServer.run_until_drained(on_step=daemon.tick)`` — is the
recommended pattern for in-process serving loops.  The threaded
``start()/stop()`` mode suits bookkeeping supervisors and real
deployments where cells run out-of-process; do not combine it with a
same-process step loop on the card (two threads would race on device state).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.core.elastic import ElasticPolicy, ReconcilePolicy
from repro_torch.core.telemetry import DecisionAudit


class SupervisorDaemon:
    """Periodic health-check + reconcile + SLO autoscale + replica sync."""

    def __init__(self, supervisor, *, interval: float = 0.5,
                 history_limit: int = 10_000):
        self.sup = supervisor
        self.interval = interval
        self.policies: List[ReconcilePolicy] = []
        self.servers: List[Tuple[object, Optional[str]]] = []
        self.ticks = 0
        # bounded: a long-running threaded daemon must not leak one
        # record per tick forever
        self.history: Deque[dict] = deque(maxlen=history_limit)
        self.errors: Deque[dict] = deque(maxlen=1_000)
        # the decision audit: every tick's observed SLO signals + every
        # action taken with its reason, queryable after the fact and
        # folded into DisaggServer.trace_export(daemon=...)
        self.audit = DecisionAudit()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration ---------------------------------------------------
    def add_policy(self, policy: ReconcilePolicy) -> ReconcilePolicy:
        """Register a hand-built policy (prefer :meth:`add_slo_policy`)."""
        self.policies.append(policy)
        return policy

    def add_slo_policy(self, server: str, donor: Optional[str] = None, *,
                       metric: str = "ttft", hysteresis: float = 0.5,
                       window: int = 50, percentile: float = 99.0,
                       cooldown: float = 0.0,
                       autoscale_replicas: bool = False,
                       queue_depth=None, queue_high: int = 4,
                       pool_occupancy=None, occupancy_high: float = 0.9,
                       tenant: Optional[str] = None
                       ) -> ReconcilePolicy:
        """Build a policy whose bands derive from the spec's SLOTarget.

        ``ut`` is the declared ``{metric}_p99`` target, ``lt`` is
        ``hysteresis * ut`` — nothing is hand-picked.  With ``donor``
        set, tail crossings move columns between ``server`` and
        ``donor``; with ``autoscale_replicas=True`` the ``tpot_p99``
        target (plus ``queue_depth``, e.g. ``lambda:
        len(disagg_server.pending)``, and optionally ``pool_occupancy``,
        e.g. ``disagg_server.pool_occupancy`` — KV-pool pressure) drives
        the server spec's desired replica count.

        With ``tenant`` set, the band derives from that tenant's own
        :class:`~repro_torch.core.spec.SLOTarget` (``TenantSpec.slo`` on the
        server cell, falling back to the cell-level SLO) and the window
        ingests ONLY that tenant's samples — the cell autoscales for
        the tenant whose objective is actually violated.
        """
        spec = getattr(self.sup, "desired", None)
        if spec is None or not spec.has_cell(server):
            raise ValueError(f"no applied spec declares cell {server!r}")
        slo = self._resolve_slo(spec, server, tenant)
        policy = None
        if donor is not None:
            policy = ElasticPolicy.from_slo(
                slo, metric=metric, hysteresis=hysteresis, window=window,
                percentile=percentile, cooldown=cooldown)
        replica_policy = None
        if autoscale_replicas:
            replica_policy = ElasticPolicy.from_slo(
                slo, metric="tpot", hysteresis=hysteresis, window=window,
                percentile=percentile, cooldown=cooldown)
        pol = self.add_policy(ReconcilePolicy(
            self.sup, server, donor, policy,
            replica_policy=replica_policy, queue_depth=queue_depth,
            queue_high=queue_high, pool_occupancy=pool_occupancy,
            occupancy_high=occupancy_high, tenant=tenant))
        # remembered so tick() re-derives the band when the application
        # re-applies a spec with a CHANGED SLOTarget — the objective is
        # the spec's, never frozen at registration time
        pol._slo_conf = {"metric": metric, "hysteresis": hysteresis,
                         "window": window, "percentile": percentile,
                         "cooldown": cooldown, "seen": slo,
                         "tenant": tenant}
        return pol

    @staticmethod
    def _resolve_slo(spec, server: str, tenant: Optional[str]):
        """The SLO a policy bands against: the tenant's own declared
        target when one exists, else the cell-level target."""
        cell = spec.cell(server)
        if tenant is not None and getattr(cell, "has_tenant",
                                          lambda _n: False)(tenant):
            tslo = cell.tenant(tenant).slo
            if tslo is not None:
                return tslo
        return cell.slo

    def _refresh_slo_bands(self, pol: ReconcilePolicy):
        """Re-derive an add_slo_policy band after the spec's SLO changed."""
        conf = getattr(pol, "_slo_conf", None)
        if conf is None:
            return
        spec = getattr(self.sup, "desired", None)
        if spec is None or not spec.has_cell(pol.server):
            return
        slo = self._resolve_slo(spec, pol.server, conf.get("tenant"))
        if slo is None or slo == conf["seen"]:
            return
        kw = {k: conf[k] for k in
              ("hysteresis", "window", "percentile", "cooldown")}
        try:
            if pol.policy is not None:
                pol.policy = ElasticPolicy.from_slo(
                    slo, metric=conf["metric"], **kw)
            if pol.replica_policy is not None:
                pol.replica_policy = ElasticPolicy.from_slo(
                    slo, metric="tpot", **kw)
        except ValueError:
            return      # new SLO dropped the needed target; keep old band
        conf["seen"] = slo

    def attach_server(self, server, decode_spec: Optional[str] = None):
        """Keep a DisaggServer's replica surface synced to the spec on
        every tick (``decode_spec`` defaults to the server's own base)."""
        self.servers.append((server, decode_spec))
        return server

    # -- one management cycle -------------------------------------------
    def tick(self, now: Optional[float] = None) -> dict:
        """Run one full cycle: health -> reconcile -> policies -> sync.

        ``now`` overrides wall-clock for simulated-time benchmarks (it is
        forwarded to the policies' cooldown logic).  Returns the tick
        record, also appended to :attr:`history`.
        """
        now = time.monotonic() if now is None else now
        rec = {"tick": self.ticks, "ts": now, "dead": [], "plan": "noop",
               "actions": [], "sync": {}}
        audited: List[dict] = []        # this tick's audit actions
        # 1. health: heartbeat-stale cells become failed, so the planner
        #    below schedules their recover
        check = getattr(self.sup, "check_health", None)
        if check is not None:
            for name in check():
                cell = self.sup.cells.get(name)
                if cell is not None and cell.status == "running":
                    cell.status = "failed"
                rec["dead"].append(name)
                audited.append({"kind": "mark_failed", "cell": name,
                                "reason": "heartbeat stale"})
        # 2. converge observed -> desired (recover, regrow, re-channel)
        plan = self.sup.reconcile()
        rec["plan"] = plan.summary()
        for op in getattr(plan, "ops", ()):
            audited.append({"kind": f"plan:{op.verb}",
                            "cell": getattr(op, "cell", None),
                            "reason": (f"reconcile: {op.verb} "
                                       f"{getattr(op, 'cell', '?')} "
                                       f"[{op.status}]")})
        # 3. SLO policies may rewrite + re-apply the spec (bands track the
        #    spec's CURRENT SLOTarget, not the one seen at registration)
        signals: dict = {}
        for policy in self.policies:
            self._refresh_slo_bands(policy)
            act = policy.maybe_act(now)
            if act:
                rec["actions"].append(act)
                audited.append(act)
            # the signals the policy ACTUALLY saw this tick (post-pull),
            # whether or not it acted — the audit must explain inaction
            # as well as action (duck-typed: hand-built policies need not
            # expose the full ReconcilePolicy surface)
            srv_name = getattr(policy, "server", None)
            if srv_name is None:
                continue
            sig = signals.setdefault(srv_name, {})
            if callable(getattr(policy, "tail", None)):
                sig["tail"] = policy.tail()
            if callable(getattr(policy, "replica_tail", None)):
                sig["tpot_tail"] = policy.replica_tail()
            qd = getattr(policy, "queue_depth", None)
            if callable(qd):
                sig["queue_depth"] = int(qd())
            occ = getattr(policy, "pool_occupancy", None)
            if callable(occ):
                sig["pool_occupancy"] = float(occ())
        # 4. serving surfaces follow the (possibly rescaled) spec
        for srv, base in self.servers:
            s = srv.sync(getattr(self.sup, "desired", None), base)
            if s["attached"] or s["detached"]:
                rec["sync"][base or srv._decode_base] = s
                audited.append({
                    "kind": "sync", "cell": base or srv._decode_base,
                    "reason": (f"replica surface converged: attached "
                               f"{s['attached']} detached {s['detached']} "
                               f"requeued {s['requeued']}")})
        self.audit.record(self.ticks, now, signals, audited)
        self.ticks += 1
        self.history.append(rec)
        return rec

    # -- timer loop -------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        """Tick every ``interval`` seconds on a background thread."""
        if self.running:
            raise RuntimeError("daemon already running")
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="supervisor-daemon", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop_evt.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # keep the loop alive; surface the error
                self.errors.append({"ts": time.monotonic(), "error": repr(e)})

    def stop(self, timeout: float = 5.0):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # a tick is still running: clearing _thread here would let
                # start() race a second concurrent daemon over the same
                # supervisor state
                raise RuntimeError(
                    f"daemon thread did not stop within {timeout}s")
            self._thread = None

    def __enter__(self) -> "SupervisorDaemon":
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
