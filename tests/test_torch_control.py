"""The port's control plane against the JAX one (CPU, no device work).

Every bookkeeping-supervisor scenario of ``tests/test_reconcile.py``, the
policy tests of ``tests/test_core.py`` and the daemon audit of
``tests/test_telemetry.py`` run twice: through ``benchmarks/simlib.py``'s
``SimSupervisor`` over the JAX reconciler, policies and daemon, and
through :class:`PortSimSupervisor` below, its twin over the port's
reconciler and ``CellAccounting``.  A scenario records what it saw (plan
ops with their verb, cell, args, status and result; the primitive log;
the end state of cells and desired spec; errors by type and message;
daemon tick records and audits on a fake clock), and the two records
must be equal.  ``PartitionTable`` is held against JAX's over random op
sequences (hypothesis): the same zones, epochs, failed columns and
errors after every op.
"""
import dataclasses
import time
import types

import pytest

pytest.importorskip("torch")

import benchmarks.simlib as jsim  # noqa: E402
from repro.core import accounting as j_accounting  # noqa: E402
from repro.core import daemon as j_daemon  # noqa: E402
from repro.core import elastic as j_elastic  # noqa: E402
from repro.core import partition as j_partition  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro_torch.core import accounting as t_accounting  # noqa: E402
from repro_torch.core import daemon as t_daemon  # noqa: E402
from repro_torch.core import elastic as t_elastic  # noqa: E402
from repro_torch.core import partition as t_partition  # noqa: E402
from repro_torch.core import spec as t_spec  # noqa: E402
from repro_torch.core.reconciler import Reconciler as TReconciler  # noqa: E402


# ---------------------------------------------------------------------------
# the port's twin of benchmarks/simlib.py's bookkeeping supervisor
# ---------------------------------------------------------------------------
class PortSimZone:
    def __init__(self, ncols: int):
        self.ncols = ncols


class PortSimCell:
    """Duck-typed cell: zone/role/status/accounting, no devices."""

    def __init__(self, name: str, ncols: int, role: str = "serve", arch=None):
        self.name = name
        self.zone = PortSimZone(ncols)
        self.role = role
        self.arch = arch
        self.status = "running"
        self.accounting = t_accounting.CellAccounting(name)


class PortSimSupervisor:
    """The port's reconciler over instant bookkeeping primitives, with the
    contract of ``benchmarks/simlib.py``'s ``SimSupervisor``: primitive
    calls append to ``log``; transfers also bump ``transfers``."""

    def __init__(self, *cells: PortSimCell):
        self.cells = {c.name: c for c in cells}
        self.desired = None
        self.log = []
        self.transfers = 0

    def apply(self, spec):
        self.desired = spec
        return self.reconcile()

    def reconcile(self):
        return TReconciler(self).reconcile(self.desired)

    def create_cell(self, name, arch, role, *, ncols, pods=(0,),
                    opt_cfg=None, parent=None):
        self.log.append(("create", name, ncols))
        self.cells[name] = PortSimCell(name, ncols, role, arch)
        return self.cells[name]

    def destroy_cell(self, name):
        self.log.append(("destroy", name))
        del self.cells[name]

    def resize_cell(self, name, ncols):
        self.log.append(("resize", name, ncols))
        self.cells[name].zone.ncols = ncols
        return {"ncols": ncols}

    def transfer_columns(self, src, dst, ncols=1):
        self.log.append(("transfer", src, dst, ncols))
        self.cells[src].zone.ncols -= ncols
        self.cells[dst].zone.ncols += ncols
        self.transfers += 1
        return {"ncols": ncols}

    def recover_cell(self, name, *, ncols=None, ckpt_dir=None):
        self.log.append(("recover", name, ncols, ckpt_dir))
        cell = self.cells[name]
        cell.status = "running"
        if ncols is not None:
            cell.zone.ncols = ncols
        return cell


def _ns(sim_cell, sim_sup, acc, spec, elastic, daemon, partition):
    return types.SimpleNamespace(
        SimCell=sim_cell, SimSupervisor=sim_sup,
        CellAccounting=acc.CellAccounting,
        CellSpec=spec.CellSpec, ChannelSpec=spec.ChannelSpec,
        ClusterSpec=spec.ClusterSpec, SLOTarget=spec.SLOTarget,
        SpecError=spec.SpecError, TenantSpec=spec.TenantSpec,
        ElasticPolicy=elastic.ElasticPolicy,
        ReconcilePolicy=elastic.ReconcilePolicy,
        SupervisorDaemon=daemon.SupervisorDaemon,
        PartitionError=partition.PartitionError)


JAX = _ns(jsim.SimCell, jsim.SimSupervisor, j_accounting, j_spec, j_elastic,
          j_daemon, j_partition)
PORT = _ns(PortSimCell, PortSimSupervisor, t_accounting, t_spec, t_elastic,
           t_daemon, t_partition)


# ---------------------------------------------------------------------------
# what a scenario records
# ---------------------------------------------------------------------------
class Trace(list):
    def plan(self, plan):
        self.append(("plan", [(op.verb, op.cell, dict(op.args), op.status,
                               op.result) for op in plan.ops]))
        return plan

    def state(self, sup):
        cells = {n: (c.zone.ncols, c.status, c.role)
                 for n, c in sorted(sup.cells.items())}
        desired = None
        if sup.desired is not None:
            desired = [(c.name, c.ncols, c.replicas, c.min_ncols, c.max_ncols)
                       for c in sup.desired.cells]
        self.append(("state", cells, desired, list(sup.log)))

    def err(self, fn):
        try:
            out = fn()
        except Exception as e:            # the error IS the observation
            self.append(("raises", type(e).__name__, str(e)))
            return None
        self.append(("ok",))
        return out

    def act(self, action):
        self.append(("action", None if action is None else dict(action)))
        return action


def _sup(ns, **cols):
    return ns.SimSupervisor(*(ns.SimCell(n, c) for n, c in cols.items()))


# ---------------------------------------------------------------------------
# scenarios of tests/test_reconcile.py
# ---------------------------------------------------------------------------
def sc_cellspec_validation(ns, t):
    t.err(lambda: ns.CellSpec("a/b", None, "serve"))
    t.err(lambda: ns.CellSpec("a", None, "serve", replicas=0))
    t.err(lambda: ns.CellSpec("a", None, "serve", ncols=5, max_ncols=3))
    t.err(lambda: ns.ClusterSpec(cells=(ns.CellSpec("a", None, "serve"),
                                        ns.CellSpec("a", None, "train"))))
    t.err(lambda: ns.ClusterSpec(cells=(ns.CellSpec("a", None, "serve"),),
                                 channels=(ns.ChannelSpec("a", "ghost"),)))
    t.err(lambda: ns.CellSpec("a", None, "train",
                              tenants=(ns.TenantSpec("x"),)))


def sc_tenant_validation(ns, t):
    for kw in ({"name": ""}, {"name": "a/b"}, {"name": "__public__"},
               {"name": "x", "weight": 0}, {"name": "x", "page_quota": 1.5},
               {"name": "x", "rate": -1}, {"name": "x", "burst": 2.0},
               {"name": "x", "rate": 1.0, "burst": 0}):
        t.err(lambda kw=kw: ns.TenantSpec(**kw))
    t.err(lambda: ns.CellSpec("s", None, "serve", tenants=(
        ns.TenantSpec("a", page_quota=0.7),
        ns.TenantSpec("b", page_quota=0.6))))
    t.err(lambda: ns.CellSpec("s", None, "serve", tenants=(
        ns.TenantSpec("a"), ns.TenantSpec("a"))))
    c = ns.CellSpec("s", None, "serve", tenants=(
        ns.TenantSpec("a", weight=2.0, rate=5.0),))
    t.append(("tenant", c.has_tenant("a"), c.has_tenant("b"),
              c.tenant("a").weight))
    t.err(lambda: c.tenant("b"))


def sc_replica_bounds(ns, t):
    t.err(lambda: ns.CellSpec("a", None, "serve", replicas=4, max_replicas=2))
    t.err(lambda: ns.CellSpec("a", None, "serve", replicas=1, min_replicas=2))
    t.err(lambda: ns.CellSpec("a", None, "serve", min_replicas=0))
    c = ns.CellSpec("a", None, "serve", replicas=2, min_replicas=1,
                    max_replicas=4)
    t.append((c.clamp_replicas(9), c.clamp_replicas(0),
              c.with_replicas(3).replicas))
    spec = ns.ClusterSpec(cells=(c,))
    s2, d = spec.scale_replicas_by("a", 10)
    t.append((d, s2.cell("a").replicas))
    t.append(s2.scale_replicas_by("a", 1)[1])


def sc_instances_and_scaling(ns, t):
    c = ns.CellSpec("dec", None, "serve", ncols=2, min_ncols=1, max_ncols=4,
                    replicas=3, slo=ns.SLOTarget(ttft_p99=0.1))
    t.append(c.instances())
    spec = ns.ClusterSpec(cells=(c, ns.CellSpec("pre", None, "serve")),
                          channels=(ns.ChannelSpec("pre", "dec", kind="kv"),))
    t.append(sorted(spec.instance_specs()))
    t.append(spec.instance_channels())
    s2, d = spec.scale_by("dec", 10)
    t.append((d, s2.cell("dec").ncols))
    s3, d = s2.scale_by("dec", -10)
    t.append((d, s3.cell("dec").ncols))
    t.append(s3.scale_by("dec", -1)[1])
    t.append((spec.scale("pre", 1) is not spec,
              spec.without_cell("dec").channels))


def sc_converges_idempotent(ns, t):
    sup = _sup(ns)
    spec = ns.ClusterSpec(cells=(ns.CellSpec("a", None, "serve", ncols=2),
                                 ns.CellSpec("b", None, "train", ncols=3)))
    t.plan(sup.apply(spec))
    t.plan(sup.reconcile())
    t.plan(sup.reconcile())
    t.state(sup)


def sc_pairs_into_transfer(ns, t):
    sup = _sup(ns, a=4, b=2)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("a", None, "serve", ncols=2, min_ncols=1, max_ncols=6),
        ns.CellSpec("b", None, "serve", ncols=4, min_ncols=1, max_ncols=6)))))
    t.plan(sup.reconcile())
    t.state(sup)


def sc_destroys_unmanaged(ns, t):
    sup = _sup(ns, old=2, keep=1)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("keep", None, "serve", ncols=3, max_ncols=3),
        ns.CellSpec("new", None, "serve", ncols=1)))))
    t.plan(sup.reconcile())
    t.state(sup)


def sc_unbalanced_shrink_transfer(ns, t):
    sup = _sup(ns, a=5, b=3)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("a", None, "serve", ncols=2, min_ncols=2, max_ncols=6),
        ns.CellSpec("b", None, "serve", ncols=4, min_ncols=1, max_ncols=6)))))
    t.plan(sup.reconcile())
    t.state(sup)


def sc_blocked_create_blocks_channel(ns, t):
    class FullSup(ns.SimSupervisor):
        def create_cell(self, name, arch, role, **kw):
            raise ns.PartitionError("no free columns")

        def find_channel(self, src, dst, kind="array"):
            return None

        def open_channel(self, src, dst, kind="array"):
            raise AssertionError("must not be reached")

    sup = FullSup(ns.SimCell("a", 1))
    t.plan(sup.apply(ns.ClusterSpec(
        cells=(ns.CellSpec("a", None, "serve", ncols=1, max_ncols=1),
               ns.CellSpec("b", None, "serve", ncols=1)),
        channels=(ns.ChannelSpec("a", "b"),))))
    t.state(sup)


def sc_recreate_reopens_channels(ns, t):
    class ChanSup(ns.SimSupervisor):
        def __init__(self, *cells):
            super().__init__(*cells)
            self.channels = []

        def find_channel(self, src, dst, kind="array"):
            return next((c for c in self.channels if c == (src, dst, kind)),
                        None)

        def open_channel(self, src, dst, kind="array"):
            self.channels.append((src, dst, kind))
            return types.SimpleNamespace(cid=len(self.channels))

        def destroy_cell(self, name):
            super().destroy_cell(name)
            self.channels = [c for c in self.channels
                             if name not in (c[0], c[1])]

    sup = ChanSup(ns.SimCell("a", 1), ns.SimCell("b", 1))
    spec = ns.ClusterSpec(
        cells=(ns.CellSpec("a", None, "serve", ncols=1, max_ncols=1),
               ns.CellSpec("b", None, "serve", ncols=1, max_ncols=1)),
        channels=(ns.ChannelSpec("a", "b", kind="kv"),))
    t.plan(sup.apply(spec))
    t.plan(sup.reconcile())
    t.plan(sup.apply(spec.with_cell(
        ns.CellSpec("b", None, "train", ncols=1, max_ncols=1))))
    t.plan(sup.reconcile())
    t.append(list(sup.channels))
    t.state(sup)


def sc_recovers_failed(ns, t):
    sup = _sup(ns, a=2)
    sup.cells["a"].status = "failed"
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("a", None, "serve", ncols=2, max_ncols=2),))))
    t.plan(sup.reconcile())
    t.state(sup)


def sc_recreates_on_role_change(ns, t):
    sup = _sup(ns, a=2)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("a", None, "train", ncols=2, max_ncols=2),))))
    t.plan(sup.reconcile())
    t.state(sup)


def sc_expands_replicas(ns, t):
    sup = _sup(ns)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("dec", None, "serve", ncols=1, replicas=3),))))
    t.plan(sup.reconcile())
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("dec", None, "serve", ncols=1, replicas=2),))))
    t.state(sup)


def sc_policy_validation(ns, t):
    t.err(lambda: ns.ElasticPolicy(lt=0.1, ut=0.2, metric="tftt"))
    t.err(lambda: ns.ElasticPolicy(lt=0.3, ut=0.2))
    t.err(lambda: ns.ElasticPolicy(lt=0.1, ut=0.2, window=0))
    sup = _sup(ns)
    t.err(lambda: ns.ReconcilePolicy(sup, "a"))
    t.err(lambda: ns.ReconcilePolicy(sup, "a", None,
                                     ns.ElasticPolicy(lt=0.1, ut=0.2)))
    t.err(lambda: ns.ReconcilePolicy(
        sup, "a", replica_policy=ns.ElasticPolicy(lt=0.1, ut=0.2),
        occupancy_high=1.5))


def sc_from_slo(ns, t):
    slo = ns.SLOTarget(ttft_p99=0.2, tpot_p99=0.05)
    for kw in ({"metric": "ttft", "hysteresis": 0.8},
               {"metric": "tpot", "hysteresis": 0.5, "window": 20},
               {"metric": "ttft", "hysteresis": 0.5, "percentile": 90.0,
                "cooldown": 3.0}):
        t.append(dataclasses.asdict(ns.ElasticPolicy.from_slo(slo, **kw)))
    t.err(lambda: ns.ElasticPolicy.from_slo(ns.SLOTarget(ttft_p99=0.2),
                                            metric="tpot"))
    t.err(lambda: ns.ElasticPolicy.from_slo(None, metric="ttft"))
    t.err(lambda: ns.ElasticPolicy.from_slo(slo, hysteresis=1.5))


def sc_pull_cursor_identity(ns, t):
    sup = _sup(ns, server=2, batch=2)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("server", None, "serve", ncols=2, min_ncols=1,
                    max_ncols=4),
        ns.CellSpec("batch", None, "train", ncols=2, min_ncols=1,
                    max_ncols=4)))))
    pol = ns.ReconcilePolicy(sup, "server", "batch",
                             ns.ElasticPolicy(lt=0.1, ut=0.2, window=10))
    for i in range(3):
        sup.cells["server"].accounting.record_request(i, ttft=0.15)
    t.append(pol.pull())
    sup.cells["server"].accounting = ns.CellAccounting("server")
    for i in range(5):
        sup.cells["server"].accounting.record_request(i, ttft=0.15)
    t.append(pol.pull())
    t.append(list(pol.samples))


def sc_recover_threads_ckpt_dir(ns, t):
    sup = _sup(ns, a=2)
    sup.cells["a"].status = "failed"
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("a", None, "serve", ncols=2, max_ncols=2,
                    ckpt_dir="/ckpts/a"),))))
    t.state(sup)


def sc_replica_autoscale(ns, t):
    sup = _sup(ns)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("dec", None, "serve", ncols=1, replicas=1,
                    max_replicas=3),))))
    q = {"n": 10}
    pol = ns.ReconcilePolicy(
        sup, "dec",
        replica_policy=ns.ElasticPolicy(lt=0.05, ut=0.2, window=10,
                                        metric="tpot"),
        queue_depth=lambda: q["n"], queue_high=4)
    t.act(pol.maybe_act(now=0.0))
    t.state(sup)
    q["n"] = 0
    for i in range(10):
        sup.cells["dec/0"].accounting.record_request(i, tpot=0.5)
    t.act(pol.maybe_act(now=1.0))
    for i in range(10, 20):
        sup.cells["dec/0"].accounting.record_request(i, tpot=0.5)
    t.act(pol.maybe_act(now=2.0))
    for i in range(20, 32):
        sup.cells["dec/1"].accounting.record_request(i, tpot=0.01)
    t.act(pol.maybe_act(now=3.0))
    t.plan(sup.reconcile())
    t.state(sup)


def sc_replica_rename_boundary(ns, t):
    sup = _sup(ns)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("dec", None, "serve", ncols=1, replicas=2,
                    max_replicas=3),))))
    pol = ns.ReconcilePolicy(
        sup, "dec",
        replica_policy=ns.ElasticPolicy(lt=0.05, ut=0.2, window=10,
                                        metric="tpot"),
        queue_depth=lambda: 0)
    for i in range(10):
        sup.cells["dec/0"].accounting.record_request(i, tpot=0.01)
    t.act(pol.maybe_act(now=0.0))
    for i in range(10, 22):
        sup.cells["dec/0"].accounting.record_request(i, tpot=0.5)
    t.act(pol.maybe_act(now=1.0))
    t.state(sup)
    sup2 = _sup(ns)
    t.plan(sup2.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("dec", None, "serve", ncols=1, replicas=2),))))
    pol2 = ns.ReconcilePolicy(
        sup2, "dec",
        replica_policy=ns.ElasticPolicy(lt=0.05, ut=0.2, window=10,
                                        metric="tpot"),
        queue_depth=lambda: 0)
    for i in range(10):
        sup2.cells["dec/0"].accounting.record_request(i, tpot=0.01)
    t.act(pol2.maybe_act(now=0.0))
    t.state(sup2)


def sc_occupancy_signal(ns, t):
    """The pool-occupancy signal grows replicas alone and blocks a shrink
    into a memory squeeze."""
    sup = _sup(ns)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("dec", None, "serve", ncols=1, replicas=2,
                    max_replicas=3),))))
    occ = {"v": 0.95}
    pol = ns.ReconcilePolicy(
        sup, "dec",
        replica_policy=ns.ElasticPolicy(lt=0.05, ut=0.2, window=10,
                                        metric="tpot"),
        queue_depth=lambda: 0, pool_occupancy=lambda: occ["v"])
    t.act(pol.maybe_act(now=0.0))
    occ["v"] = 0.6
    for i in range(12):
        sup.cells["dec/0"].accounting.record_request(i, tpot=0.01)
    t.act(pol.maybe_act(now=1.0))
    occ["v"] = 0.1
    t.act(pol.maybe_act(now=2.0))
    t.state(sup)


# ---------------------------------------------------------------------------
# the daemon (tests/test_reconcile.py, tests/test_telemetry.py), fake clock
# ---------------------------------------------------------------------------
def _recording_sup(ns, *cells):
    class RecordingSup(ns.SimSupervisor):
        def __init__(self, *cells):
            super().__init__(*cells)
            self.calls = []
            self.dead_once = []

        def check_health(self):
            self.calls.append("health")
            out, self.dead_once = self.dead_once, []
            return out

        def reconcile(self):
            self.calls.append("reconcile")
            return super().reconcile()

    return RecordingSup(*cells)


def _tick(t, daemon, now):
    rec = daemon.tick(now=now)
    t.append(("tick", dict(rec)))
    return rec


def sc_daemon_tick_order(ns, t):
    sup = _recording_sup(ns, ns.SimCell("a", 2))
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("a", None, "serve", ncols=2, max_ncols=2),))))
    calls = sup.calls

    class FakePolicy:
        actions = []

        def maybe_act(self, now=None):
            calls.append("policy")
            return None

    class FakeSrv:
        _decode_base = "a"

        def sync(self, spec, base=None):
            calls.append("sync")
            return {"attached": ["a/9"], "detached": [], "requeued": 0}

    daemon = ns.SupervisorDaemon(sup)
    daemon.add_policy(FakePolicy())
    daemon.attach_server(FakeSrv())
    sup.dead_once = ["a"]
    calls.clear()
    _tick(t, daemon, 5.0)
    t.append(list(calls))
    _tick(t, daemon, 6.0)
    t.append((daemon.ticks, len(daemon.history), daemon.audit.entries()))
    t.state(sup)


def sc_daemon_slo_policy(ns, t):
    sup = _sup(ns, srv=2, don=4)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("srv", None, "serve", ncols=2, min_ncols=1, max_ncols=6,
                    slo=ns.SLOTarget(ttft_p99=0.2, tpot_p99=0.05)),
        ns.CellSpec("don", None, "train", ncols=4, min_ncols=1,
                    max_ncols=6)))))
    daemon = ns.SupervisorDaemon(sup)
    pol = daemon.add_slo_policy("srv", "don", hysteresis=0.8,
                                autoscale_replicas=True)
    t.append((dataclasses.asdict(pol.policy),
              dataclasses.asdict(pol.replica_policy)))
    for i in range(10):
        sup.cells["srv"].accounting.record_request(i, ttft=0.5)
    _tick(t, daemon, 0.0)
    sup.apply(sup.desired.with_cell(dataclasses.replace(
        sup.desired.cell("srv"),
        slo=ns.SLOTarget(ttft_p99=0.1, tpot_p99=0.02))))
    _tick(t, daemon, 100.0)
    t.append((dataclasses.asdict(pol.policy),
              dataclasses.asdict(pol.replica_policy)))
    t.append(daemon.audit.entries())
    t.append(daemon.audit.query(kind="grow"))
    t.err(lambda: daemon.add_slo_policy("ghost", "don"))
    sup2 = _sup(ns, x=1)
    sup2.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("x", None, "serve", ncols=1, max_ncols=1),)))
    t.err(lambda: ns.SupervisorDaemon(sup2).add_slo_policy(
        "x", autoscale_replicas=True))
    t.state(sup)


def sc_daemon_tenant_slo(ns, t):
    """A tenant-scoped SLO policy bands against the tenant's own target
    and reads only that tenant's samples."""
    sup = _sup(ns, srv=2, don=4)
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("srv", None, "serve", ncols=2, min_ncols=1, max_ncols=6,
                    slo=ns.SLOTarget(ttft_p99=0.5),
                    tenants=(ns.TenantSpec("paid",
                                           slo=ns.SLOTarget(ttft_p99=0.1)),
                             ns.TenantSpec("free"))),
        ns.CellSpec("don", None, "train", ncols=4, min_ncols=1,
                    max_ncols=6)))))
    daemon = ns.SupervisorDaemon(sup)
    pol = daemon.add_slo_policy("srv", "don", tenant="paid")
    t.append(dataclasses.asdict(pol.policy))
    acc = sup.cells["srv"].accounting
    for i in range(10):
        acc.record_request(i, ttft=0.01, tenant="free")
    _tick(t, daemon, 0.0)
    for i in range(10, 20):
        acc.record_request(i, ttft=0.3, tenant="paid")
    _tick(t, daemon, 1.0)
    t.append(daemon.audit.entries())
    t.state(sup)


def sc_daemon_audit_fake_sup(ns, t):
    class FakePlan:
        ops = ()

        def summary(self):
            return "noop"

    class FakeSup:
        cells: dict = {}
        desired = None

        def check_health(self):
            return ["decode/1"]

        def reconcile(self):
            return FakePlan()

    d = ns.SupervisorDaemon(FakeSup())
    _tick(t, d, 1.0)
    t.append(d.audit.query(kind="mark_failed"))
    t.append(d.audit.entries())


# ---------------------------------------------------------------------------
# the policy tests of tests/test_core.py
# ---------------------------------------------------------------------------
def _mock(ns):
    sup = ns.SimSupervisor(ns.SimCell("srv", 2, "serve"),
                           ns.SimCell("don", 4, "train"))
    spec = ns.ClusterSpec(cells=(
        ns.CellSpec("srv", None, "serve", ncols=2, min_ncols=1, max_ncols=6),
        ns.CellSpec("don", None, "train", ncols=4, min_ncols=1,
                    max_ncols=6)))
    return sup, spec


def sc_policy_grow_shrink_cooldown(ns, t):
    sup, spec = _mock(ns)
    t.plan(sup.apply(spec))
    sched = ns.ReconcilePolicy(
        sup, "srv", "don",
        ns.ElasticPolicy(lt=0.1, ut=0.2, window=10, cooldown=100.0))
    for _ in range(10):
        sched.observe(0.5)
    t.act(sched.maybe_act(now=0.0))
    t.state(sup)
    for _ in range(10):
        sched.observe(0.5)
    t.act(sched.maybe_act(now=50.0))
    for _ in range(10):
        sched.observe(0.01)
    t.act(sched.maybe_act(now=200.0))
    t.plan(sup.apply(sup.desired.scale("srv", 1).scale("don", 5)))
    for _ in range(10):
        sched.observe(0.01)
    t.act(sched.maybe_act(now=400.0))
    t.append(sched.actions)
    t.state(sup)


def sc_policy_conserves_columns(ns, t):
    sup = ns.SimSupervisor(ns.SimCell("dec/0", 1, "serve"),
                           ns.SimCell("dec/1", 1, "serve"),
                           ns.SimCell("don", 4, "train"))
    t.plan(sup.apply(ns.ClusterSpec(cells=(
        ns.CellSpec("dec", None, "serve", ncols=1, min_ncols=1, max_ncols=3,
                    replicas=2),
        ns.CellSpec("don", None, "train", ncols=4, min_ncols=1,
                    max_ncols=6)))))
    sched = ns.ReconcilePolicy(
        sup, "dec", "don",
        ns.ElasticPolicy(lt=0.1, ut=0.2, window=10, cooldown=0.0))
    for _ in range(10):
        sched.observe(0.5)
    t.act(sched.maybe_act(now=0.0))
    t.plan(sup.reconcile())
    for _ in range(10):
        sched.observe(0.5)
    before = sup.desired
    t.act(sched.maybe_act(now=10.0))
    t.append(sup.desired is before)
    t.state(sup)


def sc_policy_pulls_live_accounting(ns, t):
    sup, spec = _mock(ns)
    sup.apply(spec)
    sched = ns.ReconcilePolicy(
        sup, "srv", "don",
        ns.ElasticPolicy(lt=0.1, ut=0.2, window=10, cooldown=0.0,
                         metric="ttft"))
    acc = sup.cells["srv"].accounting
    for rid in range(10):
        acc.record_request(rid, ttft=0.5, tpot=0.01)
    t.act(sched.maybe_act(now=0.0))
    t.append(sched.pull())
    sup.cells["srv"].accounting = ns.CellAccounting("srv")
    sup.cells["srv"].accounting.record_request(0, ttft=0.7)
    t.append(sched.pull())
    sched2 = ns.ReconcilePolicy(
        sup, "srv", "don",
        ns.ElasticPolicy(lt=0.1, ut=0.2, window=10, cooldown=0.0,
                         metric="tpot"))
    sched2.pull()
    t.append(list(sched2.samples))
    t.state(sup)


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_port_matches_jax(scenario):
    traces = []
    for ns in (JAX, PORT):
        t = Trace()
        scenario(ns, t)
        traces.append(t)
    assert traces[0], "the scenario recorded nothing"
    assert traces[1] == traces[0]


def test_port_daemon_threaded_start_stop():
    """The timer loop of tests/test_reconcile.py on the port's daemon."""
    sup = _sup(PORT, a=1)
    sup.apply(t_spec.ClusterSpec(cells=(
        t_spec.CellSpec("a", None, "serve", ncols=1, max_ncols=1),)))
    daemon = t_daemon.SupervisorDaemon(sup, interval=0.005)
    with daemon:
        assert daemon.running
        with pytest.raises(RuntimeError):
            daemon.start()
        deadline = time.monotonic() + 5.0
        while daemon.ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
    assert not daemon.running
    assert daemon.ticks >= 1 and not daemon.errors
    ticks_at_stop = daemon.ticks
    time.sleep(0.03)
    assert daemon.ticks == ticks_at_stop


# ---------------------------------------------------------------------------
# PartitionTable against JAX's over random op sequences
# ---------------------------------------------------------------------------
def _table_state(table):
    return (table.grid_shape, table.epoch,
            tuple((z.name, z.pods, z.c0, z.c1) for z in table.zones),
            sorted(table.failed_columns))


def _apply(table, op, a, b):
    if op == "carve":
        return table.carve(f"z{a}", b)[0]
    if op == "carve2":
        return table.carve(f"z{a}", b, pods=(0, 1))[0]
    if op == "release":
        return table.release(f"z{a}")
    if op == "resize":
        return table.resize(f"z{a}", b)[0]
    if op == "fail":
        return table.mark_failed(a % 2, b)
    if op == "restore":
        return table.mark_restored(a % 2, b)
    if op == "transfer":
        return table.transfer(f"z{a}", f"z{(a + 1) % 10}", b)[0]
    raise ValueError(op)


def _run_ops(mod, seq):
    table = mod.PartitionTable(grid_shape=(2, 16, 16))
    out = [_table_state(table)]
    for op, a, b in seq:
        try:
            table = _apply(table, op, a, b)
            out.append(_table_state(table))
        except mod.PartitionError as e:
            out.append(("PartitionError", str(e)))
    return out


UNIT_SEQUENCES = {
    # the unit sequences of tests/test_partition.py, as op lists
    "carve_resize_fail": [
        ("carve", 0, 4), ("carve", 1, 8), ("carve", 2, 8), ("carve2", 3, 4),
        ("resize", 0, 6), ("resize", 1, 2), ("transfer", 1, 1),
        ("transfer", 0, 5), ("fail", 0, 3), ("restore", 0, 3),
        ("restore", 0, 3), ("release", 1, 0), ("release", 9, 0),
        ("carve", 0, 1), ("carve", 5, 0)],
    # a donor right of its taker frees its left edge; then one whose
    # shapes do not fit relocates both zones
    "transfer_sides": [
        ("carve", 1, 4), ("carve", 0, 4), ("transfer", 0, 1),
        ("carve", 2, 6), ("transfer", 1, 2), ("transfer", 2, 5),
        ("resize", 0, 9), ("fail", 0, 0), ("transfer", 0, 1)],
}


@pytest.mark.parametrize("name", sorted(UNIT_SEQUENCES))
def test_partition_unit_sequences_match_jax(name):
    seq = UNIT_SEQUENCES[name]
    assert _run_ops(t_partition, seq) == _run_ops(j_partition, seq)


try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:          # keep the module's other tests without the dep
    hypothesis = None

if hypothesis is not None:
    OPS = st.lists(
        st.one_of(
            st.tuples(st.just("carve"), st.integers(0, 9), st.integers(1, 6)),
            st.tuples(st.just("carve2"), st.integers(0, 9), st.integers(1, 6)),
            st.tuples(st.just("release"), st.integers(0, 9), st.integers(1, 6)),
            st.tuples(st.just("resize"), st.integers(0, 9), st.integers(1, 8)),
            st.tuples(st.just("fail"), st.integers(0, 1), st.integers(0, 15)),
            st.tuples(st.just("restore"), st.integers(0, 1), st.integers(0, 15)),
            st.tuples(st.just("transfer"), st.integers(0, 9), st.integers(1, 4)),
        ),
        max_size=25,
    )


    @hypothesis.settings(max_examples=200, deadline=None)
    @hypothesis.given(OPS)
    def test_partition_table_matches_jax(seq):
        """tests/test_partition.py's random op sequences (plus two-pod carves,
        restores and transfers) on both tables: the same zones, epochs,
        failed columns and errors after every op."""
        assert _run_ops(t_partition, seq) == _run_ops(j_partition, seq)
