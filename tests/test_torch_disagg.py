"""The port's disaggregated server against the JAX package's (CPU, float32).

Every ``DisaggServer`` scenario of ``tests/test_serve_disagg.py`` runs
through both packages on the same weights (JAX's ``Model.init(PRNGKey(0))``
of the float32 smoke config, through ``params_from_numpy``) and the same
requests: the tokens must be identical, and so must the deterministic
counters (KV transfers, requests per replica, requeues, prefill worker
invocations, token-at-a-time fallbacks, prefix-hit tokens, warm and cold
routings, decode invocations, the kinds and ends of the channels the
supervisor opened) and the span names of every request's trace in the
cells' flight recorders.  The two scenarios that restore a cell from a
checkpoint write it with each package's own ``checkpoint.save``.
"""
import collections
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.serve import batcher as j_batcher  # noqa: E402
from repro.serve import disagg as j_disagg  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.core.telemetry import recorder_of  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402
from repro_torch.serve import batcher as t_batcher  # noqa: E402
from repro_torch.serve import disagg as t_disagg  # noqa: E402

MAX_LEN = 48
SLOTS = 3
_WEIGHTS = {}


class Side:
    """One package's serving surface over the float32 smoke config of
    ``arch`` (``window``: its sliding window replaced), with the JAX
    package's seed-0 weights."""

    def __init__(self, port: bool, arch: str, window=None):
        self.port = port
        jcfg = smoke_config(get_arch(arch)).replace(dtype="float32")
        tcfg = t_smoke_config(t_get_arch(arch)).replace(dtype="float32")
        if window is not None:
            jcfg, tcfg = (c.replace(sliding_window=window)
                          for c in (jcfg, tcfg))
        key = (arch, window)
        if key not in _WEIGHTS:
            jp = build_model(jcfg, single_device_ctx()).init(
                jax.random.PRNGKey(0))
            _WEIGHTS[key] = (jp, params_from_numpy(
                jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                dtype=torch.float32, device="cpu"))
        self.params = _WEIGHTS[key][1 if port else 0]
        self.cfg = tcfg if port else jcfg
        self.core = T if port else J
        self.disagg = t_disagg if port else j_disagg
        self.Request = (t_batcher if port else j_batcher).Request
        self.ContinuousBatcher = (t_batcher if port
                                  else j_batcher).ContinuousBatcher
        self.devices = ["cpu"] if port else jax.devices()[:1]

    def supervisor(self, cols: int):
        return self.core.Supervisor(self.core.DeviceGrid.from_flat(
            self.devices, 1, 1, cols, allow_reuse=True))

    def init(self, cell):
        cell.init_serve(params=self.params)

    def spec(self, replicas: int, **kw):
        c = self.core
        return c.ClusterSpec(
            cells=(c.CellSpec("prefill", self.cfg, "serve", ncols=1),
                   c.CellSpec("decode", self.cfg, "serve", ncols=1,
                              replicas=replicas, **kw)),
            channels=(c.ChannelSpec("prefill", "decode", kind="kv"),))

    def requests(self, lens, max_new=5, seed=0, rid0=0, srcs=False):
        """Random prompts of ``lens`` (and, ``srcs``, ragged encdec
        sources), the draws of ``tests/test_serve_disagg.py``."""
        rng = np.random.RandomState(seed)
        out = []
        for i, L in enumerate(lens):
            src = (rng.randn(5 + 3 * i, self.cfg.d_model).astype(np.float32)
                   if srcs else None)
            out.append(self.Request(
                rid=rid0 + i, max_new_tokens=max_new, src=src,
                prompt=rng.randint(1, self.cfg.vocab, size=L)
                .astype(np.int32)))
        return out

    @property
    def ckpt(self):
        if self.port:
            from repro_torch.checkpoint import checkpoint
        else:
            from repro.checkpoint import checkpoint
        return checkpoint

    def leaves(self, tree):
        if self.port:
            from repro_torch.models.param import jax_leaves
            return [t.numpy() for t in jax_leaves(tree)]
        return [np.asarray(x) for x in jax.tree.leaves(tree)]

    def recorder(self, cell):
        if self.port:
            return recorder_of(cell.accounting)
        from repro.core.telemetry import recorder_of as j_recorder_of
        return j_recorder_of(cell.accounting)


def counters(side, sup, srv) -> dict:
    """The deterministic observables a scenario must give alike."""
    st = srv.stats()
    spans = collections.Counter()
    open_spans = 0
    for cell in sup.cells.values():
        rec = side.recorder(cell)
        open_spans += len(rec.open_spans)
        spans.update((e["trace_id"], e["name"]) for e in rec.log
                     if e["trace_id"] is not None)
    return {
        "kv_transfers": st["kv_transfers"],
        "per_replica_requests": st["per_replica_requests"],
        "requests_detached": st["requests_detached"],
        "requeued": st["requeued"],
        "invocations": srv.worker.invocations if srv.worker else 0,
        "fallback": st["prefill_fallback_requests"],
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "routed": (st["routed_warm"], st["routed_cold"]),
        "decode_invocations": st["decode_invocations"],
        "blocked_on_pool": st["blocked_on_pool"],
        "channels": [(e["kind"], e["src"], e["dst"]) for e in sup.events
                     if e["op"] == "open_channel"],
        "replicas": [rep.cell.name for rep in srv.replicas],
        "spans": sorted(spans.items(), key=repr),
        "open_spans": open_spans,
    }


def both(scenario, arch="qwen3-4b", **kw):
    """Run ``scenario(side)`` -> (tokens, observables) through both
    packages; assert they agree and return the port's."""
    got = {}
    for port in (False, True):
        got[port] = scenario(Side(port, arch, **kw))
    (jt, jc), (tt, tc) = got[False], got[True]
    assert tt == jt
    assert tc == jc
    return tt, tc


def drained(srv, **kw):
    return {r.rid: r.output for r in srv.run_until_drained(**kw)}


# ---------------------------------------------------------------------------
def test_kv_handoff_roundtrip():
    def run(side):
        sup = side.supervisor(2)
        sup.create_cell("prefill", side.cfg, "serve", ncols=1)
        dec = sup.create_cell("decode", side.cfg, "serve", ncols=1)
        side.init(dec)
        srv = side.disagg.DisaggServer(sup, "prefill", "decode",
                                       batch_slots=SLOTS, max_len=MAX_LEN,
                                       chunk=16)
        for r in side.requests([3, 33, 17, 40]):
            srv.submit(r)
        got = drained(srv)
        c = counters(side, sup, srv)
        c["served_by_decode"] = dec.accounting.serving_summary()["requests"]
        c["channel_transfers"] = srv.channel.transfers
        return got, c

    got, c = both(run)
    assert sorted(got) == [0, 1, 2, 3] and all(len(v) == 5
                                              for v in got.values())
    assert [k for k, _, _ in c["channels"]] == ["array", "kv"]
    assert c["channel_transfers"] == 4 and c["served_by_decode"] == 4
    assert c["open_spans"] == 0


def test_decode_replica_fanout():
    def run(side):
        sup = side.supervisor(3)
        spec = side.spec(2)
        plan = sup.apply(spec)
        side.init(sup.cells["decode/0"])
        srv = side.disagg.DisaggServer(sup, "prefill",
                                       spec.cell("decode").instances(),
                                       batch_slots=2, max_len=MAX_LEN,
                                       chunk=16)
        reused = (sup.find_channel("prefill", "decode/0", "kv")
                  is srv.replicas[0].channel)
        for r in side.requests([9, 33, 17, 21, 40, 12], max_new=3):
            srv.submit(r)
        got = drained(srv)
        c = counters(side, sup, srv)
        c["plan"] = sorted({op.verb for op in plan.ops})
        c["reused"] = reused
        return got, c

    got, c = both(run)
    assert len(got) == 6 and all(n > 0 for n in c["per_replica_requests"])
    assert c["reused"] and ("array", "decode/0", "decode/1") in c["channels"]


def test_failed_replica_requeues_orphans():
    def run(side):
        sup = side.supervisor(3)
        sup.create_cell("prefill", side.cfg, "serve", ncols=1)
        side.init(sup.create_cell("dec0", side.cfg, "serve", ncols=1))
        sup.create_cell("dec1", side.cfg, "serve", ncols=1)
        srv = side.disagg.DisaggServer(sup, "prefill", ["dec0", "dec1"],
                                       batch_slots=2, max_len=MAX_LEN,
                                       chunk=16)
        for r in side.requests([9, 33, 17, 21, 40, 12], max_new=4):
            srv.submit(r)
        srv.step()
        srv.step()
        victim = srv.replicas[1]
        held = sum(s is not None for s in victim.batcher.slot_req)
        sup.fail_column(0, victim.cell.zone.c0)
        got = drained(srv, max_steps=2_000)
        c = counters(side, sup, srv)
        c["held"] = held
        return got, c

    got, c = both(run)
    assert len(got) == 6 and all(len(v) == 4 for v in got.values())
    assert c["held"] >= 1 and c["requeued"] >= 1
    assert c["replicas"] == ["dec0"]
    assert c["kv_transfers"] == 6 + c["requeued"]


def test_sync_attach_detach_roundtrip():
    def run(side):
        sup = side.supervisor(4)
        spec = side.spec(3, min_replicas=1, max_replicas=3)
        sup.apply(spec)
        side.init(sup.cells["decode/0"])
        srv = side.disagg.DisaggServer(sup, "prefill",
                                       spec.cell("decode").instances(),
                                       batch_slots=2, max_len=MAX_LEN,
                                       chunk=16)
        for r in side.requests([9, 33, 17, 21], max_new=4):
            srv.submit(r)
        srv.step()
        outs = []
        for n in (2, 3):
            sup.apply(sup.desired.with_cell(dataclasses.replace(
                sup.desired.cell("decode"), replicas=n)))
            outs.append(srv.sync(sup.desired))
        attached = srv.replicas[-1]
        c = {"sync": outs,
             "fanned_out": attached.cell.serve_params is not None,
             "fresh_kv": sup.find_channel("prefill", "decode/2", "kv")
             is attached.channel}
        got = drained(srv, max_steps=2_000)
        c.update(counters(side, sup, srv))
        return got, c

    got, c = both(run)
    assert c["sync"][0]["detached"] == ["decode/2"]
    assert c["sync"][0]["requeued"] >= 1
    assert c["sync"][1]["attached"] == ["decode/2"]
    assert c["fanned_out"] and c["fresh_kv"]
    assert len(got) == 4 and all(len(v) == 4 for v in got.values())


def test_daemon_recovers_prefill_cell():
    def run(side):
        sup = side.supervisor(4)
        spec = side.spec(2, min_replicas=2, max_replicas=2)
        sup.apply(spec)
        side.init(sup.cells["decode/0"])
        srv = side.disagg.DisaggServer(sup, "prefill",
                                       spec.cell("decode").instances(),
                                       batch_slots=2, max_len=MAX_LEN,
                                       chunk=16)
        daemon = side.core.SupervisorDaemon(sup)
        daemon.attach_server(srv)
        for r in side.requests([9, 33, 17, 21], max_new=4):
            srv.submit(r)
        srv.step()
        daemon.tick()
        old = srv.prefill_cell
        sup.fail_column(0, old.zone.c0)
        got = drained(srv, max_steps=2_000, on_step=daemon.tick)
        c = counters(side, sup, srv)
        c["rebound"] = (srv.prefill_cell is not old
                        and srv.prefill_cell is sup.cells["prefill"]
                        and srv.worker.cell is srv.prefill_cell
                        and srv.prefill_cell.serve_params is not None)
        c["converged"] = sup.reconcile().empty
        return got, c

    got, c = both(run)
    assert len(got) == 4 and all(len(v) == 4 for v in got.values())
    assert c["rebound"] and c["converged"]
    assert c["replicas"] == ["decode/0", "decode/1"]


def test_swa_rolling_cache_falls_back_not_crashes():
    def run(side):
        assert side.cfg.sliding_window == 64
        sup = side.supervisor(2)
        sup.create_cell("prefill", side.cfg, "serve", ncols=1)
        dec = sup.create_cell("decode", side.cfg, "serve", ncols=1)
        side.init(dec)
        with pytest.raises(ValueError):
            side.disagg.PrefillWorker(dec, max_len=96)
        srv = side.disagg.DisaggServer(sup, "prefill", "decode",
                                       batch_slots=2, max_len=96, chunk=16)
        assert srv.worker is None
        for r in side.requests([9, 33, 70], max_new=3):
            srv.submit(r)
        got = drained(srv, max_steps=5_000)
        c = counters(side, sup, srv)
        c["prefill_fallback"] = \
            sup.cells["prefill"].accounting.counters["prefill_fallback"]
        return got, c

    got, c = both(run, arch="mixtral-8x7b")
    assert len(got) == 3 and c["fallback"] == 3 and c["invocations"] == 0
    assert c["prefill_fallback"] == 1


def test_prefill_dummy_row_waste_accounted():
    def run(side):
        sup = side.supervisor(2)
        sup.create_cell("prefill", side.cfg, "serve", ncols=1)
        side.init(sup.create_cell("decode", side.cfg, "serve", ncols=1))
        srv = side.disagg.DisaggServer(sup, "prefill", "decode",
                                       batch_slots=4, max_len=MAX_LEN,
                                       chunk=16)
        for r in side.requests([33, 35, 40], max_new=2):
            srv.submit(r)
        got = drained(srv)
        c = counters(side, sup, srv)
        c["dummy_rows"] = \
            sup.cells["prefill"].accounting.counters["prefill_dummy_rows"]
        return got, c

    got, c = both(run)
    assert c["invocations"] == 1 and c["dummy_rows"] == 1


def test_unservable_prompts_do_not_stall_the_loop():
    def run(side):
        sup = side.supervisor(2)
        sup.create_cell("prefill", side.cfg, "serve", ncols=1)
        side.init(sup.create_cell("decode", side.cfg, "serve", ncols=1))
        srv = side.disagg.DisaggServer(sup, "prefill", "decode",
                                       batch_slots=2, max_len=32, chunk=8)
        good = side.requests([5])[0].prompt
        srv.submit(side.Request(rid=0, prompt=np.array([], np.int32),
                                max_new_tokens=3))
        srv.submit(side.Request(rid=1, prompt=good, max_new_tokens=3))
        srv.submit(side.Request(rid=2, prompt=np.ones(40, np.int32),
                                max_new_tokens=3))
        got = drained(srv)
        c = counters(side, sup, srv)
        st = srv.stats()
        c["front_door"] = st["decode_serving"]["requests"]
        c["rejected"] = len(srv.rejected)
        return got, c

    got, c = both(run)
    assert got[0] == [] and got[2] == [] and len(got[1]) == 3
    assert sum(c["per_replica_requests"]) == 1
    assert c["front_door"] == 3 and c["rejected"] == 2


def test_worker_and_replicas_are_programs_of_their_cells():
    """The prefill worker and each replica's batcher are their cells'
    programs (held weakly): the guard checks them, and a detached
    replica's batcher leaves its cell's programs."""
    side = Side(True, "qwen3-4b")
    sup = side.supervisor(3)
    spec = side.spec(2, min_replicas=1, max_replicas=2)
    sup.apply(spec)
    side.init(sup.cells["decode/0"])
    srv = side.disagg.DisaggServer(sup, "prefill",
                                   spec.cell("decode").instances(),
                                   batch_slots=2, max_len=MAX_LEN, chunk=16)
    assert [p.name for p in sup.cells["prefill"].programs()] == \
        ["serve_params", "prefill_worker0"]
    assert sup.validate_cell_programs("prefill") == 2
    assert [p.name for p in sup.cells["decode/1"].programs()] == \
        ["serve_params", "batcher0"]
    gone = weakref.ref(srv.replicas[1].batcher)
    sup.apply(sup.desired.with_cell(dataclasses.replace(
        sup.desired.cell("decode"), replicas=1)))
    assert srv.sync(sup.desired)["detached"] == ["decode/1"]
    gc.collect()
    assert gone() is None       # the detached batcher went, arena and all
    srv.close()


def test_recover_serve_role_restores_params(tmp_path):
    """recover_cell(ckpt_dir=...) of a serve cell restores its bare params
    (not a train state), and an empty ckpt_dir logs recover_no_ckpt."""
    def run(side):
        d = tmp_path / ("port" if side.port else "jax")
        sup = side.supervisor(2)
        cell = sup.create_cell("srv", side.cfg, "serve", ncols=1)
        side.init(cell)
        ref = side.leaves(cell.serve_params)
        side.ckpt.save(str(d), 7, cell.serve_params)
        cell.status = "failed"
        rec = sup.recover_cell("srv", ckpt_dir=str(d))
        got = side.leaves(rec.serve_params)
        c = {"restored": (rec.status, rec.step, len(got) == len(ref) and all(
            np.array_equal(a, b) for a, b in zip(ref, got)))}
        rec.status = "failed"
        rec2 = sup.recover_cell("srv", ckpt_dir=str(d / "empty"))
        c["empty"] = rec2.serve_params is None
        c["ops"] = [e["op"] for e in sup.events]
        return {}, c

    _, c = both(run)
    assert c["restored"] == ("running", 7, True) and c["empty"]
    assert c["ops"].count("restore_ckpt") == 1
    assert c["ops"][-2:] == ["recover_no_ckpt", "recover"]


def test_daemon_e2e_kill_recover_reattach(tmp_path):
    """With traffic flowing, fail_column on a decode replica: the daemon
    recovers the cell, restoring its params from the spec's ckpt_dir,
    DisaggServer.sync re-attaches it, no request is lost and the SLO tail
    reconverges; nothing here calls a primitive."""
    def run(side):
        c = side.core
        d = tmp_path / ("port" if side.port else "jax")
        sup = side.supervisor(4)
        slo = c.SLOTarget(ttft_p99=60.0, tpot_p99=60.0)  # generous: wall clock
        spec = side.spec(2, min_replicas=2, max_replicas=2, slo=slo,
                         ckpt_dir=str(d))
        sup.apply(spec)                  # 1 spare column for recovery
        side.init(sup.cells["decode/0"])
        srv = side.disagg.DisaggServer(sup, "prefill",
                                       spec.cell("decode").instances(),
                                       batch_slots=2, max_len=MAX_LEN,
                                       chunk=16)
        side.ckpt.save(str(d), 3, sup.cells["decode/0"].serve_params)
        daemon = c.SupervisorDaemon(sup)
        daemon.attach_server(srv)
        pol = daemon.add_slo_policy("decode", autoscale_replicas=True,
                                    queue_depth=lambda: len(srv.pending),
                                    queue_high=64)
        for r in side.requests([9, 33, 17, 21, 40, 12, 28, 35], max_new=4):
            srv.submit(r)
        for _ in range(2):
            srv.step()
            daemon.tick()
        victim = srv.replicas[1].cell
        affected = sup.fail_column(0, victim.zone.c0)
        got = drained(srv, max_steps=2_000, on_step=daemon.tick)
        out = counters(side, sup, srv)
        ops = [e["op"] for e in sup.events]
        out["recovered"] = (
            victim.name in affected
            and sup.cells[victim.name] is not victim
            and all(rep.cell.status == "running" for rep in srv.replicas)
            and ("recover" in ops
                 or "create" in ops[ops.index("fail_column"):])
            and any(e["op"] == "restore_ckpt" and e["cell"] == victim.name
                    for e in sup.events))
        for r in side.requests([11, 22], max_new=4, seed=1, rid0=100):
            srv.submit(r)
        got.update(drained(srv, max_steps=2_000, on_step=daemon.tick))
        pol.pull()
        tail = pol.replica_tail()
        out["tail_ok"] = tail is not None and tail < slo.tpot_p99
        out["converged"] = sup.reconcile().empty
        return got, out

    got, c = both(run)
    assert sorted(got) == list(range(8)) + [100, 101]
    assert all(len(v) == 4 for v in got.values())
    assert c["replicas"] == ["decode/0", "decode/1"]
    assert c["recovered"] and c["tail_ok"] and c["converged"]
