"""The port's flight recorder and accounting against the JAX ones (CPU).

* On a fake clock the same operations through both packages give equal
  recorder dumps (spans, events, histograms, open spans, drops), equal
  sketch quantiles and ``to_dict`` round trips, equal request span trees
  from the request helpers, equal decision audits and equal Chrome
  traces.
* Served on the CPU (float32 qwen3-4b smoke, weights from JAX's
  ``Model.init(PRNGKey(0))`` through ``params_from_numpy``), the same
  requests through the JAX and the port batcher, each with its package's
  ``CellAccounting``, leave span trees with the same names, span ids,
  parent links, request ids and non-time attributes (structure, not
  times), and the same histogram names.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.core import accounting as j_accounting  # noqa: E402
from repro.core import channels as j_channels  # noqa: E402
from repro.core import telemetry as j_tel  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.serve.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.batcher import Request as JRequest  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.core import accounting as t_accounting  # noqa: E402
from repro_torch.core import channels as t_channels  # noqa: E402
from repro_torch.core import telemetry as t_tel  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.serve.batcher import Request  # noqa: E402

PACKAGES = {"jax": (j_tel, j_accounting, j_channels),
            "port": (t_tel, t_accounting, t_channels)}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt=0.25):
        self.t += dt


def _both(fn):
    """``fn(tel, acc, ch)`` through each package; returns [jax, port]."""
    return [fn(*PACKAGES[k]) for k in ("jax", "port")]


# ---------------------------------------------------------------------------
# recorder, ring, sketch
# ---------------------------------------------------------------------------
def _recorder_script(tel, acc, ch):
    clock = Clock()
    rec = tel.FlightRecorder("cellA", clock=clock, capacity=6)
    root = rec.start_span("request", trace_id=7, prompt_len=12)
    clock.tick()
    child = rec.start_span("queue", trace_id=7, parent=root.ctx)
    clock.tick(0.75)
    child.end(outcome="admitted")
    rec.add_complete("decode_step", clock(), 0.125, busy=3)
    for i in range(7):                   # overflow the ring (capacity 6)
        clock.tick(0.01)
        rec.add_complete("tick", clock(), 0.001 * i, trace_id=i)
    still_open = rec.start_span("decode", trace_id=7, parent=root.ctx)
    for v in (0.001, 0.02, 0.3, 0.3, 4.0, 0.0, -1.0):
        rec.record("lat", v)
    root.end()
    root.end()                           # idempotent
    off = tel.FlightRecorder("off", enabled=False)
    s = off.start_span("x", trace_id=1)
    s.end()
    off.add_complete("y", 0.0, 1.0)
    off.record("lat", 0.5)
    return (rec.dump(), rec.summary(), rec.log.dropped,
            [s.to_dict() for s in rec.open_spans], still_open.open,
            (len(off.log), off.hists, off.open_spans, s.ctx.span_id),
            tel.recorder_of(None).enabled, rec.dump(reset=True),
            rec.dump())


def test_recorder_dump_matches_jax():
    jx, pt = _both(_recorder_script)
    assert jx[0]["events"] and jx[0]["hists"]
    assert pt == jx


def _sketch_script(tel, acc, ch):
    rng = np.random.RandomState(0)
    xs = rng.lognormal(mean=-3.0, sigma=1.0, size=5000)
    h = tel.HistogramSketch(rel_err=0.01)
    for x in xs:
        h.record(x)
    qs = [h.quantile(q) for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0)]
    d = json.loads(json.dumps(h.to_dict()))
    back = tel.HistogramSketch.from_dict(d)
    other = tel.HistogramSketch()
    for x in np.linspace(0.001, 1.0, 300):
        other.record(x, n=2)
    back.merge(other)
    z = tel.HistogramSketch()
    empty = (z.quantile(0.5), z.summary(), z.to_dict())
    z.record(0.0)
    z.record(-1.0)
    return (qs, h.summary(), d, back.to_dict(), back.quantile(0.5),
            back.summary(), empty, z.quantile(0.5), z.summary())


def test_histogram_sketch_matches_jax():
    jx, pt = _both(_sketch_script)
    assert pt == jx
    # the round trip is exact in the port
    h = t_tel.HistogramSketch()
    for x in (0.5, 0.25, 3.0):
        h.record(x)
    assert t_tel.HistogramSketch.from_dict(
        json.loads(json.dumps(h.to_dict()))).to_dict() == h.to_dict()


def _event_log_script(tel, acc, ch):
    log = tel.EventLog(capacity=4)
    for i in range(10):
        log.append({"i": i})
    return len(log), log.dropped, list(log), log.drain(), len(log)


def test_event_log_matches_jax():
    jx, pt = _both(_event_log_script)
    assert jx[1] == 6 and pt == jx


# ---------------------------------------------------------------------------
# request helpers, audit, collection, Chrome export
# ---------------------------------------------------------------------------
def _req(rid, n=8, tenant=None):
    return types.SimpleNamespace(rid=rid, prompt=np.ones(n, np.int32),
                                 submitted_at=None, tenant=tenant,
                                 ttft=None, tpot=None, output=[])


def _helpers_script(tel, acc, ch):
    clock = Clock()
    front = tel.FlightRecorder("front", clock=clock)
    dec = tel.FlightRecorder("decode", clock=clock)
    other = tel.FlightRecorder("decode2", clock=clock)
    reqs = [_req(i, 4 + i, tenant="t0" if i % 2 else None) for i in range(4)]
    for r in reqs:
        r.submitted_at = clock()
        tel.open_request(front, r)
        tel.open_request(front, r)       # idempotent
        clock.tick(0.1)
    tel.mark_admitted(reqs[0], slot=1, prefix_hit=16)
    tel.mark_admitted(reqs[1], slot=0, prefix_hit=0)
    tel.span_group(front, "prefill", reqs[:2], clock(), clock() + 0.5,
                   kind="cold", batch=2)
    clock.tick(0.5)
    for r in reqs[:2]:
        tel.open_decode(dec, r, ts=clock())
    tel.requeue_request(front, reqs[1], "drained", ts=clock())
    tel.mark_admitted(reqs[1], slot=3)
    tel.open_decode(dec, reqs[1])
    clock.tick()
    tel.migrate_decode(reqs[1], other, ts=clock())
    for i, r in enumerate(reqs):
        clock.tick(0.05)
        r.ttft, r.tpot, r.output = 0.1 * (i + 1), 0.01 * (i + 1), [1, 2, 3]
        tel.finish_request(r, ts=None if i % 2 else clock(),
                           outcome="ok" if i < 3 else "shed")
    tel.finish_request(reqs[0], ts=999.0)      # idempotent
    tel.open_decode(dec, _req(99))             # no root: the null span
    return [rec.dump() for rec in (front, dec, other)]


def test_request_helpers_match_jax():
    jx, pt = _both(_helpers_script)
    assert pt == jx
    front = pt[0]
    assert not front["open_spans"]
    assert [e["name"] for e in front["events"]].count("request") == 4


def _audit_script(tel, acc, ch):
    audit = tel.DecisionAudit(capacity=3)
    audit.record(0, 1.0, {"decode": {"queue_depth": 7}},
                 [{"kind": "grow_replicas", "cell": "decode",
                   "reason": "scale replicas 2->3: queue_depth 7 > 4"}])
    audit.record(1, 2.0, {}, [{"kind": "plan:recover", "cell": "decode/1",
                               "reason": "reconcile: recover decode/1 [ok]"}])
    audit.record(2, 3.0, {"a": {"tail": 0.3}}, [])
    audit.record(3, 4.0, {}, [{"kind": "shrink_server", "cell": "a",
                               "reason": "shrink a cols 3->2"}])
    return (audit.entries(), audit.query(kind="grow"),
            audit.query(cell="decode/1"), audit.query(kind="plan", cell="a"),
            audit.query(), audit.log.dropped)


def test_decision_audit_matches_jax():
    jx, pt = _both(_audit_script)
    assert pt == jx


def _chrome_script(tel, acc, ch):
    clock = Clock()
    recs = {name: tel.FlightRecorder(name, clock=clock)
            for name in ("prefill", "decode")}
    for rid in range(3):
        root = recs["prefill"].start_span("request", trace_id=rid)
        clock.tick(0.01)
        recs["decode"].add_complete("decode", clock(), 0.02, trace_id=rid,
                                    parent=root.ctx, slot=rid)
        if rid < 2:
            root.end()
    recs["decode"].add_complete("decode_step", clock(), 0.003, busy=2)
    audit = tel.DecisionAudit()
    audit.record(0, clock() + 1.0, {}, [{"kind": "mark_failed",
                                         "cell": "decode/1",
                                         "reason": "heartbeat stale"}])
    sup = types.SimpleNamespace(control=ch.ControlPlane())
    dumps = tel.collect_traces(sup, recs)
    direct = tel.collect_traces(None, recs)
    return (tel.chrome_trace(dumps, audit=audit), tel.chrome_trace(direct),
            tel.chrome_trace([], audit=audit), dict(sup.control.stats))


def test_chrome_trace_matches_jax(tmp_path):
    jx, pt = _both(_chrome_script)
    assert pt == jx
    trace = pt[0]
    path = tmp_path / "trace.json"
    t_tel.write_trace(str(path), trace)
    loaded = json.loads(path.read_text())
    assert loaded == json.loads(json.dumps(trace))
    for ev in loaded["traceEvents"]:
        assert {"ph", "ts", "pid", "tid"} <= set(ev)
    assert {ev["args"]["name"] for ev in loaded["traceEvents"]
            if ev["ph"] == "M"} == {"cell:prefill", "cell:decode",
                                    "cell:daemon"}


def _accounting_script(tel, acc, ch):
    a = acc.CellAccounting("c")
    for i in range(20):
        a.record_request(i, ttft=0.01 * (i + 1), tpot=0.001 * (20 - i),
                         prompt_len=i, new_tokens=4,
                         tenant=("paid", "free", None)[i % 3])
    a.record_counter("prefill_dummy_rows", 3)
    a.record_counter("pages_evicted", tenant="paid")
    a.record_gauge("pages_in_use", 5)
    a.record_gauge("pages_in_use", 9, tenant="t0")
    return (a.serving_summary(), a.tenant_summary(),
            a.tenant_percentile("ttft", 99, "paid"),
            a.tenant_percentile("tpot", 50), a.counters, a.tenant_counters,
            acc.summarize_requests([]), a.totals(),
            a.recorder.cell, a.recorder.enabled)


def test_accounting_matches_jax():
    jx, pt = _both(_accounting_script)
    assert pt == jx


def test_register_program_takes_costs():
    """The port's register_program takes the costs the JAX package reads
    from a compiled executable; totals scale them by invocations."""
    a = t_accounting.CellAccounting("c")
    pc = a.register_program("step", flops=2.0e9, bytes=3.0e6, arg_bytes=10,
                            temp_bytes=4, collective={"all-reduce": 8})
    a.record_invocation("step", 10)
    a.record_invocation("ghost", 3)
    assert (pc.arg_bytes, pc.temp_bytes, pc.total_collective_bytes) == \
        (10, 4, 8)
    assert a.totals() == {"flops": 2.0e10, "bytes": 3.0e7,
                          "collective_bytes": 80.0}


# ---------------------------------------------------------------------------
# the batchers' span trees (CPU, float32)
# ---------------------------------------------------------------------------
MAX_LEN = 32
CHUNK = 8
PAGE = 8
_MODELS = {}


def _models():
    if not _MODELS:
        jcfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
        tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32")
        jm = build_model(jcfg, single_device_ctx())
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=torch.float32, device="cpu")
        _MODELS["m"] = (jm, jp, Model(tcfg), tp)
    return _MODELS["m"]


def _waves(cls, vocab):
    """Wave 1: two cold prompts sharing an 18-token prefix and a third
    that hits it; wave 2: two more hits."""
    sysp = np.random.RandomState(1234).randint(1, vocab, size=18)
    out = []
    for seed, rid0, lens in ((0, 0, [3, 5, 2]), (5, 10, [4, 7])):
        rng = np.random.RandomState(seed)
        out.append([cls(rid=rid0 + i, max_new_tokens=4, prompt=np.concatenate(
            [sysp, rng.randint(1, vocab, size=L)]).astype(np.int32))
            for i, L in enumerate(lens)])
    return out


def _structure(dump) -> list:
    """The span tree without times: (name, trace id, span id, parent id,
    the attributes that are not times)."""
    timed = {"ttft", "tpot"}
    return [(e["name"], e["trace_id"], e["span_id"], e["parent_id"],
             {k: v for k, v in sorted(e["attrs"].items()) if k not in timed})
            for e in dump["events"]]


def _serve(port: bool, kw: dict):
    jm, jp, tm, tp = _models()
    if port:
        acc = t_accounting.CellAccounting("solo")
        bat = ContinuousBatcher(tm, tp, batch_slots=2, max_len=MAX_LEN,
                                accounting=acc, device="cpu", **kw)
        cls = Request
    else:
        acc = j_accounting.CellAccounting("solo")
        bat = JBatcher(jm, jp, batch_slots=2, max_len=MAX_LEN,
                       accounting=acc, **kw)
        cls = JRequest
    for wave in _waves(cls, jm.cfg.vocab):
        for r in wave:
            bat.submit(r)
        bat.run_until_drained()
    rec = acc.recorder
    return ({r.rid: r.output for r in bat.done}, rec.dump(),
            sorted(rec.hists), [s.name for s in rec.open_spans],
            acc.counters)


CASES = {
    "paged": dict(prefill_chunk=CHUNK, page_size=PAGE),
    "dense": dict(prefill_chunk=CHUNK, kv_pool=None),
    "token_at_a_time": dict(prefill_chunk=None, page_size=PAGE),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batcher_span_trees_match_jax(case):
    jx = _serve(False, CASES[case])
    pt = _serve(True, CASES[case])
    assert pt[0] == jx[0]                         # same tokens
    assert pt[3] == jx[3] == []                   # no span left open
    assert _structure(pt[1]) == _structure(jx[1])
    assert pt[2] == jx[2]                         # the same histograms
    assert pt[4] == jx[4]                         # the same counters
    names = {e["name"] for e in pt[1]["events"]}
    assert {"request", "queue", "decode", "finish", "decode_step"} <= names
    roots = {e["trace_id"] for e in pt[1]["events"] if e["name"] == "request"}
    assert roots == set(pt[0])
