"""Per-cell flight recorder — request-path tracing, decision audit, export.

The paper makes accounting *exact* by making ownership exact: a subOS
owns its resources, so attribution is unambiguous.  `CellAccounting`
already exploits that for FLOPs/bytes; this module extends the same
principle to *time* and *decisions*:

* **Isolate first** — every cell records spans, events and latency
  sketches into its own bounded :class:`FlightRecorder` ring buffer.
  There is zero cross-cell shared state: span ids are scoped per
  recorder, clocks are injectable per recorder, and a cell that dies
  takes nothing from any other cell's log.
* **Then share** — the supervisor aggregates on demand over the
  existing control plane (:func:`collect_traces` mirrors the
  ``CachePlane.refresh`` advert round): each cell ships its *metadata*
  (span dicts, histogram buckets) as unicast messages to a
  supervisor-held endpoint; no recorder object ever crosses a cell
  boundary.  XOS (arXiv:1901.00825) makes the identical split —
  telemetry metadata in the trusted global plane, collection strictly
  application-owned.

One request yields ONE span tree.  The trace id is the request id; the
root ``request`` span is opened at the front door (the prefill cell in
disagg mode, the batcher's own cell colocated) and the *handle* rides
with the `Request` object across cells — like the request's latency
stamps already do — so whichever cell finishes (or sheds, or rejects)
the request closes the root.  Each span carries a backref to the
recorder that opened it; closing a span only ever touches that one
recorder, preserving isolation.

`HistogramSketch` is a DDSketch-style log-bucket histogram: O(1)
record, O(buckets) quantile, mergeable across cells — tail percentiles
(p50/p99/p99.9) stop being O(n) re-scans of the full request list.

`DecisionAudit` is the daemon's black box: every tick records the SLO
signals observed (ttft/tpot tails, queue depth, pool occupancy) and
each action taken with a human-readable reason
(``scale replicas 2->3: tpot_p99 0.0312 > ut 0.0250``), queryable
after the fact and folded into the Chrome trace export.

:func:`chrome_trace` emits the Chrome trace-event JSON format (the
``{"traceEvents": [...]}`` object form) — loadable in Perfetto /
``chrome://tracing``: one pid per cell, one tid per request (the trace
id), ``ph="X"`` complete events with microsecond ``ts``/``dur``.
"""
from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional


class TraceContext:
    """The propagated identity of a span: ``(trace_id, span_id)``.

    ``trace_id`` is the request id; ``span_id`` names a span within the
    recorder that opened it.  This is the only thing that crosses a
    cell boundary when a child span is opened remotely — two ints/strs,
    never a live object."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


class Span:
    """One timed interval in a trace tree.

    Opened by :meth:`FlightRecorder.start_span`; closed by :meth:`end`.
    The backref ``_rec`` pins every mutation to the recorder that owns
    the span — a span handle may *ride* with a request across cells,
    but its storage never leaves its home cell."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "ts", "dur",
                 "attrs", "cell", "_rec")

    def __init__(self, name: str, trace_id, span_id: str,
                 parent_id: Optional[str], ts: float, cell: str, rec,
                 attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts = ts
        self.dur: Optional[float] = None     # None while open
        self.attrs = dict(attrs) if attrs else {}
        self.cell = cell
        self._rec = rec

    @property
    def open(self) -> bool:
        return self.dur is None

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def end(self, now: Optional[float] = None, **attrs):
        """Close the span (idempotent).  ``now`` overrides the owning
        recorder's clock for deterministic tests."""
        if self.dur is not None:
            return self
        t1 = self._rec.clock() if now is None else now
        self.dur = max(t1 - self.ts, 0.0)
        if attrs:
            self.attrs.update(attrs)
        self._rec._close(self)
        return self

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "ts": self.ts, "dur": self.dur, "cell": self.cell,
                "attrs": dict(self.attrs)}


class _NullSpan:
    """The span returned by a disabled recorder: every operation no-ops
    so instrumentation sites never branch on enablement."""

    __slots__ = ()
    name = "null"
    trace_id = None
    span_id = "null/0"
    parent_id = None
    ts = 0.0
    dur = 0.0
    attrs: dict = {}
    cell = "null"
    open = False

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(None, self.span_id)

    def end(self, now=None, **attrs):
        return self


NULL_SPAN = _NullSpan()


class EventLog:
    """Bounded ring buffer of span/event dicts.

    A cell's telemetry must never grow without bound (the recorder sits
    on the serving path): the ring keeps the most recent ``capacity``
    entries and counts what it dropped, so a reader can tell a complete
    log from a truncated one."""

    __slots__ = ("_ring", "appended")

    def __init__(self, capacity: int = 4096):
        self._ring: deque = deque(maxlen=capacity)
        self.appended = 0

    def append(self, item):
        self._ring.append(item)
        self.appended += 1

    @property
    def dropped(self) -> int:
        return self.appended - len(self._ring)

    def drain(self) -> list:
        out = list(self._ring)
        self._ring.clear()
        return out

    def __len__(self):
        return len(self._ring)

    def __iter__(self):
        return iter(self._ring)


class HistogramSketch:
    """Log-bucket histogram (DDSketch-flavoured): values land in bucket
    ``ceil(log(v)/log(gamma))``, giving a guaranteed relative error of
    ``(gamma-1)/(gamma+1)`` per quantile at O(1) record cost.  Buckets
    merge by index, so per-cell sketches combine across replicas (and
    across a detached replica's folded-in history) without re-scanning
    any request list."""

    __slots__ = ("gamma", "_lg", "buckets", "zeros", "count",
                 "total", "vmin", "vmax")

    def __init__(self, rel_err: float = 0.01):
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self.gamma)
        self.buckets: Dict[int, int] = {}
        self.zeros = 0           # non-positive values get their own bin
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float, n: int = 1):
        value = float(value)
        self.count += n
        self.total += value * n
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        if value <= 0.0:
            self.zeros += n
            return
        idx = math.ceil(math.log(value) / self._lg)
        self.buckets[idx] = self.buckets.get(idx, 0) + n

    def merge(self, other: "HistogramSketch"):
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.zeros += other.zeros
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1] (None when empty).  Walks
        the sorted bucket indices once; rank semantics match
        ``np.percentile(..., interpolation='higher')`` up to the
        sketch's relative-error guarantee."""
        if self.count == 0:
            return None
        rank = min(max(int(math.ceil(q * self.count)), 1), self.count)
        if rank <= self.zeros:
            return max(min(0.0, self.vmax), self.vmin)
        seen = self.zeros
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                # bucket idx covers (gamma^(idx-1), gamma^idx]; return
                # the midpoint estimate, clamped to observed extremes
                est = 2.0 * self.gamma ** idx / (self.gamma + 1.0)
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
        }

    def to_dict(self) -> dict:
        return {"gamma": self.gamma, "zeros": self.zeros,
                "count": self.count, "total": self.total,
                "vmin": None if self.count == 0 else self.vmin,
                "vmax": None if self.count == 0 else self.vmax,
                "buckets": {str(k): v for k, v in self.buckets.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "HistogramSketch":
        h = cls()
        h.gamma = d["gamma"]
        h._lg = math.log(h.gamma)
        h.zeros = d["zeros"]
        h.count = d["count"]
        h.total = d["total"]
        h.vmin = math.inf if d["vmin"] is None else d["vmin"]
        h.vmax = -math.inf if d["vmax"] is None else d["vmax"]
        h.buckets = {int(k): v for k, v in d["buckets"].items()}
        return h


class FlightRecorder:
    """A cell's private telemetry plane: spans + events + sketches.

    * ``clock`` is injectable (default ``time.monotonic``) so tests can
      drive deterministic timestamps.
    * span ids are ``"{cell}/{n}"`` with a per-recorder counter — no
      global id state, so two cells can never contend or collide.
    * ``enabled=False`` turns every operation into a no-op returning
      :data:`NULL_SPAN` (a batcher built without accounting gets the
      shared disabled recorder, :data:`DISABLED`).
    """

    def __init__(self, cell: str, *, clock: Callable[[], float] = time.monotonic,
                 capacity: int = 4096, enabled: bool = True):
        self.cell = cell
        self.clock = clock
        self.enabled = enabled
        self.log = EventLog(capacity)
        self.hists: Dict[str, HistogramSketch] = {}
        self._open: Dict[str, Span] = {}
        self._n = 0

    # -- spans ---------------------------------------------------------

    def start_span(self, name: str, trace_id=None,
                   parent: Optional[TraceContext] = None,
                   ts: Optional[float] = None, **attrs):
        if not self.enabled:
            return NULL_SPAN
        self._n += 1
        span = Span(
            name, trace_id, f"{self.cell}/{self._n}",
            parent.span_id if parent is not None else None,
            self.clock() if ts is None else ts, self.cell, self, attrs)
        self._open[span.span_id] = span
        return span

    def _close(self, span: Span):
        self._open.pop(span.span_id, None)
        self.log.append(span.to_dict())

    def add_complete(self, name: str, ts: float, dur: float, trace_id=None,
                     parent: Optional[TraceContext] = None, **attrs) -> None:
        """Record an already-finished interval in one call (batched
        invocations: one measured interval, one span per request)."""
        if not self.enabled:
            return
        self._n += 1
        self.log.append({
            "name": name, "trace_id": trace_id,
            "span_id": f"{self.cell}/{self._n}",
            "parent_id": parent.span_id if parent is not None else None,
            "ts": ts, "dur": max(dur, 0.0), "cell": self.cell,
            "attrs": dict(attrs)})

    @property
    def open_spans(self) -> List[Span]:
        return list(self._open.values())

    # -- scalars -------------------------------------------------------

    def record(self, name: str, value: float):
        if not self.enabled:
            return
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = HistogramSketch()
        h.record(value)

    # -- export --------------------------------------------------------

    def dump(self, reset: bool = False) -> dict:
        """The cell's telemetry metadata, as a plain dict safe to ship
        over the control plane.  ``reset=True`` drains the ring (used
        when a cell is detached and its history folds into the
        server-side archive)."""
        events = self.log.drain() if reset else list(self.log)
        out = {"cell": self.cell, "events": events,
               "dropped": self.log.dropped,
               "open_spans": [s.to_dict() for s in self._open.values()],
               "hists": {k: h.to_dict() for k, h in self.hists.items()}}
        if reset:
            self.hists = {}
        return out

    def summary(self) -> Dict[str, dict]:
        return {k: h.summary() for k, h in self.hists.items()}


#: Shared no-op recorder for instrumentation sites whose accounting is
#: absent (standalone batchers in unit tests pass ``accounting=None``).
DISABLED = FlightRecorder("disabled", enabled=False, capacity=1)


def recorder_of(accounting) -> FlightRecorder:
    """The recorder behind a ``CellAccounting`` (or :data:`DISABLED`
    when there is none) — the single lookup every instrumentation site
    uses, so sites never branch on wiring."""
    if accounting is None:
        return DISABLED
    return getattr(accounting, "recorder", None) or DISABLED


# -- request-scoped span helpers --------------------------------------
#
# The span tree of one request:
#
#   request                      (root; front-door cell)
#     queue                      (submit -> admit, re-opened on requeue)
#     route                      (disagg only: warm/cold decision)
#     prefill                    (cold | warm | warm_snapshot group)
#     channel:kv                 (disagg only: KV handoff bytes)
#     decode                     (admit-to-finish on the decode cell)
#     finish                     (zero-dur marker with ttft/tpot)
#
# The helpers stash live handles on the Request object itself
# (``req._tspans``) — the request already carries its latency stamps
# across cells, so its span handles ride the same way.

def open_request(rec: FlightRecorder, req, ts: Optional[float] = None):
    """Open the root ``request`` span plus its ``queue`` child at the
    front door.  No-op (returns the existing root) when the request
    already has one — resubmission via requeue must not fork the tree."""
    spans = getattr(req, "_tspans", None)
    if spans is not None and "request" in spans:
        return spans["request"]
    if ts is None:
        ts = getattr(req, "submitted_at", None)
    root = rec.start_span("request", trace_id=req.rid, ts=ts,
                          prompt_len=len(req.prompt),
                          tenant=getattr(req, "tenant", None))
    queue = rec.start_span("queue", trace_id=req.rid, parent=root.ctx,
                           ts=ts)
    req._tspans = {"request": root, "queue": queue}
    return root


def mark_admitted(req, ts: Optional[float] = None, **attrs):
    """Close the open ``queue`` span — the request got a slot."""
    spans = getattr(req, "_tspans", None)
    if spans:
        q = spans.pop("queue", None)
        if q is not None:
            q.end(now=ts, **attrs)


def open_decode(rec: FlightRecorder, req, ts: Optional[float] = None):
    """Open the ``decode`` span on the cell that owns the slot."""
    spans = getattr(req, "_tspans", None)
    if spans is None or "request" not in spans:
        return NULL_SPAN
    if "decode" in spans:
        return spans["decode"]
    d = rec.start_span("decode", trace_id=req.rid,
                       parent=spans["request"].ctx, ts=ts)
    spans["decode"] = d
    return d


def requeue_request(rec: FlightRecorder, req, reason: str,
                    ts: Optional[float] = None):
    """The request bounced back to the front door: close whatever phase
    was open (outcome recorded) and start a fresh ``queue`` wait."""
    spans = getattr(req, "_tspans", None)
    if not spans or "request" not in spans:
        return
    for phase in ("decode", "queue"):
        s = spans.pop(phase, None)
        if s is not None:
            s.end(now=ts, outcome=reason)
    spans["queue"] = rec.start_span("queue", trace_id=req.rid,
                                    parent=spans["request"].ctx, ts=ts,
                                    reason=reason)


def migrate_decode(req, new_rec: FlightRecorder,
                   ts: Optional[float] = None):
    """A drained slot moved replica-to-replica: the victim's decode
    span closes (``outcome="migrated"``) and a fresh one opens on the
    survivor — each half stored on the cell that actually ran it."""
    spans = getattr(req, "_tspans", None)
    if not spans or "request" not in spans:
        return
    old = spans.pop("decode", None)
    if old is not None:
        old.end(now=ts, outcome="migrated")
    spans["decode"] = new_rec.start_span(
        "decode", trace_id=req.rid, parent=spans["request"].ctx, ts=ts,
        migrated=True)


def finish_request(req, ts: Optional[float] = None, outcome: str = "ok"):
    """Close the request's whole tree: any open decode/queue child, a
    zero-duration ``finish`` marker with the latency stamps, then the
    root.  Safe to call for rejected/shed requests that never admitted."""
    spans = getattr(req, "_tspans", None)
    if not spans:
        return
    root = spans.get("request")
    if root is None or not root.open:
        return
    for phase in ("decode", "queue"):
        s = spans.pop(phase, None)
        if s is not None:
            s.end(now=ts, outcome=outcome)
    rec = root._rec
    end_ts = (rec.clock() if ts is None else ts)
    ttft = getattr(req, "ttft", None)
    tpot = getattr(req, "tpot", None)
    rec.add_complete("finish", end_ts, 0.0, trace_id=req.rid,
                     parent=root.ctx, outcome=outcome, ttft=ttft,
                     tpot=tpot,
                     new_tokens=len(getattr(req, "output", ()) or ()))
    root.end(now=end_ts, outcome=outcome)
    if ttft is not None:
        rec.record("ttft_s", ttft)
    if tpot is not None:
        rec.record("tpot_s", tpot)


def span_group(rec: FlightRecorder, name: str, reqs, t0: float, t1: float,
               parent_key: str = "request", **attrs):
    """One measured interval, one span per request (batched prefill /
    extend / restore invocations cover several requests at once)."""
    if not rec.enabled:
        return
    for r in reqs:
        spans = getattr(r, "_tspans", None)
        parent = None
        if spans and parent_key in spans:
            parent = spans[parent_key].ctx
        rec.add_complete(name, t0, t1 - t0, trace_id=r.rid,
                         parent=parent, **attrs)


# -- daemon decision audit --------------------------------------------

class DecisionAudit:
    """The daemon's black box: one bounded entry per tick holding the
    SLO signals observed and every action taken with its reason.

    Queryable after the fact (:meth:`query`) and folded into the Chrome
    trace export as instant events on the daemon's pid."""

    def __init__(self, capacity: int = 2048):
        self.log = EventLog(capacity)

    def record(self, tick: int, ts: float, signals: dict,
               actions: List[dict]):
        self.log.append({"tick": tick, "ts": ts,
                         "signals": dict(signals),
                         "actions": [dict(a) for a in actions]})

    def entries(self) -> List[dict]:
        return list(self.log)

    def query(self, kind: Optional[str] = None,
              cell: Optional[str] = None) -> List[dict]:
        """Flattened actions (each tagged with its tick/ts/signals),
        optionally filtered by action ``kind`` substring and/or cell."""
        out: List[dict] = []
        for e in self.log:
            for a in e["actions"]:
                if kind is not None and kind not in a.get("kind", ""):
                    continue
                if cell is not None and cell != a.get("cell"):
                    continue
                out.append({"tick": e["tick"], "ts": e["ts"],
                            "signals": e["signals"], **a})
        return out


# -- control-plane collection + Chrome export -------------------------

TELEMETRY_ENDPOINT = "telemetry"
TELEMETRY_DUMP = "telemetry_dump"


def collect_traces(supervisor, recorders: Dict[str, FlightRecorder],
                   ) -> List[dict]:
    """One collection round over the supervisor's control plane,
    mirroring ``CachePlane.refresh``: each cell unicasts its
    :meth:`FlightRecorder.dump` (metadata only) to the supervisor-held
    ``telemetry`` endpoint, which drains and returns the dumps.  Falls
    back to direct dumps when no supervisor is wired (colocated
    single-cell runs)."""
    if supervisor is None:
        return [rec.dump() for rec in recorders.values()]
    supervisor.control.register(TELEMETRY_ENDPOINT)
    for name, rec in recorders.items():
        supervisor.control.unicast(name, TELEMETRY_ENDPOINT,
                                   TELEMETRY_DUMP, rec.dump())
    return [msg.payload for msg in supervisor.control.drain(TELEMETRY_ENDPOINT)
            if msg.kind == TELEMETRY_DUMP]


def chrome_trace(dumps: Iterable[dict],
                 audit: Optional[DecisionAudit] = None) -> dict:
    """Chrome trace-event JSON (object form) from recorder dumps.

    One pid per cell, tid = trace id (the request id; 0 for untraced
    events), ``ph="X"`` complete events with microsecond timestamps
    offset from the earliest event, plus ``ph="M"`` process-name
    metadata and ``ph="i"`` instants for audit actions.  Every event
    carries ``ph``/``ts``/``pid``/``tid``."""
    dumps = list(dumps)
    events: List[dict] = []
    pids: Dict[str, int] = {}
    t0 = math.inf
    for d in dumps:
        for ev in list(d.get("events", ())) + list(d.get("open_spans", ())):
            if ev["ts"] < t0:
                t0 = ev["ts"]
    if audit is not None:
        for e in audit.entries():
            if e["ts"] < t0:
                t0 = e["ts"]
    if not math.isfinite(t0):
        t0 = 0.0

    def pid_of(cell: str) -> int:
        pid = pids.get(cell)
        if pid is None:
            pid = pids[cell] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "ts": 0,
                           "args": {"name": f"cell:{cell}"}})
        return pid

    for d in dumps:
        pid = pid_of(d.get("cell", "?"))
        for ev in d.get("events", ()):
            tid = ev.get("trace_id")
            events.append({
                "ph": "X", "name": ev["name"], "pid": pid,
                "tid": int(tid) if tid is not None else 0,
                "ts": (ev["ts"] - t0) * 1e6,
                "dur": (ev.get("dur") or 0.0) * 1e6,
                "args": {**ev.get("attrs", {}),
                         "span_id": ev.get("span_id"),
                         "parent_id": ev.get("parent_id")},
            })
        for ev in d.get("open_spans", ()):
            tid = ev.get("trace_id")
            events.append({
                "ph": "X", "name": ev["name"] + " (open)", "pid": pid,
                "tid": int(tid) if tid is not None else 0,
                "ts": (ev["ts"] - t0) * 1e6, "dur": 0.0,
                "args": {**ev.get("attrs", {}), "open": True,
                         "span_id": ev.get("span_id"),
                         "parent_id": ev.get("parent_id")},
            })
    audit_entries: List[dict] = []
    if audit is not None:
        pid = pid_of("daemon")
        for e in audit.entries():
            audit_entries.append(e)
            for a in e["actions"]:
                events.append({
                    "ph": "i", "name": a.get("kind", "action"), "pid": pid,
                    "tid": 0, "ts": (e["ts"] - t0) * 1e6, "s": "g",
                    "args": {**{k: v for k, v in a.items()},
                             "tick": e["tick"]},
                })
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"origin_ts": t0}}
    if audit is not None:
        out["otherData"]["decision_audit"] = audit_entries
    return out


def write_trace(path: str, trace: dict):
    with open(path, "w") as f:
        json.dump(trace, f)
