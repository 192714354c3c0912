"""Per-cell resource accounting.

The paper argues the subOS abstraction makes accounting *exact*: a subOS
owns its resources, so consumption attribution is unambiguous.  The same
holds here — each cell's programs carry per-device FLOPs/bytes, its
requests their TTFT/TPOT, its serving path its event counters, all of
which belong to that cell alone because nothing is shared.

Where the JAX package reads a program's costs out of the compiled XLA
executable, :meth:`CellAccounting.register_program` takes them as
arguments.  A train cell registers its train step with the FLOPs and
state bytes reckoned from its config and batch shape
(``train.train_step.step_cost``).  The HLO-text parser of collective
bytes has no counterpart: the port's collectives record their
per-position bytes as they run (``sharding/collectives.py``), and a
batcher over a mesh registers each step key as a program whose
``collective_per_device`` holds them.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.telemetry import FlightRecorder


@dataclasses.dataclass
class RequestMetrics:
    """Per-request serving latencies (seconds), attributed to one cell."""
    rid: int
    ttft: Optional[float] = None     # submission -> first output token
    tpot: Optional[float] = None     # per-token decode latency after that
    prompt_len: int = 0
    new_tokens: int = 0
    tenant: Optional[str] = None     # QoS attribution (None = untagged)


def summarize_requests(requests) -> dict:
    """p50/p99/p99.9 TTFT/TPOT over any collection carrying .ttft/.tpot
    (the per-cell request log, or a merged multi-replica one)."""
    ttfts = [r.ttft for r in requests if r.ttft is not None]
    tpots = [r.tpot for r in requests if r.tpot is not None]
    out = {"requests": len(requests)}
    for key, xs in (("ttft", ttfts), ("tpot", tpots)):
        if xs:
            out[f"{key}_p50"] = float(np.percentile(xs, 50))
            out[f"{key}_p99"] = float(np.percentile(xs, 99))
            out[f"{key}_p999"] = float(np.percentile(xs, 99.9))
    return out


def tenant_percentile(requests, metric: str, q: float,
                      tenant: Optional[str] = None) -> Optional[float]:
    """Percentile ``q`` of ``metric`` (``"ttft"``/``"tpot"``) over the
    subset of ``requests`` attributed to ``tenant`` (None = all).  The
    per-tenant SLO probe: ``tenant_percentile(acct.requests, "ttft", 99,
    "paid")`` is the number a tenant's SLOTarget is judged against."""
    xs = [getattr(r, metric) for r in requests
          if getattr(r, metric, None) is not None
          and (tenant is None or getattr(r, "tenant", None) == tenant)]
    return float(np.percentile(xs, q)) if xs else None


@dataclasses.dataclass
class ProgramCost:
    name: str
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collective_per_device: Dict[str, int] = dataclasses.field(default_factory=dict)
    arg_bytes: int = 0
    temp_bytes: int = 0
    invocations: int = 0

    @property
    def total_collective_bytes(self) -> int:
        return sum(self.collective_per_device.values())


class CellAccounting:
    """Exact per-cell attribution of program costs, requests and
    serving-path counters."""

    _ids = itertools.count()

    def __init__(self, cell_name: str):
        self.cell = cell_name
        # process-unique, never reused (unlike id()): readers that cursor
        # into ``requests`` key on this to detect a recovered cell's
        # fresh log (see ReconcilePolicy.pull)
        self.uid = next(CellAccounting._ids)
        self.programs: Dict[str, ProgramCost] = {}
        self.requests: List[RequestMetrics] = []
        # named event counters (serving-path waste/degradation signals:
        # prefill_dummy_rows, prefix_hit_tokens, ...)
        self.counters: Dict[str, int] = {}
        # the same counters broken down by tenant label:
        # tenant -> name -> value
        self.tenant_counters: Dict[str, Dict[str, int]] = {}
        # the cell's private flight recorder (spans + latency sketches);
        # same ownership rule as every field above — strictly per-cell
        self.recorder = FlightRecorder(cell_name)

    def register_program(self, name: str, *, flops: float = 0.0,
                         bytes: float = 0.0, arg_bytes: int = 0,
                         temp_bytes: int = 0,
                         collective: Optional[Dict[str, int]] = None
                         ) -> ProgramCost:
        """Record one program's per-device costs, given by the caller
        (the JAX package reads them from a compiled executable)."""
        pc = ProgramCost(name=name, flops_per_device=float(flops),
                         bytes_per_device=float(bytes),
                         collective_per_device=dict(collective or {}),
                         arg_bytes=int(arg_bytes),
                         temp_bytes=int(temp_bytes))
        self.programs[name] = pc
        return pc

    def record_request(self, rid: int, *, ttft: Optional[float] = None,
                       tpot: Optional[float] = None, prompt_len: int = 0,
                       new_tokens: int = 0,
                       tenant: Optional[str] = None) -> RequestMetrics:
        rm = RequestMetrics(rid=rid, ttft=ttft, tpot=tpot,
                            prompt_len=prompt_len, new_tokens=new_tokens,
                            tenant=tenant)
        self.requests.append(rm)
        return rm

    def serving_summary(self) -> dict:
        """p50/p99 TTFT and TPOT over every request this cell served."""
        return summarize_requests(self.requests)

    def tenant_summary(self) -> Dict[str, dict]:
        """:func:`summarize_requests` broken down by tenant label.
        Untagged requests roll up under ``None``."""
        by: Dict[Optional[str], List[RequestMetrics]] = defaultdict(list)
        for r in self.requests:
            by[r.tenant].append(r)
        return {t: summarize_requests(rs) for t, rs in by.items()}

    def tenant_percentile(self, metric: str, q: float,
                          tenant: Optional[str] = None) -> Optional[float]:
        """Per-tenant tail probe over this cell's request log."""
        return tenant_percentile(self.requests, metric, q, tenant)

    def record_counter(self, name: str, n: int = 1,
                       tenant: Optional[str] = None):
        """Bump a named event counter (e.g. batch-padding dummy rows, or
        requests served over a degraded path) — cheap, exact attribution
        of serving overheads that program costs alone can't show.  With
        ``tenant=`` the bump is additionally recorded under that label
        in :attr:`tenant_counters` (the global counter still moves, so
        unlabeled readers see totals)."""
        self.counters[name] = self.counters.get(name, 0) + n
        if tenant is not None:
            tc = self.tenant_counters.setdefault(tenant, {})
            tc[name] = tc.get(name, 0) + n

    def record_gauge(self, name: str, value: int,
                     tenant: Optional[str] = None):
        """Set a point-in-time counter (e.g. ``pages_in_use`` of the
        cell's KV pool) — unlike :meth:`record_counter` it overwrites,
        reflecting current state rather than a cumulative total.  Like
        :meth:`record_counter`, the global entry always moves; with
        ``tenant=`` the value is additionally mirrored under that
        label, so unlabeled readers see the latest state either way."""
        self.counters[name] = value
        if tenant is not None:
            self.tenant_counters.setdefault(tenant, {})[name] = value

    def record_invocation(self, name: str, n: int = 1):
        if name in self.programs:
            self.programs[name].invocations += n

    def totals(self) -> dict:
        t = {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0}
        for pc in self.programs.values():
            t["flops"] += pc.flops_per_device * pc.invocations
            t["bytes"] += pc.bytes_per_device * pc.invocations
            t["collective_bytes"] += pc.total_collective_bytes * pc.invocations
        return t
