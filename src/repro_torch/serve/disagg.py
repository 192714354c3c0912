"""Disaggregated serving: a prefill cell feeding decode-cell replicas.

The port of ``repro/serve/disagg.py``, the paper's "isolate first, then
share on demand" applied to inference::

                                    +--kv channel-->  [ decode cell 0 ]
    requests ->  [ prefill cell ]---+                    continuous
                 whole prompts,     +--kv channel-->  [ decode cell 1 ]
                 batched bucket        per-request KV    batching
                 invocations           rows + meta

Each cell owns its zone's device and runs its own step graphs.  The only
coupling is the on-demand channels opened through the supervisor: the
prefill cell reaches a decode cell's device only through ``send_kv``,
one copy onto that cell's device.  Same-bucket prompts waiting together
are prefilled in one invocation; each request goes to the replica with
the most free slots, or, on a pool, to the replica the cluster cache
plane (``serve/cacheplane.py``) says holds its deepest prefix.  Decode
replica 0 holds the weights; further replicas and the prefill cell pull
them over array channels.  :meth:`DisaggServer.sync` attaches and
detaches replicas live as the decode spec's ``replicas`` changes (the
:class:`~repro_torch.core.daemon.SupervisorDaemon` calls it every tick),
and with ``migrate=True`` a replica that is going away hands its hot
prefix pages and its in-flight slots to the survivors first.

Every cell may lie over a mesh of several positions (rows and
columns of its zone).  Weights go to the destination's layout (its
``Mesh`` and ``Model.params_pspecs()``), KV and pages to the layout the
destination's own caches have (``cache_utils.PayloadLayout``): each
leaf crosses as its logical tensor, so a prefill cell with its kv heads
split feeds a replica with them whole, and the sender keeps its
tensors.

Where the port differs from the JAX package:

* a payload lands in the layout of the destination's own caches (by
  kv heads, a row's batch dim whole), where JAX's dense handoff goes to
  ``cache_pspecs`` (the sequence dim split) and its page handoffs to the
  mesh's default sharding;
* the worker's prefill, paged extend and snapshot restore run as the
  batcher's do (``serve/step_graph.py``): on the card a CUDA graph per
  key (``prefill_key``, ``extend_key``, ``restore_key`` with the worker's
  b_pad), replayed on the worker's own scratch caches, pool arena and
  checkpoint workspace; on the CPU eagerly;
* a cold payload is views of the worker's scratch cache, and the
  channel's copy is its one copy; a payload is copied out earlier only
  when a later group of the same ``prefill_many`` reuses its scratch
  (two groups of one padded batch size), because the server sends after
  every group has run, in the order the requests came.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.accounting import summarize_requests
from repro_torch.core.telemetry import (
    HistogramSketch,
    chrome_trace,
    collect_traces,
    finish_request,
    mark_admitted,
    open_request,
    recorder_of,
    requeue_request,
    span_group,
    write_trace,
)
from repro_torch.models.cache_utils import (
    PayloadLayout,
    cache_batch_axes,
    clear_kv_row,
    extract_row_pages,
    keep_layout,
    load_pages_into_row,
    strip_kv_nodes,
)
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.serve.batcher import (
    ContinuousBatcher,
    Request,
    StepRunner,
    _one_card,
)
from repro_torch.serve.cacheplane import CachePlane, migrate_prefixes
from repro_torch.serve.kvpool import (
    KVPool,
    PoolExhausted,
    build_paged_extend_step,
    build_snapshot_payloads,
    public_ctx_key,
    request_ctx_key,
    run_extend_group,
)
from repro_torch.serve.serve_step import (
    CheckpointWorkspace,
    bucket_len,
    build_extend_step,
    build_prefill_step,
    run_prefill_group,
    supports_chunked_prefill,
)
from repro_torch.serve.step_graph import StepGraph, restore_key
from repro_torch.serve.tenancy import (
    DEFAULT_TENANT,
    TenantRegistry,
    TenantScheduler,
)
from repro_torch.sharding.sharded import Sharded, row_axes, take_rows


def row_view(tree, axes, row: int):
    """Row ``row`` of every leaf of a cache tree (batch dim 1): views, or,
    where a mesh's data axes split the batch dim, a copy gathered from
    the data row that holds it (``take_rows``)."""
    return tree_map(lambda c, a: take_rows(c, a, [row]) if row_axes(c, a)
                    else keep_layout(c.narrow(a, row, 1), c), tree, axes)


def _owned(tree):
    """``tree`` with every tensor copied (a payload out of a scratch that
    is about to be written again)."""
    return tree_map(lambda t: t.clone()
                    if isinstance(t, (torch.Tensor, Sharded)) else t, tree)


class PrefillWorker(StepRunner):
    """Runs bucket-padded prefills on a (prefill) cell.

    Where the model's cache plane is pageable the worker also keeps a
    slot-less :class:`~repro_torch.serve.kvpool.KVPool` as a prefix
    cache: a prompt whose leading chunks match an interned prefix runs
    only its suffix, through one native paged extend whose block table is
    the lease's pages plus fresh temp pages; the suffix K/V lands in the
    arena and its full pages intern by ownership transfer.  On a snapshot
    pool a warm prompt restores its deepest interned state into a scratch
    row and runs its suffix through one dense extend.  The skipped
    compute shows as ``prefix_hit_tokens`` on the prefill cell's
    accounting.  The cell holds the worker among its programs
    (``Cell.track``), so a resize drops its graphs as a batcher's.

    Over a mesh the worker is the batcher's prefill half: its pool's
    arena holds each position's kv heads whole on every data row, its
    scratch caches and checkpoint workspace are split over the data
    axes, its steps are one CUDA graph a key over the positions of one
    card (eager over distinct cards), and each key's collective bytes
    are registered with the cell's accounting."""

    PROGRAM = "prefill_worker"

    def __init__(self, cell, *, max_len: int, chunk: int = 32,
                 temperature: float = 0.0, pool_pages: Optional[int] = None,
                 page_size: int = 16, tenants=None):
        if not supports_chunked_prefill(cell.model, max_len):
            raise ValueError(
                f"config {cell.model.cfg.name!r} has no exact chunked "
                f"prefill at max_len={max_len} (a rolling sliding-window "
                "cache would shift real tokens out behind the pad tail)")
        if cell.serve_params is None:
            cell.init_serve()
        self.cell = cell
        self.model = cell.model
        self.device = cell.device
        self.accounting = cell.accounting
        self.max_len = max_len
        self.chunk = chunk
        self.temperature = temperature
        self.tenants = (tenants if isinstance(tenants, TenantRegistry)
                        else TenantRegistry(tenants or ()))
        quota_fn = (self.tenants.page_quotas
                    if any(t.page_quota is not None
                           for t in self.tenants.specs.values()) else None)
        cap = KVPool.capability(self.model, max_len, page_size)
        self.pool = (KVPool(self.model, max_len=max_len, num_pages=pool_pages,
                            page_size=page_size, accounting=cell.accounting,
                            quotas=quota_fn, device=self.device)
                     if cap != "none" else None)
        self._paged = cap == "paged"
        self._snapshot = cap == "snapshot"
        if self._snapshot:
            # checkpoints sit at page multiples: page-aligned buckets
            self.chunk = int(np.lcm(chunk, page_size))
        self.page_size = page_size
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._build_steps()
        self.step_graph = (
            StepGraph(self.device,
                      generator=self.generator if temperature > 0 else None,
                      capture=_one_card(self.model))
            if self.device.type == "cuda" else None)
        self._has_resident = self._has_resident_rows()
        self._ckpts = (CheckpointWorkspace(self.model, self.device)
                       if self._snapshot else None)
        self._scratch_caches: Dict[int, object] = {}
        self._axes = cache_batch_axes(self.model, 1, max_len)
        self._resident_axes = strip_kv_nodes(self._axes)
        # b_pad -> rids whose payloads (this prefill_many) view its scratch
        self._views: Dict[int, List[int]] = {}
        self.invocations = 0
        self.rec = recorder_of(cell.accounting)
        cell.track(self)

    def _build_steps(self):
        """The prefill and (paged or dense) extend steps over the
        worker's model.  Snapshot families prefill with a checkpoint at
        every page boundary: cold prompts feed the worker's prefix cache
        and the chain the decode pool interns."""
        T = self.temperature
        self._prefill = build_prefill_step(
            self.model, T,
            checkpoint_every=self.page_size if self._snapshot else None)
        self._extend = (build_extend_step(self.model, T) if self._snapshot
                        else build_paged_extend_step(
                            self.model, T, template=self.pool.template)
                        if self._paged else None)
        self._run_extend = (self._stepper(self._extend)
                            if self._extend is not None else None)

    def rebind(self, model, params):
        """Prefill for ``model`` after the cell's mesh changed (the
        weights are the cell's): the pool's arena or payloads and the
        checkpoint workspace re-laid onto its layout, the steps rebuilt,
        the scratch caches anew, every step graph dropped."""
        self.model = model
        if self.pool is not None:
            self.pool.rebind(model)
        if self._ckpts is not None:
            self._ckpts.rebind(model)
        self._build_steps()
        self._scratch_caches = {}
        if self.step_graph is not None:
            for path in ("prefill", "extend", "restore"):
                self.step_graph.drop(path)
            self.step_graph.capture = _one_card(model)

    @property
    def params(self):
        return self.cell.serve_params

    def state_tensors(self) -> list:
        """Every tensor the worker's steps read or write in place."""
        trees = [self.params, self._scratch_caches]
        if self.pool is not None:
            trees += [self.pool.arena, self.pool.kv_scales]
        if self._ckpts is not None:
            trees.append(self._ckpts._flat)
        return [t for t in tree_leaves(trees) if isinstance(t, torch.Tensor)]

    def close(self):
        """Release the steps' CUDA graphs and their memory pool."""
        if self.step_graph is not None:
            self.step_graph.release()

    # -- scratch payloads ------------------------------------------------
    def _claim(self, b_pad: int, out):
        """Before a group writes the b_pad scratch cache: copy out the
        payloads of this call's earlier groups that still view it."""
        for rid in self._views.pop(b_pad, ()):
            req, tok, payload = out[rid]
            out[rid] = (req, tok, _owned(payload))

    def _row(self, cache, row: int):
        return row_view(cache, self._axes, row)

    def _payload(self, cache, row: int, req: Request):
        """A request's handoff: with a pool, the full prompt's canonical
        page stacks and the 1-row resident remainder, so the server can
        slice from any replica's shared-prefix depth; without one, the
        1-row dense cache."""
        if self.pool is None:
            return self._row(cache, row)
        P = self.pool.page_size
        res = strip_kv_nodes(cache)
        if tree_leaves(res):
            res = row_view(res, self._resident_axes, row)
        return {"stacks": extract_row_pages(cache, self.pool.axes, row, 0,
                                            -(-len(req.prompt) // P), P),
                "resident": res}

    # -- the groups ------------------------------------------------------
    def _cold_group(self, group, out):
        """ONE cold prefill over same-bucket requests, interned into the
        prefix cache.  On a snapshot pool each row's chunk checkpoints
        become its chain: interned here (the next same-prefix prompt
        prefills warm) and shipped, so the replica interns it too."""
        b_pad = 1 << (len(group) - 1).bit_length()
        self._claim(b_pad, out)
        t0 = self.rec.clock()
        toks, key = run_prefill_group(
            self._prefill_call, group, chunk=self.chunk,
            max_len=self.max_len, model=self.model,
            accounting=self.cell.accounting)
        t1 = self.rec.clock()
        span_group(self.rec, "prefill", group, t0, t1, kind="cold",
                   batch=len(group))
        self.rec.record("prefill_s", t1 - t0)
        self.invocations += 1
        _, cache, ckpts = self._prefill_state(key)
        for i, (req, tok) in enumerate(zip(group, toks)):
            if self._snapshot:
                chain = build_snapshot_payloads(
                    self.model, self.pool.axes, self.pool.page_size,
                    req.prompt, cache, ckpts, i)
                if chain:
                    self.pool.intern_snapshots(req.prompt,
                                               request_ctx_key(req), chain,
                                               tenant=req.tenant)
                out[req.rid] = (req, tok, {"row": self._row(cache, i),
                                           "chain": chain})
            else:
                if self.pool is not None:
                    self.pool.intern_rows(req.prompt, request_ctx_key(req),
                                          cache, i, tenant=req.tenant)
                out[req.rid] = (req, tok, self._payload(cache, i, req))
            self._views.setdefault(b_pad, []).append(req.rid)

    def _warm_snapshot_group(self, group, out):
        """Warm snapshot prefill: restore each request's deepest interned
        state (and, hybrid, the chain's shared-attention pages) into a
        scratch row, then ONE dense suffix extend over the rows.  The
        handoff is the 1-row cache without a chain (nothing new was
        computed below the boundary), so a warm handoff ships fewer bytes
        than a cold one."""
        P = self.pool.page_size
        b_pad = 1 << (len(group) - 1).bit_length()
        self._claim(b_pad, out)
        cache = self._scratch(b_pad)
        for i, (req, lease) in enumerate(group):
            state, stacks = self.pool.snapshot_chain(lease)
            clear_kv_row(cache, self.pool.axes, i)
            if state is not None:
                self.model.restore_state_row(cache, state, i)
            if stacks:
                load_pages_into_row(cache, self.pool.axes, i, stacks, 0, P)
        s_pad = bucket_len(max(len(r.prompt) - le.tokens for r, le in group),
                           self.chunk, self.max_len)
        tokens = np.zeros((b_pad, s_pad), np.int32)
        length = np.zeros((b_pad,), np.int32)
        pos = np.full((b_pad,), self.max_len, np.int32)
        for i, (req, lease) in enumerate(group):
            suf = req.prompt[lease.tokens:]
            tokens[i, :len(suf)] = suf
            length[i] = len(suf)
            pos[i] = lease.tokens
        t0 = self.rec.clock()
        toks, _ = self._run(restore_key(s_pad, b_pad), self._run_extend,
                            (self.params, cache),
                            {"tokens": tokens, "pos": pos, "length": length})
        toks = toks.tolist()
        t1 = self.rec.clock()
        span_group(self.rec, "prefill", [r for r, _ in group], t0, t1,
                   kind="warm_snapshot", batch=len(group),
                   hit_tokens=sum(le.tokens for _, le in group))
        self.rec.record("prefill_s", t1 - t0)
        self.invocations += 1
        for i, (req, lease) in enumerate(group):
            out[req.rid] = (req, int(toks[i]),
                            {"row": self._row(cache, i), "chain": None})
            self._views.setdefault(b_pad, []).append(req.rid)
            self.pool.release_lease(lease)

    def _warm_paged_group(self, group, out):
        """ONE native paged extend over prefix-hit requests whose suffixes
        share a bucket: each row's block table is its lease's pages plus
        temp pages for the suffix, which intern by ownership transfer
        afterwards.  Temp-page exhaustion demotes the group to the cold
        path, holding nothing."""
        greqs = [r for r, _ in group]
        leases = [le for _, le in group]
        P = self.pool.page_size
        temps: List[List[int]] = []
        try:
            for req, lease in group:
                temps.append(self.pool.alloc_temp_pages(
                    -(-len(req.prompt) // P) - lease.pages,
                    tenant=req.tenant))
        except PoolExhausted:
            for t, req in zip(temps, greqs):
                self.pool.free_temp_pages(t, tenant=req.tenant)
            for lease in leases:
                self.pool.release_lease(lease)
            regroup: Dict[int, List[Request]] = {}
            for req in greqs:
                regroup.setdefault(bucket_len(len(req.prompt), self.chunk,
                                              self.max_len), []).append(req)
            for _, g in sorted(regroup.items()):
                self._cold_group(g, out)
            return
        bt_rows = np.full((len(group), self.pool.n_logical),
                          self.pool.sentinel, np.int32)
        for i, lease in enumerate(leases):
            for lp, node in enumerate(lease.nodes):
                bt_rows[i, lp] = node.page
            bt_rows[i, lease.pages:lease.pages + len(temps[i])] = temps[i]
        b_pad = 1 << (len(group) - 1).bit_length()
        if self._has_resident:          # the extend writes scratch rows
            self._claim(b_pad, out)
        t0 = self.rec.clock()
        toks, rows, _ = run_extend_group(
            self._extend_call, self.pool, greqs, leases, bt_rows,
            chunk=self.chunk, max_len=self.max_len,
            accounting=self.cell.accounting)
        t1 = self.rec.clock()
        span_group(self.rec, "prefill", greqs, t0, t1, kind="warm",
                   batch=len(group), hit_tokens=sum(le.tokens for le in leases))
        self.rec.record("prefill_s", t1 - t0)
        self.invocations += 1
        for i, (req, tok) in enumerate(zip(greqs, toks)):
            # read the full prompt's pages (prefix and fresh suffix)
            # before interning may free the temp pages
            stacks = self.pool.read_pages(
                [n.page for n in leases[i].nodes] + temps[i])
            res = rows
            if tree_leaves(res):
                res = row_view(res, self._resident_axes, i)
                self._views.setdefault(b_pad, []).append(req.rid)
            out[req.rid] = (req, tok, {"stacks": stacks, "resident": res})
            # a foreign (public-grant) hit interns nothing: every temp
            # page is freed
            self.pool.intern_arena_pages(req.prompt, request_ctx_key(req),
                                         leases[i], temps[i],
                                         tenant=req.tenant)
            self.pool.release_lease(leases[i])

    def prefill_many(self, reqs: Sequence[Request]):
        """Prefill requests, ONE invocation per pad bucket: cold prompts by
        their bucket, prefix hits by their suffix's (mixed hit depths
        share one extend).  Returns ``[(req, first_token, payload), ...]``
        in input order; a payload covers the full prompt."""
        cold: Dict[int, List[Request]] = {}
        warm: Dict[int, List[tuple]] = {}
        for req in reqs:
            L = len(req.prompt)
            if not 0 < L <= self.max_len - 1:
                raise ValueError(
                    f"prompt length {L} does not fit max_len={self.max_len}")
            lease = None
            if self.pool is not None:
                alt = (public_ctx_key(req)
                       if self.tenants.share_public(req.tenant) else None)
                lease = self.pool.lease(req.prompt, request_ctx_key(req), alt)
                # the prefill side's hits are skipped compute (the bytes
                # saved are the decode pools')
                self.pool.note_lookup(L, lease.tokens,
                                      accounting=self.cell.accounting,
                                      saved_bytes=False)
            if lease is not None and lease.pages:
                warm.setdefault(bucket_len(L - lease.tokens, self.chunk,
                                           self.max_len), []).append(
                    (req, lease))
            else:
                if lease is not None:
                    self.pool.release_lease(lease)
                cold.setdefault(bucket_len(L, self.chunk, self.max_len),
                                []).append(req)
        if self._ckpts is not None and cold:
            # the workspace grows once a call, to its largest group
            self._reserve_checkpoints(max(
                self._ckpts.pairs(1 << (len(g) - 1).bit_length(),
                                  b // self.pool.page_size)
                for b, g in cold.items()))
        out: Dict[int, tuple] = {}
        self._views = {}
        for _, group in sorted(cold.items()):
            self._cold_group(group, out)
        for _, group in sorted(warm.items()):
            if self._snapshot:
                self._warm_snapshot_group(group, out)
            else:
                self._warm_paged_group(group, out)
        self._views = {}
        self.cell.heartbeat()
        return [out[r.rid] for r in reqs]

    def prefill(self, req: Request):
        """One request -> (first_token, payload)."""
        (_, tok, payload), = self.prefill_many([req])
        return tok, payload


class _DecodeReplica:
    """One decode cell's serving surface: batcher, KV channel, and the
    layout its payloads land in (:attr:`layout`)."""

    def __init__(self, cell, channel, batcher):
        self.cell = cell
        self.channel = channel
        self.batcher = batcher
        self.inflight: Dict[int, Request] = {}   # rid -> sent, not installed
        # rid -> PrefixLease on this replica's pool, taken at routing: it
        # pins the shared pages until the install moves it to the slot
        self.leases: Dict[int, object] = {}
        self.drained = False            # state already handed to survivors

    @property
    def pool(self):
        return self.batcher.pool

    @property
    def layout(self) -> PayloadLayout:
        """Where KV and pages land on this replica: the cell's device, or
        its mesh laid out as its batcher's caches (the JAX replica's
        ``kv_shardings``); the batcher's model, so a resize moves it."""
        return PayloadLayout(self.batcher.model, self.batcher.max_len,
                             self.cell.device)

    def free_capacity(self) -> int:
        # queued, unslotted requests (token-at-a-time fallback) hold
        # capacity as in-flight KV does
        return (len(self.batcher.free_slots()) - len(self.inflight)
                - len(self.batcher.queue))

    def pool_admittable(self, req: Request, lease) -> bool:
        """Can this replica's pool cover ``req``'s worst case now (in the
        request tenant's pocket under quotas)?"""
        if self.pool is None:
            return True
        need = self.pool.required_pages(
            len(req.prompt), req.max_new_tokens,
            lease.pages if lease is not None else 0)
        return need <= self.pool.available_pages(req.tenant)


class DisaggServer:
    """Prefill cell -> KV channels -> decode replica(s), one submit() front.

    ``decode_cells`` is a cell name or a list of replica cell names (e.g.
    ``spec.cell("decode").instances()``).  Each replica's batcher runs
    with ``prefill_chunk=None``: requests arrive as KV over its channel.
    Configs with no exact chunked prefill at ``max_len`` (a rolling
    window) degrade: their prompts go straight onto replica queues, token
    at a time, and the prefill cell's accounting records
    ``prefill_fallback_requests``.  The replica set is live (:meth:`sync`,
    and :meth:`pump` reaps dead replicas): a detached replica's requests
    requeue onto ``pending``, so none is lost."""

    def __init__(self, supervisor, prefill_cell: str,
                 decode_cells: Union[str, Sequence[str]], *,
                 batch_slots: int, max_len: int, chunk: int = 32,
                 temperature: float = 0.0, eos_token: Optional[int] = None,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 tenants=None, shed_queue: Optional[int] = None,
                 quantum: int = 256, migrate: bool = False):
        if isinstance(decode_cells, str):
            decode_cells = [decode_cells]
        if not decode_cells:
            raise ValueError("need at least one decode cell")
        self.sup = supervisor
        self.prefill_cell = supervisor.cells[prefill_cell]
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.chunk = chunk
        self.temperature = temperature
        self.eos_token = eos_token
        self.page_size = page_size
        self.pool_pages = pool_pages
        # the spec the decode instances come from ("dec/0" -> "dec")
        self._decode_base = decode_cells[0].split("/")[0]
        # tenant QoS: the decode spec's declared contract by default; token
        # buckets and DRR run here, at the front door, and the replicas get
        # the registry without buckets (no request is charged twice)
        if tenants is None and supervisor.desired is not None \
                and supervisor.desired.has_cell(self._decode_base):
            tenants = supervisor.desired.cell(self._decode_base).tenants
        self.tenants: TenantRegistry = (
            tenants if isinstance(tenants, TenantRegistry)
            else TenantRegistry(tenants or ()))
        self.scheduler = TenantScheduler(self.tenants, quantum=quantum)
        self.shed_queue = shed_queue    # pending cap; None = never shed
        self.shed_requests = 0
        self.pending: deque = deque()
        self.rejected: List[Request] = []   # unservable, never routed
        self.requeued = 0               # re-homed off a detached replica
        self.blocked_on_pool = 0        # admissions deferred: pool exhausted
        self.blocked_by_tenant: Dict[str, int] = {}
        self.fallback_requests = 0      # served token at a time (no worker)
        self._done_detached: List[Request] = []  # served by gone replicas
        self._detached_stats = {"requests": 0, "decode_invocations": 0,
                                "kv_bytes": 0, "kv_transfers": 0,
                                "kv_seconds": 0.0,
                                "prefix_hit_tokens": 0,
                                "prefix_miss_tokens": 0,
                                "pages_evicted": 0, "kv_bytes_saved": 0,
                                "snapshots_interned": 0,
                                "snapshot_hit_tokens": 0,
                                "snapshot_bytes_saved": 0}
        # detached replicas' telemetry survives as their counters do: the
        # dumps (for trace_export) and the merged sketches (for stats)
        self._detached_dumps: List[dict] = []
        self._detached_hists: Dict[str, HistogramSketch] = {}
        # the cluster cache plane: a supervisor-held prefix index routes
        # warm prompts; page and slot migration on drain is opt-in
        self.cacheplane = CachePlane(supervisor, page_size=page_size)
        self.migrate = migrate
        self.routed_warm = 0            # index-directed warm routings
        self.routed_cold = 0            # capacity-routed
        self.pages_migrated = 0         # prefix pages re-interned on survivors
        self.drain_handoffs = 0         # in-flight slots adopted by survivors
        if migrate:
            supervisor.add_drain_hook(self._drain_hook)

        primary = supervisor.cells[decode_cells[0]]
        if primary.serve_params is None:
            primary.init_serve()
        # the prefill cell pulls the weights from the primary decode cell
        # over an array channel (replicas do the same in _attach)
        if self.prefill_cell.serve_params is None:
            self._sync_weights(prefill_cell, decode_cells[0])
        if supports_chunked_prefill(self.prefill_cell.model, max_len):
            self.worker: Optional[PrefillWorker] = self._make_worker(
                self.prefill_cell)
        else:
            self.worker = None
            self.prefill_cell.accounting.record_counter("prefill_fallback")
        self.replicas: List[_DecodeReplica] = []
        for name in decode_cells:
            self._attach(name)
        self._refresh_index()

    def _make_worker(self, cell) -> PrefillWorker:
        return PrefillWorker(cell, max_len=self.max_len, chunk=self.chunk,
                             temperature=self.temperature,
                             page_size=self.page_size,
                             pool_pages=self.pool_pages, tenants=self.tenants)

    # -- replica lifecycle -----------------------------------------------
    def _sync_weights(self, dst_name: str, src_name: str):
        """Weight fan-out: ``dst`` pulls the params of ``src`` over a
        supervisor array channel, onto its own layout (its mesh by
        ``params_pspecs``, or its device); ``src`` keeps its params."""
        dst = self.sup.cells[dst_name]
        src = self.sup.cells[src_name]
        if src.serve_params is None:
            raise ValueError(
                f"weight source {src_name!r} holds no params to fan out")
        wch = (self.sup.find_channel(src_name, dst_name, "array")
               or self.sup.open_channel(src_name, dst_name, kind="array"))
        wch.send(src.serve_params, (dst.mesh, dst.model.params_pspecs()))
        dst.serve_params = wch.recv()
        if dst.status == "created":     # params in hand: it is serving now
            dst.status = "running"

    def _weight_source(self) -> Optional[str]:
        """The first live replica holding params, else the prefill cell if
        it holds any; None when nothing can be fanned out yet."""
        for rep in self.replicas:
            if rep.cell.serve_params is not None and \
                    rep.cell.status == "running":
                return rep.cell.name
        if self.prefill_cell.serve_params is not None:
            return self.prefill_cell.name
        return None

    def _attach(self, name: str) -> Optional[_DecodeReplica]:
        """Bring a decode cell into the serving surface: weight fan-out (if
        it has none), KV channel, a fresh batcher.  None when no weight
        source exists yet (a later sync retries)."""
        cell = self.sup.cells[name]
        if cell.serve_params is None:
            src = self._weight_source()
            if src is None:
                return None
            self._sync_weights(name, src)
        ch = (self.sup.find_channel(self.prefill_cell.name, name, "kv")
              or self.sup.open_channel(self.prefill_cell.name, name,
                                       kind="kv"))
        batcher = cell.make_batcher(
            batch_slots=self.batch_slots, max_len=self.max_len,
            temperature=self.temperature, eos_token=self.eos_token,
            prefill_chunk=None, page_size=self.page_size,
            pool_pages=self.pool_pages,
            # the tenant contract partitions each replica's pool and
            # schedules its fallback queue, without the front door's buckets
            tenants=self.tenants.specs.values(), tenant_buckets=False,
        )
        rep = _DecodeReplica(cell, ch, batcher)
        self.replicas.append(rep)
        return rep

    def _requeue(self, req: Request):
        """Reset a request's serving state and put it back at the front of
        ``pending``, to be prefilled again from scratch.  ``submitted_at``
        stays, so its TTFT includes the disruption.  (Its prompt cursor
        was its slot's: ``drop_slot`` reset it.)"""
        req.output.clear()
        req.started_at = None
        req.first_token_at = None
        req.finished_at = None
        requeue_request(recorder_of(self.prefill_cell.accounting), req,
                        "requeued")
        self.pending.appendleft(req)
        self.requeued += 1

    def _detach(self, rep: _DecodeReplica) -> int:
        """Remove a replica from the serving surface, requeueing every
        request it held (in flight on the channel or in a slot), keeping
        its served history and counters, then release its batcher: its
        graphs now, its arena with the last reference.  Returns the number
        of requests requeued."""
        self.replicas.remove(rep)
        bat = rep.batcher
        self._done_detached.extend(bat.done)
        ds = self._detached_stats
        ds["requests"] += len(bat.done)
        ds["decode_invocations"] += bat.decode_invocations
        ds["kv_bytes"] += rep.channel.bytes_sent
        ds["kv_transfers"] += rep.channel.transfers
        ds["kv_seconds"] += rep.channel.seconds
        if rep.pool is not None:
            ps = rep.pool.stats()
            for k in ("prefix_hit_tokens", "prefix_miss_tokens",
                      "pages_evicted", "kv_bytes_saved",
                      "snapshots_interned", "snapshot_hit_tokens",
                      "snapshot_bytes_saved"):
                ds[k] += ps[k]
        n = 0
        for rid, req in list(rep.inflight.items()):
            # an in-flight suffix's lease pins pool pages: drop it too
            if rid in rep.leases and rep.pool is not None:
                rep.pool.release_lease(rep.leases.pop(rid))
            self._requeue(req)
            n += 1
        rep.inflight.clear()
        rep.leases.clear()
        for slot, req in enumerate(bat.slot_req):
            if req is not None:
                bat.drop_slot(slot)     # releases the slot's pages
                self._requeue(req)
                n += 1
        while bat.queue:                # the token-at-a-time fallback queue
            self._requeue(bat.queue.pop())
            n += 1
        if rep.channel.open:
            rep.channel.close()
        # archive the replica's telemetry after the requeues above closed
        # its open decode spans
        dump = recorder_of(rep.cell.accounting).dump(reset=True)
        self._detached_dumps.append(dump)
        for k, hd in dump["hists"].items():
            h = HistogramSketch.from_dict(hd)
            if k in self._detached_hists:
                self._detached_hists[k].merge(h)
            else:
                self._detached_hists[k] = h
        bat.close()
        rep.batcher = None
        return n

    # -- cluster cache plane ---------------------------------------------
    def _refresh_index(self):
        """One advert round: live replicas advertise their interned roots
        to the supervisor-held prefix index (metadata only)."""
        self.cacheplane.refresh(
            {rep.cell.name: rep.pool for rep in self.replicas})

    def _pages_channel(self, src: _DecodeReplica, dst: _DecodeReplica):
        """Replica-to-replica migration channel, opened on first use."""
        s, d = src.cell.name, dst.cell.name
        return (self.sup.find_channel(s, d, "pages")
                or self.sup.open_channel(s, d, kind="pages"))

    def _drain_hook(self, cell_name: str):
        """The supervisor's drain hook (``migrate=True``): runs from the
        reconciler's destroy branch while the doomed cell and its
        channels are still live."""
        for rep in self.replicas:
            if rep.cell.name == cell_name:
                self._drain(rep)
                return

    def _drain(self, rep: _DecodeReplica) -> int:
        """Hand a doomed replica's hot state to the survivors before it
        detaches: interned prefix subtrees migrate over a "pages" channel
        to the survivor with the most free pages, and each slotted
        request's written pages and decode cursor are adopted by a
        survivor with a free slot, so it keeps decoding.  Best effort and
        idempotent; what cannot be placed is left for ``_detach`` to
        requeue.  Returns the number of requests handed off."""
        if rep.drained or rep.pool is None:
            return 0
        rep.drained = True
        survivors = [r for r in self.replicas
                     if r is not rep and self._alive(r)
                     and r.pool is not None]
        if not survivors:
            return 0
        # hot prefixes -> the survivor with the most free pages (replica
        # order breaks ties)
        dst = survivors[0]
        for r in survivors[1:]:
            if len(r.pool.free) > len(dst.pool.free):
                dst = r
        self.pages_migrated += migrate_prefixes(
            rep.pool, dst.pool, self._pages_channel(rep, dst))
        # slot export is page-granular: snapshot-plane slots requeue in
        # _detach (their chains just migrated, so they restart warm)
        if rep.pool.payload_kind != "page":
            return 0
        handoffs = 0
        bat = rep.batcher
        for slot, req in enumerate(bat.slot_req):
            if req is None:
                continue
            if bat.prompt_cursor[slot] < len(req.prompt):
                continue        # mid-prompt fallback slot: requeue instead
            snap = bat.export_slot(slot)
            for r in survivors:
                if not r.batcher.free_slots():
                    continue
                ch = self._pages_channel(rep, r)
                ch.send_pages({"stacks": snap["stacks"],
                               "resident": snap["resident"]},
                              r.layout.target("paged"),
                              meta={"rid": req.rid, "pos": snap["pos"],
                                    "cur_tok": snap["cur_tok"]})
                env = ch.poll_pages()
                if r.batcher.adopt_slot(req, env.cache["stacks"],
                                        env.cache["resident"],
                                        env.meta["pos"],
                                        env.meta["cur_tok"]):
                    bat.drop_slot(slot)
                    handoffs += 1
                    break
        self.drain_handoffs += handoffs
        vrec = recorder_of(rep.cell.accounting)
        if vrec.enabled:
            vrec.add_complete("drain", vrec.clock(), 0.0, handoffs=handoffs,
                              pages_migrated=self.pages_migrated)
        return handoffs

    def _refresh_prefill(self) -> bool:
        """Rebind to a prefill cell the supervisor replaced (a recover):
        fan the weights out to the live cell and rebuild the worker.  The
        replicas' channels, bound to the old cell and closed by the
        recover, are reaped right after and re-attached by sync."""
        live = self.sup.cells.get(self.prefill_cell.name)
        if (live is self.prefill_cell or live is None
                or live.status in ("failed", "destroyed")):
            return False
        if live.serve_params is None:
            src = next((rep.cell.name for rep in self.replicas
                        if rep.cell.serve_params is not None
                        and rep.cell.status == "running"), None)
            if src is None:
                return False        # no weight source yet; retry later
            self._sync_weights(live.name, src)
        self.prefill_cell = live
        if self.worker is not None:
            self.worker.close()
            self.worker = self._make_worker(live)
        return True

    def _reap_failed(self) -> int:
        """Detach replicas whose cell died (failed, destroyed or replaced
        by a recover): their requests go back onto ``pending``."""
        self._refresh_prefill()
        n = 0
        for rep in list(self.replicas):
            if not self._alive(rep):
                n += self._detach(rep)
        return n

    def _alive(self, rep: _DecodeReplica) -> bool:
        return (self.sup.cells.get(rep.cell.name) is rep.cell
                and rep.cell.status not in ("failed", "destroyed")
                and rep.channel.open)

    def sync(self, spec, decode_spec: Optional[str] = None) -> dict:
        """Converge the replica set to ``spec`` (live attach and detach):
        replicas the spec no longer names, or whose cell went stale, are
        drained (``migrate=True``) and detached; running spec instances
        not yet serving are attached.  Returns ``{"attached": [...],
        "detached": [...], "requeued": n}``."""
        base = decode_spec or self._decode_base
        self._refresh_prefill()
        desired: List[str] = []
        if spec is not None and spec.has_cell(base):
            desired = spec.cell(base).instances()
        attached, detached, requeued = [], [], 0
        for rep in list(self.replicas):
            name = rep.cell.name
            if name in desired and self._alive(rep):
                continue
            if self.migrate and self._alive(rep):
                self._drain(rep)    # idempotent: the hook may have run
            requeued += self._detach(rep)
            detached.append(name)
        current = {rep.cell.name for rep in self.replicas}
        for name in desired:
            cell = self.sup.cells.get(name)
            if (name in current or cell is None
                    or cell.status in ("failed", "destroyed")):
                continue
            if self._attach(name) is not None:
                attached.append(name)
        # re-advertise: the index never routes to a detached replica
        self._refresh_index()
        return {"attached": attached, "detached": detached,
                "requeued": requeued}

    def close(self):
        """Release what the server holds beyond its own references: the
        worker's and the replicas' step graphs, and its drain hook on the
        supervisor (which would keep the server, its pools and its
        batchers' weights alive after its cells are destroyed)."""
        if self._drain_hook in self.sup.drain_hooks:
            self.sup.drain_hooks.remove(self._drain_hook)
        if self.worker is not None:
            self.worker.close()
        for rep in self.replicas:
            rep.batcher.close()

    # -- the single-replica surface --------------------------------------
    @property
    def decode_cell(self):
        return self.replicas[0].cell

    @property
    def batcher(self) -> ContinuousBatcher:
        return self.replicas[0].batcher

    @property
    def channel(self):
        return self.replicas[0].channel

    # --------------------------------------------------------------------
    def submit(self, req: Request):
        req.submitted_at = req.submitted_at or time.monotonic()
        # the root "request" span opens on the prefill cell, the first
        # cell to touch the request
        open_request(recorder_of(self.prefill_cell.accounting), req)
        self.pending.append(req)

    def _route(self, capacity: Dict[int, int]) -> Optional[int]:
        """The replica with the most free capacity, the lowest index on
        ties: a pure function of the state (no round-robin cursor)."""
        best, best_cap = None, 0
        for i in range(len(self.replicas)):
            if capacity[i] > best_cap:
                best, best_cap = i, capacity[i]
        return best

    def _route_paged(self, capacity: Dict[int, int], req: Request):
        """Cache-aware slot routing with page admission: warm first (the
        replica the prefix index names, if it has a slot and its pool
        admits the request), else most free slots.  Returns (index, lease)
        or (None, None) when every replica is slot- or page-saturated."""
        ctx = request_ctx_key(req)
        alt = (public_ctx_key(req) if self.tenants.share_public(req.tenant)
               else None)
        self._last_route = {"warm": False, "depth": 0, "replica": None}

        def try_lease(i: int):
            rep = self.replicas[i]
            le = (rep.pool.lease(req.prompt, ctx, alt)
                  if rep.pool is not None else None)
            if rep.pool_admittable(req, le):
                capacity[i] -= 1
                return True, le
            if le is not None:
                rep.pool.release_lease(le)
            return False, None

        cand = {r.cell.name: i for i, r in enumerate(self.replicas)
                if capacity[i] > 0 and r.pool is not None}
        if cand:
            keys = [ctx] + ([alt] if alt is not None else [])
            name, depth = self.cacheplane.best_replica(req.prompt, keys,
                                                       list(cand))
            if name is not None and depth > 0:
                ok, le = try_lease(cand[name])
                if ok and le is not None and le.tokens > 0:
                    self.routed_warm += 1
                    self._last_route = {"warm": True, "depth": depth,
                                        "replica": name}
                    return cand[name], le
                if ok:      # admitted, but the advert was stale (no hit)
                    self.routed_cold += 1
                    self._last_route = {"warm": False, "depth": 0,
                                        "replica": name}
                    return cand[name], le
        skipped: Dict[int, int] = {}
        pick, lease = None, None
        while True:
            i = self._route(capacity)
            if i is None:
                break
            ok, le = try_lease(i)
            if ok:
                pick, lease = i, le
                break
            skipped[i] = capacity[i]
            capacity[i] = 0
        capacity.update(skipped)
        if pick is not None:
            self.routed_cold += 1
            self._last_route = {"warm": False, "depth": 0,
                                "replica": self.replicas[pick].cell.name}
        return pick, lease

    def _block_on_pool(self, req: Request, deferred: List[Request]):
        """Defer a request whose page admission cannot be covered yet
        (blocking, never dropping); ``pump`` puts the deferred requests
        back at the front of ``pending`` in their order."""
        req.started_at = None
        requeue_request(recorder_of(self.prefill_cell.accounting), req,
                        "pool_blocked")
        deferred.append(req)
        self.blocked_on_pool += 1
        tenant = req.tenant
        if tenant is not None:
            self.blocked_by_tenant[tenant] = (
                self.blocked_by_tenant.get(tenant, 0) + 1)
            self.prefill_cell.accounting.record_counter(
                "blocked_on_pool", tenant=tenant)

    def _shed_and_reject(self):
        """Finish unservable prompts (empty, or longer than the cache) at
        once with empty output, and past ``shed_queue`` shed the
        low-weight tier first (newest first within a tier)."""
        servable: List[Request] = []
        for req in self.pending:
            if 0 < len(req.prompt) <= self.max_len - 1:
                servable.append(req)
            else:
                req.started_at = req.started_at or time.monotonic()
                req.finished_at = time.monotonic()
                finish_request(req, ts=req.finished_at, outcome="rejected")
                self.rejected.append(req)
        if len(servable) != len(self.pending):
            self.pending = deque(servable)
        if self.shed_queue is not None and len(self.pending) > self.shed_queue:
            victims = self.scheduler.shed_victims(
                self.pending, len(self.pending) - self.shed_queue)
            vids = {id(v) for v in victims}
            self.pending = deque(r for r in self.pending
                                 if id(r) not in vids)
            now = time.monotonic()
            for req in victims:
                req.finished_at = now
                finish_request(req, ts=now, outcome="shed")
                self.rejected.append(req)
                self.shed_requests += 1
                self.prefill_cell.accounting.record_counter(
                    "shed_requests", tenant=req.tenant)

    def _send(self, rep: _DecodeReplica, req: Request, tok: int, payload,
              lease) -> dict:
        """Put one prefilled request on ``rep``'s KV channel: the dense row
        (no pool), the snapshot row and, cold, its chain, or the page
        suffix ``rep``'s pool does not hold (a torch slice of the full
        prompt's stacks; the prefix maps from its interned pages, pinned
        by ``lease`` until the install)."""
        meta = {"rid": req.rid, "first_token": tok,
                "prompt_len": len(req.prompt)}
        layout = rep.layout
        if rep.pool is None:
            return rep.channel.send_kv(payload, layout.target("row"),
                                       meta=meta)
        if rep.pool.payload_kind == "snapshot":
            st = rep.channel.send_kv(
                payload, layout.target("snapshot", len(payload["chain"] or
                                                       ())), meta=meta)
            if lease is not None:
                rep.leases[req.rid] = lease
            return st
        stacks = payload["stacks"]
        if lease.pages:
            stacks = [type(s)(*(a[lease.pages:] for a in s)) for s in stacks]
        st = rep.channel.send_kv(
            {"stacks": stacks, "resident": payload["resident"]},
            layout.target("paged"), meta={**meta, "start_page": lease.pages})
        rep.leases[req.rid] = lease
        return st

    def _install(self, rep: _DecodeReplica, env, deferred) -> bool:
        """Install one arrival into a free slot of ``rep``."""
        req = rep.inflight.pop(env.meta["rid"])
        tok = env.meta["first_token"]
        if rep.pool is None:
            ok = rep.batcher.install_prefilled(req, env.cache, tok)
            # the capacity budget reserved a slot for every send
            if not ok:
                raise RuntimeError("pump sent more KV than there were "
                                   "free slots")
            return True
        if rep.pool.payload_kind == "snapshot":
            ok = rep.batcher.install_snapshot(
                req, env.cache["row"], tok,
                lease=rep.leases.pop(env.meta["rid"], None),
                chain=env.cache["chain"])
            if not ok:
                raise RuntimeError("pump sent more KV than there were "
                                   "free slots")
            return True
        lease = rep.leases.pop(env.meta["rid"])
        if rep.batcher.install_paged(req, env.cache["stacks"],
                                     env.cache["resident"],
                                     env.meta["start_page"], tok, lease):
            return True
        # pages vanished between send and install: re-home, never drop
        rep.pool.release_lease(lease)
        self._block_on_pool(req, deferred)
        return False

    def pump(self) -> int:
        """Prefill waiting requests (up to the replicas' free capacity,
        same-bucket prompts in one invocation), send their KV over the
        per-replica channels, and install arrivals into free slots.
        Returns the number installed."""
        self._reap_failed()
        deferred: List[Request] = []    # pool-blocked this tick, in order
        self._shed_and_reject()
        capacity = {i: r.free_capacity() for i, r in enumerate(self.replicas)}
        budget = sum(c for c in capacity.values() if c > 0)

        def can_place(req: Request) -> bool:
            """Some replica has a free slot and (paged) its pool covers the
            request's hit-aware worst case in its tenant's pocket; nothing
            is reserved here."""
            ctx = request_ctx_key(req)
            alt = (public_ctx_key(req)
                   if self.tenants.share_public(req.tenant) else None)
            for i, rep in enumerate(self.replicas):
                if capacity[i] <= 0:
                    continue
                if rep.pool is None:
                    return True
                hit = len(rep.pool.tree.match(req.prompt, ctx))
                if alt is not None:
                    hit = max(hit, len(rep.pool.tree.match(req.prompt, alt)))
                need = rep.pool.required_pages(
                    len(req.prompt), req.max_new_tokens, hit)
                if need <= rep.pool.available_pages(req.tenant):
                    return True
            return False

        taking: List[Request] = []

        def take(req: Request) -> bool:
            if not can_place(req):
                return False
            req.started_at = req.started_at or time.monotonic()
            taking.append(req)
            return True

        if budget > 0 and self.pending:
            # weighted-fair intake: DRR over tenants plus their buckets,
            # scanning past requests no replica can place yet
            self.scheduler.select(self.pending, take, budget=budget)
        if taking and self.worker is None:
            # no chunked prefill for this config: each prompt goes to a
            # replica's own queue, consumed a token a step
            for req in taking:
                i = self._route(capacity)
                if i is None:
                    raise RuntimeError("the capacity budget promised a "
                                       "replica")
                capacity[i] -= 1
                self.replicas[i].batcher.submit(req)
            self.fallback_requests += len(taking)
            self.prefill_cell.accounting.record_counter(
                "prefill_fallback_requests", len(taking))
        elif taking:
            prec = recorder_of(self.prefill_cell.accounting)
            for req in taking:
                mark_admitted(req)      # the queue wait ends here
            # fresh adverts: what each replica interned since the last pump
            self._refresh_index()
            for req, tok, payload in self.worker.prefill_many(taking):
                root = getattr(req, "_tspans", {}).get("request")
                rspan = prec.start_span("route", trace_id=req.rid,
                                        parent=root.ctx if root else None)
                i, lease = self._route_paged(capacity, req)
                rspan.end(**self._last_route, blocked=(i is None))
                if i is None:
                    # every replica slot- or page-saturated: block
                    self._block_on_pool(req, deferred)
                    continue
                rep = self.replicas[i]
                st = self._send(rep, req, tok, payload, lease)
                if prec.enabled:
                    # the handoff as a traced child of the request's tree
                    t1 = prec.clock()
                    prec.add_complete(
                        "channel", t1 - st["seconds"], st["seconds"],
                        trace_id=req.rid,
                        parent=root.ctx if root else None,
                        bytes=st["bytes"], dst=rep.cell.name)
                rep.inflight[req.rid] = req
        installed = 0
        for rep in self.replicas:
            while True:
                env = rep.channel.poll_kv()
                if env is None:
                    break
                installed += self._install(rep, env, deferred)
        self.pending.extendleft(reversed(deferred))
        return installed

    def step(self) -> int:
        """One scheduler tick: pump the handoff, then one decode step on
        every replica with busy slots."""
        self.pump()
        # the prefill cell is alive while this loop drives it: keep its
        # heartbeat fresh through long decode phases
        self.prefill_cell.heartbeat()
        n = 0
        for rep in self.replicas:
            n += rep.batcher.step()
            rep.cell.heartbeat()
        return n

    def _busy(self) -> bool:
        return bool(
            self.pending
            or any(rep.inflight for rep in self.replicas)
            or any(rep.batcher.queue for rep in self.replicas)
            or any(r is not None for rep in self.replicas
                   for r in rep.batcher.slot_req))

    def run_until_drained(self, max_steps: int = 100_000,
                          on_step=None) -> List[Request]:
        """Step until no request is pending, in flight or slotted;
        ``on_step`` (e.g. ``SupervisorDaemon.tick``) runs after every
        tick."""
        steps = 0
        while self._busy() and steps < max_steps:
            self.step()
            if on_step is not None:
                on_step()
            steps += 1
        return self.done

    @property
    def done(self) -> List[Request]:
        out: List[Request] = list(self.rejected) + list(self._done_detached)
        for rep in self.replicas:
            out.extend(rep.batcher.done)
        return out

    def pool_occupancy(self) -> float:
        """The worst committed-page pressure across live replica pools
        (0.0 off the paged plane)."""
        occ = [rep.pool.occupancy() for rep in self.replicas
               if rep.pool is not None]
        return max(occ) if occ else 0.0

    def tenant_stats(self) -> dict:
        """Per-tenant serving rollups over every finished request."""
        by: Dict[str, List[Request]] = {}
        for r in self.done:
            by.setdefault(r.tenant or DEFAULT_TENANT, []).append(r)
        return {tenant: summarize_requests(reqs)
                for tenant, reqs in sorted(by.items())}

    # -- telemetry plane -------------------------------------------------
    def _recorders(self) -> Dict[str, object]:
        """name -> FlightRecorder of every live serving cell."""
        recs = {self.prefill_cell.name:
                recorder_of(self.prefill_cell.accounting)}
        for rep in self.replicas:
            recs[rep.cell.name] = recorder_of(rep.cell.accounting)
        return recs

    def trace_export(self, path: Optional[str] = None, *,
                     daemon=None) -> dict:
        """The cluster's flight-recorder state as Chrome trace-event JSON:
        one collection round over the supervisor's control plane plus the
        detached replicas' archived dumps; ``daemon=`` folds in its
        decision audit.  Written to ``path`` when given."""
        dumps = collect_traces(self.sup, self._recorders())
        dumps += [d for d in self._detached_dumps
                  if d.get("events") or d.get("open_spans")]
        audit = getattr(daemon, "audit", None) if daemon is not None \
            else None
        trace = chrome_trace(dumps, audit=audit)
        if path is not None:
            write_trace(path, trace)
        return trace

    def telemetry_summary(self) -> Dict[str, dict]:
        """Merged histogram summaries across every live cell's sketches
        and the detached archive."""
        merged: Dict[str, HistogramSketch] = {
            k: HistogramSketch.from_dict(h.to_dict())
            for k, h in self._detached_hists.items()}
        for rec in self._recorders().values():
            for k, h in rec.hists.items():
                if k in merged:
                    merged[k].merge(h)
                else:
                    merged[k] = HistogramSketch.from_dict(h.to_dict())
        return {k: h.summary() for k, h in sorted(merged.items())}

    def stats(self) -> dict:
        ds = self._detached_stats
        pools = [rep.pool.stats() for rep in self.replicas
                 if rep.pool is not None]

        def pool_sum(key):
            return ds[key] + sum(p[key] for p in pools)

        def hit_rate(hit, miss):
            return hit / max(hit + miss, 1)

        return {
            "paged_kv": bool(pools),
            "prefix_hit_tokens": pool_sum("prefix_hit_tokens"),
            "prefix_miss_tokens": pool_sum("prefix_miss_tokens"),
            "prefix_hit_rate": hit_rate(pool_sum("prefix_hit_tokens"),
                                        pool_sum("prefix_miss_tokens")),
            "per_replica_prefix_hit_rate": [
                hit_rate(p["prefix_hit_tokens"], p["prefix_miss_tokens"])
                for p in pools],
            "routed_warm": self.routed_warm,
            "routed_cold": self.routed_cold,
            "pages_migrated": self.pages_migrated,
            "drain_handoffs": self.drain_handoffs,
            "cache_index_entries": len(self.cacheplane.index),
            "pages_evicted": pool_sum("pages_evicted"),
            "kv_bytes_saved": pool_sum("kv_bytes_saved"),
            "snapshots_interned": pool_sum("snapshots_interned"),
            "snapshot_hit_tokens": pool_sum("snapshot_hit_tokens"),
            "snapshot_bytes_saved": pool_sum("snapshot_bytes_saved"),
            "pages_in_use": sum(p["pages_in_use"] for p in pools),
            "pool_occupancy": max((p["occupancy"] for p in pools),
                                  default=0.0),
            "blocked_on_pool": self.blocked_on_pool,
            "decode_serving": summarize_requests(self.done),
            "prefill_chunked": self.worker is not None,
            "prefill_invocations": (
                self.worker.invocations if self.worker is not None else 0),
            "prefill_fallback_requests": self.fallback_requests,
            "decode_invocations": ds["decode_invocations"] + sum(
                r.batcher.decode_invocations for r in self.replicas),
            "kv_bytes": ds["kv_bytes"] + sum(
                r.channel.bytes_sent for r in self.replicas),
            "kv_transfers": ds["kv_transfers"] + sum(
                r.channel.transfers for r in self.replicas),
            "kv_seconds": ds["kv_seconds"] + sum(
                r.channel.seconds for r in self.replicas),
            "replicas": len(self.replicas),
            "per_replica_requests": [len(r.batcher.done)
                                     for r in self.replicas],
            "requests_detached": ds["requests"],
            "pending": len(self.pending),
            "requeued": self.requeued,
            "per_tenant": self.tenant_stats(),
            "shed_requests": self.shed_requests,
            "blocked_by_tenant": dict(self.blocked_by_tenant),
            "throttled_by_tenant": dict(self.scheduler.throttled),
            "served_cost_by_tenant": dict(self.scheduler.served_cost),
            "telemetry": self.telemetry_summary(),
        }
