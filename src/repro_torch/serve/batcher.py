"""Continuous batcher: paged or dense KV, chunked or token-at-a-time.

A fixed-width decode batch of B slots: requests join free slots, run
until EOS or their token budget, and free their slot.  Per-slot positions
let slots sit at different depths.

KV storage is a paged pool (:class:`~repro_torch.serve.kvpool.KVPool`)
where the cache layout allows one (``KVPool.capability`` "paged"), else a
dense per-slot cache ``(B, S, Hkv, Dh)`` per layer (``kv_pool=None``, or a
rolling sliding window shorter than ``max_len``).  On the paged plane,
admission consults the pool's prefix tree first: a prompt that hits an
interned prefix maps those pages read-only and runs only its suffix
through one paged extend invocation per suffix bucket.  Cold prompts
admitted in the same tick that share a pad bucket run as ONE
``Model.prefill_ranged`` invocation, and their KV lands in the pool (full
prompt pages interned) or in their dense slot rows.  Decode runs one step
over all busy slots.  Prompts that cannot be chunked exactly (a rolling
window, ``prefill_chunk=None``, or longer than ``max_len - 1``) are fed
through the decode step one token per step.  Requests blocked on pool
pages stay queued; a deficit-round-robin tenant scheduler picks who is
admitted.

On the card every step runs as a CUDA graph, one per shape key
(``serve/step_graph.py``), as the JAX batcher calls its jitted steps:
decode by block-table width, cold prefill by (padded batch, pad bucket),
paged extend by (padded batch, suffix bucket, width), the snapshot
restore by suffix bucket.  The first call of a path in the process runs
eagerly; a key's first visit otherwise captures, and every later visit
is one replay on the batcher's own tensors: the pool's arena, the dense
cache, a per-batch-size scratch cache the prefill writes in place and,
on a snapshot pool, one checkpoint workspace.  On the CPU the same step
functions run eagerly.

The recurrent families (ssm, hybrid) get the same prefix cache through a
*snapshot* pool (``KVPool.capability`` "snapshot"): decode stays on the
dense per-slot cache, cold prefills emit a state checkpoint at every page
boundary that interns into the pool's tree, and a warm prompt restores the
deepest checkpoint of its chain into its slot row and runs only its
suffix, through one dense extend over all slots.

Slots can also be filled from outside, by the disaggregated server
(``serve/disagg.py``): :meth:`ContinuousBatcher.install_prefilled`,
:meth:`~ContinuousBatcher.install_snapshot` and
:meth:`~ContinuousBatcher.install_paged` take a request prefilled on
another cell, :meth:`~ContinuousBatcher.export_slot` and
:meth:`~ContinuousBatcher.adopt_slot` move a request mid-decode between
replicas, and :meth:`~ContinuousBatcher.drop_slot` evicts one unfinished.
Each writes in place (``index_copy_``, ``copy_``) into the tensors the
step graphs captured: the arena, the resident rows, the dense cache.
Over a mesh a 1-row cache or resident row arriving in the batcher's
layout goes into its slot's data row by global row number, and pages go
into every data row's copy of the arena.

Over a sharded model (a cell over several mesh positions) the batcher is
the same object: its host state (one slot table, one pool with its free
list, prefix tree and counters, one queue) is one, its device state
(weights, the pool's arena, the scratch caches) is Sharded, one shard per
position, and each step runs every position's part and the collectives
between them.  Over several data rows the batch dim of the dense cache,
the resident rows, the scratch caches and the checkpoint workspace is
split as the rules split it: slot ``s`` of B lies on data row ``s // (B
/ R)``; a prefill group whose padded batch R does not divide runs whole
on every data row (a key of its own, since b_pad is in the key).  The
pool's arena and its snapshot payloads are whole on every data row (the
steps' paged writes are mirrored, ``layers.attention_sharded``), and
every row the host moves (a prefill row into its slot, a slot's resident
row, a restored snapshot) goes by global numbers through
``cache_utils``' row helpers, gathered from the data row that holds it.
Positions on one card share its
stream and each step is captured as one CUDA graph; positions over
distinct cards run eagerly (``StepGraph(capture=False)``).  The
collective bytes of each step key are registered with the batcher's
accounting as that key's program cost (``collective_per_device``), from
its eager run or its capture.  :meth:`ContinuousBatcher.rebind` moves a
live batcher onto a resized cell's new model and weights.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.telemetry import (
    finish_request,
    mark_admitted,
    migrate_decode,
    open_decode,
    open_request,
    recorder_of,
    span_group,
)
from repro_torch.device import resolve_device
from repro_torch.models.cache_utils import (
    cache_batch_axes,
    clear_kv_row,
    init_resident,
    load_pages_into_row,
    merge_cache_slots,
    slice_cache_slots,
    strip_kv_nodes,
)
from repro_torch.models.param import is_pspec, tree_leaves, tree_map
from repro_torch.sharding.collectives import recording
from repro_torch.sharding.sharded import relay_leaf
from repro_torch.serve.kvpool import (
    KVPool,
    PoolExhausted,
    build_paged_extend_step,
    build_paged_serve_step,
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
    build_serve_step,
    run_prefill_group,
    supports_chunked_prefill,
)
from repro_torch.serve.step_graph import (
    DENSE_KEY,
    StepGraph,
    paged_key,
    restore_key,
    to_device,
)
from repro_torch.serve.tenancy import (
    DEFAULT_TENANT,
    TenantRegistry,
    TenantScheduler,
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    output: List[int] = dataclasses.field(default_factory=list)
    # QoS attribution: the tenant whose bucket/weight/page pocket this
    # request bills; ``public`` interns its prompt in the shared namespace
    tenant: str = DEFAULT_TENANT
    public: bool = False
    # encdec: the request's source features (S_src, d_model); None = no
    # source (zero cross memory).  Other families ignore it.
    src: Optional[np.ndarray] = None

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (submission -> first output token)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token over the decode phase (None with fewer
        than two tokens)."""
        if self.finished_at is None or self.first_token_at is None:
            return None
        n = len(self.output) - 1
        if n < 1:
            return None
        return (self.finished_at - self.first_token_at) / n


class StepRunner:
    """The steps of a batcher's prefill and extend paths, shared by
    :class:`ContinuousBatcher` and the disaggregated prefill worker
    (``serve/disagg.py``): each runs through :attr:`step_graph` on the
    card (a CUDA graph per key) and eagerly on the CPU.  The host class
    sets ``model``, ``params``, ``device``, ``max_len``, ``pool``,
    ``_paged``, ``generator``, ``step_graph``, ``_prefill``,
    ``_run_extend``, ``_ckpts`` and ``_scratch_caches``."""

    #: how a cell's guard names it among the cell's programs
    PROGRAM = "batcher"

    def _scratch(self, batch: int):
        """B-row prefill scratch cache (fixes the cache length), reused."""
        if batch not in self._scratch_caches:
            self._scratch_caches[batch] = self.model.init_cache(
                batch, self.max_len, device=self.device)
        return self._scratch_caches[batch]

    def _prefill_state(self, key):
        """(params, scratch cache, checkpoint views or None) of the cold
        prefill at ``key`` = ("prefill", b_pad, s_pad): what it reads and
        writes in place."""
        _, b_pad, s_pad = key
        ckpts = None
        if self._ckpts is not None:
            n = s_pad // self.pool.page_size
            self._reserve_checkpoints(self._ckpts.pairs(b_pad, n))
            ckpts = self._ckpts.views(b_pad, n)
        return self.params, self._scratch(b_pad), ckpts

    def _reserve_checkpoints(self, pairs: int):
        """Grow the checkpoint workspace to ``pairs`` (row, checkpoint)
        pairs a position if it is smaller; the prefill graphs captured on
        the old buffers go with them."""
        if self._ckpts.reserve(pairs) and self.step_graph is not None:
            self.step_graph.drop("prefill")

    def _prefill_call(self, key, host):
        """Run the cold prefill at ``key`` on the host inputs; the
        first tokens (b_pad,) on the device."""
        return self._run(key, self._run_prefill, self._prefill_state(key),
                         host)[0]

    def _run_prefill(self, state, inputs):
        """The plain prefill step on (params, scratch cache, checkpoint
        views) and the device inputs -> (tokens, state)."""
        params, cache, ckpts = state
        toks, _logits, cache = self._prefill(params, cache, inputs,
                                             self.generator, ckpt_out=ckpts)
        if ckpts is not None:
            cache, ckpts = cache
        return toks, (params, cache, ckpts)

    def _extend_call(self, key, host):
        """Run the paged extend at ``key`` on the host inputs over the
        pool's arena: (first tokens on the device, the b_pad rows'
        resident part)."""
        state = (self.params, self.pool.arena, self.pool.kv_scales,
                 self._extend_rows(key[1]))
        toks, (_, self.pool.arena, self.pool.kv_scales, rows) = self._run(
            key, self._run_extend, state, host)
        return toks, rows

    def _extend_rows(self, b_pad: int):
        """The resident rows a paged extend of ``b_pad`` rows writes in
        place: those of the b_pad prefill scratch cache (encdec: the
        rows' cross memory, which the extend encodes before the decoder
        stack), or, for a family with no resident state, the template's
        empty remainder."""
        if not self._has_resident:
            return strip_kv_nodes(self.pool.template)
        return strip_kv_nodes(self._scratch(b_pad))

    def _run(self, key, fn, state, host):
        """``fn(state, inputs) -> (tokens, state)`` on the host inputs
        ``host``: on the card through ``key``'s CUDA graph, on the CPU
        eagerly.  Over a mesh, the collective bytes of a run that executes
        the step's Python (eager, or the capture) become the key's program
        cost."""
        if not getattr(self.model, "sharded", False):
            return self._call(key, fn, state, host)
        with recording() as log:
            out = self._call(key, fn, state, host)
        if log and self.accounting is not None:
            self.accounting.register_program(
                "/".join(map(str, key)), collective=dict(log))
        return out

    def _call(self, key, fn, state, host):
        if self.step_graph is None:
            return fn(state, to_device(host, self.device))
        return self.step_graph(key, fn, state, host)

    def _stepper(self, step):
        """``step``, a decode or extend step over the paged arena
        (``kvpool``) or the dense cache (``serve_step``), as the plain
        ``fn(state, inputs) -> (tokens, state)`` over
        the layout of ``ContinuousBatcher._decode_state``; the inputs
        other than the block table are the step's batch."""
        paged, generator = self._paged, self.generator   # not self: the
        # batcher stays free of reference cycles, so dropping it frees it

        def run(state: tuple, inputs: dict):
            batch = {k: v for k, v in inputs.items() if k != "block_table"}
            if paged:
                params, arena, scales, resident = state
                toks, arena, scales, resident = step(
                    params, arena, scales, resident, inputs["block_table"],
                    batch, generator)
                return toks, (params, arena, scales, resident)
            params, cache = state
            toks, _logits, cache = step(params, cache, batch, generator)
            return toks, (params, cache)
        return run

    def _has_resident_rows(self) -> bool:
        """Does the model's cache keep a dense remainder beside its KV
        nodes (encdec: the cross memory)?"""
        return bool(tree_leaves(
            strip_kv_nodes(self.model.cache_specs(1, self.max_len)),
            is_leaf=is_pspec))


class ContinuousBatcher(StepRunner):
    """Slot-based continuous batching over prefill, extend and decode
    steps, on ``device`` (default ``"cuda"``).  ``kv_pool``: "auto" (a
    paged or snapshot pool where the model and cache layout allow one,
    else the dense per-slot cache), None (the dense cache) or a prebuilt
    KVPool."""

    def __init__(self, model, params, *, batch_slots: int, max_len: int,
                 temperature: float = 0.0, eos_token: Optional[int] = None,
                 prefill_chunk: Optional[int] = 32, accounting=None,
                 kv_pool: Any = "auto", page_size: int = 16,
                 pool_pages: Optional[int] = None, tenants: Any = None,
                 tenant_buckets: bool = True, quantum: int = 256,
                 kv_dtype: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos = eos_token
        self.temperature = temperature
        self.accounting = accounting
        self.rec = recorder_of(accounting)
        self.pos = np.zeros(batch_slots, np.int32)
        self.cur_tok = np.zeros(batch_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.tenants: TenantRegistry = (
            tenants if isinstance(tenants, TenantRegistry)
            else TenantRegistry(tenants or (), buckets=tenant_buckets))
        self.scheduler = TenantScheduler(self.tenants, quantum=quantum)
        quota_fn = (self.tenants.page_quotas
                    if any(t.page_quota is not None
                           for t in self.tenants.specs.values()) else None)
        if kv_pool == "auto":
            kv_pool = (KVPool(model, max_len=max_len, page_size=page_size,
                              slots=batch_slots, num_pages=pool_pages,
                              accounting=accounting, quotas=quota_fn,
                              kv_dtype=kv_dtype, device=self.device)
                       if KVPool.capability(model, max_len, page_size)
                       != "none" else None)
        self.pool: Optional[KVPool] = kv_pool
        self._paged = (self.pool is not None
                       and self.pool.payload_kind == "page")
        self._snapshot = (self.pool is not None
                          and self.pool.payload_kind == "snapshot")
        self._cache_axes = cache_batch_axes(model, batch_slots, max_len)
        self._resident_axes = strip_kv_nodes(self._cache_axes)
        if self._paged:
            self.cache = None
            # the cache's non-paged remainder, dense per slot (encdec: the
            # cross memory; nothing for the dense and MoE families)
            self.resident = init_resident(model, batch_slots, max_len,
                                          self.device)
            self._step = build_paged_serve_step(model, temperature,
                                                template=self.pool.template)
            self._extend = build_paged_extend_step(
                model, temperature, template=self.pool.template)
        else:
            # the dense per-slot cache, also the decode plane of a snapshot
            # pool (recurrent state is O(1) per slot; the pool holds only
            # the shareable checkpoint chains)
            self.cache = model.init_cache(batch_slots, max_len,
                                          device=self.device)
            self.resident = None
            self._step = build_serve_step(model, temperature)
            self._extend = build_extend_step(model, temperature)
        self.prefill_chunk = prefill_chunk
        self.chunked = (prefill_chunk is not None
                        and supports_chunked_prefill(model, max_len))
        if self.chunked and self._snapshot:
            # checkpoints sit at page multiples, so every prefill bucket is
            # page-aligned: the bucket quantum becomes lcm(chunk, page)
            self.prefill_chunk = int(np.lcm(prefill_chunk, page_size))
        self._prefill = (
            build_prefill_step(
                model, temperature,
                checkpoint_every=page_size if self._snapshot else None)
            if self.chunked else None)
        # per slot: index of the next prompt token a token-at-a-time admit
        # feeds through the decode step (the prompt length once consumed)
        self.prompt_cursor = np.zeros(batch_slots, np.int64)
        # sampling draws (temperature > 0) from a seeded generator
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        # the steps' CUDA graphs (None on the CPU: eager steps; eager and
        # counted over positions on distinct cards)
        self.step_graph = (
            StepGraph(self.device,
                      generator=self.generator if temperature > 0 else None,
                      capture=_one_card(model))
            if self.device.type == "cuda" else None)
        self._has_resident = self._has_resident_rows()
        self._run_step = self._stepper(self._step)
        self._run_extend = self._stepper(self._extend)
        # where a snapshot pool's cold prefill writes its checkpoints
        self._ckpts = (CheckpointWorkspace(model, self.device)
                       if self._snapshot and self.chunked else None)
        self._scratch_caches: Dict[int, Any] = {}  # B -> B-row prefill cache
        self._slot_init_cache = None               # lazy; see _slot_init()
        self.prefill_invocations = 0
        self.prefill_batch_sizes: List[int] = []   # prompts per invocation
        self.decode_invocations = 0

    # -- request management ----------------------------------------------
    def submit(self, req: Request):
        req.submitted_at = req.submitted_at or time.monotonic()
        open_request(self.rec, req)
        self.queue.append(req)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.B) if self.slot_req[s] is None]

    def _finish(self, req: Request, now: float, slot: Optional[int] = None):
        req.finished_at = now
        finish_request(req, ts=now)
        self.done.append(req)
        if slot is not None:
            self.slot_req[slot] = None
            if self.pool is not None:
                # private + pocket pages return to the free list; shared
                # prefix pages decref and stay interned as reclaimable cache
                self.pool.release_slot(slot)
        if self.accounting is not None:
            self.accounting.record_request(
                req.rid, ttft=req.ttft, tpot=req.tpot,
                prompt_len=len(req.prompt), new_tokens=len(req.output),
                tenant=req.tenant)

    # -- chunked prefill ---------------------------------------------------
    def _slot_init(self):
        """A pristine 1-row cache for resetting a slot at a token-at-a-time
        admit: recurrent state is not masked by position, so a request
        admitted into a reused slot would otherwise integrate its
        predecessor's state.  Built at the first such admit."""
        if self._slot_init_cache is None:
            self._slot_init_cache = self.model.init_cache(
                1, self.max_len, device=self.device)
        return self._slot_init_cache

    def _prefill_group(self, group):
        """ONE prefill invocation over same-bucket (slot, request, lease)
        triples of cold requests, then the KV installs into the pool's
        pages or the slots' dense rows; on a snapshot pool each row's
        chunk checkpoints intern first.  The installs copy out of the
        scratch cache and the workspace before any other step runs."""
        B = len(group)
        reqs = [r for _, r, _ in group]
        slots = [s for s, _, _ in group]
        t0 = self.rec.clock()
        toks, key = run_prefill_group(
            self._prefill_call, reqs, chunk=self.prefill_chunk,
            max_len=self.max_len, model=self.model,
            accounting=self.accounting)
        t1 = self.rec.clock()
        span_group(self.rec, "prefill", reqs, t0, t1, kind="cold",
                   batch=len(group))
        self.rec.record("prefill_s", t1 - t0)
        self.prefill_invocations += 1
        self.prefill_batch_sizes.append(B)
        _, rows_cache, ckpts = self._prefill_state(key)
        if self._snapshot:
            self._intern_snapshot_chains(group, rows_cache, ckpts)
        if not self._paged:
            self._install_rows(slots, reqs, rows_cache, toks[:B],
                               rows=range(B))
            return
        self._install_pool_rows(group, rows_cache, toks[:B])

    def _extend_group(self, group):
        """ONE suffix-extend invocation over prefix-hit (slot, request,
        lease) triples whose suffixes share a pad bucket.  Each row's
        block-table row is its slot's, so the suffix K/V lands directly in
        the slot's arena pages; the full prompt pages are then interned by
        ownership transfer."""
        slots = [s for s, _, _ in group]
        reqs = [r for _, r, _ in group]
        leases = [le for _, _, le in group]
        for slot, req in zip(slots, reqs):
            self.pool.map_suffix_pages(slot, len(req.prompt))
        bt_rows = np.asarray(self.pool.block_table[slots], np.int32)
        t0 = self.rec.clock()
        toks, resident_rows, _b_pad = run_extend_group(
            self._extend_call, self.pool, reqs, leases, bt_rows,
            chunk=self.prefill_chunk, max_len=self.max_len,
            accounting=self.accounting)
        t1 = self.rec.clock()
        span_group(self.rec, "prefill", reqs, t0, t1, kind="warm",
                   batch=len(group),
                   hit_tokens=sum(le.tokens for le in leases))
        self.rec.record("prefill_s", t1 - t0)
        self.prefill_invocations += 1
        self.prefill_batch_sizes.append(len(group))
        for slot, req in zip(slots, reqs):
            self.pool.promote_slot_pages(slot, req.prompt,
                                         request_ctx_key(req))
            self.pool.ensure_decode_page(slot, len(req.prompt))
        self._merge_resident_rows(resident_rows, list(range(len(group))),
                                  slots)
        self._post_install(slots, reqs, toks[:len(group)])

    def _intern_snapshot_chains(self, group, rows_cache, ckpts):
        """Intern each cold request's chunk chain: chunk ``lp``'s payload is
        the state after position ``(lp+1) * page_size`` plus, for hybrid,
        the chunk's shared-attention KV page.  Only the prompt's full
        chunks intern."""
        for i, (_slot, req, _lease) in enumerate(group):
            payloads = build_snapshot_payloads(
                self.model, self.pool.axes, self.pool.page_size, req.prompt,
                rows_cache, ckpts, i)
            if payloads:
                self.pool.intern_snapshots(req.prompt, request_ctx_key(req),
                                           payloads, tenant=req.tenant)

    def _restore_group(self, group):
        """The warm path of a snapshot pool: seed each slot's dense cache
        row from its leased chain (the deepest boundary state, and the
        chain's shared-attention pages), then run ONE dense suffix extend
        over all slots.  Rows outside the group ride along unchanged: their
        ``length`` 0 makes every SSD step an identity update (the state
        comes back bit for bit) and their ``pos`` = max_len drops every KV
        write."""
        P = self.pool.page_size
        for slot, _req, lease in group:
            state, stacks = self.pool.snapshot_chain(lease)
            clear_kv_row(self.cache, self.pool.axes, slot)
            if state is not None:
                self.model.restore_state_row(self.cache, state, slot)
            if stacks:
                load_pages_into_row(self.cache, self.pool.axes, slot, stacks,
                                    0, P)
        s_pad = bucket_len(
            max(len(r.prompt) - le.tokens for _, r, le in group),
            self.prefill_chunk, self.max_len)
        tokens = np.zeros((self.B, s_pad), np.int32)
        length = np.zeros((self.B,), np.int32)
        pos = np.full((self.B,), self.max_len, np.int32)
        for slot, req, lease in group:
            suf = req.prompt[lease.tokens:]
            tokens[slot, :len(suf)] = suf
            length[slot] = len(suf)
            pos[slot] = lease.tokens
        reqs = [r for _, r, _ in group]
        t0 = self.rec.clock()
        toks, (_, self.cache) = self._run(
            restore_key(s_pad), self._run_extend, (self.params, self.cache),
            {"tokens": tokens, "pos": pos, "length": length})
        toks = toks.tolist()
        t1 = self.rec.clock()
        span_group(self.rec, "prefill", reqs, t0, t1, kind="warm_snapshot",
                   batch=len(group),
                   hit_tokens=sum(le.tokens for _, _, le in group))
        self.rec.record("prefill_s", t1 - t0)
        self.prefill_invocations += 1
        self.prefill_batch_sizes.append(len(group))
        self._post_install([s for s, _, _ in group], reqs,
                           [toks[s] for s, _, _ in group])

    def _install_pool_rows(self, group, rows_cache, first_tokens):
        """Map each (slot, request, lease)'s computed pages out of row i of
        a dense rows cache into its slot (full prompt pages interned),
        copy the resident remainder in place, then the bookkeeping."""
        for i, (slot, req, lease) in enumerate(group):
            self.pool.install_rows(slot, req.prompt, request_ctx_key(req),
                                   rows_cache, i, lease.pages)
        slots = [s for s, _, _ in group]
        self._merge_resident_rows(rows_cache, list(range(len(group))), slots)
        self._post_install(slots, [r for _, r, _ in group], first_tokens)

    def _install_rows(self, slots, reqs, rows_cache, first_tokens,
                      rows=None):
        """Write prefilled dense rows ``rows`` (default the first
        ``len(slots)``) of ``rows_cache`` into their slots, then the
        per-request bookkeeping."""
        self.cache = merge_cache_slots(self.cache, rows_cache,
                                       self._cache_axes, slots, rows)
        self._post_install(slots, reqs, first_tokens)

    def _merge_resident_rows(self, rows_cache, rows, slots):
        """Copy the non-paged remainder of the given prefill or extend rows
        into the batcher's resident tree, in place (``index_copy_``), so
        the decode graphs' addresses hold (encdec: the cross memory; the
        dense and MoE families have none)."""
        res = strip_kv_nodes(rows_cache)
        if not tree_leaves(res):
            return
        self.resident = merge_cache_slots(self.resident, res,
                                          self._resident_axes, slots, rows)

    def _post_install(self, slots, reqs, first_tokens):
        """Per-request bookkeeping after the prompt's KV landed."""
        now = time.monotonic()
        for slot, req, tok in zip(slots, reqs, first_tokens):
            req.started_at = req.started_at or now
            req.first_token_at = req.first_token_at or now
            L = len(req.prompt)
            self.pos[slot] = L
            self.prompt_cursor[slot] = L
            self.cur_tok[slot] = tok
            req.output.append(tok)
            finished = (
                len(req.output) >= req.max_new_tokens
                or (self.eos is not None and tok == self.eos)
                or L >= self.max_len - 1
            )
            if finished:
                self._finish(req, now, slot=slot)
            else:
                self.slot_req[slot] = req
                open_decode(self.rec, req, ts=now)

    # -- slots filled from outside (disaggregated serving) ----------------
    def _merge_resident_row(self, resident_row, slot: int):
        """Copy a 1-row resident tree (encdec: cross memory and src_len)
        into ``slot``'s resident rows, in place."""
        if resident_row is not None and tree_leaves(resident_row):
            self.resident = merge_cache_slots(
                self.resident, resident_row, self._resident_axes, [slot])

    def install_prefilled(self, req: Request, row_cache,
                          first_token: int) -> bool:
        """Take a request prefilled on another cell: ``row_cache`` is a
        1-row dense cache on this batcher's device.  False when no slot
        is free or, on a paged pool, admission would exhaust it."""
        free = self.free_slots()
        if not free:
            return False
        slot = free[0]
        if self.pool is None:
            self._install_rows([slot], [req], row_cache, [first_token])
            return True
        if not self._paged:
            return self.install_snapshot(req, row_cache, first_token)
        ctx = request_ctx_key(req)
        alt = (public_ctx_key(req) if self.tenants.share_public(req.tenant)
               else None)
        lease = self.pool.lease(req.prompt, ctx, alt)
        try:
            self.pool.admit(slot, lease, len(req.prompt), req.max_new_tokens,
                            tenant=req.tenant)
        except PoolExhausted:
            self.pool.release_lease(lease)
            return False
        self._install_pool_rows([(slot, req, lease)], row_cache,
                                [first_token])
        return True

    def install_snapshot(self, req: Request, row_cache, first_token: int,
                         lease=None, chain=None) -> bool:
        """Take a request prefilled on another cell onto a snapshot pool:
        the dense 1-row install plus the prefix bookkeeping.  The lease
        (the router's, or taken here) moves to the slot at admission, and
        a cold handoff's chunk ``chain`` interns so the next request with
        this prefix restores warm.  False (lease released) when no slot
        is free."""
        free = self.free_slots()
        if not free:
            self.pool.release_lease(lease)
            return False
        slot = free[0]
        ctx = request_ctx_key(req)
        if lease is None:
            alt = (public_ctx_key(req)
                   if self.tenants.share_public(req.tenant) else None)
            lease = self.pool.lease(req.prompt, ctx, alt)
        try:
            self.pool.admit(slot, lease, len(req.prompt), req.max_new_tokens,
                            tenant=req.tenant)
        except PoolExhausted:       # a snapshot admit reserves nothing
            self.pool.release_lease(lease)
            return False
        if chain:
            self.pool.intern_snapshots(req.prompt, ctx, chain,
                                       tenant=req.tenant)
        self._install_rows([slot], [req], row_cache, [first_token])
        return True

    def install_paged(self, req: Request, stacks, resident_row,
                      start_page: int, first_token: int, lease) -> bool:
        """Take a request prefilled on another cell from page stacks: only
        the pages from ``start_page`` on crossed the channel; pages
        ``[0, start_page)`` map from this pool's interned prefix, held by
        ``lease``, which moves to the slot.  False (lease untouched) when
        no slot is free or the pool is exhausted."""
        free = self.free_slots()
        if not free:
            return False
        slot = free[0]
        try:
            self.pool.admit(slot, lease, len(req.prompt), req.max_new_tokens,
                            tenant=req.tenant)
        except PoolExhausted:
            return False
        self.pool.install_stacks(slot, req.prompt, request_ctx_key(req),
                                 stacks, start_page)
        self._merge_resident_row(resident_row, slot)
        self._post_install([slot], [req], [first_token])
        return True

    def export_slot(self, slot: int) -> dict:
        """A busy paged slot's mid-decode state, for migration: the
        request, its cursor (``pos``, ``cur_tok``), its written pages
        (positions ``[0, pos)``, as copies) and its resident row.
        Read-only: the caller drops the slot once a survivor adopted it."""
        req = self.slot_req[slot]
        if req is None or not self._paged:
            raise ValueError("slot export needs a busy slot of a paged pool "
                             "(snapshot and dense slots requeue)")
        pos = int(self.pos[slot])
        n_pages = -(-pos // self.pool.page_size)
        page_ids = np.asarray(self.pool.block_table[slot, :n_pages],
                              np.int32)
        if (page_ids == self.pool.sentinel).any():
            raise RuntimeError("a written page is unmapped: the block-table "
                               "invariant is broken")
        resident_row = None
        if tree_leaves(self.resident):
            resident_row = slice_cache_slots(self.resident,
                                             self._resident_axes, [slot])
        return {"req": req, "pos": pos, "cur_tok": int(self.cur_tok[slot]),
                "stacks": self.pool.read_pages(page_ids),
                "resident": resident_row}

    def adopt_slot(self, req: Request, stacks, resident_row, pos: int,
                   cur_tok: int) -> bool:
        """Take a migrated request mid-decode (the other half of
        :meth:`export_slot`): admit it into a free slot, map its written
        pages (the prefix this pool interned already from its own pages,
        the rest from ``stacks``, full prompt pages interned) and resume
        its cursor where the source left it.  Its tokens are not
        re-run.  False (nothing changed) when no slot is free or the
        pool is exhausted."""
        free = self.free_slots()
        if not free or not self._paged:
            return False
        slot = free[0]
        ctx = request_ctx_key(req)
        alt = (public_ctx_key(req) if self.tenants.share_public(req.tenant)
               else None)
        lease = self.pool.lease(req.prompt, ctx, alt)
        try:
            self.pool.admit(slot, lease, len(req.prompt), req.max_new_tokens,
                            tenant=req.tenant)
        except PoolExhausted:
            self.pool.release_lease(lease)
            return False
        start = lease.pages
        if start:
            stacks = [type(s)(*(a[start:] for a in s)) for s in stacks]
        self.pool.install_stacks(slot, req.prompt, ctx, stacks, start)
        self._merge_resident_row(resident_row, slot)
        self.slot_req[slot] = req
        self.pos[slot] = pos
        self.cur_tok[slot] = cur_tok
        self.prompt_cursor[slot] = len(req.prompt)
        migrate_decode(req, self.rec)
        return True

    def drop_slot(self, slot: int) -> Optional[Request]:
        """Evict a slot's request without finishing it (detach, requeue):
        the slot, its pool pages and its prompt cursor are released; the
        caller re-homes the request."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.prompt_cursor[slot] = 0
        if self.pool is not None:
            self.pool.release_slot(slot)
        return req

    def _admit_fallback(self, slot: int, req: Request):
        """Token-at-a-time admission: the prompt is fed through the decode
        step one token per step.  A reused slot's stale KV is masked by
        position; non-positional slot state (the ssm / hybrid recurrent
        state, encdec cross memory) goes back to its init values first,
        then the request's own side state (encdec: its source's cross
        memory, encoded eagerly into a fresh row) lands in the slot, all
        in place."""
        if not self.model.decode_state_positional:
            if self._paged:
                self.resident = merge_cache_slots(
                    self.resident, strip_kv_nodes(self._slot_init()),
                    self._resident_axes, [slot])
            else:
                self.cache = merge_cache_slots(self.cache, self._slot_init(),
                                               self._cache_axes, [slot])
        if req.src is not None and self.model.cfg.family == "encdec":
            ex = self.model.ranged_batch_extras([req.src], self.max_len)
            row = init_resident(self.model, 1, self.max_len, self.device)
            self.model.encode_cross_into(
                self.params, row["dec_layers"], ex["src"].to(self.device),
                ex["src_len"].to(self.device))
            merge_cache_slots(self.resident if self._paged
                              else strip_kv_nodes(self.cache), row,
                              self._resident_axes, [slot])
        self.slot_req[slot] = req
        self.pos[slot] = 0
        self.cur_tok[slot] = int(req.prompt[0]) if len(req.prompt) else 0
        self.prompt_cursor[slot] = 1

    def _admit(self):
        free = self.free_slots()
        staged: List[tuple] = []        # chunked (slot, req, lease)
        taken = [0]                     # free-slot cursor

        def try_admit(req: Request) -> bool:
            # the scheduler's resource gate: bind the next free slot and
            # reserve pool pages; False = blocked, the scheduler scans past
            slot = free[taken[0]]
            chunkable = (self.chunked
                         and 0 < len(req.prompt) <= self.max_len - 1)
            lease = None
            if self.pool is not None:
                alt = (public_ctx_key(req)
                       if chunkable and self.tenants.share_public(req.tenant)
                       else None)
                lease = (self.pool.lease(req.prompt, request_ctx_key(req),
                                         alt)
                         if chunkable else self.pool.empty_lease())
                try:
                    self.pool.admit(slot, lease, len(req.prompt),
                                    req.max_new_tokens, tenant=req.tenant)
                except PoolExhausted:
                    self.pool.release_lease(lease)
                    return False
            taken[0] += 1
            req.started_at = req.started_at or time.monotonic()
            mark_admitted(req, slot=slot,
                          prefix_hit=lease.tokens if lease else 0)
            if chunkable:
                staged.append((slot, req, lease))
            else:
                self._admit_fallback(slot, req)
                open_decode(self.rec, req)
            return True

        if free and self.queue:
            self.scheduler.select(self.queue, try_admit, budget=len(free))
        # same-bucket prompts admitted this tick share one invocation:
        # prefix hits group by their SUFFIX bucket, cold prompts by their
        # full bucket
        cold: Dict[int, List[tuple]] = {}
        warm: Dict[int, List[tuple]] = {}
        for slot, req, lease in staged:
            hit = lease.tokens if lease is not None else 0
            b = bucket_len(len(req.prompt) - hit, self.prefill_chunk,
                           self.max_len)
            (warm if hit else cold).setdefault(b, []).append(
                (slot, req, lease))
        if self._ckpts is not None and cold:
            # the workspace grows once a tick, to the tick's largest group
            self._reserve_checkpoints(max(
                self._ckpts.pairs(1 << (len(g) - 1).bit_length(),
                                  b // self.pool.page_size)
                for b, g in cold.items()))
        for _, group in sorted(cold.items()):
            self._prefill_group(group)
        for _, group in sorted(warm.items()):
            if self._paged:
                self._extend_group(group)
            else:
                self._restore_group(group)

    # -- one decode step over all busy slots -------------------------------
    def step(self) -> int:
        self._admit()
        busy = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not busy:
            return 0
        t0 = self.rec.clock() if self.rec.enabled else 0.0
        host = {"tokens": self.cur_tok[:, None], "pos": self.pos}
        key = DENSE_KEY
        if self._paged:
            # map the page each busy slot is about to write (from the
            # pocket its admission reserved: cannot fail mid-decode)
            for s in busy:
                self.pool.ensure_decode_page(s, int(self.pos[s]))
            # width-trim the block table to the pow2 page bucket covering
            # the deepest busy slot: the page walk scales with occupancy
            key = paged_key(max(int(self.pos[s]) // self.pool.page_size + 1
                                for s in busy), self.pool.n_logical)
            host["block_table"] = self.pool.block_table[:, :key[1]]
        toks = self._decode(key, host)
        self.decode_invocations += 1
        toks = toks.tolist()            # sync point: device step complete
        if self.rec.enabled:
            t1 = self.rec.clock()
            self.rec.add_complete("decode_step", t0, t1 - t0,
                                  busy=len(busy))
            self.rec.record("decode_step_s", t1 - t0)
        now = time.monotonic()
        for s in busy:
            req = self.slot_req[s]
            self.pos[s] += 1
            cursor = int(self.prompt_cursor[s])
            if cursor < len(req.prompt):
                if self.pos[s] >= self.max_len - 1:
                    # the prompt overran the cache: finish instead of
                    # spinning past the last writable slot
                    self._finish(req, now, slot=s)
                    continue
                # still consuming the prompt: feed its next token
                self.cur_tok[s] = int(req.prompt[cursor])
                self.prompt_cursor[s] = cursor + 1
                continue
            tok = int(toks[s])
            if not req.output:
                req.first_token_at = now
            req.output.append(tok)
            self.cur_tok[s] = tok
            finished = (
                len(req.output) >= req.max_new_tokens
                or (self.eos is not None and tok == self.eos)
                or self.pos[s] >= self.max_len - 1
            )
            if finished:
                self._finish(req, now, slot=s)
        return len(busy)

    def _decode(self, key, host):
        """One decode step over all B slots from the int32 host arrays
        ``host`` (tokens (B, 1), pos (B,), on the paged plane the block
        table trimmed to ``key``'s width).  Returns the sampled tokens (B,)
        on the device."""
        toks, state = self._run(key, self._run_step, self._decode_state(),
                                host)
        if self._paged:
            _, self.pool.arena, self.pool.kv_scales, self.resident = state
        else:
            _, self.cache = state
        return toks

    def _decode_state(self) -> tuple:
        """What the decode step reads and updates in place: (params,
        arena, scales, resident) on the paged plane, else (params,
        cache)."""
        if self._paged:
            return (self.params, self.pool.arena, self.pool.kv_scales,
                    self.resident)
        return self.params, self.cache

    def rebind(self, model, params):
        """Serve ``model`` over ``params`` after the cell's mesh changed:
        the pool's arena (int8 with its scale tables), the resident rows,
        the dense cache and a snapshot pool's interned payloads are
        re-laid onto the new model's layout (contents kept, old shards
        freed), the checkpoint workspace holds its capacity in the new
        layout, the steps are rebuilt over the new model, the scratch
        caches and the slot reset come anew when next needed, and every
        step graph is dropped."""
        self.model, self.params = model, params
        T = self.temperature

        def _relay_into(old, new):   # old's values in new's layout
            return tree_map(lambda dst, src: relay_leaf(src, into=dst),
                            new, old)
        if self.pool is not None:
            self.pool.rebind(model)
        if self._ckpts is not None:
            self._ckpts.rebind(model)
        if self._paged:
            self.resident = _relay_into(self.resident, init_resident(
                model, self.B, self.max_len, self.device))
            self._step = build_paged_serve_step(model, T,
                                                template=self.pool.template)
            self._extend = build_paged_extend_step(
                model, T, template=self.pool.template)
        else:
            self.cache = _relay_into(self.cache, model.init_cache(
                self.B, self.max_len, device=self.device))
            self._step = build_serve_step(model, T)
            self._extend = build_extend_step(model, T)
        if self._prefill is not None:
            self._prefill = build_prefill_step(
                model, T, checkpoint_every=(self.pool.page_size
                                            if self._snapshot else None))
        self._run_step = self._stepper(self._step)
        self._run_extend = self._stepper(self._extend)
        self._scratch_caches = {}
        self._slot_init_cache = None
        if self.step_graph is not None:
            for path in ("decode", "prefill", "extend", "restore"):
                self.step_graph.drop(path)
            self.step_graph.capture = _one_card(model)

    def state_tensors(self) -> list:
        """Every tensor the batcher's steps read or update in place (and
        so every tensor its graphs capture, beside their static inputs):
        params, the pool's arena and scales, the resident rows, the dense
        cache, the prefill scratch caches, the checkpoint workspace and
        the token-at-a-time slot reset."""
        trees = [self.params, self.resident, self.cache,
                 self._scratch_caches, self._slot_init_cache]
        if self.pool is not None:
            trees += [self.pool.arena, self.pool.kv_scales]
        if self._ckpts is not None:
            trees.append(self._ckpts._flat)
        return [t for t in tree_leaves(trees) if isinstance(t, torch.Tensor)]

    def close(self):
        """Release the steps' CUDA graphs and their memory pool."""
        if self.step_graph is not None:
            self.step_graph.release()

    def run_until_drained(self, max_steps: int = 100_000) -> List[Request]:
        steps = 0
        while ((self.queue or any(r is not None for r in self.slot_req))
               and steps < max_steps):
            self.step()
            steps += 1
        return self.done


def _one_card(model) -> bool:
    """Do the model's positions all sit on one device (so a step over
    them is one CUDA graph)?"""
    return (not getattr(model, "sharded", False)
            or len(model.ctx.mesh.distinct_devices()) == 1)


