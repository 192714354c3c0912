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

Not ported yet: snapshot pools (ROADMAP queue 1 item 8) and the
disaggregated hand-off surfaces (queue 1 item 11).
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
    open_decode,
    open_request,
    recorder_of,
    span_group,
)
from repro_torch.device import resolve_device
from repro_torch.models.cache_utils import (
    cache_batch_axes,
    merge_cache_slots,
    slice_cache_slots,
    strip_kv_nodes,
)
from repro_torch.models.param import tree_leaves
from repro_torch.serve.kvpool import (
    KVPool,
    PoolExhausted,
    build_paged_extend_step,
    build_paged_serve_step,
    public_ctx_key,
    request_ctx_key,
    run_extend_group,
)
from repro_torch.serve.serve_step import (
    bucket_len,
    build_prefill_step,
    build_serve_step,
    run_prefill_group,
    supports_chunked_prefill,
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


class ContinuousBatcher:
    """Slot-based continuous batching over prefill, extend and decode
    steps, on ``device`` (default ``"cuda"``).  ``kv_pool``: "auto" (a
    paged pool where the cache layout allows one, else the dense per-slot
    cache), None (the dense cache) or a prebuilt KVPool."""

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
        self._paged = self.pool is not None
        self._cache_axes = cache_batch_axes(model, batch_slots, max_len)
        self._resident_axes = strip_kv_nodes(self._cache_axes)
        if self._paged:
            self.cache = None
            self.resident = strip_kv_nodes(self.pool.template)
            self._step = build_paged_serve_step(model, temperature,
                                                template=self.pool.template)
            self._extend = build_paged_extend_step(
                model, temperature, template=self.pool.template)
        else:
            self.cache = model.init_cache(batch_slots, max_len,
                                          device=self.device)
            self.resident = None
            self._step = build_serve_step(model, temperature)
        self.prefill_chunk = prefill_chunk
        self.chunked = (prefill_chunk is not None
                        and supports_chunked_prefill(model, max_len))
        self._prefill = (build_prefill_step(model, temperature)
                         if self.chunked else None)
        # per slot: index of the next prompt token a token-at-a-time admit
        # feeds through the decode step (the prompt length once consumed)
        self.prompt_cursor = np.zeros(batch_slots, np.int64)
        # sampling draws (temperature > 0) from a seeded generator
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._scratch_caches: Dict[int, Any] = {}  # B -> B-row prefill cache
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
    def _scratch(self, batch: int):
        """B-row prefill scratch cache (fixes the cache length), reused."""
        if batch not in self._scratch_caches:
            self._scratch_caches[batch] = self.model.init_cache(
                batch, self.max_len, device=self.device)
        return self._scratch_caches[batch]

    def _prefill_group(self, group):
        """ONE prefill invocation over same-bucket (slot, request, lease)
        triples of cold requests, then the KV installs into the pool's
        pages or the slots' dense rows."""
        B = len(group)
        reqs = [r for _, r, _ in group]
        slots = [s for s, _, _ in group]
        t0 = self.rec.clock()
        toks, rows_cache, b_pad = run_prefill_group(
            self._prefill, self.params, self._scratch, reqs,
            chunk=self.prefill_chunk, max_len=self.max_len,
            generator=self.generator, device=self.device,
            accounting=self.accounting)
        t1 = self.rec.clock()
        span_group(self.rec, "prefill", reqs, t0, t1, kind="cold",
                   batch=len(group))
        self.rec.record("prefill_s", t1 - t0)
        self.prefill_invocations += 1
        self.prefill_batch_sizes.append(B)
        if not self._paged:
            if b_pad != B:
                rows_cache = slice_cache_slots(rows_cache, self._cache_axes,
                                               list(range(B)))
            self._install_rows(slots, reqs, rows_cache, toks[:B])
            return
        for i, (slot, req, lease) in enumerate(group):
            self.pool.install_rows(slot, req.prompt, request_ctx_key(req),
                                   rows_cache, i, lease.pages)
        self._merge_resident_rows(rows_cache, list(range(B)), slots)
        self._post_install(slots, reqs, toks[:B])

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
            self._extend, self.params, self.pool, reqs, leases, bt_rows,
            chunk=self.prefill_chunk, max_len=self.max_len,
            generator=self.generator, accounting=self.accounting)
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

    def _install_rows(self, slots, reqs, rows_cache, first_tokens):
        """Write prefilled dense KV rows (batch dim ``len(slots)``) into
        their slots with one scatter, then the per-request bookkeeping."""
        self.cache = merge_cache_slots(self.cache, rows_cache,
                                       self._cache_axes, slots)
        self._post_install(slots, reqs, first_tokens)

    def _merge_resident_rows(self, rows_cache, rows, slots):
        """Copy the non-paged remainder of the given prefill rows into the
        batcher's resident tree (the dense and MoE families have none;
        encdec cross memory comes with ROADMAP queue 1 item 7)."""
        res = strip_kv_nodes(rows_cache)
        if not tree_leaves(res):
            return
        res = slice_cache_slots(res, self._resident_axes, rows)
        self.resident = merge_cache_slots(self.resident, res,
                                          self._resident_axes, slots)

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

    def _admit_fallback(self, slot: int, req: Request):
        """Token-at-a-time admission: the prompt is fed through the decode
        step one token per step.  A reused slot's stale KV is masked by
        position, so nothing is reset (the non-positional state of encdec
        and ssm/hybrid comes with ROADMAP queue 1 items 7 and 8)."""
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
        for _, group in sorted(cold.items()):
            self._prefill_group(group)
        for _, group in sorted(warm.items()):
            self._extend_group(group)

    # -- one decode step over all busy slots -------------------------------
    def step(self) -> int:
        self._admit()
        busy = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not busy:
            return 0
        t0 = self.rec.clock()
        dev = self.device
        batch = {"tokens": torch.from_numpy(self.cur_tok[:, None].copy()).to(dev),
                 "pos": torch.from_numpy(self.pos.copy()).to(dev)}
        if self._paged:
            # map the page each busy slot is about to write (from the
            # pocket its admission reserved: cannot fail mid-decode)
            for s in busy:
                self.pool.ensure_decode_page(s, int(self.pos[s]))
            # width-trim the block table to the pow2 page bucket covering
            # the deepest busy slot: the page walk scales with occupancy
            n_act = max(int(self.pos[s]) // self.pool.page_size + 1
                        for s in busy)
            width = min(1 << (n_act - 1).bit_length(), self.pool.n_logical)
            bt = torch.from_numpy(np.ascontiguousarray(
                self.pool.block_table[:, :width])).to(dev)
            toks, self.pool.arena, self.pool.kv_scales, self.resident = \
                self._step(self.params, self.pool.arena, self.pool.kv_scales,
                           self.resident, bt, batch, self.generator)
        else:
            toks, _logits, self.cache = self._step(self.params, self.cache,
                                                   batch, self.generator)
        self.decode_invocations += 1
        toks = toks.tolist()            # sync point: device step complete
        t1 = self.rec.clock()
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

    def run_until_drained(self, max_steps: int = 100_000) -> List[Request]:
        steps = 0
        while ((self.queue or any(r is not None for r in self.slot_req))
               and steps < max_steps):
            self.step()
            steps += 1
        return self.done
