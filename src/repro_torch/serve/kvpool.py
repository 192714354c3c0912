"""KVPool: paged KV memory with radix-tree prefix sharing.

The port of ``repro/serve/kvpool.py`` in page mode.  Each request's KV
lives in page-granular private allocations (pages of ``page_size``
positions across all layers) mapped by a block table ``(slot,
logical_page) -> physical_page``; immutable, fully written prompt pages
are *interned* into a :class:`PrefixTree` with refcounts, and a later
request whose prompt shares a cached prefix maps those pages read-only and
prefills only its suffix.  The partial boundary page is always private, so
decode never writes a shared page.  Admission reserves each request's
worst-case page *pocket* up front and blocks (the request stays queued)
when the pool cannot cover it; refcount-0 interned pages are LRU-evicted
to make room.  Tenants with page quotas get bulkheaded pockets; a public
namespace is shared read-only.

The decode and extend steps are natively paged: ``paged_view`` hands the
model the arena itself behind each row's block table, attention writes
the new K/V straight into the physical pages and the paged kernels walk
the pages in place.  The arena is updated in place (the JAX package
donated it to jitted steps).  With ``kv_dtype="int8"`` the arena stores
int8 pages with one float32 scale per (page, layer).

Snapshot payloads (recurrent-state families), the slot-less prefill-worker
cache and replica-to-replica migration are not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.cache_utils import (
    clean_arena_pages,
    extract_paged,
    extract_row_pages,
    kv_node_axes,
    kv_position_bytes,
    page_arena,
    paged_view,
    quantize_page,
    read_arena_pages,
    strip_kv_nodes,
    write_arena_pages,
)
from repro_torch.models.layers import KVSlice
from repro_torch.serve.serve_step import bucket_len, sample_tokens
from repro_torch.serve.tenancy import COMMONS, DEFAULT_TENANT, PUBLIC


class PoolExhausted(RuntimeError):
    """No free or evictable page is left — the caller must requeue."""


def request_ctx_key(req) -> Optional[tuple]:
    """Prefix-tree root key for a request: its tenant namespace.  The
    default tenant keeps the root None; a ``public`` request lives under
    the shared public root; any other tenant gets a private root."""
    if getattr(req, "public", False):
        return ("public",)
    tenant = getattr(req, "tenant", DEFAULT_TENANT)
    if tenant != DEFAULT_TENANT:
        return ("tenant", tenant)
    return None


def public_ctx_key(req) -> Optional[tuple]:
    """The public-namespace root a granted tenant may match read-only;
    None when the request already lives there."""
    if getattr(req, "public", False):
        return None
    return ("public",)


def _owner(ctx_key, tenant) -> str:
    """Billing owner of pages interned under ``ctx_key``."""
    if ctx_key is not None and ctx_key and ctx_key[0] == "public":
        return PUBLIC
    return tenant if tenant is not None else DEFAULT_TENANT


class _Node:
    """One interned page: a ``page_size``-token chunk under its parent."""

    __slots__ = ("parent", "key", "children", "page", "refs", "last_used",
                 "owner")

    def __init__(self, parent, key, page, owner=None):
        self.parent = parent
        self.key = key                  # tuple of page_size token ids
        self.children: Dict[tuple, "_Node"] = {}
        self.page = page                # physical page id (None for roots)
        self.refs = 0
        self.last_used = 0
        self.owner = owner              # tenant / PUBLIC the page bills to


class PrefixTree:
    """Radix tree over ``page_size``-token chunks with refcounted pages.

    Only full pages are interned, so every match is exact.  Refcounts
    track live users; refcount-0 nodes are cache, reclaimable LRU."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._roots: Dict[Optional[tuple], _Node] = {}
        self._clock = 0
        self.interned = 0               # live interned (non-root) nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def root(self, ctx_key) -> _Node:
        if ctx_key not in self._roots:
            self._roots[ctx_key] = _Node(None, None, None)
        return self._roots[ctx_key]

    def match(self, prompt, ctx_key) -> List[_Node]:
        """Longest chain of interned chunks matching ``prompt``, leaving at
        least one suffix token to compute (it yields the first output)."""
        P = self.page_size
        node = self._roots.get(ctx_key)
        out: List[_Node] = []
        if node is None:
            return out
        for lp in range(max(len(prompt) - 1, 0) // P):
            child = node.children.get(
                tuple(int(t) for t in prompt[lp * P:(lp + 1) * P]))
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def acquire(self, nodes: List[_Node]):
        now = self._tick()
        for n in nodes:
            n.refs += 1
            n.last_used = now

    def release(self, nodes: List[_Node]):
        now = self._tick()
        for n in nodes:
            if n.refs <= 0:
                raise RuntimeError("refcount underflow on an interned page")
            n.refs -= 1
            n.last_used = now

    def insert(self, parent: _Node, key: tuple, page: int,
               owner=None) -> _Node:
        if key in parent.children:
            raise KeyError("chunk already interned under its parent")
        node = _Node(parent, key, page, owner)
        node.last_used = self._tick()
        parent.children[key] = node
        self.interned += 1
        return node

    def _walk(self):
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.page is not None:
                yield n

    def evictable_pages(self, visible=None) -> int:
        """Interned pages whose whole subtree is refcount-0 (one iterative
        bottom-up pass); with ``visible``, only nodes the caller may
        reclaim."""
        total = 0
        pinned: Dict[int, bool] = {}
        for root in self._roots.values():
            stack = [(root, False)]
            while stack:
                n, seen = stack.pop()
                if not seen:
                    stack.append((n, True))
                    stack.extend((c, False) for c in n.children.values())
                    continue
                p = n.refs > 0 or any(pinned[id(c)]
                                      for c in n.children.values())
                pinned[id(n)] = p
                if (n.page is not None and not p
                        and (visible is None or visible(n))):
                    total += 1
        return total

    def evict_lru(self, visible=None) -> Optional[Tuple[_Node, int]]:
        """Detach the least-recently-used refcount-0 LEAF; returns (node,
        freed page id) or None when nothing is evictable."""
        best: Optional[_Node] = None
        for n in self._walk():
            if (n.refs == 0 and not n.children
                    and (visible is None or visible(n))
                    and (best is None or n.last_used < best.last_used)):
                best = n
        if best is None:
            return None
        del best.parent.children[best.key]
        self.interned -= 1
        return best, best.page


@dataclasses.dataclass
class PrefixLease:
    """An acquired (incref'd) chain of shared prefix nodes, held from
    lookup until its pages map into a slot or the request is abandoned.
    ``foreign`` marks a chain matched in the public namespace: read-only."""

    nodes: List[_Node]
    page_size: int
    released: bool = False
    foreign: bool = False

    @property
    def pages(self) -> int:
        return len(self.nodes)

    @property
    def tokens(self) -> int:
        return len(self.nodes) * self.page_size


class KVPool:
    """Page-granular KV arena + block table + prefix tree for one batcher.

    Admission reserves a private-page pocket of the request's worst case
    (``ceil((prompt + max_new) / page_size)`` minus the shared prefix) so
    decode growth never fails mid-request."""

    def __init__(self, model, *, max_len: int, page_size: int = 16,
                 slots: int = 1, num_pages: Optional[int] = None,
                 accounting=None, quotas: Any = None,
                 kv_dtype: Optional[str] = None, device="cuda"):
        if not model.supports_paged_kv:
            raise NotImplementedError(
                "snapshot pools come with the ssm port (ROADMAP queue 1 "
                "item 8)")
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} not a multiple of "
                             f"page_size={page_size}")
        self.device = resolve_device(device)
        self.model = model
        self.max_len = max_len
        self.page_size = page_size
        self.slots = slots
        self.n_logical = max_len // page_size
        self.num_pages = int(num_pages if num_pages is not None
                             else (slots + 2) * self.n_logical)
        if self.num_pages < self.n_logical:
            raise ValueError("pool smaller than one request's worst case")
        self.template = model.cache_specs(1, max_len)
        self.axes = kv_node_axes(model, 1, max_len)
        self.position_bytes = kv_position_bytes(model, max_len)
        self.arena = page_arena(model, self.num_pages, page_size, self.device)
        if kv_dtype is None:
            self.kv_scales = None
        elif kv_dtype == "int8":
            # int8 pages with one float32 scale per (page, layer) per
            # tensor: quantised on page write, dequantised in the kernels
            self.arena = [KVSlice(k=torch.zeros_like(a.k, dtype=torch.int8),
                                  v=torch.zeros_like(a.v, dtype=torch.int8),
                                  slot_pos=a.slot_pos) for a in self.arena]
            self.kv_scales = [
                tuple(torch.zeros((self.num_pages, a.k.shape[2]),
                                  dtype=torch.float32, device=self.device)
                      for _ in range(2))
                for a in self.arena]
        else:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.sentinel = self.num_pages          # unmapped block-table entry
        self.block_table = np.full((slots, self.n_logical), self.sentinel,
                                   np.int32)
        self.tree = PrefixTree(page_size)
        self.free: deque = deque(range(self.num_pages))
        self.accounting = accounting
        # per slot: shared tree nodes, private pages, reserved pocket
        self._shared: List[List[_Node]] = [[] for _ in range(slots)]
        self._private: List[List[int]] = [[] for _ in range(slots)]
        self._pocket: List[List[int]] = [[] for _ in range(slots)]
        # tenant bulkheads: pocket name -> page budget; every allocated
        # page is charged to exactly one pocket in ``used``
        if callable(quotas):
            quotas = quotas(self.num_pages)
        if quotas is not None:
            if sum(quotas.values()) > self.num_pages:
                raise ValueError(
                    f"quota pockets sum to {sum(quotas.values())}, "
                    f"pool has only {self.num_pages} pages")
            if any(q < 0 for q in quotas.values()):
                raise ValueError("negative page quota pocket")
        self.quotas = dict(quotas) if quotas is not None else None
        self.used: Dict[str, int] = ({p: 0 for p in quotas}
                                     if quotas is not None else {})
        self._slot_tenant: List[Optional[str]] = [None] * slots
        self._slot_foreign: List[bool] = [False] * slots
        self.pages_evicted = 0
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.kv_bytes_saved = 0

    # -- arena writes (in place) ----------------------------------------
    def _clean_pages(self, page_ids):
        """Mark pages empty; int8 arenas also zero their scales so the
        lazy decode scale init sees them untouched."""
        clean_arena_pages(self.arena, page_ids)
        if self.kv_scales is not None:
            idx = torch.as_tensor(page_ids, dtype=torch.long,
                                  device=self.device)
            for ks, vs in self.kv_scales:
                ks[idx] = 0.0
                vs[idx] = 0.0

    def _write_pages(self, page_ids, stacks):
        """Write FLOAT canonical page stacks; an int8 arena quantizes them
        per (page, layer) and updates its scale tables."""
        if self.kv_scales is None:
            write_arena_pages(self.arena, page_ids, stacks)
            return
        idx = torch.as_tensor(page_ids, dtype=torch.long, device=self.device)
        for a, (ks, vs), s in zip(self.arena, self.kv_scales, stacks):
            kq, ksc = quantize_page(s.k, keep_axes=(0, 2))
            vq, vsc = quantize_page(s.v, keep_axes=(0, 2))
            a.k[idx] = kq
            a.v[idx] = vq
            a.slot_pos[idx] = s.slot_pos
            ks[idx] = ksc
            vs[idx] = vsc

    # -- capability ------------------------------------------------------
    @staticmethod
    def capability(model, max_len: int, page_size: int) -> str:
        """What cache payload this config can share: ``"paged"`` (KV in
        an absolute-position layout) or ``"none"`` (page-misaligned
        cache, or a rolling window shorter than the cache)."""
        w = model.cfg.sliding_window
        if max_len % page_size or not (w is None or w >= max_len):
            return "none"
        return "paged" if model.supports_paged_kv else "none"

    # -- occupancy -------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """Allocated pages (slot-held, pocketed, or interned cache)."""
        return self.num_pages - len(self.free)

    def evictable_pages(self) -> int:
        return self.tree.evictable_pages()

    def _pocket_of(self, tenant: Optional[str]) -> Optional[str]:
        """Charge pocket: a quota'd tenant's own, else the commons."""
        if self.quotas is None:
            return None
        if tenant is not None and tenant in self.quotas:
            return tenant
        return COMMONS

    def _pocket_visible(self, pocket: str):
        """Eviction candidates for a requester charged to ``pocket``."""
        return lambda n: self._pocket_of(n.owner) == pocket

    def _gauge(self):
        if self.accounting is not None:
            self.accounting.record_gauge("pages_in_use", self.pages_in_use)

    def _evicted(self, tenant=None):
        self.pages_evicted += 1
        if self.accounting is not None:
            self.accounting.record_counter("pages_evicted", tenant=tenant)

    # -- page supply -----------------------------------------------------
    def _alloc_raw(self, tenant: Optional[str] = None) -> Optional[int]:
        """One page charged to ``tenant``'s pocket, evicting refcount-0
        cache (of the same pocket, under quotas) when none is free."""
        if self.quotas is None:
            if self.free:
                return self.free.popleft()
            evicted = self.tree.evict_lru()
            if evicted is None:
                return None
            self._evicted()
            return evicted[1]
        pocket = self._pocket_of(tenant)
        if self.used[pocket] >= self.quotas[pocket]:
            evicted = self.tree.evict_lru(self._pocket_visible(pocket))
            if evicted is None:
                return None             # quota exhausted, pool untouched
            self._evicted(tenant)
            return evicted[1]
        if not self.free:
            raise RuntimeError("bulkhead invariant broken: headroom without "
                               "a free page")
        self.used[pocket] += 1
        return self.free.popleft()

    def _uncharge(self, tenant: Optional[str], n: int):
        if self.quotas is None or n == 0:
            return
        pocket = self._pocket_of(tenant)
        self.used[pocket] -= n
        if self.used[pocket] < 0:
            raise RuntimeError(f"pocket {pocket} charge underflow")

    def _take_pocket(self, slot: int) -> int:
        if not self._pocket[slot]:
            raise RuntimeError("pocket underflow: admission reserved too few "
                               "pages")
        return self._pocket[slot].pop()

    # -- prefix lookup ---------------------------------------------------
    def lease(self, prompt, ctx_key=None, alt_key=None) -> PrefixLease:
        """Match + acquire the longest interned prefix for ``prompt``;
        ``alt_key`` is the read-only public fallback (longer chain wins,
        the request's own namespace on ties)."""
        nodes = self.tree.match(prompt, ctx_key)
        foreign = False
        if alt_key is not None:
            alt = self.tree.match(prompt, alt_key)
            if len(alt) > len(nodes):
                nodes, foreign = alt, True
        self.tree.acquire(nodes)
        return PrefixLease(nodes=nodes, page_size=self.page_size,
                           foreign=foreign)

    def empty_lease(self) -> PrefixLease:
        """A zero-page lease (a token-at-a-time admit)."""
        return PrefixLease(nodes=[], page_size=self.page_size)

    def release_lease(self, lease: PrefixLease):
        if lease is None or lease.released:
            return
        self.tree.release(lease.nodes)
        lease.released = True

    def note_lookup(self, prompt_len: int, hit_tokens: int):
        """Record a prefix lookup's hit/miss token split."""
        self.prefix_hit_tokens += hit_tokens
        self.prefix_miss_tokens += prompt_len - hit_tokens
        saved = hit_tokens * self.position_bytes
        self.kv_bytes_saved += saved
        if self.accounting is not None:
            self.accounting.record_counter("prefix_hit_tokens", hit_tokens)
            self.accounting.record_counter("prefix_miss_tokens",
                                           prompt_len - hit_tokens)
            if saved:
                self.accounting.record_counter("kv_bytes_saved", saved)

    # -- slot lifecycle --------------------------------------------------
    def required_pages(self, prompt_len: int, max_new: int,
                       shared_pages: int = 0) -> int:
        """Worst-case private pages a request can touch (at least one
        post-prompt position), minus its shared prefix."""
        last = min(prompt_len + max(max_new, 1), self.max_len)
        return -(-last // self.page_size) - shared_pages

    def admit(self, slot: int, lease: PrefixLease, prompt_len: int,
              max_new: int, tenant: Optional[str] = None):
        """Commit a slot to a request: map the lease's shared pages (the
        lease's ownership moves to the slot) and reserve the full private
        pocket, charged to ``tenant``.  Raises :class:`PoolExhausted`,
        with the lease still the caller's, when the pool or the tenant's
        pocket cannot cover the worst case."""
        if self._shared[slot] or self._private[slot] or self._pocket[slot]:
            raise RuntimeError(f"slot {slot} not released")
        need = self.required_pages(prompt_len, max_new, lease.pages)
        got: List[int] = []
        for _ in range(need):
            page = self._alloc_raw(tenant)
            if page is None:
                self._uncharge(tenant, len(got))
                self.free.extend(got)
                if self.accounting is not None and self.quotas is not None:
                    self.accounting.record_counter("quota_blocked",
                                                   tenant=tenant)
                raise PoolExhausted(
                    f"need {need} pages, got {len(got)} "
                    f"(free={len(self.free)}, "
                    f"evictable={self.evictable_pages()}, "
                    f"tenant={tenant!r})")
            got.append(page)
        self._slot_tenant[slot] = tenant
        self._slot_foreign[slot] = lease.foreign
        if got:
            self._clean_pages(got)
        self._pocket[slot] = got
        for lp, node in enumerate(lease.nodes):
            self.block_table[slot, lp] = node.page
        self._shared[slot] = list(lease.nodes)
        lease.released = True            # ownership moved to the slot
        self.note_lookup(prompt_len, lease.tokens)
        self._gauge()

    def _transfer_charge(self, tenant: Optional[str], owner) -> bool:
        """Move one page's charge from ``tenant``'s pocket to ``owner``'s;
        False (the page stays private) when the destination pocket cannot
        absorb it even after reclaiming its own idle cache."""
        if self.quotas is None:
            return True
        src = self._pocket_of(tenant)
        dst = self._pocket_of(owner)
        if src == dst:
            return True
        if self.used[dst] >= self.quotas[dst]:
            evicted = self.tree.evict_lru(self._pocket_visible(dst))
            if evicted is None:
                return False
            self.pages_evicted += 1
            self.free.append(evicted[1])
            self.used[dst] -= 1
        self.used[src] -= 1
        self.used[dst] += 1
        return True

    def map_private(self, slot: int, logical_page: int) -> int:
        """Map a pocket page at ``logical_page``."""
        page = self._take_pocket(slot)
        self.block_table[slot, logical_page] = page
        self._private[slot].append(page)
        return page

    def ensure_decode_page(self, slot: int, pos: int):
        """Before a decode step: map the page holding ``pos`` (from the
        slot's pocket, so it cannot fail)."""
        lp = pos // self.page_size
        if self.block_table[slot, lp] == self.sentinel:
            self.map_private(slot, lp)

    def map_suffix_pages(self, slot: int, prompt_len: int):
        """Map pocket pages under every logical page a suffix extend will
        write: the paged extend writes K/V straight into them, and a
        sentinel entry would drop the write."""
        for lp in range(-(-prompt_len // self.page_size)):
            if self.block_table[slot, lp] == self.sentinel:
                self.map_private(slot, lp)

    def promote_slot_pages(self, slot: int, prompt, ctx_key):
        """Intern a warm-extended slot's full prompt pages by ownership
        transfer (the extend already wrote them in place): a chunk not yet
        interned joins the tree as the slot's page; a chunk already there
        remaps the slot to it and frees the private copy.  The partial
        boundary page stays private; a foreign-prefix slot never
        interns."""
        if self._slot_foreign[slot]:
            return
        P = self.page_size
        tenant = self._slot_tenant[slot]
        owner = _owner(ctx_key, tenant)
        parent = (self._shared[slot][-1] if self._shared[slot]
                  else self.tree.root(ctx_key))
        for lp in range(len(self._shared[slot]), len(prompt) // P):
            page = int(self.block_table[slot, lp])
            key = tuple(int(t) for t in prompt[lp * P:(lp + 1) * P])
            node = parent.children.get(key)
            if node is not None:
                self.block_table[slot, lp] = node.page
                self._private[slot].remove(page)
                self.free.append(page)
                self._uncharge(tenant, 1)
            elif self._transfer_charge(tenant, owner):
                node = self.tree.insert(parent, key, page, owner)
                self._private[slot].remove(page)
            else:
                break                   # owner pocket full: stay private
            node.refs += 1
            node.last_used = self.tree._tick()
            self._shared[slot].append(node)
            parent = node
        self._gauge()

    def install_stacks(self, slot: int, prompt, ctx_key,
                       stacks: List[KVSlice], start_page: int):
        """Map a request's computed pages (canonical stacks covering
        logical pages ``start_page ..`` through the prompt's last page)
        into ``slot``: full prompt pages are interned (copied into tree
        pages, refcount held by the slot), the partial boundary page stays
        private, and the page holding position ``len(prompt)`` is mapped
        for the first decode write."""
        P = self.page_size
        L = len(prompt)
        n = stacks[0].k.shape[0] if stacks else 0
        tenant = self._slot_tenant[slot]
        owner = _owner(ctx_key, tenant)
        can_intern = not self._slot_foreign[slot]
        parent = (self._shared[slot][-1] if self._shared[slot]
                  else self.tree.root(ctx_key))
        new_ids: List[int] = []         # pages needing a data write,
        new_rows: List[int] = []        # batched into one arena write
        for j in range(n):
            lp = start_page + j
            node = None
            if can_intern and (lp + 1) * P <= L:
                key = tuple(int(t) for t in prompt[lp * P:(lp + 1) * P])
                node = parent.children.get(key)
                if node is None:
                    if self._transfer_charge(tenant, owner):
                        page = self._take_pocket(slot)
                        node = self.tree.insert(parent, key, page, owner)
                        new_ids.append(page)
                        new_rows.append(j)
                    else:
                        can_intern = False
            if node is not None:
                node.refs += 1
                node.last_used = self.tree._tick()
                self._shared[slot].append(node)
                self.block_table[slot, lp] = node.page
                parent = node
            else:
                page = self._take_pocket(slot)
                new_ids.append(page)
                new_rows.append(j)
                self._private[slot].append(page)
                self.block_table[slot, lp] = page
        if new_ids:
            self._write_pages(new_ids, read_arena_pages(stacks, new_rows))
        self.ensure_decode_page(slot, L)
        self._gauge()

    def install_rows(self, slot: int, prompt, ctx_key, rows_cache,
                     row: int, start_page: int):
        """``install_stacks`` fed from one row of a dense prefill cache."""
        P = self.page_size
        n_total = -(-len(prompt) // P)
        stacks = extract_row_pages(rows_cache, self.axes, row, start_page,
                                   n_total - start_page, P)
        self.install_stacks(slot, prompt, ctx_key, stacks, start_page)

    def release_slot(self, slot: int):
        """Free a slot: decref its shared prefix (it stays interned as
        reclaimable cache), return private and pocket pages to the free
        list, unmap the block-table row."""
        self.tree.release(self._shared[slot])
        self._shared[slot] = []
        self._uncharge(self._slot_tenant[slot],
                       len(self._private[slot]) + len(self._pocket[slot]))
        self.free.extend(self._private[slot])
        self._private[slot] = []
        self.free.extend(self._pocket[slot])
        self._pocket[slot] = []
        self._slot_tenant[slot] = None
        self._slot_foreign[slot] = False
        self.block_table[slot, :] = self.sentinel
        self._gauge()


# --------------------------------------------------------------------------
# steps over the paged cache
# --------------------------------------------------------------------------
def build_paged_serve_step(model, temperature, *, template):
    """paged_step(params, arena, scales, resident, block_table, batch,
    generator) -> (next_tokens, arena, scales, resident).

    Native paged decode: ``Model.decode`` sees the arena itself behind
    each row's block table; attention writes the new token's K/V into its
    physical page in place and the paged decode kernel walks the row's
    pages.  The block table may be width-trimmed to the live page
    bucket."""
    def paged_step(params, arena, scales, resident, block_table, batch,
                   generator):
        cache = paged_view(template, resident, arena, block_table, scales)
        logits, new_cache = model.decode(params, cache, batch)
        arena, scales, resident = extract_paged(new_cache)
        toks = sample_tokens(logits, generator, temperature)
        return toks, arena, scales, resident
    return paged_step


def build_paged_extend_step(model, temperature, *, template):
    """paged_extend(params, arena, scales, resident, block_table, batch,
    generator) -> (first_tokens, arena, scales, resident): the suffix
    twin of ``build_paged_serve_step`` over ``Model.prefill_extend``.
    Each row's block table must already map every page its suffix
    writes."""
    def paged_extend(params, arena, scales, resident, block_table, batch,
                     generator):
        cache = paged_view(template, resident, arena, block_table, scales)
        logits, new_cache = model.prefill_extend(params, batch, cache)
        arena, scales, resident = extract_paged(new_cache)
        toks = sample_tokens(logits, generator, temperature)
        return toks, arena, scales, resident
    return paged_extend


def run_extend_group(extend_fn, params, pool: KVPool, reqs,
                     leases: List[PrefixLease], bt_rows, *, chunk: int,
                     max_len: int, generator, accounting=None):
    """ONE native-paged suffix-extend invocation over prefix-hit rows.

    The batch pads to the next power of two with all-sentinel dummy rows
    (writes drop, reads mask, outputs discarded); all suffixes share one
    pad bucket, each row carries its own prefix offset ``pos``.  The block
    table is width-trimmed to the power-of-two page bucket covering the
    longest prompt.  The suffix K/V lands in the pool's arena in place.
    Returns (first_tokens, resident rows, b_pad)."""
    B = len(reqs)
    b_pad = 1 << (B - 1).bit_length()
    P = pool.page_size
    prefix = [lease.tokens for lease in leases] + [0] * (b_pad - B)
    suffixes = [np.asarray(r.prompt[h:], np.int32)
                for r, h in zip(reqs, prefix)]
    s_pad = bucket_len(max(len(s) for s in suffixes), chunk, max_len)
    tokens = np.zeros((b_pad, s_pad), np.int32)
    lengths = np.zeros((b_pad,), np.int32)
    for i, s in enumerate(suffixes):
        tokens[i, :len(s)] = s
        lengths[i] = len(s)
    width = max(-(-len(r.prompt) // P) for r in reqs)
    width = min(1 << (width - 1).bit_length(), pool.n_logical)
    bt = np.full((b_pad, width), pool.sentinel, np.int32)
    bt[:B] = np.asarray(bt_rows, np.int32)[:, :width]
    dev = pool.device
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "pos": torch.tensor(prefix, dtype=torch.int32, device=dev),
             "length": torch.from_numpy(lengths).to(dev)}
    resident = strip_kv_nodes(pool.template)
    toks, pool.arena, pool.kv_scales, rows = extend_fn(
        params, pool.arena, pool.kv_scales, resident,
        torch.from_numpy(bt).to(dev), batch, generator)
    if accounting is not None and b_pad != B:
        accounting.record_counter("prefill_dummy_rows", b_pad - B)
    return toks.tolist(), rows, b_pad
