"""Cluster cache plane: prefix-locality routing and live KV page migration.

The port's copy of ``repro/serve/cacheplane.py`` (it loads no framework;
the port keeps its own copy all the same).  Each decode replica keeps its
own pool and prefix tree; nothing here shares mutable state between
cells, and the index holds digests, never pages.

* Replicas advertise their interned roots (digest, depth, refcount) as
  control-plane messages to a supervisor-held :class:`PrefixIndex`;
  ``DisaggServer.pump`` consults it to route a warm prompt to the replica
  holding its deepest prefix.
* When pages must move (drain before detach), a replica-to-replica
  ``ArrayChannel`` of ``kind="pages"`` opened through the supervisor
  carries exported subtrees (``KVPool.export_subtree`` /
  ``import_subtree``, refcount-correct re-interning), and a shrinking
  replica hands its hot prefixes and in-flight slots to survivors before
  its zone is released.

An interned page is bit-identical to what any replica would compute for
the same chunk, so migrated pages serve like locally interned ones.  The
plane keys on chunk digests and moves opaque exported subtrees, so
snapshot pools (ssm / hybrid state checkpoints) advertise and migrate the
same way.  The digests hash each chunk's tokens as int64 bytes, the same
bytes as the JAX package's, so both route identically.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.models.cache_utils import PayloadLayout


def chunk_digests(prompt, ctx_key, page_size: int,
                  limit: Optional[int] = None) -> List[str]:
    """Cumulative digests of a prompt's full ``page_size``-token chunks
    under a namespace root: ``digests[d-1]`` identifies the depth-``d``
    prefix chain, with the namespace key folded into the seed so equal
    token chunks in different tenants' namespaces never collide.  Capped
    like ``PrefixTree.match`` (at least one suffix token stays
    computable) unless ``limit`` says otherwise."""
    h = hashlib.sha1(repr(ctx_key).encode())
    P = page_size
    n = max(len(prompt) - 1, 0) // P if limit is None else limit
    out: List[str] = []
    for lp in range(n):
        h.update(np.asarray(prompt[lp * P:(lp + 1) * P],
                            np.int64).tobytes())
        out.append(h.hexdigest())
    return out


def advertise(pool, max_nodes: Optional[int] = None) -> List[dict]:
    """A replica's cache advert: every interned node as ``{"digest",
    "depth", "refs"}``, digests computed cumulatively down each chain
    (compatible with :func:`chunk_digests` over the same tokens).  Pure
    metadata — no tokens and no page data leave the cell."""
    entries: List[dict] = []
    for ctx_key, root in pool.tree._roots.items():
        seed = hashlib.sha1(repr(ctx_key).encode())
        stack: List[tuple] = [(root, seed, 0)]
        while stack:
            node, h, depth = stack.pop()
            for key, child in node.children.items():
                h2 = h.copy()
                h2.update(np.asarray(key, np.int64).tobytes())
                entries.append({"digest": h2.hexdigest(),
                                "depth": depth + 1, "refs": child.refs})
                if max_nodes is not None and len(entries) >= max_nodes:
                    return entries
                stack.append((child, h2, depth + 1))
    return entries


class PrefixIndex:
    """Digest -> holders map over replica adverts (supervisor-held).

    ``update`` replaces a replica's whole advert (adverts are snapshots,
    not deltas); ``best`` answers routing queries deepest-prefix-first
    with a deterministic candidate-order tie-break."""

    def __init__(self):
        self._holders: Dict[str, Dict[str, dict]] = {}
        self._by_replica: Dict[str, List[str]] = {}

    def update(self, replica: str, entries: List[dict]):
        self.drop(replica)
        digests: List[str] = []
        for e in entries:
            self._holders.setdefault(e["digest"], {})[replica] = e
            digests.append(e["digest"])
        self._by_replica[replica] = digests

    def drop(self, replica: str):
        for d in self._by_replica.pop(replica, ()):
            holders = self._holders.get(d)
            if holders is not None:
                holders.pop(replica, None)
                if not holders:
                    del self._holders[d]

    def replicas(self) -> List[str]:
        return list(self._by_replica)

    def __len__(self) -> int:
        return len(self._holders)

    def best(self, digests: List[str],
             candidates: Iterable[str]) -> Tuple[Optional[str], int]:
        """Deepest advertised prefix of ``digests`` held by any
        candidate; the FIRST candidate (caller's order — stable replica
        ordering) wins ties.  Returns ``(replica, depth)`` or
        ``(None, 0)``."""
        for depth in range(len(digests), 0, -1):
            holders = self._holders.get(digests[depth - 1])
            if not holders:
                continue
            for name in candidates:
                if name in holders:
                    return name, depth
        return None, 0


class CachePlane:
    """The supervisor-held side of the cluster cache plane.

    Owns the :class:`PrefixIndex` and the advert endpoint on the
    supervisor's control plane; replicas advertise with FICM-style
    unicast messages (cell -> "cacheplane") and :meth:`refresh` ingests
    them — the index is metadata in the supervisor plane, the pages stay
    isolated in each replica's pool."""

    ENDPOINT = "cacheplane"
    ADVERT = "cache_advert"

    def __init__(self, supervisor, *, page_size: int):
        self.sup = supervisor
        self.page_size = page_size
        self.index = PrefixIndex()
        self.adverts = 0                # advert messages ingested

    def refresh(self, pools: Dict[str, object]):
        """One advert round: every live replica (``name -> pool``) sends
        its interned roots over the control plane; the index ingests the
        messages and forgets replicas that are gone."""
        self.sup.control.register(self.ENDPOINT)
        for name, pool in pools.items():
            if pool is None:
                continue
            self.sup.control.unicast(
                name, self.ENDPOINT, self.ADVERT,
                {"replica": name, "entries": advertise(pool)})
        for msg in self.sup.control.drain(self.ENDPOINT):
            if msg.kind == self.ADVERT:
                self.index.update(msg.payload["replica"],
                                  msg.payload["entries"])
                self.adverts += 1
        for name in self.index.replicas():
            if name not in pools:
                self.index.drop(name)

    def best_replica(self, prompt, ctx_keys: Iterable,
                     candidates: List[str]) -> Tuple[Optional[str], int]:
        """The candidate holding the deepest advertised prefix of
        ``prompt`` under any of the request's namespaces (its own root
        first, then the public grant), or ``(None, 0)`` when no one
        advertises a single chunk."""
        best, best_depth = None, 0
        for ck in ctx_keys:
            name, depth = self.index.best(
                chunk_digests(prompt, ck, self.page_size), candidates)
            if depth > best_depth:
                best, best_depth = name, depth
        return best, best_depth


def migrate_prefixes(src_pool, dst_pool, channel, *,
                     ctx_keys: Optional[Iterable] = None,
                     max_pages: Optional[int] = None) -> int:
    """Move interned prefix subtrees replica-to-replica: export from
    ``src_pool``, stream the page data over a ``kind="pages"`` array
    channel (copied onto the destination pool's layout: its device, or
    its mesh laid out as its arena or payloads — the on-demand
    inter-subOS path), re-intern into ``dst_pool`` best-effort.  The
    source is untouched (refcounts and pages intact); the destination
    receives refs-0 reclaimable cache charged to each page's original
    owner.  Returns the number of pages newly interned."""
    imported = 0
    keys = list(src_pool.tree._roots) if ctx_keys is None else list(ctx_keys)
    layout = PayloadLayout(dst_pool.model, dst_pool.max_len, dst_pool.device)
    for ck in keys:
        records, stacks = src_pool.export_subtree(ck, max_pages)
        if not records:
            continue
        target = (layout.target("stacks")
                  if dst_pool.payload_kind == "page"
                  else layout.target("snapshots", len(stacks)))
        channel.send_pages(stacks, target,
                           meta={"ctx_key": ck, "records": records})
        env = channel.poll_pages()
        imported += dst_pool.import_subtree(env.meta["ctx_key"],
                                            env.meta["records"], env.cache)
    return imported
