"""The page plane: dense cache rows, the physical page arena, int8 pages.

A serving cache is a tree (dicts and NamedTuples) whose nodes are either
KV nodes (:class:`~repro_torch.models.layers.KVSlice`, or a
:class:`~repro_torch.models.layers.PagedKVCache` view) or dense
*resident* state: nothing for the dense family, the Mamba states of the
ssm and hybrid families (hybrid nests its shared-attention KVSlice beside
them in a ``ZambaGroupCache``), the cross memory and ``src_len`` of the
encdec decoder (beside its self-KV node in a ``DecCache``).  KV nodes are
visited in the order in which JAX flattens the same tree: dict keys
sorted, NamedTuple fields in order.

A *page* is ``page_size`` consecutive positions of one request's KV across
every layer.  The canonical page layout moves a KV node's (batch, seq)
axes to the front, ``(num_pages, page_size, *rest)``, so one page id
addresses the same positions in every leaf.  A block table maps
``(slot, logical_page) -> physical_page``; entries ``>= num_pages`` are
unmapped sentinels: reads see them as empty (slot_pos -1) and writes to
them drop.  Arena updates happen IN PLACE where the JAX package donated
the arena buffers to a jitted update.

Over a mesh the helpers that move a slot's rows take global slot and row
numbers (``sharding/sharded.py``'s ``move_rows``, ``take_rows``,
``row_owners``): a cache's batch dim may be split over the data axes, a
row is read on the data row that holds it and written only on the data
rows that hold its destination.  The page arena, the page stacks and the
snapshot payloads have no batch dim and lie whole on every data row.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.models.layers import KVSlice, PagedKVCache
from repro_torch.models.param import (
    init_params,
    is_namedtuple,
    is_pspec,
    resolve_dtype,
    tree_leaves,
    tree_map,
    tree_map_pspec,
)
from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import (
    Sharded,
    move_rows,
    position_pspecs,
    row_axes,
    row_owners,
    shard_at,
    take_rows,
)


def _is_kv(x) -> bool:
    return isinstance(x, (KVSlice, PagedKVCache))


def _map_kv(tree: Any, fn) -> Any:
    """``tree`` with ``fn`` applied to every KV node, in JAX's flatten
    order (dict keys sorted); other nodes kept."""
    if _is_kv(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_kv(tree[k], fn) for k in sorted(tree)}
    if is_namedtuple(tree):
        return type(tree)(*(_map_kv(v, fn) for v in tree))
    return tree


def cache_batch_axes(model, batch: int, max_len: int) -> Any:
    """Tree (same structure as the cache) of per-leaf batch-axis indices."""
    return tree_map_pspec(lambda s: s.logical.index("batch"),
                          model.cache_specs(batch, max_len))


def slice_cache_slots(cache: Any, axes: Any, slots: Sequence[int]) -> Any:
    """The given slot rows of every cache leaf (batch dim len(slots),
    whole on every position of a mesh)."""
    return tree_map(lambda c, a: take_rows(c, a, slots), cache, axes)


def merge_cache_slots(dst: Any, src: Any, axes: Any, slots: Sequence[int],
                      rows: Sequence[int] = None) -> Any:
    """Write ``src``'s rows ``rows`` (default its first ``len(slots)``, in
    order) into ``dst`` at ``slots``, in place; over a mesh each row is
    read where it lies and written where its slot lies.  Returns
    ``dst``."""
    tree_map(lambda d, s, a: move_rows(d, a, slots, s, rows), dst, src, axes)
    return dst


def kv_cache_nodes(cache: Any) -> list:
    """The cache's KV nodes, in JAX's flatten order."""
    out: list = []
    _map_kv(cache, out.append)
    return out


def strip_kv_nodes(cache: Any) -> Any:
    """The cache with every KV node replaced by None: the *resident* part
    that stays dense per slot (nothing for the dense family, the Mamba
    states for ssm and hybrid, the cross memory for encdec)."""
    return _map_kv(cache, lambda n: None)


def init_resident(model, batch: int, max_len: int, device) -> Any:
    """The resident part of a ``batch``-row cache at its init values,
    without allocating the KV nodes (a sharded model's, per position)."""
    specs = strip_kv_nodes(model.cache_specs(batch, max_len))
    if getattr(model, "sharded", False):
        return model.position_tree(
            lambda m, d, b: init_resident(m, b, max_len, d), specs, batch)
    return init_params(specs, None, model.cfg.dtype, device)


def install_cross_memory(cache: Any, mem, slots: Sequence[int]) -> Any:
    """Write encdec cross memory into rows ``slots`` of a cache (a whole
    cache or its resident part), in place.  ``mem`` = (cross_k (L, B,
    S_src, Hkv, Dh), cross_v, src_len (B,)) with B == len(slots), as
    ``Model.encode_cross_rows`` gives it (JAX's batcher's route for a
    token-at-a-time admission).  Returns ``cache``."""
    ck, cv, src_len = mem
    dec = cache["dec_layers"]
    move_rows(dec.cross_k, 1, slots, ck)
    move_rows(dec.cross_v, 1, slots, cv)
    move_rows(dec.src_len, 1, slots,
              src_len[None].expand(dec.src_len.shape[0], -1))
    return cache


def rebuild_kv_nodes(template: Any, resident: Any, nodes: list) -> Any:
    """Inverse of ``strip_kv_nodes``: splice ``nodes`` (flatten order)
    back into ``resident`` where ``template`` holds a KV node."""
    it = iter(nodes)

    def build(t, r):
        if _is_kv(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k], r[k]) for k in sorted(t)}
        if is_namedtuple(t):
            return type(r)(*(build(tv, rv) for tv, rv in zip(t, r)))
        return r
    return build(template, resident)


def kv_node_axes(model, batch: int, max_len: int) -> list:
    """Per-KV-node batch-axis index (seq is always batch + 1)."""
    return [n.k.logical.index("batch")
            for n in kv_cache_nodes(model.cache_specs(batch, max_len))]


def kv_position_bytes(model, max_len: int) -> int:
    """Bytes of KV cache held per token position (all layers, one slot)."""
    total = 0
    for node in kv_cache_nodes(model.cache_specs(1, max_len)):
        for spec in node:
            n = 1
            for d in spec.shape:
                n *= d
            itemsize = resolve_dtype(spec, model.cfg.dtype).itemsize
            total += n * itemsize // max_len
    return total


def recurrent_state_bytes(model, max_len: int) -> int:
    """Bytes of one slot's non-positional cache state (everything that is
    not a KV node: the Mamba conv and ssm states): the size of one
    recurrent-state snapshot."""
    total = 0
    for spec in tree_leaves(strip_kv_nodes(model.cache_specs(1, max_len)),
                            is_leaf=is_pspec):
        n = 1
        for d in spec.shape:
            n *= d
        total += n * resolve_dtype(spec, model.cfg.dtype).itemsize
    return total


def clear_kv_row(cache: Any, axes: list, row: int) -> Any:
    """Mark every KV position of one slot row empty (slot_pos -1), in
    place, so a snapshot restore into a recycled slot leaves no stale
    attendable position behind the restored prefix.  Returns ``cache``."""
    for node, a in zip(kv_cache_nodes(cache), axes):
        for _, sp, lo in row_owners(node.slot_pos, a, row):
            _to_canonical(sp, a)[lo] = -1
    return cache


def load_pages_into_row(cache: Any, axes: list, row: int, stacks: list,
                        start_page: int, page_size: int) -> Any:
    """Write canonical page stacks into one row of a dense cache at logical
    pages ``start_page ..``, in place: how a restored snapshot chain's
    shared-attention pages become the row's resident prefix.  Returns
    ``cache``."""
    lo = start_page * page_size
    for node, stack, a in zip(kv_cache_nodes(cache), stacks, axes):
        n = stack.k.shape[0] * page_size
        for leaf, s in zip(node, stack):
            for r, shard, i in row_owners(leaf, a, row):
                v = shard_at(s, r)
                _to_canonical(shard, a)[i, lo:lo + n] = v.reshape(
                    (n,) + v.shape[2:]).to(shard.device, shard.dtype)
    return cache


def _to_canonical(leaf: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(leaf, (axis, axis + 1), (0, 1))


def _from_canonical(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(x, (0, 1), (axis, axis + 1))


def page_arena(model, num_pages: int, page_size: int, device) -> list:
    """Physical page arena: one contiguous canonical ``(num_pages,
    page_size, *rest)`` KVSlice per KV node, k/v zeroed and slot_pos -1
    (every page empty).  A sharded model's arena is one per position, its
    kv heads split as each position's attention reads them."""
    if getattr(model, "sharded", False):
        return model.position_tree(
            lambda m, d, _: page_arena(m, num_pages, page_size, d),
            page_arena(type(model)(model.cfg), num_pages, page_size,
                       torch.device("meta")))
    nodes = init_params(
        kv_cache_nodes(model.cache_specs(num_pages, page_size)), None,
        model.cfg.dtype, device)
    axes = kv_node_axes(model, num_pages, page_size)
    return [KVSlice(*(_to_canonical(x, a).contiguous() for x in n))
            for n, a in zip(nodes, axes)]


def extract_row_pages(cache: dict, axes: list, row: int, start_page: int,
                      n_pages: int, page_size: int) -> list:
    """``n_pages`` canonical page stacks (one (n_pages, P, *rest) tensor
    per k/v/slot_pos of each KV node) out of one row of a dense cache.  A
    Sharded leaf laid out with its sequence dim whole (by heads) gives
    stacks laid out as its other dims are, whole on every data row (a
    row of a batch dim split over the data axes is gathered from the data
    row that holds it)."""
    lo, hi = start_page * page_size, (start_page + n_pages) * page_size

    def e(leaf, a):
        i = row
        if row_axes(leaf, a):
            leaf, i = take_rows(leaf, a, [row]), 0
        x = _to_canonical(leaf, a)[i, lo:hi]
        x = x.reshape((n_pages, page_size) + x.shape[1:])
        spec = getattr(leaf, "spec", None)
        if isinstance(leaf, Sharded) and spec is not None and not (
                spec.axes_of(a) or spec.axes_of(a + 1)):
            x.spec = P(None, None, *(spec[d] if d < len(spec) else None
                                     for d in range(leaf.dim())
                                     if d not in (a, a + 1)))
        return x
    return [KVSlice(*(e(x, a) for x in node))
            for node, a in zip(kv_cache_nodes(cache), axes)]


class PayloadLayout:
    """Where a model's serving payloads land on its cell: laid out as the
    model's own caches are (over a mesh by position: each position's kv
    heads, a Mamba state's parts; a row's batch dim whole on every data
    row).  :meth:`target` is what ``ArrayChannel.send`` takes: the device
    of a one-position model, else its mesh and the payload's
    PartitionSpec tree.  The kinds:

    * ``"row"``: a 1-row cache (a dense handoff);
    * ``"paged"``: {"stacks": canonical page stacks, "resident": the
      1-row resident remainder} (a paged handoff, a slot's migration);
    * ``"snapshot"``: {"row": a 1-row cache, "chain": ``n`` snapshot
      payloads or None} (a snapshot handoff);
    * ``"stacks"``: canonical page stacks; ``"snapshots"``: ``n``
      snapshot payloads (an interned subtree's migration)."""

    def __init__(self, model, max_len: int, device):
        self.device = device
        self.mesh = (model.ctx.mesh if getattr(model, "sharded", False)
                     else None)
        if self.mesh is None:
            return
        b_axes = model.ctx.pspec(("batch",), (1,)).axes_of(0)
        row = position_pspecs(model.local.cache_specs(model.local_batch(1),
                                                          max_len),
                              model.cache_specs(1, max_len), self.mesh,
                              b_axes)
        self.row = row
        self.resident = strip_kv_nodes(row)
        # a stack of a node's pages: its (batch, seq) dims become the
        # (page, position) dims in front, every other dim as the cache's
        self.stacks = [
            KVSlice(*(P(None, None, *(e for d, e in enumerate(s)
                                      if d not in (a, a + 1)))
                      for s in node))
            for node, a in zip(kv_cache_nodes(row),
                               kv_node_axes(model, 1, max_len))]
        self.snapshot = ({"state": model.state_node(row),
                          "pages": self.stacks}
                         if model.supports_snapshot_state else None)

    def target(self, kind: str, n: int = 0):
        if self.mesh is None:
            return self.device
        specs = {"row": lambda: self.row,
                 "paged": lambda: {"stacks": self.stacks,
                                   "resident": self.resident},
                 "snapshot": lambda: {"row": self.row,
                                      "chain": [self.snapshot] * n},
                 "stacks": lambda: self.stacks,
                 "snapshots": lambda: [self.snapshot] * n}[kind]()
        return self.mesh, specs


def _ids(page_ids, device) -> torch.Tensor:
    return torch.as_tensor(page_ids, dtype=torch.long, device=device)


def write_arena_pages(arena: list, page_ids, stacks: list) -> list:
    """Write canonical page stacks into the arena at ``page_ids``, in
    place.  Returns the arena."""
    for a, s in zip(arena, stacks):
        idx = _ids(page_ids, a.k.device)
        a.k[idx] = s.k.to(a.k.dtype)
        a.v[idx] = s.v.to(a.v.dtype)
        a.slot_pos[idx] = s.slot_pos
    return arena


def keep_layout(out, like):
    """``out`` (a Sharded computed position by position from ``like``,
    with the same dims split) laid out as ``like`` is; a plain tensor as
    it is."""
    if isinstance(out, Sharded):
        out.spec = like.spec
    return out


def read_arena_pages(arena: list, page_ids) -> list:
    """Canonical page stacks for ``page_ids`` (copies; inverse of write),
    laid out as the arena is."""
    out = []
    for a in arena:
        idx = _ids(page_ids, a.k.device)
        out.append(KVSlice(*(keep_layout(x[idx], x) for x in a)))
    return out


def clean_arena_pages(arena: list, page_ids) -> list:
    """Mark every position of the given pages empty (slot_pos -1), in
    place, so a recycled page's stale contents are never attended."""
    for a in arena:
        a.slot_pos[_ids(page_ids, a.k.device)] = -1
    return arena


def paged_view(template: dict, resident: dict, arena: list,
               block_table: torch.Tensor, scales=None) -> dict:
    """The cache that carries the arena THROUGH the model: each KV node
    becomes a PagedKVCache over the whole arena node plus the batch's
    block table (``layer`` 0; the layer loop rebinds it).  ``scales``:
    per-node ``(k_scale, v_scale)`` for int8 arenas, or None."""
    nodes = []
    for i, a in enumerate(arena):
        ks, vs = scales[i] if scales is not None else (None, None)
        nodes.append(PagedKVCache(k=a.k, v=a.v, slot_pos=a.slot_pos,
                                  block_table=block_table, layer=0,
                                  k_scale=ks, v_scale=vs))
    return rebuild_kv_nodes(template, resident, nodes)


def extract_paged(cache: dict):
    """Inverse of :func:`paged_view`: (arena nodes, scales, resident)."""
    nodes = kv_cache_nodes(cache)
    arena = [KVSlice(k=n.k, v=n.v, slot_pos=n.slot_pos) for n in nodes]
    scales = [(n.k_scale, n.v_scale) for n in nodes]
    if all(k is None for k, _ in scales):
        scales = None
    return arena, scales, strip_kv_nodes(cache)


# --------------------------------------------------------------------------
# int8 KV pages: per-page symmetric quantization
# --------------------------------------------------------------------------
def _bshape(ndim: int, keep_axes, scale_shape) -> tuple:
    shape = [1] * ndim
    for a, s in zip(keep_axes, scale_shape):
        shape[a] = s
    return tuple(shape)


def quantize_page(x: torch.Tensor, *, keep_axes=(0,), amax=None):
    """Symmetric int8 quantization with one scale per kept-axes index
    (``(0, 2)`` on a canonical ``(n_pages, P, L, Hkv, Dh)`` stack gives
    one scale per (page, layer)).  Returns ``(q int8, scale float32)``;
    all-zero groups get scale 0.  ``amax`` reduces each group's max
    further (over a mesh, a ``pmax`` over the positions holding parts of
    the group)."""
    x32 = x.to(torch.float32)
    red = tuple(a for a in range(x.ndim) if a not in keep_axes)
    top = x32.abs().amax(dim=red)
    if amax is not None:
        top = amax(top)
    scale = top / 127.0
    b = scale.reshape(_bshape(x.ndim, keep_axes, scale.shape))
    q = torch.round(x32 / b.clamp(min=1e-8)).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_page(q: torch.Tensor, scale: torch.Tensor, *, keep_axes=(0,)):
    """Inverse of :func:`quantize_page` (float32 output)."""
    b = scale.reshape(_bshape(q.ndim, keep_axes, scale.shape))
    return q.to(torch.float32) * b


def mask_pad_slots_(cache: Any, length: torch.Tensor) -> Any:
    """Invalidate dense-cache slots at or beyond each row's true prompt
    length (``slot_pos`` -1), in place, so decode attention never sees the
    bucket padding's K/V.  Recurrent state is left alone.  Returns
    ``cache``."""
    def fix(node):
        if isinstance(node, KVSlice):
            s_c = node.slot_pos.shape[-1]
            pad = (torch.arange(s_c, dtype=torch.int32, device=length.device)
                   >= length[:, None])
            node.slot_pos.masked_fill_(pad, -1)
        return node
    _map_kv(cache, fix)
    return cache
