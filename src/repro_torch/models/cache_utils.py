"""The page plane: dense cache rows, the physical page arena, int8 pages.

A serving cache is a dict whose values are either KV nodes
(:class:`~repro_torch.models.layers.KVSlice`, or a
:class:`~repro_torch.models.layers.PagedKVCache` view) or dense
*resident* state (nothing, for the dense family).  The helpers here take
those explicit NamedTuples of tensors; KV nodes are visited in sorted-key
order, the order in which JAX flattens the same dict.

A *page* is ``page_size`` consecutive positions of one request's KV across
every layer.  The canonical page layout moves a KV node's (batch, seq)
axes to the front, ``(num_pages, page_size, *rest)``, so one page id
addresses the same positions in every leaf.  A block table maps
``(slot, logical_page) -> physical_page``; entries ``>= num_pages`` are
unmapped sentinels: reads see them as empty (slot_pos -1) and writes to
them drop.  Arena updates happen IN PLACE where the JAX package donated
the arena buffers to a jitted update.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.models.layers import KVSlice, PagedKVCache
from repro_torch.models.param import tree_map, tree_map_pspec


def _is_kv(x) -> bool:
    return isinstance(x, (KVSlice, PagedKVCache))


def cache_batch_axes(model, batch: int, max_len: int) -> Any:
    """Tree (same structure as the cache) of per-leaf batch-axis indices."""
    return tree_map_pspec(lambda s: s.logical.index("batch"),
                          model.cache_specs(batch, max_len))


def slice_cache_slots(cache: Any, axes: Any, slots: Sequence[int]) -> Any:
    """The given slot rows of every cache leaf (batch dim len(slots))."""
    def take(c, a):
        return c.index_select(a, torch.as_tensor(list(slots),
                                                 device=c.device))
    return tree_map(take, cache, axes)


def merge_cache_slots(dst: Any, src: Any, axes: Any,
                      slots: Sequence[int]) -> Any:
    """Write ``src`` rows (batch dim ``len(slots)``) into ``dst`` at
    ``slots``, in place.  Returns ``dst``."""
    def put(d, s, a):
        d.index_copy_(a, torch.as_tensor(list(slots), device=d.device),
                      s.to(d.dtype))
        return d
    return tree_map(put, dst, src, axes)


def kv_cache_nodes(cache: dict) -> list:
    """The cache's KV nodes, in sorted-key order."""
    return [cache[k] for k in sorted(cache) if _is_kv(cache[k])]


def strip_kv_nodes(cache: dict) -> dict:
    """The cache with every KV node replaced by None: the *resident* part
    that stays dense per slot (nothing for the dense family)."""
    return {k: (None if _is_kv(v) else v) for k, v in cache.items()}


def rebuild_kv_nodes(template: dict, resident: dict, nodes: list) -> dict:
    """Inverse of ``strip_kv_nodes``: splice ``nodes`` (sorted-key order)
    back into ``resident`` where ``template`` holds a KV node."""
    it = iter(nodes)
    return {k: (next(it) if _is_kv(template[k]) else resident[k])
            for k in sorted(template)}


def kv_node_axes(model, batch: int, max_len: int) -> list:
    """Per-KV-node batch-axis index (seq is always batch + 1)."""
    return [n.k.logical.index("batch")
            for n in kv_cache_nodes(model.cache_specs(batch, max_len))]


def kv_position_bytes(model, max_len: int) -> int:
    """Bytes of KV cache held per token position (all layers, one slot)."""
    from repro_torch.models.param import resolve_dtype
    total = 0
    for node in kv_cache_nodes(model.cache_specs(1, max_len)):
        for spec in node:
            n = 1
            for d in spec.shape:
                n *= d
            itemsize = resolve_dtype(spec, model.cfg.dtype).itemsize
            total += n * itemsize // max_len
    return total


def _to_canonical(leaf: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(leaf, (axis, axis + 1), (0, 1))


def _from_canonical(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(x, (0, 1), (axis, axis + 1))


def page_arena(model, num_pages: int, page_size: int, device) -> list:
    """Physical page arena: one contiguous canonical ``(num_pages,
    page_size, *rest)`` KVSlice per KV node, k/v zeroed and slot_pos -1
    (every page empty)."""
    full = model.init_cache(num_pages, page_size, device=device)
    axes = kv_node_axes(model, num_pages, page_size)
    return [KVSlice(*(_to_canonical(x, a).contiguous() for x in n))
            for n, a in zip(kv_cache_nodes(full), axes)]


def extract_row_pages(cache: dict, axes: list, row: int, start_page: int,
                      n_pages: int, page_size: int) -> list:
    """``n_pages`` canonical page stacks (one (n_pages, P, *rest) tensor
    per k/v/slot_pos of each KV node) out of one row of a dense cache."""
    lo, hi = start_page * page_size, (start_page + n_pages) * page_size

    def e(leaf, a):
        x = _to_canonical(leaf, a)[row, lo:hi]
        return x.reshape((n_pages, page_size) + x.shape[1:])
    return [KVSlice(*(e(x, a) for x in node))
            for node, a in zip(kv_cache_nodes(cache), axes)]


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


def read_arena_pages(arena: list, page_ids) -> list:
    """Canonical page stacks for ``page_ids`` (copies; inverse of write)."""
    out = []
    for a in arena:
        idx = _ids(page_ids, a.k.device)
        out.append(KVSlice(k=a.k[idx], v=a.v[idx], slot_pos=a.slot_pos[idx]))
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


def quantize_page(x: torch.Tensor, *, keep_axes=(0,)):
    """Symmetric int8 quantization with one scale per kept-axes index
    (``(0, 2)`` on a canonical ``(n_pages, P, L, Hkv, Dh)`` stack gives
    one scale per (page, layer)).  Returns ``(q int8, scale float32)``;
    all-zero groups get scale 0."""
    x32 = x.to(torch.float32)
    red = tuple(a for a in range(x.ndim) if a not in keep_axes)
    scale = x32.abs().amax(dim=red) / 127.0
    b = scale.reshape(_bshape(x.ndim, keep_axes, scale.shape))
    q = torch.round(x32 / b.clamp(min=1e-8)).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_page(q: torch.Tensor, scale: torch.Tensor, *, keep_axes=(0,)):
    """Inverse of :func:`quantize_page` (float32 output)."""
    b = scale.reshape(_bshape(q.ndim, keep_axes, scale.shape))
    return q.to(torch.float32) * b


def mask_pad_slots(cache: dict, length: torch.Tensor) -> dict:
    """Invalidate dense-cache slots at or beyond each row's true prompt
    length (``slot_pos`` -1) so decode attention never sees the bucket
    padding's K/V."""
    def fix(node):
        if isinstance(node, KVSlice):
            s_c = node.slot_pos.shape[-1]
            valid = (torch.arange(s_c, dtype=torch.int32,
                                  device=length.device)
                     < length[:, None])
            return node._replace(slot_pos=torch.where(valid, node.slot_pos,
                                                      -1))
        return node
    return {k: fix(v) for k, v in cache.items()}

