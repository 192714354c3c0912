"""Model layers: norms, RoPE, attention, MLP, logits.

Attention dispatches on the device of its inputs.  On a CUDA tensor it
runs the hand-written kernels (``kernels/flash_attention`` for training,
prefill and extend, paged or over a dense cache seen as an arena, with
the backward kernel under autograd; ``kernels/decode_attention`` for
paged and dense decode); on a CPU tensor it runs the plain versions:
``flash_attention``'s ``attention_ref`` in train mode (differentiable,
with the written-out backward), and ``chunked_attention``,
``decode_attention_ref`` and ``extend_attention_ref`` below, the same math
the JAX package runs on its CPU path.

Given a sharded ``ctx`` (a mesh of more than one position), attention and
the MLP run tensor-parallel over :class:`~repro_torch.sharding.sharded.
Sharded` weights: q/k/v column-parallel by heads, ``wo`` and ``w_down``
row-parallel, each followed by a ``psum`` over ``model``; the body is the
one-device code run per position (the kernels through ``per_position``).
When the head or kv-head count does not divide the model axis, attention
runs replicated on every position where JAX uses context parallelism (the
same math).  A dense cache sharded on its sequence dim decodes through
``sharded_decode`` (``cfg.sharded_decode``, under JAX's condition) or by
all-gathering the cache, what GSPMD does.  With the batch split over the
data axes a paged arena is whole on every data row: each row's new K/V
are all-gathered over the batch axes and every data row writes them all
at the global block table (the arena's copies stay equal), then attends
its own rows through their block-table rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import gather_pages_ref
from repro_torch.models.param import PSpec
from repro_torch.sharding.collectives import all_gather, pmax, psum, relayout
from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import empty_like_global, per_position
from repro_torch.sharding.sharded import split as split_input

# the kernels' wrappers, run once per position on Sharded arguments
decode_attention = per_position(decode_ops.decode_attention)
paged_decode_attention = per_position(decode_ops.paged_decode_attention)
flash_attention = per_position(flash_ops.flash_attention)
paged_extend_attention = per_position(flash_ops.paged_extend_attention)

F32 = torch.float32
NEG_INF = -1e30


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x, w, eps: float):
    x32 = x.to(F32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.to(F32)).to(x.dtype)


def norm_spec(d: int) -> PSpec:
    return PSpec((d,), (None,), ("const", 1.0))


# --------------------------------------------------------------------------
# RoPE (half-split rotation, not interleaved)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=F32, device=device) / half)


def rope_tables(positions, head_dim: int, theta: float):
    """cos/sin of the rotation angles, (..., S, 1, Dh/2) for positions
    broadcastable to (..., S)."""
    freqs = rope_freqs(head_dim, theta, positions.device)    # (Dh/2,)
    angles = positions.to(F32)[..., None] * freqs            # (..., S, Dh/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x, cos, sin):
    """Apply a half-split rotation with tables from :func:`rope_tables`."""
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------
# plain attention: the CPU path
# --------------------------------------------------------------------------
def _block_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(qc, kc) bool mask of VALID entries from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      kv_len=None):
    """Flash-algorithm attention (running max/sum over KV chunks).

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh); GQA via head grouping.
    kv_len: optional (B,) valid key count per row, keys at positions >=
    kv_len[b] masked out (an encoder's padded source frames).  A q row
    with no valid key gets the mean of V over all keys (never NaN), as in
    JAX; callers must not read it.  Returns (B, Sq, Hq, Dh)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"Sq={Sq}, Skv={Skv} not multiples of the chunks "
                         f"{q_chunk}, {kv_chunk}")
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    qg = q.reshape(B, nq, q_chunk, Hkv, G, Dh)
    kg = k.reshape(B, nk, kv_chunk, Hkv, Dh)
    vg = v.reshape(B, nk, kv_chunk, Hkv, Dh)
    outs = []
    for qi in range(nq):
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=F32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=F32, device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dh), dtype=F32,
                          device=q.device)
        for ki in range(nk):
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, qi].to(F32),
                             kg[:, ki].to(F32)) * scale
            s = torch.where(_block_mask(q_pos, k_pos, causal, window), s,
                            NEG_INF)
            if kv_len is not None:
                row_ok = k_pos[None, :] < kv_len[:, None]         # (B, kc)
                s = torch.where(row_ok[:, None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vg[:, ki].to(F32))
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]             # (B,Hkv,G,qc,Dh)
        outs.append(out.permute(0, 3, 1, 2, 4))               # (B,qc,Hkv,G,Dh)
    out = torch.stack(outs, dim=1).reshape(B, Sq, Hq, Dh)
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, kv_len, *,
                         window: Optional[int] = None, slot_pos=None):
    """Single-position attention against a (possibly rolling) KV cache.

    q: (B, 1, Hq, Dh); k/v_cache: (B, S, Hkv, Dh); kv_len: (B,) valid
    count; slot_pos: (B, S) absolute position per slot, or None meaning
    slot i holds position i.  Returns (B, 1, Hq, Dh).  The dense decode
    kernel's plain version, in the model's layout."""
    return decode_ref.decode_attention_ref(
        q[:, 0], k_cache, v_cache, kv_len, slot_pos=slot_pos,
        window=window)[:, None]


def extend_attention_ref(q, k_cache, v_cache, slot_pos, q_pos, *,
                         window: Optional[int] = None):
    """Multi-position attention against an absolute-position KV cache: a
    slot is attended iff it holds a valid position <= the query's.

    q: (B, S, Hq, Dh); k/v_cache: (B, S_c, Hkv, Dh); slot_pos: (B, S_c)
    (-1 = empty); q_pos: (B, S).  Returns (B, S, Hq, Dh)."""
    B, S, Hq, Dh = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, Dh)
    s = torch.einsum("bshgd,bkhd->bshgk", qg.to(F32),
                     k_cache.to(F32)) / math.sqrt(Dh)
    valid = ((slot_pos[:, None, :] >= 0)
             & (slot_pos[:, None, :] <= q_pos[:, :, None]))    # (B,S,S_c)
    if window is not None:
        valid &= slot_pos[:, None, :] > q_pos[:, :, None] - window
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bshgk,bkhd->bshgd", p, v_cache.to(F32))
    return out.reshape(B, S, Hq, Dh).to(q.dtype)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def attn_specs(cfg: ArchConfig, d_in: Optional[int] = None) -> dict:
    d = d_in or cfg.d_model
    dh = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    specs = {
        "wq": PSpec((d, hq, dh), ("embed", "heads", None), ("normal", 0)),
        "wk": PSpec((d, hkv, dh), ("embed", "kv_heads", None), ("normal", 0)),
        "wv": PSpec((d, hkv, dh), ("embed", "kv_heads", None), ("normal", 0)),
        "wo": PSpec((hq, dh, cfg.d_model), ("heads", None, "embed"),
                    ("normal", 0)),
    }
    if cfg.qkv_bias:
        specs["bq"] = PSpec((hq, dh), ("heads", None), ("const", 0.0))
        specs["bk"] = PSpec((hkv, dh), ("kv_heads", None), ("const", 0.0))
        specs["bv"] = PSpec((hkv, dh), ("kv_heads", None), ("const", 0.0))
    if cfg.qk_norm:
        specs["q_norm"] = norm_spec(dh)
        specs["k_norm"] = norm_spec(dh)
    return specs


class KVSlice(NamedTuple):
    """Per-layer (or layer-stacked) dense KV cache."""
    k: torch.Tensor          # (B, S_cache, Hkv, Dh)
    v: torch.Tensor
    slot_pos: torch.Tensor   # (B, S_cache) int32 absolute position, -1 empty


class PagedKVCache(NamedTuple):
    """Paged KV view: the whole physical page arena + one batch's block
    table (the calling convention of ``serve/kvpool.py``).

    Attention writes the current token(s) IN PLACE into their physical
    pages (entries >= N in the block table drop the write) and reads by
    walking the block-table rows.  ``layer`` selects the arena layer this
    view reads and writes; the model's layer loop rebinds it.

    Precondition: slot ``i`` of logical page ``j`` holds position
    ``j*P + i`` (the KVPool gate guarantees it: no rolling window).

    k/v: (N, P, L, Hkv, Dh) float, or int8 with per-page scales;
    slot_pos: (N, P, L) int32 (-1 = empty); block_table: (B, n_log) int32;
    layer: int; k_scale/v_scale: (N, L) float32 for int8 arenas.
    """
    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor
    block_table: torch.Tensor
    layer: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def paged_gather(cache: PagedKVCache):
    """Walk a block table: (B, n_log*P) dense K/V/slot_pos of the view's
    layer.  Sentinel pages read as masked slots (slot_pos -1); int8 arenas
    are dequantised with their per-page scales."""
    return gather_pages_ref(cache.k, cache.v, cache.slot_pos,
                            cache.block_table, cache.layer, cache.k_scale,
                            cache.v_scale)


def _quantize_to(arena_dtype, vals, scale):
    """Quantize (..., Hkv, Dh) floats with broadcast (...,) scales."""
    q = torch.round(vals.to(F32) / scale.clamp(min=1e-8)[..., None, None])
    return q.clamp(-127, 127).to(arena_dtype)


def _drop_plan(phys, keep):
    """Sync-free form of JAX's ``.at[...].set(mode="drop")``: returns
    ``(rows, j)`` where ``rows`` is ``phys`` with every dropped entry
    redirected onto the first kept entry ``j`` (a 1-element tensor; with
    none kept, entry 0 clamped into range).  Writers then store the kept
    entry's value (or, with none kept, the target's current value) for the
    dropped entries, so duplicate indices always carry equal values and no
    host read of ``keep`` is needed."""
    j = keep.to(torch.int32).argmax().reshape(1)
    return torch.where(keep, phys, phys.index_select(0, j)), j


def _put_rows(dst, rows, j, keep, vals):
    """``dst[rows] = vals`` along dim 0 under a :func:`_drop_plan`."""
    shape = (-1,) + (1,) * (vals.dim() - 1)
    fill = torch.where(keep.index_select(0, j).view(shape),
                       vals.index_select(0, j),
                       dst.index_select(0, rows.index_select(0, j)))
    dst.index_copy_(0, rows, torch.where(keep.view(shape), vals, fill))


def _write_slots(cache: PagedKVCache, phys, off, k, v, positions):
    """Store K/V/positions at (phys, off, layer) for the entries whose page
    is mapped (0 <= phys < N); the others drop.  Writes the arena in
    place, through (N*P)-row views of the view's layer."""
    N, P, L = cache.k.shape[:3]
    phys, off, positions = (x.reshape(-1) for x in (phys, off, positions))
    keep = (phys >= 0) & (phys < N)
    rows, j = _drop_plan(phys.clamp(0, N - 1) * P + off, keep)
    for arena, vals in ((cache.k, k), (cache.v, v),
                        (cache.slot_pos, positions)):
        view = arena.view((N * P, L) + arena.shape[3:])[:, cache.layer]
        _put_rows(view, rows, j, keep,
                  vals.reshape((-1,) + arena.shape[3:]).to(arena.dtype))


def _paged_positions(pos, S: int, mode: str):
    """(B, S) absolute positions of S tokens per row from ``pos`` (B,):
    a decode step's one, a view of ``pos``."""
    if mode == "decode":
        return pos[:, None]
    return pos[:, None] + torch.arange(S, dtype=torch.int32,
                                       device=pos.device)[None, :]


def _paged_write(cache: PagedKVCache, k, v, pos, positions, mode: str,
                 amax=None):
    """The K/V of an extend (S tokens a row at ``positions``) or a decode
    step (one at ``pos``) into their pages, in place.  ``amax`` (int8
    pages over a mesh whose positions hold parts of the kv heads) turns
    each position's max into the max over every head: a ``pmax`` over
    ``model``."""
    if mode == "extend":
        _paged_write_extend(cache, k, v, positions, amax)
    else:
        _paged_write_decode(cache, k[:, 0], v[:, 0], pos, amax)


def _paged_attend(q, cache: PagedKVCache, pos, positions, mode: str,
                  window):
    """Attention of ``q`` over the pages of its rows' block-table rows:
    the paged extend or decode kernel on the card, the plain versions on
    the CPU."""
    if q.is_cuda:
        if mode == "extend":
            return paged_extend_attention(
                q, cache.k, cache.v, cache.slot_pos, cache.block_table, pos,
                cache.layer, k_scale=cache.k_scale, v_scale=cache.v_scale)
        return paged_decode_attention(
            q, cache.k, cache.v, cache.slot_pos, cache.block_table, pos + 1,
            cache.layer, k_scale=cache.k_scale, v_scale=cache.v_scale)
    k_d, v_d, sp_d = paged_gather(cache)
    if mode == "extend":
        return extend_attention_ref(q, k_d, v_d, sp_d, positions,
                                    window=window)
    return decode_attention_ref(q, k_d, v_d, pos + 1, window=window,
                                slot_pos=sp_d)


def _paged_write_decode(cache: PagedKVCache, k, v, pos, amax=None):
    """Write one token per row into its physical page, in place.

    k/v: (B, Hkv, Dh) values for position ``pos`` (B,).  Unmapped target
    pages drop the write.  Int8 arenas lazily initialise the per-page
    scale on first touch (scale 0 = untouched page) from the max over
    the row's kv heads (``amax`` reduces it over a mesh's positions)."""
    N, P = cache.k.shape[0], cache.k.shape[1]
    layer, bt = cache.layer, cache.block_table
    n_log = bt.shape[1]
    lp = (pos // P).long()
    phys = torch.where(lp < n_log,
                       bt.gather(1, lp.clamp(max=n_log - 1)[:, None])[:, 0],
                       N).long()                                    # (B,)
    off = (pos % P).long()
    if cache.k_scale is not None:
        ks, vs = cache.k_scale, cache.v_scale
        physc = phys.clamp(0, N - 1)
        amax_k = k.to(F32).abs().amax(dim=(1, 2))                  # (B,)
        amax_v = v.to(F32).abs().amax(dim=(1, 2))
        if amax is not None:
            amax_k, amax_v = amax(amax_k), amax(amax_v)
        sck = torch.where(ks[physc, layer] > 0, ks[physc, layer],
                          amax_k / 127.0)
        scv = torch.where(vs[physc, layer] > 0, vs[physc, layer],
                          amax_v / 127.0)
        keep = (phys >= 0) & (phys < N)
        rows, j = _drop_plan(physc, keep)
        _put_rows(ks[:, layer], rows, j, keep, sck)
        _put_rows(vs[:, layer], rows, j, keep, scv)
        k = _quantize_to(cache.k.dtype, k, sck)
        v = _quantize_to(cache.v.dtype, v, scv)
    _write_slots(cache, phys, off, k, v, pos)
    return cache


def _paged_write_extend(cache: PagedKVCache, k, v, positions, amax=None):
    """Write S suffix tokens per row into their physical pages, in place.

    k/v: (B, S, Hkv, Dh); positions: (B, S) absolute.  Positions whose
    logical page is beyond the block-table width or unmapped drop the
    write.  Int8 scales take a scatter-max per target (page, layer) of
    each token's max over the kv heads (``amax`` reduces it over a
    mesh's positions)."""
    N, P = cache.k.shape[0], cache.k.shape[1]
    L = cache.k.shape[2]
    layer, bt = cache.layer, cache.block_table
    n_log = bt.shape[1]
    lp = (positions // P).long()
    phys = torch.where(lp < n_log, bt.gather(1, lp.clamp(max=n_log - 1)),
                       N).long()                                    # (B, S)
    off = (positions % P).long()
    if cache.k_scale is not None:
        physc = phys.clamp(0, N - 1)
        keep = (phys >= 0) & (phys < N)
        flat = (physc * L + layer).reshape(-1)
        for sc, x in ((cache.k_scale, k), (cache.v_scale, v)):
            top = x.to(F32).abs().amax(dim=(2, 3))                 # (B, S)
            if amax is not None:
                top = amax(top)
            # a dropped entry maxes 0 into a clamped target: scales are
            # >= 0, so that is no change
            sc.view(-1).scatter_reduce_(
                0, flat, torch.where(keep, top / 127.0, 0.0).reshape(-1),
                reduce="amax", include_self=True)
        k = _quantize_to(cache.k.dtype, k, cache.k_scale[physc, layer])
        v = _quantize_to(cache.v.dtype, v, cache.v_scale[physc, layer])
    _write_slots(cache, phys, off, k, v, positions)
    return cache


def _dense_write_extend(cache: KVSlice, k, v, positions):
    """Write S suffix tokens per row into a dense (B, S_c, ...) cache at
    slots ``positions`` (B, S), in place; positions outside [0, S_c) drop
    their writes, as JAX's ``.at[...].set(mode="drop")``, without a host
    sync."""
    B, S_c = cache.slot_pos.shape
    keep = ((positions >= 0) & (positions < S_c)).reshape(-1)
    flat = (torch.arange(B, device=positions.device)[:, None] * S_c
            + positions.long().clamp(0, S_c - 1)).reshape(-1)
    rows, j = _drop_plan(flat, keep)
    for dst, vals in ((cache.k, k), (cache.v, v),
                      (cache.slot_pos, positions)):
        view = dst.view((B * S_c,) + dst.shape[2:])
        _put_rows(view, rows, j, keep,
                  vals.reshape((-1,) + dst.shape[2:]).to(dst.dtype))


def dense_kv_arena(cache: KVSlice):
    """One layer's dense (B, S_c, Hkv, Dh) cache seen, without a copy, as
    a paged arena (B * S_c / P, P, 1, Hkv, Dh) with P = gcd(S_c, 64), its
    slot_pos as (B * S_c / P, P, 1) and the block table ``bt[b, j] =
    b * S_c / P + j``: the arguments after ``q`` of
    ``paged_extend_attention`` (layer 0)."""
    B, S_c, Hkv, Dh = cache.k.shape
    P = math.gcd(S_c, 64)
    n = B * (S_c // P)
    bt = torch.arange(n, dtype=torch.int32, device=cache.k.device)
    return (cache.k.view(n, P, 1, Hkv, Dh), cache.v.view(n, P, 1, Hkv, Dh),
            cache.slot_pos.view(n, P, 1), bt.view(B, S_c // P))


# --------------------------------------------------------------------------
# attention block (QKV proj + rope + attn + out proj)
# --------------------------------------------------------------------------
def qkv_project(p, x, cfg: ArchConfig, positions):
    """x: (B,S,D) -> q (B,S,Hq,Dh), k,v (B,S,Hkv,Dh), roped."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    cos, sin = rope_tables(positions, q.shape[-1], cfg.rope_theta)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _prefill_into(cache: KVSlice, k, v):
    """Write a prefill's K/V (B, S, ...) into the dense cache ``cache`` in
    place, every slot: the first S positions with zero K/V and ``slot_pos``
    -1 past them, or, on a rolling cache shorter than S, the last S_c
    positions."""
    B, S = k.shape[:2]
    S_c = cache.k.shape[1]
    n = min(S, S_c)
    for dst, src in ((cache.k, k), (cache.v, v)):
        dst[:, :n].copy_(src[:, S - n:])
        dst[:, n:].zero_()
    sp = torch.arange(S - n, S - n + S_c, dtype=torch.int32, device=k.device)
    cache.slot_pos.copy_(torch.where(sp < S, sp, -1)[None].expand(B, S_c))


def attention_block(p, x, cfg: ArchConfig, *, mode: str, cache=None,
                    pos=None, causal: bool = True, kv_len=None,
                    ctx=None) -> Tuple[torch.Tensor, object]:
    """Full attention sublayer.  Returns (out (B,S,D), updated cache).

    ``train`` (training, and an encoder's self-attention) attends
    positions 0..S-1, ``causal`` or not, under the optional (B,) key-length
    mask ``kv_len``, through the differentiable ``flash_attention``, and
    writes no cache.  ``prefill`` writes the prompt's K/V
    into a dense KVSlice (which fixes the cache length; nothing in it is
    read) in place; ``extend`` and ``decode`` take a
    :class:`PagedKVCache` or a dense KVSlice and update the cache in
    place.  A sharded ``ctx`` runs :func:`attention_sharded`."""
    if ctx is not None and ctx.sharded:
        return attention_sharded(p, x, cfg, ctx, mode=mode, cache=cache,
                                 pos=pos, causal=causal, kv_len=kv_len)
    B, S, _ = x.shape
    window = cfg.sliding_window
    on_card = x.is_cuda
    if mode == "train":
        # differentiable on both devices: the flash kernel and its
        # hand-written backward on the card, attention_ref and
        # flash_attention_bwd_ref on the CPU
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = qkv_project(p, x, cfg, positions)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              kv_len=kv_len)
        new_cache = None
    elif mode == "prefill":
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = qkv_project(p, x, cfg, positions)
        if on_card:
            out = flash_attention(q, k, v, causal=True, window=window)
        else:
            out = chunked_attention(q, k, v, causal=True, window=window,
                                    q_chunk=cfg.attn_q_chunk,
                                    kv_chunk=cfg.attn_kv_chunk)
        _prefill_into(cache, k, v)
        new_cache = cache
    elif mode == "decode" and isinstance(cache, KVSlice):
        q, k, v = qkv_project(p, x, cfg, pos[:, None])        # S == 1
        S_c = cache.k.shape[1]
        rolling = window is not None and S_c <= window
        if rolling:
            slot = pos.long() % S_c
        else:
            slot = pos.long().clamp(max=S_c - 1)
        # in place, with 1-D index tensors: nothing is read back to the host
        rows = torch.arange(B, device=x.device)
        cache.k.index_put_((rows, slot), k[:, 0])
        cache.v.index_put_((rows, slot), v[:, 0])
        cache.slot_pos.index_put_((rows, slot), pos.to(torch.int32))
        # Outside a rolling buffer every slot s below kv_len = pos + 1 holds
        # position s (prefill writes position s to slot s, decode position
        # pos to slot pos; padding at or past a prompt's length is
        # overwritten before kv_len reaches it), so the slot_pos mask of
        # JAX's decode_attention_ref reduces to s < kv_len and the kernel
        # stops its key walk there.  A rolling buffer's positions lie
        # anywhere: it passes its slot_pos plane and the kernel walks it all.
        out = decode_attention(q, cache.k, cache.v, pos + 1,
                               slot_pos=cache.slot_pos if rolling else None,
                               window=window)
        new_cache = cache
    elif mode == "extend" and isinstance(cache, KVSlice):
        # the snapshot restore's suffix over the dense per-slot cache: slot
        # i holds position i (the pool gate admits no rolling window), and
        # positions at or past the cache length drop their writes
        positions = pos[:, None] + torch.arange(
            S, dtype=torch.int32, device=x.device)[None, :]
        q, k, v = qkv_project(p, x, cfg, positions)
        _dense_write_extend(cache, k, v, positions)
        if on_card:
            # the paged extend kernel over the cache seen as an arena; its
            # mask 0 <= slot_pos <= q_pos is extend_attention_ref's
            out = paged_extend_attention(q, *dense_kv_arena(cache), pos, 0)
        else:
            out = extend_attention_ref(q, cache.k, cache.v, cache.slot_pos,
                                       positions, window=window)
        new_cache = cache
    elif mode in ("extend", "decode"):
        positions = _paged_positions(pos, S, mode)
        q, k, v = qkv_project(p, x, cfg, positions)
        _paged_write(cache, k, v, pos, positions, mode)
        out = _paged_attend(q, cache, pos, positions, mode, window)
        new_cache = cache
    else:
        raise ValueError(mode)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


# --------------------------------------------------------------------------
# tensor-parallel attention over a mesh
# --------------------------------------------------------------------------
def attn_tp(cfg: ArchConfig, ctx) -> bool:
    """Are heads and kv heads split over the model axis?  Else attention
    runs replicated on every position."""
    m = ctx.model_size()
    return (m > 1 and cfg.num_heads % m == 0
            and cfg.num_kv_heads % m == 0)


def local_attn_cfg(cfg: ArchConfig, ctx) -> ArchConfig:
    """The config one position's attention sees: Hq / m and Hkv / m heads
    under TP, else the full config."""
    if not attn_tp(cfg, ctx):
        return cfg
    m = ctx.model_size()
    return cfg.replace(num_heads=cfg.num_heads // m,
                       num_kv_heads=cfg.num_kv_heads // m)


def _attn_want(name: str, ndim: int, tp: bool, model_axis) -> P:
    """The compute layout of attention weight ``name``: heads over the
    model axis under TP, every other dim whole."""
    m = model_axis if tp else None
    if name in ("wq", "wk", "wv"):
        return P(None, m, None)
    if name in ("wo", "bq", "bk", "bv"):
        return P(*((m,) + (None,) * (ndim - 1)))
    return P(*((None,) * ndim))


def batch_split(ctx, t):
    """A per-row input (B, ...) split over the batch axes as the rules
    split the batch."""
    return split_input(t, ctx.pspec(("batch",) + (None,) * (t.dim() - 1),
                                    t.shape), ctx.mesh)


def batch_axes(ctx, n: int) -> tuple:
    """The mesh axes of size above 1 the rules split a batch of ``n``
    rows over (() when the batch runs whole on every data row)."""
    sizes = ctx.axis_sizes
    return tuple(a for a in ctx.pspec(("batch",), (n,)).axes_of(0)
                 if sizes[a] > 1)


def _paged_mirrored(p, x, cfg, ctx, b_ax, *, mode, cache, pos, tp):
    """Paged extend or decode with the batch split over ``b_ax`` (or
    whole, ``b_ax`` empty): ``x`` holds this data row's rows, ``pos`` (B,)
    and the block table are global.  The new K/V are all-gathered over
    the batch axes and each data row writes every row's into its own copy
    of the arena (the copies stay equal, so a page a slot on one data row
    wrote is there for a slot on another); attention reads this data
    row's block-table rows.  An int8 arena's page scale is the max over
    every kv head, so under TP (``tp``) each position's max is a ``pmax``
    over ``model``: every position and data row then writes the same
    scale into its own copy of the scale tables.  Returns the output
    projection, before the model axis' ``psum``."""
    positions = _paged_positions(pos, x.shape[1], mode)
    pos_l, positions_l = batch_split(ctx, pos), batch_split(ctx, positions)
    q, k, v = qkv_project(p, x, cfg, positions_l)
    k_all, v_all = (all_gather(t, b_ax, dim=0) for t in (k, v))
    amax = None
    if tp and cache.k_scale is not None:
        def amax(t):
            return pmax(t, ctx.model_axis)
    _paged_write(cache, k_all, v_all, pos, positions, mode, amax)
    rows = cache._replace(block_table=batch_split(ctx, cache.block_table))
    out = _paged_attend(q, rows, pos_l, positions_l, mode,
                        cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _seq_split(cache) -> bool:
    return (isinstance(cache, KVSlice) and cache.k.spec is not None
            and cache.k.spec.axes_of(1) != ())


def attention_sharded(p, x, cfg: ArchConfig, ctx, *, mode: str, cache=None,
                      pos=None, causal: bool = True, kv_len=None):
    """:func:`attention_block` over a mesh.  ``x`` (B_l, S, D) is
    replicated over ``model`` (batch-split over the data axes); ``pos``
    the global (B,) positions.  Paged caches and dense caches laid out by
    heads run the one-device code per position with the local heads; a
    dense cache split on its sequence dim takes the sequence paths."""
    tp = attn_tp(cfg, ctx)
    pl = {k: relayout(v, _attn_want(k, v.dim(), tp, ctx.model_axis))
          for k, v in p.items()}
    lcfg = local_attn_cfg(cfg, ctx)
    b_ax = () if pos is None else batch_axes(ctx, pos.shape[0])
    if isinstance(cache, PagedKVCache) and (
            b_ax or (tp and cache.k_scale is not None)):
        y = _paged_mirrored(pl, x, lcfg, ctx, b_ax, mode=mode, cache=cache,
                            pos=pos, tp=tp)
        return (psum(y, ctx.model_axis) if tp else y), cache
    if pos is not None and cache is not None and not isinstance(
            cache, PagedKVCache):
        pos = batch_split(ctx, pos)
    if _seq_split(cache):
        out = _attend_seq_split(pl, x, cfg, lcfg, ctx, tp, mode=mode,
                                cache=cache, pos=pos)
        y = torch.einsum("bshk,hkd->bsd", out, pl["wo"])
    else:
        y, cache = attention_block(pl, x, lcfg, mode=mode, cache=cache,
                                   pos=pos, causal=causal, kv_len=kv_len)
    if tp:
        y = psum(y, ctx.model_axis)
    return y, cache


def _all_heads(t, ctx, tp: bool):
    """(B, S, H_local, Dh) -> every head on every position."""
    return all_gather(t, ctx.model_axis, dim=2) if tp else t


def _local_heads(t, ctx, tp: bool):
    """(B, S, H, Dh) replicated -> this position's heads."""
    if not tp:
        return t
    return relayout(t, P(None, None, ctx.model_axis, None),
                    have=P(None, None, None, None))


def _attend_seq_split(pl, x, cfg, lcfg, ctx, tp, *, mode, cache, pos):
    """Attention over a dense cache split on its sequence dim: prefill
    (every slot written, each position its own), or decode through the
    LSE combine of ``sharded_decode`` or the all-gathered cache.  Returns
    the attention output with this position's heads."""
    from repro_torch.models.sharded_decode import (
        seq_axes,
        sharded_decode_attention,
    )
    B, S, _ = x.shape
    window = cfg.sliding_window
    full = P(*((cache.k.spec[0], None) + (None,) * (cache.k.dim() - 2)))
    if mode == "prefill":
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = qkv_project(pl, x, lcfg, positions)
        if x.is_cuda:
            out = flash_attention(q, k, v, causal=True, window=window)
        else:
            out = chunked_attention(q, k, v, causal=True, window=window,
                                    q_chunk=cfg.attn_q_chunk,
                                    kv_chunk=cfg.attn_kv_chunk)
        whole = KVSlice(*(empty_like_global(a, P(full[0], None))
                          for a in cache))
        _prefill_into(whole, _all_heads(k, ctx, tp), _all_heads(v, ctx, tp))
        for dst, src in zip(cache, whole):
            dst.copy_(relayout(src, dst.spec, have=src.spec))
        return out
    if mode != "decode":
        raise ValueError(f"mode {mode!r} over a cache split on its sequence "
                         "dim (extend runs on caches laid out by heads)")
    q, k, v = qkv_project(pl, x, lcfg, pos[:, None])
    use_sharded = (cfg.sharded_decode and cfg.decode_kv_shard_seq
                   and cache.k.global_shape[0] % max(ctx.dp_size(), 1) == 0
                   and seq_axes(ctx, cache) != ())
    if use_sharded:
        out, _ = sharded_decode_attention(
            ctx, _all_heads(q, ctx, tp), cache, _all_heads(k, ctx, tp),
            _all_heads(v, ctx, tp), pos, window=window)
        return _local_heads(out, ctx, tp)
    return _decode_seq_gathered(q, cache, _all_heads(k, ctx, tp),
                                _all_heads(v, ctx, tp), pos, ctx, tp,
                                window, full)


def _decode_seq_gathered(q, cache, k_all, v_all, pos, ctx, tp, window, full):
    """GSPMD's decode over a sequence-split cache: the owning shard writes
    the new token, then every position all-gathers the layer's cache and
    attends with its own heads."""
    from repro_torch.models.sharded_decode import owner_write
    owner_write(ctx, cache, k_all, v_all, pos, window=window)
    rolling = window is not None and cache.k.global_shape[1] <= window
    k_f = _local_heads(relayout(cache.k, full), ctx, tp)
    v_f = _local_heads(relayout(cache.v, full), ctx, tp)
    sp_f = relayout(cache.slot_pos, P(full[0], None))
    return decode_attention(q, k_f, v_f, pos + 1,
                            slot_pos=sp_f if rolling else None,
                            window=window)


def kv_slice_specs(cfg: ArchConfig, batch: int, max_len: int) -> KVSlice:
    """PSpec tree for one layer's dense KV cache: its sequence dim carries
    the ``kv_seq`` logical axis (sharded over data and model by the
    rules: distributed decode), or ``kv_heads`` its head dim when
    ``cfg.decode_kv_shard_seq`` is off."""
    S_c = (max_len if cfg.sliding_window is None
           else min(max_len, cfg.sliding_window))
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.decode_kv_shard_seq:
        axes = ("batch", "kv_seq", None, None)
    else:
        axes = ("batch", None, "kv_heads", None)
    return KVSlice(
        k=PSpec((batch, S_c, hkv, dh), axes, ("const", 0.0)),
        v=PSpec((batch, S_c, hkv, dh), axes, ("const", 0.0)),
        slot_pos=PSpec((batch, S_c),
                       ("batch", axes[1] if axes[1] == "kv_seq" else None),
                       ("const", -1), dtype="int32"),
    )


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None,
              d_in: Optional[int] = None) -> dict:
    d, f = d_in or cfg.d_model, d_ff or cfg.d_ff
    if cfg.gated_mlp:
        return {
            "w_gate": PSpec((d, f), ("embed", "ffn"), ("normal", 0)),
            "w_up": PSpec((d, f), ("embed", "ffn"), ("normal", 0)),
            "w_down": PSpec((f, d), ("ffn", "embed"), ("normal", 0)),
        }
    return {
        "w_up": PSpec((d, f), ("embed", "ffn"), ("normal", 0)),
        "w_down": PSpec((f, d), ("ffn", "embed"), ("normal", 0)),
    }


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def mlp_block(p, x, cfg: ArchConfig, ctx=None):
    """The (gated) MLP; over a mesh (sharded ``ctx``) its ffn dim is split
    over ``model`` when it divides: w_gate / w_up column-parallel, w_down
    row-parallel, then a ``psum``."""
    if ctx is not None and ctx.sharded:
        f = p["w_up"].global_shape[1]
        m = ctx.model_axis if f % ctx.model_size() == 0 else None
        pl = {k: relayout(v, P(m, None) if k == "w_down" else P(None, m))
              for k, v in p.items()}
        y = mlp_block(pl, x, cfg)
        return psum(y, ctx.model_axis) if m else y
    act = _act(cfg.act)
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# embeddings / logits
# --------------------------------------------------------------------------
def pad_vocab(vocab: int, multiple: int) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def embed_spec(vocab_padded: int, d: int) -> PSpec:
    return PSpec((vocab_padded, d), ("vocab", "embed"), ("normal", 1))


def out_spec(d: int, vocab_padded: int) -> PSpec:
    return PSpec((d, vocab_padded), ("embed", "vocab"), ("normal", 0))


def logits_fn(x, out_w, real_vocab: int):
    """x: (B,S,D) -> float32 logits with the padded-vocab tail masked."""
    logits = torch.einsum("bsd,dv->bsv", x, out_w).to(F32)
    V = logits.shape[-1]
    if V != real_vocab:
        mask = torch.arange(V, device=x.device) < real_vocab
        logits = torch.where(mask, logits, NEG_INF)
    return logits
