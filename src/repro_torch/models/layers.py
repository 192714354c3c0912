"""Model layers of the dense path: norms, RoPE, attention, MLP, logits.

Attention dispatches on the device of its inputs.  On a CUDA tensor it
runs the hand-written kernels (``kernels/flash_attention`` for prefill and
paged extend, ``kernels/decode_attention`` for paged and dense decode); on
a CPU tensor it runs the plain ``chunked_attention``,
``decode_attention_ref`` and ``extend_attention_ref`` below, the same math
the JAX package runs on its CPU path.  Sharding constraints of the JAX
layers are left out.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    paged_extend_attention,
)
from repro_torch.kernels.flash_attention.ref import gather_pages_ref
from repro_torch.models.param import PSpec

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
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """Flash-algorithm attention (running max/sum over KV chunks).

    q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh); GQA via head grouping.
    Returns (B, Sq, Hq, Dh)."""
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


def _paged_write_decode(cache: PagedKVCache, k, v, pos):
    """Write one token per row into its physical page, in place.

    k/v: (B, Hkv, Dh) values for position ``pos`` (B,).  Unmapped target
    pages drop the write.  Int8 arenas lazily initialise the per-page
    scale on first touch (scale 0 = untouched page)."""
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


def _paged_write_extend(cache: PagedKVCache, k, v, positions):
    """Write S suffix tokens per row into their physical pages, in place.

    k/v: (B, S, Hkv, Dh); positions: (B, S) absolute.  Positions whose
    logical page is beyond the block-table width or unmapped drop the
    write.  Int8 scales take a scatter-max per target (page, layer)."""
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
            amax = x.to(F32).abs().amax(dim=(2, 3))                # (B, S)
            # a dropped entry maxes 0 into a clamped target: scales are
            # >= 0, so that is no change
            sc.view(-1).scatter_reduce_(
                0, flat, torch.where(keep, amax / 127.0, 0.0).reshape(-1),
                reduce="amax", include_self=True)
        k = _quantize_to(cache.k.dtype, k, cache.k_scale[physc, layer])
        v = _quantize_to(cache.v.dtype, v, cache.v_scale[physc, layer])
    _write_slots(cache, phys, off, k, v, positions)
    return cache


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


def attention_block(p, x, cfg: ArchConfig, *, mode: str, cache=None,
                    pos=None) -> Tuple[torch.Tensor, object]:
    """Full attention sublayer.  Returns (out (B,S,D), updated cache).

    ``prefill`` (cache: a dense KVSlice fixing the cache length) returns a
    fresh KVSlice; ``extend`` takes a :class:`PagedKVCache` and ``decode``
    a PagedKVCache or a dense KVSlice, and both update the cache in
    place."""
    B, S, _ = x.shape
    window = cfg.sliding_window
    on_card = x.is_cuda
    if mode == "prefill":
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = qkv_project(p, x, cfg, positions)
        if on_card:
            out = flash_attention(q, k, v, causal=True, window=window)
        else:
            out = chunked_attention(q, k, v, causal=True, window=window,
                                    q_chunk=cfg.attn_q_chunk,
                                    kv_chunk=cfg.attn_kv_chunk)
        S_c = cache.k.shape[1]
        if S_c >= S:
            pad = torch.zeros((B, S_c - S) + k.shape[2:], dtype=k.dtype,
                              device=k.device)
            idx = torch.arange(S_c, dtype=torch.int32, device=x.device)
            sp = torch.where(idx < S, idx, -1)[None].expand(B, S_c)
            new_cache = KVSlice(k=torch.cat([k, pad], dim=1),
                                v=torch.cat([v, pad], dim=1),
                                slot_pos=sp.contiguous())
        else:
            # rolling (SWA) cache: keep the last S_c positions
            sp = torch.arange(S - S_c, S, dtype=torch.int32, device=x.device)
            new_cache = KVSlice(k=k[:, -S_c:], v=v[:, -S_c:],
                                slot_pos=sp[None].expand(B, S_c).contiguous())
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
    elif mode in ("extend", "decode"):
        if not isinstance(cache, PagedKVCache):
            raise NotImplementedError(
                "extend over a dense per-slot cache comes with the snapshot "
                "restore of ssm/hybrid (ROADMAP queue 1 item 8)")
        if mode == "extend":
            positions = pos[:, None] + torch.arange(
                S, dtype=torch.int32, device=x.device)[None, :]
            q, k, v = qkv_project(p, x, cfg, positions)
            _paged_write_extend(cache, k, v, positions)
            if on_card:
                out = paged_extend_attention(
                    q, cache.k, cache.v, cache.slot_pos, cache.block_table,
                    pos, cache.layer, k_scale=cache.k_scale,
                    v_scale=cache.v_scale)
            else:
                k_d, v_d, sp_d = paged_gather(cache)
                out = extend_attention_ref(q, k_d, v_d, sp_d, positions,
                                           window=window)
        else:
            positions = pos[:, None]                              # (B,1)
            q, k, v = qkv_project(p, x, cfg, positions)           # S == 1
            _paged_write_decode(cache, k[:, 0], v[:, 0], pos)
            if on_card:
                out = paged_decode_attention(
                    q, cache.k, cache.v, cache.slot_pos, cache.block_table,
                    pos + 1, cache.layer, k_scale=cache.k_scale,
                    v_scale=cache.v_scale)
            else:
                k_d, v_d, sp_d = paged_gather(cache)
                out = decode_attention_ref(q, k_d, v_d, pos + 1,
                                           window=window, slot_pos=sp_d)
        new_cache = cache
    else:
        raise ValueError(mode)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache


def kv_slice_specs(cfg: ArchConfig, batch: int, max_len: int) -> KVSlice:
    """PSpec tree for one layer's dense KV cache."""
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


def mlp_block(p, x, cfg: ArchConfig):
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
