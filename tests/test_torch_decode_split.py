"""The split plan and merge of the decode kernel, on the CPU.

The CUDA kernel splits each row's keys across a cluster of
``ops.decode_splits`` blocks, block s taking ``ops.split_range`` of them,
and merges the blocks' softmax partials with ``ops.lse_combine``'s
weights.  On a paged arena the keys are the row's logical pages; on a
dense cache they are the slots of ``ops.dense_live_range`` (the live
slots, or all S of a rolling buffer).  Here the plan is checked to cover
every page, or every slot that can count, exactly once, and the plain
version run per split range and merged with ``ops.lse_combine`` is held
against JAX's ``decode_attention_ref`` (float32, rel < 2e-5: only the
summation order differs).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_ref  # noqa: E402
from repro.models.layers import (  # noqa: E402
    decode_attention_ref as jax_layers_decode_ref,
)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as dense_ref,
    paged_decode_attention_ref,
)
from repro_torch.kernels.flash_attention.ref import gather_pages_ref  # noqa: E402

jax_decode_ref = jax.jit(decode_attention_ref)


@pytest.mark.parametrize("n_sm", [132, 114], ids=["h100-sxm", "h100-pcie"])
def test_split_plan_covers_every_page_once(n_sm):
    """For n_log 1-512 and 1-1024 blocks: 1 <= n_split <= min(8, n_log),
    two blocks an SM unless a cap binds, and the ranges of the splits
    tile [0, n_log) in order, each page once."""
    for n_log in range(1, 513):
        seen = set()
        for blocks in range(1, 1025):
            n = dops.decode_splits(n_log, blocks, n_sm)
            assert 1 <= n <= min(dops.MAX_SPLIT, n_log)
            if n < min(dops.MAX_SPLIT, n_log):
                assert blocks * n >= 2 * n_sm
                assert n & (n - 1) == 0
            seen.add(n)
        for n in seen:
            ranges = [dops.split_range(n_log, n, s) for s in range(n)]
            assert ranges[0][0] == 0 and ranges[-1][1] == n_log
            for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                assert lo <= hi == lo2
            assert max(hi - lo for lo, hi in ranges) == -(-n_log // n)


def test_split_plan_at_the_serving_shapes():
    """qwen3-4b's decode at batch 8 (8 kv heads, n_log 16): 8 splits of 2
    pages; a wide call (256 blocks) takes 2; a call wider than two blocks
    an SM takes 1."""
    assert dops.decode_splits(16, 64) == 8
    assert [dops.split_range(16, 8, s) for s in range(8)] == [
        (2 * s, 2 * s + 2) for s in range(8)]
    assert dops.decode_splits(16, 256) == 2
    assert dops.decode_splits(16, 264) == 1
    assert dops.decode_splits(3, 8) == 3


def _arena(rng, B, Hkv, Dh, P, n_log, kv_lens):
    """Arena (N, P, 1, Hkv, Dh) in which logical page j of row b holds
    positions [j*P, min((j+1)*P, kv_len)); unmapped entries are N."""
    N = B * n_log + 2
    k = rng.standard_normal((N, P, 1, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((N, P, 1, Hkv, Dh)).astype(np.float32)
    sp = np.full((N, P, 1), -1, np.int32)
    bt = np.full((B, n_log), N, np.int32)
    nxt = 0
    for b, kl in enumerate(kv_lens):
        for j in range(-(-kl // P)):
            fill = min(P, kl - j * P)
            sp[nxt, :fill, 0] = j * P + np.arange(fill)
            bt[b, j] = nxt
            nxt += 1
    return k, v, sp, bt


def _split_partial(q, k, v, sp, bt, kl, lo, hi):
    """(m, l, acc) of logical pages [lo, hi): the plain version over that
    range gives acc / l; m and l come from the range's valid scores (an
    empty range: m = -1e30, l = 0, acc = 0)."""
    B, Hq, Dh = q.shape
    out = paged_decode_attention_ref(q, k, v, sp, bt[:, lo:hi], kl, 0)
    kd, _, spd = gather_pages_ref(k, v, sp, bt[:, lo:hi], 0)
    Hkv = kd.shape[2]
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, Hq // Hkv, Dh),
                     kd) / math.sqrt(Dh)
    valid = ((spd >= 0) & (spd < kl[:, None]))[:, None, None]
    s = torch.where(valid, s, -torch.inf)
    m = s.amax(-1).clamp(min=-1e30)
    ls = torch.where(valid, torch.exp(s - m[..., None]), 0.0).sum(-1)
    acc = out.reshape(B, Hkv, Hq // Hkv, Dh) * ls[..., None]
    return m.reshape(B, Hq), ls.reshape(B, Hq), acc.reshape(B, Hq, Dh)


# B, Hq, Hkv, Dh, P, n_log, kv_lens, blocks (the call's B * Hkv)
MERGE = [
    (2, 8, 2, 64, 16, 16, (200, 20), None),        # row 1: 7 empty splits
    (3, 4, 4, 32, 8, 6, (48, 1, 17), None),        # n_log 6: 6 splits
    (2, 4, 1, 16, 16, 256, (4096, 700), None),     # 8 splits of 32 pages
    (4, 32, 8, 128, 16, 8, (128, 77, 1, 100), 264),  # 1 split
]


@pytest.mark.parametrize("case", MERGE)
def test_split_merge_matches_jax(case):
    B, Hq, Hkv, Dh, P, n_log, kv_lens, blocks = case
    rng = np.random.default_rng(12)
    k, v, sp, bt = _arena(rng, B, Hkv, Dh, P, n_log, kv_lens)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kl = np.asarray(kv_lens, np.int32)
    n_split = dops.decode_splits(n_log, blocks or B * Hkv)
    tk, tv, tsp, tbt, tq, tkl = (torch.from_numpy(x)
                                 for x in (k, v, sp, bt, q, kl))
    parts = [_split_partial(tq, tk, tv, tsp, tbt, tkl,
                            *dops.split_range(n_log, n_split, s))
             for s in range(n_split)]
    ms, ls, accs = (torch.stack(x) for x in zip(*parts))
    if n_split > 1:
        assert (ls == 0).any()                   # a split with no live page
    out = dops.lse_combine(ms, ls, accs)
    # JAX over the gathered cache: logical slot i holds position i
    kd = k[np.minimum(bt, k.shape[0] - 1), :, 0].reshape(B, n_log * P, Hkv,
                                                          Dh)
    vd = v[np.minimum(bt, v.shape[0] - 1), :, 0].reshape(B, n_log * P, Hkv,
                                                          Dh)
    ref = jax_decode_ref(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
                         jnp.asarray(kl))
    ref = np.asarray(ref)
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err < 2e-5, err


def _dense_valid(S, kv_len, window, slot_pos_row):
    """Slots of one row that count in JAX's ``decode_attention_ref``: the
    position p (the plane's, or the slot) has p >= 0, p < kv_len and,
    with a window, p > kv_len - 1 - window."""
    pos = np.arange(S) if slot_pos_row is None else slot_pos_row
    ok = (pos >= 0) & (pos < kv_len)
    if window is not None:
        ok &= pos > kv_len - 1 - window
    return set(np.flatnonzero(ok).tolist())


@pytest.mark.parametrize("S", [1, 5, 48, 100, 512])
def test_dense_split_plan_covers_the_live_slots_once(S):
    """For kv_len 0..S+2, windows and S off every tile: the splits of
    ``dense_live_range`` cover [max(lo + 1, 0), min(S, kv_len)) in order,
    each slot once, and hold every slot that counts; with a slot_pos plane
    they cover all S slots."""
    for window in (None, 1, 7, 40, 1000):
        for kv_len in range(0, S + 3):
            begin, end = dops.dense_live_range(S, kv_len, window)
            lo = -1 if window is None else max(kv_len - 1 - window, -1)
            assert (begin, end) == (max(lo + 1, 0),
                                    max(max(lo + 1, 0), min(S, kv_len)))
            for n_split in (1, 2, 3, 8):
                ranges = [dops.split_range(end - begin, n_split, s, begin)
                          for s in range(n_split)]
                assert ranges[0][0] == begin and ranges[-1][1] == end
                for (a, b), (a2, _) in zip(ranges, ranges[1:]):
                    assert a <= b == a2
                covered = {i for a, b in ranges for i in range(a, b)}
                assert _dense_valid(S, kv_len, window, None) <= covered
    for n_split in (1, 3, 8):
        begin, end = dops.dense_live_range(S, 7, 4, rolling=True)
        ranges = [dops.split_range(end - begin, n_split, s, begin)
                  for s in range(n_split)]
        assert [i for a, b in ranges for i in range(a, b)] == list(range(S))


def test_dense_split_plan_at_the_serving_shapes():
    """qwen3-4b's dense decode at batch 8 (8 kv heads of 4 q heads, S
    512): 8 splits of the live slots, 11-17 of them each at kv_len 87-129;
    zamba2-2.7b's (32 kv heads of 1): 2 splits."""
    assert dops.decode_splits(512, 8 * 8) == 8
    for kv_len in (87, 129):
        sizes = [b - a for a, b in (dops.split_range(kv_len, 8, s)
                                    for s in range(8))]
        assert min(sizes) >= 10 and max(sizes) <= 17
    assert dops.decode_splits(512, 8 * 32) == 2


def _dense_split_partial(q, k, v, kl, window, sp, ranges):
    """(m, l, acc) of the given per-row slot ranges of a dense cache: the
    plain version over each row's range gives acc / l; m and l come from
    the range's valid scores (an empty range: m = -1e30, l = 0, acc = 0)."""
    B, Hq, Dh = q.shape
    Hkv = k.shape[2]
    ms, ls, accs = [], [], []
    for b, (a, e) in enumerate(ranges):
        kb, vb = k[b:b + 1, a:e], v[b:b + 1, a:e]
        pos = (torch.arange(a, e, dtype=torch.int32)[None] if sp is None
               else sp[b:b + 1, a:e])
        out = dense_ref(q[b:b + 1], kb, vb, kl[b:b + 1], slot_pos=pos,
                        window=window)
        s = torch.einsum("bhgd,bkhd->bhgk",
                         q[b:b + 1].reshape(1, Hkv, Hq // Hkv, Dh),
                         kb) / math.sqrt(Dh)
        valid = (pos >= 0) & (pos < kl[b])
        if window is not None:
            valid &= pos > kl[b] - 1 - window
        valid = valid[:, None, None]
        s = torch.where(valid, s, -torch.inf)
        m = s.amax(-1).clamp(min=-1e30) if e > a else torch.full(
            (1, Hkv, Hq // Hkv), -1e30)
        ls_ = torch.where(valid, torch.exp(s - m[..., None]), 0.0).sum(-1)
        acc = (out.reshape(1, Hkv, Hq // Hkv, Dh) * ls_[..., None]
               if e > a else torch.zeros((1, Hkv, Hq // Hkv, Dh)))
        ms.append(m.reshape(Hq))
        ls.append(ls_.reshape(Hq))
        accs.append(acc.reshape(Hq, Dh))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


# B, Hq, Hkv, Dh, S, kv_lens, window, rolling
DENSE_MERGE = [
    (3, 8, 2, 64, 512, (87, 129, 1), None, False),     # the serving shape
    (3, 8, 2, 64, 100, (100, 37, 60), 40, False),      # window, no plane
    (3, 4, 1, 32, 48, (130, 48, 20), 40, True),        # rolling buffer
    (2, 4, 4, 16, 48, (300, 49), None, True),          # rolling, no window
]


@pytest.mark.parametrize("case", DENSE_MERGE)
def test_dense_split_merge_matches_jax(case):
    """Per-split plain versions over a dense cache, the rows' live slots
    (all S of a rolling buffer) split as the kernel splits them, merged by
    ``lse_combine``: JAX's ``decode_attention_ref`` (``repro/models/
    layers.py``, slot_pos and window masks) within 2e-5."""
    B, Hq, Hkv, Dh, S, kv_lens, window, rolling = case
    rng = np.random.default_rng(21)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    kl = np.asarray(kv_lens, np.int32)
    sp = None
    if rolling:      # the last S positions at pos % S, one slot emptied
        sp = np.full((B, S), -1, np.int32)
        for b, n in enumerate(kv_lens):
            p = np.arange(max(n - S, 0), n)
            sp[b, p % S] = p
        sp[0, 5] = -1
    n_split = dops.decode_splits(S, B * Hkv)
    tq, tk, tv, tkl = (torch.from_numpy(x) for x in (q, k, v, kl))
    tsp = None if sp is None else torch.from_numpy(sp)
    live = [dops.dense_live_range(S, n, window, rolling) for n in kv_lens]
    parts = [_dense_split_partial(
        tq, tk, tv, tkl, window, tsp,
        [dops.split_range(e - a, n_split, s, a) for a, e in live])
        for s in range(n_split)]
    ms, ls, accs = (torch.stack(x) for x in zip(*parts))
    out = dops.lse_combine(ms, ls, accs)
    ref = np.asarray(jax_layers_decode_ref(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kl), window=window,
        slot_pos=None if sp is None else jnp.asarray(sp)))[:, 0]
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err < 2e-5, err
