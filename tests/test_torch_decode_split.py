"""The split plan and merge of the paged decode kernel, on the CPU.

The CUDA kernel splits each row's logical pages across a cluster of
``ops.decode_splits`` blocks, block s taking ``ops.split_range``, and
merges the blocks' softmax partials with ``ops.lse_combine``'s weights.
Here the plan is checked to cover every logical page exactly once, and
the plain version run per split range and merged with ``ops.lse_combine``
is held against JAX's ``decode_attention_ref`` over the gathered cache
(float32, rel < 2e-5: only the summation order differs).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
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
