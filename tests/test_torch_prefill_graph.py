"""Cold prefill, paged extend and the snapshot restore as CUDA graphs.

CPU (here): ``Model.prefill_ranged(in_place=True)`` writes the default
path's cache, bit for bit, into the tensors it was given (dense, moe, ssm
and hybrid, the checkpoints into a ``CheckpointWorkspace``) and agrees
with JAX's ``prefill_ranged``; prefill attention writes every slot of
the KVSlice it is given; the in-place ``mask_pad_slots_``; the
checkpoint output of ``ops.ssd``; the keys of the three paths (the
extend width against the batcher's block-table trim) and their count at
8 slots and max_len 512; the workspace's growth plan; and the CPU
batcher over two rounds, which builds no graph, serves the JAX batcher's
tokens on the paged, dense and snapshot planes, and meets in round 2 only
keys it met in round 1.

Card (marked ``cuda``, skipped here), in float32 at smoke size: two
rounds of cold and warm waves through a graphed batcher (every path
warmed first, so each key's first visit captures) against an eager one,
on the six paths of ``test_torch_step_graph.py`` and qwen3-4b paged at
chunk 4 (two prefill keys a wave): identical tokens and
every cache leaf bitwise, every round-2 prefill, extend and restore a
replay; the checkpoint workspace regrowing (its prefill graphs dropped and
captured again); the draws at temperature 0.8; a prefill that cannot be
captured raising; and which first-use work CUDA allows inside a capture.

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_prefill_graph.py

The JAX reference is imported where a CPU test first needs it: the card's
machine has no jax, and runs only the ``cuda`` tests.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from repro_torch.models.cache_utils import mask_pad_slots_  # noqa: E402
from repro_torch.models.layers import KVSlice, attention_block  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    CheckpointWorkspace,
    bucket_len,
    grow_capacity,
)
from repro_torch.serve.step_graph import (  # noqa: E402
    PATH_OF,
    decode_keys,
    extend_key,
    leaf_addresses,
    paged_key,
    prefill_key,
    restore_key,
)

PAGE = 8
_MODELS = {}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _models(arch):
    """(JAX model, JAX params, port model, port params on the CPU) of
    ``arch`` at smoke size in float32, from one JAX init."""
    import jax

    from repro.configs.base import smoke_config
    from repro.configs.registry import get_arch
    from repro.models.model import build_model
    from repro.sharding.rules import single_device_ctx
    if arch not in _MODELS:
        jm = build_model(smoke_config(get_arch(arch)).replace(dtype="float32"),
                         single_device_ctx())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
        tm = Model(t_smoke_config(t_get_arch(arch)).replace(dtype="float32"))
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=torch.float32, device="cpu", specs=tm.param_specs())
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def _jax_leaves(tree):
    """Array leaves in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _jax_leaves(v)]
    return [] if tree is None else [tree]


def _garbage(tree, seed=9):
    """Overwrite every tensor leaf of ``tree`` with noise, in place."""
    g = torch.Generator().manual_seed(seed)
    for t in tree_leaves(tree):
        if t.dtype == torch.int32:
            t.copy_(torch.randint(-5, 50, t.shape, generator=g))
        else:
            t.copy_(torch.randn(t.shape, generator=g))


# --------------------------------------------------------------------------
# in-place prefill
# --------------------------------------------------------------------------
# (arch, checkpoint_every, tolerance against JAX in float32: the existing
# model tests' own)
IN_PLACE = {
    "dense": ("qwen3-4b", None, 1e-4),
    "moe": ("deepseek-moe-16b", None, 1e-4),
    "ssm": ("mamba2-2.7b", PAGE, 1e-5),
    "hybrid": ("zamba2-2.7b", PAGE, 1e-5),
}


@pytest.mark.parametrize("family", sorted(IN_PLACE))
def test_in_place_prefill_equals_default_and_jax(family):
    """Bucket-padded rows (lengths 32, 21, 9 and a dummy 0) through
    ``prefill_ranged``: the in-place call, on a cache and checkpoint
    workspace full of noise (it reads neither), writes the default path's
    values bit for bit into the tensors it was given and returns them;
    both agree with JAX."""
    import jax
    import jax.numpy as jnp
    arch, ck, tol = IN_PLACE[family]
    jm, jp, tm, tp = _models(arch)
    B, S, max_len = 4, 32, 64
    lengths = np.array([32, 21, 9, 0], np.int32)
    tokens = np.random.default_rng(0).integers(
        1, jm.cfg.vocab, (B, S)).astype(np.int32)
    tokens[np.arange(S)[None] >= lengths[:, None]] = 0
    tb = {"tokens": torch.from_numpy(tokens),
          "length": torch.from_numpy(lengths)}
    kw = {} if ck is None else {"checkpoint_every": ck}
    default = tm.prefill_ranged(tp, tb, tm.init_cache(B, max_len,
                                                      device="cpu"), **kw)
    cache = tm.init_cache(B, max_len, device="cpu")
    _garbage(cache)
    if ck is not None:
        ws = CheckpointWorkspace(tm, "cpu")
        ws.reserve(B * S // ck)
        kw["ckpt_out"] = ws.views(B, S // ck)
        _garbage(kw["ckpt_out"])
    given = leaf_addresses((cache, kw.get("ckpt_out")))
    out = tm.prefill_ranged(tp, tb, cache, in_place=True, **kw)
    assert leaf_addresses(out[1:]) == given
    assert torch.equal(out[0], default[0])
    d_leaves, o_leaves = tree_leaves(default[1:]), tree_leaves(out[1:])
    assert len(d_leaves) == len(o_leaves)
    assert all(torch.equal(a, b) for a, b in zip(d_leaves, o_leaves))

    jb = {"tokens": jnp.asarray(tokens), "length": jnp.asarray(lengths)}
    jout = jax.jit(jm.prefill_ranged, static_argnames="checkpoint_every")(
        jp, jb, jm.init_cache(B, max_len), checkpoint_every=ck)
    assert _rel(_np(out[0]), jout[0]) < tol
    t_leaves, j_leaves = tree_leaves(out[1]), _jax_leaves(jout[1])
    assert [tuple(t.shape) for t in t_leaves] == [j.shape for j in j_leaves]
    for t, j in zip(t_leaves, j_leaves):
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), np.asarray(j))
        else:
            assert _rel(_np(t), j) < tol
    if ck is None:
        return
    # checkpoints past a row's length are pad garbage: each row's full
    # chunks are compared
    ax = tm._state_batch_axis
    for t, j in zip(tree_leaves(out[2]), _jax_leaves(jout[2])):
        assert tuple(t.shape) == j.shape
        for b, n in enumerate(lengths[lengths >= ck]):
            full = (slice(None),) * ax + (slice(0, n // ck),)
            assert _rel(_np(t.select(ax, b))[full],
                        np.take(np.asarray(j), b, axis=ax)[full]) < tol


@pytest.mark.parametrize("window", [None, 8], ids=["full", "rolling"])
def test_prefill_writes_every_slot_of_a_kv_slice(window):
    """``attention_block(mode="prefill")`` writes into the dense KVSlice it
    is given, every slot, reading none: the same on a cache of noise as on
    a zero one; zero K/V and ``slot_pos`` -1 past the prompt on a cache
    longer than it, its last positions on a rolling cache shorter."""
    cfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(
        dtype="float32", sliding_window=window)
    tm = Model(cfg)
    lp = tm.init(torch.Generator().manual_seed(0), device="cpu")["layers"]
    p = {k: v[0] for k, v in lp["attn"].items()}
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    S_c = 16 if window is None else window
    spec = (2, S_c, cfg.num_kv_heads, cfg.resolved_head_dim)
    outs = []
    for noise in (False, True):
        cache = KVSlice(torch.zeros(spec), torch.zeros(spec),
                        torch.zeros((2, S_c), dtype=torch.int32))
        if noise:
            _garbage(cache)
        given = leaf_addresses(cache)
        y, out = attention_block(p, x, cfg, mode="prefill", cache=cache)
        assert leaf_addresses(out) == given
        outs.append((y,) + tuple(out))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    _, k, v, sp = outs[1]
    want = torch.arange(S_c, dtype=torch.int32) + max(12 - S_c, 0)
    want = torch.where(want < 12, want, -1)
    assert torch.equal(sp, want[None].expand(2, S_c))
    if window is None:
        assert not k[:, 12:].any() and not v[:, 12:].any()


def test_mask_pad_slots_in_place():
    """``mask_pad_slots_`` sets ``slot_pos`` -1 at and past each row's
    length in the cache's own tensors, every KV node of a nested tree,
    and leaves the rest (and the recurrent state) as it was."""
    tm = Model(t_smoke_config(t_get_arch("zamba2-2.7b")).replace(
        dtype="float32"))
    cache = tm.init_cache(3, 16, device="cpu")
    _garbage(cache)
    length = torch.tensor([16, 5, 0], dtype=torch.int32)
    before = [t.clone() for t in tree_leaves(cache)]
    sp0 = cache["groups"].shared.slot_pos.clone()
    given = leaf_addresses(cache)
    got = mask_pad_slots_(cache, length)
    assert got is cache and leaf_addresses(got) == given
    pad = torch.arange(16)[None] >= length[:, None]
    sp = cache["groups"].shared.slot_pos
    assert torch.equal(sp, torch.where(pad, -1, sp0))
    for a, b in zip(before, tree_leaves(cache)):
        assert b is sp or torch.equal(a, b)


def test_ssd_writes_its_checkpoints_into_ckpt_out():
    """``ops.ssd(ckpt_out=...)`` on the CPU: ``ssd_ref``'s checkpoints
    copied into the given tensor, which comes back as the checkpoints; a
    tensor of the wrong shape or dtype, or without checkpoints, raises."""
    g = torch.Generator().manual_seed(0)
    Bb, S, H, P, N = 2, 32, 4, 8, 16
    x = torch.randn(Bb, S, H, P, generator=g)
    dt = torch.rand(Bb, S, H, generator=g)
    A_log = torch.rand(H, generator=g)
    Bm = torch.randn(Bb, S, 1, N, generator=g)
    want = ssd(x, dt, A_log, Bm, Bm, chunk=8, checkpoints=True)
    out = torch.full((Bb, 4, H, P, N), float("nan"))
    got = ssd(x, dt, A_log, Bm, Bm, chunk=8, checkpoints=True, ckpt_out=out)
    assert got[2] is out
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    for bad, kw in ((torch.empty(Bb, 2, H, P, N), {"checkpoints": True}),
                    (torch.empty(Bb, 4, H, P, N, dtype=torch.float64),
                     {"checkpoints": True}),
                    (out, {})):
        with pytest.raises(ValueError):
            ssd(x, dt, A_log, Bm, Bm, chunk=8, ckpt_out=bad, **kw)


# --------------------------------------------------------------------------
# keys and the workspace plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_logical", [4, 32])
def test_extend_width_is_the_batchers_trim(n_logical):
    """The extend key's width is the block-table trim of the batcher's
    paged extend: the power-of-two page bucket covering the longest
    prompt, capped at ``n_logical``."""
    P = 16
    for longest in range(1, n_logical * P + 1):
        pages = -(-longest // P)
        trim = min(1 << (pages - 1).bit_length(), n_logical)
        key = extend_key(4, 32, pages, n_logical)
        assert key == ("extend", 4, 32, trim)
        assert ("paged", trim) in decode_keys(n_logical)
        assert paged_key(pages, n_logical)[1] == trim


def _key_space(slots, chunk, max_len, page):
    """Every key a batcher of ``slots`` slots can meet, by path, built
    with the key functions over every padded batch size, pad bucket and
    prompt page count (extend: an upper bound, as not every width goes
    with every suffix bucket)."""
    buckets = sorted({bucket_len(n, chunk, max_len)
                      for n in range(1, max_len)})
    pads = sorted({1 << (b - 1).bit_length() for b in range(1, slots + 1)})
    n_log = max_len // page
    return buckets, {
        "decode": set(decode_keys(n_log)) | set(decode_keys(None)),
        "prefill": {prefill_key(b, s) for b in pads for s in buckets},
        "extend": {extend_key(b, s, n, n_log) for b in pads for s in buckets
                   for n in range(1, n_log + 1)},
        "restore": {restore_key(s) for s in buckets}}


def test_key_count_at_8_slots_and_max_len_512():
    """At 8 slots, max_len 512, chunk 32 and page 16: 16 pad buckets, 64
    prefill keys, at most 384 extend keys, 16 restore keys, 6 paged
    decode keys; each key names its path."""
    buckets, space = _key_space(8, 32, 512, 16)
    assert buckets == list(range(32, 513, 32))
    assert {p: len(k) for p, k in space.items()} == {
        "decode": 6 + 1, "prefill": 64, "extend": 384, "restore": 16}
    for path, keys in space.items():
        assert all(PATH_OF[k[0]] == path for k in keys)


def test_workspace_growth_plan():
    """The workspace grows to exactly what a key needs, and only when a
    key needs more than it holds."""
    caps, cap = [], 0
    for need in (24, 64, 24, 32, 80, 8):
        cap = grow_capacity(cap, need)
        caps.append(cap)
    assert caps == [24, 64, 64, 64, 80, 80]


def test_checkpoint_workspace_views():
    """``CheckpointWorkspace`` (CPU): views of b rows of nb checkpoints are
    contiguous views of the buffers' fronts, shaped as the model's
    checkpoints; a larger reserve reallocates them (a regrowth), a smaller
    one keeps them; a view past the capacity raises."""
    tm = Model(t_smoke_config(t_get_arch("zamba2-2.7b")).replace(
        dtype="float32"))
    ws = CheckpointWorkspace(tm, "cpu")
    assert ws.reserve(6) and ws.capacity == 6 and ws.regrowths == 0
    v = ws.views(2, 3)
    specs = tm.checkpoint_specs(2, 3)
    assert [tuple(t.shape) for t in v] == [s.shape for s in specs]
    assert all(t.is_contiguous() for t in v)
    front = leaf_addresses(v)
    assert leaf_addresses(ws.views(1, 2)) == front
    assert not ws.reserve(4) and leaf_addresses(ws.views(2, 3)) == front
    assert ws.reserve(12) and ws.regrowths == 1 and ws.capacity == 12
    with pytest.raises(ValueError):
        ws.views(4, 4)


# --------------------------------------------------------------------------
# the CPU batcher over two rounds: no graph, the JAX batcher's tokens
# --------------------------------------------------------------------------
PLANES = {
    "paged": ("qwen3-4b", {}),
    "dense": ("qwen3-4b", {"kv_pool": None}),
    "snapshot": ("mamba2-2.7b", {}),
}
TAILS = [5, 11, 7]


def _rounds(vocab, n=2):
    """``n`` rounds of two waves: each round a new 20-token shared prefix
    and new tokens with the same tail lengths (two cold prompts, then one
    that hits the round's prefix)."""
    out = []
    for r in range(n):
        rng = np.random.RandomState(10 + r)
        sysp = rng.randint(1, vocab, size=20)
        p = [np.concatenate([sysp, rng.randint(1, vocab, size=k)])
             .astype(np.int32) for k in TAILS]
        out += [p[:2], p[2:]]
    return out


def _drive(bat, req_cls, waves, max_new=4):
    rid = 0
    for wave in waves:
        for p in wave:
            bat.submit(req_cls(rid=rid, prompt=p, max_new_tokens=max_new))
            rid += 1
        bat.run_until_drained()
    return {r.rid: r.output for r in bat.done}


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_cpu_batcher_two_rounds_match_jax(plane):
    """Two rounds through the port's CPU batcher: no graph is built, the
    tokens are the JAX batcher's, every key is one the enumerations list,
    and round 2 meets only keys of round 1 (what lets every round-2
    prefill replay on the card)."""
    from repro.serve.batcher import ContinuousBatcher as JBatcher
    from repro.serve.batcher import Request as JRequest
    arch, kw = PLANES[plane]
    jm, jp, tm, tp = _models(arch)
    kw = {"batch_slots": 2, "max_len": 64, "page_size": PAGE,
          "prefill_chunk": 8, **kw}
    waves = _rounds(jm.cfg.vocab)
    jout = _drive(JBatcher(jm, jp, **kw), JRequest, waves)
    tbat = ContinuousBatcher(tm, tp, device="cpu", **kw)
    assert tbat.step_graph is None
    seen = []
    run = tbat._run

    def spy(key, fn, state, host):
        seen.append(key)
        return run(key, fn, state, host)

    tbat._run = spy
    tout = _drive_more(tbat, waves[:2], 0)
    first = set(seen)
    tout.update(_drive_more(tbat, waves[2:], len(tout)))
    tbat.close()
    assert tout == jout
    assert set(seen) == first
    _, space = _key_space(2, tbat.prefill_chunk, 64, PAGE)
    assert set(seen) <= set().union(*space.values())
    paths = {PATH_OF[k[0]] for k in seen}
    assert paths == {"decode", "prefill",
                     *({"paged": ["extend"], "snapshot": ["restore"]}
                       .get(plane, []))}


def _drive_more(bat, waves, rid0, max_new=4):
    """Serve ``waves`` through ``bat`` (draining between waves), request
    ids from ``rid0``; returns the new requests' tokens by id."""
    done0, rid = len(bat.done), rid0
    for wave in waves:
        for p in wave:
            bat.submit(Request(rid=rid, prompt=p, max_new_tokens=max_new))
            rid += 1
        bat.run_until_drained()
    return {r.rid: r.output for r in bat.done[done0:]}


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


CARD = {
    "qwen3-paged": ("qwen3-4b", {}),
    "qwen3-paged-chunk4": ("qwen3-4b", {"prefill_chunk": 4}),
    "qwen3-dense": ("qwen3-4b", {"kv_pool": None}),
    "qwen3-int8": ("qwen3-4b", {"kv_dtype": "int8"}),
    "deepseek-paged": ("deepseek-moe-16b", {}),
    "mamba2-snapshot": ("mamba2-2.7b", {}),
    "zamba2-snapshot": ("zamba2-2.7b", {}),
}
_CARD_MODELS = {}


def _card_model(dev, arch):
    if arch not in _CARD_MODELS:
        tm = Model(t_smoke_config(t_get_arch(arch)).replace(dtype="float32"))
        tp = tm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        _CARD_MODELS[arch] = (tm, tp)
    return _CARD_MODELS[arch]


def _card_batcher(dev, arch, kw, temperature=0.0, graphs=True):
    tm, tp = _card_model(dev, arch)
    kw = {"batch_slots": 2, "max_len": 64, "page_size": PAGE,
          "prefill_chunk": 8, "temperature": temperature, **kw}
    bat = ContinuousBatcher(tm, tp, device=dev, **kw)
    if not graphs:
        bat.step_graph = None
    return bat


def _state_leaves(bat):
    """Every tensor the batcher serves from: the pool's arena and scales
    or the dense cache, and the resident tree."""
    return tree_leaves(bat._decode_state()[1:])


def _warm(dev, arch, kw):
    """Run every path once in this process (its eager call), so that the
    next batcher's first visits all capture."""
    bat = _card_batcher(dev, arch, kw)
    _drive(bat, Request, _rounds(bat.model.cfg.vocab, 1))
    bat.close()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD))
def test_replayed_prefills_equal_eager_ones(dev, case):
    """Two rounds through a graphed batcher and an eager one: the same
    tokens and every state tensor bitwise after each round; round 1's
    first visits captured (no eager call: the paths were warmed), round
    2's prefill, extend and restore calls all replays of round 1's
    graphs."""
    arch, kw = CARD[case]
    _warm(dev, arch, kw)
    graphed = _card_batcher(dev, arch, kw)
    eager = _card_batcher(dev, arch, kw, graphs=False)
    waves = _rounds(graphed.model.cfg.vocab)
    stats = []
    for r in range(2):
        outs = [_drive_more(bat, waves[2 * r:2 * r + 2], 100 * r, max_new=6)
                for bat in (graphed, eager)]
        torch.cuda.synchronize()
        assert outs[0] == outs[1]
        bitwise = [torch.equal(a, b) for a, b in
                   zip(_state_leaves(graphed), _state_leaves(eager))]
        stats.append(graphed.step_graph.stats())
        print(f"[prefill graph] {case} round {r + 1}: {stats[-1]}; state "
              f"leaves bitwise equal: {sum(bitwise)} of {len(bitwise)}")
        assert all(bitwise)
    one, two = stats
    for path, g in two.items():
        assert g["eager_calls"] == 0 and g["dropped"] == 0, (path, g)
        assert g["captures"] == g["keys"], (path, g)
        if path != "decode" and g["keys"]:
            assert g["captures"] == one[path]["captures"], (path, one, two)
            assert g["replays"] > one[path]["replays"], (path, one, two)
    graphed.close()


def _sources(rounds, d, seed=31):
    """A source per prompt of ``_rounds``: in each round the first cold
    prompt and the warm one share a source (so the warm one hits under its
    digest), the second cold prompt has none."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rounds):
        a = rng.randn(int(rng.randint(6, 40)), d).astype(np.float32)
        out += [[a, None], [a]]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"kv_pool": None}], ids=["paged", "dense"])
def test_encdec_replayed_prefills_equal_eager_ones(dev, kw):
    """seamless smoke with sources: two rounds through a graphed batcher
    and an eager one give the same tokens and every state tensor bitwise
    (the resident cross memory and ``src_len`` included), round 2's
    prefill and extend calls all replays; each replayed cold prefill
    launched flash 3 times a decoder layer plus once an encoder layer,
    each extend the encoder's and the cross-attention's flash and one
    paged extend a decoder layer."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    arch = "seamless-m4t-large-v2"
    _warm(dev, arch, kw)
    graphed = _card_batcher(dev, arch, kw)
    eager = _card_batcher(dev, arch, kw, graphs=False)
    cfg = graphed.model.cfg
    waves = _rounds(cfg.vocab)
    srcs = _sources(2, cfg.d_model)
    stats = []
    for r in range(2):
        outs = []
        for bat in (graphed, eager):
            done0, rid = len(bat.done), 100 * r
            if bat is graphed:
                f0 = flash_attention.launches
                e0 = paged_extend_attention.launches
                n0 = graphed.prefill_invocations
            for wave, wsrc in zip(waves[2 * r:2 * r + 2],
                                  srcs[2 * r:2 * r + 2]):
                for prompt, src in zip(wave, wsrc):
                    bat.submit(Request(rid=rid, prompt=prompt,
                                       max_new_tokens=6, src=src))
                    rid += 1
                bat.run_until_drained()
            if bat is graphed:
                calls = graphed.prefill_invocations - n0
                ext = paged_extend_attention.launches - e0
                flash = flash_attention.launches - f0
            outs.append({q.rid: q.output for q in bat.done[done0:]})
        torch.cuda.synchronize()
        assert outs[0] == outs[1]
        bitwise = [torch.equal(a, b) for a, b in
                   zip(_state_leaves(graphed), _state_leaves(eager))]
        stats.append(graphed.step_graph.stats())
        print(f"[prefill graph] seamless {kw} round {r + 1}: {stats[-1]}; "
              f"state leaves bitwise equal: {sum(bitwise)} of "
              f"{len(bitwise)}")
        assert all(bitwise)
        n_ext = ext // cfg.num_layers
        assert flash == (
            (cfg.encoder_layers + 2 * cfg.num_layers) * (calls - n_ext)
            + (cfg.encoder_layers + cfg.num_layers) * n_ext)
        assert n_ext == (1 if kw == {} else 0)
    for path, g in stats[1].items():
        assert g["eager_calls"] == 0 and g["dropped"] == 0, (path, g)
        if path != "decode" and g["keys"]:
            assert g["captures"] == stats[0][path]["captures"], stats
    assert graphed.resident is None or float(
        graphed.resident["dec_layers"].cross_k.abs().max()) > 0
    graphed.close()


@pytest.mark.cuda
def test_workspace_regrowth_recaptures(dev):
    """mamba2 on the snapshot pool: a one-row cold prefill, then a
    two-row one with more checkpoints regrows the workspace (the prefill
    graphs dropped), then the one-row key again captures anew; the tokens
    are the eager batcher's throughout."""
    _warm(dev, "mamba2-2.7b", {})
    graphed = _card_batcher(dev, "mamba2-2.7b", {})
    eager = _card_batcher(dev, "mamba2-2.7b", {}, graphs=False)
    rng = np.random.RandomState(5)
    V = graphed.model.cfg.vocab
    waves = [[rng.randint(1, V, size=12).astype(np.int32)],
             [rng.randint(1, V, size=n).astype(np.int32) for n in (30, 26)],
             [rng.randint(1, V, size=13).astype(np.int32)]]
    outs = [_drive_more(bat, waves, 0) for bat in (graphed, eager)]
    assert outs[0] == outs[1]
    g = graphed.step_graph.stats()["prefill"]
    print(f"[prefill graph] regrowth: {g}, workspace regrowths "
          f"{graphed._ckpts.regrowths}, capacity {graphed._ckpts.capacity}")
    assert graphed._ckpts.regrowths >= 1 and g["dropped"] >= 1
    assert g["captures"] == g["keys"] + g["dropped"]
    graphed.close()


@pytest.mark.cuda
def test_prefill_draws_at_temperature(dev):
    """At temperature 0.8 the graphed prefills (and decode steps) draw
    what the eager batcher draws, round after round."""
    _warm(dev, "qwen3-4b", {})
    graphed = _card_batcher(dev, "qwen3-4b", {}, temperature=0.8)
    eager = _card_batcher(dev, "qwen3-4b", {}, temperature=0.8, graphs=False)
    waves = _rounds(graphed.model.cfg.vocab)
    outs = [_drive_more(bat, waves, 0, max_new=6) for bat in (graphed,
                                                                eager)]
    g = graphed.step_graph.stats()
    print(f"[prefill graph] temperature 0.8: graphed draws equal eager "
          f"draws: {outs[0] == outs[1]}; {g}")
    assert g["prefill"]["replays"] > g["prefill"]["keys"]
    assert outs[0] == outs[1]
    graphed.close()


def _child(code: str) -> subprocess.CompletedProcess:
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=600)


@pytest.mark.cuda
def test_prefill_capture_failure_raises(dev):
    """A prefill step that reads a device value back to the host cannot
    be captured: the capture raises at the key's first visit, nothing
    runs eagerly in its place, and the launch counters stay as they
    were.  In a child process (a failed capture leaves PyTorch's CUDA
    generators in capture mode)."""
    out = _child("""
        import numpy as np
        import torch
        from repro_torch.kernels import _build
        from repro_torch.serve.step_graph import StepGraph

        graphs = StepGraph("cuda")
        x = torch.ones(4, device="cuda")
        host = {"tokens": np.zeros((2, 8), np.int32),
                "length": np.full(2, 8, np.int32)}

        def ok(state, inputs):
            return inputs["length"], state

        def bad(state, inputs):
            (t,) = state
            t.add_(inputs["length"].float().sum().item())
            return inputs["length"], state

        graphs(("prefill", 2, 16), ok, (x,), host)   # the path's eager call
        counts = _build.launch_counts()
        try:
            graphs(("prefill", 2, 8), bad, (x,), host)
        except RuntimeError as e:
            print("capture raised", type(e).__name__)
        g = graphs.stats()["prefill"]
        assert g["replays"] == 0 and g["captures"] == 0, g
        assert _build.launch_counts() == counts
        assert x.tolist() == [1.0] * 4
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "capture raised" in out.stdout


LEGALITY = {
    "the kernel library bound inside the capture": "cap(ssd_call())",
    "a kernel's first launch after the library is bound":
        "_build.library(); cap(ssd_call())",
    "the cluster decode kernel's first launch (occupancy query, cluster "
    "launch)": "_build.library(); cap(dec_call())",
    "the first cuBLAS matmul of the process":
        "a = torch.randn(64, 64, device=dev); cap(lambda: a @ a)",
    "a cuBLAS matmul at a new shape after one eager matmul":
        "a = torch.randn(64, 64, device=dev); a @ a; "
        "b = torch.randn(1000, 256, device=dev).bfloat16(); "
        "cap(lambda: b @ b.T)",
}
_LEGALITY_PRE = """
import torch
from repro_torch.kernels import _build
dev = torch.device("cuda")

def cap(fn):
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            fn()
        g.replay()
        torch.cuda.synchronize()
        print("RESULT legal")
    except Exception as e:
        print("RESULT illegal:", type(e).__name__,
              str(e).splitlines()[0][:160])

def ssd_call():
    from repro_torch.kernels.ssd_scan.ops import ssd
    x = torch.randn(2, 64, 8, 64, device=dev)
    B = torch.randn(2, 64, 1, 128, device=dev)
    dt = torch.rand(2, 64, 8, device=dev)
    A = torch.rand(8, device=dev)
    return lambda: ssd(x, dt, A, B, B, chunk=16, checkpoints=True)

def dec_call():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    q = torch.randn(8, 1, 32, 128, device=dev).bfloat16()
    k = torch.randn(8, 4096, 8, 128, device=dev).bfloat16()
    kl = torch.full((8,), 4000, dtype=torch.int32, device=dev)
    return lambda: decode_attention(q, k, k, kl)
"""


@pytest.mark.cuda
def test_what_a_capture_allows(dev):
    """Which first-use work CUDA allows inside a graph capture (PyTorch's
    default ``capture_error_mode="global"``), each in a fresh process.
    The step graph's policy rests on two: a kernel's first launch after
    the library is bound, and a cuBLAS product at a new shape once the
    process has made one; the first cuBLAS product of a process is what
    each path's first, eager call is for."""
    found = {}
    for what, code in LEGALITY.items():
        out = _child(_LEGALITY_PRE + code)
        res = [x for x in out.stdout.splitlines() if x.startswith("RESULT")]
        found[what] = res[-1][7:] if res else f"no result: {out.stderr[-300:]}"
        print(f"[capture] {what}: {found[what]}")
    assert found["a kernel's first launch after the library is bound"] == \
        "legal"
    assert found["a cuBLAS matmul at a new shape after one eager matmul"] \
        == "legal"
