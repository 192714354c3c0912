"""The port's dense-path layers against the JAX layers (CPU, float32).

Seeded numpy inputs and JAX-initialised weights (through the weight
bridge) go through ``repro.models.layers`` and
``repro_torch.models.layers``; the paged writes are compared on the whole
arena after the write, including a target that must drop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402

F32 = torch.float32


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    """The same smoke config in both packages (float32)."""
    jc = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32", **kw)
    tc = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32", **kw)
    return jc, tc


def _weights(specs_fn, jc, tc, seed=0, **kw):
    """JAX-initialised weights for one sublayer, bridged to the port;
    biases (constant 0 at init) are overwritten with random values so
    they are exercised."""
    jp = jax_init_params(specs_fn(jc, **kw), jax.random.PRNGKey(seed),
                         "float32")
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
              if k.startswith("b") else v) for k, v in jp.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), dtype=F32,
                           device="cpu")
    return jp, tp


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    w = rng.standard_normal((32,)).astype(np.float32)
    assert _rel(_np(tl.rms_norm(_t(x), _t(w), 1e-5)),
                jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)) < 1e-6


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    out = tl.apply_rope(_t(x), _t(pos), 1e6)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    assert _rel(_np(out), ref) < 1e-5


@pytest.mark.parametrize("qk_norm,qkv_bias", [(True, False), (False, True),
                                              (True, True)])
def test_qkv_project(qk_norm, qkv_bias):
    jc, tc = _cfgs(qk_norm=qk_norm, qkv_bias=qkv_bias)
    jp, tp = _weights(jl.attn_specs, jc, tc)
    x = np.random.default_rng(2).standard_normal((2, 6, jc.d_model)).astype(
        np.float32)
    pos = np.arange(6, dtype=np.int32)[None] + np.array([[0], [9]], np.int32)
    outs = tl.qkv_project(tp, _t(x), tc, _t(pos))
    refs = jax.jit(jl.qkv_project, static_argnums=2)(
        jp, jnp.asarray(x), jc, jnp.asarray(pos))
    for o, r in zip(outs, refs):
        assert _rel(_np(o), r) < 1e-5


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("sq_relu", False), ("gelu", True)])
def test_mlp_block(act, gated):
    jc, tc = _cfgs(act=act, gated_mlp=gated)
    jp, tp = _weights(jl.mlp_specs, jc, tc)
    x = np.random.default_rng(3).standard_normal((2, 4, jc.d_model)).astype(
        np.float32)
    ref = jax.jit(jl.mlp_block, static_argnums=2)(jp, jnp.asarray(x), jc)
    assert _rel(_np(tl.mlp_block(tp, _t(x), tc)), ref) < 1e-5


def test_logits_fn_masks_padded_vocab():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    out = _np(tl.logits_fn(_t(x), _t(w), 33))
    ref = np.asarray(jl.logits_fn(jnp.asarray(x), jnp.asarray(w), 33))
    assert _rel(out[..., :33], ref[..., :33]) < 1e-6
    assert (out[..., 33:] == ref[..., 33:]).all()
    assert (out[..., 33:] <= -1e29).all()


# --------------------------------------------------------------------------
# paged writes: the whole arena after the write, float and int8
# --------------------------------------------------------------------------
N, P, L, HKV, DH = 7, 4, 3, 2, 8


def _paged_pair(quant, layer, bt):
    """The same arena as a JAX and a port PagedKVCache."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((N, P, L, HKV, DH)).astype(np.float32)
    v = rng.standard_normal((N, P, L, HKV, DH)).astype(np.float32)
    sp = rng.integers(-1, 20, (N, P, L)).astype(np.int32)
    sc = (None, None)
    if quant:
        k = np.clip(np.round(k * 40), -127, 127).astype(np.int8)
        v = np.clip(np.round(v * 40), -127, 127).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, (N, L)).astype(np.float32)
        ks[:2] = 0.0                      # untouched pages: lazy init
        sc = (ks, ks[::-1].copy())
    arrays = (k, v, sp, bt)
    jc = jl.PagedKVCache(*(jnp.asarray(a) for a in arrays),
                         layer=jnp.int32(layer),
                         k_scale=None if sc[0] is None else jnp.asarray(sc[0]),
                         v_scale=None if sc[1] is None else jnp.asarray(sc[1]))
    tc = tl.PagedKVCache(*(_t(a) for a in arrays), layer=layer,
                         k_scale=None if sc[0] is None else _t(sc[0]),
                         v_scale=None if sc[1] is None else _t(sc[1]))
    return jc, tc


def _same_arena(jc, tc, tol):
    assert np.array_equal(np.asarray(jc.slot_pos), tc.slot_pos.numpy())
    if jc.k_scale is None:
        assert _rel(_np(tc.k), jc.k) <= tol and _rel(_np(tc.v), jc.v) <= tol
        return
    # int8: identical codes except where float rounding sits on a .5 edge
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        assert np.abs(a.numpy().astype(int) - np.asarray(b).astype(int)
                      ).max() <= 1
    assert _rel(_np(tc.k_scale), jc.k_scale) < 1e-6
    assert _rel(_np(tc.v_scale), jc.v_scale) < 1e-6


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_write_decode(quant):
    # row 0 writes page 3; row 1's target page is a sentinel (drops);
    # row 2's position lies past the block-table width (drops)
    bt = np.array([[1, 3], [0, N], [4, 5]], np.int32)
    pos = np.array([5, 6, 9], np.int32)
    jc, tc = _paged_pair(quant, 1, bt)
    rng = np.random.default_rng(6)
    k = rng.standard_normal((3, HKV, DH)).astype(np.float32)
    v = rng.standard_normal((3, HKV, DH)).astype(np.float32)
    jn = jl._paged_write_decode(jc, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos))
    tn = tl._paged_write_decode(tc, _t(k), _t(v), _t(pos))
    _same_arena(jn, tn, 0.0)
    assert tn.slot_pos[3, 1, 1] == 5         # row 0 landed in page 3


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_write_extend(quant):
    # row 0 spans pages 2 -> 6; row 1 runs into a sentinel page and past
    # the table width (those positions drop)
    bt = np.array([[2, 6, 0], [1, N, N]], np.int32)
    positions = np.array([[2, 3, 4, 5, 6], [3, 4, 5, 12, 13]], np.int32)
    jc, tc = _paged_pair(quant, 2, bt)
    rng = np.random.default_rng(7)
    k = rng.standard_normal((2, 5, HKV, DH)).astype(np.float32)
    v = rng.standard_normal((2, 5, HKV, DH)).astype(np.float32)
    jn = jl._paged_write_extend(jc, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(positions))
    tn = tl._paged_write_extend(tc, _t(k), _t(v), _t(positions))
    _same_arena(jn, tn, 0.0)


# --------------------------------------------------------------------------
# attention_block in prefill, extend and decode modes
# --------------------------------------------------------------------------
def _jax_attention(cfg, mode):
    """JAX's attention_block, jitted (one compile instead of one per op)."""
    return jax.jit(lambda p, x, cache, pos: jl.attention_block(
        p, x, cfg, None, mode=mode, cache=cache, pos=pos))


def test_attention_block_prefill():
    jc, tc = _cfgs()
    jp, tp = _weights(jl.attn_specs, jc, tc)
    x = np.random.default_rng(8).standard_normal((2, 16, jc.d_model)).astype(
        np.float32)
    S_c = 24
    jcache = jl.KVSlice(k=jnp.zeros((2, S_c, jc.num_kv_heads, 32)),
                        v=jnp.zeros((2, S_c, jc.num_kv_heads, 32)),
                        slot_pos=jnp.zeros((2, S_c), jnp.int32))
    tcache = tl.KVSlice(*(torch.zeros(tuple(a.shape), dtype=torch.int32
                                      if a.dtype == jnp.int32 else F32)
                          for a in jcache))
    jy, jn = _jax_attention(jc, "prefill")(jp, jnp.asarray(x), jcache, None)
    ty, tn = tl.attention_block(tp, _t(x), tc, mode="prefill", cache=tcache)
    assert _rel(_np(ty), jy) < 1e-5
    assert _rel(_np(tn.k), jn.k) < 1e-5 and _rel(_np(tn.v), jn.v) < 1e-5
    assert np.array_equal(tn.slot_pos.numpy(), np.asarray(jn.slot_pos))


def _attn_paged(mode, S, pos):
    jc, tc = _cfgs()
    jp, tp = _weights(jl.attn_specs, jc, tc, seed=9)
    hkv, dh, p = jc.num_kv_heads, jc.resolved_head_dim, 8
    n, n_log, layers = 9, 4, 2
    rng = np.random.default_rng(10)
    k = rng.standard_normal((n, p, layers, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((n, p, layers, hkv, dh)).astype(np.float32)
    sp = np.full((n, p, layers), -1, np.int32)
    bt = np.full((2, n_log), n, np.int32)
    nxt = 0
    for b, pb in enumerate(pos):              # rows hold [0, pos + S)
        for j in range(-(-(pb + S) // p)):
            fill = min(p, pb - j * p)
            if fill > 0:
                sp[nxt, :fill] = (j * p + np.arange(fill))[:, None]
            bt[b, j] = nxt
            nxt += 1
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    arrays = (k, v, sp, bt)
    jcache = jl.PagedKVCache(*(jnp.asarray(a) for a in arrays),
                             layer=jnp.int32(1))
    tcache = tl.PagedKVCache(*(_t(a) for a in arrays), layer=1)
    jy, jn = _jax_attention(jc, mode)(jp, jnp.asarray(x), jcache,
                                      jnp.asarray(pos, jnp.int32))
    ty, tn = tl.attention_block(tp, _t(x), tc, mode=mode, cache=tcache,
                                pos=torch.tensor(pos, dtype=torch.int32))
    assert _rel(_np(ty), jy) < 1e-5
    _same_arena(jn, tn, 1e-6)


def test_attention_block_extend():
    _attn_paged("extend", 6, [8, 3])


def test_attention_block_decode():
    _attn_paged("decode", 1, [13, 7])


@pytest.mark.parametrize("window,S_c,pos", [
    (None, 24, [13, 7]),              # plain: slot = pos
    (None, 12, [13, 7]),              # a position past the cache clamps
    (16, 16, [37, 5]),                # rolling buffer: slot = pos % S_c
])
def test_attention_block_decode_dense(window, S_c, pos):
    """Decode over a dense per-slot KVSlice: the write (slot ``pos % S_c``
    for a rolling buffer, else ``min(pos, S_c - 1)``) and the attention
    with the slot_pos and window masks, against JAX."""
    jc, tc = _cfgs(sliding_window=window)
    jp, tp = _weights(jl.attn_specs, jc, tc, seed=11)
    hkv, dh = jc.num_kv_heads, jc.resolved_head_dim
    rng = np.random.default_rng(12)
    k = rng.standard_normal((2, S_c, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, S_c, hkv, dh)).astype(np.float32)
    sp = np.full((2, S_c), -1, np.int32)
    for b, p in enumerate(pos):           # rows hold positions [0, pos)
        if window:                        # a rolling buffer keeps the last S_c
            held = np.arange(max(p - S_c, 0), p)
            sp[b, held % S_c] = held
        else:                             # positions past the cache clamp
            held = np.arange(p)
            sp[b, np.minimum(held, S_c - 1)] = held
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    jcache = jl.KVSlice(*(jnp.asarray(a) for a in (k, v, sp)))
    tcache = tl.KVSlice(*(_t(a) for a in (k, v, sp)))
    jy, jn = _jax_attention(jc, "decode")(jp, jnp.asarray(x), jcache,
                                          jnp.asarray(pos, jnp.int32))
    ty, tn = tl.attention_block(tp, _t(x), tc, mode="decode", cache=tcache,
                                pos=torch.tensor(pos, dtype=torch.int32))
    assert tn is tcache                   # written in place
    assert _rel(_np(ty), jy) < 1e-5
    assert _rel(_np(tn.k), jn.k) < 1e-6 and _rel(_np(tn.v), jn.v) < 1e-6
    assert np.array_equal(tn.slot_pos.numpy(), np.asarray(jn.slot_pos))


def test_attention_block_extend_over_a_dense_cache_names_its_item():
    _, tc = _cfgs()
    _, tp = _weights(jl.attn_specs, *_cfgs())
    cache = tl.KVSlice(torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32),
                       torch.full((1, 8), -1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tl.attention_block(tp, torch.zeros(1, 2, tc.d_model), tc,
                           mode="extend", cache=cache,
                           pos=torch.zeros(1, dtype=torch.int32))
