"""The port's encoder-decoder family against JAX (CPU, seamless smoke).

seamless-m4t-large-v2 at smoke size (2 encoder and 4 decoder layers,
d_model 128, 4 heads of 32), weights from JAX ``Model.init`` through the
weight bridge, inputs drawn from numpy seeds:

* the flash plain version and ``chunked_attention`` under a key-length
  mask against JAX's ``chunked_attention``: bidirectional with Skv < Sq
  and Skv > Sq, causal, and a row whose ``kv_len`` is 0 (the mean of V on
  both sides; the CUDA kernels store 0 there, which the serving path
  never reads: such rows have zero cross memory);
* ``enc_layer``, ``cross_attend`` and ``dec_layer`` in prefill, extend and
  decode, float32 at atol 1e-5 and bfloat16 at rel 2e-2 (the tolerance of
  ``tests/test_kernels.py``);
* ``Model``: ``prefill_ranged``, ``prefill_extend`` (paged, the cross
  memory from the cache or encoded from the batch's sources) and
  ``decode`` (paged), their logits and the cross memory and ``src_len``
  each writes; ``encode_cross_rows`` + ``install_cross_memory``;
  ``ranged_batch_extras``; the cache specs;
* the source digest of the prefix tree's root keys;
* the weight bridge's parameter count, at smoke size and full width;
* the CPU batcher against the JAX batcher, float32 greedy over two
  rounds, ragged sources and one ``src=None`` request a wave: paged cold
  and warm (prefix hits under the source digest), the dense cache, and
  token at a time.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.cache_utils import install_cross_memory as j_install  # noqa: E402
from repro.models.layers import KVSlice as JKV  # noqa: E402
from repro.models.layers import PagedKVCache as JPaged  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.serve import kvpool as jkvpool  # noqa: E402
from repro.serve.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.batcher import Request as JRequest  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import encdec as tenc  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.cache_utils import (  # noqa: E402
    cache_batch_axes,
    install_cross_memory,
    strip_kv_nodes,
)
from repro_torch.models.layers import KVSlice as TKV  # noqa: E402
from repro_torch.models.layers import PagedKVCache as TPaged  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy, tree_map  # noqa: E402
from repro_torch.serve import kvpool as tkvpool  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, MAX_LEN, PAGE = 3, 32, 8
N_LOG = MAX_LEN // PAGE
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_MODELS = {}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, dtype):
    """float32: max |t - j| < 1e-5; bfloat16: rel < 2e-2."""
    if dtype == "float32":
        assert float(np.max(np.abs(_np(t) - _np(j)))) < TOL["float32"]
    else:
        assert _rel(_np(t), _np(j)) < TOL["bfloat16"]


def _models(dtype):
    if dtype not in _MODELS:
        jm = build_model(smoke_config(get_arch(ARCH)).replace(dtype=dtype),
                         single_device_ctx())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = Model(t_smoke_config(t_get_arch(ARCH)).replace(dtype=dtype))
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=tm.dtype, device="cpu", specs=tm.param_specs())
        _MODELS[dtype] = (jm, jp, tm, tp)
    return _MODELS[dtype]


def _pair(a, dtype):
    """One numpy array as (JAX, port) in ``dtype`` (int32 stays)."""
    if a.dtype == np.int32:
        return jnp.asarray(a), torch.from_numpy(a.copy())
    return (jnp.asarray(a, jnp.dtype(dtype)),
            torch.from_numpy(a.copy()).to(getattr(torch, dtype)))


def _layer(tree_j, tree_t, i=0):
    return (jax.tree.map(lambda a: a[i], tree_j),
            tree_map(lambda a: a[i], tree_t))


# --------------------------------------------------------------------------
# attention under a key-length mask
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sq,skv,causal", [(16, 8, False), (8, 24, False),
                                           (16, 16, True), (1, 24, False)],
                         ids=["skv<sq", "skv>sq", "causal", "one-query"])
def test_kv_len_attention_matches_jax_chunked(sq, skv, causal):
    """Row 0 sees every key, row 1 some, row 2 none (kv_len 0): the flash
    plain version (``ops.flash_attention`` on CPU tensors) and the port's
    ``chunked_attention`` give what JAX's ``chunked_attention`` gives."""
    rng = np.random.default_rng(sq * 100 + skv)
    q = rng.standard_normal((3, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, skv, 2, 16)).astype(np.float32)
    kl = np.array([skv, skv // 3 + 1, 0], np.int32)
    ref = jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=sq, kv_chunk=8 if skv % 8 == 0 else skv,
        kv_len=jnp.asarray(kl))
    t = [torch.from_numpy(a) for a in (q, k, v, kl)]
    flash = flash_attention(*t[:3], causal=causal, kv_len=t[3])
    chunked = tlayers.chunked_attention(*t[:3], causal=causal, q_chunk=sq,
                                        kv_chunk=8 if skv % 8 == 0 else skv,
                                        kv_len=t[3])
    for out in (flash, chunked):
        assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) < 1e-5
    # the kv_len 0 row is the mean of V over all keys, not NaN
    mean_v = np.repeat(v[2].mean(axis=0), 2, axis=0)        # (Hq, Dh)
    assert np.allclose(flash[2].numpy(), mean_v[None], atol=1e-5)


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------
SRC_LEN = np.array([16, 5, 0], np.int32)      # a full row, a ragged one, none


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_enc_layer_matches_jax(dtype):
    jm, jp, tm, tp = _models(dtype)
    jl, tl = _layer(jp["enc_layers"], tp["enc_layers"], 1)
    x = np.random.default_rng(1).standard_normal((B, 16, 128)).astype(
        np.float32)
    (jx, tx), (jsl, tsl) = _pair(x, dtype), _pair(SRC_LEN, dtype)
    jy, _, _ = jax.jit(lambda lp, x, sl: jenc.enc_layer(
        lp, x, jm.cfg, None, src_len=sl))(jl, jx, jsl)
    ty = tenc.enc_layer(tl, tx, tm.cfg, tsl)
    _close(ty, jy, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [8, 1], ids=["prefill", "decode"])
def test_cross_attend_matches_jax(dtype, sq):
    jm, jp, tm, tp = _models(dtype)
    jl, tl = _layer(jp["dec_layers"]["cross"], tp["dec_layers"]["cross"], 2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, sq, 128)).astype(np.float32)
    ck = rng.standard_normal((B, 16, 4, 32)).astype(np.float32)
    cv = rng.standard_normal((B, 16, 4, 32)).astype(np.float32)
    (jx, tx), (jk, tk), (jv, tv), (jsl, tsl) = (
        _pair(a, dtype) for a in (x, ck, cv, SRC_LEN))
    jy = jax.jit(lambda cp, x, ck, cv, sl: jenc.cross_attend(
        cp, x, ck, cv, jm.cfg, src_len=sl))(jl, jx, jk, jv, jsl)
    ty = tenc.cross_attend(tl, tx, tk, tv, tm.cfg, tsl)
    _close(ty, jy, dtype)


def _dec_inputs(dtype, seed=3):
    """(x (B, 8, D) prompt activations, memory (B, 16, D)) as pairs."""
    rng = np.random.default_rng(seed)
    return (_pair(rng.standard_normal((B, 8, 128)).astype(np.float32),
                  dtype),
            _pair(rng.standard_normal((B, 16, 128)).astype(np.float32),
                  dtype))


def _dec_prefilled(dtype):
    """dec_layer (layer 1) in prefill mode in both frameworks: (JAX out,
    JAX DecCache, port out, port DecCache) over a 16-slot self cache.
    JAX's layer projects and writes the cross memory itself; the port's
    reads it from the cache, written by ``cross_kv`` of the same memory
    (``Model.encode_cross_into``'s per-layer step)."""
    jm, jp, tm, tp = _models(dtype)
    jl, tl = _layer(jp["dec_layers"], tp["dec_layers"], 1)
    (jx, tx), (jmem, tmem) = _dec_inputs(dtype)
    jsl, tsl = _pair(SRC_LEN, dtype)
    jcache = jenc.DecCache(
        self_kv=JKV(jnp.zeros((B, 16, 4, 32), jx.dtype),
                    jnp.zeros((B, 16, 4, 32), jx.dtype),
                    jnp.full((B, 16), -1, jnp.int32)),
        cross_k=None, cross_v=None, src_len=None)
    jy, jnew, _ = jax.jit(lambda lp, x, mem, c, sl: jenc.dec_layer(
        lp, x, jm.cfg, None, mode="prefill", memory=mem, cache=c,
        src_len=sl))(jl, jx, jmem, jcache, jsl)
    tcache = tenc.DecCache(
        TKV(torch.zeros((B, 16, 4, 32), dtype=tx.dtype),
            torch.zeros((B, 16, 4, 32), dtype=tx.dtype),
            torch.full((B, 16), -1, dtype=torch.int32)),
        *tenc.cross_kv(tl["cross"], tmem), tsl)
    ty, tnew = tenc.dec_layer(tl, tx, tm.cfg, mode="prefill", cache=tcache)
    return jl, tl, jy, jnew, ty, tnew


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "extend", "decode"])
def test_dec_layer_matches_jax(dtype, mode):
    """Prefill writes the self KV into the cache (and JAX's the cross
    memory and ``src_len``, equal to the port's ``cross_kv``); extend (4
    suffix tokens behind the 8 prefilled) and decode
    (one token at position 8) read the cross memory and ``src_len`` back
    from the cache, over the dense self cache."""
    jm, jp, tm, tp = _models(dtype)
    jl, tl, jy, jnew, ty, tnew = _dec_prefilled(dtype)
    if mode == "prefill":
        _close(ty, jy, dtype)
        for t, j in ((tnew.cross_k, jnew.cross_k), (tnew.cross_v,
                                                     jnew.cross_v),
                     (tnew.self_kv.k, jnew.self_kv.k)):
            _close(t, j, dtype)
        assert np.array_equal(tnew.src_len.numpy(), np.asarray(jnew.src_len))
        assert np.array_equal(tnew.self_kv.slot_pos.numpy(),
                              np.asarray(jnew.self_kv.slot_pos))
        return
    S = 4 if mode == "extend" else 1
    x = np.random.default_rng(4).standard_normal((B, S, 128)).astype(
        np.float32)
    (jx, tx), (jpos, tpos) = _pair(x, dtype), _pair(np.full(B, 8, np.int32),
                                                    dtype)
    jy2, jc2, _ = jax.jit(lambda lp, x, c, p: jenc.dec_layer(
        lp, x, jm.cfg, None, mode=mode, cache=c, pos=p))(jl, jx, jnew, jpos)
    ty2, tc2 = tenc.dec_layer(tl, tx, tm.cfg, mode=mode, cache=tnew,
                              pos=tpos)
    _close(ty2, jy2, dtype)
    _close(tc2.self_kv.k, jc2.self_kv.k, dtype)
    assert np.array_equal(tc2.self_kv.slot_pos.numpy(),
                          np.asarray(jc2.self_kv.slot_pos))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def _sources(seed=5, lens=(20, 9, None), d=128):
    rng = np.random.default_rng(seed)
    return [None if n is None else
            rng.standard_normal((n, d)).astype(np.float32) for n in lens]


_PREFILLED = {}


def _prefilled(dtype):
    """Ragged prompts (16, 11, 5 tokens) with ragged sources (20 and 9
    frames, and none) through one ranged prefill in both models."""
    if dtype not in _PREFILLED:
        jm, jp, tm, tp = _models(dtype)
        rng = np.random.default_rng(0)
        lengths = np.array([16, 11, 5], np.int32)
        tokens = rng.integers(1, jm.cfg.vocab, (B, 16)).astype(np.int32)
        for b, n in enumerate(lengths):
            tokens[b, n:] = 0
        srcs = _sources()
        jextra = jm.ranged_batch_extras(srcs, MAX_LEN)
        textra = tm.ranged_batch_extras(srcs, MAX_LEN)
        jb = {"tokens": jnp.asarray(tokens), "length": jnp.asarray(lengths),
              **jextra}
        tb = {"tokens": torch.from_numpy(tokens),
              "length": torch.from_numpy(lengths), **textra}
        jlog, jcache = jax.jit(jm.prefill_ranged)(
            jp, jb, jm.init_cache(B, MAX_LEN))
        tlog, tcache = tm.prefill_ranged(
            tp, tb, tm.init_cache(B, MAX_LEN, device="cpu"))
        _PREFILLED[dtype] = (lengths, srcs, jlog, tlog, jcache, tcache)
    return _PREFILLED[dtype]


def _check_cache(tnode, jnode, dtype):
    _close(tnode.cross_k, jnode.cross_k, dtype)
    _close(tnode.cross_v, jnode.cross_v, dtype)
    assert np.array_equal(tnode.src_len.numpy(), np.asarray(jnode.src_len))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_ranged_matches_jax(dtype):
    _, _, jlog, tlog, jcache, tcache = _prefilled(dtype)
    assert _rel(_np(tlog), jlog) < (1e-4 if dtype == "float32" else 2e-2)
    tn, jn = tcache["dec_layers"], jcache["dec_layers"]
    _check_cache(tn, jn, dtype)
    assert tn.src_len[0].tolist() == [20, 9, 0]
    assert float(tn.cross_k[:, 2].abs().max()) == 0.0  # no source: zeros
    _close(tn.self_kv.k, jn.self_kv.k, dtype)
    assert np.array_equal(tn.self_kv.slot_pos.numpy(),
                          np.asarray(jn.self_kv.slot_pos))


def _paged(dtype, jcache, tcache):
    """The prefill caches with their self KV laid out as a paged arena
    (row b's logical page j is physical page b * N_LOG + j, one clean
    spare page); the cross memory stays dense per row."""
    jn = jcache["dec_layers"]
    L = jn.self_kv.k.shape[0]
    n = B * N_LOG + 1

    def arena(x):
        x = np.asarray(jnp.asarray(x, jnp.float32) if x.dtype != jnp.int32
                       else x)
        rows = np.moveaxis(x.reshape((L, B, N_LOG, PAGE) + x.shape[3:]),
                           0, 3)                    # (B, n_log, P, L, ...)
        out = np.full((n, PAGE, L) + x.shape[3:],
                      -1 if x.dtype == np.int32 else 0, x.dtype)
        out[:B * N_LOG] = rows.reshape((B * N_LOG, PAGE, L) + x.shape[3:])
        return out
    k, v, sp = (arena(a) for a in jn.self_kv)
    bt = np.arange(B * N_LOG, dtype=np.int32).reshape(B, N_LOG)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp_ = JPaged(jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(sp),
                 jnp.asarray(bt), jnp.int32(0))
    tp_ = TPaged(torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
                 torch.from_numpy(sp), torch.from_numpy(bt), 0)
    tn = tcache["dec_layers"]
    return ({"dec_layers": jn._replace(self_kv=jp_)},
            {"dec_layers": tn._replace(self_kv=tp_, cross_k=tn.cross_k.clone(),
                                       cross_v=tn.cross_v.clone(),
                                       src_len=tn.src_len.clone())})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(dtype):
    """One paged decode step at each row's next position, the cross
    memory read from the cache."""
    jm, jp, tm, tp = _models(dtype)
    lengths, _, _, _, jcache, tcache = _prefilled(dtype)
    jc, tc = _paged(dtype, jcache, tcache)
    tok = np.random.default_rng(6).integers(1, jm.cfg.vocab, (B, 1)).astype(
        np.int32)
    jlog, jn = jax.jit(jm.decode)(jp, jc, {"tokens": jnp.asarray(tok),
                                           "pos": jnp.asarray(lengths)})
    tlog, tn = tm.decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                  "pos": torch.from_numpy(lengths.copy())})
    assert _rel(_np(tlog), jlog) < (1e-4 if dtype == "float32" else 2e-2)
    _close(tn["dec_layers"].self_kv.k, jn["dec_layers"].self_kv.k, dtype)
    _check_cache(tn["dec_layers"], jn["dec_layers"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_src", [False, True],
                         ids=["cross-from-cache", "encoded-by-extend"])
def test_prefill_extend_matches_jax(dtype, with_src):
    """A ragged suffix extend behind each row's prefix, paged.  Without
    sources the cross memory is read from the cache; with them (as the
    batcher's extend step runs) the port encodes them into the cache's
    cross memory first, where JAX installs ``encode_cross_rows``."""
    jm, jp, tm, tp = _models(dtype)
    lengths, srcs, _, _, jcache, tcache = _prefilled(dtype)
    jc, tc = _paged(dtype, jcache, tcache)
    if with_src:
        srcs = _sources(seed=7, lens=(None, 30, 4))
        jc = j_install(jc, jm.encode_cross_rows(jp, srcs, MAX_LEN),
                       list(range(B)))
        for leaf in strip_kv_nodes(tc)["dec_layers"][1:]:
            leaf.zero_()                 # the extend must write it all
    etok = np.random.default_rng(8).integers(
        1, jm.cfg.vocab, (B, 8)).astype(np.int32)
    elen = np.array([8, 5, 3], np.int32)
    jlog, jn = jax.jit(jm.prefill_extend)(
        jp, {"tokens": jnp.asarray(etok), "pos": jnp.asarray(lengths),
             "length": jnp.asarray(elen)}, jc)
    tb = {"tokens": torch.from_numpy(etok),
          "pos": torch.from_numpy(lengths.copy()),
          "length": torch.from_numpy(elen)}
    if with_src:
        tb.update(tm.ranged_batch_extras(srcs, MAX_LEN))
    tlog, tn = tm.prefill_extend(tp, tb, tc)
    assert _rel(_np(tlog), jlog) < (1e-4 if dtype == "float32" else 2e-2)
    _close(tn["dec_layers"].self_kv.k, jn["dec_layers"].self_kv.k, dtype)
    assert np.array_equal(tn["dec_layers"].self_kv.slot_pos.numpy(),
                          np.asarray(jn["dec_layers"].self_kv.slot_pos))
    _check_cache(tn["dec_layers"], jn["dec_layers"], dtype)


def test_plain_prefill_matches_jax():
    """``prefill`` (unpadded, no src_len: every frame valid)."""
    jm, jp, tm, tp = _models("float32")
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, jm.cfg.vocab, (B, 12)).astype(np.int32)
    src = rng.standard_normal((B, 16, 128)).astype(np.float32)
    jlog, jcache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(tokens), "src": jnp.asarray(src)},
        jm.init_cache(B, 16))
    tlog, tcache = tm.prefill(
        tp, {"tokens": torch.from_numpy(tokens), "src": torch.from_numpy(src)},
        tm.init_cache(B, 16, device="cpu"))
    assert _rel(_np(tlog), jlog) < 1e-4
    _check_cache(tcache["dec_layers"], jcache["dec_layers"], "float32")


def test_encode_cross_rows_and_install_match_jax():
    """The token-at-a-time path's cross memory: encoded rows and their
    install into slots 2 and 0 of a cache, in place in the port."""
    jm, jp, tm, tp = _models("float32")
    srcs = _sources(seed=10, lens=(None, 13))
    jmem = jm.encode_cross_rows(jp, srcs, MAX_LEN)
    tmem = tm.encode_cross_rows(tp, srcs, MAX_LEN)
    for t, j in zip(tmem, jmem):
        _close(t, j, "float32")
    assert tm.encode_cross_rows(tp, [None, None], MAX_LEN) is None
    jc = j_install(jm.init_cache(B, MAX_LEN), jmem, [2, 0])
    tc = tm.init_cache(B, MAX_LEN, device="cpu")
    before = tc["dec_layers"].cross_k.data_ptr()
    install_cross_memory(tc, tmem, [2, 0])
    assert tc["dec_layers"].cross_k.data_ptr() == before
    _check_cache(tc["dec_layers"], jc["dec_layers"], "float32")


def test_ranged_batch_extras_match_jax():
    jm, _, tm, _ = _models("bfloat16")
    srcs = _sources(seed=11, lens=(40, None, 3))     # 40 frames cut to 32
    j, t = jm.ranged_batch_extras(srcs, MAX_LEN), tm.ranged_batch_extras(
        srcs, MAX_LEN)
    assert sorted(t) == sorted(j) == ["src", "src_len"]
    assert t["src"].dtype == torch.bfloat16
    assert np.array_equal(_np(t["src"]), _np(j["src"]))
    assert t["src_len"].tolist() == np.asarray(j["src_len"]).tolist() == [
        32, 0, 3]
    assert Model(t_smoke_config(t_get_arch("qwen3-4b"))).ranged_batch_extras(
        srcs, MAX_LEN) == {}


def test_cache_specs_and_axes_match_jax():
    jm, _, tm, _ = _models("float32")
    jspec = jm.cache_specs(B, MAX_LEN)["dec_layers"]
    tspec = tm.cache_specs(B, MAX_LEN)["dec_layers"]
    assert type(tspec).__name__ == type(jspec).__name__ == "DecCache"
    for t, j in zip(tenc.DecCache(*tspec)[1:], jspec[1:]):
        assert (t.shape, t.logical, t.init, t.dtype) == (
            j.shape, j.logical, j.init, j.dtype)
    for t, j in zip(tspec.self_kv, jspec.self_kv):
        assert (t.shape, t.logical) == (j.shape, j.logical)
    axes = cache_batch_axes(tm, B, MAX_LEN)["dec_layers"]
    assert (axes.cross_k, axes.cross_v, axes.src_len) == (1, 1, 1)
    assert tuple(axes.self_kv) == (1, 1, 1)
    assert tm.source_len(MAX_LEN) == jm.source_len(MAX_LEN) == MAX_LEN
    assert tm.supports_paged_kv and not tm.decode_state_positional


# --------------------------------------------------------------------------
# the source digest, the weight bridge
# --------------------------------------------------------------------------
class _Req:
    def __init__(self, src=None, tenant="default", public=False):
        self.src, self.tenant, self.public = src, tenant, public


@pytest.mark.parametrize("tenant,public", [("default", False), ("a", False),
                                           ("default", True)])
@pytest.mark.parametrize("with_src", [False, True])
def test_source_digest_matches_jax(tenant, public, with_src):
    """``request_ctx_key`` and ``public_ctx_key`` key the prefix tree by
    the tenant's namespace and the source's shape and SHA-1, as JAX's do;
    sources that differ in one value get different roots."""
    src = (np.random.default_rng(12).standard_normal((7, 16))
           .astype(np.float32) if with_src else None)
    req = _Req(src, tenant, public)
    for fn in ("request_ctx_key", "public_ctx_key"):
        assert getattr(tkvpool, fn)(req) == getattr(jkvpool, fn)(req)
    if with_src:
        other = src.copy()
        other[3, 5] += 1.0
        assert (tkvpool.request_ctx_key(_Req(other, tenant, public))
                != tkvpool.request_ctx_key(req))


def test_source_digest_is_hashed_once_per_source(monkeypatch):
    """Both ctx keys of a request reuse one SHA-1 of its source; a new
    source object on the request is hashed anew."""
    calls = []
    sha1 = tkvpool.hashlib.sha1

    def counting(b):
        calls.append(len(b))
        return sha1(b)

    monkeypatch.setattr(tkvpool.hashlib, "sha1", counting)
    src = np.random.default_rng(13).standard_normal((5, 16)).astype(
        np.float32)
    req = _Req(src)
    keys = [tkvpool.request_ctx_key(req), tkvpool.public_ctx_key(req),
            tkvpool.request_ctx_key(req)]
    assert len(calls) == 1 and keys[0] == keys[2] == keys[1][1]
    req.src = src + 1.0
    assert tkvpool.request_ctx_key(req) != keys[0] and len(calls) == 2

def test_weight_bridge_gives_jax_n_params():
    """The bridged smoke tree is the port's spec tree, and the parameter
    count matches JAX's at smoke size and at full width (1.63 B: the
    untied embedding and output, 24 encoder and 24 decoder layers)."""
    jm, jp, tm, tp = _models("float32")
    assert sum(t.numel() for t in _leaves(tp)) == tm.n_params() == \
        jm.n_params()
    full_j = build_model(get_arch(ARCH), single_device_ctx())
    full_t = Model(t_get_arch(ARCH))
    assert full_t.n_params() == full_j.n_params()
    assert 1.6e9 < full_t.n_params() < 1.7e9
    ta, ja = full_t.abstract_params(), full_j.abstract_params()
    assert tuple(ta["dec_layers"]["cross"]["wq"].shape) == tuple(
        ja["dec_layers"]["cross"]["wq"].shape) == (24, 1024, 16, 64)
    assert tuple(ta["enc_layers"]["mlp"]["w_up"].shape) == (24, 1024, 8192)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


# --------------------------------------------------------------------------
# the CPU batcher against the JAX batcher
# --------------------------------------------------------------------------
def _rounds(vocab, d=128):
    """Two rounds of two waves of 4 requests: a shared 18-token prefix
    (new each round) plus 2..7 tokens of their own, sources of 5..30
    frames and one ``src=None`` a wave; wave 2 reuses wave 1's sources
    request by request, so its prefix hits land under their digests."""
    rng = np.random.RandomState(21)
    out = []
    for _ in range(2):
        shared = rng.randint(1, vocab, size=18)
        srcs = [rng.randn(int(n), d).astype(np.float32)
                for n in rng.randint(5, 31, size=3)] + [None]
        for _ in range(2):
            out.append([(np.concatenate([shared, rng.randint(
                1, vocab, size=int(n))]).astype(np.int32), s)
                for n, s in zip(rng.randint(2, 8, size=4), srcs)])
    return out


PLANES = {"paged": {}, "dense": {"kv_pool": None},
          "token-at-a-time": {"prefill_chunk": None},
          "token-at-a-time-dense": {"prefill_chunk": None, "kv_pool": None}}
_SERVED = {}


def _serve(port: bool, plane: str):
    jm, jp, tm, tp = _models("float32")
    kw = {"batch_slots": 2, "max_len": MAX_LEN, "page_size": PAGE,
          "prefill_chunk": 8, **PLANES[plane]}
    if port:
        bat, cls = ContinuousBatcher(tm, tp, device="cpu", **kw), Request
    else:
        bat, cls = JBatcher(jm, jp, **kw), JRequest
    rid = 0
    for wave in _rounds(jm.cfg.vocab):
        for prompt, src in wave:
            bat.submit(cls(rid=rid, prompt=prompt, max_new_tokens=4,
                           src=src))
            rid += 1
        bat.run_until_drained()
    return {r.rid: r.output for r in bat.done}, bat


def _both(plane):
    if plane not in _SERVED:
        _SERVED[plane] = (_serve(False, plane), _serve(True, plane))
    return _SERVED[plane]


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_batcher_tokens_match_jax(plane):
    (jout, jbat), (tout, tbat) = _both(plane)
    assert len(tout) == 16 and tout == jout
    if plane == "paged":
        assert tbat.pool.prefix_hit_tokens == jbat.pool.prefix_hit_tokens > 0


def test_paged_warm_hits_under_the_source_digest_and_drain():
    """Wave 2 of each round hits wave 1's 16-token prefix pages only
    under each request's own source digest (4 requests x 2 rounds), the
    pool holds no page after the drain, and the resident cross memory
    stayed the batcher's own tensors."""
    (_, _), (_, tbat) = _both("paged")
    assert tbat.pool.prefix_hit_tokens == 2 * 4 * 16
    pool = tbat.pool
    assert all(n.refs == 0 for n in pool.tree._walk())
    assert pool.pages_in_use == pool.evictable_pages()
    assert (pool.block_table == pool.sentinel).all()
    dec = tbat.resident["dec_layers"]
    assert dec.self_kv is None and dec.cross_k.shape == (4, 2, MAX_LEN, 4, 32)


def test_launch_serve_seamless_on_cpu():
    assert t_serve.main(["--device", "cpu", "--arch", ARCH, "--requests",
                         "3", "--max-new", "3", "--max-len", "64"]) == 0
