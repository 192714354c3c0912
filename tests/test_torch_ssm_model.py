"""The port's ssm and hybrid Model against the JAX Model (CPU).

mamba2-2.7b and zamba2-2.7b at smoke size, weights from ``Model.init``
through the weight bridge:

* ``prefill_ranged(checkpoint_every=)`` on bucket-padded rows: logits,
  the cache (Mamba states, and zamba2's shared-attention KV) and the
  chunk checkpoints;
* ``slice_checkpoint`` (a copy) and ``restore_state_row``, then a suffix
  ``prefill_extend`` from the restored snapshot over the dense per-slot
  cache, with a row riding along at ``length`` 0 and ``pos`` = max_len
  (its state and KV come back unchanged), and a decode step;
* extend over a dense ``KVSlice`` (writes past the cache drop), and the
  same attention through the paged extend kernel's plain version over the
  cache seen as an arena (the route the card takes);
* the cache helpers on the nested hybrid tree, and the full-width specs.

Float32, rel < 1e-5 (summation order).  bfloat16 is held block by block
in ``test_torch_ssd.py`` (rel < 2e-2, the tolerance of
``tests/test_kernels.py``): through a stack of Mamba layers the bf16
rounding at other places in the two frameworks adds up with depth (rel
0.5e-2, 1.0e-2, 1.4e-2, 2.6e-2 after 1 to 4 smoke layers of mamba2, while
float32 agrees to 1e-6), so the model is compared in float32, as the
token-identity parity is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import cache_utils as jcu  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.kernels.flash_attention.ops import paged_extend_attention  # noqa: E402
from repro_torch.models import cache_utils as tcu  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
B, S_PAD, MAX_LEN, CK = 3, 32, 64, 8
TOL = {"float32": 1e-5}
_MODELS, _PREFILLED = {}, {}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree):
    """Tensor / array leaves in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _models(arch, dtype):
    key = (arch, dtype)
    if key not in _MODELS:
        jm = build_model(smoke_config(get_arch(arch)).replace(dtype=dtype),
                         single_device_ctx())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
        tm = Model(t_smoke_config(t_get_arch(arch)).replace(dtype=dtype))
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=tm.dtype, device="cpu", specs=tm.param_specs())
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _batch(**arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _prefilled(arch, dtype):
    """Cold bucket-padded rows (lengths 32, 21, 9) through one
    checkpointing ranged prefill in both models (memoized)."""
    key = (arch, dtype)
    if key not in _PREFILLED:
        jm, jp, tm, tp = _models(arch, dtype)
        rng = np.random.default_rng(0)
        lengths = np.array([32, 21, 9], np.int32)
        tokens = rng.integers(1, jm.cfg.vocab, (B, S_PAD)).astype(np.int32)
        tokens[np.arange(S_PAD)[None] >= lengths[:, None]] = 0
        jb, tb = _batch(tokens=tokens, length=lengths)
        jout = jax.jit(jm.prefill_ranged, static_argnames="checkpoint_every")(
            jp, jb, jm.init_cache(B, MAX_LEN), checkpoint_every=CK)
        tout = tm.prefill_ranged(tp, tb, tm.init_cache(B, MAX_LEN,
                                                       device="cpu"),
                                 checkpoint_every=CK)
        _PREFILLED[key] = (lengths, tokens, jout, tout)
    return _PREFILLED[key]


@pytest.mark.parametrize("dtype", ["float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_ranged_with_checkpoints_matches_jax(arch, dtype):
    _, _, (jlog, jcache, jck), (tlog, tcache, tck) = _prefilled(arch, dtype)
    tol = TOL[dtype]
    assert _rel(_np(tlog), jlog) < tol
    jl_, tl_ = _leaves(jcache), _leaves(tcache)
    assert [tuple(t.shape) for t in tl_] == [j.shape for j in jl_]
    for t, j in zip(tl_, jl_):
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), np.asarray(j))
        else:
            assert _rel(_np(t), j) < tol
    # (L, B, nb, ...) for ssm, (G, E, B, nb, ...) for hybrid
    for t, j in zip(tck, jck):
        assert tuple(t.shape) == j.shape
        assert _rel(_np(t), j) < tol


@pytest.mark.parametrize("arch", ARCHS)
def test_slice_checkpoint_is_a_copy_and_matches_jax(arch):
    jm, _, tm, _ = _models(arch, "float32")
    _, _, (_, _, jck), (_, _, tck) = _prefilled(arch, "float32")
    for row, c in ((0, 3), (1, 1)):
        js = jm.slice_checkpoint(jck, row, c)
        ts = tm.slice_checkpoint(tck, row, c)
        for t, j, whole in zip(ts, js, tck):
            assert tuple(t.shape) == j.shape
            assert _rel(_np(t), j) < TOL["float32"]
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() != \
                whole.untyped_storage().data_ptr()


def _restore_both(arch, dtype):
    """A fresh (B, MAX_LEN) cache in both models with slot 1 restored from
    row 0's snapshot after 16 tokens (its chunk 1) and, for hybrid, the
    chain's two shared-attention pages loaded; slot 2 restored from row 2's
    final prefill state (it rides along)."""
    jm, jp, tm, tp = _models(arch, dtype)
    _, tokens, (_, jcache, jck), (_, tcache, tck) = _prefilled(arch, dtype)
    jc, tc = jm.init_cache(B, MAX_LEN), tm.init_cache(B, MAX_LEN,
                                                      device="cpu")
    jaxes = jcu.kv_node_axes(jm, 1, MAX_LEN)
    taxes = tcu.kv_node_axes(tm, 1, MAX_LEN)
    assert taxes == jaxes
    jc = jm.restore_state_row(jc, jm.slice_checkpoint(jck, 0, 1), 1)
    tc = tm.restore_state_row(tc, tm.slice_checkpoint(tck, 0, 1), 1)
    ax = tm._state_batch_axis
    take = lambda a, r: a[(slice(None),) * ax + (slice(r, r + 1),)]  # noqa: E731
    jnode = (jcache["mamba_layers"] if arch == "mamba2-2.7b"
             else jcache["groups"].mamba)
    tnode = (tcache["mamba_layers"] if arch == "mamba2-2.7b"
             else tcache["groups"].mamba)
    jc = jm.restore_state_row(jc, jax.tree.map(lambda a: take(a, 2), jnode),
                              2)
    tc = tm.restore_state_row(tc, type(tnode)(*(take(a, 2) for a in tnode)),
                              2)
    if jaxes:
        js = jcu.extract_row_pages(jcache, jaxes, 0, 0, 2, CK)
        ts = tcu.extract_row_pages(tcache, taxes, 0, 0, 2, CK)
        jc = jcu.load_pages_into_row(jc, jc, jaxes, 1, js, 0, CK)
        tc = tcu.load_pages_into_row(tc, taxes, 1, ts, 0, CK)
        js2 = jcu.extract_row_pages(jcache, jaxes, 2, 0, 2, CK)
        ts2 = tcu.extract_row_pages(tcache, taxes, 2, 0, 2, CK)
        jc = jcu.load_pages_into_row(jc, jc, jaxes, 2, js2, 0, CK)
        tc = tcu.load_pages_into_row(tc, taxes, 2, ts2, 0, CK)
    return jm, jp, tm, tp, tokens, jc, tc


@pytest.mark.parametrize("dtype", ["float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_extend_from_a_restored_snapshot_matches_jax(arch, dtype):
    """Slot 1 continues row 0's prompt after 16 restored tokens; slot 0
    is empty and slot 2 rides along (``length`` 0, ``pos`` = max_len):
    its recurrent state comes back bit for bit, its KV unchanged."""
    jm, jp, tm, tp, tokens, jc, tc = _restore_both(arch, dtype)
    state = tc["mamba_layers"] if arch == "mamba2-2.7b" else tc["groups"].mamba
    kv = [] if arch == "mamba2-2.7b" else list(tc["groups"].shared)
    state0, kv0 = [a.clone() for a in state], [a.clone() for a in kv]
    ext = np.zeros((B, 16), np.int32)
    ext[1] = tokens[0, 16:32]
    jb, tb = _batch(tokens=ext, pos=np.array([MAX_LEN, 16, MAX_LEN],
                                             np.int32),
                    length=np.array([0, 16, 0], np.int32))
    jlog, jn = jax.jit(jm.prefill_extend)(jp, jb, jc)
    tlog, tn = tm.prefill_extend(tp, tb, tc)
    assert all(a is b for a, b in zip(_leaves(tn), _leaves(tc)))  # in place
    assert _rel(_np(tlog[1]), jlog[1]) < TOL[dtype]
    for t, j in zip(_leaves(tn), _leaves(jn)):
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), np.asarray(j))
        else:
            assert _rel(_np(t), j) < TOL[dtype]
    row = (slice(None),) * tm._state_batch_axis + (2,)
    for a, a0 in zip(state, state0):
        assert torch.equal(a[row], a0[row])      # bit for bit
    for a, a0 in zip(kv, kv0):
        assert torch.equal(a[:, 2], a0[:, 2])    # every write dropped
    # the restored row's logits equal a cold prefill of the whole prompt
    _, _, (jlog_c, _, _), (tlog_c, _, _) = _prefilled(arch, dtype)
    assert _rel(_np(tlog[1]), _np(tlog_c[0])) < 20 * TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_restore_matches_jax(arch):
    jm, jp, tm, tp, _, jc, tc = _restore_both(arch, "float32")
    dtok = np.array([[0], [5], [7]], np.int32)
    jb, tb = _batch(tokens=dtok, pos=np.array([0, 16, 9], np.int32))
    jlog, jn = jax.jit(jm.decode)(jp, jc, jb)
    tlog, tn = tm.decode(tp, tc, tb)
    assert all(a is b for a, b in zip(_leaves(tn), _leaves(tc)))  # in place
    assert _rel(_np(tlog[1:]), jlog[1:]) < TOL["float32"]
    for t, j in zip(_leaves(tn), _leaves(jn)):
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), np.asarray(j))
        else:
            assert _rel(_np(t), j) < TOL["float32"]


def test_family_capabilities():
    for arch, paged, snap in (("mamba2-2.7b", False, True),
                              ("zamba2-2.7b", False, True),
                              ("qwen3-4b", True, False)):
        jm = build_model(smoke_config(get_arch(arch)), single_device_ctx())
        tm = Model(t_smoke_config(t_get_arch(arch)))
        assert tm.supports_paged_kv == jm.supports_paged_kv == paged
        assert tm.supports_snapshot_state == jm.supports_snapshot_state == snap
        assert tm.decode_state_positional == jm.decode_state_positional
        assert tm.chunked_prefill_exact == jm.chunked_prefill_exact


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_helpers_on_the_recurrent_trees_match_jax(arch):
    """Batch axes, KV nodes (none for ssm; zamba2's shared KVSlice nested
    in its ZambaGroupCache), the resident remainder, the snapshot size,
    and clear_kv_row."""
    jm, _, tm, _ = _models(arch, "float32")
    jaxes, taxes = (jcu.cache_batch_axes(jm, B, MAX_LEN),
                    tcu.cache_batch_axes(tm, B, MAX_LEN))
    assert _leaves(taxes) == _leaves(jaxes)
    assert (tcu.recurrent_state_bytes(tm, MAX_LEN)
            == jcu.recurrent_state_bytes(jm, MAX_LEN))
    assert (tcu.kv_position_bytes(tm, MAX_LEN)
            == jcu.kv_position_bytes(jm, MAX_LEN))
    _, _, (_, jcache, _), (_, tcache, _) = _prefilled(arch, "float32")
    jn, tn = jcu.kv_cache_nodes(jcache), tcu.kv_cache_nodes(tcache)
    assert len(tn) == len(jn) == (0 if arch == "mamba2-2.7b" else 1)
    res = tcu.strip_kv_nodes(tcache)
    assert len(_leaves(res)) == len(_leaves(jcu.strip_kv_nodes(jcache)))
    back = tcu.rebuild_kv_nodes(tm.cache_specs(B, MAX_LEN), res, tn)
    assert all(a is b for a, b in zip(_leaves(back), _leaves(tcache)))
    if tn:
        jc = jcu.clear_kv_row(jcache, jcu.kv_node_axes(jm, B, MAX_LEN), 1)
        tcu.clear_kv_row(tcache, tcu.kv_node_axes(tm, B, MAX_LEN), 1)
        assert np.array_equal(
            tcu.kv_cache_nodes(tcache)[0].slot_pos.numpy(),
            np.asarray(jcu.kv_cache_nodes(jc)[0].slot_pos))
        _PREFILLED.pop((arch, "float32"))    # the cache was changed


def test_full_width_specs_match_jax():
    """mamba2-2.7b and zamba2-2.7b at full width: the port's meta tensors
    have JAX's shapes and dtypes (the ssm leaves float32), 2.84 B and 2.45
    B parameters, and the snapshot sizes are JAX's."""
    for arch, lo, hi in (("mamba2-2.7b", 2.80e9, 2.90e9),
                         ("zamba2-2.7b", 2.40e9, 2.50e9)):
        jm = build_model(get_arch(arch), single_device_ctx())
        tm = Model(t_get_arch(arch))
        jf, tf = _leaves(jm.abstract_params()), _leaves(tm.abstract_params())
        assert [tuple(t.shape) for t in tf] == [j.shape for j in jf]
        assert [str(t.dtype).split(".")[-1] for t in tf] == \
            [str(j.dtype) for j in jf]
        assert tm.n_params() == jm.n_params() and lo < tm.n_params() < hi
        assert (tcu.recurrent_state_bytes(tm, 512)
                == jcu.recurrent_state_bytes(jm, 512))


# --------------------------------------------------------------------------
# attention extend over a dense per-slot cache
# --------------------------------------------------------------------------
def _attn(seed=0):
    jc = smoke_config(get_arch("zamba2-2.7b")).replace(dtype="float32")
    tc = t_smoke_config(t_get_arch("zamba2-2.7b")).replace(dtype="float32")
    jp = jax_init_params(jl.attn_specs(jc), jax.random.PRNGKey(seed),
                         "float32")
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a), jp),
                           dtype=torch.float32, device="cpu")
    return jc, tc, jp, tp


def _dense_cache(jc, S_c, pos, seed=1):
    rng = np.random.default_rng(seed)
    hkv, dh = jc.num_kv_heads, jc.resolved_head_dim
    k = rng.standard_normal((len(pos), S_c, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((len(pos), S_c, hkv, dh)).astype(np.float32)
    sp = np.where(np.arange(S_c)[None] < np.minimum(pos, S_c)[:, None],
                  np.arange(S_c)[None], -1).astype(np.int32)
    return k, v, sp


def test_attention_extend_over_a_dense_cache_matches_jax():
    """Suffix queries at per-row offsets write into a dense KVSlice in
    place; a row near the end of the cache and a row at ``pos`` = S_c drop
    the writes that land past it, as JAX's ``mode="drop"``."""
    jc, tc, jp, tp = _attn()
    S_c, S = 32, 8
    pos = np.array([4, 28, S_c], np.int32)
    k, v, sp = _dense_cache(jc, S_c, pos)
    x = np.random.default_rng(2).standard_normal(
        (3, S, jc.d_model)).astype(np.float32)
    jy, jn = jl.attention_block(jp, jnp.asarray(x), jc, None, mode="extend",
                                cache=jl.KVSlice(*(jnp.asarray(a)
                                                   for a in (k, v, sp))),
                                pos=jnp.asarray(pos))
    tcache = tl.KVSlice(*(torch.from_numpy(a.copy()) for a in (k, v, sp)))
    ty, tn = tl.attention_block(tp, torch.from_numpy(x), tc, mode="extend",
                                cache=tcache, pos=torch.from_numpy(pos))
    assert tn is tcache
    assert _rel(_np(ty[:2]), jy[:2]) < TOL["float32"]
    assert _rel(_np(tn.k), jn.k) < 1e-6 and _rel(_np(tn.v), jn.v) < 1e-6
    assert np.array_equal(tn.slot_pos.numpy(), np.asarray(jn.slot_pos))
    assert np.array_equal(tn.k[2].numpy(), k[2])      # every write dropped
    assert (tn.slot_pos[1, 28:] == torch.arange(28, 32)).all()


@pytest.mark.parametrize("S_c", [32, 96, 512])
def test_dense_cache_as_an_arena_gives_the_extend_masks(S_c):
    """The card's route: the paged extend kernel over the dense cache seen
    as an arena (``dense_kv_arena``).  Its plain version, with the kernel's
    mask 0 <= slot_pos <= q_pos, equals ``extend_attention_ref`` over the
    dense cache, empty slots and a ride-along row included."""
    jc, tc, _, _ = _attn()
    pos = np.array([0, S_c // 2 + 3, S_c], np.int32)
    k, v, sp = _dense_cache(jc, S_c, pos + 5, seed=3)
    sp[1, 2] = -1                                    # an empty slot
    cache = tl.KVSlice(*(torch.from_numpy(a) for a in (k, v, sp)))
    S = 12
    q = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, S, tc.num_heads, tc.resolved_head_dim)).astype(np.float32))
    ps = torch.from_numpy(pos)
    ak, av, asp, bt = tl.dense_kv_arena(cache)
    assert ak.data_ptr() == cache.k.data_ptr()       # a view, no copy
    assert ak.shape[1] == np.gcd(S_c, 64) and tuple(bt.shape) == (
        3, S_c // ak.shape[1])
    out = paged_extend_attention(q, ak, av, asp, bt, ps, 0)
    ref = tl.extend_attention_ref(q, cache.k, cache.v, cache.slot_pos,
                                  ps[:, None] + torch.arange(S)[None])
    assert _rel(_np(out), _np(ref)) < 1e-6
