"""The port's Model against the JAX Model: qwen3-4b at smoke size.

Weights come from ``Model.init(PRNGKey(0))`` through the weight bridge.
``prefill_ranged`` runs on the same bucket-padded prompts; the JAX
prefill cache is then laid out as a paged arena that both models decode
and suffix-extend over.  Logits agree within rel 1e-4 in float32 and
2e-2 in bfloat16 (bf16 rounds at other places in the two frameworks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models.cache_utils import cache_batch_axes as jax_batch_axes  # noqa: E402
from repro.models.cache_utils import slice_cache_slots as jax_slice_slots  # noqa: E402
from repro.models.layers import PagedKVCache as JPaged  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.models.cache_utils import (  # noqa: E402
    cache_batch_axes,
    slice_cache_slots,
)
from repro_torch.models.layers import PagedKVCache as TPaged  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402

B, MAX_LEN, PAGE = 2, 32, 8
N_LOG = MAX_LEN // PAGE
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
_MODELS = {}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(dtype):
    if dtype not in _MODELS:
        jcfg = smoke_config(get_arch("qwen3-4b")).replace(dtype=dtype)
        tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype=dtype)
        jm = build_model(jcfg, single_device_ctx())
        jp = jm.init(jax.random.PRNGKey(0))
        tm = Model(tcfg)
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=tm.dtype, device="cpu")
        _MODELS[dtype] = (jm, jp, tm, tp)
    return _MODELS[dtype]


def _batch(**arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _paged_from(jcache):
    """The JAX prefill cache rows as a paged arena: row b's logical page j
    is physical page b*N_LOG + j; one clean spare page at the end."""
    node = jcache["layers"]
    k, v, sp = (np.asarray(jnp.asarray(a, jnp.float32)
                           if a.dtype != jnp.int32 else a)
                for a in (node.k, node.v, node.slot_pos))
    L = k.shape[0]
    n = B * N_LOG + 1

    def arena(x):
        rows = x[:, :, :N_LOG * PAGE].reshape(
            (L, B, N_LOG, PAGE) + x.shape[3:])
        rows = np.moveaxis(rows, 0, 3)            # (B, n_log, P, L, ...)
        out = np.zeros((n, PAGE, L) + x.shape[3:], x.dtype)
        if x.dtype == np.int32:
            out[:] = -1
        out[:B * N_LOG] = rows.reshape((B * N_LOG, PAGE, L) + x.shape[3:])
        return out
    bt = np.arange(B * N_LOG, dtype=np.int32).reshape(B, N_LOG)
    return arena(k), arena(v), arena(sp), bt


def _pair(arrays, dtype):
    """Fresh JAX and port PagedKVCache views of the same arena."""
    k, v, sp, bt = arrays
    jd = jnp.dtype(dtype)
    jc = {"layers": JPaged(jnp.asarray(k, jd), jnp.asarray(v, jd),
                           jnp.asarray(sp), jnp.asarray(bt), jnp.int32(0))}
    td = getattr(torch, dtype)
    tc = {"layers": TPaged(torch.from_numpy(k.copy()).to(td),
                           torch.from_numpy(v.copy()).to(td),
                           torch.from_numpy(sp.copy()),
                           torch.from_numpy(bt.copy()), 0)}
    return jc, tc


_PREFILLED = {}


def _prefilled(dtype):
    """Cold prompts through one ranged prefill in both models (memoized
    per dtype): (lengths, JAX logits, port logits, JAX cache, port cache,
    the JAX cache laid out as a paged arena)."""
    if dtype not in _PREFILLED:
        jm, jp, tm, tp = _models(dtype)
        rng = np.random.default_rng(0)
        lengths = np.array([16, 11], np.int32)
        tokens = rng.integers(1, jm.cfg.vocab, (B, 16)).astype(np.int32)
        tokens[1, 11:] = 0
        jb, tb = _batch(tokens=tokens, length=lengths)
        jlog, jcache = jax.jit(jm.prefill_ranged)(
            jp, jb, jm.init_cache(B, MAX_LEN))
        tlog, tcache = tm.prefill_ranged(
            tp, tb, tm.init_cache(B, MAX_LEN, device="cpu"))
        _PREFILLED[dtype] = (lengths, jlog, tlog, jcache, tcache,
                             _paged_from(jcache))
    return _PREFILLED[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_ranged_matches_jax(dtype):
    _, jlog, tlog, jcache, tcache, _ = _prefilled(dtype)
    assert _rel(_np(tlog), jlog) < TOL[dtype]
    assert _rel(_np(tcache["layers"].k), jcache["layers"].k) < TOL[dtype]
    assert np.array_equal(tcache["layers"].slot_pos.numpy(),
                          np.asarray(jcache["layers"].slot_pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(dtype):
    """One decode step at each row's next position, paged."""
    jm, jp, tm, tp = _models(dtype)
    lengths, *_, arena = _prefilled(dtype)
    dtok = np.random.default_rng(1).integers(
        1, jm.cfg.vocab, (B, 1)).astype(np.int32)
    jb, tb = _batch(tokens=dtok, pos=lengths.copy())
    jc, tc = _pair(arena, dtype)
    jlog, jn = jax.jit(jm.decode)(jp, jc, jb)
    tlog, tn = tm.decode(tp, tc, tb)
    assert _rel(_np(tlog), jlog) < TOL[dtype]
    assert _rel(_np(tn["layers"].k), jn["layers"].k) < TOL[dtype]
    assert np.array_equal(tn["layers"].slot_pos.numpy(),
                          np.asarray(jn["layers"].slot_pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_extend_matches_jax(dtype):
    """A ragged suffix extend behind each row's resident prefix, paged."""
    jm, jp, tm, tp = _models(dtype)
    lengths, *_, arena = _prefilled(dtype)
    etok = np.random.default_rng(2).integers(
        1, jm.cfg.vocab, (B, 8)).astype(np.int32)
    jb, tb = _batch(tokens=etok, pos=lengths.copy(),
                    length=np.array([8, 5], np.int32))
    jc, tc = _pair(arena, dtype)
    jlog, jn = jax.jit(jm.prefill_extend)(jp, jb, jc)
    tlog, tn = tm.prefill_extend(tp, tb, tc)
    assert _rel(_np(tlog), jlog) < TOL[dtype]
    assert _rel(_np(tn["layers"].k), jn["layers"].k) < TOL[dtype]
    assert np.array_equal(tn["layers"].slot_pos.numpy(),
                          np.asarray(jn["layers"].slot_pos))


def test_prefill_matches_jax():
    """Plain (unpadded) prefill: logits at the last position and the
    cache of every layer."""
    jm, jp, tm, tp = _models("float32")
    tokens = np.random.default_rng(3).integers(
        1, jm.cfg.vocab, (B, 12)).astype(np.int32)
    jb, tb = _batch(tokens=tokens)
    jlog, jcache = jax.jit(jm.prefill)(jp, jb, jm.init_cache(B, MAX_LEN))
    tlog, tcache = tm.prefill(tp, tb, tm.init_cache(B, MAX_LEN, device="cpu"))
    assert _rel(_np(tlog), jlog) < TOL["float32"]
    assert _rel(_np(tcache["layers"].v), jcache["layers"].v) < TOL["float32"]


def test_cache_slot_helpers_match_jax():
    """cache_batch_axes + slice_cache_slots take the same rows."""
    jm, _, tm, _ = _models("float32")
    _, _, _, jcache, tcache, _ = _prefilled("float32")
    jaxes = jax_batch_axes(jm, B, MAX_LEN)
    taxes = cache_batch_axes(tm, B, MAX_LEN)
    assert tuple(taxes["layers"]) == tuple(jaxes["layers"])
    jrow = jax_slice_slots(jcache, jaxes, [1])["layers"]
    trow = slice_cache_slots(tcache, taxes, [1])["layers"]
    assert np.array_equal(trow.slot_pos.numpy(), np.asarray(jrow.slot_pos))
    assert _rel(_np(trow.k), jrow.k) < TOL["float32"]
