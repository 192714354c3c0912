"""The port's MoE block and MoE model against JAX (CPU).

* ``moe_block`` on the three (experts, top-k, shared) cases of
  ``tests/test_moe.py``, training (load-balance loss included) and
  inference, and on a capacity that drops tokens: the dropped tokens must
  be JAX's, which holds only if the slot cumsum runs in JAX's order;
* deepseek-moe-16b at smoke size (a leading dense layer, then MoE layers,
  each stack with its own cache node): ``prefill_ranged``, paged
  ``decode`` and paged ``prefill_extend`` logits within rel 1e-4 in
  float32 and 2e-2 in bfloat16, as ``test_torch_model.py``;
* the float32 router of a bf16 model stays float32 through ``init`` and
  through the weight bridge.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig, smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import PagedKVCache as JPaged  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import PagedKVCache as TPaged  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402

from test_moe import _cfg  # noqa: E402

B, MAX_LEN, PAGE = 2, 32, 8
N_LOG = MAX_LEN // PAGE
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_cfg(jcfg):
    """The same ArchConfig in the port's own dataclasses."""
    m = jcfg.moe
    return tbase.ArchConfig(**{
        **{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__},
        "moe": tbase.MoEConfig(**{f: getattr(m, f)
                                  for f in m.__dataclass_fields__})})


# --------------------------------------------------------------------------
# moe_block
# --------------------------------------------------------------------------
def _moe_pair(jcfg, x_shape, train):
    ctx = single_device_ctx()
    jp = jax_init_params(jmoe.moe_specs(jcfg, ctx), jax.random.PRNGKey(0),
                         "float32")
    x = np.random.default_rng(1).standard_normal(x_shape).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_block(p, x, jcfg, ctx,
                                                   train=train))(
        jp, jnp.asarray(x))
    tcfg = _port_cfg(jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), dtype=torch.float32,
                           device="cpu")
    ty, taux = tmoe.moe_block(tp, torch.from_numpy(x), tcfg, train=train)
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("E,k,shared", [(8, 2, 0), (16, 6, 2), (4, 1, 1)])
def test_moe_block_matches_jax(E, k, shared, train):
    (jy, jaux), (ty, taux) = _moe_pair(_cfg(E, k, shared), (2, 16, 32), train)
    assert _rel(_np(ty), jy) < 1e-5
    if train:
        assert abs(float(taux) - float(jaux)) < 1e-5 * float(jaux)
    else:
        assert taux is None


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_moe_block_capacity_drops_match_jax(train):
    """128 tokens over 8 experts with capacity factor 0.25 (train: 8 slots
    per expert) or the inference floor of 2 (64 slots): full experts drop
    tokens, the same tokens as JAX."""
    jcfg = _cfg(8, 2).replace(moe=MoEConfig(8, 2, 48, capacity_factor=0.25))
    (jy, _), (ty, _) = _moe_pair(jcfg, (2, 64, 32), train)
    assert tmoe._capacity(_port_cfg(jcfg), 128, train) == (8 if train else 64)
    assert _rel(_np(ty), jy) < 1e-5


def test_moe_capacity_matches_jax():
    jcfg = _cfg(64, 6).replace(moe=MoEConfig(64, 6, 48))
    tcfg = _port_cfg(jcfg)
    for t in (1, 8, 64, 65, 1024, 4096):
        for train in (True, False):
            assert (tmoe._capacity(tcfg, t, train)
                    == jmoe._capacity(jcfg, t, train))


# --------------------------------------------------------------------------
# deepseek-moe-16b at smoke size: prefill_ranged, decode, prefill_extend
# --------------------------------------------------------------------------
_MODELS = {}
_PREFILLED = {}


def _models(dtype):
    if dtype not in _MODELS:
        jcfg = smoke_config(get_arch("deepseek-moe-16b")).replace(dtype=dtype)
        tcfg = tbase.smoke_config(t_get_arch("deepseek-moe-16b")).replace(
            dtype=dtype)
        jm = build_model(jcfg, single_device_ctx())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = Model(tcfg)
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=tm.dtype, device="cpu", specs=tm.param_specs())
        _MODELS[dtype] = (jm, jp, tm, tp)
    return _MODELS[dtype]


def _batch(**arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _arena(node):
    """One stack's JAX prefill cache rows as a paged arena: row b's
    logical page j is physical page b*N_LOG + j; one clean spare page."""
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
    return arena(k), arena(v), arena(sp)


def _pair(arenas, dtype):
    """Fresh JAX and port paged views of the same per-stack arenas."""
    bt = np.arange(B * N_LOG, dtype=np.int32).reshape(B, N_LOG)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jc, tc = {}, {}
    for key, (k, v, sp) in arenas.items():
        jc[key] = JPaged(jnp.asarray(k, jd), jnp.asarray(v, jd),
                         jnp.asarray(sp), jnp.asarray(bt), jnp.int32(0))
        tc[key] = TPaged(torch.from_numpy(k.copy()).to(td),
                         torch.from_numpy(v.copy()).to(td),
                         torch.from_numpy(sp.copy()),
                         torch.from_numpy(bt.copy()), 0)
    return jc, tc


def _prefilled(dtype):
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
        arenas = {key: _arena(jcache[key]) for key in jcache}
        _PREFILLED[dtype] = (lengths, jlog, tlog, jcache, tcache, arenas)
    return _PREFILLED[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_ranged_matches_jax(dtype):
    _, jlog, tlog, jcache, tcache, _ = _prefilled(dtype)
    assert sorted(tcache) == sorted(jcache) == ["dense_layers", "moe_layers"]
    assert _rel(_np(tlog), jlog) < TOL[dtype]
    for key in jcache:
        assert _rel(_np(tcache[key].k), jcache[key].k) < TOL[dtype]
        assert np.array_equal(tcache[key].slot_pos.numpy(),
                              np.asarray(jcache[key].slot_pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_matches_jax(dtype):
    """One paged decode step at each row's next position, two stacks."""
    jm, jp, tm, tp = _models(dtype)
    lengths, *_, arenas = _prefilled(dtype)
    dtok = np.random.default_rng(1).integers(
        1, jm.cfg.vocab, (B, 1)).astype(np.int32)
    jb, tb = _batch(tokens=dtok, pos=lengths.copy())
    jc, tc = _pair(arenas, dtype)
    jlog, jn = jax.jit(jm.decode)(jp, jc, jb)
    tlog, tn = tm.decode(tp, tc, tb)
    assert _rel(_np(tlog), jlog) < TOL[dtype]
    for key in jn:
        assert _rel(_np(tn[key].k), jn[key].k) < TOL[dtype]
        assert np.array_equal(tn[key].slot_pos.numpy(),
                              np.asarray(jn[key].slot_pos))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_extend_matches_jax(dtype):
    """A ragged suffix extend behind each row's resident prefix, paged."""
    jm, jp, tm, tp = _models(dtype)
    lengths, *_, arenas = _prefilled(dtype)
    etok = np.random.default_rng(2).integers(
        1, jm.cfg.vocab, (B, 8)).astype(np.int32)
    jb, tb = _batch(tokens=etok, pos=lengths.copy(),
                    length=np.array([8, 5], np.int32))
    jc, tc = _pair(arenas, dtype)
    jlog, jn = jax.jit(jm.prefill_extend)(jp, jb, jc)
    tlog, tn = tm.prefill_extend(tp, tb, tc)
    assert _rel(_np(tlog), jlog) < TOL[dtype]
    for key in jn:
        assert _rel(_np(tn[key].v), jn[key].v) < TOL[dtype]


def test_moe_router_stays_float32_in_a_bf16_model():
    jm, jp, tm, tp = _models("bfloat16")
    assert tp["moe_layers"]["moe"]["router"].dtype == torch.float32
    assert tp["moe_layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert jp["moe_layers"]["moe"]["router"].dtype == jnp.float32
    init = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert init["moe_layers"]["moe"]["router"].dtype == torch.float32
    assert init["dense_layers"]["mlp"]["w_up"].shape[-1] == \
        tm.cfg.moe.dense_d_ff
