"""The port's plain kernel versions against the JAX oracles (CPU).

The same seeded numpy inputs go through the JAX oracle and the port's
plain PyTorch version, over the cases of ``tests/test_kernels.py``
(``FLASH_CASES``, ``DECODE_CASES``, the grouped GEMM's counts sweep) and
``tests/test_paged_kernels.py`` (``DECODE_CASES`` / ``EXTEND_CASES``), at
those tests' tolerances; the dense decode version also against the
rolling-window ``repro.models.layers.decode_attention_ref``.  On CPU
tensors the port's ``ops`` wrappers take the plain version and launch
nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_ref,
    lse_combine as jax_lse_combine,
    paged_decode_attention_ref,
)
from repro.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    paged_extend_attention_ref,
)
from repro.kernels.moe_gmm import gmm_ref  # noqa: E402
from repro.models.cache_utils import quantize_page as jax_quantize_page  # noqa: E402
from repro.models.layers import (  # noqa: E402
    decode_attention_ref as jax_layers_decode_ref,
)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as torch_decode_ref,
    paged_decode_attention_ref as torch_paged_decode_ref,
)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as torch_attention_ref,
    paged_extend_attention_ref as torch_paged_extend_ref,
)
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref as torch_gmm_ref  # noqa: E402
from repro_torch.models.cache_utils import (  # noqa: E402
    dequantize_page,
    quantize_page,
)

from test_kernels import DECODE_CASES as DENSE_DECODE_CASES  # noqa: E402
from test_kernels import FLASH_CASES  # noqa: E402
from test_paged_kernels import DECODE_CASES, EXTEND_CASES  # noqa: E402

# the JAX oracles, jitted so each case compiles once instead of per op
jax_attention_ref = jax.jit(attention_ref,
                            static_argnames=("causal", "window"))
jax_paged_decode_ref = jax.jit(paged_decode_attention_ref)
jax_paged_extend_ref = jax.jit(paged_extend_attention_ref)
jax_decode_ref = jax.jit(decode_attention_ref)
jax_layers_decode = jax.jit(jax_layers_decode_ref, static_argnames=("window",))
jax_gmm_ref = jax.jit(gmm_ref)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _arena(seed, B, Hkv, Dh, L, P, n_log, kv_lens, sentinel_rows=()):
    """Layout-consistent arena as ``test_paged_kernels._build_arena``
    builds it, from numpy: page j of row b holds positions
    [j*P, min((j+1)*P, kv_len)); the last physical page stays clean."""
    rng = np.random.default_rng(seed)
    N = B * n_log + 2
    k = rng.standard_normal((N, P, L, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((N, P, L, Hkv, Dh)).astype(np.float32)
    sp = np.full((N, P, L), -1, np.int32)
    bt = np.full((B, n_log), N, np.int32)
    nxt = 0
    for b, kl in enumerate(kv_lens):
        if b in sentinel_rows:
            continue
        for j in range(-(-kl // P)):
            fill = min(P, kl - j * P)
            sp[nxt, :fill, :] = (j * P + np.arange(fill))[:, None]
            bt[b, j] = nxt
            nxt += 1
    return k, v, sp, bt


def _quantized(k, v):
    """Int8 pages + per-(page, layer) scales, quantized once by JAX and
    handed to both sides."""
    kq, ks = jax_quantize_page(jnp.asarray(k), keep_axes=(0, 2))
    vq, vs = jax_quantize_page(jnp.asarray(v), keep_axes=(0, 2))
    return [np.asarray(x) for x in (kq, ks, vq, vs)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_attention_ref_matches_jax(case):
    B, Hq, Hkv, Sq, Skv, Dh, causal, win, dt = case
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Hq, Sq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, Dh)).astype(np.float32)
    tdt = torch.bfloat16 if dt == jnp.bfloat16 else torch.float32
    ref = jax_attention_ref(*(jnp.asarray(x, dt) for x in (q, k, v)),
                            causal=causal, window=win)
    out = torch_attention_ref(*(_t(x, tdt) for x in (q, k, v)),
                              causal=causal, window=win)
    tol = 2e-2 if dt == jnp.bfloat16 else 2e-5
    assert out.dtype == tdt
    assert _rel(_np(out), _np(ref)) < tol, case


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("B,Hq,Hkv,Dh,L,P,n_log,kv_lens", DECODE_CASES)
def test_paged_decode_ref_matches_jax(B, Hq, Hkv, Dh, L, P, n_log, kv_lens,
                                      quant):
    k, v, sp, bt = _arena(1, B, Hkv, Dh, L, P, n_log, kv_lens)
    q = np.random.default_rng(2).standard_normal((B, Hq, Dh)).astype(
        np.float32)
    kl = np.asarray(kv_lens, np.int32)
    sc = {}
    if quant:
        k, ks, v, vs = _quantized(k, v)
        sc = {"k_scale": ks, "v_scale": vs}
    ref = jax_paged_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sp),
        jnp.asarray(bt), jnp.asarray(kl), jnp.int32(L - 1),
        **{n: jnp.asarray(s) for n, s in sc.items()})
    out = torch_paged_decode_ref(
        _t(q), _t(k), _t(v), _t(sp), _t(bt), _t(kl), L - 1,
        **{n: _t(s) for n, s in sc.items()})
    assert _rel(_np(out), _np(ref)) < (2e-4 if quant else 2e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("B,Hq,Hkv,Dh,L,P,n_log,S,pos", EXTEND_CASES)
def test_paged_extend_ref_matches_jax(B, Hq, Hkv, Dh, L, P, n_log, S, pos,
                                      quant):
    k, v, sp, bt = _arena(3, B, Hkv, Dh, L, P, n_log,
                          tuple(p + S for p in pos))
    q = np.random.default_rng(4).standard_normal((B, Hq, S, Dh)).astype(
        np.float32)
    ps = np.asarray(pos, np.int32)
    sc = {}
    if quant:
        k, ks, v, vs = _quantized(k, v)
        sc = {"k_scale": ks, "v_scale": vs}
    ref = jax_paged_extend_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sp),
        jnp.asarray(bt), jnp.asarray(ps), jnp.int32(L - 1),
        **{n: jnp.asarray(s) for n, s in sc.items()})
    out = torch_paged_extend_ref(
        _t(q), _t(k), _t(v), _t(sp), _t(bt), _t(ps), L - 1,
        **{n: _t(s) for n, s in sc.items()})
    assert _rel(_np(out), _np(ref)) < (2e-4 if quant else 2e-5)


def test_fully_sentinel_row_is_finite():
    """A row mapping no page (freed or width-trimmed slot, power-of-two
    extend padding) must still come out finite, and the other rows agree
    with JAX."""
    k, v, sp, bt = _arena(5, 2, 2, 16, 1, 8, 2, (16, 16), sentinel_rows=(1,))
    q = np.random.default_rng(6).standard_normal((2, 2, 16)).astype(
        np.float32)
    kl = np.asarray([16, 1], np.int32)
    out = torch_paged_decode_ref(_t(q), _t(k), _t(v), _t(sp), _t(bt),
                                 _t(kl), 0)
    ref = jax_paged_decode_ref(*(jnp.asarray(x) for x in (q, k, v, sp, bt,
                                                          kl)), jnp.int32(0))
    assert torch.isfinite(out).all()
    assert _rel(_np(out[0]), _np(ref[0])) < 2e-5


def test_ops_on_cpu_take_the_plain_version():
    """CPU tensors go to the plain versions: same outputs, no launch."""
    before = (fops.flash_attention.launches,
              fops.paged_extend_attention.launches,
              dops.paged_decode_attention.launches)
    rng = np.random.default_rng(7)
    q = _t(rng.standard_normal((2, 24, 4, 16)).astype(np.float32))
    kv = _t(rng.standard_normal((2, 24, 2, 16)).astype(np.float32))
    out = fops.flash_attention(q, kv, kv, causal=True)
    ref = torch_attention_ref(q.transpose(1, 2), kv.transpose(1, 2),
                        kv.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(out, ref)
    k, v, sp, bt = (_t(x) for x in _arena(8, 2, 2, 16, 2, 8, 4, (20, 9)))
    pos = torch.tensor([12, 1], dtype=torch.int32)
    qe = _t(rng.standard_normal((2, 8, 4, 16)).astype(np.float32))
    out = fops.paged_extend_attention(qe, k, v, sp, bt, pos, 1)
    ref = torch_paged_extend_ref(qe.transpose(1, 2), k, v, sp, bt, pos,
                                     1).transpose(1, 2)
    assert torch.equal(out, ref)
    qd = qe[:, :1]
    kl = torch.tensor([20, 9], dtype=torch.int32)
    out = dops.paged_decode_attention(qd, k, v, sp, bt, kl, 1)
    ref = torch_paged_decode_ref(qd[:, 0], k, v, sp, bt, kl, 1)[:, None]
    assert torch.equal(out, ref)
    after = (fops.flash_attention.launches,
             fops.paged_extend_attention.launches,
             dops.paged_decode_attention.launches)
    assert after == before == (0, 0, 0)
    n_new = (dops.decode_attention.launches, gops.gmm.launches)
    kc = _t(rng.standard_normal((2, 12, 2, 16)).astype(np.float32))
    out = dops.decode_attention(qd, kc, kc, kl.clamp(max=12))
    ref = torch_decode_ref(qd[:, 0], kc, kc, kl.clamp(max=12))[:, None]
    assert torch.equal(out, ref)
    x = _t(rng.standard_normal((3, 5, 16)).astype(np.float32))
    w = _t(rng.standard_normal((3, 16, 7)).astype(np.float32))
    c = torch.tensor([5, 0, 2], dtype=torch.int32)
    assert torch.equal(gops.gmm(x, w, c), torch_gmm_ref(x, w, c))
    assert (dops.decode_attention.launches, gops.gmm.launches) == n_new \
        == (0, 0)


def test_lse_combine_matches_jax():
    rng = np.random.default_rng(9)
    ms = rng.standard_normal((4, 3, 5)).astype(np.float32)
    ls = rng.uniform(0.5, 2.0, (4, 3, 5)).astype(np.float32)
    accs = rng.standard_normal((4, 3, 5, 8)).astype(np.float32)
    ref = jax_lse_combine(jnp.asarray(ms), jnp.asarray(ls), jnp.asarray(accs))
    out = dops.lse_combine(_t(ms), _t(ls), _t(accs))
    assert _rel(_np(out), _np(ref)) < 1e-6


def test_quantize_page_matches_jax():
    x = np.random.default_rng(10).standard_normal((6, 8, 3, 2, 16)).astype(
        np.float32)
    x[2] = 0.0                                   # an all-zero page
    kq, ks = quantize_page(_t(x), keep_axes=(0, 2))
    jq, js = jax_quantize_page(jnp.asarray(x), keep_axes=(0, 2))
    assert kq.dtype == torch.int8 and ks.shape == (6, 3)
    assert np.array_equal(kq.numpy(), np.asarray(jq))
    assert np.allclose(ks.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    deq = dequantize_page(kq, ks, keep_axes=(0, 2))
    assert bool((deq[2] == 0).all())


@pytest.mark.parametrize("case", DENSE_DECODE_CASES)
def test_dense_decode_ref_matches_jax(case):
    B, Hq, Hkv, S, Dh, dt = case
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    kl = ((np.arange(B) * 37 + S // 3) % S + 1).astype(np.int32)
    tdt = torch.bfloat16 if dt == jnp.bfloat16 else torch.float32
    ref = jax_decode_ref(*(jnp.asarray(x, dt) for x in (q, k, v)),
                         jnp.asarray(kl))
    out = torch_decode_ref(*(_t(x, tdt) for x in (q, k, v)), _t(kl))
    assert out.dtype == tdt
    assert _rel(_np(out), _np(ref)) < (2e-2 if dt == jnp.bfloat16 else 2e-5)


@pytest.mark.parametrize("window", [None, 20])
def test_dense_decode_ref_rolling_matches_jax_layers(window):
    """A rolling buffer of 24 slots holding the last 24 positions at
    ``pos % 24``, an empty slot, and a window: the masks of JAX's
    ``layers.decode_attention_ref``."""
    B, Hq, Hkv, S, Dh = 3, 4, 2, 24, 16
    rng = np.random.default_rng(12)
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    kl = np.array([61, 24, 9], np.int32)
    sp = np.full((B, S), -1, np.int32)
    for b, n in enumerate(kl):
        p = np.arange(max(n - S, 0), n)
        sp[b, p % S] = p
    sp[1, 3] = -1
    ref = jax_layers_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(kl), window=window,
                            slot_pos=jnp.asarray(sp))
    out = torch_decode_ref(_t(q[:, 0]), _t(k), _t(v), _t(kl),
                           slot_pos=_t(sp), window=window)
    assert _rel(_np(out), _np(ref)[:, 0]) < 2e-5


@pytest.mark.parametrize("dt", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("E,C,D,F,counts", [
    (8, 256, 128, 256, [0, 5, 128, 256, 129, 200, 1, 64]),
    (8, 256, 128, 256, [0] * 8),
    (8, 256, 128, 256, [256] * 8),
    (4, 12, 64, 40, [12, 0, 7, 1]),          # C, F off any tile size
])
def test_gmm_ref_matches_jax(E, C, D, F, counts, dt):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) * 0.05).astype(np.float32)
    c = np.asarray(counts, np.int32)
    tdt = torch.bfloat16 if dt == jnp.bfloat16 else torch.float32
    ref = jax_gmm_ref(jnp.asarray(x, dt), jnp.asarray(w, dt), jnp.asarray(c))
    out = torch_gmm_ref(_t(x, tdt), _t(w, tdt), _t(c))
    assert out.dtype == tdt
    assert _rel(_np(out), _np(ref)) < (2e-2 if dt == jnp.bfloat16 else 1e-5)
    for e, n in enumerate(counts):
        assert not out[e, n:].any()
