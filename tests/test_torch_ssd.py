"""The port's SSD scan and Mamba-2 / Zamba2 blocks against JAX (CPU).

* ``kernels/ssd_scan``: the plain ``ssd_chunk_ref`` against JAX's, and
  ``ops.ssd`` (the plain chunk version on the CPU) against JAX's
  ``ops.ssd`` (the Pallas kernel in interpret mode, as
  ``tests/test_kernels.py`` runs it) and against ``ssd_chunked``: chunk
  lengths 16/32/64 with G 2, an initial state, a ragged pad mask with the
  truncated-row check, and the chunk checkpoints; ``ssd_scan_ref``, the
  CUDA scan's order of work (16-step sub-chunks, the running state carried
  between them), against the same at chunk lengths 1, 16 and 128;
* ``models/mamba2``: ``_causal_conv`` (``length``, ``boundary_every``),
  ``ssd_decode_step``, the softplus, and ``mamba_block`` in prefill (with
  checkpoints), extend and decode;
* ``models/zamba2``: ``shared_block`` in prefill and decode;
* the ``alog`` and ``dt_bias`` initialisers.

Inputs come from a numpy seed; weights from the JAX initialiser through
the weight bridge.  Tolerances: rel < 1e-5 in float32 (summation order),
2e-2 in bfloat16 (the tolerance of ``tests/test_kernels.py``: bf16 rounds
at other places in the two frameworks).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jax_chunk_ref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import zamba2 as jz2  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import zamba2 as tz2  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    PSpec,
    init_params,
    params_from_numpy,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.array(a, np.float32), dtype)


def _ssd_inputs(Bb, S, H, P, G, N, seed, init=False):
    """x, dt, A_log, B, C (and an initial state) as numpy float32, drawn
    as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    n = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    out = [n(Bb, S, H, P),
           np.log1p(np.exp(n(Bb, S, H) * 0.5)).astype(np.float32),
           rng.uniform(0.0, 1.5, H).astype(np.float32),
           n(Bb, S, G, N) * 0.3, n(Bb, S, G, N) * 0.3]
    if init:
        out.append(n(Bb, H, P, N) * 0.2)
    return out


def _chunk_views(x, dt, A_log, B, C, Q):
    """The per-chunk inputs, as both wrappers form them, in numpy."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2:]
    nc = S // Q
    dA = dt * -np.exp(A_log)
    xw = x * dt[..., None]
    return (xw.reshape(Bb, nc, Q, H, P).transpose(0, 3, 1, 2, 4),
            dA.reshape(Bb, nc, Q, H).transpose(0, 3, 1, 2),
            B.reshape(Bb, nc, Q, G, N).transpose(0, 3, 1, 2, 4),
            C.reshape(Bb, nc, Q, G, N).transpose(0, 3, 1, 2, 4))


# --------------------------------------------------------------------------
# the SSD scan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunk_ref_matches_jax(chunk):
    views = _chunk_views(*_ssd_inputs(2, 128, 4, 16, 2, 32, seed=4), chunk)
    ours = ssd_chunk_ref(*(_t(v) for v in views))
    theirs = jax_chunk_ref(*(_j(v) for v in views))
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        assert _rel(_np(a), b) < 1e-5


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_matches_jax_kernel_and_oracle(chunk):
    """G 2: ``ops.ssd`` against JAX's ``ops.ssd`` (Pallas, interpret
    mode) and ``ssd_chunked``, and the port's ``ssd_chunked`` too."""
    inp = _ssd_inputs(2, 128, 4, 16, 2, 32, seed=4)
    y, h = sops.ssd(*(_t(a) for a in inp), chunk=chunk)
    y_k, h_k = jax_ssd(*(_j(a) for a in inp), chunk=chunk)
    y_r, h_r = jm2.ssd_chunked(*(_j(a) for a in inp), chunk=chunk)
    y_o, h_o = tm2.ssd_chunked(*(_t(a) for a in inp), chunk=chunk)
    for ours in ((y, h), (y_o, h_o)):
        assert _rel(_np(ours[0]), y_k) < 1e-5 and _rel(_np(ours[1]), h_k) < 1e-5
        assert _rel(_np(ours[0]), y_r) < 1e-5 and _rel(_np(ours[1]), h_r) < 1e-5


def test_ssd_initial_state_matches_jax():
    *inp, init = _ssd_inputs(1, 64, 2, 8, 1, 16, seed=5, init=True)
    y, h = sops.ssd(*(_t(a) for a in inp), chunk=16, initial_state=_t(init))
    y_k, h_k = jax_ssd(*(_j(a) for a in inp), chunk=16,
                       initial_state=_j(init))
    y_r, _ = jm2.ssd_chunked(*(_j(a) for a in inp), chunk=16,
                             initial_state=_j(init))
    assert _rel(_np(y), y_k) < 1e-5 and _rel(_np(h), h_k) < 1e-5
    assert _rel(_np(y), y_r) < 1e-5


def test_ssd_pad_mask_exact():
    """A ragged validity mask: the port agrees with JAX's kernel and
    oracle, and each row's final state equals the state of the row run
    alone at its true length (pads make no state update)."""
    inp = _ssd_inputs(3, 64, 2, 8, 1, 16, seed=6)
    lengths = np.array([64, 17, 1])
    mask = np.arange(64)[None, :] < lengths[:, None]
    y, h = sops.ssd(*(_t(a) for a in inp), chunk=16,
                    mask=torch.from_numpy(mask))
    y_k, h_k = jax_ssd(*(_j(a) for a in inp), chunk=16,
                       mask=jnp.asarray(mask))
    _, h_r = jm2.ssd_chunked(*(_j(a) for a in inp), chunk=16,
                             mask=jnp.asarray(mask))
    assert _rel(_np(h), h_k) < 1e-5 and _rel(_np(h), h_r) < 1e-5
    x, dt, A_log, B, C = inp
    for b, L in enumerate(lengths):
        with warnings.catch_warnings():   # L % 16: the chunk degrades
            warnings.simplefilter("ignore")
            _, h_t = tm2.ssd_chunked(_t(x[b:b + 1, :L]), _t(dt[b:b + 1, :L]),
                                     _t(A_log), _t(B[b:b + 1, :L]),
                                     _t(C[b:b + 1, :L]), chunk=16)
        assert _rel(_np(h[b:b + 1]), _np(h_t)) < 1e-5, (b, L)
        assert _rel(_np(y[b, :L]), y_k[b, :L]) < 1e-5, (b, L)


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_checkpoints_match_jax(chunk):
    """``checkpoints=True``: the state after every chunk, (B, nc, H, P,
    N), as JAX's ``ssd_chunked(checkpoints=True)`` gives it (``ops.ssd``
    of JAX has none), under an initial state and a mask."""
    *inp, init = _ssd_inputs(2, 64, 4, 8, 2, 16, seed=7, init=True)
    mask = np.arange(64)[None, :] < np.array([64, 37])[:, None]
    kw_t = dict(chunk=chunk, initial_state=_t(init),
                mask=torch.from_numpy(mask), checkpoints=True)
    kw_j = dict(chunk=chunk, initial_state=_j(init), mask=jnp.asarray(mask),
                checkpoints=True)
    y, h, ck = sops.ssd(*(_t(a) for a in inp), **kw_t)
    _, _, ck_o = tm2.ssd_chunked(*(_t(a) for a in inp), **kw_t)
    y_r, h_r, ck_r = jm2.ssd_chunked(*(_j(a) for a in inp), **kw_j)
    assert tuple(ck.shape) == ck_r.shape == (2, 64 // chunk, 4, 8, 16)
    assert _rel(_np(ck), ck_r) < 1e-5 and _rel(_np(ck_o), ck_r) < 1e-5
    assert _rel(_np(h), h_r) < 1e-5
    assert np.array_equal(_np(ck[:, -1]), _np(h))


def test_ssd_fully_masked_row_keeps_its_state_bit_for_bit():
    """A row with no real step (a row riding along a snapshot restore):
    its final state and every checkpoint are the initial state, exactly."""
    *inp, init = _ssd_inputs(2, 32, 4, 8, 1, 16, seed=8, init=True)
    mask = torch.tensor([[True] * 32, [False] * 32])
    y, h, ck = sops.ssd(*(_t(a) for a in inp), chunk=8,
                        initial_state=_t(init), mask=mask, checkpoints=True)
    assert torch.equal(h[1], _t(init[1]))
    assert all(torch.equal(ck[1, c], _t(init[1])) for c in range(4))
    yc, states, decay = ssd_chunk_ref(*(_t(v) for v in _chunk_views(
        np.zeros_like(inp[0]), np.zeros_like(inp[1]), *inp[2:], 8)))
    assert torch.equal(decay, torch.ones_like(decay))
    assert not states.any() and not yc.any()


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("Q", [1, 16, 128])
def test_ssd_scan_order_matches_jax(Q, G):
    """``ssd_scan_ref`` (the CUDA scan's order of work) under an initial
    state and a ragged mask (a full row, a ragged row, a row with no real
    step): y and the final state against JAX's ``ops.ssd`` (Pallas,
    interpret mode), the checkpoints against JAX's ``ssd_chunked``, all
    within 2e-5; the row with no real step keeps its state bit for bit."""
    S = 32 if Q == 1 else 128
    *inp, init = _ssd_inputs(3, S, 4, 8, G, 16, seed=17 + Q + G, init=True)
    lengths = np.array([S, S // 2 + 3, 0])
    mask = np.arange(S)[None, :] < lengths[:, None]
    kw_t = dict(chunk=Q, initial_state=_t(init), mask=torch.from_numpy(mask))
    kw_j = dict(chunk=Q, initial_state=_j(init), mask=jnp.asarray(mask))
    y, h = ssd_scan_ref(*(_t(a) for a in inp), **kw_t)
    y_c, h_c, ck = ssd_scan_ref(*(_t(a) for a in inp), checkpoints=True,
                                **kw_t)
    y_k, h_k = jax_ssd(*(_j(a) for a in inp), **kw_j)
    y_r, h_r, ck_r = jm2.ssd_chunked(*(_j(a) for a in inp), checkpoints=True,
                                     **kw_j)
    assert _rel(_np(y), y_k) < 2e-5 and _rel(_np(h), h_k) < 2e-5
    assert _rel(_np(y_c), y_r) < 2e-5 and _rel(_np(h_c), h_r) < 2e-5
    assert tuple(ck.shape) == ck_r.shape == (3, S // Q, 4, 8, 16)
    assert _rel(_np(ck), ck_r) < 2e-5
    assert torch.equal(h[2], _t(init[2])) and torch.equal(h_c[2], _t(init[2]))
    assert all(torch.equal(ck[2, c], _t(init[2])) for c in range(S // Q))


def test_ssd_tiling_chunk_degrades_with_a_warning():
    assert sops.ssd_tiling_chunk(128, 256) == 128
    with pytest.warns(UserWarning, match="degrading to chunk 32"):
        assert sops.ssd_tiling_chunk(96, 64) == 32
    with pytest.warns(UserWarning, match="degrading to chunk 1"):
        assert tm2.ssd_tiling_chunk(17, 16) == 1


def test_ssd_decode_step_matches_jax():
    Bb, H, P, G, N = 3, 4, 8, 2, 16
    x, dt, _, B, C, st = _ssd_inputs(Bb, 1, H, P, G, N, seed=9, init=True)
    A_log = np.random.default_rng(1).uniform(0, 1.5, H).astype(np.float32)
    y, new = tm2.ssd_decode_step(_t(st), _t(x), _t(dt), _t(A_log), _t(B),
                                 _t(C))
    y_j, new_j = jm2.ssd_decode_step(_j(st), _j(x), _j(dt), _j(A_log),
                                     _j(B), _j(C))
    assert _rel(_np(y), y_j) < 1e-5 and _rel(_np(new), new_j) < 1e-5


def test_softplus_matches_jax_beyond_torch_threshold():
    v = np.linspace(-40, 60, 2001).astype(np.float32)
    assert _rel(_np(tm2.softplus(_t(v))), jax.nn.softplus(_j(v))) < 1e-6


# --------------------------------------------------------------------------
# the Mamba-2 block, the causal conv, the shared block
# --------------------------------------------------------------------------
def _cfgs(arch, dtype):
    return (smoke_config(get_arch(arch)).replace(dtype=dtype),
            t_smoke_config(t_get_arch(arch)).replace(dtype=dtype))


def _block_weights(jspecs, tspecs, dtype, seed):
    jp = jax_init_params(jspecs, jax.random.PRNGKey(seed), dtype)
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp),
                           dtype=getattr(torch, dtype), device="cpu",
                           specs=tspecs)
    return jp, tp


@pytest.mark.parametrize("length", [None, "ragged"])
def test_causal_conv_matches_jax(length):
    rng = np.random.default_rng(10)
    Bb, S, C, K = 3, 32, 24, 4
    seq = rng.standard_normal((Bb, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    st = rng.standard_normal((Bb, K - 1, C)).astype(np.float32)
    ln = None if length is None else np.array([32, 5, 0], np.int32)
    y, new, bst = tm2._causal_conv(
        _t(seq), _t(w), _t(st),
        length=None if ln is None else torch.from_numpy(ln),
        boundary_every=8)
    y_j, new_j, bst_j = jm2._causal_conv(
        _j(seq), _j(w), _j(st),
        length=None if ln is None else jnp.asarray(ln), boundary_every=8)
    assert _rel(_np(y), y_j) < 1e-6
    assert np.array_equal(_np(new), np.asarray(new_j))
    assert np.array_equal(_np(bst), np.asarray(bst_j))
    if ln is not None:          # a length-0 row keeps its seeded state
        assert np.array_equal(_np(new[2]), st[2])


MAMBA_MODES = ["prefill", "prefill-ckpt", "extend", "decode"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MAMBA_MODES)
def test_mamba_block_matches_jax(mode, dtype):
    """``mamba_block`` (the port through ``ops.ssd``; JAX through
    ``ssd_chunked``) on bucket-padded rows, from a seeded state where the
    mode reads one."""
    jc, tc = _cfgs("mamba2-2.7b", dtype)
    jp, tp = _block_weights(jm2.mamba_specs(jc), tm2.mamba_specs(tc), dtype,
                            seed=11)
    d_inner, H, G, N, K = jm2.mamba_dims(jc)
    Bb, S = 3, (1 if mode == "decode" else 32)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((Bb, S, jc.d_model)).astype(np.float32)
    conv = rng.standard_normal((Bb, K - 1, d_inner + 2 * G * N)).astype(
        np.float32)
    ssm = (rng.standard_normal((Bb, H, jc.ssm.head_dim, N)) * 0.3).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jstate = jm2.MambaState(conv=_j(conv, jdt), ssm=_j(ssm))
    tstate = tm2.MambaState(conv=_t(conv, tdt), ssm=_t(ssm))
    kw_j, kw_t = {}, {}
    if mode != "decode":
        lengths = np.array([32, 19, 0 if mode == "extend" else 7])
        mask = np.arange(S)[None, :] < lengths[:, None]
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if mode == "prefill-ckpt":
        kw_j["ckpt_every"] = kw_t["ckpt_every"] = 8
    m = "prefill" if mode.startswith("prefill") else mode
    with_state = mode in ("extend", "decode")
    y_j, s_j = jm2.mamba_block(jp, _j(x, jdt), jc, mode=m,
                               state=jstate if with_state else None, **kw_j)
    y_t, s_t = tm2.mamba_block(tp, _t(x, tdt), tc, mode=m,
                               state=tstate if with_state else None, **kw_t)
    tol = TOL[dtype]
    assert y_t.dtype == tdt and _rel(_np(y_t), y_j) < tol
    pairs = [(s_t, s_j)] if mode != "prefill-ckpt" else list(zip(s_t, s_j))
    for st_t, st_j in pairs:
        assert _rel(_np(st_t.ssm), st_j.ssm) < tol
        assert _rel(_np(st_t.conv), st_j.conv) < tol
    if mode == "extend":        # the length-0 row: state untouched
        assert torch.equal(s_t.ssm[2], tstate.ssm[2])
        assert torch.equal(s_t.conv[2], tstate.conv[2])


def test_mamba_block_dt_matches_jax():
    """The softplus of ``dt_raw + dt_bias`` over the block's real inputs,
    large arguments included."""
    jc, tc = _cfgs("mamba2-2.7b", "float32")
    jp, tp = _block_weights(jm2.mamba_specs(jc), tm2.mamba_specs(tc),
                            "float32", seed=13)
    x = np.random.default_rng(14).standard_normal((2, 8, jc.d_model)) * 30
    raw = x.astype(np.float32) @ np.asarray(jp["wdt"]) + np.asarray(
        jp["dt_bias"])
    assert raw.max() > 20          # where torch's F.softplus turns linear
    assert _rel(_np(tm2.softplus(_t(raw))), jax.nn.softplus(_j(raw))) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_shared_block_matches_jax(mode, dtype):
    """Zamba2's shared block: ``concat(x, x0)`` through attention and MLP
    into the residual, with its own KV cache."""
    jc, tc = _cfgs("zamba2-2.7b", dtype)
    jp, tp = _block_weights(jz2.shared_block_specs(jc),
                            tz2.shared_block_specs(tc), dtype, seed=15)
    Bb, S_c = 2, 32
    S = 16 if mode == "prefill" else 1
    rng = np.random.default_rng(16)
    x, x0 = (rng.standard_normal((Bb, S, jc.d_model)).astype(np.float32)
             for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    hkv, dh = jc.num_kv_heads, jc.resolved_head_dim
    k = rng.standard_normal((Bb, S_c, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((Bb, S_c, hkv, dh)).astype(np.float32)
    pos = np.array([9, 20], np.int32)
    sp = np.where(np.arange(S_c)[None] < pos[:, None], np.arange(S_c)[None],
                  -1).astype(np.int32)
    jcache = jl.KVSlice(_j(k, jdt), _j(v, jdt), jnp.asarray(sp))
    tcache = tl.KVSlice(_t(k, tdt), _t(v, tdt), torch.from_numpy(sp))
    kw_j = dict(mode=mode, cache=jcache)
    kw_t = dict(mode=mode, cache=tcache)
    if mode == "decode":
        kw_j["pos"], kw_t["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    y_j, c_j = jz2.shared_block(jp, _j(x, jdt), _j(x0, jdt), jc, None, **kw_j)
    y_t, c_t = tz2.shared_block(tp, _t(x, tdt), _t(x0, tdt), tc, **kw_t)
    tol = TOL[dtype]
    assert _rel(_np(y_t), y_j) < tol
    assert _rel(_np(c_t.k), c_j.k) < tol and _rel(_np(c_t.v), c_j.v) < tol
    assert np.array_equal(c_t.slot_pos.numpy(), np.asarray(c_j.slot_pos))


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------
def test_alog_and_dt_bias_initialisers():
    """``alog``: A = exp(A_log) ~ U[1, 16); ``dt_bias``: softplus(dt_bias)
    ~ LogU[1e-3, 1e-1]; both float32 whatever the model dtype, drawn from
    the generator (two seeds differ, one seed repeats)."""
    specs = {"a": PSpec((4096,), (None,), ("alog",), dtype="float32"),
             "d": PSpec((4096,), (None,), ("dt_bias",), dtype="float32")}
    p = init_params(specs, torch.Generator().manual_seed(0), "bfloat16",
                    "cpu")
    q = init_params(specs, torch.Generator().manual_seed(0), "bfloat16",
                    "cpu")
    r = init_params(specs, torch.Generator().manual_seed(1), "bfloat16",
                    "cpu")
    assert p["a"].dtype == p["d"].dtype == torch.float32
    assert torch.equal(p["a"], q["a"]) and not torch.equal(p["a"], r["a"])
    A = torch.exp(p["a"])
    assert 1.0 <= A.min() and A.max() < 16.0 and 7.0 < A.mean() < 9.5
    dt = tm2.softplus(p["d"])
    assert 1e-3 * 0.999 <= dt.min() and dt.max() <= 1e-1 * 1.001
    assert abs(float(torch.log(dt).mean()) - np.log(1e-2)) < 0.1


def test_init_mamba_state_matches_jax():
    jc, tc = _cfgs("zamba2-2.7b", "bfloat16")
    j = jm2.init_mamba_state(jc, 3, jnp.bfloat16)
    t = tm2.init_mamba_state(tc, 3, torch.bfloat16)
    for a, b in zip(t, j):
        assert tuple(a.shape) == b.shape and not a.any()
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_model_init_pins_the_ssm_leaves_to_float32(arch):
    model = Model(t_smoke_config(t_get_arch(arch)))
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    mam = (p["mamba_layers"]["mamba"] if arch == "mamba2-2.7b"
           else p["groups"]["mamba"])
    for leaf in ("dt_bias", "A_log", "D_skip"):
        assert mam[leaf].dtype == torch.float32, leaf
    assert mam["wz"].dtype == torch.bfloat16
    assert torch.equal(mam["D_skip"], torch.ones_like(mam["D_skip"]))
