"""The gradient of flash attention (CPU, float32): the port's plain
backward against ``jax.vjp`` of the JAX oracles.

``flash_attention_bwd_ref`` (dq, dk, dv written out from q, k, v, out,
dout and the forward's LSE) is held against ``jax.vjp`` of
``repro.kernels.flash_attention.ref.attention_ref`` (causal, windowed,
GQA 4, Sq below Skv with q positions aligned to the end of the keys) and
of ``repro.models.layers.chunked_attention`` (bidirectional under a
key-length mask, a row with no valid key among them, and cross-attention
with Sq above and below Skv), to 1e-5 relative.  The LSE of
``attention_ref(return_lse=True)`` is held to ``jax.nn.logsumexp`` of the
oracle's scores; ``ops.flash_attention``'s autograd Function runs both on
a CPU tensor, and ``attention_block(mode="train")``'s gradients match
JAX's (whose train mode runs ``chunked_attention``).

The card's bf16 backward (``csrc/flash_attention_bwd.cu``, the
tensor-core route) rounds P and dS to bf16 before the products that take
them.  A plain emulation of that arithmetic stays within the card check's
2e-2 of ``flash_attention_bwd_ref`` under every mask, so the tolerance
fits the design before any card run.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    _scores,
    attention_ref,
    flash_attention_bwd_ref,
)
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402

TOL = 1e-5

# (B, Sq, Skv, Hq, Hkv, Dh, causal, window, kv_len): oracle attention_ref
REF_CASES = {
    "causal": (2, 24, 24, 4, 4, 16, True, None, None),
    "window": (2, 40, 40, 4, 2, 16, True, 7, None),
    "gqa4": (1, 32, 32, 8, 2, 32, True, None, None),
    "suffix_q": (2, 12, 30, 4, 2, 16, True, None, None),
    "bidir": (2, 20, 20, 4, 1, 16, False, None, None),
}
# chunked_attention oracle: bidirectional under kv_len (0 = no valid key)
MASK_CASES = {
    "bidir_kv_len": (2, 20, 20, 4, 2, 16, (13, 20)),
    "bidir_kv_len_empty_row": (2, 16, 16, 4, 4, 16, (0, 9)),
    "cross_short_q": (2, 10, 28, 4, 2, 16, (19, 28)),
    "cross_long_q": (2, 30, 12, 4, 4, 16, (5, 12)),
}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _draw(B, Sq, Skv, Hq, Hkv, Dh, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, Sq, Hq, Dh), f(B, Skv, Hkv, Dh), f(B, Skv, Hkv, Dh), \
        f(B, Sq, Hq, Dh)


def _port_grads(q, k, v, do, **mask):
    """(out, lse, dq, dk, dv) of the port's plain versions, (B, S, H, Dh)."""
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v, do)]
    out, lse = attention_ref(*t[:3], return_lse=True, **mask)
    g = flash_attention_bwd_ref(*t[:3], out, t[3], lse, **mask)
    return (out.transpose(1, 2).numpy(), lse.numpy(),
            *(x.transpose(1, 2).numpy() for x in g))


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_backward_ref_matches_jax_vjp_of_attention_ref(case):
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, _ = REF_CASES[case]
    q, k, v, do = _draw(B, Sq, Skv, Hq, Hkv, Dh)

    def f(q, k, v):
        return j_attention_ref(q, k, v, causal=causal, window=window)
    jt = [jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v, do)]
    jout, vjp = jax.vjp(f, *jt[:3])
    jg = vjp(jt[3])
    out, lse, *tg = _port_grads(q, k, v, do, causal=causal, window=window)
    assert _rel(out, np.asarray(jout).transpose(0, 2, 1, 3)) < TOL
    for name, a, b in zip("qkv", tg, jg):
        assert _rel(a, np.asarray(b).transpose(0, 2, 1, 3)) < TOL, name
    # the LSE is logsumexp of the oracle's masked scores
    G = Hq // Hkv
    s = jnp.einsum("bhqd,bhkd->bhqk", jt[0], jnp.repeat(jt[1], G, axis=1))
    s = s / math.sqrt(Dh)
    qp = jnp.arange(Sq)[:, None] + (Skv - Sq)
    kp = jnp.arange(Skv)[None, :]
    m = jnp.ones((Sq, Skv), bool)
    if causal:
        m &= qp >= kp
    if window is not None:
        m &= kp > qp - window
    jl = jax.nn.logsumexp(jnp.where(m, s, -1e30), axis=-1)
    assert _rel(lse, jl) < TOL


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_backward_ref_matches_jax_vjp_under_a_key_length_mask(case):
    B, Sq, Skv, Hq, Hkv, Dh, kv_len = MASK_CASES[case]
    q, k, v, do = _draw(B, Sq, Skv, Hq, Hkv, Dh, seed=1)
    jl = jnp.asarray(kv_len, jnp.int32)

    def f(q, k, v):
        return j_layers.chunked_attention(q, k, v, causal=False, kv_len=jl)
    jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    out, _, *tg = _port_grads(q, k, v, do, causal=False,
                              kv_len=torch.tensor(kv_len))
    assert _rel(out, jout) < TOL
    for name, a, b in zip("qkv", tg, jg):
        assert _rel(a, b) < TOL, name


@pytest.mark.parametrize("case", ["window", "suffix_q", "gqa4"])
def test_autograd_function_on_cpu_is_the_written_out_backward(case):
    """``ops.flash_attention`` under autograd: the forward saves its LSE
    and the backward is ``flash_attention_bwd_ref`` (equal to autograd
    run through the plain forward); no kernel is counted on the CPU."""
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, _ = REF_CASES[case]
    q, k, v, do = (torch.from_numpy(x) for x in _draw(B, Sq, Skv, Hq, Hkv, Dh))
    n = (fops.flash_attention.launches, fops.flash_attention_bwd.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fops.flash_attention(*leaves, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = attention_ref(*(x.transpose(1, 2) for x in plain), causal=causal,
                        window=window).transpose(1, 2)
    ref.backward(do)
    assert torch.equal(out, ref)
    for a, b in zip(leaves, plain):
        assert _rel(a.grad.numpy(), b.grad.numpy()) < TOL
    with torch.no_grad():
        assert fops.flash_attention(*leaves, causal=causal,
                                    window=window).grad_fn is None
    assert n == (fops.flash_attention.launches,
                 fops.flash_attention_bwd.launches)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "encoder"])
def test_attention_block_train_gradients_match_jax(causal):
    """The train-mode attention sublayer of qwen3-4b's smoke config
    (qk-norm, RoPE, GQA): its output and the gradients of every weight
    and of the input agree with JAX's."""
    jcfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
    tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32")
    jp = build_model(jcfg, single_device_ctx()).init(
        jax.random.PRNGKey(0))["layers"]["attn"]
    jp = jax.tree.map(lambda a: a[0], jp)
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp), dtype=torch.float32,
                           device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    kl = np.array([17, 24], np.int32) if not causal else None

    def jf(p, x):
        return j_layers.attention_block(
            p, x, jcfg, None, mode="train", causal=causal,
            kv_len=None if kl is None else jnp.asarray(kl))[0]
    jy, vjp = jax.vjp(jf, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tleaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = t_layers.attention_block(
        tleaves, tx, tcfg, mode="train", causal=causal,
        kv_len=None if kl is None else torch.from_numpy(kl))
    ty.backward(torch.from_numpy(dy))
    assert _rel(ty.detach().numpy(), jy) < TOL
    assert _rel(tx.grad.numpy(), jgx) < TOL
    for name in tp:
        assert _rel(tleaves[name].grad.numpy(), jgp[name]) < 1e-4, name


# bf16 route: (B, Sq, Skv, Hq, Hkv, Dh, causal, window, kv_len), GQA 4
BF16_CASES = {
    "causal": (2, 40, 40, 8, 2, 32, True, None, None),
    "window": (2, 40, 40, 8, 2, 32, True, 9, None),
    "suffix_q": (2, 16, 40, 8, 2, 32, True, None, None),
    "bidir_kv_len": (2, 40, 40, 8, 2, 32, False, None, (23, 40)),
    "cross_short_q": (2, 16, 40, 8, 2, 32, False, None, (29, 40)),
    "cross_long_q": (2, 40, 16, 8, 2, 32, False, None, (11, 16)),
}
BF16_TOL = 2e-2     # chip_smoke.py's and the card tests' bf16 tolerance


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _tc_route(q, k, v, out, dout, lse, *, causal, window, kv_len):
    """The bf16 backward kernels' arithmetic, (B, H, S, Dh) float32 in and
    out: S, dP and D summed in float32; P = exp(S - lse) and dS / scale =
    P (dP - D) rounded to bf16 before dV = P^T dO, dK = scale dS^T Q and
    dQ = scale dS K, summed in float32; the gradients rounded to bf16."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    s, mask = _scores(q, k, causal, window, kv_len)
    mask = mask.expand(s.shape)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout,
                      v.repeat_interleave(G, dim=1))
    D = (dout * out).sum(dim=-1, keepdim=True)
    ds = torch.where(mask, p * (dp - D), 0.0)
    pb, dsb = _bf16(p), _bf16(ds)
    scale = 1 / math.sqrt(Dh)

    def fold(t):
        return t.view(B, Hkv, G, Skv, Dh).sum(dim=2)
    dv = fold(torch.einsum("bhqk,bhqd->bhkd", pb, dout))
    dk = fold(torch.einsum("bhqk,bhqd->bhkd", dsb, q)) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb,
                      k.repeat_interleave(G, dim=1)) * scale
    return _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_route_rounding_fits_the_card_tolerance(case):
    """bf16 inputs and the forward's bf16 output, as the card has them:
    the emulated kernel against the float32 plain backward on the same
    values, within the card check's bf16 tolerance (and not equal to it:
    the rounding points are in the emulation)."""
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, kv = BF16_CASES[case]
    q, k, v, do = (_bf16(torch.from_numpy(x).transpose(1, 2))
                   for x in _draw(B, Sq, Skv, Hq, Hkv, Dh, seed=3))
    mask = dict(causal=causal, window=window,
                kv_len=None if kv is None else torch.tensor(kv))
    out, lse = attention_ref(q, k, v, return_lse=True, **mask)
    out = _bf16(out)
    want = flash_attention_bwd_ref(q, k, v, out, do, lse, **mask)
    got = _tc_route(q, k, v, out, do, lse, **mask)
    for name, g, w in zip("qkv", got, want):
        err = _rel(g.numpy(), w.numpy())
        assert 0 < err < BF16_TOL, (name, err)
