"""The gradient of the grouped expert GEMM (CPU): the port's plain backward
against ``jax.vjp`` of the JAX oracle, and a MoE train step's FLOPs.

``gmm_bwd_ref`` (dx = dy w^T over each expert's first counts[e] slots,
exact zeros past them; dw = x^T dy over those slots) is held against
``jax.vjp`` of ``repro.kernels.moe_gmm.ref.gmm_ref`` on the same numpy
inputs and cotangent: counts of 0, of C and partial ones, C, D and F off
any tile, in float32 (rel < 1e-5, max abs error over the largest entry)
and bfloat16 (rel < 2e-2, ``tests/test_kernels.py``'s tolerance for the
grouped GEMM; both sides round the float32 products once).  Slots at or
past counts[e] are never read: NaNs there change no gradient.

``ops.gmm`` goes through the autograd Function ``_GMM`` when autograd
records it: ``torch.autograd.grad`` through it on the CPU gives
``gmm_bwd_ref``'s gradients bit for bit (and so JAX's within the same
tolerances), only the parts asked for, and a call without grad returns
what ``gmm_ref`` returns, bit for bit.  The card's kernels are held
against ``gmm_bwd_ref`` by ``tests/test_torch_gmm_grad_cuda.py``.

``train_step.step_cost`` counts a MoE model's FLOPs at its active
parameters, ``N - R + R top_k / E`` with R the routed experts' weights.

``ops.takes_wgmma``, the predicate behind ``gmm_bwd.launches_wgmma``,
names the card's route by shape: bf16, no extent 0, D and F multiples
of 8 and 16-byte aligned bases (TMA's terms).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm.ref import gmm_ref as j_gmm_ref  # noqa: E402
from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_bwd_ref, gmm_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import active_params, step_cost  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (E, C, D, F, counts)
CASES = {
    "mixed": (4, 24, 32, 40, [0, 24, 7, 1]),
    "all_empty": (3, 16, 24, 16, [0, 0, 0]),
    "all_full": (3, 16, 24, 16, [16, 16, 16]),
    "ragged_dims": (5, 13, 17, 9, [13, 0, 5, 12, 1]),
}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(case, dtype, seed=0):
    """numpy (x, w, counts, dy) of ``case``, x, w and dy rounded to
    ``dtype`` (the same values on both sides)."""
    E, C, D, F, counts = CASES[case]
    rng = np.random.default_rng(seed)
    rnd = lambda *s: np.array(jnp.asarray(  # noqa: E731
        rng.standard_normal(s).astype(np.float32), JAX[dtype]), np.float32)
    return (rnd(E, C, D), rnd(E, D, F) * np.float32(0.2),
            np.asarray(counts, np.int32), rnd(E, C, F))


def _torch(a, dtype):
    return torch.from_numpy(a).to(TORCH[dtype])


def _jax_grads(x, w, counts, dy, dtype):
    j = lambda a: jnp.asarray(a, JAX[dtype])  # noqa: E731
    _, vjp = jax.vjp(lambda a, b: j_gmm_ref(a, b, jnp.asarray(counts)),
                     j(x), j(w))
    return vjp(j(dy))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_bwd_ref_matches_jax_vjp(case, dtype):
    x, w, counts, dy = _inputs(case, dtype)
    jdx, jdw = _jax_grads(x, w, counts, dy, dtype)
    dx, dw = gmm_bwd_ref(_torch(x, dtype), _torch(w, dtype),
                         torch.from_numpy(counts), _torch(dy, dtype))
    assert dx.dtype == dw.dtype == TORCH[dtype]
    assert dx.shape == x.shape and dw.shape == w.shape
    for got, want in ((dx, jdx), (dw, jdw)):
        if np.abs(_np(want)).max() == 0:
            assert not _np(got).any()
        else:
            assert _rel(_np(got), _np(want)) < TOL[dtype]
    C = x.shape[1]
    pad = np.arange(C)[None, :] >= counts[:, None]
    assert not _np(dx)[pad].any()           # exact zeros past counts
    assert not _np(dw)[counts == 0].any()   # an expert with no token


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_through_gmm_matches_ref_and_jax(case, dtype):
    x, w, counts, dy = _inputs(case, dtype, seed=1)
    tx = _torch(x, dtype).requires_grad_()
    tw = _torch(w, dtype).requires_grad_()
    tc, tdy = torch.from_numpy(counts), _torch(dy, dtype)
    out = gops.gmm(tx, tw, tc)
    assert out.grad_fn is not None
    assert torch.equal(out, gmm_ref(tx.detach(), tw.detach(), tc))
    dx, dw = torch.autograd.grad(out, (tx, tw), tdy)
    rdx, rdw = gmm_bwd_ref(tx.detach(), tw.detach(), tc, tdy)
    assert torch.equal(dx, rdx) and torch.equal(dw, rdw)
    jdx, jdw = _jax_grads(x, w, counts, dy, dtype)
    for got, want in ((dx, jdx), (dw, jdw)):
        if np.abs(_np(want)).max() == 0:
            assert not _np(got).any()
        else:
            assert _rel(_np(got), _np(want)) < TOL[dtype]


@pytest.mark.parametrize("which", ["x", "w"])
def test_autograd_computes_only_the_parts_asked_for(which, monkeypatch):
    x, w, counts, dy = _inputs("mixed", "float32")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    leaf = (tx if which == "x" else tw).requires_grad_()
    calls = []
    bwd = gops.gmm_bwd

    def spy(*args, **kw):
        calls.append((kw["dx"], kw["dw"]))
        return bwd(*args, **kw)

    monkeypatch.setattr(gops, "gmm_bwd", spy)
    out = gops.gmm(tx, tw, torch.from_numpy(counts))
    (g,) = torch.autograd.grad(out, leaf, torch.from_numpy(dy))
    assert calls == [(which == "x", which == "w")]
    want = gmm_bwd_ref(tx.detach(), tw.detach(), torch.from_numpy(counts),
                       torch.from_numpy(dy))[0 if which == "x" else 1]
    assert torch.equal(g, want)


def test_slots_past_counts_are_never_read():
    """NaN in x's and dy's padding slots reaches no gradient, and the
    forward writes zeros there."""
    x, w, counts, dy = _inputs("mixed", "float32", seed=2)
    pad = np.arange(x.shape[1])[None, :] >= counts[:, None]
    x[pad] = np.nan
    dy[pad] = np.nan
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = gops.gmm(tx, tw, torch.from_numpy(counts))
    assert not out[torch.from_numpy(pad)].any()
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(dy))
    assert torch.isfinite(dw).all()
    assert not dx[torch.from_numpy(pad)].any()
    assert torch.isfinite(dx).all()


def test_gmm_without_grad_is_the_plain_call():
    x, w, counts, _ = _inputs("ragged_dims", "bfloat16")
    tx = _torch(x, "bfloat16").requires_grad_()
    tw = _torch(w, "bfloat16")
    with torch.no_grad():
        out = gops.gmm(tx, tw, torch.from_numpy(counts))
    assert out.grad_fn is None
    assert torch.equal(out, gmm_ref(tx.detach(), tw, torch.from_numpy(counts)))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_step_cost_counts_active_params(arch):
    """6 N_active T: a MoE layer's routed experts count top_k of E; the
    leading dense layers (deepseek's first) have none.  The state bytes
    still count every parameter."""
    cfg = smoke_config(get_arch(arch))
    model = Model(cfg)
    m = cfg.moe
    B, S = 2, 32
    tok = torch.zeros((B, S), dtype=torch.int32)
    c = step_cost(model, OptConfig(), {"tokens": tok, "labels": tok})
    N = model.n_params()
    routed = ((cfg.num_layers - m.first_dense_layers) * 3 * cfg.d_model
              * m.d_expert * m.num_experts)
    n_active = N - routed + routed * m.top_k / m.num_experts
    assert 0 < n_active < N
    assert active_params(model) == pytest.approx(n_active, rel=1e-12)
    attn = 6.0 * cfg.num_layers * B * S * S * cfg.num_heads \
        * cfg.resolved_head_dim
    assert c["flops"] == pytest.approx(6.0 * n_active * B * S + attn,
                                       rel=1e-12)
    # one microbatch: bf16 params and grads, float32 moments, all N
    assert cfg.microbatch == 1
    assert c["bytes"] == 4 * 2 * N + (2 * 2 + 4 + 4 + 2 + 4 + 4) * N


def test_active_params_of_the_depth_cut_deepseek():
    """deepseek-moe-16b at its published widths with 6 of its 28 layers (1
    dense + 5 MoE): 3.443 B parameters, of which about 0.934 B a token
    meets."""
    model = Model(get_arch("deepseek-moe-16b").replace(num_layers=6))
    assert model.n_params() == 3_442_763_776
    assert round(active_params(model) / 1e6, 1) == 934.0


@pytest.mark.parametrize("case,want", [
    ("deepseek_widths", True), ("float32", False), ("d_not_8", False),
    ("f_not_8", False), ("no_slots", False), ("x_offset", False),
    ("w_offset", False), ("dy_offset", False)])
def test_wgmma_route_is_chosen_by_shape(case, want):
    """``takes_wgmma`` mirrors ``rt_gmm_bwd``'s ``gmm_bwd_takes_wgmma``:
    the aligned bf16 training widths take the wgmma route; float32, a D or
    F not a multiple of 8, an empty capacity, or an x, w or dy whose base
    sits one element (2 bytes) into its storage take another."""
    E, C, D, F = 2, 0 if case == "no_slots" else 8, 24, 40
    D += 4 * (case == "d_not_8")
    F += 4 * (case == "f_not_8")
    dt = torch.float32 if case == "float32" else torch.bfloat16

    def make(*shape, off=False):
        n = int(np.prod(shape))
        buf = torch.zeros(n + 16, dtype=dt)
        base = (16 - buf.data_ptr() % 16) % 16 // buf.element_size()
        return buf[base + off:base + off + n].view(shape)

    x = make(E, C, D, off=case == "x_offset")
    w = make(E, D, F, off=case == "w_offset")
    dy = make(E, C, F, off=case == "dy_offset")
    assert gops.takes_wgmma(x, w, dy) is want
