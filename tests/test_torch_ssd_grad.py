"""The gradient of the SSD scan (CPU, float32): the port's plain backward
against ``jax.vjp`` of the JAX oracle.

``ssd_bwd_ref`` (dx, ddt, dA_log, dB, dC and the initial state's
gradient, written out in the CUDA backward's three parts: U per sub-chunk,
the adjoint scanned backwards, every sub-chunk's body from it) is held
against ``jax.vjp`` of ``repro.models.mamba2.ssd_chunked`` on the same
numpy inputs at 1e-5 relative (max abs error over the largest entry; for
dA_log over its summands' scale, below): chunk lengths 16, 32 and 64 and
an S the chunk does not tile (with and without a mask), one and two
groups, no mask, a ragged masked tail, rows masked from a sub-chunk's
first step and a fully masked row, with and without an initial state
(without one JAX is given zeros, so the initial state's gradient is
compared too), with and without the final state's cotangent, and bf16 x,
B and C (JAX takes their float32 values) over two and five sub-chunks.
Where dt' is zero the port's dx, ddt and dB are exactly 0.

dA_log = A sum_{b, s} dt' da is a sum whose terms cancel: at these inputs
its entries are 30-900 times smaller than |A| sum |dt' da|, and any float32
evaluation, JAX's included, is off from a float64 one by float32's epsilon
times the latter (up to 3.3e-5 of the largest entry for JAX, 1.3e-5 for
the port).  So its error is taken relative to that scale
(``ref.ssd_dA_log_scale``, from JAX's own dx and ddt), still at 1e-5.

``ops.ssd`` goes through the autograd Function ``_SSD`` when autograd
records it: on the CPU its gradients are autograd-through-``ssd_ref``'s,
and a call without grad returns what ``ssd_ref`` returns, bit for bit.
The card's kernel is held against ``ssd_bwd_ref`` by
``tests/test_torch_ssd_grad_cuda.py``.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.mamba2 import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_bwd_ref,
    ssd_bwd_span,
    ssd_dA_log_scale,
    ssd_ref,
)

TOL = 1e-5
NAMES = ("dx", "ddt", "dA_log", "dB", "dC", "d_initial_state")

# (B, S, H, P, G, N, chunk, row lengths or None, initial state, final
# state's cotangent, x / B / C dtype)
CASES = {
    "chunk16": (2, 64, 4, 8, 1, 16, 16, None, False, True, "float32"),
    "chunk64": (2, 128, 4, 8, 1, 16, 64, None, True, True, "float32"),
    "chunk_degrades": (2, 40, 4, 8, 1, 16, 16, None, True, True, "float32"),
    "g2": (2, 64, 4, 8, 2, 16, 32, None, True, False, "float32"),
    "ragged_tail": (3, 64, 4, 8, 1, 16, 16, (64, 37, 5), False, True,
                    "float32"),
    "masked_row": (2, 48, 4, 8, 2, 16, 16, (48, 0), True, True, "float32"),
    "no_final_cotangent": (2, 64, 2, 16, 1, 32, 16, (64, 50), True, False,
                           "float32"),
    "bf16": (2, 64, 4, 8, 2, 16, 16, (64, 21), True, True, "bfloat16"),
    # where the sub-chunk boundaries matter: an S the chunk does not tile
    # (8-step sub-chunks) under a mask, rows masked from a sub-chunk's first
    # step, an initial state with the final state's cotangent in two
    # groups, and five sub-chunks in bf16
    "degraded_span": (2, 56, 4, 8, 1, 16, 16, (56, 23), True, True,
                      "float32"),
    "masked_from_chunk_start": (3, 64, 4, 8, 1, 16, 16, (64, 32, 16), True,
                                True, "float32"),
    "init_final_g2": (2, 64, 4, 8, 2, 16, 16, (64, 40), True, True,
                      "float32"),
    "bf16_five_chunks": (2, 80, 4, 8, 2, 16, 16, (80, 49), True, True,
                         "bfloat16"),
}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _draw(case, seed=0):
    """numpy inputs of a case: (x, dt, A_log, B, C, init, dy, d_final, mask),
    x, B and C rounded to the case's dtype (as float32 values)."""
    B, S, H, P, G, N, _, lens, init, dfin, dtype = CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, raw = f(B, S, H, P), f(B, S, H)
    dt = np.log1p(np.exp(raw * 0.5)).astype(np.float32)
    A_log = (rng.random(H) * 1.5).astype(np.float32)
    Bm, Cm = f(B, S, G, N) * 0.3, f(B, S, G, N) * 0.3
    h0 = f(B, H, P, N) * 0.2 if init else None
    dy, d_final = f(B, S, H, P), f(B, H, P, N) if dfin else None
    if dtype == "bfloat16":
        x, Bm, Cm = (torch.from_numpy(t).to(torch.bfloat16).float().numpy()
                     for t in (x, Bm, Cm))
    mask = (None if lens is None
            else np.arange(S)[None] < np.asarray(lens)[:, None])
    return x, dt, A_log, Bm, Cm, h0, dy, d_final, mask


def _jax_grads(case):
    x, dt, A_log, Bm, Cm, h0, dy, d_final, mask = _draw(case)
    chunk = CASES[case][6]
    if h0 is None:       # JAX's own default, given so that it has a gradient
        h0 = np.zeros(x.shape[:1] + x.shape[2:] + Bm.shape[3:], np.float32)
    jm = None if mask is None else jnp.asarray(mask)

    def f(x, dt, A_log, B, C, h0):
        return j_ssd_chunked(x, dt, A_log, B, C, chunk=chunk,
                             initial_state=h0, mask=jm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the degraded chunk warns
        (_, fin), vjp = jax.vjp(f, *(jnp.asarray(t) for t in
                                     (x, dt, A_log, Bm, Cm, h0)))
        cot = (jnp.asarray(dy), jnp.zeros_like(fin) if d_final is None
               else jnp.asarray(d_final))
        return [np.array(g) for g in vjp(cot)]


def _port(case, fn=ssd_bwd_ref):
    x, dt, A_log, Bm, Cm, h0, dy, d_final, mask = _draw(case)
    dtype = getattr(torch, CASES[case][10])
    t = torch.from_numpy
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(t(x).to(dtype), t(dt), t(A_log), t(Bm).to(dtype),
                  t(Cm).to(dtype), t(dy),
                  None if d_final is None else t(d_final),
                  chunk=CASES[case][6],
                  initial_state=None if h0 is None else t(h0),
                  mask=None if mask is None else t(mask)), mask


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_bwd_ref_matches_jax_vjp(case):
    got, mask = _port(case)
    want = _jax_grads(case)
    x, dt = _draw(case)[:2]
    t = torch.from_numpy
    scale = ssd_dA_log_scale(t(x), t(dt), None if mask is None else t(mask),
                             t(want[0]), t(want[1])).numpy()
    assert len(got) == len(want) == 6
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == w.shape, (name, g.shape, w.shape)
        g = g.numpy()
        err = (np.max(np.abs(g - w)) / scale.max() if name == "dA_log"
               else _rel(g, w))
        assert err < TOL, (case, name, err)


@pytest.mark.parametrize("case", ["ragged_tail", "masked_row", "bf16",
                                  "degraded_span", "masked_from_chunk_start"])
def test_gradients_are_exactly_zero_where_dt_is_masked(case):
    (dx, ddt, _, dB, _, _), mask = _port(case)
    pad = torch.from_numpy(~mask)
    assert pad.any()
    assert torch.all(dx[pad] == 0) and torch.all(ddt[pad] == 0)
    # dB is a sum over the group's heads: exactly 0 at a pad step of the row
    assert torch.all(dB[pad] == 0)
    assert dx[~pad].abs().max() > 0 and dB[~pad].abs().max() > 0


def test_ssd_bwd_on_the_cpu_is_the_plain_version_in_the_inputs_dtypes():
    got, _ = _port("bf16", sops.ssd_bwd)
    want, _ = _port("bf16")
    dtypes = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
              torch.bfloat16, torch.float32)
    for g, w, dt in zip(got, want, dtypes):
        assert g.dtype == dt
        assert torch.equal(g, w.to(dt))
    assert sops.ssd_bwd.launches == 0        # counts card launches only


def test_ssd_bwd_span():
    assert ssd_bwd_span(512, 256) == 16
    assert ssd_bwd_span(64, 32) == 16
    assert ssd_bwd_span(64, 8) == 8
    with pytest.warns(UserWarning, match="degrading to chunk 8"):
        assert ssd_bwd_span(40, 16) == 8


def _leaves(case, seed=3):
    x, dt, A_log, Bm, Cm, h0, dy, d_final, mask = _draw(case, seed)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return ([None if a is None else t(a).requires_grad_()
             for a in (x, dt, A_log, Bm, Cm, h0)], t(dy), t(d_final), t(mask))


@pytest.mark.parametrize("checkpoints", [False, True])
def test_the_function_gives_autograd_through_ssd_ref(checkpoints):
    """``ops.ssd`` with grad enabled runs ``_SSD`` (forward ``ssd_ref``,
    backward ``ssd_bwd_ref``): the same outputs as ``ssd_ref``, gradients
    equal to autograd through ``ssd_ref`` to 1e-5, the checkpoints not
    differentiable."""
    a, dy, d_final, mask = _leaves("masked_row")
    b = [t.detach().clone().requires_grad_() for t in a]
    out = sops.ssd(*a[:5], chunk=16, initial_state=a[5], mask=mask,
                   checkpoints=checkpoints)
    ref = ssd_ref(*b[:5], chunk=16, initial_state=b[5], mask=mask,
                  checkpoints=checkpoints)
    assert out[0].grad_fn is not None
    assert type(out[0].grad_fn).__name__ == "_SSDBackward"
    for o, r in zip(out, ref):
        assert torch.equal(o, r.detach())
    if checkpoints:
        assert not out[2].requires_grad
    ((out[0] * dy).sum() + (out[1] * d_final).sum()).backward()
    ((ref[0] * dy).sum() + (ref[1] * d_final).sum()).backward()
    for name, u, v in zip(NAMES, a, b):
        assert _rel(u.grad.numpy(), v.grad.numpy()) < TOL, name


def test_the_function_skips_what_needs_no_gradient():
    """Only y feeds the loss (the final state's cotangent is None) and
    ``initial_state`` needs no gradient: the Function hands back None for
    it and the others' gradients still match autograd."""
    a, dy, _, mask = _leaves("ragged_tail")
    b = [t.detach().clone().requires_grad_() for t in a[:5]]
    y, _ = sops.ssd(*a[:5], chunk=16, mask=mask)
    y_r, _ = ssd_ref(*b, chunk=16, mask=mask)
    (y * dy).sum().backward()
    (y_r * dy).sum().backward()
    for u, v in zip(a[:5], b):
        assert _rel(u.grad.numpy(), v.grad.numpy()) < TOL


def test_ssd_without_grad_is_unchanged():
    """A serving call (nothing requires grad, or under no_grad) is the plain
    version's result bit for bit, recorded by no Function, and writes its
    checkpoints into ``ckpt_out``."""
    a, _, _, mask = _leaves("g2")
    plain = [t.detach() for t in a]
    want = ssd_ref(*plain[:5], chunk=32, initial_state=plain[5], mask=mask,
                   checkpoints=True)
    got = sops.ssd(*plain[:5], chunk=32, initial_state=plain[5], mask=mask,
                   checkpoints=True)
    with torch.no_grad():
        buf = torch.empty(want[2].shape)
        got2 = sops.ssd(*a[:5], chunk=32, initial_state=a[5], mask=mask,
                        checkpoints=True, ckpt_out=buf)
    assert got2[2] is buf
    for w, g, g2 in zip(want, got, got2):
        assert g.grad_fn is None and g2.grad_fn is None
        assert torch.equal(g, w) and torch.equal(g2, w)
