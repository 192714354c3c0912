"""The SSD scan's backward kernel on the card against its plain version.

Needs an NVIDIA GPU: a CUDA kernel has no CPU mode, so without a card
every test here skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_grad_cuda.py

``ops.ssd_bwd`` (``csrc/ssd_scan_bwd.cu``: bf16 x, B and C on the tensor
cores in spans of ``ops.BWD_SPAN`` sub-chunks, float32 on CUDA cores in
spans of ``ops.BWD_SPAN_F32``; the fixed order sums) is held against
``ref.ssd_bwd_ref`` run on the card on the same inputs and the same
cotangents: mamba2's state 128 and zamba2's 64 with 64-row heads, a head
dim of 80 (two P tiles, the second one ragged), states 16 to 256 (256:
the most shared memory), two groups, a chunk that degrades to 8-step
sub-chunks, rows that cross either route's span boundaries (a last span
of one sub-chunk), ragged masks and a fully masked row, with and without
an initial state and the final state's cotangent, float32 and bf16 x, B
and C. Each call counts one launch, and a bf16 one a tensor-core launch.
Tolerances: float32 outputs rel < 1e-4 (max abs error over the largest
entry; the kernel sums in another order than the plain version, dB and
dC over the group's heads too); bf16 outputs (dx, dB, dC of bf16 inputs)
rel < 1e-2, bf16 output rounding; dA_log, a sum whose terms cancel, 1e-5
of its summands' scale (``ref.ssd_dA_log_scale``). Two calls are bitwise
equal (bf16 and float32), shapes the kernel does not take raise
``ValueError`` before any launch, and ``ops.ssd`` under autograd
launches the forward once and the backward once, from the states the
forward kept.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_bwd_ref,
    ssd_bwd_span,
    ssd_dA_log_scale,
)

pytestmark = pytest.mark.cuda

NAMES = ("dx", "ddt", "dA_log", "dB", "dC", "d_initial_state")
# (B, S, H, P, G, N, chunk, row lengths or None, initial state, final
# state's cotangent, x / B / C dtype)
CASES = {
    "mamba2_n128_bf16": (2, 128, 8, 64, 1, 128, 256, None, False, False,
                         torch.bfloat16),
    "zamba2_n64_masked": (2, 128, 8, 64, 1, 64, 256, (128, 77), False, True,
                          torch.float32),
    "g2_n64_masked_row": (2, 64, 4, 32, 2, 64, 32, (64, 0), True, True,
                          torch.float32),
    "p80_two_tiles": (1, 96, 4, 80, 2, 128, 32, None, True, True,
                      torch.float32),
    "n256": (1, 64, 2, 64, 1, 256, 16, (50,), True, True, torch.float32),
    "sub8_n16": (2, 40, 4, 16, 1, 16, 16, (40, 13), False, True,
                 torch.float32),
    "g2_bf16": (2, 64, 4, 64, 2, 32, 64, (64, 30), True, True,
                torch.bfloat16),
    # the bf16 route across its span boundaries (``ops.BWD_SPAN`` sub-chunks
    # of 16 steps): N 128 with a ragged mask and an initial state over two
    # spans, P 80 in two tiles, S = 2 spans + 16 (a last span of one
    # sub-chunk), and its other state widths (256; 16 with 8-step
    # sub-chunks)
    "n128_bf16_ragged_init": (2, 192, 4, 64, 1, 128, 256, (192, 70), True,
                              True, torch.bfloat16),
    "p80_two_tiles_bf16": (1, 96, 4, 80, 2, 128, 32, None, True, True,
                           torch.bfloat16),
    "two_spans_and_16_bf16": (2, 16 * (2 * sops.BWD_SPAN + 1), 4, 64, 1, 64,
                              16, (16 * (2 * sops.BWD_SPAN + 1), 100), True,
                              True, torch.bfloat16),
    "n256_bf16": (1, 64, 2, 64, 1, 256, 16, (50,), True, True,
                  torch.bfloat16),
    "sub8_n16_bf16": (2, 40, 4, 16, 1, 16, 16, (40, 13), False, True,
                      torch.bfloat16),
    # the float32 route across its span boundaries (``ops.BWD_SPAN_F32``
    # sub-chunks): the bf16 cases above in float32, with a fully masked
    # row beside the ragged one, and states 256 and 16 (8-step
    # sub-chunks) over three spans
    "n128_f32_ragged_init": (3, 192, 4, 64, 1, 128, 256, (192, 70, 0), True,
                             True, torch.float32),
    "p80_two_tiles_f32_spans": (2, 144, 4, 80, 2, 128, 48, (144, 0), True,
                                True, torch.float32),
    "two_spans_and_16_f32": (3, 16 * (2 * sops.BWD_SPAN_F32 + 1), 4, 64, 1,
                             64, 16, (16 * (2 * sops.BWD_SPAN_F32 + 1), 100,
                                      0), True, True, torch.float32),
    "n256_f32_spans": (1, 160, 2, 64, 1, 256, 16, (150,), True, True,
                       torch.float32),
    "sub8_n16_f32_spans": (2, 72, 4, 16, 1, 16, 8, (72, 29), True, True,
                           torch.float32),
    "mamba2_n128_f32": (2, 128, 8, 64, 1, 128, 256, None, False, False,
                        torch.float32),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-9))


def _inputs(dev, case, seed=0):
    B, S, H, P, G, N, chunk, lens, init, dfin, dtype = CASES[case]
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(dev)
    dt = torch.nn.functional.softplus(t(B, S, H, scale=0.5))
    A_log = torch.from_numpy((rng.random(H) * 1.5).astype(np.float32)).to(dev)
    x, Bm, Cm = (t(B, S, H, P).to(dtype), t(B, S, G, N, scale=0.3).to(dtype),
                 t(B, S, G, N, scale=0.3).to(dtype))
    h0 = t(B, H, P, N, scale=0.2) if init else None
    dy, d_final = t(B, S, H, P), t(B, H, P, N) if dfin else None
    mask = (None if lens is None else torch.arange(S, device=dev)[None]
            < torch.tensor(lens, device=dev)[:, None])
    kw = dict(chunk=chunk, initial_state=h0, mask=mask)
    return (x, dt, A_log, Bm, Cm, dy, d_final), kw


def _hold(got, want, args, kw):
    x, dt = args[:2]
    scale = ssd_dA_log_scale(x, dt, kw["mask"], want[0], want[1]).max()
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        if name == "dA_log":
            err = float((g.double() - w.double()).abs().max() / scale)
            assert err < 1e-5, (name, err)
            continue
        tol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        assert _rel(g, w) < tol, (name, _rel(g, w))


@pytest.mark.parametrize("case", list(CASES))
def test_ssd_bwd_kernel_matches_its_plain_version(dev, case):
    args, kw = _inputs(dev, case)
    n0, f0 = sops.ssd_bwd.launches, sops.ssd.launches
    tc0 = sops.ssd_bwd.launches_tc
    got = sops.ssd_bwd(*args, **kw)
    want = ssd_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    assert sops.ssd_bwd.launches == n0 + 1
    # bf16 x, B and C take the tensor cores, float32 the CUDA cores
    assert sops.ssd_bwd.launches_tc == tc0 + (args[0].dtype
                                              == torch.bfloat16)
    assert sops.ssd.launches == f0 + 1      # the states, computed first
    for g, t in zip(got, (args[0], args[1], args[2], args[3], args[4],
                          kw["initial_state"])):
        assert g.dtype == (torch.float32 if t is None else t.dtype)
    _hold(got, want, args, kw)
    if kw["mask"] is not None:
        pad = ~kw["mask"]
        assert torch.all(got[0][pad] == 0) and torch.all(got[1][pad] == 0)
        assert torch.all(got[3][pad] == 0)


@pytest.mark.parametrize("case", ["mamba2_n128_bf16", "mamba2_n128_f32"])
def test_two_calls_are_bitwise_equal(dev, case):
    args, kw = _inputs(dev, case)
    K = ssd_bwd_span(args[0].shape[1], kw["chunk"])
    with torch.no_grad():
        states = sops.ssd(*args[:5], chunk=K, initial_state=kw["initial_state"],
                          mask=kw["mask"], checkpoints=True)[2]
    a = sops.ssd_bwd(*args, states=states, **kw)
    b = sops.ssd_bwd(*args, states=states, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("P,N", [(6, 16), (16, 6), (16, 260), (260, 16)])
def test_ssd_bwd_rejects_shapes(dev, P, N):
    r = lambda *s: torch.randn(s, device=dev)  # noqa: E731
    n0 = sops.ssd_bwd.launches
    with pytest.raises(ValueError):
        sops.ssd_bwd(r(1, 16, 2, P), r(1, 16, 2).abs(), r(2), r(1, 16, 1, N),
                     r(1, 16, 1, N), r(1, 16, 2, P), chunk=16)
    assert sops.ssd_bwd.launches == n0


def test_ssd_under_autograd_launches_the_backward(dev):
    """``ops.ssd`` with grad: one forward launch that keeps the states, one
    backward launch from them, gradients those of ``ssd_bwd_ref``; the
    outputs are the serving call's, bit for bit (chunk 256 walks the same
    16-step sub-chunks with and without checkpoints)."""
    args, kw = _inputs(dev, "zamba2_n64_masked")
    x, dt, A_log, Bm, Cm, dy, d_final = args
    leaves = [t.clone().requires_grad_() for t in (x, dt, A_log, Bm, Cm)]
    f0, b0 = sops.ssd.launches, sops.ssd_bwd.launches
    y, fin = sops.ssd(*leaves, chunk=kw["chunk"], mask=kw["mask"])
    assert sops.ssd.launches == f0 + 1
    with torch.no_grad():
        y2, fin2 = sops.ssd(x, dt, A_log, Bm, Cm, chunk=kw["chunk"],
                            mask=kw["mask"])
    assert torch.equal(y.detach(), y2) and torch.equal(fin.detach(), fin2)
    ((y * dy).sum() + (fin * d_final).sum()).backward()
    assert sops.ssd_bwd.launches == b0 + 1
    assert sops.ssd.launches == f0 + 2
    want = ssd_bwd_ref(*args, **kw)
    _hold([t.grad for t in leaves] + [want[5]], want, args, kw)
