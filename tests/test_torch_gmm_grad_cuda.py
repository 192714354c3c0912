"""The grouped GEMM's backward kernels on the card against their plain
version.

Needs an NVIDIA GPU: a CUDA kernel has no CPU mode, so without a card
every test here skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gmm_grad_cuda.py

``ops.gmm_bwd`` (``rt_gmm_bwd`` in ``csrc/moe_gmm.cu``: dX the forward's
tile over w as it lies, dW a grouped product over each expert's count;
bf16 on the tensor cores, float32 on CUDA cores) is held against
``ref.gmm_bwd_ref`` run on the card on the same inputs and cotangent:
each of the bf16 kernel's tiles by C (16, 64 and 128 rows), counts of 0,
1, a tile's edges and C, all-empty and all-full experts, C, D and F off
every tile and D or F not a multiple of 8 (the element-wise loads), and a
training shape of deepseek-moe-16b's widths.  Tolerances: bf16 rel < 2e-2
(max abs error over the largest entry; output rounding), float32 rel <
1e-4 (sums in another order).  Rows of dx past counts and the dw of an
expert with no token are exact zeros, each part is computed only when
asked for, two calls are bitwise equal, NaNs in the slots past counts
reach nothing, and ``ops.gmm`` under autograd launches the forward once
and the backward once with the parts autograd asks for.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_bwd_ref, gmm_ref  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (E, C, D, F, counts)
CASES = {
    "wide_tiles": (8, 256, 128, 256, [0, 5, 128, 256, 129, 200, 1, 64]),
    "medium_all_full": (8, 96, 128, 256, [96] * 8),
    "all_empty": (8, 64, 128, 136, [0] * 8),
    "narrow": (5, 16, 512, 384, [0, 1, 15, 16, 9]),
    "ragged_elementwise": (4, 40, 100, 44, [40, 0, 33, 1]),
    "ragged_f_tiles": (8, 300, 256, 264, [0, 1, 127, 128, 129, 300, 255, 256]),
    "d_tile_ragged": (3, 72, 136, 60, [72, 17, 64]),
    "deepseek_down": (4, 240, 1408, 2048, [192, 240, 0, 131]),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-9))


def _inputs(dev, case, dtype, seed=0):
    E, C, D, F, counts = CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return (r(E, C, D).to(dtype), (r(E, D, F) * 0.05).to(dtype),
            torch.tensor(counts, dtype=torch.int32, device=dev),
            r(E, C, F).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_gmm_bwd_kernel_matches_its_plain_version(dev, case, dtype):
    x, w, cnt, dy = _inputs(dev, case, dtype)
    n0 = (gops.gmm_bwd.launches, gops.gmm_bwd.launches_tc,
          gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw)
    dx, dw = gops.gmm_bwd(x, w, cnt, dy)
    want = gmm_bwd_ref(x, w, cnt, dy)
    torch.cuda.synchronize()
    assert (gops.gmm_bwd.launches, gops.gmm_bwd.launches_tc,
            gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw) == (
        n0[0] + 1, n0[1] + (dtype == torch.bfloat16), n0[2] + 1, n0[3] + 1)
    assert dx.dtype == dw.dtype == dtype
    C = x.shape[1]
    pad = torch.arange(C, device=dev)[None] >= cnt[:, None]
    assert not dx[pad].any()
    assert not dw[cnt == 0].any()
    for got, ref in zip((dx, dw), want):
        assert torch.isfinite(got).all()
        if ref.abs().max() == 0:
            assert not got.any()
        else:
            assert _rel(got, ref) < TOL[dtype], _rel(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_part_alone_and_bitwise_repeatable(dev, dtype):
    x, w, cnt, dy = _inputs(dev, "wide_tiles", dtype, seed=1)
    dx, dw = gops.gmm_bwd(x, w, cnt, dy)
    n0 = (gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw)
    dx1, none1 = gops.gmm_bwd(x, w, cnt, dy, dw=False)
    none2, dw1 = gops.gmm_bwd(x, w, cnt, dy, dx=False)
    torch.cuda.synchronize()
    assert none1 is None and none2 is None
    assert (gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw) == (
        n0[0] + 1, n0[1] + 1)
    assert torch.equal(dx, dx1) and torch.equal(dw, dw1)
    dx2, dw2 = gops.gmm_bwd(x, w, cnt, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def test_slots_past_counts_are_never_read(dev):
    x, w, cnt, dy = _inputs(dev, "ragged_f_tiles", torch.bfloat16, seed=2)
    want = gops.gmm_bwd(x, w, cnt, dy)
    pad = torch.arange(x.shape[1], device=dev)[None] >= cnt[:, None]
    got = gops.gmm_bwd(x.masked_fill(pad[..., None], float("nan")), w, cnt,
                       dy.masked_fill(pad[..., None], float("nan")))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gmm_under_autograd_launches_the_backward(dev, dtype):
    """``ops.gmm`` with grad: one forward launch (the serving call's output,
    bit for bit) and one backward launch with both parts; with only w
    requiring grad, dW alone."""
    x, w, cnt, dy = _inputs(dev, "medium_all_full", dtype, seed=3)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    f0, b0 = gops.gmm.launches, gops.gmm_bwd.launches
    dx0, dw0 = gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw
    out = gops.gmm(xl, wl, cnt)
    assert gops.gmm.launches == f0 + 1
    assert torch.equal(out.detach(), gops.gmm(x, w, cnt))
    out.backward(dy)
    assert gops.gmm_bwd.launches == b0 + 1
    assert (gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw) == (
        dx0 + 1, dw0 + 1)
    want = gops.gmm_bwd(x, w, cnt, dy)
    assert torch.equal(xl.grad, want[0]) and torch.equal(wl.grad, want[1])
    wl2 = w.clone().requires_grad_()
    gops.gmm(x, wl2, cnt).backward(dy)
    assert (gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw) == (
        dx0 + 2, dw0 + 3)
    assert torch.equal(wl2.grad, want[1])
    assert _rel(out.detach(), gmm_ref(x, w, cnt)) < TOL[dtype]


def test_gmm_bwd_rejects_bad_shapes(dev):
    x, w, cnt, dy = _inputs(dev, "narrow", torch.bfloat16)
    n0 = gops.gmm_bwd.launches
    with pytest.raises(ValueError):
        gops.gmm_bwd(x, w, cnt, dy[:, :, :-1])
    with pytest.raises(ValueError):
        gops.gmm_bwd(x, w.float(), cnt, dy)
    assert gops.gmm_bwd.launches == n0
