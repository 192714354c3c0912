"""The grouped GEMM's backward kernels on the card against their plain
version.

Needs an NVIDIA GPU: a CUDA kernel has no CPU mode, so without a card
every test here skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gmm_grad_cuda.py

``ops.gmm_bwd`` (``rt_gmm_bwd`` in ``csrc/moe_gmm.cu``: bf16 with D and
F multiples of 8 and aligned bases on ``wgmma`` fed by TMA, other bf16
shapes element loads into ``mma.sync`` tiles, float32 on CUDA cores) is
held against ``ref.gmm_bwd_ref`` run on the card on the same inputs and
cotangent: each of the element route's tiles by C (16, 64 and 128 rows),
counts of 0, 1, a tile's edges and C, all-empty and all-full experts, C,
D and F off every tile and D or F not a multiple of 8 (the element-wise
loads), and a training shape of deepseek-moe-16b's widths; for the
``wgmma`` route, counts at its m64 and 64-slot slice edges at C 240, F
1400 (a ragged K for dX, a ragged N for dW), and x, w or dy views offset
by one element, which take the element route; for the float32 route,
counts at its 64-row tile's edges, D and F off its tiles and not
multiples of 4 or 8, and operands offset by one element.  Tolerances: bf16 rel <
2e-2 (max abs error over the largest entry; output rounding), float32
rel < 1e-4 (sums in another order).  Rows of dx past counts and the dw
of an expert with no token are exact zeros, each part is computed only
when asked for, two calls are bitwise equal, NaNs in the slots past
counts reach nothing (also at C 240 at deepseek's widths, where dW's last
slice is partial), the route is chosen by shape, and ``ops.gmm`` under
autograd launches the forward once and the backward once with the parts
autograd asks for.
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
    # the wgmma route: counts at the m64 sub-tile and 64-slot slice edges
    "wgmma_edges": (10, 240, 256, 320,
                    [63, 64, 65, 127, 128, 129, 191, 192, 239, 240]),
    "f_1400": (4, 240, 256, 1400, [240, 100, 0, 177]),
    # the float32 route's tiles: counts at its 64-row dX tile's edges, D
    # and F off its 128 (dW) and 256 (dX) tiles, D or F not a multiple of
    # 4 or 8 (element loads below 4)
    "f32_count_edges": (8, 240, 256, 320,
                        [63, 64, 65, 127, 128, 129, 239, 240]),
    "f32_off_tiles": (4, 200, 264, 200, [1, 199, 200, 0]),
    "f32_not_mult_4": (3, 70, 102, 66, [70, 5, 64]),
    "f32_f_not_mult_8": (3, 96, 132, 60, [96, 33, 0]),
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
          gops.gmm_bwd.launches_wgmma, gops.gmm_bwd.launches_dx,
          gops.gmm_bwd.launches_dw)
    dx, dw = gops.gmm_bwd(x, w, cnt, dy)
    want = gmm_bwd_ref(x, w, cnt, dy)
    torch.cuda.synchronize()
    E, C, D, F, _ = CASES[case]
    wgmma = dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
    assert (gops.gmm_bwd.launches, gops.gmm_bwd.launches_tc,
            gops.gmm_bwd.launches_wgmma, gops.gmm_bwd.launches_dx,
            gops.gmm_bwd.launches_dw) == (
        n0[0] + 1, n0[1] + (dtype == torch.bfloat16), n0[2] + wgmma,
        n0[3] + 1, n0[4] + 1)
    assert dx.dtype == dw.dtype == dtype
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


@pytest.mark.parametrize("case", ["ragged_f_tiles", "deepseek_partial"])
def test_slots_past_counts_are_never_read(dev, case):
    """NaNs in the slots past counts reach no output: the element route
    never reads them; the wgmma route's dX loads some, whose rows are
    written as zeros, and its dW zeroes them before the last k16 step
    (``deepseek_partial``: C 240 at deepseek's widths, last slices of 1,
    49 and 13 slots)."""
    cases = {**CASES, "deepseek_partial": (4, 240, 2048, 1408,
                                           [193, 240, 0, 77])}
    E, C, D, F, counts = cases[case]
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
    w = (torch.randn(E, D, F, generator=gen, device=dev) * 0.05).bfloat16()
    dy = torch.randn(E, C, F, generator=gen, device=dev).bfloat16()
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    want = gops.gmm_bwd(x, w, cnt, dy)
    pad = torch.arange(x.shape[1], device=dev)[None] >= cnt[:, None]
    got = gops.gmm_bwd(x.masked_fill(pad[..., None], float("nan")), w, cnt,
                       dy.masked_fill(pad[..., None], float("nan")))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _offset(t, off):
    """A contiguous copy of ``t`` whose base lies ``off`` elements into
    its storage."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("which", ["none", "x", "w", "dy"])
def test_route_by_shape(dev, which):
    """The training shape's aligned operands take the wgmma route; an x, w
    or dy offset by one element (2 bytes: no TMA) takes the element route
    and still matches the plain version."""
    x, w, cnt, dy = _inputs(dev, "deepseek_down", torch.bfloat16, seed=4)
    args = {"x": x, "w": w, "dy": dy}
    if which != "none":
        args[which] = _offset(args[which], 1)
    assert gops.takes_wgmma(args["x"], args["w"], args["dy"]) == (
        which == "none")
    n0 = (gops.gmm_bwd.launches_tc, gops.gmm_bwd.launches_wgmma)
    dx, dw = gops.gmm_bwd(args["x"], args["w"], cnt, args["dy"])
    want = gmm_bwd_ref(x, w, cnt, dy)
    torch.cuda.synchronize()
    assert (gops.gmm_bwd.launches_tc, gops.gmm_bwd.launches_wgmma) == (
        n0[0] + 1, n0[1] + (which == "none"))
    pad = torch.arange(x.shape[1], device=dev)[None] >= cnt[:, None]
    assert not dx[pad].any() and not dw[cnt == 0].any()
    for got, ref in zip((dx, dw), want):
        assert _rel(got, ref) < TOL[torch.bfloat16], _rel(got, ref)


@pytest.mark.parametrize("which", ["x", "w", "dy"])
def test_float32_unaligned_operands(dev, which):
    """float32 with an x, w or dy offset by one element (4 bytes: no
    16-byte rows) takes the kernel's element loads and still matches the
    plain version, its padding rows and empty experts exact zeros."""
    x, w, cnt, dy = _inputs(dev, "deepseek_down", torch.float32, seed=5)
    args = {"x": x, "w": w, "dy": dy}
    args[which] = _offset(args[which], 1)
    dx, dw = gops.gmm_bwd(args["x"], args["w"], cnt, args["dy"])
    want = gmm_bwd_ref(x, w, cnt, dy)
    torch.cuda.synchronize()
    pad = torch.arange(x.shape[1], device=dev)[None] >= cnt[:, None]
    assert not dx[pad].any() and not dw[cnt == 0].any()
    for got, ref in zip((dx, dw), want):
        assert _rel(got, ref) < TOL[torch.float32], _rel(got, ref)


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
