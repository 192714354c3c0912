"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU: a CUDA kernel has no CPU mode, so without a card
every test here skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Cases follow ``tests/test_kernels.py`` and ``tests/test_paged_kernels.py``
(MHA/GQA/MQA, multi-layer arenas, ragged lengths, P not dividing them,
sentinel rows, int8, the grouped GEMM's counts sweep, the SSD scan with
G 2, an initial state and a ragged mask), plus q lengths, cache lengths,
GEMM shapes and SSD chunk lengths that are not a multiple of the kernels'
tiles, a rolling-window dense cache, the attention kernels at zamba2's
head dim 80 and at seamless-m4t-large-v2's (G 1, Dh 64: flash under a
key-length mask, bidirectional with Skv below and above Sq and causal,
rows with kv_len 0 and above Skv; dense decode over a cross memory), and the SSD scan (``ops.ssd``, one launch) at the chunk
lengths and widths of mamba2-2.7b and zamba2-2.7b, with and without
checkpoints, at N 32 to 256.  bf16
takes the tensor-core flash, paged extend and GEMM kernels, float32 the
CUDA-core ones: every flash case runs through both routes (every mask,
head dims 16 to 256, GQA 4 and 5), extend at page sizes 1 to 64, the
GEMM at counts on each side of its 16- and 128-row tiles; the float32
flash and extend also give their LSE within 1e-5 of the plain version's,
the same bits on a second call, read an arena view whose rows are off 16
bytes element by element, and raise on a head dim of 18.  Paged
decode and extend run every dtype pair (q float32 or bf16, arena the same
or int8; bf16 q over int8 takes the tensor-core extend, held also with
per-page scales from 1e-3 to 1e2 under one 32-key tile and a page of
codes +-127); decode at n_log 1 to 256, so that a row's pages split
across 1 to 8 blocks, with kv_len 0, 1 and n_log * P, rows whose every split is
empty, and G 12 at head dim 192; extend up to head dim 256.  Dense decode
runs the same split kernel over a dense cache's live slots: windows,
kv_len 0 and above S, G 12 at Dh 192.  Tolerances: rel < 2e-5 in float32
attention and SSD (summation order), 1e-4 in the float32 grouped GEMM
(2048-term sums in another order), 2e-4 for int8 arenas in float32 (same
dequantised values), 2e-2 in bf16 (output rounding).  Pad steps of the
SSD scan are exact identities (the initial state back bit for bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
    paged_decode_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    paged_extend_attention_ref,
)
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models.cache_utils import quantize_page  # noqa: E402
from repro_torch.models.layers import KVSlice, dense_kv_arena  # noqa: E402
from repro_torch.models.layers import extend_attention_ref  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-9))


def _arena(dev, B, Hkv, Dh, L, P, n_log, kv_lens, quant, sentinel_rows=(),
           dtype=torch.float32):
    """Arena in which logical page j of row b holds positions [j*P,
    min((j+1)*P, kv_len)); float arenas in ``dtype``, int8 with scales."""
    rng = np.random.default_rng(0)
    N = B * n_log + 2
    k = torch.from_numpy(rng.standard_normal((N, P, L, Hkv, Dh)).astype(
        np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((N, P, L, Hkv, Dh)).astype(
        np.float32)).to(dev)
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
    sc = {}
    if quant:
        k, ks = quantize_page(k, keep_axes=(0, 2))
        v, vs = quantize_page(v, keep_axes=(0, 2))
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(dtype), v.to(dtype)
    return (k, v, torch.from_numpy(sp).to(dev), torch.from_numpy(bt).to(dev),
            sc)


# (q dtype, int8 arena) -> tolerance on max|err| / max|ref|: float32 sums
# in another order; int8 dequantised to the same values on both sides; bf16
# output and P rounding
PAIRS = [(torch.float32, False), (torch.float32, True),
         (torch.bfloat16, False), (torch.bfloat16, True)]
PAIR_IDS = ["float", "int8", "bf16", "bf16-int8"]


def _tol(qdt, quant):
    if qdt == torch.bfloat16:
        return 2e-2
    return 2e-4 if quant else 2e-5


FLASH = [
    # B, Hq, Hkv, Sq, Skv, Dh, causal, window: every case through both
    # routes (float32 CUDA cores, bf16 tensor cores)
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 8, 256, 256, 64, True, None),
    (2, 4, 1, 128, 128, 32, True, 64),
    (1, 2, 2, 128, 256, 64, True, None),     # Skv > Sq
    (2, 4, 2, 128, 128, 64, False, None),    # bidirectional
    (1, 4, 4, 64, 64, 128, True, None),
    (2, 32, 8, 100, 100, 128, True, None),   # ragged Sq
    (2, 32, 32, 100, 100, 80, True, None),   # zamba2 Dh 80
    (2, 32, 32, 128, 128, 80, True, None),
    (2, 32, 8, 72, 200, 128, True, None),    # ragged, Skv > Sq
    (2, 32, 8, 200, 200, 128, True, 64),     # window, Dh 128
    (2, 32, 8, 128, 128, 128, True, None),   # GQA 4, qwen3-4b
    (2, 10, 2, 100, 100, 128, True, None),   # GQA 5
    (1, 4, 4, 100, 100, 16, True, None),     # Dh 16
    (1, 8, 2, 100, 100, 192, True, None),    # Dh 192
    (1, 4, 2, 100, 100, 256, False, 40),     # Dh 256, window
]


def _flash_inputs(dev, case, dt, seed=0):
    B, Hq, Hkv, Sq, Skv, Dh = case[:6]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, Hq, Dh), generator=g, device=dev).to(dt)
    k = torch.randn((B, Skv, Hkv, Dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, Skv, Hkv, Dh), generator=g, device=dev).to(dt)
    return q, k, v


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_kernel(dev, case, dt):
    causal, win = case[6:]
    q, k, v = _flash_inputs(dev, case, dt)
    n0 = fops.flash_attention.launches
    out = fops.flash_attention(q, k, v, causal=causal, window=win)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=win).transpose(1, 2)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == n0 + 1
    assert _rel(out, ref) < (2e-2 if dt == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_f32_lse(dev, case):
    """The float32 route's log-sum-exp (what the backward reads) against
    the plain version's at 1e-5, beside its output at 2e-5."""
    causal, win = case[6:]
    q, k, v = _flash_inputs(dev, case, torch.float32)
    out, lse = fops._flash_forward(q, k, v, causal, win, None, True)
    ref, ref_lse = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=win, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == ref_lse.shape
    assert _rel(lse, ref_lse) < 1e-5
    assert _rel(out, ref.transpose(1, 2)) < 2e-5


# the key-length mask (encdec): B, Hq, Hkv, Sq, Skv, Dh, causal, kv_len
FLASH_KV_LEN = [
    (3, 16, 16, 512, 512, 64, False, (384, 96, 0)),       # the encoder
    (3, 16, 16, 128, 512, 64, False, (200, 512, 0)),      # cross, Skv > Sq
    (3, 16, 16, 130, 70, 64, False, (70, 33, 0)),         # Skv < Sq
    (2, 8, 2, 100, 100, 128, True, (64, 1)),              # causal
    (3, 4, 4, 40, 200, 128, False, (0, 150, 1000)),       # kv_len above Skv
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_KV_LEN)
def test_flash_attention_kv_len(dev, case, dt):
    """Both routes under a key-length mask: rows with keys match the plain
    version; a row with kv_len 0 stores 0 (the plain version gives it the
    mean of V: the serving path never reads such a row)."""
    B, Hq, Hkv, Sq, Skv, Dh, causal, kv_lens = case
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((B, Sq, Hq, Dh), generator=g, device=dev).to(dt)
    k = torch.randn((B, Skv, Hkv, Dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, Skv, Hkv, Dh), generator=g, device=dev).to(dt)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    f = fops.flash_attention
    n0 = (f.launches, f.launches_tc, dict(f.launches_kv_len))
    out = f(q, k, v, causal=causal, kv_len=kl)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        kv_len=kl).transpose(1, 2)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_tc) == (n0[0] + 1,
                                           n0[1] + (dt == torch.bfloat16))
    assert f.launches_kv_len[Sq, Skv] == n0[2].get((Sq, Skv), 0) + 1
    live = [b for b, n in enumerate(kv_lens) if n > 0]
    assert _rel(out[live], ref[live]) < (2e-2 if dt == torch.bfloat16
                                         else 2e-5)
    empty = [b for b, n in enumerate(kv_lens) if n == 0]
    assert not out[empty].any()


def test_flash_attention_bf16_rejects_head_dim(dev):
    """The bf16 route takes Dh % 16 == 0 up to 256 and raises on any other
    head dim; it is not routed to the float32 kernel."""
    q = torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16, device=dev)
    n0 = fops.flash_attention.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        fops.flash_attention(q, q, q)
    assert fops.flash_attention.launches == n0


def test_flash_attention_f32_rejects_head_dim(dev):
    """The float32 routes take Dh % 4 == 0 up to 256: a head dim of 18
    raises in flash and in paged extend, and nothing launches."""
    q = torch.zeros((1, 8, 2, 18), device=dev)
    n0 = (fops.flash_attention.launches, fops.paged_extend_attention.launches)
    with pytest.raises(ValueError, match="multiple of 4"):
        fops.flash_attention(q, q, q)
    k, v, sp, bt, sc = _arena(dev, 1, 2, 18, 1, 16, 2, (24,), False)
    ps = torch.tensor([16], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        fops.paged_extend_attention(q, k, v, sp, bt, ps, 0, **sc)
    assert (fops.flash_attention.launches,
            fops.paged_extend_attention.launches) == n0


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_f32_routes_repeat_bitwise(dev, quant):
    """Two float32 calls of each route on the same inputs give the same
    bits: flash with its LSE, and the extend over a float32 or an int8
    arena (every product an fmaf, each sum in one order, no atomics)."""
    q, k, v = _flash_inputs(dev, (2, 32, 8, 200, 200, 128), torch.float32)
    a = fops._flash_forward(q, k, v, True, None, None, True)
    b = fops._flash_forward(q, k, v, True, None, None, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    k, v, sp, bt, sc = _arena(dev, 3, 8, 128, 2, 16, 8, (104, 70, 128),
                              quant)
    q = torch.randn((3, 40, 32, 128), device=dev)
    ps = torch.tensor([64, 30, 88], dtype=torch.int32, device=dev)
    a = fops.paged_extend_attention(q, k, v, sp, bt, ps, 1, **sc)
    b = fops.paged_extend_attention(q, k, v, sp, bt, ps, 1, **sc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_attention_bf16_strided_views(dev):
    """q, k and v as slices of one fused projection, with rows that do not
    start on 16 bytes (the wrapper copies them for the kernel)."""
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((2, 100, 4 + 2 + 2, 68), generator=g,
                      device=dev).to(torch.bfloat16)[..., 4:]
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = fops.flash_attention(q, k, v)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    assert _rel(out, ref) < 2e-2


def test_tensor_core_counters(dev):
    """bf16 launches of flash attention, paged extend (over a bf16 or an
    int8 arena) and the grouped GEMM take the tensor-core kernels and
    count in ``launches_tc``; float32 launches (paged extend over a
    float32 or an int8 arena) take the CUDA-core kernels and do not."""
    g = torch.Generator(device=dev).manual_seed(4)
    ext = fops.paged_extend_attention
    for dt, quant, tc in ((torch.bfloat16, False, 1), (torch.float32, False, 0),
                          (torch.bfloat16, True, 1), (torch.float32, True, 0)):
        k, v, sp, bt, sc = _arena(dev, 1, 2, 64, 1, 16, 2, (24,), quant,
                                  dtype=dt)
        q = torch.randn((1, 8, 4, 64), generator=g, device=dev).to(dt)
        n0 = (ext.launches, ext.launches_tc)
        ext(q, k, v, sp, bt, torch.tensor([16], dtype=torch.int32,
                                          device=dev), 0, **sc)
        assert (ext.launches, ext.launches_tc) == (n0[0] + 1, n0[1] + tc)
    for dt, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        q = torch.randn((1, 64, 4, 64), generator=g, device=dev).to(dt)
        n0 = (fops.flash_attention.launches, fops.flash_attention.launches_tc)
        fops.flash_attention(q, q[:, :, :2], q[:, :, 2:])
        assert (fops.flash_attention.launches,
                fops.flash_attention.launches_tc) == (n0[0] + 1, n0[1] + tc)
        x = torch.randn((2, 32, 64), generator=g, device=dev).to(dt)
        w = torch.randn((2, 64, 64), generator=g, device=dev).to(dt)
        c = torch.tensor([32, 5], dtype=torch.int32, device=dev)
        n0 = (gops.gmm.launches, gops.gmm.launches_tc,
              gops.gmm.launches_by_capacity.get(32, 0))
        gops.gmm(x, w, c)
        assert (gops.gmm.launches, gops.gmm.launches_tc,
                gops.gmm.launches_by_capacity[32]) == (n0[0] + 1, n0[1] + tc,
                                                       n0[2] + 1)
    torch.cuda.synchronize()


DECODE = [
    # B, Hq, Hkv, Dh, L, P, n_log, kv_lens
    (2, 4, 4, 64, 1, 8, 4, (32, 17)),
    (3, 8, 2, 32, 3, 8, 4, (8, 29, 1)),
    (2, 4, 1, 16, 2, 16, 2, (5, 32)),
    (4, 32, 8, 128, 4, 16, 8, (128, 77, 1, 100)),
    (2, 10, 2, 64, 2, 16, 4, (50, 33)),                    # GQA 5
    # n_log 1, 3, 8 and 256: 1, 3, 8 and 8 splits of a row's pages
    (2, 4, 2, 64, 1, 16, 1, (16, 9)),
    (2, 4, 2, 64, 1, 16, 3, (40, 17)),
    (2, 8, 2, 128, 2, 16, 8, (128, 70)),
    (2, 8, 2, 128, 1, 16, 256, (4096, 1500)),
    (8, 32, 32, 80, 1, 16, 16, (200, 1, 87, 129, 64, 100, 3, 256)),  # 2 splits, Dh 80
    (3, 8, 2, 64, 1, 8, 6, (0, 1, 48)),                     # kv_len 0, 1, n_log * P
    # G 12 at Dh 192 (nemotron4-340b's heads): two blocks of heads (n_hc
    # 2) and 8 head dims a lane
    (2, 24, 2, 192, 2, 16, 4, (50, 33)),
    # seamless-m4t-large-v2's decoder self-attention: G 1, Dh 64
    (8, 16, 16, 64, 3, 16, 8, (80, 128, 65, 100, 72, 1, 90, 127)),
]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("case", DECODE)
def test_paged_decode_kernel(dev, case, pair):
    """Rows with kv_len 0 see no key: the kernel gives 0, the plain version
    the average over its masked keys; they are checked to be 0."""
    qdt, quant = pair
    B, Hq, Hkv, Dh, L, P, n_log, kv_lens = case
    k, v, sp, bt, sc = _arena(dev, B, Hkv, Dh, L, P, n_log, kv_lens, quant,
                              dtype=qdt)
    q = torch.randn((B, 1, Hq, Dh), device=dev).to(qdt)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    n0 = dops.paged_decode_attention.launches
    out = dops.paged_decode_attention(q, k, v, sp, bt, kl, L - 1, **sc)
    ref = paged_decode_attention_ref(q[:, 0], k, v, sp, bt, kl, L - 1, **sc)
    torch.cuda.synchronize()
    assert dops.paged_decode_attention.launches == n0 + 1
    live = [b for b, n in enumerate(kv_lens) if n > 0]
    assert _rel(out[live, 0], ref[live]) < _tol(qdt, quant)
    empty = [b for b, n in enumerate(kv_lens) if n == 0]
    assert not out[empty].any()


def test_paged_decode_splits(dev):
    """The split counts the cases above run: 1 to 8."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    got = [dops.decode_splits(n_log, B * Hkv, sms)
           for B, _, Hkv, _, _, _, n_log, _ in DECODE]
    assert min(got) == 1 and max(got) == 8 and 2 in got and 3 in got


def test_paged_decode_every_split_empty(dev):
    """At n_log 256 (8 splits) a fully sentinel row and a row with kv_len
    0 leave every split empty: both come out 0, the live row right."""
    k, v, sp, bt, _ = _arena(dev, 3, 2, 64, 1, 16, 256, (300, 300, 0),
                             False, sentinel_rows=(1,))
    q = torch.randn((3, 1, 8, 64), device=dev)
    kl = torch.tensor([300, 300, 0], dtype=torch.int32, device=dev)
    out = dops.paged_decode_attention(q, k, v, sp, bt, kl, 0)
    ref = paged_decode_attention_ref(q[:, 0], k, v, sp, bt, kl, 0)
    torch.cuda.synchronize()
    assert not out[1:].any()
    assert _rel(out[0, 0], ref[0]) < 2e-5


def test_paged_decode_back_to_back(dev):
    """Two calls in a row at different B, Hkv and split counts, read back
    after both: each right (the launch plan is per call)."""
    outs, refs = [], []
    for B, Hq, Hkv, n_log, kv_lens in ((2, 8, 2, 64, (1000, 300)),
                                       (8, 32, 32, 16, (200,) * 8)):
        k, v, sp, bt, _ = _arena(dev, B, Hkv, 64, 1, 16, n_log, kv_lens,
                                 False, dtype=torch.bfloat16)
        q = torch.randn((B, 1, Hq, 64), device=dev).to(torch.bfloat16)
        kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        outs.append(dops.paged_decode_attention(q, k, v, sp, bt, kl, 0))
        refs.append(paged_decode_attention_ref(q[:, 0], k, v, sp, bt, kl, 0))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert dops.decode_splits(64, 4, sms) != dops.decode_splits(16, 256, sms)
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert _rel(out[:, 0], ref) < 2e-2


def test_paged_decode_fully_sentinel_row(dev):
    k, v, sp, bt, _ = _arena(dev, 2, 2, 16, 1, 8, 2, (16, 16), False,
                             sentinel_rows=(1,))
    q = torch.randn((2, 1, 2, 16), device=dev)
    kl = torch.tensor([16, 1], dtype=torch.int32, device=dev)
    out = dops.paged_decode_attention(q, k, v, sp, bt, kl, 0)
    ref = paged_decode_attention_ref(q[:, 0], k, v, sp, bt, kl, 0)
    assert torch.isfinite(out).all()
    assert _rel(out[0, 0], ref[0]) < 2e-5


EXTEND = [
    # B, Hq, Hkv, Dh, L, P, n_log, S, pos
    (2, 4, 4, 32, 1, 8, 4, 8, (0, 16)),
    (2, 8, 2, 32, 2, 8, 4, 4, (5, 13)),
    (1, 4, 1, 16, 2, 16, 2, 12, (7,)),
    (3, 32, 8, 128, 3, 16, 8, 40, (0, 64, 33)),           # ragged Sq
    (2, 32, 32, 80, 1, 64, 8, 40, (64, 16)),              # zamba2 Dh 80, P 64, G 1
    (2, 10, 2, 64, 2, 16, 4, 24, (3, 20)),                # GQA 5
    (8, 32, 8, 128, 4, 16, 16, 40, (0, 16, 64, 5, 100, 0, 33, 7)),  # phase 3's offsets
    (2, 8, 2, 192, 2, 16, 6, 24, (3, 70)),                # Dh 192
    (2, 8, 2, 256, 1, 16, 4, 24, (16, 5)),                # Dh 256
    (8, 16, 16, 64, 3, 16, 8, 64, (64,) * 7 + (0,)),      # seamless: G 1, Dh 64
]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("case", EXTEND)
def test_paged_extend_kernel(dev, case, pair):
    qdt, quant = pair
    B, Hq, Hkv, Dh, L, P, n_log, S, pos = case
    k, v, sp, bt, sc = _arena(dev, B, Hkv, Dh, L, P, n_log,
                              tuple(p + S for p in pos), quant, dtype=qdt)
    q = torch.randn((B, S, Hq, Dh), device=dev).to(qdt)
    ps = torch.tensor(pos, dtype=torch.int32, device=dev)
    n0 = fops.paged_extend_attention.launches
    out = fops.paged_extend_attention(q, k, v, sp, bt, ps, L - 1, **sc)
    ref = paged_extend_attention_ref(q.transpose(1, 2), k, v, sp, bt, ps,
                                     L - 1, **sc).transpose(1, 2)
    torch.cuda.synchronize()
    assert fops.paged_extend_attention.launches == n0 + 1
    assert _rel(out, ref) < _tol(qdt, quant)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_paged_extend_fully_sentinel_row(dev, pair):
    """A row that maps no page comes out 0 (the plain version averages its
    masked keys); the other rows right."""
    qdt, quant = pair
    k, v, sp, bt, sc = _arena(dev, 3, 2, 64, 1, 16, 4, (40, 40, 40), quant,
                              sentinel_rows=(1,), dtype=qdt)
    q = torch.randn((3, 24, 8, 64), device=dev).to(qdt)
    ps = torch.tensor([16, 16, 3], dtype=torch.int32, device=dev)
    out = fops.paged_extend_attention(q, k, v, sp, bt, ps, 0, **sc)
    ref = paged_extend_attention_ref(q.transpose(1, 2), k, v, sp, bt, ps, 0,
                                     **sc).transpose(1, 2)
    torch.cuda.synchronize()
    assert not out[1].any()
    assert _rel(out[[0, 2]], ref[[0, 2]]) < _tol(qdt, quant)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_extend_bf16_rejects(dev, quant):
    """The bf16 q route, over a bf16 or an int8 arena, raises on a head dim
    that is not a multiple of 16 and on an arena view whose rows do not
    start on 16 bytes; it launches nothing."""
    n0 = fops.paged_extend_attention.launches
    k, v, sp, bt, sc = _arena(dev, 1, 2, 72, 1, 16, 2, (24,), quant,
                              dtype=torch.bfloat16)
    q = torch.zeros((1, 8, 4, 72), dtype=torch.bfloat16, device=dev)
    ps = torch.tensor([16], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        fops.paged_extend_attention(q, k, v, sp, bt, ps, 0, **sc)
    # Dh 64 seen inside rows of 72: the view's base is off by 8 elements
    k, v = k[..., 4:68], v[..., 4:68]
    q = q[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        fops.paged_extend_attention(q, k, v, sp, bt, ps, 0, **sc)
    assert fops.paged_extend_attention.launches == n0


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_extend_f32_unaligned_arena(dev, quant):
    """float32 q over an arena view whose rows do not start on 16 bytes
    (Dh 64 inside rows of 68, the base off by one element; the wrapper
    cannot copy an arena cheaply): the CUDA-core kernel reads it element
    by element, held to the plain version (2e-5; an int8 arena 2e-4)."""
    B, Hq, Hkv, L, P, S, pos = 2, 8, 2, 2, 16, 24, (40, 7)
    n_log = -(-(max(pos) + S) // P)
    k, v, sp, bt, sc = _arena(dev, B, Hkv, 68, L, P, n_log,
                              tuple(p + S for p in pos), quant)
    k, v = k[..., 1:65], v[..., 1:65]
    assert k.data_ptr() % 16 and k.stride(-1) == 1
    q = torch.randn((B, S, Hq, 64), device=dev)
    ps = torch.tensor(pos, dtype=torch.int32, device=dev)
    f = fops.paged_extend_attention
    n0 = (f.launches, f.launches_tc)
    out = f(q, k, v, sp, bt, ps, L - 1, **sc)
    ref = paged_extend_attention_ref(q.transpose(1, 2), k, v, sp, bt, ps,
                                     L - 1, **sc).transpose(1, 2)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_tc) == (n0[0] + 1, n0[1])
    assert _rel(out, ref) < _tol(torch.float32, quant)


@pytest.mark.parametrize("P", [8, 16])
def test_paged_extend_int8_scales_per_key(dev, P):
    """bf16 q over an int8 arena whose pages under one 32-key tile have k
    and v scales from 1e-3 to 1e2, one page holding codes of +-127 only:
    the tensor-core kernel applies each key's scale, held against the
    plain version at 2e-2 (bf16 output and P rounding)."""
    B, Hq, Hkv, Dh, L, S, pos = 2, 8, 2, 64, 2, 24, (40, 17)
    n_log = -(-(max(pos) + S) // P)
    k, v, sp, bt, sc = _arena(dev, B, Hkv, Dh, L, P, n_log,
                              tuple(p + S for p in pos), True)
    rng = np.random.default_rng(P)
    N = k.shape[0]
    tile = bt[0, :32 // P].long()       # the pages under row 0's first tile
    for name in ("k_scale", "v_scale"):
        sc[name] = torch.from_numpy(10.0 ** rng.uniform(
            -3, 2, (N, L)).astype(np.float32)).to(dev)
        sc[name][tile, L - 1] = torch.tensor([1e-3, 1e2, 1e-1, 1e1],
                                             device=dev)[:len(tile)]
    page = int(bt[1, 1])
    for t in (k, v):
        t[page] = torch.from_numpy(rng.choice(
            np.array([-127, 127], np.int8), t[page].shape)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, S, Hq, Dh)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    ps = torch.tensor(pos, dtype=torch.int32, device=dev)
    f = fops.paged_extend_attention
    n0 = (f.launches, f.launches_tc)
    out = f(q, k, v, sp, bt, ps, L - 1, **sc)
    ref = paged_extend_attention_ref(q.transpose(1, 2), k, v, sp, bt, ps,
                                     L - 1, **sc).transpose(1, 2)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_tc) == (n0[0] + 1, n0[1] + 1)
    assert _rel(out, ref) < 2e-2


# the dense decode cases of tests/test_kernels.py (B, Hq, Hkv, S, Dh,
# dtype), then S not a multiple of the key tile, zamba2's head dim 80,
# G 12 at Dh 192 (two blocks of heads), and 8 splits of 1 slot or less
DENSE_DECODE = [
    (2, 8, 2, 512, 64, torch.float32),
    (4, 4, 4, 256, 128, torch.bfloat16),
    (1, 16, 2, 1024, 64, torch.bfloat16),
    (3, 2, 1, 128, 32, torch.float32),
    (3, 32, 8, 100, 128, torch.float32),
    (4, 32, 32, 512, 80, torch.float32),                  # zamba2 Dh 80
    (4, 32, 32, 512, 80, torch.bfloat16),
    (2, 24, 2, 96, 192, torch.float32),
    (2, 24, 2, 96, 192, torch.bfloat16),
    (1, 4, 1, 5, 64, torch.float32),
]


def _dense_cache(dev, B, Hq, Hkv, S, Dh, dt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Hq, Dh), generator=g, device=dev).to(dt)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=dev).to(dt)
    return q, k, v


@pytest.mark.parametrize("case", DENSE_DECODE)
def test_dense_decode_kernel(dev, case):
    B, Hq, Hkv, S, Dh, dt = case
    q, k, v = _dense_cache(dev, B, Hq, Hkv, S, Dh, dt)
    kl = (torch.arange(B, dtype=torch.int32, device=dev) * 37 + S // 3) % S + 1
    n0 = (dops.decode_attention.launches, dops.paged_decode_attention.launches)
    out = dops.decode_attention(q, k, v, kl)
    ref = decode_attention_ref(q[:, 0], k, v, kl)
    torch.cuda.synchronize()
    assert (dops.decode_attention.launches,
            dops.paged_decode_attention.launches) == (n0[0] + 1, n0[1])
    assert _rel(out[:, 0], ref) < (2e-2 if dt == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_dense_decode_cross_memory(dev, dt):
    """seamless-m4t-large-v2's cross-attention at decode: G 1 at head dim
    64 over a 512-frame memory, kv_len = src_len (ragged, one row 0, one
    the whole memory), no slot_pos."""
    B, Hq, Hkv, S, Dh = 8, 16, 16, 512, 64
    q, k, v = _dense_cache(dev, B, Hq, Hkv, S, Dh, dt, seed=5)
    kl = torch.tensor([96, 384, 0, 512, 200, 97, 255, 1], dtype=torch.int32,
                      device=dev)
    out = dops.decode_attention(q, k, v, kl)
    ref = decode_attention_ref(q[:, 0], k, v, kl)
    torch.cuda.synchronize()
    assert not out[2].any()
    live = [b for b in range(B) if b != 2]
    assert _rel(out[live, 0], ref[live]) < (2e-2 if dt == torch.bfloat16
                                            else 2e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_window_and_empty_rows(dev, dt):
    """A window on a non-rolling cache (the live range starts at kv_len -
    window), kv_len 0 (every split empty: the row is 0) and kv_len above S
    (the range ends at S), over 8 splits of the row's slots."""
    B, Hq, Hkv, S, Dh = 4, 8, 2, 300, 64
    q, k, v = _dense_cache(dev, B, Hq, Hkv, S, Dh, dt, seed=3)
    kl = torch.tensor([320, 0, 45, 290], dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert dops.decode_splits(S, B * Hkv, sms) == 8
    out = dops.decode_attention(q, k, v, kl, window=40)
    ref = decode_attention_ref(q[:, 0], k, v, kl, window=40)
    torch.cuda.synchronize()
    assert not out[1].any()
    live = [0, 2, 3]
    assert _rel(out[live, 0], ref[live]) < (2e-2 if dt == torch.bfloat16
                                            else 2e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_rolling_window(dev, dt):
    """A rolling buffer of S = 48 slots (not a multiple of the key tile)
    holding the last 48 positions of a longer sequence, wrapped at
    pos % S, with a window of 40 and an empty slot."""
    B, Hq, Hkv, S, Dh = 3, 8, 2, 48, 64
    q, k, v = _dense_cache(dev, B, Hq, Hkv, S, Dh, dt, seed=1)
    kv_len = torch.tensor([130, 48, 20], dtype=torch.int32, device=dev)
    sp = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    for b, n in enumerate(kv_len.tolist()):
        p = torch.arange(max(n - S, 0), n, dtype=torch.int32, device=dev)
        sp[b, (p % S).long()] = p
    sp[1, 5] = -1
    out = dops.decode_attention(q, k, v, kv_len, slot_pos=sp, window=40)
    ref = decode_attention_ref(q[:, 0], k, v, kv_len, slot_pos=sp, window=40)
    torch.cuda.synchronize()
    assert _rel(out[:, 0], ref) < (2e-2 if dt == torch.bfloat16 else 2e-5)


# the counts sweep of tests/test_kernels.py (E 8, C 256, D 128, F 256),
# then deepseek-moe-16b's decode and prefill shapes (C 8 and 192, D 2048,
# F 1408) on 4 experts, neither C nor F a multiple of the kernel's tiles,
# then C, D and F all ragged with F not a multiple of the 8-wide vectors
GMM = [
    (8, 256, 128, 256, [0, 5, 128, 256, 129, 200, 1, 64]),
    (8, 256, 128, 256, [0] * 8),
    (8, 256, 128, 256, [256] * 8),
    (4, 8, 2048, 1408, [3, 0, 8, 1]),
    (4, 192, 2048, 1408, [192, 77, 0, 150]),
    (4, 40, 100, 44, [40, 0, 33, 1]),   # F % 8 != 0: element-wise loads
    # counts at 0, 1, tile - 1, tile, tile + 1 and C of the bf16 kernel's
    # 128-row tile (C 300: a ragged third tile; F 264 off the 128 columns)
    (8, 300, 256, 264, [0, 1, 127, 128, 129, 300, 255, 256]),
    # ... and of its 16-row tile at C <= 16
    (5, 16, 512, 384, [0, 1, 15, 16, 9]),
    (4, 300, 100, 44, [0, 127, 129, 300]),  # element-wise loads, 128-row tile
    # the float32 kernel's 64-row tiles at C 240 and deepseek's widths, and
    # D, F not multiples of 4 (its element loads)
    (4, 240, 2048, 1408, [63, 64, 65, 240]),
    (3, 70, 102, 66, [70, 5, 64]),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GMM)
def test_gmm_kernel(dev, case, dt):
    E, C, D, F, counts = case
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((E, C, D), generator=g, device=dev).to(dt)
    w = (torch.randn((E, D, F), generator=g, device=dev) * 0.05).to(dt)
    c = torch.tensor(counts, dtype=torch.int32, device=dev)
    n0 = gops.gmm.launches
    out = gops.gmm(x, w, c)
    ref = gmm_ref(x, w, c)
    torch.cuda.synchronize()
    assert gops.gmm.launches == n0 + 1
    for e, n in enumerate(counts):
        assert not out[e, n:].any()          # padding rows exactly zero
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert _rel(out, ref) < tol


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_dense_extend_through_the_paged_kernel(dev, dt):
    """Extend over a dense per-slot cache (the snapshot restore) runs the
    paged extend kernel over the cache seen as an arena: zamba2's 32 heads
    of 80, a 512-slot cache, rows at different offsets, one riding along
    at pos = S (nothing valid past its cache, output discarded)."""
    B, H, Dh, S_c, S = 3, 32, 80, 512, 40
    g = torch.Generator(device=dev).manual_seed(3)
    k = torch.randn((B, S_c, H, Dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, S_c, H, Dh), generator=g, device=dev).to(dt)
    pos = torch.tensor([64, 16, S_c], dtype=torch.int32, device=dev)
    slots = torch.arange(S_c, dtype=torch.int32, device=dev)
    sp = torch.where(slots[None] < pos[:, None] + S, slots[None], -1)
    cache = KVSlice(k, v, sp.contiguous())
    q = torch.randn((B, S, H, Dh), generator=g, device=dev).to(dt)
    q_pos = pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)
    out = fops.paged_extend_attention(q, *dense_kv_arena(cache), pos, 0)
    ref = extend_attention_ref(q, k, v, sp, q_pos)
    torch.cuda.synchronize()
    assert _rel(out[:2], ref[:2]) < (2e-2 if dt == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S_c", [200, 101])
def test_dense_extend_odd_cache_length(dev, S_c, dt):
    """Extend over a dense cache whose length is not a multiple of 64:
    ``dense_kv_arena`` pages it by gcd(S_c, 64), 8 slots at 200 and 1 at
    101, with GQA 4 at Dh 128."""
    B, Hq, Hkv, Dh, S = 2, 32, 8, 128, 24
    g = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn((B, S_c, Hkv, Dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, S_c, Hkv, Dh), generator=g, device=dev).to(dt)
    pos = torch.tensor([S_c - S, 13], dtype=torch.int32, device=dev)
    slots = torch.arange(S_c, dtype=torch.int32, device=dev)
    sp = torch.where(slots[None] < pos[:, None] + S, slots[None], -1)
    cache = KVSlice(k, v, sp.contiguous())
    q = torch.randn((B, S, Hq, Dh), generator=g, device=dev).to(dt)
    q_pos = pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)
    arena = dense_kv_arena(cache)
    assert arena[0].shape[1] == (8 if S_c == 200 else 1)
    out = fops.paged_extend_attention(q, *arena, pos, 0)
    ref = extend_attention_ref(q, k, v, sp, q_pos)
    torch.cuda.synchronize()
    assert _rel(out, ref) < (2e-2 if dt == torch.bfloat16 else 2e-5)


def _ssd_inputs(dev, Bb, S, H, P, G, N, seed=0):
    """x (B, S, H, P), dt (B, S, H), A_log (H,), B/C (B, S, G, N) float32 on
    ``dev``, drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(  # noqa: E731
        rng.standard_normal(sh).astype(np.float32)).to(dev)
    x = f(Bb, S, H, P)
    dt = torch.nn.functional.softplus(f(Bb, S, H) * 0.5)
    A_log = torch.from_numpy(rng.uniform(0.0, 1.5, H).astype(
        np.float32)).to(dev)
    return x, dt, A_log, f(Bb, S, G, N) * 0.3, f(Bb, S, G, N) * 0.3


SSD_CHUNKS = [
    # Bb, S, H, P, G, N, Q: mamba2-2.7b (H 80, P 64, N 128) and zamba2-2.7b
    # (N 64) at every chunk length the main paths give, a degenerate Q 1,
    # G 2 with Q off the 16-step sub-chunk, Q 300 (sub-chunks of 16 and a
    # ragged 12)
    (1, 64, 80, 64, 1, 128, 1),
    (2, 128, 80, 64, 1, 128, 16),
    (2, 128, 80, 64, 1, 64, 16),
    (1, 128, 80, 64, 1, 128, 32),
    (1, 128, 80, 64, 1, 64, 64),
    (1, 256, 80, 64, 1, 128, 128),
    (1, 256, 80, 64, 1, 128, 256),
    (1, 256, 80, 64, 1, 64, 256),
    (2, 96, 4, 16, 2, 32, 24),
    (1, 300, 4, 64, 1, 128, 300),
    # P off the 64-row tile (N 64, 128); N 192 and 256, the widest state
    # tiles
    (2, 64, 4, 80, 2, 128, 16),
    (1, 48, 2, 136, 1, 64, 24),
    (1, 64, 4, 64, 1, 192, 16),
    (1, 64, 2, 32, 1, 256, 32),
]


@pytest.mark.parametrize("case", SSD_CHUNKS)
def test_ssd_chunks_kernel(dev, case):
    """``ops.ssd`` (one launch of the scan) against its plain version
    ``ssd_ref`` with and without checkpoints: y, the final state and the
    state after every chunk."""
    Bb, S, H, P, G, N, Q = case
    inp = _ssd_inputs(dev, Bb, S, H, P, G, N)
    n0 = sops.ssd.launches
    y, h, ck = sops.ssd(*inp, chunk=Q, checkpoints=True)
    y2, h2 = sops.ssd(*inp, chunk=Q)
    y_r, h_r, ck_r = ssd_ref(*inp, chunk=Q, checkpoints=True)
    torch.cuda.synchronize()
    assert sops.ssd.launches == n0 + 2
    assert tuple(ck.shape) == (Bb, S // Q, H, P, N)
    for got, ref in ((y, y_r), (h, h_r), (ck, ck_r), (y2, y_r), (h2, h_r)):
        assert _rel(got, ref) < 2e-5


def test_ssd_scan_reads_bf16_inputs(dev):
    """x, B and C in bfloat16 (the full-width models' dtype) are read as
    stored and widened exactly: the result is the float32 scan of the
    same values."""
    inp = list(_ssd_inputs(dev, 2, 64, 8, 64, 1, 128, seed=2))
    for i in (0, 3, 4):
        inp[i] = inp[i].to(torch.bfloat16)
    y, h, ck = sops.ssd(*inp, chunk=16, checkpoints=True)
    y_r, h_r, ck_r = ssd_ref(*inp, chunk=16, checkpoints=True)
    torch.cuda.synchronize()
    for got, ref in ((y, y_r), (h, h_r), (ck, ck_r)):
        assert _rel(got, ref) < 2e-5


def test_ssd_pad_rows_are_exact_identities(dev):
    """Rows whose every step is masked (the rows riding along a snapshot
    restore's extend): ``ops.ssd`` hands the initial state back bit for
    bit, as the final state and at every checkpoint."""
    Bb, S, H, P, G, N = 3, 64, 80, 64, 1, 128
    x, dt, A_log, B, C = _ssd_inputs(dev, Bb, S, H, P, G, N, seed=1)
    mask = torch.ones((Bb, S), dtype=torch.bool, device=dev)
    mask[1] = False
    init = torch.randn((Bb, H, P, N), device=dev)
    _, final, ck = sops.ssd(x, dt, A_log, B, C, chunk=16,
                            initial_state=init, mask=mask, checkpoints=True)
    _, final2 = sops.ssd(x, dt, A_log, B, C, chunk=16, initial_state=init,
                         mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(final[1], init[1]) and torch.equal(final2[1], init[1])
    assert all(torch.equal(ck[1, c], init[1]) for c in range(S // 16))


def test_ssd_rejects_shapes(dev):
    """P or N not a multiple of 4, or above 256, raises; nothing launches."""
    n0 = sops.ssd.launches
    for P, N in ((6, 16), (8, 18), (260, 16), (8, 260)):
        inp = _ssd_inputs(dev, 1, 16, 2, P, 1, N)
        with pytest.raises(ValueError, match="multiples of 4"):
            sops.ssd(*inp, chunk=16)
    assert sops.ssd.launches == n0


# the SSD cases of tests/test_kernels.py: G 2 at three chunk lengths, an
# initial state, a ragged pad mask (full row, ragged row, one real step)
@pytest.mark.parametrize("case", ["g2-16", "g2-32", "g2-64", "init",
                                  "mask"])
def test_ssd_matches_chunked_oracle(dev, case):
    if case.startswith("g2"):
        Bb, S, H, P, G, N, chunk = 2, 128, 4, 16, 2, 32, int(case[3:])
    else:
        Bb, S, H, P, G, N, chunk = (1, 64, 2, 8, 1, 16, 16) if case == \
            "init" else (3, 64, 2, 8, 1, 16, 16)
    x, dt, A_log, B, C = _ssd_inputs(dev, Bb, S, H, P, G, N, seed=4)
    kw = {}
    if case == "init":
        kw["initial_state"] = torch.randn((Bb, H, P, N), device=dev) * 0.2
    if case == "mask":
        lengths = torch.tensor([64, 17, 1], device=dev)
        kw["mask"] = torch.arange(S, device=dev)[None] < lengths[:, None]
    y_k, h_k, ck_k = sops.ssd(x, dt, A_log, B, C, chunk=chunk,
                              checkpoints=True, **kw)
    y_r, h_r, ck_r = ssd_chunked(x, dt, A_log, B, C, chunk=chunk,
                                 checkpoints=True, **kw)
    torch.cuda.synchronize()
    assert _rel(h_k, h_r) < 2e-5 and _rel(ck_k, ck_r) < 2e-5
    if case == "mask":
        for b, L in enumerate([64, 17, 1]):
            assert _rel(y_k[b, :L], y_r[b, :L]) < 2e-5
    else:
        assert _rel(y_k, y_r) < 2e-5
