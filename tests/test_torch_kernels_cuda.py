"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU: a CUDA kernel has no CPU mode, so without a card
every test here skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Cases follow ``tests/test_kernels.py`` and ``tests/test_paged_kernels.py``
(MHA/GQA/MQA, multi-layer arenas, ragged lengths, P not dividing them,
sentinel rows, int8, the grouped GEMM's counts sweep), plus q lengths,
cache lengths and GEMM shapes that are not a multiple of the kernels'
tiles, and a rolling-window dense cache.  Tolerances: rel < 2e-5 in
float32 attention (summation order), 1e-4 in the float32 grouped GEMM
(2048-term sums in another order), 2e-4 for int8 arenas in float32 (same
dequantised values), 2e-2 in bf16 (output rounding).
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
from repro_torch.models.cache_utils import quantize_page  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-9))


def _arena(dev, B, Hkv, Dh, L, P, n_log, kv_lens, quant, sentinel_rows=()):
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
    return (k, v, torch.from_numpy(sp).to(dev), torch.from_numpy(bt).to(dev),
            sc)


FLASH = [
    # B, Hq, Hkv, Sq, Skv, Dh, causal, window, dtype
    (2, 4, 2, 128, 128, 64, True, None, torch.float32),
    (1, 8, 8, 256, 256, 64, True, None, torch.bfloat16),
    (2, 4, 1, 128, 128, 32, True, 64, torch.bfloat16),
    (1, 2, 2, 128, 256, 64, True, None, torch.float32),
    (2, 4, 2, 128, 128, 64, False, None, torch.float32),
    (1, 4, 4, 64, 64, 128, True, None, torch.float32),
    (2, 32, 8, 100, 100, 128, True, None, torch.float32),   # ragged Sq
]


@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_kernel(dev, case):
    B, Hq, Hkv, Sq, Skv, Dh, causal, win, dt = case
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, Sq, Hq, Dh), generator=g, device=dev).to(dt)
    k = torch.randn((B, Skv, Hkv, Dh), generator=g, device=dev).to(dt)
    v = torch.randn((B, Skv, Hkv, Dh), generator=g, device=dev).to(dt)
    n0 = fops.flash_attention.launches
    out = fops.flash_attention(q, k, v, causal=causal, window=win)
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=win).transpose(1, 2)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == n0 + 1
    assert _rel(out, ref) < (2e-2 if dt == torch.bfloat16 else 2e-5)


DECODE = [
    # B, Hq, Hkv, Dh, L, P, n_log, kv_lens
    (2, 4, 4, 64, 1, 8, 4, (32, 17)),
    (3, 8, 2, 32, 3, 8, 4, (8, 29, 1)),
    (2, 4, 1, 16, 2, 16, 2, (5, 32)),
    (4, 32, 8, 128, 4, 16, 8, (128, 77, 1, 100)),
]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", DECODE)
def test_paged_decode_kernel(dev, case, quant):
    B, Hq, Hkv, Dh, L, P, n_log, kv_lens = case
    k, v, sp, bt, sc = _arena(dev, B, Hkv, Dh, L, P, n_log, kv_lens, quant)
    q = torch.randn((B, 1, Hq, Dh), device=dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    out = dops.paged_decode_attention(q, k, v, sp, bt, kl, L - 1, **sc)
    ref = paged_decode_attention_ref(q[:, 0], k, v, sp, bt, kl, L - 1, **sc)
    torch.cuda.synchronize()
    assert _rel(out[:, 0], ref) < (2e-4 if quant else 2e-5)


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
]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", EXTEND)
def test_paged_extend_kernel(dev, case, quant):
    B, Hq, Hkv, Dh, L, P, n_log, S, pos = case
    k, v, sp, bt, sc = _arena(dev, B, Hkv, Dh, L, P, n_log,
                              tuple(p + S for p in pos), quant)
    q = torch.randn((B, S, Hq, Dh), device=dev)
    ps = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = fops.paged_extend_attention(q, k, v, sp, bt, ps, L - 1, **sc)
    ref = paged_extend_attention_ref(q.transpose(1, 2), k, v, sp, bt, ps,
                                     L - 1, **sc).transpose(1, 2)
    torch.cuda.synchronize()
    assert _rel(out, ref) < (2e-4 if quant else 2e-5)


# the dense decode cases of tests/test_kernels.py (B, Hq, Hkv, S, Dh,
# dtype), then S not a multiple of the 32-slot key tile
DENSE_DECODE = [
    (2, 8, 2, 512, 64, torch.float32),
    (4, 4, 4, 256, 128, torch.bfloat16),
    (1, 16, 2, 1024, 64, torch.bfloat16),
    (3, 2, 1, 128, 32, torch.float32),
    (3, 32, 8, 100, 128, torch.float32),
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
    n0 = dops.decode_attention.launches
    out = dops.decode_attention(q, k, v, kl)
    ref = decode_attention_ref(q[:, 0], k, v, kl)
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == n0 + 1
    assert _rel(out[:, 0], ref) < (2e-2 if dt == torch.bfloat16 else 2e-5)


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
