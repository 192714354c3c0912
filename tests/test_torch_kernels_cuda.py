"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU: a CUDA kernel has no CPU mode, so without a card
every test here skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Cases follow ``tests/test_kernels.py`` and ``tests/test_paged_kernels.py``
(MHA/GQA/MQA, multi-layer arenas, ragged lengths, P not dividing them,
sentinel rows, int8), plus q lengths that are not a multiple of the
kernels' q tiles.  Tolerances: rel < 2e-5 in float32 (summation order),
2e-4 for int8 arenas in float32 (same dequantised values), 2e-2 in bf16
(output rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref,
)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    paged_extend_attention_ref,
)
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
