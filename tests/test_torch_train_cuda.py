"""Training on the card: flash attention's backward kernel against its
plain version, and train steps through it.

Needs an NVIDIA GPU: a CUDA kernel has no CPU mode, so without a card
every test here skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

The backward kernel (``csrc/flash_attention_bwd.cu``) is held against
``flash_attention_bwd_ref`` on the same q, k, v, out, dout and LSE (the
forward kernel's), through both routes (bf16: the tensor-core kernels;
float32: the CUDA-core kernels), under every mask the forward takes:
causal (also at an Sq and Skv that no tile size divides), a sliding
window (also one that crosses several q tiles), bidirectional with a
key-length mask, cross-attention (Sq below and above Skv), GQA 4, head
dims 32 to 256.  Tolerances: rel < 1e-4 in float32 (sums over up to G x
Sq terms in another order), 2e-2 in bf16 (the kernels round P, dS and
their outputs to bf16; the plain version stays float32).
The forward's LSE is held to the plain version's at 1e-5 (float32) and
1e-3 (bf16, tensor-core products) absolute.  Float32 smoke train steps of
qwen3-4b, mamba2-2.7b and zamba2-2.7b (the last two through the SSD
scan's backward kernel) and deepseek-moe-16b (through the grouped GEMM's
backward kernels, on CUDA cores) give the CPU's loss, xent and grad norm
within 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    flash_attention_bwd_ref,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import jax_leaves, params_from_numpy  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_adam_state  # noqa: E402
from repro_torch.train.train_step import TrainState, build_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

# (B, Sq, Skv, Hq, Hkv, Dh, causal, window, kv_len)
CASES = {
    "causal": (2, 100, 100, 8, 2, 64, True, None, None),
    "window": (2, 130, 130, 4, 4, 32, True, 33, None),
    "bidir_kv_len": (2, 70, 70, 4, 1, 64, False, None, (50, 70)),
    "cross_short_q": (2, 40, 90, 4, 4, 64, False, None, (60, 90)),
    "cross_long_q": (2, 90, 40, 4, 2, 32, False, None, (17, 40)),
    "causal_suffix_q": (1, 48, 100, 4, 2, 64, True, None, None),
    "gqa4_dh128": (1, 160, 160, 16, 4, 128, True, None, None),
    "dh80": (2, 96, 96, 4, 4, 80, True, None, None),
    "dh256": (1, 70, 70, 4, 2, 256, True, None, None),
    "causal_ragged": (2, 75, 75, 8, 4, 128, True, None, None),
    "window_wide": (1, 300, 300, 4, 2, 128, True, 100, None),
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-9))


def _inputs(dev, case, dtype, seed=0):
    B, Sq, Skv, Hq, Hkv, Dh, causal, window, kv_len = CASES[case]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)
    q, k, v = t(B, Sq, Hq, Dh), t(B, Skv, Hkv, Dh), t(B, Skv, Hkv, Dh)
    dout = t(B, Sq, Hq, Dh)
    kl = (None if kv_len is None
          else torch.tensor(kv_len, dtype=torch.int32, device=dev))
    return q, k, v, dout, dict(causal=causal, window=window, kv_len=kl)


def _bhsd(*ts):
    return [t.transpose(1, 2) for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain(dev, case, dtype):
    q, k, v, dout, mask = _inputs(dev, case, dtype)
    out, lse = fops._flash_forward(q, k, v, mask["causal"], mask["window"],
                                   mask["kv_len"], True)
    _, lse_ref = attention_ref(*_bhsd(q, k, v), return_lse=True, **mask)
    atol = 1e-5 if dtype == torch.float32 else 1e-3
    assert float((lse - lse_ref).abs().max()) < atol * max(
        1.0, float(lse_ref.abs().max()))
    n0 = fops.flash_attention_bwd.launches
    tc0 = fops.flash_attention_bwd.launches_tc
    got = fops.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    torch.cuda.synchronize()
    assert fops.flash_attention_bwd.launches == n0 + 1
    assert (fops.flash_attention_bwd.launches_tc
            == tc0 + (dtype == torch.bfloat16))
    want = flash_attention_bwd_ref(*_bhsd(q, k, v, out, dout), lse, **mask)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        err = _rel(g, w.transpose(1, 2))
        assert err < TOL[dtype], (name, err)


def test_backward_kernel_is_deterministic(dev):
    q, k, v, dout, mask = _inputs(dev, "gqa4_dh128", torch.bfloat16)
    out, lse = fops._flash_forward(q, k, v, True, None, None, True)
    a = fops.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    b = fops.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tensor_core_route_refuses_a_head_dim_it_does_not_take(dev):
    """bf16 takes Dh % 16 == 0 only: Dh 72 raises (no fallback), while
    float32 at Dh 72 runs on the CUDA-core kernels."""
    B, S, H, Dh = 1, 40, 2, 72
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn((B, S, H, Dh), generator=gen, device=dev)
                     for _ in range(4))
    out, lse = fops._flash_forward(q, k, v, True, None, None, True)
    n0 = fops.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        fops.flash_attention_bwd(*(t.to(torch.bfloat16)
                                   for t in (q, k, v, out, dout)), lse)
    assert fops.flash_attention_bwd.launches == n0
    fops.flash_attention_bwd(q, k, v, out, dout, lse)
    torch.cuda.synchronize()
    assert fops.flash_attention_bwd.launches == n0 + 1


def test_autograd_runs_the_kernels(dev):
    q, k, v, dout, mask = _inputs(dev, "bidir_kv_len", torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fops.flash_attention.launches, fops.flash_attention_bwd.launches
    out = fops.flash_attention(*leaves, **mask)
    out.backward(dout)
    assert fops.flash_attention.launches == f0 + 1
    assert fops.flash_attention_bwd.launches == b0 + 1
    _, lse = fops._flash_forward(q, k, v, False, None, mask["kv_len"], True)
    want = fops.flash_attention_bwd(q, k, v, out.detach(), dout, lse, **mask)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_no_grad_forward_writes_no_lse(dev, monkeypatch):
    """Serving launches pass a null LSE pointer and save nothing; the paged
    extend route (rows 2 and 2b) is the tensor-core kernel as before."""
    seen = []
    kernel = _build.kernel

    def spy(name, signature):
        fn = kernel(name, signature)
        if name != "rt_flash_attention":
            return fn
        return lambda *args: seen.append(args[-2]) or fn(*args)
    monkeypatch.setattr(fops._build, "kernel", spy)
    q, k, v, _, mask = _inputs(dev, "causal", torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        a = fops.flash_attention(*leaves, **mask)
    with torch.inference_mode():
        b = fops.flash_attention(q, k, v, **mask)
    c = fops.flash_attention(q, k, v, **mask)      # nothing requires grad
    d = fops.flash_attention(*leaves, **mask)      # training: LSE written
    assert seen[:3] == [None, None, None] and seen[3] is not None
    assert a.grad_fn is None and c.grad_fn is None and d.grad_fn is not None
    assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    # paged extend over a bf16 arena still takes the tensor-core kernel
    B, P, n_log, Hkv, Dh = 2, 16, 4, 2, 64
    arena = torch.randn((B * n_log, P, 1, Hkv, Dh), device=dev,
                        dtype=torch.bfloat16)
    sp = (torch.arange(n_log * P, device=dev, dtype=torch.int32)
          .view(n_log, P, 1).repeat(B, 1, 1))
    bt = torch.arange(B * n_log, device=dev, dtype=torch.int32).view(B, n_log)
    qe = torch.randn((B, 8, 8, Dh), device=dev, dtype=torch.bfloat16)
    n_tc = fops.paged_extend_attention.launches_tc
    fops.paged_extend_attention(qe, arena, arena, sp, bt,
                                torch.full((B,), 40, device=dev,
                                           dtype=torch.int32), 0)
    assert fops.paged_extend_attention.launches_tc == n_tc + 1


def _smoke_run(device, steps=2, arch="qwen3-4b"):
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    model = Model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    params = params_from_numpy(
        {k: v for k, v in _np_tree(params).items()}, dtype=torch.float32,
        device=device)
    state = TrainState(params=params, opt=init_adam_state(params,
                                                          OptConfig()))
    step = build_train_step(model, OptConfig(lr=1e-3, warmup_steps=1))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(steps):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65)).astype(
            np.int32)).to(device)
        state, m = step(state, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def test_float32_train_steps_match_the_cpu(dev):
    f0 = fops.flash_attention_bwd.launches
    tc0 = fops.flash_attention_bwd.launches_tc
    card, _ = _smoke_run(dev)
    assert fops.flash_attention_bwd.launches > f0
    assert fops.flash_attention_bwd.launches_tc == tc0   # CUDA cores only
    cpu, _ = _smoke_run("cpu")
    for c, h in zip(card, cpu):
        for k in ("loss", "xent", "grad_norm"):
            assert abs(c[k] - h[k]) <= 1e-5 * abs(h[k]), (k, c[k], h[k])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_float32_ssm_train_steps_match_the_cpu(dev, arch):
    """mamba2 (ssm) and zamba2 (hybrid) train on the card through the SSD
    scan's backward kernel (zamba2's shared attention through the float32
    flash backward): loss, xent and grad norm equal to the CPU's plain
    versions within 1e-5 relative, float32 both sides."""
    b0 = sops.ssd_bwd.launches
    card, _ = _smoke_run(dev, arch=arch)
    assert sops.ssd_bwd.launches > b0
    cpu, _ = _smoke_run("cpu", arch=arch)
    for c, h in zip(card, cpu):
        for k in ("loss", "xent", "grad_norm"):
            assert abs(c[k] - h[k]) <= 1e-5 * abs(h[k]), (k, c[k], h[k])


def test_float32_moe_train_steps_match_the_cpu(dev):
    """deepseek-moe-16b (a dense layer, then MoE layers) trains on the card
    through the grouped GEMM's backward kernels, every launch on the
    CUDA-core route in float32: loss, xent and grad norm equal to the
    CPU's plain versions within 1e-5 relative."""
    b0, tc0 = gops.gmm_bwd.launches, gops.gmm_bwd.launches_tc
    dx0, dw0 = gops.gmm_bwd.launches_dx, gops.gmm_bwd.launches_dw
    card, _ = _smoke_run(dev, arch="deepseek-moe-16b")
    assert gops.gmm_bwd.launches > b0
    assert gops.gmm_bwd.launches_tc == tc0             # CUDA cores only
    assert gops.gmm_bwd.launches_dx > dx0 and gops.gmm_bwd.launches_dw > dw0
    cpu, _ = _smoke_run("cpu", arch="deepseek-moe-16b")
    for c, h in zip(card, cpu):
        for k in ("loss", "xent", "grad_norm"):
            assert abs(c[k] - h[k]) <= 1e-5 * abs(h[k]), (k, c[k], h[k])


def test_train_steps_on_the_card_are_deterministic(dev):
    a, sa = _smoke_run(dev)
    b, sb = _smoke_run(dev)
    assert a == b
    for x, y in zip(jax_leaves(sa.params), jax_leaves(sb.params)):
        assert torch.equal(x, y)
