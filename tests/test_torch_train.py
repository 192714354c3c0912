"""The port's training substrate against the JAX package's (CPU, float32).

Twins of ``tests/test_train.py`` (AdamW against numpy, clipping,
microbatch equivalence, ``resolve_microbatch`` under hypothesis, error
feedback, compression learns, determinism), then the two packages side by
side:

* AdamW, the schedule, the clip and the int8 error feedback on the same
  random trees agree with JAX's to 1e-6.
* For each of qwen3-4b, deepseek-moe-16b, mamba2-2.7b, zamba2-2.7b and
  seamless-m4t-large-v2 at smoke size in float32, on JAX's
  ``Model.init(PRNGKey(0))`` weights (``params_from_numpy``) and one
  batch: ``loss``, ``xent`` and ``aux`` agree to 1e-5 relative, every
  gradient leaf to 1e-4 (relative to the leaf's largest entry), and the
  params after 3 train steps to 1e-5 (per leaf, relative to its largest
  entry).  The 3 steps run JAX's default ``OptConfig``, whose warmup
  keeps the learning rate at 3e-6 .. 9e-6: Adam divides each gradient
  entry by its own RMS, so an entry whose float32 gradient is mostly
  rounding noise moves by up to the learning rate either way, and the
  comparison of parameters measures that noise times the learning rate.
  At a learning rate of 1e-3 the 3 steps' losses are held to 1e-5.
* A microbatched step (microbatch 2) and a step with int8 compression
  agree with JAX's on the same state.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")  # keep collection alive without the dep
torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
import hypothesis.strategies as st  # noqa: E402

from repro.configs.base import ShapeConfig, smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro.train import grad_compress as j_gc  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    jax_leaves,
    params_from_numpy,
    tree_map,
)
from repro_torch.train import grad_compress  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptConfig,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    init_adam_state,
)
from repro_torch.train.train_step import (  # noqa: E402
    TrainState,
    _split_microbatches,
    build_train_step,
    init_train_state,
    resolve_microbatch,
    step_cost,
)

FAMILIES = ["qwen3-4b", "deepseek-moe-16b", "mamba2-2.7b", "zamba2-2.7b",
            "seamless-m4t-large-v2"]
_CACHE = {}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tiny_model():
    cfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(
        num_layers=2, d_model=64, d_ff=128, num_heads=2, num_kv_heads=1,
        head_dim=32, vocab=128)
    return cfg, Model(cfg)


def _bridge(jp, model):
    return params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                          jp), dtype=model.dtype, device="cpu",
                             specs=model.param_specs())


# ---------------------------------------------------------------------------
# twins of tests/test_train.py
# ---------------------------------------------------------------------------
def test_adamw_matches_numpy_reference():
    """One AdamW step vs a straight numpy implementation."""
    cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=10**9,
                    weight_decay=0.1, grad_clip=1e9, min_lr_ratio=1.0)
    w0 = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    p = {"w": torch.tensor(w0)}
    g = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    st_ = init_adam_state(p, cfg)
    new_p, new_st, m = adamw_update(p, g, st_, cfg)

    gw = g["w"].numpy()
    m1 = 0.1 * gw
    v1 = 0.05 * gw**2
    mh = m1 / (1 - 0.9)
    vh = v1 / (1 - 0.95)
    delta = mh / (np.sqrt(vh) + cfg.eps) + 0.1 * w0
    ref = w0 - 1e-2 * delta
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-5)
    assert int(new_st.step) == 1
    assert new_p["w"] is p["w"]                      # updated in place


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-5)


def test_microbatch_equivalence():
    """mb=1 and mb=4 produce (nearly) the same training trajectory."""
    cfg, _ = _tiny_model()
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    pipe = SyntheticPipeline(DataConfig(kind="bigram", vocab=64), cfg,
                             TShape("t", "train", 16, 8), device="cpu")
    losses = {}
    for mb in (1, 4):
        m2 = Model(cfg.replace(microbatch=mb))
        state = init_train_state(m2, torch.Generator().manual_seed(0), opt)
        step = build_train_step(m2, opt)
        for i in range(3):
            state, metrics = step(state, pipe.get_batch(i))
        losses[mb] = float(metrics["xent"])
    # bf16 params: accumulation-order effects allow small drift
    assert abs(losses[1] - losses[4]) < 0.05, losses


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 64), st.integers(1, 512), st.integers(1, 64))
def test_resolve_microbatch_properties(want, B, dp):
    n = resolve_microbatch(want, B, dp)
    assert n == j_ts.resolve_microbatch(want, B, dp)
    assert 1 <= n <= max(want, 1)
    assert B % n == 0
    if B % dp == 0:
        assert (B // n) % dp == 0


def test_compressed_psum_with_error_feedback_converges():
    """EF compression: the EF buffer carries the residual so the sum over
    steps stays unbiased."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    ef = torch.zeros_like(x)
    total_c = torch.zeros_like(x)
    total_t = torch.zeros_like(x)
    for i in range(20):
        g = x * (1 + 0.1 * i)
        q, s = grad_compress.quantize_int8(g + ef)
        deq = grad_compress.dequantize_int8(q, s)
        ef = (g + ef) - deq
        total_c = total_c + deq
        total_t = total_t + g
    np.testing.assert_allclose((total_c + ef).numpy(), total_t.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_train_step_with_compression_learns():
    cfg, model = _tiny_model()
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=200)
    pipe = SyntheticPipeline(DataConfig(kind="bigram", vocab=64), cfg,
                             TShape("t", "train", 16, 16), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), opt,
                             compress=True)
    step = build_train_step(model, opt, compress=True)
    first = last = None
    for i in range(40):
        state, m = step(state, pipe.get_batch(i))
        if first is None:
            first = float(m["xent"])
        last = float(m["xent"])
    assert last < first - 0.5, (first, last)


def test_determinism():
    cfg, model = _tiny_model()
    opt = OptConfig()
    pipe = SyntheticPipeline(DataConfig(kind="bigram", vocab=64), cfg,
                             TShape("t", "train", 16, 4), device="cpu")
    outs = []
    for _ in range(2):
        state = init_train_state(model, torch.Generator().manual_seed(0), opt)
        step = build_train_step(model, opt)
        for i in range(2):
            state, m = step(state, pipe.get_batch(i))
        outs.append(float(m["xent"]))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the optimizer and compression against JAX's
# ---------------------------------------------------------------------------
def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 2, 4)}}
    draw = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p = jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    g = jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    return p, g


@pytest.mark.parametrize("clip", [1e9, 0.5], ids=["unclipped", "clipped"])
def test_adamw_steps_match_jax(clip):
    p, g = _trees()
    jcfg = j_opt.OptConfig(lr=1e-2, warmup_steps=3, total_steps=10,
                           grad_clip=clip)
    tcfg = OptConfig(lr=1e-2, warmup_steps=3, total_steps=10, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, p)
    jst = j_opt.init_adam_state(jp, jcfg)
    tp = tree_map(torch.from_numpy, p)
    tst = init_adam_state(tp, tcfg)
    for i in range(4):
        gi = jax.tree.map(lambda x: x * (1 + i), g)
        jp, jst, jm = j_opt.adamw_update(jp, jax.tree.map(jnp.asarray, gi),
                                         jst, jcfg)
        tp, tst, tm = adamw_update(tp, tree_map(torch.from_numpy, gi), tst,
                                   tcfg)
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
    for a, b in zip(jax_leaves(tp), jax.tree.leaves(jp)):
        assert _rel(a.numpy(), b) < 1e-6
    for a, b in zip(jax_leaves(tst.m) + jax_leaves(tst.v),
                    jax.tree.leaves(jst.m) + jax.tree.leaves(jst.v)):
        assert _rel(a.numpy(), b) < 1e-6
    assert int(tst.step) == int(jst.step) == 4


def test_cosine_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    js, ts = j_opt.cosine_schedule(j_opt.OptConfig(**cfg)), \
        cosine_schedule(OptConfig(**cfg))
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        a = float(ts(torch.tensor(s, dtype=torch.int32)))
        b = float(js(jnp.int32(s)))
        assert abs(a - b) <= 1e-7 * max(abs(b), 1e-12), s


def test_ef_compression_matches_jax():
    _, g = _trees(1)
    jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
    tg = tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), g)
    jef = j_gc.init_ef_state(jg)
    tef = grad_compress.init_ef_state(tg)
    for _ in range(3):
        jc, jef = j_gc.apply_ef_compression(jg, jef)
        tc, tef = grad_compress.apply_ef_compression(tg, tef)
        for a, b in zip(jax_leaves(tc) + jax_leaves(tef),
                        jax.tree.leaves(jc) + jax.tree.leaves(jef)):
            assert a.dtype == torch.bfloat16
            assert _rel(_np(a), _np(b)) < 1e-2      # bf16 rounding of both
        # the codes themselves agree exactly on float32 input
    x = np.random.default_rng(3).standard_normal(300).astype(np.float32)
    jq, js = j_gc.quantize_int8(jnp.asarray(x))
    tq, ts = grad_compress.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def test_split_microbatches_and_step_cost():
    batch = {"tokens": torch.arange(24).view(4, 6),
             "labels": torch.arange(24).view(4, 6) + 1}
    parts = _split_microbatches(batch, 2)
    assert [p["tokens"][:, 0].tolist() for p in parts] == [[0, 6], [12, 18]]
    cfg = t_smoke_config(t_get_arch("qwen3-4b"))
    model = Model(cfg)
    c1 = step_cost(model, OptConfig(), batch)
    N = model.n_params()
    attn = 6.0 * cfg.num_layers * 4 * 36 * cfg.num_heads * cfg.head_dim
    assert c1["flops"] == 6.0 * N * 24 + attn
    # bf16 params and grads, float32 moments; one microbatch
    assert c1["bytes"] == 4 * 2 * N + (2 * 2 + 4 + 4 + 2 + 4 + 4) * N
    c2 = step_cost(Model(cfg.replace(microbatch=2)), OptConfig(), batch)
    assert c2["bytes"] == c1["bytes"] + 4 * 2 * N + 2 * (8 * N + 2 * N) \
        + 4 * N + 2 * N
    assert c2["arg_bytes"] == c1["arg_bytes"]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_step_cost_counts_the_ssd_scan(arch):
    """An ssm or hybrid step's FLOPs add the SSD scan's products, reckoned
    from the shapes: per Mamba layer the forward twice (remat) and the
    backward, in sub-chunks of T = 16 steps (S 64, chunk 32)."""
    cfg = t_smoke_config(t_get_arch(arch))
    model = Model(cfg)
    B, S = 2, 64
    tok = torch.zeros((B, S), dtype=torch.int32)
    c = step_cost(model, OptConfig(), {"tokens": tok, "labels": tok})
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    P, G, N, T = cfg.ssm.head_dim, cfg.ssm.ngroups, cfg.ssm.d_state, 16
    fwd = H * (4 * P * N + (T + 1) * P) + G * (T + 1) * N
    bwd = H * (8 * P * N + 2 * (T + 1) * (P + N)) + G * (T + 1) * N
    ssd = cfg.num_layers * B * S * (2 * fwd + bwd)
    attn = (6.0 * model._n_groups * B * S * S * cfg.num_heads
            * cfg.resolved_head_dim if cfg.family == "hybrid" else 0.0)
    assert ssd > 0
    assert c["flops"] == 6.0 * model.n_params() * B * S + attn + ssd


# ---------------------------------------------------------------------------
# per-family parity: loss, gradients, params after 3 steps
# ---------------------------------------------------------------------------
def _family(arch):
    """JAX and port results on one float32 smoke model and one batch."""
    if arch in _CACHE:
        return _CACHE[arch]
    jcfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    tcfg = t_smoke_config(t_get_arch(arch)).replace(dtype="float32")
    jm = build_model(jcfg, single_device_ctx())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg)
    tp = _bridge(jp, tm)
    shape = ShapeConfig("t", "train", 16, 2)
    jb = JPipeline(JDataConfig(kind="bigram"), jcfg, shape).get_batch(0)
    tb = SyntheticPipeline(DataConfig(kind="bigram"), tcfg,
                           TShape("t", "train", 16, 2),
                           device="cpu").get_batch(0)
    out = {"j": {}, "t": {}}
    (_, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, jb),
                                       has_aux=True)(jp)
    out["j"]["metrics"] = {k: float(v) for k, v in jmet.items()}
    out["j"]["grads"] = [np.asarray(g) for g in jax.tree.leaves(jg)]
    leaves = tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss, tmet = tm.loss(leaves, tb)
    loss.backward()
    out["t"]["metrics"] = {k: float(v.detach()) for k, v in tmet.items()}
    out["t"]["grads"] = [t.grad.numpy() for t in jax_leaves(leaves)]
    for opt_kw, key in (({}, "default"),
                        ({"lr": 1e-3, "warmup_steps": 1}, "lr1e-3")):
        js = j_ts.init_train_state(jm, jax.random.PRNGKey(0),
                                   j_opt.OptConfig(**opt_kw))
        jstep = jax.jit(j_ts.build_train_step(jm, j_opt.OptConfig(**opt_kw)))
        ts = TrainState(params=tree_map(torch.clone, tp),
                        opt=init_adam_state(tp, OptConfig(**opt_kw)))
        tstep = build_train_step(tm, OptConfig(**opt_kw))
        jl, tl = [], []
        for i in range(3):
            js, jmm = jstep(js, jb)
            ts, tmm = tstep(ts, tb)
            jl.append(float(jmm["loss_step"]))
            tl.append(float(tmm["loss_step"]))
        out["j"][key] = (jl, [np.asarray(x) for x in jax.tree.leaves(js.params)])
        out["t"][key] = (tl, [x.numpy() for x in jax_leaves(ts.params)])
    _CACHE[arch] = out
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_jax(arch):
    r = _family(arch)
    j, t = r["j"]["metrics"], r["t"]["metrics"]
    assert set(t) == {"loss", "xent", "aux"}
    for k in ("loss", "xent", "aux"):
        assert abs(t[k] - j[k]) <= 1e-5 * max(abs(j[k]), 1e-6), (k, t, j)
    assert (j["aux"] > 0) == (arch == "deepseek-moe-16b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_jax(arch):
    r = _family(arch)
    jg, tg = r["j"]["grads"], r["t"]["grads"]
    assert len(jg) == len(tg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4, (i, _rel(a, b))


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_after_three_steps_match_jax(arch):
    r = _family(arch)
    jl, jp = r["j"]["default"]
    tl, tp = r["t"]["default"]
    for a, b in zip(tp, jp):
        assert _rel(a, b) < 1e-5
    for key in ("default", "lr1e-3"):
        for a, b in zip(r["t"][key][0], r["j"][key][0]):
            assert abs(a - b) <= 1e-5 * abs(b), (key, a, b)


def test_microbatched_and_compressed_steps_match_jax():
    """qwen3-4b smoke with microbatch 2 (the float32 accumulators), and
    with int8 error-feedback compression: 2 steps each, the metrics and
    params against JAX's."""
    for mb, compress in ((2, False), (1, True)):
        jcfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32",
                                                           microbatch=mb)
        tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(
            dtype="float32", microbatch=mb)
        jm = build_model(jcfg, single_device_ctx())
        tm = Model(tcfg)
        js = j_ts.init_train_state(jm, jax.random.PRNGKey(0), j_opt.OptConfig(),
                                   compress=compress)
        tp = _bridge(js.params, tm)
        ts = TrainState(params=tp, opt=init_adam_state(tp, OptConfig()),
                        ef=(grad_compress.init_ef_state(tp) if compress
                            else None))
        jstep = jax.jit(j_ts.build_train_step(jm, j_opt.OptConfig(),
                                              compress=compress))
        tstep = build_train_step(tm, OptConfig(), compress=compress)
        shape = ShapeConfig("t", "train", 16, 4)
        jpipe = JPipeline(JDataConfig(kind="bigram"), jcfg, shape)
        tpipe = SyntheticPipeline(DataConfig(kind="bigram"), tcfg,
                                  TShape("t", "train", 16, 4), device="cpu")
        for i in range(2):
            js, jm_ = jstep(js, jpipe.get_batch(i))
            ts, tm_ = tstep(ts, tpipe.get_batch(i))
            assert set(tm_) == set(jm_)
            for k in jm_:
                assert abs(float(tm_[k]) - float(jm_[k])) <= \
                    1e-5 * max(abs(float(jm_[k])), 1e-6), (mb, compress, k)
        for a, b in zip(jax_leaves(ts.params), jax.tree.leaves(js.params)):
            assert _rel(a.numpy(), b) < 1e-5, (mb, compress)
