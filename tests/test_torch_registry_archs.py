"""The four registry archs no other port test runs as a model, against JAX
(CPU): chameleon-34b (the vlm family, qk-norm), qwen2.5-32b (qkv bias),
deepseek-coder-33b and nemotron-4-340b (squared-ReLU MLP, not gated; a
bf16 Adam first moment).

Each arch runs in two float32 configs: (a) ``smoke_config(arch)``, as the
JAX package's own model tests run it (G 4 at head dim 32), and (b) the
same with the arch's real attention group and head dim over one kv head
(``num_heads=G, num_kv_heads=1, head_dim=resolved_head_dim``: G 8 / 128
for chameleon, 5 / 128 qwen2.5, 7 / 128 deepseek-coder, 12 / 192
nemotron).  Weights come from JAX's ``Model.init(PRNGKey(0))`` through
``params_from_numpy``.

* Twin of ``tests/test_models.py``'s train step: the loss within 1e-5
  relative, every gradient leaf within 1e-4 (relative to its largest
  entry), as ``tests/test_torch_train.py`` holds the five families.
* Twin of its teacher-forcing test: prefill S-1 tokens, decode one; the
  logits equal the port's own teacher-forced prefill and JAX's decode
  within 1e-4 with equal argmax (float32), and JAX's within 2e-2 in
  bfloat16 (``tests/test_torch_model.py``'s tolerances).
* Twins of ``tests/test_chunked_exactness.py``: ``prefill_ranged`` on a
  bucket-padded row equals exact-length ``prefill`` (and JAX's ranged
  logits); the batcher on the paged pool, ragged prompts with batch-pad
  dummy rows, cold then warm, gives JAX's batcher's tokens and its own
  token-at-a-time tokens, with the same prefix hits.
* nemotron-4-340b's bf16 first moment: three AdamW steps against JAX's
  ``build_train_step`` with the same ``OptConfig``.
* ``repro_torch.launch.serve --arch A --device cpu`` serves each arch and
  gives ``repro.launch.serve``'s tokens on the same weights.
"""
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.cell as j_cell_mod  # noqa: E402
import repro.launch.serve as j_serve  # noqa: E402
import repro_torch.core.cell as t_cell_mod  # noqa: E402
import repro_torch.launch.serve as t_serve  # noqa: E402
from repro.configs.base import ShapeConfig, smoke_config, with_opt_level  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.serve.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.batcher import Request as JRequest  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
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
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_adam_state  # noqa: E402
from repro_torch.train.train_step import TrainState, build_train_step  # noqa: E402

ARCHS = ["chameleon-34b", "qwen2.5-32b", "deepseek-coder-33b",
         "nemotron-4-340b"]
CONFIGS = ["smoke", "real_heads"]
CASES = [(a, c) for a in ARCHS for c in CONFIGS]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MAX_LEN, CHUNK, PAGE, SLOTS = 64, 16, 8, 3
_MODELS = {}
_RUNS = {}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfg(smoke, get, arch, config, dtype):
    """Config (a) ``smoke`` or (b) ``real_heads`` of ``arch`` in one of
    the two packages (``smoke``, ``get``: its smoke_config and get_arch)."""
    full = get(arch)
    cfg = smoke(full).replace(dtype=dtype)
    if config == "real_heads":
        cfg = cfg.replace(num_heads=full.num_heads // full.num_kv_heads,
                          num_kv_heads=1, head_dim=full.resolved_head_dim)
    return cfg


def _models(arch, config, dtype="float32"):
    """(JAX model, JAX params, port model, port params) on JAX's
    ``Model.init(PRNGKey(0))`` weights (memoized)."""
    key = (arch, config, dtype)
    if key not in _MODELS:
        jm = build_model(_cfg(smoke_config, get_arch, arch, config, dtype),
                         single_device_ctx())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = Model(_cfg(t_smoke_config, t_get_arch, arch, config, dtype))
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=tm.dtype, device="cpu", specs=tm.param_specs())
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def test_configs_keep_each_archs_features():
    """Config (b) has the arch's real group and head dim; both configs
    keep qk-norm, the qkv bias, the non-gated squared-ReLU MLP and the
    bf16 first moment where the arch has them."""
    want = {"chameleon-34b": (8, 128), "qwen2.5-32b": (5, 128),
            "deepseek-coder-33b": (7, 128), "nemotron-4-340b": (12, 192)}
    for arch, (g, dh) in want.items():
        full = t_get_arch(arch)
        for config in CONFIGS:
            cfg = _models(arch, config)[2].cfg
            assert asdict(cfg) == asdict(_models(arch, config)[0].cfg)
            if config == "real_heads":
                assert (cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim) == (g, 1, dh)
            for f in ("family", "qk_norm", "qkv_bias", "act", "gated_mlp",
                      "optimizer_m_dtype"):
                assert getattr(cfg, f) == getattr(full, f), (arch, f)
    assert t_get_arch("chameleon-34b").family == "vlm"


# ---------------------------------------------------------------------------
# twin of tests/test_models.py::test_smoke_train_step
# ---------------------------------------------------------------------------
def _train_batch(jm, tm, seq=16, batch=2):
    jb = JPipeline(JDataConfig(kind="bigram"), jm.cfg,
                   ShapeConfig("t", "train", seq, batch)).get_batch(0)
    tb = SyntheticPipeline(DataConfig(kind="bigram"), tm.cfg,
                           TShape("t", "train", seq, batch),
                           device="cpu").get_batch(0)
    assert np.array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
    return jb, tb


def _loss_and_grads(arch, config):
    key = ("grads", arch, config)
    if key not in _RUNS:
        jm, jp, tm, tp = _models(arch, config)
        jb, tb = _train_batch(jm, tm)
        (_, jmet), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb), has_aux=True))(jp)
        leaves = tree_map(lambda t: t.clone().requires_grad_(), tp)
        tl, tmet = tm.loss(leaves, tb)
        tl.backward()
        _RUNS[key] = (
            {k: float(v) for k, v in jmet.items()},
            {k: float(v.detach()) for k, v in tmet.items()},
            [np.asarray(g) for g in jax.tree.leaves(jg)],
            [t.grad.numpy() for t in jax_leaves(leaves)])
    return _RUNS[key]


@pytest.mark.parametrize("arch,config", CASES)
def test_loss_matches_jax(arch, config):
    jmet, tmet, _, _ = _loss_and_grads(arch, config)
    for k in ("loss", "xent"):
        assert np.isfinite(tmet[k])
        assert abs(tmet[k] - jmet[k]) <= 1e-5 * abs(jmet[k]), (k, tmet, jmet)


@pytest.mark.parametrize("arch,config", CASES)
def test_gradients_match_jax(arch, config):
    _, _, jg, tg = _loss_and_grads(arch, config)
    assert len(jg) == len(tg)
    norm = 0.0
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4, (i, _rel(a, b))
        norm += float(np.sum(np.square(a, dtype=np.float64)))
    assert np.isfinite(norm) and norm > 0


# ---------------------------------------------------------------------------
# twin of tests/test_models.py::test_prefill_decode_matches_teacher_forcing
# ---------------------------------------------------------------------------
def _teacher_forcing(arch, config, dtype):
    """Logits of prefill S-1 tokens then decode the last, in JAX and the
    port, and of the port's teacher-forced prefill of all S tokens at its
    last position."""
    key = ("tf", arch, config, dtype)
    if key not in _RUNS:
        jm, jp, tm, tp = _models(arch, config, dtype)
        B, S = 2, 16
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, S),
                                             0, jm.cfg.vocab), np.int32)
        pos = np.full((B,), S - 1, np.int32)
        _, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :-1])},
                                    jm.init_cache(B, S))
        jdec, _ = jax.jit(jm.decode)(jp, jc, {
            "tokens": jnp.asarray(toks[:, -1:]), "pos": jnp.asarray(pos)})
        tt = torch.from_numpy(toks.copy())
        with torch.no_grad():
            tfull, _ = tm.prefill(tp, {"tokens": tt},
                                  tm.init_cache(B, S, device="cpu"))
            _, tc = tm.prefill(tp, {"tokens": tt[:, :-1]},
                               tm.init_cache(B, S, device="cpu"))
            tdec, _ = tm.decode(tp, tc, {"tokens": tt[:, -1:],
                                         "pos": torch.from_numpy(pos)})
        V = jm.cfg.vocab
        _RUNS[key] = tuple(_np(x)[:, :V] for x in (jdec, tfull, tdec))
    return _RUNS[key]


@pytest.mark.parametrize("arch,config", CASES)
def test_prefill_decode_matches_teacher_forcing(arch, config):
    jdec, tfull, tdec = _teacher_forcing(arch, config, "float32")
    assert _rel(tdec, tfull) < TOL["float32"]
    assert _rel(tdec, jdec) < TOL["float32"]
    assert np.array_equal(tdec.argmax(-1), tfull.argmax(-1))
    assert np.array_equal(tdec.argmax(-1), jdec.argmax(-1))


@pytest.mark.parametrize("arch,config", CASES)
def test_prefill_decode_bf16_matches_jax(arch, config):
    jdec, tfull, tdec = _teacher_forcing(arch, config, "bfloat16")
    assert _rel(tdec, jdec) < TOL["bfloat16"]
    # tests/test_models.py's own bf16 limit between decode and prefill
    assert _rel(tdec, tfull) < 5e-2


# ---------------------------------------------------------------------------
# twins of tests/test_chunked_exactness.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,config", CASES)
def test_prefill_ranged_matches_exact_length(arch, config):
    """Bucket-padded ``prefill_ranged`` == exact-length ``prefill`` at the
    last real token (L 1: a 15-token pad tail), and == JAX's ranged
    logits."""
    jm, jp, tm, tp = _models(arch, config)
    V = tm.cfg.vocab
    rng = np.random.RandomState(1)
    for L in (1, 11):
        prompt = rng.randint(1, V, size=L).astype(np.int32)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :L] = prompt
        length = np.array([L], np.int32)
        with torch.no_grad():
            ref, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompt[None])},
                                tm.init_cache(1, MAX_LEN, device="cpu"))
            got, _ = tm.prefill_ranged(
                tp, {"tokens": torch.from_numpy(padded),
                     "length": torch.from_numpy(length)},
                tm.init_cache(1, MAX_LEN, device="cpu"))
        jgot, _ = jm.prefill_ranged(jp, {"tokens": jnp.asarray(padded),
                                         "length": jnp.asarray(length)},
                                    jm.init_cache(1, MAX_LEN))
        assert _rel(_np(got)[:, :V], _np(ref)[:, :V]) < 1e-4, L
        assert _rel(_np(got)[:, :V], _np(jgot)[:, :V]) < 1e-4, L


# waves of ragged prompt tails behind a 16-token shared prefix (two pages):
# five prompts on three slots, so groups pad to powers of two with dummy
# rows; the second wave meets the first's interned prefix
WAVES = [([3, 17, 1, 20, 9], 0, 0), ([5, 2, 12, 8, 14], 1, 10)]


def _requests(cls, vocab, lens, *, seed, rid0, shared=16, max_new=5):
    sysp = np.random.RandomState(1234).randint(1, vocab, size=shared)
    rng = np.random.RandomState(seed)
    return [cls(rid=rid0 + i, max_new_tokens=max_new,
                prompt=np.concatenate([sysp, rng.randint(1, vocab, size=n)])
                .astype(np.int32))
            for i, n in enumerate(lens)]


def _serve(which, arch, config, prefill_chunk=CHUNK):
    """Both waves through one batcher on the paged pool, draining between
    them.  Returns ({rid: tokens}, the batcher)."""
    jm, jp, tm, tp = _models(arch, config)
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
              prefill_chunk=prefill_chunk)
    if which == "jax":
        bat, cls = JBatcher(jm, jp, **kw), JRequest
    else:
        bat, cls = ContinuousBatcher(tm, tp, device="cpu", **kw), Request
    for lens, seed, rid0 in WAVES:
        for r in _requests(cls, tm.cfg.vocab, lens, seed=seed, rid0=rid0):
            bat.submit(r)
        bat.run_until_drained()
    return {r.rid: r.output for r in bat.done}, bat


@pytest.mark.parametrize("arch,config", CASES)
def test_batcher_matches_jax_and_token_at_a_time(arch, config):
    jout, jbat = _serve("jax", arch, config)
    tout, tbat = _serve("port", arch, config)
    ref, base = _serve("port", arch, config, prefill_chunk=None)
    assert tbat.pool is not None and tbat.chunked
    assert tout == jout
    assert tout == ref
    assert len({t for out in tout.values() for t in out}) > 1
    assert tbat.pool.prefix_hit_tokens == jbat.pool.prefix_hit_tokens > 0
    assert tbat.prefill_invocations == jbat.prefill_invocations > 0
    assert tbat.decode_invocations == jbat.decode_invocations
    assert base.prefill_invocations == 0
    assert tbat.decode_invocations < base.decode_invocations


# ---------------------------------------------------------------------------
# nemotron-4-340b: AdamW with a bf16 first moment
# ---------------------------------------------------------------------------
def test_nemotron_bf16_first_moment_matches_jax():
    """Three AdamW steps of config (b) with ``m_dtype="bfloat16"``: the
    losses within 1e-5 relative, every param leaf within 1e-5 of its
    largest entry, both first moments bf16 and equal within a bf16 ulp of
    each leaf's largest entry."""
    arch = "nemotron-4-340b"
    jm, _, tm, tp = _models(arch, "real_heads")
    assert tm.cfg.optimizer_m_dtype == "bfloat16"
    jb, tb = _train_batch(jm, tm)
    jo = j_opt.OptConfig(m_dtype=tm.cfg.optimizer_m_dtype)
    to = OptConfig(m_dtype=tm.cfg.optimizer_m_dtype)
    js = j_ts.init_train_state(jm, jax.random.PRNGKey(0), jo)
    jstep = jax.jit(j_ts.build_train_step(jm, jo))
    ts = TrainState(params=tree_map(torch.clone, tp),
                    opt=init_adam_state(tp, to))
    tstep = build_train_step(tm, to)
    for _ in range(3):
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, tb)
        jl, tl = float(jmet["loss_step"]), float(tmet["loss_step"])
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    for a, b in zip(jax_leaves(ts.params), jax.tree.leaves(js.params)):
        assert _rel(_np(a), b) < 1e-5
    jm_leaves = jax.tree.leaves(js.opt.m)
    tm_leaves = jax_leaves(ts.opt.m)
    assert all(m.dtype == jnp.bfloat16 for m in jm_leaves)
    assert all(m.dtype == torch.bfloat16 for m in tm_leaves)
    for a, b in zip(tm_leaves, jm_leaves):
        assert _rel(_np(a), b) <= 2.0 ** -8


# ---------------------------------------------------------------------------
# the launcher: repro_torch.launch.serve == repro.launch.serve
# ---------------------------------------------------------------------------
def _capture(monkeypatch, mod):
    made = []
    orig = mod.Cell.make_batcher

    def make_batcher(self, **kw):
        bat = orig(self, **kw)
        made.append(bat)
        return bat

    monkeypatch.setattr(mod.Cell, "make_batcher", make_batcher)
    return made


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_matches_jax(arch, monkeypatch):
    """Both entry points in float32 at smoke size, the port's cell on
    JAX's weights: exit 0 and the same greedy tokens."""
    def f32(smoke):
        return lambda a: smoke(a).replace(dtype="float32")
    monkeypatch.setattr(j_serve, "smoke_config", f32(smoke_config))
    monkeypatch.setattr(t_serve, "smoke_config", f32(t_smoke_config))
    j_made = _capture(monkeypatch, j_cell_mod)
    t_made = _capture(monkeypatch, t_cell_mod)
    jcfg = with_opt_level(f32(smoke_config)(get_arch(arch)), True)
    jp = build_model(jcfg, single_device_ctx()).init(jax.random.PRNGKey(0))
    weights = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        dtype=torch.float32, device="cpu")
    orig_init = t_cell_mod.Cell.init_serve

    def init_serve(self, params=None, generator=None):
        return orig_init(self, params=weights)

    monkeypatch.setattr(t_cell_mod.Cell, "init_serve", init_serve)
    argv = ["--arch", arch, "--requests", "3", "--max-new", "4",
            "--max-len", "64"]
    assert j_serve.main(argv) == 0
    assert t_serve.main(argv + ["--device", "cpu"]) == 0
    (jbat,), (tbat,) = j_made, t_made
    assert tbat.pool is not None and tbat.pool.payload_kind == "page"
    tout = {r.rid: r.output for r in tbat.done}
    assert sorted(tout) == [0, 1, 2]
    assert tout == {r.rid: r.output for r in jbat.done}
