"""The port's other serving paths against the JAX ContinuousBatcher (CPU,
float32 greedy tokens):

* deepseek-moe-16b at smoke size on the paged pool, cold and on warm
  prefix hits, with no page held after the drain;
* qwen3-4b at smoke size on the dense per-slot cache (``kv_pool=None``)
  and with token-at-a-time prompts on the paged pool
  (``prefill_chunk=None``);
* mixtral-8x7b at smoke size with ``max_len`` 128 above its 64-token
  window: a rolling dense cache fed token at a time;
* the port's chunked trajectory equals its own token-at-a-time one, as
  ``tests/test_chunked_exactness.py`` checks in JAX.

Weights come from the JAX ``Model.init`` through the weight bridge, with
a key per architecture under which the greedy tokens vary (a constant
token stream would hide a mismatch); prompts share an 18-token prefix, as
in ``test_torch_serve.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.serve.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.batcher import Request as JRequest  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402

PAGE = 8
WEIGHT_KEY = {"qwen3-4b": 3, "deepseek-moe-16b": 4, "mixtral-8x7b": 5}
_MODELS = {}
_RUNS = {}

# wave 1: two prompts admitted in one tick (cold), a third behind them
# (warm on the paged pool); wave 2 hits the shared prefix too
WAVES = [([3, 5, 2], 0, 0), ([4, 7], 5, 10)]


def _models(arch):
    if arch not in _MODELS:
        jcfg = smoke_config(get_arch(arch)).replace(dtype="float32")
        tcfg = t_smoke_config(t_get_arch(arch)).replace(dtype="float32")
        jm = build_model(jcfg, single_device_ctx())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(WEIGHT_KEY[arch]))
        tm = Model(tcfg)
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=torch.float32, device="cpu", specs=tm.param_specs())
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def _requests(cls, vocab, lens, *, seed, rid0, shared=18, max_new=6):
    sysp = np.random.RandomState(1234).randint(1, vocab, size=shared)
    rng = np.random.RandomState(seed)
    return [cls(rid=rid0 + i, max_new_tokens=max_new,
                prompt=np.concatenate([sysp, rng.randint(1, vocab, size=L)])
                .astype(np.int32))
            for i, L in enumerate(lens)]


def _serve(port: bool, arch: str, *, waves=WAVES, **kw):
    """Run ``waves`` through one batcher, draining between waves.
    Returns ({rid: tokens}, the batcher)."""
    jm, jp, tm, tp = _models(arch)
    kw = {"batch_slots": 2, "page_size": PAGE, **kw}
    if port:
        bat, cls = ContinuousBatcher(tm, tp, device="cpu", **kw), Request
    else:
        bat, cls = JBatcher(jm, jp, **kw), JRequest
    for lens, seed, rid0 in waves:
        for r in _requests(cls, jm.cfg.vocab, lens, seed=seed, rid0=rid0):
            bat.submit(r)
        bat.run_until_drained()
    return {r.rid: r.output for r in bat.done}, bat


CASES = {
    "deepseek-paged": ("deepseek-moe-16b", dict(max_len=32, prefill_chunk=8)),
    "qwen3-dense": ("qwen3-4b", dict(max_len=32, prefill_chunk=8,
                                     kv_pool=None)),
    "qwen3-token-at-a-time": ("qwen3-4b", dict(max_len=32,
                                               prefill_chunk=None)),
    "mixtral-rolling": ("mixtral-8x7b", dict(max_len=128, prefill_chunk=8)),
}


def _both(case):
    if case not in _RUNS:
        arch, kw = CASES[case]
        _RUNS[case] = (_serve(False, arch, **kw), _serve(True, arch, **kw))
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_match_jax(case):
    (jout, jbat), (tout, tbat) = _both(case)
    assert tout == jout
    assert tbat.prefill_invocations == jbat.prefill_invocations
    assert tbat.decode_invocations == jbat.decode_invocations


def test_moe_paged_warm_hits_and_releases_every_page():
    (_, jbat), (_, tbat) = _both("deepseek-paged")
    pool = tbat.pool
    assert pool.prefix_hit_tokens == jbat.pool.prefix_hit_tokens >= 3 * 16
    assert len(pool.arena) == 2              # dense_layers and moe_layers
    nodes = list(pool.tree._walk())
    assert nodes and all(n.refs == 0 for n in nodes)
    assert pool.pages_in_use == pool.tree.interned == pool.evictable_pages()
    assert (pool.block_table == pool.sentinel).all()


def test_which_cache_plane_each_path_takes():
    """kv_pool=None and a rolling window take the dense cache (a rolling
    window also feeds prompts token at a time); prefill_chunk=None keeps
    the paged pool."""
    for case, paged, chunked in (("qwen3-dense", False, True),
                                 ("mixtral-rolling", False, False),
                                 ("qwen3-token-at-a-time", True, False)):
        (_, jbat), (_, tbat) = _both(case)
        assert (tbat.pool is not None) == paged == (jbat.pool is not None)
        assert tbat.chunked == chunked == jbat.chunked
        assert (tbat.prefill_invocations > 0) == chunked


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_chunked_trajectory_equals_token_at_a_time(arch):
    """A ragged batch of 5 prompts on 3 slots: bucket grouping and
    power-of-two dummy rows in the chunked run, the same tokens as
    feeding every prompt through the decode step."""
    waves = [([3, 17, 1, 20, 9], 0, 0)]
    kw = dict(max_len=64, batch_slots=3)
    ref, base = _serve(True, arch, waves=waves, prefill_chunk=None, **kw)
    got, chunked = _serve(True, arch, waves=waves, prefill_chunk=8, **kw)
    assert got == ref
    assert base.prefill_invocations == 0
    assert 0 < chunked.prefill_invocations <= 5
    assert chunked.decode_invocations < base.decode_invocations


def test_prompt_longer_than_the_cache_is_fed_token_at_a_time():
    """A prompt past ``max_len - 1`` is not chunkable: it goes through the
    decode step and finishes when it overruns the cache, as in JAX."""
    outs = []
    for port in (False, True):
        out, _ = _serve(port, "qwen3-4b", waves=[([30, 2], 0, 0)],
                        max_len=32, prefill_chunk=8)
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[1][0] == [] and len(outs[1][1]) == 6


@pytest.mark.parametrize("arch,extra", [
    ("deepseek-moe-16b", []),
    ("deepseek-moe-16b", ["--prefill-chunk", "0"]),
    ("mixtral-8x7b", ["--max-len", "128"]),
])
def test_launch_serve_paths_on_cpu(arch, extra):
    assert t_serve.main(["--device", "cpu", "--arch", arch, "--requests",
                         "3", "--max-new", "3", "--max-len", "64"]
                        + extra) == 0


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-moe-16b", {"max_len": 64}),               # paged, MoE routing
    ("qwen3-4b", {"max_len": 64, "kv_pool": None}),      # dense cache
    ("mixtral-8x7b", {"max_len": 128}),                  # rolling, MoE
])
def test_decode_step_reads_nothing_back_to_the_host(arch, kw):
    """One decode step issues no op that reads a device value back to the
    host (``.item()``, ``nonzero``): routing counts, capacity slots and the
    dense writes stay on the device, so the card never waits for the host
    inside the step."""
    from torch.profiler import ProfilerActivity, profile
    _, _, tm, tp = _models(arch)
    bat = ContinuousBatcher(tm, tp, batch_slots=2, page_size=PAGE,
                            prefill_chunk=8, device="cpu", **kw)
    for r in _requests(Request, tm.cfg.vocab, [3, 9], seed=0, rid0=0,
                       max_new=8):
        bat.submit(r)
    for _ in range(3):
        bat.step()
    batch = {"tokens": torch.from_numpy(bat.cur_tok[:, None].copy()),
             "pos": torch.from_numpy(bat.pos.copy())}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if bat.pool is not None:
            bt = torch.from_numpy(bat.pool.block_table.copy())
            bat._step(tp, bat.pool.arena, bat.pool.kv_scales, bat.resident,
                      bt, batch, None)
        else:
            bat._step(tp, bat.cache, batch, None)
    reads = [e.name for e in prof.events()
             if e.name in ("aten::item", "aten::_local_scalar_dense",
                           "aten::nonzero")]
    assert not reads
