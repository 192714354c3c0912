"""The decode step as a CUDA graph per batcher shape (``serve/step_graph.py``).

CPU (here): the keys over the width buckets, and the batcher's width
sequence against the JAX batcher's block-table trim; the launch-counter
registry a replay advances (a delta added on each replay, capture leaving
the counters as they were, ``launches_by_capacity`` merged); the address
guard; the in-place contract of every decode step the graph relies on
(its state comes back as the same tensors); the sampling draw, equal to
``torch.multinomial``'s; and the CPU batcher, which builds no graph and
serves the JAX batcher's tokens on the paged, dense and snapshot planes.

Card (marked ``cuda``, skipped here): in float32 at smoke size, 12 decode
steps replayed (each key captured at its first visit, or at its second
after the path's eager first call in the process) against the same 12
steps run eagerly from the same state,
on qwen3-4b paged across two width buckets, on the dense cache, on an
int8 pool, deepseek-moe-16b, mamba2-2.7b and zamba2-2.7b: identical
tokens, every cache leaf within rel 1e-6 (the output says whether
bitwise); seamless-m4t-large-v2 with a source, paged and dense: identical
tokens and every state tensor bitwise, the cross memory included; at temperature 0.8 the draws differ from replay to replay and
equal the eager draws; a moved state tensor and a step that cannot be
captured raise.

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_step_graph.py

The JAX reference is imported where a CPU test first needs it: the card's
machine has no jax, and runs only the ``cuda`` tests.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
    paged_extend_attention,
)
from repro_torch.kernels.moe_gmm.ops import gmm  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serve.serve_step import sample_tokens  # noqa: E402
from repro_torch.serve.step_graph import (  # noqa: E402
    DENSE_KEY,
    check_unmoved,
    decode_keys,
    leaf_addresses,
    paged_key,
)

PAGE = 8
_MODELS = {}


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_logical", [1, 8, 24, 32])
def test_decode_keys_cover_every_width_bucket(n_logical):
    """Every active page count maps to the narrowest key that covers it,
    and the keys are the power-of-two widths below ``n_logical`` plus
    ``n_logical``: six at max_len 512 and page 16."""
    keys = decode_keys(n_logical)
    widths = [w for _, w in keys]
    assert widths == sorted(set(widths))
    assert widths[-1] == n_logical
    assert all(w & (w - 1) == 0 for w in widths[:-1])
    for n in range(1, n_logical + 1):
        path, w = paged_key(n, n_logical)
        assert path == "paged" and (path, w) in keys and w >= n
        assert all(v < n for v in widths if v < w)
    assert len(decode_keys(512 // 16)) == 6
    assert decode_keys(None) == [DENSE_KEY]


def _models(arch):
    """(JAX model, JAX params, port model, port params on the CPU) of
    ``arch`` at smoke size in float32, from one JAX init."""
    import jax

    from repro.configs.base import smoke_config
    from repro.configs.registry import get_arch
    from repro.models.model import build_model
    from repro.sharding.rules import single_device_ctx
    if arch not in _MODELS:
        jm = build_model(smoke_config(get_arch(arch)).replace(dtype="float32"),
                         single_device_ctx())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
        tm = Model(t_smoke_config(t_get_arch(arch)).replace(dtype="float32"))
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=torch.float32, device="cpu", specs=tm.param_specs())
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def _prompts(vocab, lens, seed=0):
    """A 20-token shared prefix with a tail of each length in ``lens``."""
    rng = np.random.RandomState(seed)
    sysp = rng.randint(1, vocab, size=20)
    return [np.concatenate([sysp, rng.randint(1, vocab, size=n)])
            .astype(np.int32) for n in lens]


PLANES = {
    "paged": ("qwen3-4b", {}),
    "dense": ("qwen3-4b", {"kv_pool": None}),
    "snapshot": ("mamba2-2.7b", {}),
}


def _serve(port, arch, kw, waves, max_new=4):
    """Serve ``waves`` of prompts through one batcher (draining between
    waves); returns ({rid: tokens}, batcher)."""
    from repro.serve.batcher import ContinuousBatcher as JBatcher
    from repro.serve.batcher import Request as JRequest
    jm, jp, tm, tp = _models(arch)
    kw = {"batch_slots": 2, "max_len": 64, "page_size": PAGE,
          "prefill_chunk": 8, **kw}
    bat = (ContinuousBatcher(tm, tp, device="cpu", **kw) if port
           else JBatcher(jm, jp, **kw))
    rid = 0
    for wave in waves:
        for p in wave:
            bat.submit((Request if port else JRequest)(
                rid=rid, prompt=p, max_new_tokens=max_new))
            rid += 1
        bat.run_until_drained()
    return {r.rid: r.output for r in bat.done}, bat


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": None}],
                         ids=["chunked", "token-at-a-time"])
def test_paged_widths_match_the_jax_trim(kw):
    """The port's decode keys follow the width the JAX batcher trims its
    block table to, step by step (``repro/serve/batcher.py``), across
    several width buckets."""
    from repro.serve.batcher import Request as JRequest
    jm, _, tm, _ = _models("qwen3-4b")
    waves = [_prompts(jm.cfg.vocab, [3, 14, 6], seed=1)]
    _, jbat = _serve(False, "qwen3-4b", kw, [])
    jwidths, twidths = [], []
    jstep = jbat._step

    def jspy(params, arena, scales, resident, bt, *rest):
        jwidths.append(bt.shape[1])
        return jstep(params, arena, scales, resident, bt, *rest)

    jbat._step = jspy
    tbat = ContinuousBatcher(tm, _models("qwen3-4b")[3], device="cpu",
                             batch_slots=2, max_len=64, page_size=PAGE,
                             **{"prefill_chunk": 8, **kw})
    tdecode = tbat._decode

    def tspy(key, host):
        assert host["block_table"].shape[1] == key[1]
        twidths.append(key[1])
        return tdecode(key, host)

    tbat._decode = tspy
    for bat, cls in ((jbat, JRequest), (tbat, Request)):
        for i, p in enumerate(waves[0]):
            bat.submit(cls(rid=i, prompt=p, max_new_tokens=12))
        bat.run_until_drained()
    assert twidths == jwidths
    assert len(set(twidths)) >= 2


# --------------------------------------------------------------------------
# launch counters
# --------------------------------------------------------------------------
def test_every_kernel_wrapper_registers_its_counters():
    reg = {fn: names for fn, names in _build.COUNTED}
    assert reg[paged_decode_attention] == ("launches",)
    assert reg[decode_attention] == ("launches",)
    assert reg[flash_attention] == ("launches", "launches_tc",
                                    "launches_kv_len")
    assert reg[paged_extend_attention] == ("launches", "launches_tc")
    assert reg[gmm] == ("launches", "launches_tc", "launches_by_capacity")
    assert reg[ssd] == ("launches",)


@pytest.fixture
def counters():
    saved = _build.launch_counts()
    yield
    _build.set_launch_counts(saved)


def _fake_capture():
    """What one captured decode step of deepseek-moe-16b counts: the
    wrappers ran while capturing, and the counts go back as they were."""
    before = _build.launch_counts()
    paged_decode_attention.launches += 28
    gmm.launches += 81
    gmm.launches_tc += 81
    gmm.launches_by_capacity[8] = gmm.launches_by_capacity.get(8, 0) + 81
    after = _build.launch_counts()
    _build.set_launch_counts(before)
    return before, _build.launch_delta(before, after)


def test_capture_leaves_the_counters_as_they_were(counters):
    by_c = gmm.launches_by_capacity
    by_c[192] = 5
    before, delta = _fake_capture()
    assert _build.launch_counts() == before
    assert gmm.launches_by_capacity is by_c and by_c == {192: 5}
    assert delta == {(paged_decode_attention, "launches"): 28,
                     (gmm, "launches"): 81, (gmm, "launches_tc"): 81,
                     (gmm, "launches_by_capacity"): {8: 81}}


def test_each_replay_adds_the_captured_delta(counters):
    paged_decode_attention.launches = 7
    gmm.launches_by_capacity.clear()
    gmm.launches_by_capacity.update({8: 3, 96: 81})
    flash0 = flash_attention.launches
    _, delta = _fake_capture()
    for _ in range(3):
        _build.add_launch_counts(delta)
    assert paged_decode_attention.launches == 7 + 3 * 28
    assert gmm.launches_by_capacity == {8: 3 + 3 * 81, 96: 81}
    assert flash_attention.launches == flash0


# --------------------------------------------------------------------------
# the address guard and the in-place contract
# --------------------------------------------------------------------------
def test_address_guard_raises_on_a_moved_leaf():
    cache = {"k": torch.zeros(2, 3), "v": torch.ones(2, 3), "none": None}
    captured = leaf_addresses((cache,))
    cache["k"].add_(1.0)                 # in place: same address
    check_unmoved(captured, (cache,), "in place")
    cache["v"] = cache["v"] + 1.0        # a new tensor
    with pytest.raises(RuntimeError, match="1 input tensor"):
        check_unmoved(captured, (cache,), "moved")


def test_address_guard_raises_on_a_leaf_added_or_dropped():
    tree = [torch.zeros(1), torch.zeros(1)]
    captured = leaf_addresses(tree)
    with pytest.raises(RuntimeError):
        check_unmoved(captured, tree[:1], "dropped")


IN_PLACE = {
    "qwen3-paged": ("qwen3-4b", {}),
    "qwen3-int8": ("qwen3-4b", {"kv_dtype": "int8"}),
    "qwen3-dense": ("qwen3-4b", {"kv_pool": None}),
    "deepseek-paged": ("deepseek-moe-16b", {}),
    "mixtral-rolling": ("mixtral-8x7b", {"max_len": 128}),
    "mamba2-snapshot": ("mamba2-2.7b", {}),
    "zamba2-snapshot": ("zamba2-2.7b", {}),
}


@pytest.mark.parametrize("case", sorted(IN_PLACE))
def test_decode_step_updates_its_state_in_place(case):
    """The plain decode step returns its state as the same tensors it was
    given, and changes them: what a graph replay relies on."""
    arch, kw = IN_PLACE[case]
    tm = Model(t_smoke_config(t_get_arch(arch)).replace(dtype="float32"))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    bat = ContinuousBatcher(tm, tp, device="cpu", **{
        "batch_slots": 2, "max_len": 64, "page_size": PAGE,
        "prefill_chunk": 8, **kw})
    for i, p in enumerate(_prompts(tm.cfg.vocab, [3, 9])):
        bat.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    bat.step()
    assert bat.step_graph is None
    state = bat._decode_state()
    before = [t.clone() for t in tree_leaves(state[1:])]
    host = {"tokens": bat.cur_tok[:, None], "pos": bat.pos}
    if bat.pool is not None and bat.pool.payload_kind == "page":
        host["block_table"] = bat.pool.block_table[:, :8]
    inputs = {k: torch.from_numpy(np.array(v)) for k, v in host.items()}
    toks, out = bat._run_step(state, inputs)
    check_unmoved(leaf_addresses(state), out, case)
    assert toks.shape == (2,) and toks.dtype == torch.int32
    after = tree_leaves(out[1:])
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------
@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.3])
def test_sampling_draws_what_multinomial_draws(temperature):
    """The graph-safe draw equals ``torch.multinomial(probs, 1)`` on the
    same generator, and leaves the generator in the same state."""
    rng = np.random.RandomState(0)
    for seed in range(20):
        logits = torch.from_numpy(rng.randn(4, 512).astype(np.float32) * 3)
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        probs = torch.softmax(logits / temperature, dim=-1)
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        got = sample_tokens(logits, g2, temperature)
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), want)
        assert torch.equal(g1.get_state(), g2.get_state())


# --------------------------------------------------------------------------
# the CPU batcher: no graph, the JAX batcher's tokens
# --------------------------------------------------------------------------
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_cpu_batcher_builds_no_graph(plane):
    """On the CPU the decode step runs eagerly (no StepGraph), and the
    batcher serves the JAX batcher's greedy tokens, cold and on a warm
    prefix (paged and snapshot) or on the dense per-slot cache."""
    arch, kw = PLANES[plane]
    vocab = _models(arch)[0].cfg.vocab
    p = _prompts(vocab, [5, 11, 7], seed=2)
    waves = [p[:2], p[2:]]
    jout, _ = _serve(False, arch, kw, waves)
    tout, tbat = _serve(True, arch, kw, waves)
    assert tbat.step_graph is None
    tbat.close()                         # nothing to release on the CPU
    assert tout == jout
    assert tbat.decode_invocations > 0


# --------------------------------------------------------------------------
# the card: replayed steps against eager ones
# --------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


CARD = {
    # prompts of 20 + 3 and 20 + 9 tokens at page 8: the decode walks from
    # width 4 into width 8 within 12 steps
    "qwen3-paged": ("qwen3-4b", {}),
    "qwen3-dense": ("qwen3-4b", {"kv_pool": None}),
    "qwen3-int8": ("qwen3-4b", {"kv_dtype": "int8"}),
    "deepseek-paged": ("deepseek-moe-16b", {}),
    "mamba2-snapshot": ("mamba2-2.7b", {}),
    "zamba2-snapshot": ("zamba2-2.7b", {}),
}


def _pair(dev, arch, kw, temperature=0.0):
    """Two batchers over one float32 smoke model on the card: the first
    steps through its graphs, the second eagerly (``step_graph`` None)."""
    tm = Model(t_smoke_config(t_get_arch(arch)).replace(dtype="float32"))
    tp = tm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    kw = {"batch_slots": 2, "max_len": 64, "page_size": PAGE,
          "prefill_chunk": 8, "temperature": temperature, **kw}
    graphed = ContinuousBatcher(tm, tp, device=dev, **kw)
    eager = ContinuousBatcher(tm, tp, device=dev, **kw)
    eager.step_graph = None
    for bat in (graphed, eager):
        for i, p in enumerate(_prompts(tm.cfg.vocab, [3, 9])):
            bat.submit(Request(rid=i, prompt=p, max_new_tokens=16))
    return tm, graphed, eager


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD))
def test_replayed_steps_equal_eager_steps(dev, case):
    arch, kw = CARD[case]
    tm, graphed, eager = _pair(dev, arch, kw)
    graphed.step()                       # prefill, then the first decode
    eager.step()
    for dst, src in zip(tree_leaves(eager._decode_state()[1:]),
                        tree_leaves(graphed._decode_state()[1:])):
        dst.copy_(src)                   # the same state from here on
    assert [r.output for r in eager.slot_req] == \
        [r.output for r in graphed.slot_req]
    keys = set()
    for _ in range(12):
        if graphed.pool is not None and graphed.pool.payload_kind == "page":
            keys.add(paged_key(int(graphed.pos.max()) // PAGE + 1,
                               graphed.pool.n_logical))
        graphed.step()
        eager.step()
        assert [r.output for r in graphed.slot_req] == \
            [r.output for r in eager.slot_req]
    torch.cuda.synchronize()
    g = graphed.step_graph.stats()["decode"]
    # one capture a key; an eager step only as the path's first in the
    # process; every other step a replay
    assert g["captures"] == g["keys"] and g["eager_calls"] <= 1
    assert g["replays"] + g["eager_calls"] == graphed.decode_invocations
    if case == "qwen3-paged":
        assert len(keys) == 2, keys
    rels = [_rel(a, b) for a, b in zip(tree_leaves(graphed._decode_state()[1:]),
                                       tree_leaves(eager._decode_state()[1:]))]
    bitwise = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(graphed._decode_state()[1:]),
        tree_leaves(eager._decode_state()[1:])))
    print(f"[step graph] {case}: {g}; cache leaves max rel "
          f"{max(rels):.3e}, bitwise equal: {bitwise}")
    assert max(rels) <= 1e-6
    graphed.close()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"kv_pool": None}], ids=["paged", "dense"])
def test_encdec_replayed_decode_equals_eager(dev, kw):
    """seamless smoke, one request with a 30-frame source and one with
    none: after the same prefill, 12 decode steps replayed and eager give
    the same tokens and every state tensor bitwise (the cross memory and
    ``src_len`` in the resident tree or the dense cache included); each
    step launched one self and one cross decode a decoder layer (paged:
    paged decode for self; dense: dense decode for both)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        paged_decode_attention,
    )
    tm = Model(t_smoke_config(t_get_arch("seamless-m4t-large-v2"))
               .replace(dtype="float32"))
    tp = tm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    kw = {"batch_slots": 2, "max_len": 64, "page_size": PAGE,
          "prefill_chunk": 8, **kw}
    graphed = ContinuousBatcher(tm, tp, device=dev, **kw)
    eager = ContinuousBatcher(tm, tp, device=dev, **kw)
    eager.step_graph = None
    src = np.random.RandomState(2).randn(30, tm.cfg.d_model).astype(
        np.float32)
    for bat in (graphed, eager):
        for i, (p, s) in enumerate(zip(_prompts(tm.cfg.vocab, [3, 9]),
                                       (src, None))):
            bat.submit(Request(rid=i, prompt=p, max_new_tokens=16, src=s))
        bat.step()
    for dst, s in zip(tree_leaves(eager._decode_state()[1:]),
                      tree_leaves(graphed._decode_state()[1:])):
        dst.copy_(s)
    L = tm.cfg.num_layers
    for _ in range(12):
        n0 = (decode_attention.launches, paged_decode_attention.launches)
        graphed.step()
        n1 = (decode_attention.launches, paged_decode_attention.launches)
        eager.step()
        assert [r.output for r in graphed.slot_req] == \
            [r.output for r in eager.slot_req]
        assert (n1[0] - n0[0], n1[1] - n0[1]) == (
            (2 * L, 0) if graphed.pool is None else (L, L))
    torch.cuda.synchronize()
    g = graphed.step_graph.stats()["decode"]
    assert g["replays"] >= 12 - g["eager_calls"]
    leaves = list(zip(tree_leaves(graphed._decode_state()[1:]),
                      tree_leaves(eager._decode_state()[1:])))
    bitwise = all(torch.equal(a, b) for a, b in leaves)
    print(f"[step graph] seamless {'dense' if 'kv_pool' in kw else 'paged'}: {g}; state "
          f"leaves bitwise equal: {bitwise}")
    assert bitwise
    graphed.close()


@pytest.mark.cuda
def test_replays_draw_new_numbers_at_temperature(dev):
    """At temperature 0.8 each replay draws afresh (the batcher's
    generator is registered with the graph): the same inputs give other
    tokens from call to call, and the graphed draws are the eager ones."""
    tm, graphed, eager = _pair(dev, "qwen3-4b", {}, temperature=0.8)
    outs = {}
    for name, bat in (("graphed", graphed), ("eager", eager)):
        for _ in range(13):
            bat.step()
        outs[name] = [r.output for r in bat.slot_req]
    same = outs["graphed"] == outs["eager"]
    key = paged_key(int(graphed.pos.max()) // PAGE + 1,
                    graphed.pool.n_logical)
    host = {"tokens": graphed.cur_tok[:, None], "pos": graphed.pos,
            "block_table": graphed.pool.block_table[:, :key[1]]}
    draws = [tuple(graphed._decode(key, host).tolist()) for _ in range(8)]
    print(f"[step graph] temperature 0.8: graphed draws equal eager draws: "
          f"{same}; 8 replays at fixed inputs drew {len(set(draws))} "
          f"distinct token pairs")
    assert graphed.step_graph.stats()["decode"]["replays"] > 8
    assert len(set(draws)) > 1
    assert same
    graphed.close()


@pytest.mark.cuda
def test_moved_state_raises(dev):
    tm, graphed, _ = _pair(dev, "qwen3-4b", {"kv_pool": None})
    for _ in range(3):                   # (eager,) capture and replays
        graphed.step()
    assert graphed.step_graph.stats()["decode"]["captures"] == 1
    node = graphed.cache["layers"]
    graphed.cache["layers"] = type(node)(*(a.clone() for a in node))
    with pytest.raises(RuntimeError, match="moved"):
        graphed.step()


@pytest.mark.cuda
def test_capture_failure_raises(dev):
    """A step that reads a device value back to the host cannot be
    captured: the capture raises, nothing steps eagerly in its place, and
    the launch counters stay as they were.  It runs in a child process: a
    failed capture leaves PyTorch's CUDA generators in capture mode, so
    the process that saw it draws no more random numbers on the card."""
    child = textwrap.dedent("""
        import numpy as np
        import torch
        from repro_torch.kernels import _build
        from repro_torch.serve.step_graph import DENSE_KEY, StepGraph

        graphs = StepGraph("cuda")
        x = torch.ones(4, device="cuda")

        def fn(state, inputs):
            (t,) = state
            t.add_(inputs["pos"].float().sum().item())
            return inputs["tokens"][:, 0], state

        host = {"tokens": np.zeros((4, 1), np.int32),
                "pos": np.arange(4, dtype=np.int32)}
        graphs(DENSE_KEY, fn, (x,), host)   # the path's first call: eager
        counts = _build.launch_counts()
        try:
            graphs(DENSE_KEY, fn, (x,), host)
        except RuntimeError as e:
            print("capture raised", type(e).__name__)
        g = graphs.stats()["decode"]
        assert g["replays"] == 0 and g["captures"] == 0, g
        assert _build.launch_counts() == counts
        assert x.tolist() == [7.0] * 4
    """)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "capture raised" in out.stdout
