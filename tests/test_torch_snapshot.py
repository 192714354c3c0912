"""The port's snapshot cache plane against JAX (CPU, float32 greedy).

Mirrors ``tests/test_snapshot_cache.py`` on the port: the capability
three-way, eviction that reaps interned payloads, and warm == cold greedy
tokens for mamba2-2.7b and zamba2-2.7b at smoke size (a warm request
restores its prefix from an interned chunk-boundary snapshot chain and
extends only its suffix), with every lease ref back to 0.  The same
tokens are held against the JAX ``ContinuousBatcher``'s: cold and warm on
the snapshot pool, on the dense per-slot cache (``kv_pool=None``) and
token at a time (``prefill_chunk=None``, which resets a reused slot's
recurrent state).  The ssm and hybrid decode, prefill and extend steps
read nothing back to the host.
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
from repro_torch.serve.kvpool import KVPool  # noqa: E402

MAX_LEN, PAGE, CHUNK = 64, 8, 8
SNAP_ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
_MODELS, _RUNS = {}, {}


def _models(arch):
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


def _prompts(vocab):
    """A 40-token system prompt with four tails (5, 7, 3, 9 tokens)."""
    rng = np.random.RandomState(0)
    sysp = rng.randint(1, vocab, size=40)
    return [np.concatenate([sysp, rng.randint(1, vocab, size=n)])
            .astype(np.int32) for n in (5, 7, 3, 9)]


def _serve(port, arch, waves, *, fresh_each=False, **kw):
    """Serve ``waves`` of prompts (draining between waves) through one
    batcher, or a fresh batcher per prompt with ``fresh_each``.  Returns
    ({rid: tokens}, the last batcher)."""
    jm, jp, tm, tp = _models(arch)
    kw = {"batch_slots": 2, "max_len": MAX_LEN, "page_size": PAGE,
          "prefill_chunk": CHUNK, **kw}
    out, bat, rid = {}, None, 0
    for wave in waves:
        for p in wave:
            if bat is None or fresh_each:
                bat = (ContinuousBatcher(tm, tp, device="cpu", **kw) if port
                       else JBatcher(jm, jp, **kw))
            bat.submit((Request if port else JRequest)(
                rid=rid, prompt=p, max_new_tokens=5))
            rid += 1
            if fresh_each:
                out.update({r.rid: r.output for r in bat.run_until_drained()})
        out.update({r.rid: r.output for r in bat.run_until_drained()})
    return out, bat


CASES = {
    "snapshot": {},
    "dense": {"kv_pool": None},
    "token-at-a-time": {"prefill_chunk": None},
}


def _both(arch, case):
    key = (arch, case)
    if key not in _RUNS:
        p = _prompts(_models(arch)[0].cfg.vocab)
        waves = [p[:2], p[2:]]              # wave 2 hits wave 1's chain
        _RUNS[key] = (_serve(False, arch, waves, **CASES[case]),
                      _serve(True, arch, waves, **CASES[case]))
    return _RUNS[key]


def test_capability_three_way():
    tm = _models("mamba2-2.7b")[2]
    assert KVPool.capability(tm, MAX_LEN, PAGE) == "snapshot"
    assert KVPool.capability(tm, MAX_LEN + 1, PAGE) == "none"
    qwen = Model(t_smoke_config(t_get_arch("qwen3-4b")))
    assert KVPool.capability(qwen, MAX_LEN, PAGE) == "paged"


def _payloads(tag, n):
    """n fake chunk payloads: the pool never looks inside one."""
    return [{"state": np.asarray([tag, lp], np.int64), "pages": []}
            for lp in range(n)]


def test_snapshot_eviction_reaps_payloads():
    """Handle pressure evicts refcount-0 leaves and their payloads: no
    orphaned payload, occupancy within the handle supply, and a leased
    chain survives the squeeze."""
    tm = _models("mamba2-2.7b")[2]
    pool = KVPool(tm, max_len=32, page_size=PAGE, num_pages=4, device="cpu")
    assert pool.payload_kind == "snapshot" and pool.arena == []
    a = np.asarray([1] * 32, np.int32)
    pool.intern_snapshots(a, None, _payloads(0, 4))
    lease = pool.lease(a, None)
    assert len(lease.nodes) == (32 - 1) // PAGE
    b = np.asarray([2] * 32, np.int32)
    pool.intern_snapshots(b, None, _payloads(1, 4))
    assert pool.pages_in_use <= pool.num_pages
    assert set(n.page for n in pool.tree._walk()) == set(pool._snaps)
    assert pool.pages_evicted >= 1
    state, stacks = pool.snapshot_chain(lease)
    assert stacks == []
    assert np.array_equal(state, np.asarray([0, len(lease.nodes) - 1]))
    pool.release_lease(lease)
    assert all(n.refs == 0 for n in pool.tree._walk())


@pytest.mark.parametrize("arch", SNAP_ARCHS)
def test_snapshot_restore_exact(arch):
    """Warm (wave 2 restores the 40-token prefix from wave 1's chain and
    extends only its tail) == cold (a fresh batcher per prompt), with the
    snapshot counters set and every ref back to 0."""
    p = _prompts(_models(arch)[0].cfg.vocab)
    cold, _ = _serve(True, arch, [p[:2], p[2:]], fresh_each=True)
    (_, _), (warm, bat) = _both(arch, "snapshot")
    assert warm == cold
    st = bat.pool.stats()
    assert st["snapshot_hit_tokens"] == 2 * 40
    assert st["snapshot_bytes_saved"] > 0 and st["snapshots_interned"] > 0
    assert all(n.refs == 0 for n in bat.pool.tree._walk())
    assert not any(bat.pool._shared)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", SNAP_ARCHS)
def test_tokens_match_jax(arch, case):
    (jout, jbat), (tout, tbat) = _both(arch, case)
    assert tout == jout
    assert tbat.prefill_invocations == jbat.prefill_invocations
    assert tbat.decode_invocations == jbat.decode_invocations
    if case == "snapshot":
        js, ts = jbat.pool.stats(), tbat.pool.stats()
        for k in ("snapshot_hit_tokens", "snapshots_interned",
                  "snapshot_bytes_saved", "prefix_miss_tokens",
                  "interned_pages"):
            assert ts[k] == js[k], k
        assert tbat.prefill_chunk == jbat.prefill_chunk


@pytest.mark.parametrize("arch", SNAP_ARCHS)
def test_token_at_a_time_admit_resets_a_reused_slot(arch):
    """One slot, two prompts token at a time: the second request's tokens
    equal its tokens on a fresh batcher (the first request's recurrent
    state was reset, not integrated)."""
    p = _prompts(_models(arch)[0].cfg.vocab)
    kw = dict(batch_slots=1, prefill_chunk=None)
    shared, _ = _serve(True, arch, [p[:2]], **kw)
    alone, _ = _serve(True, arch, [p[1:2]], **kw)
    assert shared[1] == alone[0]


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()
            if e.name in ("aten::item", "aten::_local_scalar_dense",
                          "aten::nonzero")]


@pytest.mark.parametrize("arch", SNAP_ARCHS)
def test_steps_read_nothing_back_to_the_host(arch):
    """The decode step, the checkpointing prefill step and the dense
    suffix-extend step of the snapshot plane issue no op that reads a
    device value back to the host."""
    _, _, tm, tp = _models(arch)
    bat = ContinuousBatcher(tm, tp, batch_slots=2, max_len=MAX_LEN,
                            page_size=PAGE, prefill_chunk=CHUNK,
                            device="cpu")
    for i, p in enumerate(_prompts(tm.cfg.vocab)[:2]):
        bat.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    for _ in range(3):
        bat.step()
    dec = {"tokens": torch.from_numpy(bat.cur_tok[:, None].copy()),
           "pos": torch.from_numpy(bat.pos.copy())}
    assert not _profiled(lambda: bat._step(tp, bat.cache, dec, None))
    toks = torch.zeros((2, 48), dtype=torch.int32)
    for i, q in enumerate(_prompts(tm.cfg.vocab)[:2]):
        toks[i, :len(q)] = torch.from_numpy(q)
    pre = {"tokens": toks, "length": torch.tensor([45, 47],
                                                  dtype=torch.int32)}
    assert not _profiled(lambda: bat._prefill(tp, bat._scratch(2), pre, None))
    ext = {"tokens": toks[:, :16],
           "pos": torch.tensor([16, MAX_LEN], dtype=torch.int32),
           "length": torch.tensor([16, 0], dtype=torch.int32)}
    assert not _profiled(lambda: bat._extend(tp, bat.cache, ext, None))


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-2.7b", []),
    ("zamba2-2.7b", []),
    ("mamba2-2.7b", ["--prefill-chunk", "0"]),
])
def test_launch_serve_on_cpu(arch, extra):
    assert t_serve.main(["--device", "cpu", "--arch", arch, "--requests",
                         "3", "--max-new", "3", "--max-len", "64"]
                        + extra) == 0
