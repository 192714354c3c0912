"""The port's ContinuousBatcher against the JAX one (CPU, float32).

The harness of ``tests/test_kvpool.py`` (MAX_LEN 32, CHUNK 8, PAGE 8):
the same prompts, sharing an 18-token prefix, through both batchers with
the same weights (JAX ``Model.init(PRNGKey(0))`` through the weight
bridge).  Greedy tokens must be identical cold and on warm prefix hits,
with float and int8 pages, and the port's pool must hold no page for a
request after the drain.
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
from repro_torch.serve.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.serve.batcher import Request  # noqa: E402

MAX_LEN = 32
CHUNK = 8
PAGE = 8
_CACHE = {}


def _models():
    if not _CACHE:
        jcfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
        tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32")
        jm = build_model(jcfg, single_device_ctx())
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
            dtype=torch.float32, device="cpu")
        _CACHE["models"] = (jm, jp, Model(tcfg), tp)
    return _CACHE["models"]


def _requests(cls, vocab, lens, *, shared=18, max_new=4, seed=0, rid0=0):
    """Prompts sharing a ``shared``-token prefix (seeded separately)."""
    sysp = np.random.RandomState(1234).randint(1, vocab, size=shared)
    rng = np.random.RandomState(seed)
    return [cls(rid=rid0 + i, max_new_tokens=max_new,
                prompt=np.concatenate([sysp, rng.randint(1, vocab, size=L)])
                .astype(np.int32))
            for i, L in enumerate(lens)]


def _serve(port: bool, kv_dtype, waves):
    """Run ``waves`` (lists of (lens, seed, rid0)) through one batcher,
    draining between waves.  Returns ({rid: tokens}, the pool)."""
    jm, jp, tm, tp = _models()
    if port:
        bat = ContinuousBatcher(tm, tp, batch_slots=2, max_len=MAX_LEN,
                                prefill_chunk=CHUNK, page_size=PAGE,
                                kv_dtype=kv_dtype, device="cpu")
        cls = Request
    else:
        bat = JBatcher(jm, jp, batch_slots=2, max_len=MAX_LEN,
                       prefill_chunk=CHUNK, page_size=PAGE, kv_dtype=kv_dtype)
        cls = JRequest
    for lens, seed, rid0 in waves:
        for r in _requests(cls, jm.cfg.vocab, lens, seed=seed, rid0=rid0):
            bat.submit(r)
        bat.run_until_drained()
    return {r.rid: r.output for r in bat.done}, bat.pool


# wave 1: requests 0 and 1 are admitted in one tick into an empty tree
# (cold), request 2 then hits their 16-token prefix; wave 2 (10, 11) hits
# it too
WARM = [([3, 5, 2], 0, 0), ([4, 7], 5, 10)]
COLD_RIDS, WARM_RIDS = (0, 1), (2, 10, 11)


def _both(kv_dtype):
    if kv_dtype not in _CACHE:
        _CACHE[kv_dtype] = (_serve(False, kv_dtype, WARM),
                            _serve(True, kv_dtype, WARM))
    return _CACHE[kv_dtype]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cold_tokens_match_jax(kv_dtype):
    (jout, _), (tout, _) = _both(kv_dtype)
    assert {r: tout[r] for r in COLD_RIDS} == {r: jout[r] for r in COLD_RIDS}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_warm_prefix_hit_tokens_match_jax(kv_dtype):
    (jout, jpool), (tout, tpool) = _both(kv_dtype)
    assert tpool.prefix_hit_tokens >= 3 * 16          # 2 pages x 3 reqs
    assert tpool.prefix_hit_tokens == jpool.prefix_hit_tokens
    assert {r: tout[r] for r in WARM_RIDS} == {r: jout[r] for r in WARM_RIDS}


def test_warm_equals_cold_in_the_port():
    """Prefix-hit serving is token-identical to cold serving: wave 2 on a
    fresh batcher (both admitted in one tick, no hit) gives the tokens it
    gave behind the warm tree."""
    (_, _), (warm, _) = _both(None)
    cold, pool = _serve(True, None, [([4, 7], 5, 10)])
    assert pool.prefix_hit_tokens == 0
    assert cold == {r: warm[r] for r in (10, 11)}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_releases_every_request_page(kv_dtype):
    """After the drain no page is held for a request: every allocated page
    is interned refcount-0 cache, and every refcount is 0."""
    (_, _), (_, pool) = _both(kv_dtype)
    nodes = list(pool.tree._walk())
    assert nodes and all(n.refs == 0 for n in nodes)
    assert pool.pages_in_use == pool.tree.interned == pool.evictable_pages()
    assert (pool.block_table == pool.sentinel).all()
    assert not any(pool._pocket) and not any(pool._private)


def test_launch_serve_on_cpu():
    assert t_serve.main(["--device", "cpu", "--requests", "4", "--max-new",
                         "4", "--max-len", "64"]) == 0


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, _, tm, tp = _models()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(tm, tp, batch_slots=2, max_len=MAX_LEN,
                          page_size=PAGE)


def test_tenant_quotas_and_public_prefix_match_jax():
    """Two quota'd tenants (page pockets) and a public prompt whose prefix
    the other tenant maps read-only: same tokens, same hits and the same
    per-pocket page charges as the JAX batcher."""
    from repro.core.spec import TenantSpec
    jm, jp, tm, tp = _models()
    tenants = [TenantSpec("a", page_quota=0.4, weight=2.0),
               TenantSpec("b", page_quota=0.3)]
    results = []
    for port in (False, True):
        kw = dict(batch_slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
                  page_size=PAGE, tenants=tenants)
        if port:
            bat, cls = ContinuousBatcher(tm, tp, device="cpu", **kw), Request
        else:
            bat, cls = JBatcher(jm, jp, **kw), JRequest
        waves = [([5, 3], 0, 0), ([4, 6, 2], 5, 10)]
        for w, (lens, seed, rid0) in enumerate(waves):
            for i, r in enumerate(_requests(cls, jm.cfg.vocab, lens,
                                            seed=seed, rid0=rid0)):
                r.tenant = "ab"[i % 2]
                r.public = w == 0 and i == 0
                bat.submit(r)
            bat.run_until_drained()
        pool = bat.pool
        results.append(({r.rid: r.output for r in bat.done},
                        pool.prefix_hit_tokens, dict(pool.used),
                        pool.tree.interned))
    assert results[1] == results[0]
    assert results[1][1] > 0                     # someone hit a prefix


def test_pool_exhaustion_blocks_and_evicts_like_jax():
    """A pool of 6 pages under 2 slots whose requests need 4 pages each:
    admission blocks (requests wait queued) and refcount-0 prefixes are
    LRU-evicted, with the same tokens, hits and evictions as JAX."""
    jm, jp, tm, tp = _models()
    results = []
    for port in (False, True):
        kw = dict(batch_slots=2, max_len=MAX_LEN, prefill_chunk=CHUNK,
                  page_size=PAGE, pool_pages=6)
        if port:
            bat, cls = ContinuousBatcher(tm, tp, device="cpu", **kw), Request
        else:
            bat, cls = JBatcher(jm, jp, **kw), JRequest
        for lens, seed, rid0 in ([5, 3, 7], 0, 0), ([4, 6], 5, 10):
            for r in _requests(cls, jm.cfg.vocab, lens, seed=seed,
                               rid0=rid0):
                bat.submit(r)
            bat.run_until_drained()
        pool = bat.pool
        results.append(({r.rid: r.output for r in bat.done},
                         pool.prefix_hit_tokens, pool.pages_evicted,
                         pool.pages_in_use))
    assert results[1] == results[0]
    assert results[1][2] > 0                     # something was evicted
