"""The port's disaggregation primitives against the JAX package's (CPU,
float32), call for call.

* Pool: ``intern_rows``, ``alloc_temp_pages`` / ``free_temp_pages``,
  ``intern_arena_pages``, ``available_pages``, ``read_pages``,
  ``export_subtree`` / ``import_subtree`` and ``release_all`` on a
  slot-less pool and a decode pool, with float32 and int8 arenas: the
  same page ids, free lists, tree (keys, pages, refcounts, owners),
  exported records and page data (int8: within one quantum).
* Batcher: ``install_paged``, ``install_prefilled`` (a paged pool and the
  dense cache), ``install_snapshot`` with a chain, ``export_slot`` then
  ``adopt_slot`` into another batcher (qwen3-4b, and
  seamless-m4t-large-v2, whose resident rows, the cross memory and
  ``src_len``, travel with the slot) and ``drop_slot``: the same block
  tables, cursors, carried state and the tokens decoded afterwards.
  Payloads come from each package's own prefill worker.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402

from repro.serve import kvpool as j_kvpool  # noqa: E402
from repro_torch.serve import kvpool as t_kvpool  # noqa: E402
from test_torch_cacheplane import _model, _pool, _zero_cache  # noqa: E402
from test_torch_disagg import Side  # noqa: E402

MAX_LEN = 32
PAGE = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaves(side, tree):
    if side.port:
        from repro_torch.models.param import tree_leaves
        return [_np(t) for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)]
    return [_np(t) for t in jax.tree.leaves(tree)]


def _tree(pool):
    """Every interned node: (path of chunk keys, page, refs, owner)."""
    out = []
    for ctx, root in pool.tree._roots.items():
        stack = [(root, (repr(ctx),))]
        while stack:
            node, path = stack.pop()
            for key, child in node.children.items():
                p = path + (key,)
                out.append((p, child.page, child.refs, child.owner))
                stack.append((child, p))
    return sorted(out, key=repr)


def _pool_state(pool):
    return {"free": list(pool.free), "tree": _tree(pool),
            "in_use": pool.pages_in_use, "available": pool.available_pages(),
            "block_table": pool.block_table.tolist()}


def _random_cache(side, model, seed=0):
    """A 1-row dense cache of random K/V, every position written."""
    cache = _zero_cache(side, model)
    rng = np.random.RandomState(seed)
    vals = []
    for a in _leaves(side, cache):
        if a.dtype.kind == "i":         # slot_pos: every position written
            vals.append(np.broadcast_to(np.arange(a.shape[-1], dtype=a.dtype),
                                        a.shape).copy())
        else:
            vals.append(rng.randn(*a.shape).astype(np.float32))
    if not side.port:
        return jax.tree.unflatten(jax.tree.structure(cache),
                                  [jax.numpy.asarray(v) for v in vals])
    from repro_torch.models.param import tree_leaves
    for t, v in zip(tree_leaves(cache), vals):
        t.copy_(torch.from_numpy(v))
    return cache


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_primitives_match_jax(kv_dtype):
    def run(side):
        model = _model(side)
        kvmod = t_kvpool if side.port else j_kvpool
        cache = _random_cache(side, model)
        rng = np.random.RandomState(1)
        p1 = rng.randint(1, side.cfg.vocab, size=30).astype(np.int32)
        p2 = np.concatenate([p1[:17], rng.randint(1, side.cfg.vocab, 12)
                             .astype(np.int32)])
        log = {}
        pool = _pool(side, model, num_pages=12, kv_dtype=kv_dtype)
        pool.intern_rows(p1, None, cache, 0)
        log["interned"] = _pool_state(pool)
        lease = pool.lease(p2, None)
        temps = pool.alloc_temp_pages(-(-len(p2) // PAGE) - lease.pages)
        log["temps"] = (lease.pages, list(temps), _pool_state(pool))
        pool.intern_arena_pages(p2, None, lease, temps)
        pool.release_lease(lease)
        log["arena_interned"] = _pool_state(pool)
        extra = pool.alloc_temp_pages(2)
        pool.free_temp_pages(extra)
        log["temp_roundtrip"] = (list(extra), _pool_state(pool))
        ids = [n.page for n in pool.tree.match(p1, None)]
        log["read"] = (ids, _leaves(side, pool.read_pages(ids)))
        records, stacks = pool.export_subtree(None)
        log["export"] = ([(tuple(r["key"]), r["owner"], r["parent"])
                          for r in records], _leaves(side, stacks))
        dst = _pool(side, model, slots=2, kv_dtype=kv_dtype)
        log["imported"] = dst.import_subtree(None, records, stacks)
        le = dst.lease(p2, None)
        dst.admit(0, le, len(p2), 2)
        log["admitted"] = _pool_state(dst)
        dst.release_all()
        log["released"] = _pool_state(dst)
        log["dst_pages"] = _leaves(side, dst.read_pages(
            [n.page for n in dst.tree.match(p1, None)]))
        # exhaustion evicts the reclaimable cache on its way, then holds
        # nothing
        with pytest.raises(kvmod.PoolExhausted):
            pool.alloc_temp_pages(13)
        log["exhausted"] = _pool_state(pool)
        return log

    j, t = (run(Side(port, "qwen3-4b")) for port in (False, True))
    data = ("read", "export", "dst_pages")
    assert {k: v for k, v in t.items() if k not in data} == \
        {k: v for k, v in j.items() if k not in data}
    assert t["read"][0] == j["read"][0] and t["export"][0] == j["export"][0]
    for k in data:
        got = t[k][1] if k != "dst_pages" else t[k]
        want = j[k][1] if k != "dst_pages" else j[k]
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            # float32 pages bit for bit; int8 codes may round a .5 edge
            # apart, so one quantum (max |x| / 127 <= 5 / 127)
            tol = 0 if kv_dtype is None else 5 / 127
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _worker(side, page_size=PAGE):
    sup = side.supervisor(1)
    cell = sup.create_cell("p", side.cfg, "serve", ncols=1)
    side.init(cell)
    return side.disagg.PrefillWorker(cell, max_len=MAX_LEN, chunk=8,
                                     page_size=page_size)


def _batcher(side, **kw):
    extra = {"device": "cpu"} if side.port else {}
    return side.ContinuousBatcher(
        _model(side), side.params, batch_slots=3, max_len=MAX_LEN,
        prefill_chunk=None, page_size=PAGE, **kw, **extra)


def _steps(bat, n):
    for _ in range(n):
        bat.step()
    return {s: (list(r.output) if r is not None else None)
            for s, r in enumerate(bat.slot_req)}


def _slots(side, bat):
    out = {"pos": bat.pos.tolist(), "cur_tok": bat.cur_tok.tolist(),
           "busy": [r.rid if r is not None else None for r in bat.slot_req]}
    if bat.pool is not None:
        out["pool"] = _pool_state(bat.pool)
    return out


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-large-v2"])
def test_batcher_paged_primitives_match_jax(arch):
    def run(side):
        kvmod = t_kvpool if side.port else j_kvpool
        worker = _worker(side)
        reqs = side.requests([21, 13], max_new=8, seed=3,
                             srcs=side.cfg.family == "encdec")
        # the third shares request 1's first two pages (and source)
        rng = np.random.RandomState(8)
        reqs.append(side.Request(
            rid=2, max_new_tokens=8, src=reqs[1].src,
            prompt=np.concatenate([reqs[1].prompt[:16], rng.randint(
                1, side.cfg.vocab, size=10).astype(np.int32)])))
        a, c = _batcher(side), _batcher(side)
        log = {}
        for req in reqs[:2]:
            tok, payload = worker.prefill(req)
            lease = a.pool.lease(req.prompt, kvmod.request_ctx_key(req))
            assert a.install_paged(req, payload["stacks"],
                                   payload["resident"], 0, tok, lease)
        log["installed"] = _slots(side, a)
        log["decoded"] = _steps(a, 3)
        snap = a.export_slot(1)
        log["export"] = (snap["pos"], snap["cur_tok"], snap["req"].rid,
                         _leaves(side, snap["stacks"]),
                         _leaves(side, snap["resident"]))
        # the third request on the target first: request 1's first page
        # is then interned there, and only the rest of its stacks installs
        tok, payload = worker.prefill(reqs[2])
        lease = c.pool.lease(reqs[2].prompt,
                             kvmod.request_ctx_key(reqs[2]))
        assert c.install_paged(reqs[2], payload["stacks"],
                               payload["resident"], 0, tok, lease)
        assert c.adopt_slot(snap["req"], snap["stacks"], snap["resident"],
                            snap["pos"], snap["cur_tok"])
        a.drop_slot(1)
        log["adopted"] = (_slots(side, a), _slots(side, c))
        if side.port:
            assert c.prompt_cursor[1] == len(snap["req"].prompt)
            assert a.prompt_cursor[1] == 0
        if side.port and side.cfg.family == "encdec":
            from repro_torch.models.cache_utils import slice_cache_slots
            row = slice_cache_slots(c.resident, c._resident_axes, [1])
            log["resident"] = _leaves(side, row)
        elif side.cfg.family == "encdec":
            from repro.models.cache_utils import slice_cache_slots
            row = slice_cache_slots(c.resident, c._resident_axes, [1])
            log["resident"] = _leaves(side, row)
        log["after"] = (_steps(a, 4), _steps(c, 4))
        return log

    j, t = (run(Side(port, arch)) for port in (False, True))
    for k in ("installed", "decoded", "adopted", "after"):
        assert t[k] == j[k], k
    assert t["export"][:3] == j["export"][:3]
    for got, want in ((t["export"][3], j["export"][3]),
                      (t["export"][4], j["export"][4]),
                      (t.get("resident", []), j.get("resident", []))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if arch == "seamless-m4t-large-v2":
        assert t["export"][4] and t["resident"]   # the cross memory moved


def test_install_prefilled_matches_jax():
    """A 1-row dense payload (a pool-less worker: page 5 does not divide
    max_len) installed into a paged batcher and into the dense cache."""
    def run(side):
        worker = _worker(side, page_size=5)
        assert worker.pool is None
        reqs = side.requests([19, 9], max_new=6, seed=4)
        paged, dense = _batcher(side), _batcher(side, kv_pool=None)
        for req in reqs:
            tok, row = worker.prefill(req)
            assert paged.install_prefilled(req, row, tok)
        log = {"paged": _slots(side, paged), "paged_out": _steps(paged, 5)}
        for req in side.requests([19, 9], max_new=6, seed=4):
            tok, row = worker.prefill(req)
            assert dense.install_prefilled(req, row, tok)
        log["dense"] = _slots(side, dense)
        log["dense_out"] = _steps(dense, 5)
        return log

    j, t = (run(Side(port, "qwen3-4b")) for port in (False, True))
    assert t == j
    assert t["paged_out"] == t["dense_out"]


def test_install_snapshot_matches_jax():
    """mamba2 on the snapshot plane: a cold payload's chain interns in the
    replica's pool, a second request with that prefix routes warm."""
    def run(side):
        worker = _worker(side)
        bat = _batcher(side)
        rng = np.random.RandomState(6)
        shared = rng.randint(1, side.cfg.vocab, size=17).astype(np.int32)
        reqs = [side.Request(rid=i, max_new_tokens=5, prompt=np.concatenate(
            [shared, rng.randint(1, side.cfg.vocab, size=n).astype(np.int32)]))
            for i, n in enumerate((4, 6))]
        log = []
        for req in reqs:
            tok, payload = worker.prefill(req)
            assert bat.install_snapshot(req, payload["row"], tok,
                                        chain=payload["chain"])
            log.append((tok, len(payload["chain"] or []),
                        bat.pool.stats()["snapshots_interned"],
                        _tree(bat.pool)))
        log.append(_steps(bat, 4))
        log.append(worker.pool.stats()["prefix_hit_tokens"])
        return log

    j, t = (run(Side(port, "mamba2-2.7b")) for port in (False, True))
    assert t == j
    assert t[0][2] > 0 and t[-1] > 0      # interned; the worker hit warm


def test_run_prefill_prompt_matches_jax():
    """``serve_step.run_prefill_prompt`` / ``run_prefill_prompts``: the
    first tokens and the written cache rows of JAX's, over a batcher's own
    prefill step and scratch cache."""
    from repro.serve import serve_step as j_ss
    from repro_torch.serve import serve_step as t_ss
    j, t = Side(False, "qwen3-4b"), Side(True, "qwen3-4b")
    rng = np.random.RandomState(9)
    prompts = [rng.randint(1, j.cfg.vocab, size=n).astype(np.int32)
               for n in (11, 14, 9)]
    jm, tm = _model(j), _model(t)
    step = jax.jit(j_ss.build_prefill_step(jm))
    bat = t.ContinuousBatcher(tm, t.params, batch_slots=4, max_len=MAX_LEN,
                              prefill_chunk=8, page_size=PAGE, device="cpu")
    kw = dict(chunk=8, max_len=MAX_LEN)
    jtok, jrow, _ = j_ss.run_prefill_prompt(
        step, j.params, jm.init_cache(1, MAX_LEN), prompts[0],
        rng=jax.random.PRNGKey(0), model=jm, **kw)
    ttok, key = t_ss.run_prefill_prompt(bat._prefill_call, prompts[0],
                                        model=tm, **kw)
    assert ttok == jtok and key == ("prefill", 1, 16)
    L = len(prompts[0])
    got = _leaves(t, bat._scratch(1))
    want = [np.asarray(x) for x in jax.tree.leaves(jrow)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[:, :, :L], b[:, :, :L], rtol=1e-5,
                                   atol=1e-5)
    # three prompts of one bucket: JAX's row count, the port's padding to 4
    jtoks, _, _ = j_ss.run_prefill_prompts(
        step, j.params, jm.init_cache(3, MAX_LEN), prompts,
        rng=jax.random.PRNGKey(0), model=jm, **kw)
    ttoks, key = t_ss.run_prefill_prompts(bat._prefill_call, prompts,
                                          model=tm, **kw)
    assert ttoks[:3] == jtoks and key == ("prefill", 4, 16)
