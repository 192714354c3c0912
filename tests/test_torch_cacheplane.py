"""The port's cluster cache plane against the JAX package's (CPU, float32).

Every scenario of ``tests/test_cacheplane.py`` runs through both packages
(``tests/test_torch_disagg.py``'s ``Side``: the same weights and
requests): chunk digests and replica adverts, prefix-index routing, a
pool warmed only by ``export_subtree`` / ``import_subtree`` (dense, moe
and encdec), ``migrate_prefixes`` over a ``pages`` channel, warm routing
in ``DisaggServer.pump`` and drain before detach (``migrate=True``, by
``sync`` and from the reconciler's drain hook).  Digests, adverts,
exported records, routing decisions (``routed_warm``, ``routed_cold``),
``pages_migrated``, ``drain_handoffs`` and tokens must be identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from repro.serve import cacheplane as j_cp  # noqa: E402
from repro.serve import kvpool as j_kvpool  # noqa: E402
from repro_torch.serve import cacheplane as t_cp  # noqa: E402
from repro_torch.serve import kvpool as t_kvpool  # noqa: E402
from test_torch_disagg import Side, counters  # noqa: E402

MAX_LEN = 32
CHUNK = 8
PAGE = 8
FAMILY_ARCHS = ["qwen3-4b", "mixtral-8x7b", "seamless-m4t-large-v2"]


def _cp(side):
    return t_cp if side.port else j_cp


def _pool(side, model, **kw):
    mod = t_kvpool if side.port else j_kvpool
    if side.port:
        kw["device"] = "cpu"
    return mod.KVPool(model, max_len=MAX_LEN, page_size=PAGE, **kw)


def _model(side):
    if side.port:
        from repro_torch.models.model import Model
        return Model(side.cfg)
    from repro.models.model import build_model
    from repro.sharding.rules import single_device_ctx
    return build_model(side.cfg, single_device_ctx())


def _zero_cache(side, model):
    if side.port:
        return model.init_cache(1, MAX_LEN, device="cpu")
    return model.init_cache(1, MAX_LEN)


def _requests(side, lens, *, shared=0, max_new=4, seed=0, rid0=0):
    """The requests of ``tests/test_cacheplane.py``'s ``_requests``."""
    cfg = side.cfg
    srng = np.random.RandomState(1234)
    sysp = srng.randint(1, cfg.vocab, size=shared).astype(np.int32)
    rng = np.random.RandomState(seed)
    out = []
    for i, L in enumerate(lens):
        tail = rng.randint(1, cfg.vocab, size=L).astype(np.int32)
        src = None
        if cfg.family == "encdec":
            src = np.random.RandomState(99).randn(
                9, cfg.d_model).astype(np.float32)
        out.append(side.Request(rid=rid0 + i, max_new_tokens=max_new,
                                prompt=np.concatenate([sysp, tail]), src=src))
    return out


def _both(fn, arch="qwen3-4b"):
    """``fn(side)`` through both packages; they must agree."""
    j, t = (fn(Side(port, arch)) for port in (False, True))
    assert t == j
    return t


def _adverts(side, pool):
    return sorted((e["digest"], e["depth"], e["refs"])
                  for e in _cp(side).advertise(pool))


# ---------------------------------------------------------------------------
def test_advert_matches_chunk_digests():
    def run(side):
        model = _model(side)
        pool = _pool(side, model, slots=2)
        rng = np.random.RandomState(0)
        prompt = rng.randint(1, side.cfg.vocab,
                             size=MAX_LEN - 2).astype(np.int32)
        pool.intern_rows(prompt, None, _zero_cache(side, model), 0)
        cp = _cp(side)
        return {"adverts": _adverts(side, pool),
                "digests": cp.chunk_digests(prompt, None, PAGE),
                "tenant": cp.chunk_digests(prompt, ("tenant", "a"), PAGE)}

    out = _both(run)
    assert out["digests"] and {d for d, _, _ in out["adverts"]} == \
        set(out["digests"])
    assert set(out["tenant"]).isdisjoint(out["digests"])


def test_prefix_index_routing_deterministic():
    def run(side):
        idx = _cp(side).PrefixIndex()
        d = [f"d{i}" for i in range(4)]
        out = []
        idx.update("r0", [{"digest": d[0], "depth": 1, "refs": 0}])
        idx.update("r1", [{"digest": d[0], "depth": 1, "refs": 0},
                          {"digest": d[1], "depth": 2, "refs": 1}])
        out += [idx.best(d, ["r0", "r1"]), idx.best(d[:1], ["r0", "r1"]),
                idx.best(d[:1], ["r1", "r0"])]
        idx.update("r1", [{"digest": d[0], "depth": 1, "refs": 0}])
        out.append(idx.best(d, ["r0", "r1"]))
        idx.drop("r0")
        idx.drop("r1")
        out += [len(idx), idx.best(d, ["r0", "r1"])]
        return out

    assert _both(run) == [("r1", 2), ("r0", 1), ("r1", 1), ("r0", 1), 0,
                          (None, 0)]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_migrated_prefix_exact(arch):
    """A batcher warmed only by page migration serves the tokens of a cold
    one, and hits the imported pages; the exported records match."""
    def run(side):
        def bat():
            kw = {"device": "cpu"} if side.port else {}
            return side.ContinuousBatcher(
                _model(side), side.params, batch_slots=2, max_len=MAX_LEN,
                prefill_chunk=CHUNK, page_size=PAGE, **kw)

        def serve(b, seed, rid0):
            for r in _requests(side, [4, 6], shared=17, seed=seed,
                               rid0=rid0):
                b.submit(r)
            return {r.rid: r.output for r in b.run_until_drained(2_000)}

        src = bat()
        first = serve(src, 0, 0)
        dst = bat()
        n, records = 0, []
        for ck in list(src.pool.tree._roots):
            recs, stacks = src.pool.export_subtree(ck)
            records.append([(tuple(r["key"]), r["owner"], r["parent"])
                            for r in recs])
            n += dst.pool.import_subtree(ck, recs, stacks)
        got = serve(dst, 5, 10)
        return {"first": first, "records": records, "imported": n,
                "interned": src.pool.tree.interned,
                "hits": dst.pool.stats()["prefix_hit_tokens"],
                "tokens": got, "ref": serve(bat(), 5, 10),
                "adverts": _adverts(side, dst.pool)}

    out = _both(run, arch)
    assert out["imported"] == out["interned"] > 0 and out["hits"] > 0
    assert out["tokens"] == out["ref"]


def test_migrate_prefixes_over_pages_channel():
    def run(side):
        model = _model(side)
        sup = side.supervisor(2)
        sup.create_cell("a", side.cfg, "serve", ncols=1)
        sup.create_cell("b", side.cfg, "serve", ncols=1)
        src = _pool(side, model, slots=2)
        dst = _pool(side, model, slots=2)
        rng = np.random.RandomState(3)
        prompt = rng.randint(1, side.cfg.vocab,
                             size=MAX_LEN - 1).astype(np.int32)
        src.intern_rows(prompt, None, _zero_cache(side, model), 0)
        ch = sup.open_channel("a", "b", kind="pages")
        cp = _cp(side)
        n = cp.migrate_prefixes(src, dst, ch)
        again = cp.migrate_prefixes(src, dst, ch)
        return {"n": n, "again": again, "interned": src.tree.interned,
                "transfers": ch.transfers,
                "adverts": (_adverts(side, src), _adverts(side, dst))}

    out = _both(run)
    assert out["n"] == out["interned"] > 0 and out["again"] == 0
    assert out["adverts"][0] == out["adverts"][1]


def _server(side, names=("dec0", "dec1"), **kw):
    sup = side.supervisor(3)
    sup.create_cell("prefill", side.cfg, "serve", ncols=1)
    side.init(sup.create_cell(names[0], side.cfg, "serve", ncols=1))
    for nm in names[1:]:
        sup.create_cell(nm, side.cfg, "serve", ncols=1)
    srv = side.disagg.DisaggServer(sup, "prefill", list(names),
                                   batch_slots=2, max_len=MAX_LEN,
                                   chunk=CHUNK, page_size=PAGE, **kw)
    return sup, srv


def _cache_stats(srv) -> dict:
    st = srv.stats()
    return {k: st[k] for k in ("routed_warm", "routed_cold",
                               "pages_migrated", "drain_handoffs",
                               "cache_index_entries", "prefix_hit_rate",
                               "per_replica_prefix_hit_rate")}


def test_warm_routing_concentrates_prefix():
    def run(side):
        sup, srv = _server(side)
        for r in _requests(side, [3, 4], shared=18):
            srv.submit(r)
        first = {r.rid: r.output for r in srv.run_until_drained(2_000)}
        for r in _requests(side, [5, 3, 4], shared=18, seed=7, rid0=10):
            srv.submit(r)
        got = {r.rid: r.output for r in srv.run_until_drained(2_000)}
        return {"tokens": got, "first": first, **_cache_stats(srv),
                **counters(side, sup, srv)}

    out = _both(run)
    assert out["routed_warm"] > 0 and out["cache_index_entries"] > 0
    assert max(out["per_replica_prefix_hit_rate"]) > 0


def test_route_deterministic_without_traffic_history():
    def run(side):
        _, srv = _server(side)
        cap = {0: 2, 1: 2}
        return ([srv._route(dict(cap)) for _ in range(3)],
                srv._route({0: 1, 1: 2}), srv._route({0: 0, 1: 0}))

    assert _both(run) == ([0, 0, 0], 1, None)


def _scaled_server(side, migrate):
    sup = side.supervisor(4)
    spec = side.spec(3, min_replicas=1, max_replicas=3)
    sup.apply(spec)
    side.init(sup.cells["decode/0"])
    srv = side.disagg.DisaggServer(sup, "prefill",
                                   spec.cell("decode").instances(),
                                   batch_slots=2, max_len=MAX_LEN,
                                   chunk=CHUNK, page_size=PAGE,
                                   migrate=migrate)
    return sup, srv


def _scale_to(sup, n):
    sup.apply(sup.desired.with_cell(
        dataclasses.replace(sup.desired.cell("decode"), replicas=n)))


def test_scale_down_drains_to_survivors():
    def run(side):
        sup, srv = _scaled_server(side, migrate=True)
        for r in _requests(side, [9, 10, 11, 12], shared=12, max_new=6):
            srv.submit(r)
        srv.step()
        held = sum(s is not None for s in srv.replicas[2].batcher.slot_req)
        _scale_to(sup, 2)
        out = srv.sync(sup.desired)
        mid = {**_cache_stats(srv), "index": sorted(
            srv.cacheplane.index.replicas())}
        done = {r.rid: r.output for r in srv.run_until_drained(2_000)}
        return {"held": held, "sync": out, "mid": mid, "tokens": done,
                **counters(side, sup, srv)}

    out = _both(run)
    assert out["sync"]["detached"] == ["decode/2"]
    assert out["sync"]["requeued"] == 0 and out["held"] >= 1
    assert out["mid"]["drain_handoffs"] == out["held"]
    assert out["mid"]["pages_migrated"] > 0
    assert set(out["mid"]["index"]) <= {"decode/0", "decode/1"}
    assert all(len(v) == 6 for v in out["tokens"].values())
    # and the tokens of a port server that never scaled
    side = Side(True, "qwen3-4b")
    _, ref = _scaled_server(side, migrate=False)
    for r in _requests(side, [9, 10, 11, 12], shared=12, max_new=6):
        ref.submit(r)
    assert {r.rid: r.output for r in ref.run_until_drained(2_000)} == \
        out["tokens"]


def test_drain_hook_fires_from_reconciler():
    def run(side):
        sup, srv = _scaled_server(side, migrate=True)
        hooked = srv._drain_hook in sup.drain_hooks
        for r in _requests(side, [3, 5, 2, 4], shared=12, max_new=6):
            srv.submit(r)
        srv.step()
        held = sum(s is not None for s in srv.replicas[2].batcher.slot_req)
        _scale_to(sup, 2)      # the reconciler's destroy runs the drain
        drained = (srv.drain_handoffs, srv.replicas[2].drained)
        out = srv.sync(sup.desired)
        done = {r.rid: r.output for r in srv.run_until_drained(2_000)}
        return {"hooked": hooked, "held": held, "drained": drained,
                "sync": out, "tokens": done, **_cache_stats(srv),
                **counters(side, sup, srv)}

    out = _both(run)
    assert out["hooked"] and out["drained"] == (out["held"], True)
    assert out["sync"]["requeued"] == 0 and sorted(out["tokens"]) == \
        [0, 1, 2, 3]
    # the port's close() unhooks the server, so dropping it frees it
    sup, srv = _scaled_server(Side(True, "qwen3-4b"), migrate=True)
    srv.close()
    assert srv._drain_hook not in sup.drain_hooks
