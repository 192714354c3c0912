"""Serve cells over zones of several rows and pods: the batch split over
the data axes, one host schedule, the page arena whole on every data row
(float32, ``cpu`` positions).

* The row helpers (``sharded.move_rows``, ``take_rows``,
  ``row_owners``) against plain indexing of the gathered tensor, over
  (data 2, model 2) and (pod 2, data 2, model 1), split and whole.
* All five families at smoke size, weights from JAX's ``Model.init``
  through ``params_from_numpy``: a serve cell over (data 2, model 2)
  gives the greedy tokens of JAX's one-device ``ContinuousBatcher`` and
  of the port's one-position cell, with JAX's pool counters (prefix-hit
  tokens, pages or payloads interned, pages held after the drain) and
  invocation counts.  The traffic crosses data rows: a two-prompt cold
  group's second row (data row 1) lands in slot 1 (data row 0); a
  two-prompt warm extend computes a suffix on data row 1 for a slot on
  data row 0; a later prompt hits that suffix's interned page alone, a
  one-prompt group the rules run whole on every data row.  After the
  drain every data row's copy of the arena is bitwise the same.
* The other layouts against JAX: the dense per-slot cache, prompts fed
  token at a time, and three slots (a decode batch the data axis does
  not divide, run whole on every data row).
* Cell verbs: a (pod 2, data 1, model 2) cell, a resize (data 2, model
  1) -> (2, 2) -> (2, 1) with requests in flight, and ``transfer_columns``
  between two serve cells on a two-row grid, each keeping the
  one-position cell's tokens.
* Disaggregated serving from a prefill cell over (rows, 2) to a decode
  cell over (rows, 1), one and two rows: the tokens and the KV channel's
  logical bytes of one-position cells.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from repro.configs.base import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.serve.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve.batcher import Request as JRequest  # noqa: E402
from repro.sharding.rules import single_device_ctx as j_ctx1  # noqa: E402
from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import DeviceGrid, Supervisor  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    gather_tree,
    params_from_numpy,
    tree_leaves,
)
from repro_torch.serve.batcher import Request  # noqa: E402
from repro_torch.sharding.rules import P, Mesh  # noqa: E402
from repro_torch.sharding.sharded import (  # noqa: E402
    Sharded,
    gather_leaf,
    move_rows,
    row_owners,
    shard_leaf,
    take_rows,
)

ARCHS = ["qwen3-4b", "deepseek-moe-16b", "mamba2-2.7b", "zamba2-2.7b",
         "seamless-m4t-large-v2"]
PAGED = ["qwen3-4b", "deepseek-moe-16b", "seamless-m4t-large-v2"]
# keys under which the greedy tokens vary (a constant stream would hide a
# mismatch)
WEIGHT_KEY = {"qwen3-4b": 6, "deepseek-moe-16b": 5, "mamba2-2.7b": 3,
              "zamba2-2.7b": 0, "seamless-m4t-large-v2": 6}
KW = dict(max_len=64, prefill_chunk=8, page_size=8)
SLOTS = 4
_MODELS, _RUNS = {}, {}


# --------------------------------------------------------------------------
# the row helpers
# --------------------------------------------------------------------------
def _mesh(shape, names):
    return Mesh(np.array(["cpu"] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


MESHES = {"data2-model2": ((2, 2), ("data", "model"), ("data",)),
          "pod2-data2-model1": ((2, 2, 1), ("pod", "data", "model"),
                                ("pod", "data"))}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_row_helpers_match_plain_indexing(name):
    shape, names, b_ax = MESHES[name]
    mesh = _mesh(shape, names)
    b = b_ax[0] if len(b_ax) == 1 else b_ax
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.standard_normal((3, 8, 4, 6)).astype(
        np.float32))
    split = shard_leaf(full, P(None, b, "model" if "model" in names and
                               mesh.shape["model"] > 1 else None), mesh)
    # one row, whole on every data row, laid out as ``split`` otherwise
    whole = shard_leaf(full[:, :1].clone(), P(None, None, split.spec[2]),
                       mesh)
    # take_rows: rows on any data row, gathered whole on every position
    rows = [7, 0, 5]
    got = take_rows(split, 1, rows)
    assert got.spec[1] is None and got.shape[1] == 3
    assert torch.equal(gather_leaf(got), full[:, rows])
    for s in got.shards[1:]:
        assert torch.equal(s, got.shards[0]) or mesh.shape["model"] > 1
    # move_rows: split -> split across data rows, whole -> split
    dst = shard_leaf(torch.zeros_like(full), split.spec, mesh)
    move_rows(dst, 1, [1, 6, 3], split, [6, 1, 2])
    want = torch.zeros_like(full)
    want[:, [1, 6, 3]] = full[:, [6, 1, 2]]
    assert torch.equal(gather_leaf(dst), want)
    move_rows(dst, 1, [4], whole, [0])
    want[:, 4] = full[:, 0]
    assert torch.equal(gather_leaf(dst), want)
    # row_owners: the positions of one data rank hold row 6
    k = 6 // (8 // int(np.prod([mesh.shape[a] for a in b_ax])))
    owners = row_owners(split, 1, 6)
    assert [r for r, _, _ in owners] == [
        r for r in range(mesh.size) if mesh.rank(r, b_ax) == k]
    assert all(lo == 6 % (8 // int(np.prod([mesh.shape[a] for a in b_ax])))
               for _, _, lo in owners)
    assert len(row_owners(whole, 1, 0)) == mesh.size


# --------------------------------------------------------------------------
# serving: the traffic, the three references
# --------------------------------------------------------------------------
def _models(arch):
    if arch not in _MODELS:
        jcfg = j_smoke_config(j_get_arch(arch)).replace(dtype="float32")
        jm = j_build_model(jcfg, j_ctx1())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(WEIGHT_KEY[arch]))
        host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        _MODELS[arch] = (jm, jp, host)
    return _MODELS[arch]


def _ticks(vocab, family):
    """Three ticks of (prompt, source) pairs behind a shared 16-token
    prefix S: two cold prompts of one bucket; two warm ones, each adding
    its own full page T1 / T2 (one extend group); one prompt alone that
    hits S + T2.  encdec: the first prompt carries a source."""
    rng = np.random.default_rng(11)

    def toks(n):
        return rng.integers(1, vocab, size=n).astype(np.int32)
    s, t1, t2 = toks(16), toks(8), toks(8)
    src = (rng.standard_normal((20, 128)).astype(np.float32)
           if family == "encdec" else None)
    return [[(np.concatenate([s, toks(5)]), src),
             (np.concatenate([s, toks(3)]), None)],
            [(np.concatenate([s, t1, toks(3)]), None),
             (np.concatenate([s, t2, toks(3)]), None)],
            [(np.concatenate([s, t2, toks(5)]), None)]]


def _drive(bat, cls, ticks, *, rid0=0, between=None):
    """Submit each tick's requests together and drain (``between(bat)``
    after each tick's first step).  Returns {rid: tokens}."""
    rid = rid0
    for tick in ticks:
        for prompt, src in tick:
            bat.submit(cls(rid=rid, prompt=prompt, max_new_tokens=5,
                           src=src))
            rid += 1
        if between is not None:
            bat.step()
            between(bat)
        bat.run_until_drained()
    return {r.rid: list(r.output) for r in bat.done if r.rid >= rid0}


def _jax(arch, **kw):
    jm, jp, _ = _models(arch)
    bat = JBatcher(jm, jp, **{"batch_slots": SLOTS, **KW, **kw})
    return _drive(bat, JRequest, _ticks(jm.cfg.vocab, jm.cfg.family)), bat


def _cell(arch, grid, ncols=2, pods=(0,), name="c", sup=None):
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    sup = sup or Supervisor(grid)
    cell = sup.create_cell(name, cfg, "serve", ncols=ncols, pods=pods)
    cell.init_serve(params=params_from_numpy(
        _models(arch)[2], dtype=torch.float32, device="cpu",
        specs=Model(cfg).param_specs()))
    return sup, cell


def _rows_grid():
    return DeviceGrid.from_flat(["cpu"] * 8, 1, 2, 4)


def _port(arch, grid, ncols=2, pods=(0,), **kw):
    sup, cell = _cell(arch, grid, ncols, pods)
    bat = cell.make_batcher(**{"batch_slots": SLOTS, **KW, **kw},
                            device="cpu")
    cfg = cell.arch
    return _drive(bat, Request, _ticks(cfg.vocab, cfg.family)), bat, cell, sup


def _runs(arch):
    """(JAX's, the one-position cell's, the (2, 2) cell's) runs."""
    if arch not in _RUNS:
        one = DeviceGrid.from_flat(["cpu"], 1, 1, 8, allow_reuse=True)
        _RUNS[arch] = (_jax(arch), _port(arch, one), _port(arch, _rows_grid()))
    return _RUNS[arch]


def _counters(pool):
    st = pool.stats()
    return {"prefix_hit_tokens": st["prefix_hit_tokens"],
            "prefix_miss_tokens": st["prefix_miss_tokens"],
            "interned": pool.tree.interned,
            "pages_in_use": pool.pages_in_use,
            "snapshots_interned": st["snapshots_interned"],
            "snapshot_hit_tokens": st["snapshot_hit_tokens"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_over_two_rows_matches_jax(arch):
    (jtok, jbat), (otok, obat, _, _), (tok, bat, cell, sup) = _runs(arch)
    assert cell.mesh.shape == {"data": 2, "model": 2}
    assert cell.model.ctx.batch_axes == ("data",)
    assert len({t for out in jtok.values() for t in out}) >= 5
    assert tok == jtok == otok
    assert (bat.prefill_invocations, bat.decode_invocations) == (
        jbat.prefill_invocations, jbat.decode_invocations)
    assert bat.prefill_batch_sizes == obat.prefill_batch_sizes
    assert 2 in bat.prefill_batch_sizes and 1 in bat.prefill_batch_sizes
    assert _counters(bat.pool) == _counters(jbat.pool) == _counters(
        obat.pool)
    assert bat.pool.stats()["prefix_hit_tokens"] >= 3 * 16
    assert sup.validate_cell_programs("c") == 2       # weights, batcher


@pytest.mark.parametrize("arch", ARCHS)
def test_the_batch_splits_and_the_weights_keep_fsdp(arch):
    """The decode cache or resident rows split over ``data``, the pool's
    arena and a snapshot pool's payloads whole on every data row, the
    weights' ``embed`` dim over ``data`` (FSDP), gathered to the
    one-position weights."""
    _, (_, obat, one, _), (_, bat, cell, _) = _runs(arch)
    split = [x for x in _sharded([bat.cache, bat.resident,
                                  bat._scratch_caches])
             if "data" in tuple(a for d in range(x.dim())
                                for a in x.spec.axes_of(d))]
    assert split and all(x.shape[x.spec.index("data")] * 2 ==
                         x.global_shape[x.spec.index("data")]
                         for x in split)
    embed = cell.serve_params["embed"]
    assert embed.spec == P("model", "data")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(gather_tree(cell.serve_params)),
        tree_leaves(one.serve_params)))
    if bat._paged:
        assert all(s is None or "data" not in (s if isinstance(s, tuple)
                                               else (s,))
                   for s in bat.pool.arena[0].k.spec)
    elif bat._snapshot:
        # the checkpoint workspace holds a position's rows: tick 1's cold
        # pair (3 checkpoints a row) is one row a data row
        assert obat._ckpts.capacity == 2 * 3
        assert bat._ckpts.capacity == 1 * 3
        payload = next(iter(bat.pool._snaps.values()))
        ax = bat.model._state_batch_axis
        assert payload["state"].conv.spec[ax] is None
        assert payload["state"].conv.shape[ax] == 1
    costs = {k: dict(p.collective_per_device)
             for k, p in cell.accounting.programs.items()}
    assert all(c.get("all-gather", 0) > 0 for c in costs.values()), costs


def _sharded(tree):
    out = []
    from repro_torch.models.param import tree_map
    tree_map(lambda x: out.append(x) if isinstance(x, Sharded) else None,
             tree)
    return out


@pytest.mark.parametrize("arch", PAGED)
def test_every_data_row_holds_the_same_arena(arch):
    """After the drain each data row's copy of the arena (and every
    position's block-table walk) is bitwise the same: the paged writes
    were mirrored, the page-stack installs written on every data row."""
    _, _, (_, bat, cell, _) = _runs(arch)
    mesh = cell.mesh
    for node in bat.pool.arena:
        for leaf in node:
            for g in mesh.groups(("data",)):
                assert all(torch.equal(leaf.shards[g[0]], leaf.shards[r])
                           for r in g[1:])
    assert (bat.pool.block_table == bat.pool.sentinel).all()


def test_a_warm_page_computed_on_one_data_row_serves_the_other():
    """qwen3-4b: tick 2's extend computes T2 on data row 1 for slot 1 (on
    data row 0 with four slots); tick 3's prompt, alone in slot 0, maps
    T2's interned page: both read a page their own data row did not
    compute, and match JAX."""
    (jtok, _), _, (tok, bat, cell, _) = _runs("qwen3-4b")
    assert bat.model.local_batch(SLOTS) == 2      # slots 0, 1 on data row 0
    assert bat.model.local_batch(2) == 1          # a pair: one a data row
    assert tok[3] == jtok[3] and tok[4] == jtok[4]
    assert bat.pool.stats()["prefix_hit_tokens"] >= 16 + 16 + 24


LAYOUTS = {"dense": ("qwen3-4b", dict(kv_pool=None)),
           "dense-mamba2": ("mamba2-2.7b", dict(kv_pool=None)),
           "token-at-a-time": ("qwen3-4b", dict(prefill_chunk=None)),
           "token-at-a-time-seamless": ("seamless-m4t-large-v2",
                                        dict(prefill_chunk=None)),
           "three-slots": ("deepseek-moe-16b", dict(batch_slots=3)),
           "three-slots-zamba2": ("zamba2-2.7b", dict(batch_slots=3))}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layouts_match_jax(case):
    arch, kw = LAYOUTS[case]
    jtok, jbat = _jax(arch, **kw)
    tok, bat, cell, _ = _port(arch, _rows_grid(), **kw)
    assert cell.mesh.shape == {"data": 2, "model": 2}
    assert tok == jtok
    assert bat.decode_invocations == jbat.decode_invocations
    if jbat.pool is not None:
        assert _counters(bat.pool) == _counters(jbat.pool)


# --------------------------------------------------------------------------
# cell verbs over rows and pods
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_a_cell_over_two_pods(arch):
    _, (otok, obat, _, _), _ = _runs(arch)
    grid = DeviceGrid.from_flat(["cpu"] * 8, 2, 1, 4)
    tok, bat, cell, _ = _port(arch, grid, pods=(0, 1))
    assert cell.mesh.shape == {"pod": 2, "data": 1, "model": 2}
    assert cell.model.ctx.batch_axes == ("pod", "data")
    assert tok == otok
    assert _counters(bat.pool) == _counters(obat.pool)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_resize_over_two_rows_with_requests_in_flight(arch):
    """(data 2, model 1) -> (2, 2) -> (2, 1): the live batcher is rebound
    after a tick's first step, the requests in flight keep their tokens,
    the weights come back bit for bit."""
    _, (otok, obat, one, _), _ = _runs(arch)
    sup, cell = _cell(arch, _rows_grid(), ncols=1)
    assert cell.mesh.shape == {"data": 2, "model": 1}
    bat = cell.make_batcher(batch_slots=SLOTS, **KW, device="cpu")
    shapes = []

    def resize(b):
        n = 2 if cell.mesh.shape["model"] == 1 else 1
        sup.resize_cell("c", n)
        shapes.append(dict(cell.mesh.shape))
        assert b.model is cell.model
    tok = _drive(bat, Request, _ticks(cell.arch.vocab, cell.arch.family),
                 between=resize)
    assert shapes == [{"data": 2, "model": 2}, {"data": 2, "model": 1},
                      {"data": 2, "model": 2}]
    assert tok == otok
    assert _counters(bat.pool) == _counters(obat.pool)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(gather_tree(cell.serve_params)),
        tree_leaves(one.serve_params)))
    assert sup.validate_cell_programs("c") == 2


def test_transfer_columns_between_two_cells_on_two_rows():
    """Cells a (2 columns) and b (1) on a two-row grid serve together; a
    column moves from a to b between ticks; both keep their tokens."""
    arch = "qwen3-4b"
    _, (otok, _, _, _), _ = _runs(arch)
    sup, a = _cell(arch, _rows_grid(), ncols=2, name="a")
    _, b = _cell(arch, None, ncols=1, name="b", sup=sup)
    assert (a.mesh.shape, b.mesh.shape) == (
        {"data": 2, "model": 2}, {"data": 2, "model": 1})
    bats = {n: c.make_batcher(batch_slots=SLOTS, **KW, device="cpu")
            for n, c in (("a", a), ("b", b))}
    ticks = _ticks(a.arch.vocab, a.arch.family)
    out = {"a": {}, "b": {}}
    rid = 0
    for t, tick in enumerate(ticks):
        if t == 1:
            sup.transfer_columns("a", "b", 1)
            assert (a.mesh.shape, b.mesh.shape) == (
                {"data": 2, "model": 1}, {"data": 2, "model": 2})
        for name in ("a", "b"):
            for i, (prompt, src) in enumerate(tick):
                bats[name].submit(Request(rid=rid + i, prompt=prompt,
                                          max_new_tokens=5, src=src))
        while any(bt.queue or any(r is not None for r in bt.slot_req)
                  for bt in bats.values()):
            for bt in bats.values():
                bt.step()
        rid += len(tick)
    for name, bt in bats.items():
        out[name] = {r.rid: list(r.output) for r in bt.done}
    assert out["a"] == out["b"] == otok
    assert sup.validate_cell_programs("a") == 2
    assert sup.validate_cell_programs("b") == 2


def test_one_position_mesh_helpers_are_plain_indexing():
    """On a one-position cell the helpers are ``index_select`` and
    ``index_copy_`` of the plain tensor, so the one-device path is
    unchanged."""
    t = torch.arange(24.0).reshape(2, 4, 3)
    assert torch.equal(take_rows(t, 1, [3, 1]), t[:, [3, 1]])
    d = torch.zeros_like(t)
    move_rows(d, 1, [0, 2], t, [1, 3])
    assert torch.equal(d[:, [0, 2]], t[:, [1, 3]])
    assert row_owners(t, 1, 2) == [(0, t, 2)]


def test_a_mesh_of_two_data_rows_splits_the_prefill_pair():
    mesh = make_mesh_for_devices(2, 2, devices=["cpu"])
    assert mesh.shape == {"data": 2, "model": 2}
    cfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import make_ctx
    model = build_model(cfg, make_ctx(mesh))
    scratch = model.init_cache(2, 64)
    assert scratch["layers"].k.spec[1] == "data"
    one = model.init_cache(1, 64)
    assert one["layers"].k.spec[1] is None


@pytest.mark.parametrize("rows", [1, 2])
def test_disaggregated_serving_over_a_mesh(rows):
    """A prefill cell over (rows, 2) feeding a decode cell over (rows, 1)
    serves the tokens of one-position cells on the same weights, its
    KV channel counting the same logical bytes."""
    from repro_torch.serve.disagg import DisaggServer

    def serve(grid, prefill_cols):
        sup, _ = _cell("qwen3-4b", grid, ncols=1, name="decode")
        sup.create_cell("prefill", sup.cells["decode"].arch, "serve",
                        ncols=prefill_cols)
        srv = DisaggServer(sup, "prefill", "decode", batch_slots=2,
                           max_len=64, chunk=8, page_size=8)
        for i, tick in enumerate(_ticks(512, "dense")):
            for j, (prompt, _) in enumerate(tick):
                srv.submit(Request(rid=10 * i + j, prompt=prompt,
                                   max_new_tokens=5))
        done = {r.rid: list(r.output) for r in srv.run_until_drained()}
        st = srv.stats()
        return done, (st["kv_bytes"], st["kv_transfers"],
                      st["prefix_hit_tokens"]), sup

    tok, counts, sup = serve(DeviceGrid.from_flat(["cpu"] * 8, 1, rows,
                                                  8 // rows), 2)
    assert sup.cells["prefill"].mesh.shape == {"data": rows, "model": 2}
    assert sup.cells["decode"].mesh.shape == {"data": rows, "model": 1}
    one_tok, one_counts, _ = serve(DeviceGrid.from_flat(
        ["cpu"], 1, 1, 8, allow_reuse=True), 1)
    assert len(tok) == 5 and tok == one_tok and counts == one_counts
