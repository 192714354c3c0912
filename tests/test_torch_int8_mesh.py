"""int8 KV pages over a mesh (CPU, float32 model, int8 arena).

A page's scale is one float32 per (page, layer) over every kv head (JAX's
``kv_dtype="int8"`` pool).  Over a mesh each position holds its part of
the kv heads, so the paged writes take the max of every position's
maxima (``collectives.pmax`` over ``model``) and every position keeps
its own copy of the scale tables, written with the same values.

* qwen3-4b's smoke config (one kv head: attention replicated over
  ``model``) and the same config with four kv heads (split over
  ``model``), over (1, 2), (2, 2) and (pod 2, data 1, model 2), against
  JAX's one-device int8 batcher on the same weights and traffic
  (``tests/test_torch_sharding_rows.py``'s three ticks: cold, warm
  extend, a page interned on another data row): tokens identical, JAX's
  pool counters, every data row's int8 arena bitwise equal, the int8
  codes within one of JAX's (a value at a rounding's .5 edge may round
  either way).  The scale tables are bitwise equal across positions;
  layer 0's equal the one-position cell's bitwise (its K/V are bitwise
  the same, and a max is exact); every layer's are within 1e-6 relative
  of the one-position cell's (a later layer's K/V differ by the float32
  rounding of the ``psum`` over ``model``) and within 2e-6 of JAX's (that
  rounding and the one-position port's own, each under 1e-6).
* A resize of an int8 cell, (data 2, model 1) -> (2, 2) -> (2, 1) with
  requests in flight, keeps its pages: the tokens and prefix hits of a
  cell that never resized.
* ``export_subtree`` / ``import_subtree`` round-trip an interned tree
  between an int8 pool over (2, 2) and a one-position int8 pool: the
  records identical, the dequantised pages within one code step, and
  the one-position pool serves the prefix warm.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import DeviceGrid, Supervisor  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402
from repro_torch.serve.batcher import Request  # noqa: E402
from repro_torch.serve.kvpool import KVPool  # noqa: E402
from repro_torch.sharding.sharded import Sharded, gather_leaf  # noqa: E402
from test_torch_sharding_rows import (  # noqa: E402
    KW,
    SLOTS,
    JBatcher,
    JRequest,
    _counters,
    _drive,
    _ticks,
    j_build_model,
    j_ctx1,
    j_get_arch,
    j_smoke_config,
)

#: config name -> kv heads of the smoke qwen3-4b
CONFIGS = {"qwen3-4b": 1, "qwen3-4b-kv4": 4}
#: layout name -> (pods, rows, cols of the grid, the cell's ncols)
MESHES = {"1x2": (1, 1, 8, 2), "2x2": (1, 2, 4, 2), "pod2-1x2": (2, 1, 4, 2)}
_JAX, _HOST = {}, {}


def _cfgs(name):
    kv = CONFIGS[name]
    j = j_smoke_config(j_get_arch("qwen3-4b")).replace(dtype="float32",
                                                       num_kv_heads=kv)
    t = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32",
                                                   num_kv_heads=kv)
    return j, t


def _jax(name):
    if name not in _JAX:
        jcfg, _ = _cfgs(name)
        jm = j_build_model(jcfg, j_ctx1())
        jp = jax.jit(jm.init)(jax.random.PRNGKey(6))
        _HOST[name] = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        bat = JBatcher(jm, jp, batch_slots=SLOTS, kv_dtype="int8", **KW)
        _JAX[name] = (_drive(bat, JRequest, _ticks(jcfg.vocab, "dense")),
                      bat)
    return _JAX[name]


def _cell(name, grid, ncols, pods=(0,)):
    _jax(name)
    _, cfg = _cfgs(name)
    sup = Supervisor(grid)
    cell = sup.create_cell("c", cfg, "serve", ncols=ncols, pods=pods)
    cell.init_serve(params=params_from_numpy(
        _HOST[name], dtype=torch.float32, device="cpu",
        specs=Model(cfg).param_specs()))
    return sup, cell


def _grid(layout):
    pods, rows, cols, _ = MESHES[layout]
    return DeviceGrid.from_flat(["cpu"] * 8, pods, rows, cols)


def _one_position_pool(name):
    if ("one", name) not in _JAX:
        _, cell = _cell(name, DeviceGrid.from_flat(["cpu"], 1, 1, 8,
                                                   allow_reuse=True), 1)
        bat = cell.make_batcher(batch_slots=SLOTS, kv_dtype="int8",
                                device="cpu", **KW)
        _drive(bat, Request, _ticks(cell.arch.vocab, "dense"))
        _JAX["one", name] = bat.pool
    return _JAX["one", name]


def _by_path(records) -> dict:
    """The chunk-key path from the root of each exported record -> its
    index."""
    out, paths = {}, []
    for i, rec in enumerate(records):
        path = (paths[rec["parent"]] if rec["parent"] >= 0 else ()) + (
            tuple(rec["key"]),)
        paths.append(path)
        out[path] = i
    return out


def _whole(x):
    return gather_leaf(x) if isinstance(x, Sharded) else x


@pytest.mark.parametrize("layout", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_pool_over_a_mesh_matches_jax(name, layout):
    jtok, jbat = _jax(name)
    pods, _, _, ncols = MESHES[layout]
    _, cell = _cell(name, _grid(layout), ncols, tuple(range(pods)))
    bat = cell.make_batcher(batch_slots=SLOTS, kv_dtype="int8",
                            device="cpu", **KW)
    tok = _drive(bat, Request, _ticks(cell.arch.vocab, "dense"))
    assert tok == jtok and len({t for o in tok.values() for t in o}) >= 5
    assert _counters(bat.pool) == _counters(jbat.pool)
    heads = bat.pool.arena[0].k.spec[3]
    assert (heads == "model") == (CONFIGS[name] == 4)
    mesh = cell.mesh
    one = _one_position_pool(name)
    for node, jnode, scales, jscales, oscales in zip(
            bat.pool.arena, jbat.pool.arena, bat.pool.kv_scales,
            jbat.pool.kv_scales, one.kv_scales):
        for table, jtable, otable in zip(scales, jscales, oscales):
            assert all(torch.equal(table.shards[0], s) for s in table.shards)
            got = table.shards[0]
            assert torch.equal(got[:, 0], otable[:, 0])
            torch.testing.assert_close(got, otable, rtol=1e-6, atol=0)
            js = np.asarray(jtable)
            assert np.all(np.abs(got.numpy() - js) <= 2e-6 * np.abs(js))
            assert ((got.numpy() > 0) == (js > 0)).all() and (js > 0).any()
        for leaf, jleaf in zip(node[:2], jnode[:2]):
            for g in mesh.groups(tuple(a for a in mesh.axis_names
                                       if a != "model")):
                assert all(torch.equal(leaf.shards[g[0]], leaf.shards[r])
                           for r in g[1:])
            codes = gather_leaf(leaf).numpy().astype(np.int32)
            assert np.abs(codes - np.asarray(jleaf).astype(np.int32)).max() \
                <= 1
        assert np.array_equal(gather_leaf(node.slot_pos).numpy(),
                              np.asarray(jnode.slot_pos))


def test_resize_keeps_an_int8_cells_pages():
    """(data 2, model 1) -> (2, 2) -> (2, 1) after each tick's first step,
    four kv heads: the int8 arena and its scale tables are re-laid with
    the requests in flight, and the tokens and prefix hits are those of
    a cell that never resized (and JAX's)."""
    name = "qwen3-4b-kv4"
    jtok, jbat = _jax(name)
    sup, cell = _cell(name, _grid("2x2"), 1)
    bat = cell.make_batcher(batch_slots=SLOTS, kv_dtype="int8",
                            device="cpu", **KW)
    shapes = []

    def resize(b):
        sup.resize_cell("c", 2 if cell.mesh.shape["model"] == 1 else 1)
        shapes.append(cell.mesh.shape["model"])
        assert b.pool.kv_scales[0][0].mesh is cell.mesh
    tok = _drive(bat, Request, _ticks(cell.arch.vocab, "dense"),
                 between=resize)
    assert shapes == [2, 1, 2] and tok == jtok
    assert _counters(bat.pool) == _counters(jbat.pool)
    assert bat.pool.arena[0].k.dtype == torch.int8
    assert sup.validate_cell_programs("c") == 2


def test_export_import_round_trips_int8_pages_between_layouts():
    name = "qwen3-4b-kv4"
    _jax(name)
    _, cell = _cell(name, _grid("2x2"), 2)
    bat = cell.make_batcher(batch_slots=SLOTS, kv_dtype="int8",
                            device="cpu", **KW)
    ticks = _ticks(cell.arch.vocab, "dense")
    _drive(bat, Request, ticks[:2])
    records, stacks = bat.pool.export_subtree(None)
    assert records and stacks[0].k.spec[3] == "model"

    def pool(model):
        return KVPool(model, max_len=KW["max_len"], page_size=KW["page_size"],
                      slots=SLOTS, kv_dtype="int8", device="cpu")
    one = pool(Model(cell.arch))
    assert one.import_subtree(None, records, stacks) == len(records)
    back_records, back_stacks = one.export_subtree(None)
    again = pool(cell.model)
    assert again.import_subtree(None, back_records, back_stacks) == \
        len(records)
    rounds = [(records, stacks), (back_records, back_stacks),
              again.export_subtree(None)]
    # a subtree's siblings come back in another order: align by path
    paths = [_by_path(r) for r, _ in rounds]
    assert paths[0].keys() == paths[1].keys() == paths[2].keys()
    for path, i in paths[0].items():
        j, k = paths[1][path], paths[2][path]
        assert rounds[0][0][i]["owner"] == rounds[1][0][j]["owner"]
        for a, b, c in zip(*(r[1] for r in rounds)):
            for x, y, z in zip(a, b, c):
                x, y, z = _whole(x)[i], y[j], _whole(z)[k]
                if x.dtype == torch.int32:          # slot_pos
                    assert torch.equal(x, y) and torch.equal(x, z)
                    continue
                # one code step of the page's scale a layer: requantising
                # a dequantised page keeps each code within one
                step = x.abs().amax(dim=(0, 2, 3), keepdim=True) / 127.0
                assert ((x - y).abs() <= step * 1.0001).all()
                assert ((x - z).abs() <= 2 * step * 1.0001).all()
    # the one-position pool serves the interned prefix warm
    lease = one.lease(ticks[2][0][0])
    assert lease.tokens >= 16
    one.release_lease(lease)
