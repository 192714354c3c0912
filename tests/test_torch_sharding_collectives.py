"""The port's collectives, sharded tensors, and shard / gather of trees.

Each collective over a mesh of 8 ``cpu`` positions equals its plain
definition (the sum, max, mean or concatenation over the group, in rank
order), every position of a replicated result holds the same bits in a
tensor of its own, and the bytes each call records equal the bytes
reckoned from its shapes.  ``shard_tree`` followed by ``gather_tree`` is
the input bit for bit, and ``reshard_tree`` onto another mesh donates the
source shards.  Per-position dispatch of a Sharded: torch functions,
methods, indexing and in-place writes run per position.
"""
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.resharding import reshard_tree  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    gather_tree,
    shard_tree,
    tree_leaves,
)
from repro_torch.sharding import collectives as C  # noqa: E402
from repro_torch.sharding.rules import P, make_ctx  # noqa: E402
from repro_torch.sharding.sharded import (  # noqa: E402
    Sharded,
    first,
    gather_leaf,
    per_position,
    shard_leaf,
)

MESH = make_mesh_for_devices(2, 4, devices=["cpu"])


def _values(dtype=torch.float32, shape=(3, 8), seed=0):
    rng = np.random.default_rng(seed)
    return Sharded([torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for _ in range(MESH.size)], MESH)


def _groups(axes):
    return MESH.groups(axes)


def _nbytes(t):
    return t.numel() * t.element_size()


AXES = [("model",), ("data",), ("data", "model")]


@pytest.mark.parametrize("axes", AXES, ids="+".join)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_psum_pmax_pmean_match_their_definitions(axes, dtype):
    x = _values(dtype)
    for fn, op in ((C.psum, "sum"), (C.pmax, "max"), (C.pmean, "mean")):
        with C.recording() as log:
            y = fn(x, axes)
        for g in _groups(axes):
            stack = torch.stack([x.shards[r].float() for r in g])
            acc = stack[0]
            for t in stack[1:]:
                acc = torch.maximum(acc, t) if op == "max" else acc + t
            if op == "mean":
                acc = acc / len(g)
            want = acc.to(dtype)
            for r in g:
                assert torch.equal(y.shards[r], want), (op, r)
            assert len({y.shards[r].data_ptr() for r in g}) == len(g)
        assert dict(log) == {"all-reduce": _nbytes(x.shards[0])}


@pytest.mark.parametrize("axes", AXES, ids="+".join)
@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_and_psum_scatter_match_their_definitions(axes, dim):
    x = _values(shape=(8, 16))
    with C.recording() as log:
        y = C.all_gather(x, axes, dim=dim)
        z = C.psum_scatter(x, axes, dim=dim)
        s = C.all_gather(x, axes, dim=0, tiled=False)
    n = len(_groups(axes)[0])
    for g in _groups(axes):
        cat = torch.cat([x.shards[r] for r in g], dim)
        total = sum(x.shards[r] for r in g)
        for i, r in enumerate(g):
            assert torch.equal(y.shards[r], cat)
            assert torch.equal(s.shards[r],
                               torch.stack([x.shards[q] for q in g]))
            assert torch.equal(z.shards[r], total.chunk(n, dim)[i])
    full = _nbytes(x.shards[0])
    assert dict(log) == {"all-gather": 2 * full * n,
                         "reduce-scatter": full // n}


def test_axis_index_and_size_one_axes():
    assert C.axis_index(MESH, "model").shards == [0, 1, 2, 3] * 2
    assert C.axis_index(MESH, ("data", "model")).shards == list(range(8))
    one = make_mesh_for_devices(1, 8, devices=["cpu"])
    x = Sharded([torch.ones(2)] * 8, one)
    with C.recording() as log:
        assert C.psum(x, "data") is x       # no collective over size 1
    assert not log


def test_relayout_gathers_and_slices():
    t = torch.arange(8 * 16 * 2, dtype=torch.float32).reshape(8, 16, 2)
    s = shard_leaf(t, P("data", "model"), MESH)
    assert s.shape == (4, 4, 2) and s.global_shape == (8, 16, 2)
    with C.recording() as log:
        r = C.relayout(s, P(None, None))
    assert all(torch.equal(x, t) for x in r.shards)
    # dim 0 over data: (8, 4, 2) out; then dim 1 over model: (8, 16, 2)
    assert dict(log) == {"all-gather": (8 * 4 * 2 + 8 * 16 * 2) * 4}
    with C.recording() as log:
        back = C.relayout(r, P("data", "model"))
    assert torch.equal(gather_leaf(back), t) and not log
    with C.recording() as log:
        same = C.relayout(s, P("data", "model"))
    assert same is s and not log
    moved = C.relayout(s, P(None, ("data", "model")))
    assert moved.shape == (8, 2, 2)
    assert torch.equal(gather_leaf(moved), t)


def test_shard_then_gather_is_bitwise_the_input():
    ctx = make_ctx(MESH)
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 6, generator=g).to(torch.bfloat16),
            "b": [torch.randn(4, 16, generator=g),
                  torch.arange(24, dtype=torch.int32).reshape(2, 12)],
            "c": torch.randn(5, generator=g)}
    specs = {"a": P("data", None), "b": [P(None, ("data", "model")),
                                         P(None, "model")], "c": P(None)}
    sharded = shard_tree(tree, specs, ctx)
    assert sharded["b"][0].shards[3].shape == (4, 2)
    back = gather_tree(sharded)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # every shard is a tensor of its own (no view of the input)
    ptrs = {t.data_ptr() for t in tree_leaves(sharded)}
    assert len(ptrs) == len(tree_leaves(sharded))
    assert not ptrs & {t.data_ptr() for t in tree_leaves(tree)}


def test_reshard_across_meshes_donates_the_source():
    t = torch.randn(8, 8)
    a = make_ctx(MESH)
    b = make_ctx(make_mesh_for_devices(1, 2, devices=["cpu"]))
    src = {"w": shard_leaf(t, P("data", "model"), MESH)}
    refs = [weakref.ref(x) for x in src["w"].shards]
    out, stats = reshard_tree(src, b, {"w": P(None, "model")})
    assert stats["bytes"] == t.numel() * 4
    assert src["w"].shards == []
    gc.collect()
    assert all(r() is None for r in refs)
    assert torch.equal(gather_leaf(out["w"]), t)
    one, _ = reshard_tree(out, "cpu")
    assert torch.equal(one["w"], t) and out["w"].shards == []
    del a


def test_per_position_dispatch():
    x = _values(shape=(2, 3))
    w = torch.randn(3, 4)
    y = torch.einsum("bd,df->bf", x, w)
    assert all(torch.equal(y.shards[r], torch.einsum("bd,df->bf",
                                                     x.shards[r], w))
               for r in range(8))
    z = (x + 1).float().T
    assert z.shape == (3, 2)
    x[0] = torch.zeros(3)
    assert all(torch.equal(s[0], torch.zeros(3)) for s in x.shards)
    assert x.index_fill_(1, torch.tensor([2]), 5.0) is x
    assert all(bool((s[:, 2] == 5).all()) for s in x.shards)
    f = per_position(lambda a, b: (a.sum(), b))
    s, b = f(x, 3)
    assert b == 3 and isinstance(s, Sharded)
    assert first(s) is s.shards[0] and first(w) is w
    with pytest.raises(TypeError):
        bool(x)
