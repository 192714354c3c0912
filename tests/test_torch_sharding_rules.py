"""The port's sharding rules against JAX's, and the port's meshes.

For every architecture of the port's registry and the meshes (1, 1),
(2, 4), (16, 16) and (2, 16, 16), under the serve (FSDP off), FSDP and
ZeRO-3 (``dp_over_model``) rule sets, ``Model.params_pspecs`` and
``Model.cache_pspecs`` of the port equal JAX's, whose ``ShardCtx`` is built
on a stand-in mesh object exposing only ``axis_names`` and
``devices.shape`` (no devices are needed to resolve a PartitionSpec).
Then the port's ``Mesh`` groups, ``make_mesh_for_devices`` /
``make_production_mesh`` and ``DeviceGrid.zone_mesh``.
"""
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.sharding.rules import ShardCtx as JShardCtx  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.partition import DeviceGrid, PartitionTable  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_mesh_for_devices,
    make_production_mesh,
)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding.rules import (  # noqa: E402
    P,
    ShardCtx,
    make_ctx,
    single_device_ctx,
)

MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
RULE_SETS = {"serve": dict(fsdp=False), "fsdp": dict(fsdp=True),
             "zero3": dict(fsdp=True, dp_over_model=True)}
# cache shapes: a batch that splits over the data axes, and batch 1 (the
# long-context cell, whose sequence takes the data axis too)
CACHE_SHAPES = ((32, 4096), (1, 8192))


class _StandInMesh:
    """What JAX's ShardCtx reads of a mesh: axis names and a shape."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


def _flat(tree, is_spec, path=()):
    """(path, spec as a tuple) leaves: dict keys sorted, NamedTuple fields
    and sequences in order."""
    if is_spec(tree):
        return [(path, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat(tree[k], is_spec, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, is_spec, path + (i,))]
    return [(path, tree)]


def _j_ctx(shape, axes, **kw):
    names = axes
    batch = tuple(a for a in ("pod", "data") if a in names)
    return JShardCtx(mesh=_StandInMesh(shape, axes), batch_axes=batch,
                     model_axis="model", **kw)


def _t_ctx(shape, axes, **kw):
    return make_ctx(make_mesh_for_devices(*shape[-2:], pods=(
        shape[0] if len(shape) == 3 else 1), devices=["meta"]), **kw)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pspecs_match_jax(arch, shape):
    from jax.sharding import PartitionSpec
    axes = MESHES[shape]
    is_j = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    is_t = lambda x: isinstance(x, P)  # noqa: E731
    for rules, kw in RULE_SETS.items():
        jctx, tctx = _j_ctx(shape, axes, **kw), _t_ctx(shape, axes, **kw)
        jm = j_build_model(j_get_arch(arch), jctx)
        tm = build_model(ARCHS[arch], tctx)
        got = _flat(tm.params_pspecs(), is_t)
        want = _flat(jm.params_pspecs(), is_j)
        assert got == want, (arch, shape, rules)
        for b, s in CACHE_SHAPES:
            assert _flat(tm.cache_pspecs(b, s), is_t) == _flat(
                jm.cache_pspecs(b, s), is_j), (arch, shape, rules, b, s)
        # the model axis is really used at the production mesh
        if shape[-1] == 16 and rules == "serve":
            assert any("model" in str(s) for _, s in got)


def test_pspec_resolution_rules():
    """Divisibility-aware resolution: batch binds first, a TP dim keeps
    the model axis over the serve-mode embed fallback, an axis that does
    not divide is dropped."""
    ctx = make_ctx(make_mesh_for_devices(2, 4, devices=["meta"]),
                   fsdp=False)
    assert ctx.pspec(("batch", "kv_seq", None, None),
                     (8, 64, 2, 8)) == P("data", "model", None, None)
    assert ctx.pspec(("batch", "kv_seq", None, None),
                     (1, 64, 2, 8)) == P(None, ("data", "model"), None, None)
    assert ctx.pspec(("embed", "heads", None),
                     (32, 8, 4)) == P(None, "model", None)
    assert ctx.pspec(("embed", "kv_heads", None),
                     (32, 2, 4)) == P("model", None, None)
    assert ctx.pspec(("vocab", "embed"), (6, 32)) == P(None, "model")
    assert ctx.dp_size() == 2 and ctx.model_size() == 4 and ctx.sharded
    one = single_device_ctx()
    assert not one.sharded and one.model_size() == 1
    z = make_ctx(make_mesh_for_devices(2, 4, devices=["meta"]),
                 dp_over_model=True)
    assert z.pspec(("batch", None), (16, 3)) == P(("data", "model"), None)
    assert isinstance(ctx, ShardCtx)


def test_mesh_groups_and_ranks():
    mesh = make_mesh_for_devices(2, 4, devices=["cpu"])
    assert mesh.size == 8 and mesh.shape == {"data": 2, "model": 4}
    assert mesh.groups(("model",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups(("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.groups(("data", "model")) == [list(range(8))]
    assert mesh.groups(()) == [[r] for r in range(8)]
    assert [mesh.rank(r, ("model",)) for r in range(8)] == [0, 1, 2, 3] * 2
    assert mesh.rank(6, ("data", "model")) == 6
    assert mesh.distinct_devices() == [torch.device("cpu")]
    pods = make_mesh_for_devices(2, 2, pods=2, devices=["cpu", "meta"])
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.positions[:2] == [torch.device("cpu"), torch.device("meta")]
    prod = make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    assert prod.positions[0] == torch.device("meta")


def test_zone_mesh_of_explicit_and_cycled_grids():
    """A grid that states its entries gets one position per entry, repeats
    included; a cycled grid's zone on one device is one position (the
    one-device cell), and over distinct devices one per entry."""
    table = PartitionTable((1, 2, 4))
    table, z = table.carve("z", 2)
    explicit = DeviceGrid.from_flat(["cpu"] * 8, 1, 2, 4)
    m = explicit.zone_mesh(z)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    cycled = DeviceGrid.from_flat(["cpu"], 1, 2, 4, allow_reuse=True)
    assert cycled.zone_mesh(z).size == 1
    mixed = DeviceGrid.from_flat(["cpu", "meta"], 1, 2, 4, allow_reuse=True)
    assert mixed.zone_mesh(z).shape == {"data": 2, "model": 2}
    table2, z2 = PartitionTable((2, 1, 4)).carve("p", 2, pods=(0, 1))
    del table2
    pods = DeviceGrid.from_flat(["cpu"] * 8, 2, 1, 4)
    assert pods.zone_mesh(z2).axis_names == ("pod", "data", "model")
