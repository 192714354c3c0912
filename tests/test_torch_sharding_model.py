"""The port's model over a mesh of ``cpu`` positions, against its own
one-position model and JAX's one-device model (float32).

* The twin of ``tests/test_system.py::test_distributed_decode_matches_
  single_device``: qwen3-4b smoke (2 layers, vocab 256), B 4, S 32, mesh
  (2, 4), the KV cache laid out by ``Model.cache_pspecs`` (batch over
  data, sequence over model), ``sharded_decode`` on and off: logits
  within 1e-5 of the port's one-position decode and 2e-5 of JAX's.
* The sequence-sharded decode's LSE combine moves fewer bytes
  (``all-reduce``) than the gather path's per-layer cache ``all-gather``,
  by the factor reckoned from the cache length.
* The twin of ``test_moe_ep_layout_equality``: expert-parallel (2, 4)
  against data-parallel (8, 1), JAX's bounds, and each against JAX's
  one-device ``moe_block``.
* A serve cell over a zone of two positions gives a one-position cell's
  greedy tokens, for qwen3-4b and deepseek-moe-16b smoke; a resize from
  2 positions to 4 and back to 1 keeps the weights bit for bit, frees
  the source shards, and the cell's batcher keeps serving the same
  tokens.
"""
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.base import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.models.param import init_params as j_init_params  # noqa: E402
from repro.sharding.rules import single_device_ctx as j_ctx1  # noqa: E402
from repro_torch.configs.base import ArchConfig, MoEConfig  # noqa: E402
from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CellSpec,
    ClusterSpec,
    DeviceGrid,
    Supervisor,
)
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import batch_split  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    gather_tree,
    params_from_numpy,
    shard_tree,
    tree_leaves,
    tree_map,
)
from repro_torch.serve.batcher import Request  # noqa: E402
from repro_torch.sharding import collectives as C  # noqa: E402
from repro_torch.sharding.rules import P, make_ctx  # noqa: E402
from repro_torch.sharding.sharded import (  # noqa: E402
    Sharded,
    first,
    gather_leaf,
)

B, S = 4, 32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _decode_case(sharded_decode: bool):
    """(cfg, numpy params, tokens, JAX's one-device decode logits)."""
    jcfg = j_smoke_config(j_get_arch("qwen3-4b")).replace(
        num_layers=2, vocab=256, dtype="float32")
    jm = j_build_model(jcfg, j_ctx1())
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    cache = jm.init_cache(B, S)
    _, cache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :-1])},
                                   cache)
    dec = {"tokens": jnp.asarray(toks[:, -1:]),
           "pos": jnp.full((B,), S - 1, jnp.int32)}
    logits, _ = jax.jit(jm.decode)(jp, cache, dec)
    cfg = smoke_config(get_arch("qwen3-4b")).replace(
        num_layers=2, vocab=256, dtype="float32",
        sharded_decode=sharded_decode)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return cfg, host, toks, np.asarray(logits, np.float32)[:, :cfg.vocab]


def _port_decode(cfg, host, toks, ctx=None):
    """The port's prefill + decode: (logits (B, vocab), collective bytes
    of the decode step)."""
    model = build_model(cfg, ctx)
    params = params_from_numpy(host, dtype=torch.float32, device="cpu",
                               specs=model.param_specs())
    if ctx is None:
        cache = model.init_cache(B, S, device="cpu")
    else:
        params = shard_tree(params, model.params_pspecs(), ctx)
        cache = model.init_cache(B, S, device="cpu",
                                 pspecs=model.cache_pspecs(B, S))
        assert cache["layers"].k.spec == P(None, "data", "model", None, None)
    t = torch.from_numpy(toks)
    _, cache = model.prefill(params, {"tokens": t[:, :-1]}, cache)
    with C.recording() as log:
        logits, _ = model.decode(params, cache, {
            "tokens": t[:, -1:], "pos": torch.full((B,), S - 1,
                                                   dtype=torch.int32)})
    return logits[:, :cfg.vocab].numpy(), dict(log)


def _mesh_ctx(n_data, n_model):
    return make_ctx(make_mesh_for_devices(n_data, n_model, devices=["cpu"]))


@pytest.mark.parametrize("sharded_decode", [False, True],
                         ids=["gathered", "lse"])
def test_distributed_decode_matches_single_device(sharded_decode):
    cfg, host, toks, jlogits = _decode_case(sharded_decode)
    one, _ = _port_decode(cfg, host, toks)
    dist, log = _port_decode(cfg, host, toks, _mesh_ctx(2, 4))
    assert _rel(dist, one) < 1e-5
    assert _rel(dist, jlogits) < 2e-5
    assert log["all-reduce"] > 0


def test_sharded_decode_moves_fewer_bytes_than_the_gather():
    """Per layer and position the gather path all-gathers the layer's
    cache, k and v (B_l, S_c, Hkv, Dh) and slot_pos (B_l, S_c); the LSE
    combine all-reduces m and l (B_l, Hkv, G) and acc (B_l, Hkv, G, Dh),
    float32 — the rest of the two steps' collectives is the same."""
    cfg, host, toks, _ = _decode_case(False)
    ctx = _mesh_ctx(2, 4)
    _, gathered = _port_decode(cfg, host, toks, ctx)
    _, lse = _port_decode(cfg.replace(sharded_decode=True), host, toks, ctx)
    L, Hq, Hkv, Dh = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    b_l = B // 2
    cache_bytes = L * (2 * b_l * S * Hkv * Dh * 4 + b_l * S * 4)
    stats_bytes = L * (2 * b_l * Hq * 4 + b_l * Hq * Dh * 4)
    assert gathered["all-gather"] - lse["all-gather"] == cache_bytes
    assert lse["all-reduce"] - gathered["all-reduce"] == stats_bytes
    factor = (2 * S * Hkv * Dh + S) / (Hq * (2 + Dh))
    assert cache_bytes / stats_bytes == pytest.approx(factor)
    assert factor > 1


def _moe_cfgs():
    kw = dict(name="t", family="moe", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=2, head_dim=16, d_ff=64, vocab=64,
              dtype="float32")
    return (JArchConfig(moe=JMoEConfig(num_experts=8, top_k=2, d_expert=48,
                                       capacity_factor=8.0), **kw),
            ArchConfig(moe=MoEConfig(num_experts=8, top_k=2, d_expert=48,
                                     capacity_factor=8.0), **kw))


def test_moe_ep_layout_equality():
    """EP over a 4-wide model axis == the data-parallel (8, 1) layout,
    and both == JAX's one-device block."""
    jcfg, tcfg = _moe_cfgs()
    jc1 = j_ctx1()
    jp = j_init_params(jmoe.moe_specs(jcfg, jc1), jax.random.PRNGKey(0),
                       "float32")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 16, 32),
                                     jnp.float32))
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_block(p, x, jcfg, jc1,
                                                   train=True))(jp, x)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    outs = []
    for shape in ((2, 4), (8, 1)):
        ctx = _mesh_ctx(*shape)
        assert tmoe.use_ep(tcfg, ctx)
        specs = tmoe.moe_specs(tcfg, ctx)
        p = shard_tree(params_from_numpy(host, dtype=torch.float32,
                                         device="cpu", specs=specs),
                       ctx.params_pspecs(specs), ctx)
        xs = batch_split(ctx, torch.from_numpy(np.array(x)))
        with C.recording() as log:
            y, aux = tmoe.moe_block(p, xs, tcfg, ctx, train=True)
        y = gather_leaf(Sharded(y.shards, ctx.mesh, xs.spec))
        outs.append((y.numpy(), float(first(aux))))
        if shape == (2, 4):
            assert log["reduce-scatter"] > 0 and log["all-gather"] > 0
    assert _rel(outs[0][0], outs[1][0]) < 1e-4
    assert abs(outs[0][1] - outs[1][1]) < 1e-3
    for y, aux in outs:
        assert _rel(y, jy) < 1e-4
        assert abs(aux - float(jaux)) < 1e-3


# --------------------------------------------------------------------------
# serve cells over several positions
# --------------------------------------------------------------------------
def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=16).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, vocab, size=n).astype(
        np.int32)]) for n in (3, 9, 5, 12)]


def _serve(bat, prompts, rid0=0):
    """Two waves (the second hits the first's prefix); {rid: tokens} of
    these requests."""
    for w, wave in enumerate((prompts[:2], prompts[2:])):
        for i, p in enumerate(wave):
            bat.submit(Request(rid=rid0 + 2 * w + i, prompt=p,
                               max_new_tokens=5))
        bat.run_until_drained()
    return {r.rid: list(r.output) for r in bat.done if r.rid >= rid0}


def _cell(arch, ncols, explicit=True):
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    grid = (DeviceGrid.from_flat(["cpu"] * 8, 1, 1, 8) if explicit
            else DeviceGrid.from_flat(["cpu"], 1, 1, 8, allow_reuse=True))
    sup = Supervisor(grid)
    sup.apply(ClusterSpec(cells=(CellSpec("c", cfg, "serve",
                                          ncols=ncols),)))
    cell = sup.cells["c"]
    cell.init_serve(generator=torch.Generator().manual_seed(0))
    return sup, cell


BATCHER = dict(batch_slots=2, max_len=64, prefill_chunk=8, page_size=8)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_serve_cell_on_two_positions_matches_one(arch):
    _, one = _cell(arch, 2, explicit=False)
    assert one.mesh.size == 1 and not one.model.sharded
    ref = _serve(one.make_batcher(**BATCHER), _prompts(one.arch.vocab))
    sup, two = _cell(arch, 2)
    assert two.mesh.shape == {"data": 1, "model": 2} and two.model.sharded
    bat = two.make_batcher(**BATCHER)
    assert isinstance(bat.pool.arena[0].k, Sharded)
    got = _serve(bat, _prompts(two.arch.vocab))
    assert got == ref
    assert bat.pool.prefix_hit_tokens > 0
    costs = {k: p.collective_per_device
             for k, p in two.accounting.programs.items()}
    assert any(k.startswith("paged") for k in costs)
    assert all(c.get("all-reduce", 0) > 0 for c in costs.values())
    # every position's tensors lie on the zone's device: the guard passes
    assert sup.validate_cell_programs("c") == 2
    # the one-position weights, laid out by the rules, are the same
    g1, g2 = gather_tree(one.serve_params), gather_tree(two.serve_params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1),
                                                   tree_leaves(g2)))


def test_resize_across_meshes_keeps_weights_and_frees_shards():
    arch = "deepseek-moe-16b"
    _, one = _cell(arch, 1, explicit=False)
    ref_bat = one.make_batcher(**BATCHER)
    prompts = _prompts(one.arch.vocab)
    ref = _serve(ref_bat, prompts)
    ref2 = _serve(ref_bat, _prompts(one.arch.vocab, seed=3), rid0=100)
    sup, cell = _cell(arch, 2)
    full = tree_map(lambda t: t.clone(), gather_tree(cell.serve_params))
    bat = cell.make_batcher(**BATCHER)
    assert _serve(bat, prompts) == ref
    old = tree_leaves(cell.serve_params)
    old_leaves = _sharded_leaves(cell.serve_params)
    refs = [weakref.ref(t) for t in old]
    del old
    sup.resize_cell("c", 4)
    assert cell.mesh.size == 4 and cell.model.ctx.model_size() == 4
    assert all(not x.shards for x in old_leaves)
    gc.collect()
    assert all(r() is None for r in refs)
    now = gather_tree(cell.serve_params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(full),
                                                   tree_leaves(now)))
    # the batcher was rebound to the 4-position model and keeps serving
    assert bat.model is cell.model and bat.pool.arena[0].k.mesh.size == 4
    assert _serve(bat, _prompts(one.arch.vocab, seed=3), rid0=100) == ref2
    sup.resize_cell("c", 1)
    assert cell.mesh.size == 1 and not cell.model.sharded
    assert all(isinstance(t, torch.Tensor) and not isinstance(t, Sharded)
               for t in tree_leaves(cell.serve_params))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(full), tree_leaves(cell.serve_params)))
    assert isinstance(bat.pool.arena[0].k, torch.Tensor)


def _sharded_leaves(tree):
    out = []
    tree_map(lambda x: out.append(x) if isinstance(x, Sharded) else None,
             tree)
    return out
