"""The ssm, hybrid and encdec families over a mesh of ``cpu`` positions,
against JAX's one-device model and the port's one-position model
(float32).

* mamba2-2.7b, zamba2-2.7b and seamless-m4t-large-v2 at smoke size over
  meshes (1, 2) and (1, 4), weights from JAX's ``Model.init`` through
  ``params_from_numpy``: a bucket-padded ``prefill_ranged`` (state
  checkpoints for ssm / hybrid; ragged sources and a row without one for
  encdec), an extend (from a snapshot restored into a fresh cache; encdec
  over the dense cache behind each row's prompt) and four decode steps,
  logits within 2e-5 of JAX's.
* The Mamba state and the checkpoints laid out by position: the first
  Mamba layer (whose inputs both models compute alike) gathers to the
  one-position model's bit for bit, every layer to within 2e-5 (the
  row-parallel ``psum``s round deeper layers' inputs differently), and a
  one-position state laid onto the mesh and gathered back is itself.
* The replicated fallback: SSD heads that do not divide the model axis
  (a mesh of 3 positions; 15 heads over 2).
* A serve cell over two positions gives a one-position cell's greedy
  tokens, cold and warm (a snapshot-chain restore; seamless with ragged
  sources and a ``src=None`` request), with equal snapshot counters.
* ``resize_to`` 1 -> 2 -> 4 -> 1 of a mamba2 and a zamba2 cell keeps the
  weights and the interned payloads bit for bit, frees the source
  shards, and the live batcher keeps serving the same tokens and hits.
* Cells over a mesh bind in both roles: a train cell over two positions
  trains (training under a mesh, item 13c, lifted the refusal that
  stood here); a serve cell over a zone of several rows binds and serves
  the one-position cell's tokens.
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models import cache_utils as jcu  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx as j_ctx1  # noqa: E402
from repro_torch.configs.base import ShapeConfig, smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CellSpec,
    ClusterSpec,
    DeviceGrid,
    Supervisor,
)
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models import cache_utils as tcu  # noqa: E402
from repro_torch.models.mamba2 import mamba_tp  # noqa: E402
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
from repro_torch.sharding.rules import P, Segments, make_ctx  # noqa: E402
from repro_torch.sharding.sharded import Sharded, relay_leaf  # noqa: E402

ARCHS = ["mamba2-2.7b", "zamba2-2.7b", "seamless-m4t-large-v2"]
RECURRENT = ARCHS[:2]
B, S_PAD, MAX_LEN, CK = 3, 32, 64, 8
TOL = 2e-5
_JAX = {}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ctx(n_model: int):
    return make_ctx(make_mesh_for_devices(1, n_model, devices=["cpu"]))


def _sources(seed=5, lens=(20, 9, None), d=128):
    rng = np.random.default_rng(seed)
    return [None if n is None else
            rng.standard_normal((n, d)).astype(np.float32) for n in lens]


def _inputs(vocab):
    rng = np.random.default_rng(0)
    lengths = np.array([32, 21, 9], np.int32)
    tokens = rng.integers(1, vocab, (B, S_PAD)).astype(np.int32)
    tokens[np.arange(S_PAD)[None] >= lengths[:, None]] = 0
    return tokens, lengths


def _restore_rows(model, cache, ckpts, full):
    """Slot 1 from row 0's snapshot after chunk 1 (16 tokens) and, with
    KV, the row's first two pages; slot 2 from row 2's final state."""
    model.restore_state_row(cache, model.slice_checkpoint(ckpts, 0, 1), 1)
    ax = model._state_batch_axis
    node = model.state_node(full)
    model.restore_state_row(cache, type(node)(*(
        a[(slice(None),) * ax + (slice(2, 3),)] for a in node)), 2)
    axes = tcu.kv_node_axes(model, 1, MAX_LEN)
    if axes:
        for slot, row in ((1, 0), (2, 2)):
            tcu.load_pages_into_row(cache, axes, slot, tcu.extract_row_pages(
                full, axes, row, 0, 2, CK), 0, CK)
    return cache


def _jax_run(arch):
    """JAX's one-device model: (numpy weights, logits of the prefill, the
    extend and four decode steps, the prefill's checkpoints)."""
    if arch in _JAX:
        return _JAX[arch]
    jm = j_build_model(j_smoke_config(j_get_arch(arch)).replace(
        dtype="float32"), j_ctx1())
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    tokens, lengths = _inputs(jm.cfg.vocab)
    batch = {"tokens": jnp.asarray(tokens), "length": jnp.asarray(lengths)}
    outs, ck = [], None
    if jm.cfg.family == "encdec":
        batch.update(jm.ranged_batch_extras(_sources(), MAX_LEN))
        logits, cache = jax.jit(jm.prefill_ranged)(
            jp, batch, jm.init_cache(B, MAX_LEN))
        outs.append(logits)
        ext = {"tokens": jnp.asarray(tokens[:, :8]),
               "pos": jnp.asarray(lengths), "length": jnp.asarray(
                   np.array([8, 5, 3], np.int32))}
        logits, cache = jax.jit(jm.prefill_extend)(jp, ext, cache)
        pos = lengths + np.array([8, 5, 3], np.int32)
    else:
        logits, full, ck = jax.jit(
            jm.prefill_ranged, static_argnames="checkpoint_every")(
                jp, batch, jm.init_cache(B, MAX_LEN), checkpoint_every=CK)
        outs.append(logits)
        cache = jm.init_cache(B, MAX_LEN)
        cache = jm.restore_state_row(cache, jm.slice_checkpoint(ck, 0, 1), 1)
        ax = 1 if jm.cfg.family == "ssm" else 2
        node = (full["mamba_layers"] if jm.cfg.family == "ssm"
                else full["groups"].mamba)
        cache = jm.restore_state_row(cache, jax.tree.map(
            lambda a: a[(slice(None),) * ax + (slice(2, 3),)], node), 2)
        axes = jcu.kv_node_axes(jm, 1, MAX_LEN)
        if axes:
            for slot, row in ((1, 0), (2, 2)):
                cache = jcu.load_pages_into_row(
                    cache, cache, axes, slot,
                    jcu.extract_row_pages(full, axes, row, 0, 2, CK), 0, CK)
        ext = np.zeros((B, 16), np.int32)
        ext[1] = tokens[0, 16:32]
        logits, cache = jax.jit(jm.prefill_extend)(jp, {
            "tokens": jnp.asarray(ext),
            "pos": jnp.asarray(np.array([MAX_LEN, 16, MAX_LEN], np.int32)),
            "length": jnp.asarray(np.array([0, 16, 0], np.int32))}, cache)
        pos = np.array([0, 32, 9], np.int32)
    outs.append(logits)
    for t in range(4):
        logits, cache = jax.jit(jm.decode)(jp, cache, {
            "tokens": jnp.asarray(tokens[:, t:t + 1]),
            "pos": jnp.asarray(pos + t)})
        outs.append(logits)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    _JAX[arch] = (host, [_np(o) for o in outs],
                  None if ck is None else [_np(a) for a in ck])
    return _JAX[arch]


def _port_run(arch, ctx=None, host=None):
    """The port's model, over ``ctx``'s mesh or one position: the same
    calls as :func:`_jax_run`.  Returns (logits list, the prefill's cache
    and checkpoints, the model)."""
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    model = build_model(cfg, ctx)
    params = params_from_numpy(host, dtype=torch.float32, device="cpu",
                               specs=model.param_specs())
    if ctx is not None:
        params = shard_tree(params, model.params_pspecs(), ctx)
    tokens, lengths = _inputs(cfg.vocab)
    t = torch.from_numpy
    batch = {"tokens": t(tokens), "length": t(lengths)}
    outs, ck, full = [], None, None
    cache = model.init_cache(B, MAX_LEN, device="cpu")
    if cfg.family == "encdec":
        batch.update(model.ranged_batch_extras(_sources(), MAX_LEN))
        logits, cache = model.prefill_ranged(params, batch, cache)
        outs.append(logits)
        full = cache
        elen = np.array([8, 5, 3], np.int32)
        logits, cache = model.prefill_extend(params, {
            "tokens": t(tokens[:, :8].copy()), "pos": t(lengths.copy()),
            "length": t(elen)}, cache)
        pos = lengths + elen
    else:
        logits, full, ck = model.prefill_ranged(params, batch, cache,
                                                checkpoint_every=CK)
        outs.append(logits)
        cache = _restore_rows(model, model.init_cache(B, MAX_LEN,
                                                      device="cpu"), ck, full)
        ext = np.zeros((B, 16), np.int32)
        ext[1] = tokens[0, 16:32]
        logits, cache = model.prefill_extend(params, {
            "tokens": t(ext), "pos": t(np.array([MAX_LEN, 16, MAX_LEN],
                                                np.int32)),
            "length": t(np.array([0, 16, 0], np.int32))}, cache)
        pos = np.array([0, 32, 9], np.int32)
    outs.append(logits)
    for s in range(4):
        with C.recording() as log:
            logits, cache = model.decode(params, cache, {
                "tokens": t(tokens[:, s:s + 1].copy()), "pos": t(pos + s)})
        outs.append(logits)
    if ctx is not None:
        assert log["all-reduce"] > 0
    return [_np(o) for o in outs], full, ck, model


# --------------------------------------------------------------------------
# the models against JAX
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_extend_decode_match_jax(arch, n_model):
    host, jlogits, _ = _jax_run(arch)
    ctx = _ctx(n_model)
    got, _, _, model = _port_run(arch, ctx, host)
    assert model.sharded and model.local.cfg != model.cfg
    if arch in RECURRENT:
        assert mamba_tp(model.cfg, ctx)
        # extend: the restored row (the others ride along at length 0)
        got[1], jlogits = got[1][1:2], list(jlogits)
        jlogits[1] = jlogits[1][1:2]
    vocab = model.cfg.vocab
    for step, (a, b) in enumerate(zip(got, jlogits)):
        assert _rel(a[:, :vocab], b[:, :vocab]) < TOL, step


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("arch", RECURRENT)
def test_gather_of_states_and_checkpoints(arch, n_model):
    host, _, jck = _jax_run(arch)
    ctx = _ctx(n_model)
    _, full1, ck1, m1 = _port_run(arch, None, host)
    _, full2, ck2, m2 = _port_run(arch, ctx, host)
    conv = m2.state_node(full2).conv
    assert isinstance(conv, Sharded)
    assert isinstance(conv.spec[-1], Segments)
    assert conv.shape[-1] < conv.global_shape[-1]
    first = (0,) if arch == "mamba2-2.7b" else (0, 0)
    for one, two in ((m1.state_node(full1), m2.state_node(full2)),
                     (ck1, ck2)):
        g = gather_tree(two)
        for a, b in zip(one, g):
            assert a.shape == b.shape
            assert torch.equal(a[first], b[first])      # bit for bit
            assert _rel(b, a) < TOL
    for a, j in zip(gather_tree(ck2), jck):
        assert _rel(a, j) < TOL
    # a one-position state laid out by position and gathered is itself
    for tree in (m1.state_node(full1), ck1):
        like = (m2.state_node(m2.init_cache(B, MAX_LEN)) if tree is not ck1
                else m2.init_checkpoints(B, S_PAD // CK))
        laid = tree_map(lambda src, dst: relay_leaf(src, into=dst), tree,
                        like)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(tree), tree_leaves(gather_tree(laid))))


FALLBACK = [("mamba2-2.7b", 3, None), ("zamba2-2.7b", 3, None),
            ("mamba2-2.7b", 2, 120)]


@pytest.mark.parametrize("arch,n_model,d_model", FALLBACK,
                         ids=["mamba2-3pos", "zamba2-3pos", "mamba2-15heads"])
def test_replicated_fallback(arch, n_model, d_model):
    """SSD heads that do not divide the model axis: every position runs
    the whole Mamba layer and holds the whole state.  With 15 heads over
    2 positions the rules still split ``inner`` (240), so the layer
    gathers its weights first."""
    jcfg = j_smoke_config(j_get_arch(arch)).replace(dtype="float32")
    if d_model:
        jcfg = jcfg.replace(d_model=d_model)
    jm = j_build_model(jcfg, j_ctx1())
    jp = jax.jit(jm.init)(jax.random.PRNGKey(2))
    tokens, lengths = _inputs(jcfg.vocab)
    jlog, _, jck = jax.jit(jm.prefill_ranged, static_argnames=(
        "checkpoint_every",))(jp, {"tokens": jnp.asarray(tokens),
                                   "length": jnp.asarray(lengths)},
                              jm.init_cache(B, MAX_LEN), checkpoint_every=CK)
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    if d_model:
        cfg = cfg.replace(d_model=d_model)
    ctx = _ctx(n_model)
    model = build_model(cfg, ctx)
    assert not mamba_tp(cfg, ctx)
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    params = shard_tree(params_from_numpy(host, dtype=torch.float32,
                                          device="cpu",
                                          specs=model.param_specs()),
                        model.params_pspecs(), ctx)
    if d_model:
        lay = params["mamba_layers"]["mamba"]["wz"].spec
        assert "model" in lay.axes_of(2)            # the rules split inner
    logits, cache, ck = model.prefill_ranged(
        params, {"tokens": torch.from_numpy(tokens),
                 "length": torch.from_numpy(lengths)},
        model.init_cache(B, MAX_LEN), checkpoint_every=CK)
    assert all(s is None for s in model.state_node(cache).conv.spec)
    assert _rel(_np(logits)[:, :cfg.vocab], _np(jlog)[:, :cfg.vocab]) < TOL
    for a, j in zip(gather_tree(ck), jck):
        assert _rel(a, _np(j)) < TOL


# --------------------------------------------------------------------------
# serve cells over several positions
# --------------------------------------------------------------------------
def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=16).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, vocab, size=n).astype(
        np.int32)]) for n in (3, 9, 5, 12)]


def _serve(bat, prompts, rid0=0, srcs=None):
    """Two waves (the second restores the first's prefix); {rid: tokens}
    of these requests."""
    srcs = srcs or [None] * len(prompts)
    for wave in ((0, 1), (2, 3)):
        for i in wave:
            bat.submit(Request(rid=rid0 + i, prompt=prompts[i],
                               max_new_tokens=5, src=srcs[i]))
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
SNAPSHOT_KEYS = ("snapshots_interned", "snapshot_hit_tokens",
                 "snapshot_bytes_saved", "prefix_hit_tokens")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cell_on_two_positions_matches_one(arch):
    srcs = (_sources(lens=(20, None, 9, None))
            if arch == "seamless-m4t-large-v2" else None)
    _, one = _cell(arch, 2, explicit=False)
    assert not one.model.sharded
    b1 = one.make_batcher(**BATCHER)
    ref = _serve(b1, _prompts(one.arch.vocab), srcs=srcs)
    sup, two = _cell(arch, 2)
    assert two.mesh.shape == {"data": 1, "model": 2} and two.model.sharded
    b2 = two.make_batcher(**BATCHER)
    got = _serve(b2, _prompts(two.arch.vocab), srcs=srcs)
    assert got == ref
    s1, s2 = b1.pool.stats(), b2.pool.stats()
    assert {k: s2[k] for k in SNAPSHOT_KEYS} == {k: s1[k]
                                                 for k in SNAPSHOT_KEYS}
    assert s2["prefix_hit_tokens"] > 0
    if arch in RECURRENT:
        assert s2["snapshot_hit_tokens"] > 0
        payload = next(iter(b2.pool._snaps.values()))
        assert all(isinstance(a, Sharded) for a in payload["state"])
        assert isinstance(b2._ckpts._flat[0], Sharded)
    costs = {k: p.collective_per_device
             for k, p in two.accounting.programs.items()}
    assert costs and all(c.get("all-reduce", 0) > 0 for c in costs.values())
    assert sup.validate_cell_programs("c") == 2


def _payload_leaves(pool):
    return [t for h in sorted(pool._snaps) for t in tree_leaves(
        gather_tree(pool._snaps[h]))]


@pytest.mark.parametrize("arch", RECURRENT)
def test_resize_across_meshes_keeps_weights_and_payloads(arch):
    _, one = _cell(arch, 1, explicit=False)
    ref_bat = one.make_batcher(**BATCHER)
    rounds = [_prompts(one.arch.vocab, seed) for seed in (0, 0, 3, 3)]
    ref = [_serve(ref_bat, p, 100 * i) for i, p in enumerate(rounds)]
    ref_hits = ref_bat.pool.stats()["snapshot_hit_tokens"]
    sup, cell = _cell(arch, 1)
    assert not cell.model.sharded
    full = tree_map(lambda t: t.clone(), cell.serve_params)
    bat = cell.make_batcher(**BATCHER)
    assert _serve(bat, rounds[0]) == ref[0]
    for i, ncols in enumerate((2, 4, 1), start=1):
        payloads = [t.clone() for t in _payload_leaves(bat.pool)]
        old = [x for x in tree_leaves(
            [cell.serve_params, list(bat.pool._snaps.values())])]
        old_sharded = _sharded_leaves(
            [cell.serve_params, list(bat.pool._snaps.values())])
        refs = [weakref.ref(t) for t in old]
        del old
        sup.resize_cell("c", ncols)
        assert cell.mesh.size == ncols and bat.model is cell.model
        assert all(not x.shards for x in old_sharded)
        gc.collect()
        assert all(r() is None for r in refs)
        now = gather_tree(cell.serve_params)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(full),
                                                       tree_leaves(now)))
        assert all(torch.equal(a, b) for a, b in
                   zip(payloads, _payload_leaves(bat.pool)))
        state = next(iter(bat.pool._snaps.values()))["state"]
        assert isinstance(state.conv, Sharded) == (ncols > 1)
        assert _serve(bat, rounds[i], 100 * i) == ref[i]
    assert bat.pool.stats()["snapshot_hit_tokens"] == ref_hits
    assert not cell.model.sharded
    assert not _sharded_leaves([cell.serve_params, bat.cache,
                                list(bat.pool._snaps.values())])


def _sharded_leaves(tree):
    out = []
    tree_map(lambda x: out.append(x) if isinstance(x, Sharded) else None,
             tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_bind_and_the_refusals_that_stay(arch):
    """A serve and a train cell over two positions bind (the train cell
    takes a step: no refusal stays since item 13c), and a serve cell over
    a zone of two rows serves the one-position cell's tokens."""
    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    sup = Supervisor(DeviceGrid.from_flat(["cpu"] * 8, 1, 1, 8))
    cell = sup.create_cell("s", cfg, "serve", ncols=2)
    assert cell.model.sharded and cell.mesh.size == 2
    trainer = sup.create_cell("t", cfg, "train", ncols=2)
    assert trainer.model.sharded and trainer.mesh.size == 2
    pipe = SyntheticPipeline(DataConfig(kind="bigram"), cfg,
                             ShapeConfig("t", "train", 16, 2), device="cpu")
    m = trainer.train_steps(pipe.get_batch, 1)
    assert np.isfinite(m["xent"]) and np.isfinite(m["grad_norm"])
    rows = Supervisor(DeviceGrid.from_flat(["cpu"] * 8, 1, 2, 4))
    two_rows = rows.create_cell("s", cfg, "serve", ncols=1)
    assert two_rows.mesh.shape == {"data": 2, "model": 1}
    assert two_rows.model.sharded
    two_rows.init_serve(generator=torch.Generator().manual_seed(0))
    _, one = _cell(arch, 1, explicit=False)
    prompts = _prompts(cfg.vocab)
    srcs = (_sources(lens=(20, None, 9, None))
            if arch == "seamless-m4t-large-v2" else None)
    got = _serve(two_rows.make_batcher(**BATCHER), prompts, srcs=srcs)
    assert got and got == _serve(one.make_batcher(**BATCHER), prompts,
                                 srcs=srcs)


def test_conv_state_layout_is_segments():
    """The conv state of mamba2 smoke over 2 positions: each position
    holds [x_r | B | C], the x segment split over ``model``."""
    ctx = _ctx(2)
    model = build_model(smoke_config(get_arch("mamba2-2.7b")).replace(
        dtype="float32"), ctx)
    conv = model.init_cache(1, MAX_LEN)["mamba_layers"].conv
    d_inner, gn = 256, 2 * 16
    assert conv.spec == P(None, None, None, Segments(
        (d_inner, ("model",)), (gn, ())))
    assert conv.shape[-1] == d_inner // 2 + gn
    assert conv.global_shape[-1] == d_inner + gn
