"""Training over a mesh: the port's train step over CPU positions against
JAX's one-device step (CPU, float32).

* qwen3-4b at smoke size in float32 over (data 1, model 2), (2, 2) and
  (pod 2, data 1, model 2): ``loss``, ``xent`` and ``aux`` to 1e-5
  relative, every gathered gradient leaf to 1e-4 (relative to the leaf's
  largest entry), every copy of a gradient leaf bitwise equal, and the
  params after 3 steps to 1e-5, the tolerances of
  ``tests/test_torch_train.py``.  ``test_torch_train_mesh_families.py``
  holds deepseek-moe-16b and mamba2-2.7b, and
  ``test_torch_train_mesh_hybrid.py`` zamba2-2.7b and
  seamless-m4t-large-v2, the same way, through this module's helpers (a
  MoE dropless, ``capacity_factor`` 8: a position's capacity comes from
  its own tokens, as in JAX's ``shard_map``, so only a dropless step is
  the one-device step).
* A microbatched step (microbatch 2) and a step with int8 error-feedback
  compression (the global per-tensor scale) over (2, 2) against JAX's.
* ``compressed_psum`` in its collective form over 4 positions: JAX's
  under ``vmap`` with a named axis gives the reference, and the twin of
  ``tests/test_train.py::test_compressed_psum_with_error_feedback_converges``
  holds the error feedback unbiased over 20 steps.
* Each collective's backward is its dual (``psum`` <-> ``psum``,
  ``all_gather`` <-> ``psum_scatter``), bitwise over the copies of a
  replicated result, and records its bytes.
* The lifecycle twin of ``tests/test_system.py::test_multidevice_lifecycle``
  on a 2 x 4 grid of CPU positions: train 2 columns, resize to 3 bit for
  bit, transfer a column, checkpoint, fail a column, recover at step 4,
  train; the accounting's collective bytes.
"""
import dataclasses
import math
import tempfile
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig, smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro.train import grad_compress as j_gc  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.core import DeviceGrid, Supervisor  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    gather_tree,
    jax_leaves,
    params_from_numpy,
    shard_tree,
    tree_map,
)
from repro_torch.sharding import collectives as C  # noqa: E402
from repro_torch.sharding.rules import make_ctx  # noqa: E402
from repro_torch.sharding.sharded import Sharded, first, shard_leaf  # noqa: E402
from repro_torch.train import grad_compress  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptConfig,
    copy_axes,
    init_adam_state,
)
from repro_torch.train.train_step import (  # noqa: E402
    TrainState,
    _grad_leaf,
    _layer_depth,
    build_train_step,
    reduce_copies,
    train_state_pspecs,
)

MESHES = {"1x2": (1, 1, 2), "2x2": (1, 2, 2), "2x1x2": (2, 1, 2)}
_CACHE = {}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _mesh(name):
    pods, data, model = MESHES[name]
    return make_mesh_for_devices(data, model, pods=pods, devices=["cpu"])


def _dropless(cfg):
    """A MoE config at capacity factor 8 (no token dropped); others as
    they are."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _configs(arch, **kw):
    jcfg = _dropless(smoke_config(get_arch(arch)).replace(dtype="float32",
                                                          **kw))
    tcfg = _dropless(t_smoke_config(t_get_arch(arch)).replace(
        dtype="float32", **kw))
    return jcfg, tcfg


def _bridge(jp, model):
    return params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                          jp), dtype=model.dtype, device="cpu",
                             specs=model.param_specs())


def _batches(jcfg, tcfg, B=2, S=16):
    jb = JPipeline(JDataConfig(kind="bigram"), jcfg,
                   ShapeConfig("t", "train", S, B)).get_batch(0)
    tb = SyntheticPipeline(DataConfig(kind="bigram"), tcfg,
                           TShape("t", "train", S, B),
                           device="cpu").get_batch(0)
    return jb, tb


def _jax_ref(arch):
    """JAX's one-device loss metrics, gradients and params after 3 steps
    (default OptConfig) on ``Model.init(PRNGKey(0))`` and one batch."""
    key = ("jax", arch)
    if key in _CACHE:
        return _CACHE[key]
    jcfg, tcfg = _configs(arch)
    jm = build_model(jcfg, single_device_ctx())
    jp = jm.init(jax.random.PRNGKey(0))
    jb, tb = _batches(jcfg, tcfg)
    (_, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, jb),
                                       has_aux=True)(jp)
    js = j_ts.init_train_state(jm, jax.random.PRNGKey(0), j_opt.OptConfig())
    jstep = jax.jit(j_ts.build_train_step(jm, j_opt.OptConfig()))
    losses = []
    for _ in range(3):
        js, m = jstep(js, jb)
        losses.append(float(m["loss_step"]))
    out = {"jp": jp, "tb": tb, "tcfg": tcfg,
           "metrics": {k: float(v) for k, v in jmet.items()},
           "grads": [np.asarray(g) for g in jax.tree.leaves(jg)],
           "losses": losses,
           "params": [np.asarray(x) for x in jax.tree.leaves(js.params)]}
    _CACHE[key] = out
    return out


def _mesh_run(arch, mesh_name):
    """The port over ``mesh_name``: loss metrics, gathered gradients and
    whether every copy of each gradient leaf holds the same bits, and the
    losses and gathered params of 3 train steps."""
    key = (arch, mesh_name)
    if key in _CACHE:
        return _CACHE[key]
    ref = _jax_ref(arch)
    tcfg, tb = ref["tcfg"], ref["tb"]
    ctx = make_ctx(_mesh(mesh_name))
    tm = Model(tcfg, ctx)
    full = _bridge(ref["jp"], tm)
    params = shard_tree(tree_map(torch.clone, full), tm.params_pspecs(), ctx)
    grads = tree_map(torch.zeros_like, params)
    leaves = tree_map(lambda p, g, s: _grad_leaf(p, g, _layer_depth(s)),
                      params, grads, tm.param_specs())
    loss, met = tm.loss(leaves, tb)
    first(loss).backward()
    reduce_copies(grads)
    same = all(
        torch.equal(g.shards[grp[0]], g.shards[r])
        for g in jax_leaves(grads)
        for grp in g.mesh.groups(copy_axes(g)) for r in grp)
    out = {"metrics": {k: float(first(v).detach()) for k, v in met.items()},
           "grads": [g.numpy() for g in jax_leaves(gather_tree(grads))],
           "copies_equal": same}
    state = TrainState(params=params, opt=init_adam_state(params,
                                                          OptConfig()))
    step = build_train_step(tm, OptConfig())
    losses = []
    for _ in range(3):
        state, m = step(state, tb)
        losses.append(float(m["loss_step"]))
    out["losses"] = losses
    out["params"] = [x.numpy() for x in jax_leaves(gather_tree(state.params))]
    _CACHE[key] = out
    return out


def _check_loss(arch, mesh_name):
    j, t = _jax_ref(arch)["metrics"], _mesh_run(arch, mesh_name)["metrics"]
    assert set(t) == {"loss", "xent", "aux"}
    for k in ("loss", "xent", "aux"):
        assert abs(t[k] - j[k]) <= 1e-5 * max(abs(j[k]), 1e-6), (k, t, j)


def _check_grads(arch, mesh_name):
    r = _mesh_run(arch, mesh_name)
    jg, tg = _jax_ref(arch)["grads"], r["grads"]
    assert len(jg) == len(tg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4, (i, _rel(a, b))
    assert r["copies_equal"]


def _check_steps(arch, mesh_name):
    ref, r = _jax_ref(arch), _mesh_run(arch, mesh_name)
    for a, b in zip(r["params"], ref["params"]):
        assert _rel(a, b) < 1e-5
    for a, b in zip(r["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)


FAMILIES = ["qwen3-4b"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_over_a_mesh_matches_jax(arch, mesh_name):
    _check_loss(arch, mesh_name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_over_a_mesh_match_jax(arch, mesh_name):
    _check_grads(arch, mesh_name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_after_three_steps_over_a_mesh_match_jax(arch, mesh_name):
    _check_steps(arch, mesh_name)


@pytest.mark.parametrize("mb,compress", [(2, False), (1, True)],
                         ids=["microbatch2", "compressed"])
def test_microbatched_and_compressed_steps_over_a_mesh_match_jax(
        mb, compress):
    """qwen3-4b smoke over (2, 2) with microbatch 2 (each microbatch's
    rows split over the data axis) and with int8 error-feedback
    compression at the global per-tensor scale: 2 steps, the metrics
    against JAX's one-device step, and the params after microbatched
    steps.  The compressed steps' params are held by the next test on a
    given gradient: here a code of an entry next to a rounding boundary
    may differ by one (the gradients agree to 1e-7, not bitwise), and
    at the warmup's learning rate of 3e-6 a code of 0 against 1 moves
    that entry by the learning rate, 1.2e-5 of its leaf's largest."""
    jcfg, tcfg = _configs("qwen3-4b", microbatch=mb)
    jm = build_model(jcfg, single_device_ctx())
    ctx = make_ctx(_mesh("2x2"))
    tm = Model(tcfg, ctx)
    js = j_ts.init_train_state(jm, jax.random.PRNGKey(0), j_opt.OptConfig(),
                               compress=compress)
    params = shard_tree(_bridge(js.params, tm), tm.params_pspecs(), ctx)
    ts = TrainState(params=params, opt=init_adam_state(params, OptConfig()),
                    ef=(grad_compress.init_ef_state(params) if compress
                        else None))
    jstep = jax.jit(j_ts.build_train_step(jm, j_opt.OptConfig(),
                                          compress=compress))
    tstep = build_train_step(tm, OptConfig(), compress=compress)
    jpipe = JPipeline(JDataConfig(kind="bigram"), jcfg,
                      ShapeConfig("t", "train", 16, 4))
    tpipe = SyntheticPipeline(DataConfig(kind="bigram"), tcfg,
                              TShape("t", "train", 16, 4), device="cpu")
    for i in range(2):
        js, jm_ = jstep(js, jpipe.get_batch(i))
        ts, tm_ = tstep(ts, tpipe.get_batch(i))
        assert set(tm_) == set(jm_)
        for k in jm_:
            assert abs(float(tm_[k]) - float(jm_[k])) <= \
                1e-5 * max(abs(float(jm_[k])), 1e-6), (k, tm_, jm_)
    if not compress:
        for a, b in zip(jax_leaves(gather_tree(ts.params)),
                        jax.tree.leaves(js.params)):
            assert _rel(a.numpy(), b) < 1e-5
    else:
        # the buffers keep their parameters' layout (train_state_pspecs)
        assert train_state_pspecs(tm, compress=True).ef is not None
        for e, p in zip(jax_leaves(ts.ef), jax_leaves(ts.params)):
            assert isinstance(e, Sharded) and e.spec == p.spec


def test_compression_over_a_mesh_takes_the_global_scale():
    """``apply_ef_compression`` on a gradient tree laid out over (2, 2) by
    the rules equals JAX's on the whole tree, bit for bit, 3 rounds with
    error feedback: each leaf's scale is the ``pmax`` of the positions'
    maxima over the axes its layout splits, the global one."""
    _, tcfg = _configs("qwen3-4b")
    ctx = make_ctx(_mesh("2x2"))
    tm = Model(tcfg, ctx)
    rng = np.random.default_rng(2)
    full = tree_map(lambda t: torch.from_numpy(rng.standard_normal(
        tuple(t.shape)).astype(np.float32) * rng.uniform(0.01, 3.0)),
        tm.abstract_params())
    g = shard_tree(tree_map(torch.clone, full), tm.params_pspecs(), ctx)
    ef = grad_compress.init_ef_state(g, "float32")
    jg = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), full))
    jef = j_gc.init_ef_state(jg, "float32")
    for _ in range(3):
        c, ef = grad_compress.apply_ef_compression(g, ef)
        jc, jef = j_gc.apply_ef_compression(jg, jef)
        for a, b in zip(jax_leaves(gather_tree(c)) +
                        jax_leaves(gather_tree(ef)),
                        jax.tree.leaves(jc) + jax.tree.leaves(jef)):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_compressed_psum_matches_jax_and_its_error_feedback_converges():
    """The collective form over 4 positions: each step's reduced value and
    error-feedback buffers against JAX's ``compressed_psum`` under
    ``vmap`` with a named axis, and over 20 steps the compressed sums
    plus the summed residuals equal the exact sums."""
    mesh = make_mesh_for_devices(1, 4, devices=["cpu"])
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((4, 512)).astype(np.float32) * np.array(
        [[1.0], [0.5], [2.0], [0.1]], np.float32)
    jfn = jax.vmap(j_gc.compressed_psum, in_axes=(0, None, 0),
                   axis_name="i")
    ef = Sharded([torch.zeros(512) for _ in range(4)], mesh)
    jef = jnp.zeros((4, 512), jnp.float32)
    total_c = np.zeros(512, np.float32)
    total_t = np.zeros(512, np.float32)
    for i in range(20):
        g = xs * (1 + 0.1 * i)
        red, ef = grad_compress.compressed_psum(
            Sharded([torch.from_numpy(r.copy()) for r in g], mesh), "model",
            ef)
        jred, jef = jfn(jnp.asarray(g), "i", jef)
        for r in range(4):
            assert torch.equal(red.shards[r], red.shards[0])
            np.testing.assert_allclose(red.shards[r].numpy(),
                                       np.asarray(jred[r]), rtol=0,
                                       atol=1e-6 * np.abs(g).sum(0).max())
            np.testing.assert_allclose(ef.shards[r].numpy(),
                                       np.asarray(jef[r]), rtol=0,
                                       atol=1e-6 * np.abs(g).max())
        total_c += red.shards[0].numpy()
        total_t += g.sum(0)
    resid = sum(e.numpy() for e in ef.shards)
    np.testing.assert_allclose(total_c + resid, total_t, rtol=1e-4,
                               atol=1e-4)


COLLECTIVES = ["psum", "pmean", "all_gather", "psum_scatter"]


@pytest.mark.parametrize("axes", [("model",), ("data",), ("data", "model")],
                         ids="+".join)
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_backward_is_its_dual(name, axes):
    """Through autograd, each collective's operand gradient is its dual
    applied to the cotangents (float32 in position order, rounded once):
    psum's and pmean's their psum (pmean's over the group size),
    all_gather's their psum_scatter, psum_scatter's their all_gather;
    the copies of a replicated gradient are bitwise equal, and the
    backward records its bytes under the dual's op name."""
    mesh = make_mesh_for_devices(2, 4, devices=["cpu"])
    rng = np.random.default_rng(1)
    x = Sharded([torch.from_numpy(rng.standard_normal((8, 6)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
        for _ in range(mesh.size)], mesh)
    fwd = {"psum": lambda t: C.psum(t, axes),
           "pmean": lambda t: C.pmean(t, axes),
           "all_gather": lambda t: C.all_gather(t, axes, dim=0),
           "psum_scatter": lambda t: C.psum_scatter(t, axes, dim=0)}[name]
    y = fwd(x)
    ct = Sharded([torch.from_numpy(rng.standard_normal(tuple(s.shape)).astype(
        np.float32)).to(torch.bfloat16) for s in y.shards], mesh)
    with C.recording() as log:
        torch.autograd.backward(y.shards, ct.shards)
    dual = {"psum": lambda t: C.psum(t, axes),
            "pmean": lambda t: C.pmean(t, axes),
            "all_gather": lambda t: C.psum_scatter(t, axes, dim=0),
            "psum_scatter": lambda t: C.all_gather(t, axes, dim=0)}[name]
    want = dual(ct)
    for r in range(mesh.size):
        assert torch.equal(x.shards[r].grad, want.shards[r]), (name, r)
    for g in mesh.groups(axes):
        if name in ("psum", "pmean"):
            assert all(torch.equal(x.shards[g[0]].grad, x.shards[r].grad)
                       for r in g)
    op = {"psum": "all-reduce", "pmean": "all-reduce",
          "all_gather": "reduce-scatter", "psum_scatter": "all-gather"}[name]
    assert set(log) == {op}


def test_a_cotangent_read_at_one_position_reaches_every_operand_once():
    """The train step's rule: a replicated loss read (and differentiated)
    at position 0 alone gives each position's operand the gradient of
    the logical sum, once."""
    mesh = make_mesh_for_devices(2, 2, devices=["cpu"])
    x = Sharded([torch.full((3,), float(r + 1), requires_grad=True)
                 for r in range(mesh.size)], mesh)
    total = C.psum((x * x).sum(), ("data", "model"))
    first(total).backward()
    for r in range(mesh.size):
        assert torch.equal(x.shards[r].grad, 2 * x.shards[r].detach())


def test_multidevice_lifecycle_over_cpu_positions(monkeypatch):
    """The twin of ``test_system.py::test_multidevice_lifecycle``: a train
    cell over 2 columns of a 2 x 4 grid of CPU positions trains, resizes
    to 3 columns (a (2, 3) mesh the heads do not divide) with its state
    bit for bit, trains, gives a column to a serve cell, trains,
    checkpoints, loses a column and recovers (degraded) at step 4 from
    the checkpoint, laid out over its new mesh leaf by leaf as it is read
    (one whole leaf on the host at a time; position 0 holds only its
    shard of each split float32 moment), and trains on."""
    laid = []          # (the whole host leaf, weakly; its shard at 0)

    def spy(t, spec, mesh):
        assert all(w() is None for w, _ in laid), \
            "two whole checkpoint leaves alive at once"
        out = shard_leaf(t, spec, mesh)
        laid.append((weakref.ref(t), out.shards[0]))
        return out
    monkeypatch.setattr(ckpt, "shard_leaf", spy)
    grid = DeviceGrid.from_flat(["cpu"] * 8, 1, 2, 4)
    sup = Supervisor(grid)
    cfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(
        num_layers=2, d_model=64, d_ff=128, num_heads=2, num_kv_heads=2,
        head_dim=32, vocab=256)
    cell = sup.create_cell("tr", cfg, "train", ncols=2, opt_cfg=OptConfig())
    assert cell.mesh.shape == {"data": 2, "model": 2} and cell.model.sharded
    pipe = SyntheticPipeline(DataConfig(kind="bigram", vocab=128), cfg,
                             TShape("t", "train", 16, 16), device="cpu")
    out = {}
    m = cell.train_steps(pipe.get_batch, 2)
    out["xent0"] = m["xent"]
    prog = cell.accounting.programs["train_step"]
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(
        prog.collective_per_device)
    before = [t.clone() for t in jax_leaves(gather_tree(cell.state))]
    sup.resize_cell("tr", 3)
    assert cell.mesh.shape == {"data": 2, "model": 3}
    after = jax_leaves(gather_tree(cell.state))
    out["resize_exact"] = all(torch.equal(a, b)
                              for a, b in zip(before, after))
    m = cell.train_steps(pipe.get_batch, 1)
    srv = sup.create_cell("srv", cfg, "serve", ncols=1)
    srv.init_serve()
    sup.transfer_columns("tr", "srv", 1)
    out["tr_cols"] = sup.cells["tr"].zone.ncols
    out["srv_cols"] = sup.cells["srv"].zone.ncols
    m = cell.train_steps(pipe.get_batch, 1)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, cell.step, cell.state)
        saved = [t.clone() for t in jax_leaves(gather_tree(cell.state))]
        out["affected"] = sup.fail_column(0, sup.cells["tr"].zone.c0)
        rec = sup.recover_cell("tr", ckpt_dir=d)
        out["recovered_step"] = rec.step
        assert rec.model.sharded
        assert all(isinstance(t, Sharded)
                   for t in jax_leaves(rec.state.params))
        restored = jax_leaves(gather_tree(rec.state))
        assert all(torch.equal(a, b) for a, b in zip(saved, restored))
        assert len(laid) == len(restored)
        moments = jax_leaves(rec.state.opt.m) + jax_leaves(rec.state.opt.v)
        split = [t for t in moments
                 if t.shards[0].numel() < math.prod(t.global_shape)]
        assert split and all(t.dtype == torch.float32 for t in moments)
        at0 = {id(s) for _, s in laid}
        assert all(id(t.shards[0]) in at0 for t in moments)
        m = rec.train_steps(pipe.get_batch, 1)
        out["xent_after_recovery"] = m["xent"]
    out["events"] = [e["op"] for e in sup.events]
    assert out["resize_exact"], "resize must preserve state bit-exactly"
    assert out["tr_cols"] == 2 and out["srv_cols"] == 2
    assert out["affected"] == ["tr"]
    assert out["recovered_step"] == 4
    assert out["xent_after_recovery"] > 0
    assert "recover" in out["events"]
