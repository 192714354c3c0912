"""ZeRO-3, the chunked head and the dry run: twins of
``tests/test_layouts.py``'s ZeRO-3 tests and of
``tests/test_system.py::test_reduced_multipod_dryrun`` (CPU).

* The ZeRO-3 rules (``dp_over_model``) equal JAX's; a one-device model
  under them gives the TP model's loss; its sequence-chunked head
  (``Model._chunked_xent``, 1024 tokens a row or more) the monolithic
  head's, and JAX's chunked loss to 1e-5.
* ZeRO-3 over (data 2, model 2) of CPU positions: every layer
  data-parallel over all four positions, the vocab head whole on each;
  the loss and the params after 2 train steps against JAX's one-device
  step (1e-5), and the chunked head over the mesh against JAX's.
* The dry run on ``meta`` (``launch/dryrun.py``): a mixtral smoke train
  step over (pod 2, data 2, model 2) reports 8 positions with
  collectives present, FLOPs, argument bytes and no temp bytes; a
  prefill and a decode trace too; the ZeRO-3 rule picks the layout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

from repro.configs.base import ShapeConfig, smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticPipeline as JPipeline  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.sharding.rules import ShardCtx as JShardCtx  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.launch.dryrun import lower_cell, run_cell  # noqa: E402
from repro_torch.launch.mesh import make_mesh_for_devices  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    gather_tree,
    jax_leaves,
    params_from_numpy,
    shard_tree,
)
from repro_torch.sharding.rules import ShardCtx, make_ctx  # noqa: E402
from repro_torch.sharding.rules import single_device_ctx as t_ctx1  # noqa: E402
from repro_torch.sharding.sharded import first  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_adam_state  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainState,
    build_train_step,
)


def _bridge(jp, model):
    return params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                          jp), dtype=model.dtype, device="cpu",
                             specs=model.param_specs())


def _z3(ctx):
    return ShardCtx(mesh=ctx.mesh, batch_axes=("data",), model_axis="model",
                    dp_over_model=True)


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_opt_level_roundtrip():
    """qwen3-4b trains ZeRO-3 at the optimized level and TP at the
    baseline, as JAX's configs say."""
    from repro_torch.configs.base import with_opt_level
    a = t_get_arch("qwen3-4b")
    assert a.train_layout == "zero3"
    base = with_opt_level(a, False)
    assert (base.train_layout == "tp" and not base.sharded_decode
            and base.serve_fsdp)
    opt = with_opt_level(a, True)
    assert opt.sharded_decode and opt.train_layout == "zero3"


def test_zero3_rules_single_device():
    z = _z3(t_ctx1())
    r = z.rules()
    assert r["heads"] == () and r["ffn"] == ()
    assert "model" in r["batch"]
    assert r["vocab"] == ("model",)
    assert z.dp_size() == 1
    jz = JShardCtx(mesh=single_device_ctx().mesh, batch_axes=("data",),
                   model_axis="model", dp_over_model=True)
    assert {k: tuple(v) for k, v in r.items()} == {
        k: tuple(v) for k, v in jz.rules().items()}


def test_zero3_loss_matches_tp_single_device():
    """Layouts are semantics-preserving: the ZeRO-3 model's loss on one
    device is the TP model's, and JAX's."""
    jcfg = smoke_config(get_arch("qwen3-4b")).replace(train_layout="tp")
    tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(train_layout="tp")
    jp = j_build_model(jcfg, single_device_ctx()).init(jax.random.PRNGKey(0))
    tp_model, z3_model = Model(tcfg), Model(tcfg, _z3(t_ctx1()))
    params = _bridge(jp, tp_model)
    batch = _batch(tcfg, 2, 32)
    l1 = float(tp_model.loss(params, _t(batch))[0])
    l2 = float(z3_model.loss(params, _t(batch))[0])
    jl = float(j_build_model(jcfg, single_device_ctx()).loss(jp, batch)[0])
    assert abs(l1 - l2) < 1e-3, (l1, l2)
    assert abs(l2 - jl) < 1e-3, (l2, jl)


def test_chunked_xent_matches_full():
    """The seq-chunked remat'd head equals the monolithic head, and JAX's
    chunked loss (float32, 1e-5)."""
    jcfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
    tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32")
    jctx = single_device_ctx()
    jz3 = JShardCtx(mesh=jctx.mesh, batch_axes=("data",), model_axis="model",
                    dp_over_model=True)
    jm = j_build_model(jcfg, jz3)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(tcfg, 1, 2048)
    jl = float(jax.jit(jm.loss)(jp, batch)[0])
    model = Model(tcfg, _z3(t_ctx1()))
    params = _bridge(jp, model)
    l_chunked = model.loss(params, _t(batch))[0]
    l_full = Model(tcfg).loss(params, _t(batch))[0]
    assert abs(float(l_chunked) - float(l_full)) < 1e-3
    assert abs(float(l_chunked) - jl) <= 1e-5 * abs(jl), (float(l_chunked), jl)
    # the chunked head is differentiable through its recompute
    leaves = {k: v for k, v in params.items()}
    leaves["embed"] = params["embed"].clone().requires_grad_()
    model.loss(leaves, _t(batch))[0].backward()
    assert torch.isfinite(leaves["embed"].grad).all()


@pytest.mark.parametrize("S", [16, 1024], ids=["full_head", "chunked_head"])
def test_zero3_over_a_mesh_matches_jax(S):
    """ZeRO-3 over (2, 2): the batch over all four positions, the weights
    FSDP over ``data`` and gathered whole, the head whole on every
    position (chunked at S 1024); the loss against JAX's one-device loss,
    and (at S 16) the params after 2 train steps."""
    jcfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32")
    tcfg = t_smoke_config(t_get_arch("qwen3-4b")).replace(dtype="float32")
    jm = j_build_model(jcfg, single_device_ctx())
    jp = jm.init(jax.random.PRNGKey(0))
    ctx = make_ctx(make_mesh_for_devices(2, 2, devices=["cpu"]),
                   dp_over_model=True)
    model = Model(tcfg, ctx)
    assert model._lctx.model_axis is None and model._vocab_axis() is None
    params = shard_tree(_bridge(jp, model), model.params_pspecs(), ctx)
    batch = _batch(tcfg, 4, S)
    loss = float(first(model.loss(params, _t(batch))[0]))
    jl = float(jax.jit(jm.loss)(jp, batch)[0])
    assert abs(loss - jl) <= 1e-5 * abs(jl), (loss, jl)
    if S > 16:
        return
    js = j_ts.init_train_state(jm, jax.random.PRNGKey(0), j_opt.OptConfig())
    jstep = jax.jit(j_ts.build_train_step(jm, j_opt.OptConfig()))
    ts = TrainState(params=params, opt=init_adam_state(params, OptConfig()))
    step = build_train_step(model, OptConfig())
    jpipe = JPipeline(JDataConfig(kind="bigram"), jcfg,
                      ShapeConfig("t", "train", 16, 4))
    tpipe = SyntheticPipeline(DataConfig(kind="bigram"), tcfg,
                              TShape("t", "train", 16, 4), device="cpu")
    for i in range(2):
        js, jmet = jstep(js, jpipe.get_batch(i))
        ts, tmet = step(ts, tpipe.get_batch(i))
        a, b = float(tmet["loss_step"]), float(jmet["loss_step"])
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    for a, b in zip(jax_leaves(gather_tree(ts.params)),
                    jax.tree.leaves(js.params)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_reduced_multipod_dryrun():
    """The dry-run machinery on a 2 x 2 x 2 'multi-pod' mesh of ``meta``
    positions: a MoE train step traced, collectives present across the
    pod axis."""
    mesh = make_mesh_for_devices(2, 2, pods=2, devices=["meta"])
    arch = t_smoke_config(t_get_arch("mixtral-8x7b")).replace(microbatch=1)
    shape = TShape("t", "train", 64, 8)
    rec = run_cell(arch, shape, mesh, "reduced", verbose=False)
    assert rec["devices"] == 8
    colls = rec["collective_bytes_per_device"]
    assert sum(colls.values()) > 0, rec
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(colls)
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] is None
    assert not rec["dp_over_model"]          # mixtral trains "tp"


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dryrun_traces_serving_steps(kind):
    mesh = make_mesh_for_devices(2, 2, devices=["meta"])
    arch = t_smoke_config(t_get_arch("qwen3-4b"))
    rec = run_cell(arch, TShape("t", kind, 64, 4), mesh, "reduced",
                   verbose=False)
    assert rec["devices"] == 4 and rec["kind"] == kind
    assert rec["flops_per_device"] > 0
    assert sum(rec["collective_bytes_per_device"].values()) > 0


def test_dryrun_takes_zero3_by_jax_rule():
    """qwen3-4b trains ZeRO-3 when the positions divide the global batch
    (JAX's ``zero3_ok``), and TP with FSDP otherwise."""
    mesh = make_mesh_for_devices(2, 2, devices=["meta"])
    arch = t_smoke_config(t_get_arch("qwen3-4b"))
    assert arch.train_layout == "zero3"
    model, _, _ = lower_cell(arch, TShape("t", "train", 64, 8), mesh)
    assert model.ctx.dp_over_model
    model, _, _ = lower_cell(arch, TShape("t", "train", 64, 6), mesh)
    assert not model.ctx.dp_over_model
