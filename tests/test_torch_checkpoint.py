"""The port's checkpoints (CPU): twins of ``tests/test_checkpoint.py``,
and checkpoints across the two packages.

The port writes JAX's layout (``step_<N>/leaf_<i>.npy``, ``meta.json``,
bfloat16 as a u2 view, leaves in JAX's flatten order), so a TrainState
that JAX's ``checkpoint.save`` wrote restores in the port with equal
leaves, and the reverse.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as j_ckpt  # noqa: E402
from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import get_arch  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import smoke_config as t_smoke_config  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import jax_leaves, tree_map  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_adam_state  # noqa: E402
from repro_torch.train.train_step import TrainState, init_train_state  # noqa: E402


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
              "d": torch.tensor(7, dtype=torch.int32)},
    }


def _meta_like(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def test_roundtrip_exact(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = ckpt.restore(str(tmp_path), 3, _meta_like(t))
    for a, b in zip(jax_leaves(t), jax_leaves(out)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)


def test_async_save(tmp_path):
    fut = ckpt.save(str(tmp_path), 1, _tree(), blocking=False)
    fut.result(timeout=30)
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_latest_step_ignores_partial(tmp_path):
    ckpt.save(str(tmp_path), 5, _tree())
    os.makedirs(tmp_path / "step_9", exist_ok=True)   # no meta.json: partial
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_leaf_count_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree())
    bad_target = {"only": torch.empty((3, 4), device="meta")}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 2, bad_target)


def test_multiple_steps_and_overwrite(tmp_path):
    for s in (10, 20, 30):
        ckpt.save(str(tmp_path), s, _tree())
    assert ckpt.latest_step(str(tmp_path)) == 30
    ckpt.save(str(tmp_path), 30, _tree())   # overwrite OK (atomic replace)
    assert ckpt.latest_step(str(tmp_path)) == 30


def test_layout_is_jax_layout(tmp_path):
    """Files, meta and the bf16 view as JAX writes them, leaf for leaf."""
    jt = {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
          "b": {"c": jnp.ones((5,), jnp.bfloat16) * 1.5,
                "d": jnp.array(7, jnp.int32)}}
    j_ckpt.save(str(tmp_path / "j"), 1, jt)
    ckpt.save(str(tmp_path / "t"), 1, _tree())
    import json
    metas = [json.load(open(tmp_path / s / "step_1" / "meta.json"))["leaves"]
             for s in ("j", "t")]
    assert metas[0] == metas[1]
    for i in range(3):
        a, b = (np.load(tmp_path / s / "step_1" / f"leaf_{i}.npy")
                for s in ("j", "t"))
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _jax_state(compress=False):
    cfg = smoke_config(get_arch("qwen3-4b"))
    model = build_model(cfg, single_device_ctx())
    return model, j_ts.init_train_state(model, jax.random.PRNGKey(0),
                                        j_opt.OptConfig(), compress=compress)


def test_jax_train_state_restores_in_the_port(tmp_path):
    jm, js = _jax_state()
    # one moment made nonzero, and a step count, so that order shows
    js = js._replace(opt=js.opt._replace(
        step=jnp.int32(5),
        m=jax.tree.map(lambda x: x + 0.25, js.opt.m)))
    j_ckpt.save(str(tmp_path), 5, js)
    model = Model(t_smoke_config(t_get_arch("qwen3-4b")))
    params = model.abstract_params()
    target = TrainState(params=params, opt=init_adam_state(params,
                                                           OptConfig()))
    got = ckpt.restore(str(tmp_path), ckpt.latest_step(str(tmp_path)),
                       target)
    jl, tl = jax.tree.leaves(js), jax_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert str(b.dtype).replace("torch.", "") == str(a.dtype)
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert int(got.opt.step) == 5


def test_port_train_state_restores_in_jax(tmp_path):
    model = Model(t_smoke_config(t_get_arch("qwen3-4b")))
    ts = init_train_state(model, torch.Generator().manual_seed(3),
                          OptConfig(), compress=True)
    ts.opt.m["embed"].add_(0.5)
    ts = ts._replace(opt=ts.opt._replace(step=torch.tensor(4,
                                                          dtype=torch.int32)))
    ckpt.save(str(tmp_path), 4, ts, blocking=False).result(timeout=60)
    jm, js = _jax_state(compress=True)
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js)
    got = j_ckpt.restore(str(tmp_path), j_ckpt.latest_step(str(tmp_path)),
                         target)
    jl, tl = jax.tree.leaves(got), jax_leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert int(got.opt.step) == 4
