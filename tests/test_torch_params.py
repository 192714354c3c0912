"""The port's parameter plane against JAX, and its import boundary.

* the weight bridge turns ``Model.init(PRNGKey(0))`` of every registered
  config at smoke size into tensors with the same keys, shapes and values;
* the port's full-width qwen3-4b specs have JAX's shapes (meta tensors,
  no allocation);
* nothing under ``src/repro_torch`` or ``chip_smoke.py`` imports jax or
  the JAX package.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import jax  # noqa: E402

from repro.configs.base import smoke_config  # noqa: E402
from repro.configs.registry import ARCHS, get_arch  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.sharding.rules import single_device_ctx  # noqa: E402
from repro_torch.configs.registry import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _flat(tree, prefix=()):
    """{path: leaf} over nested dicts / sequences."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_from_numpy_matches_jax_init(arch):
    model = build_model(smoke_config(get_arch(arch)), single_device_ctx())
    jp = jax.jit(model.init)(jax.random.PRNGKey(0))   # one compile, not per op
    tp = params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        dtype=torch.float32, device="cpu")
    jf, tf = _flat(jp), _flat(tp)
    assert sorted(jf, key=str) == sorted(tf, key=str)
    for path, j in jf.items():
        t = tf[path]
        assert tuple(t.shape) == tuple(j.shape), path
        assert np.array_equal(t.numpy(), np.asarray(j, np.float32)), path


def test_configs_are_the_same():
    assert sorted(T_ARCHS) == sorted(ARCHS)
    for name in ARCHS:
        j, t = get_arch(name), t_get_arch(name)
        assert repr(j).replace("repro.configs", "") == \
            repr(t).replace("repro_torch.configs", "")


def test_full_width_specs_match_jax_shapes():
    """qwen3-4b at full width: the port's meta tensors have the shapes and
    dtypes of JAX's abstract params, and nothing is allocated."""
    jm = build_model(get_arch("qwen3-4b"), single_device_ctx())
    tm = Model(t_get_arch("qwen3-4b"))
    jf = _flat(jm.abstract_params())
    tf = _flat(tm.abstract_params())
    assert sorted(jf, key=str) == sorted(tf, key=str)
    for path, j in jf.items():
        t = tf[path]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    assert tm.n_params() == jm.n_params()
    assert tf[("embed",)].shape == (153600, 2560)


def test_moe_full_width_specs_match_jax_shapes():
    """deepseek-moe-16b at full width: one dense layer then 27 MoE layers
    of 64 routed experts (1408 wide) and 2 shared ones, the JAX shapes and
    dtypes (the router float32), 16.4 B parameters."""
    jm = build_model(get_arch("deepseek-moe-16b"), single_device_ctx())
    tm = Model(t_get_arch("deepseek-moe-16b"))
    jf = _flat(jm.abstract_params())
    tf = _flat(tm.abstract_params())
    assert sorted(jf, key=str) == sorted(tf, key=str)
    for path, j in jf.items():
        assert tuple(tf[path].shape) == tuple(j.shape), path
        assert str(tf[path].dtype).split(".")[-1] == str(j.dtype), path
    assert tm.n_params() == jm.n_params()
    assert 16.3e9 < tm.n_params() < 16.5e9
    assert tf[("moe_layers", "moe", "w_gate")].shape == (27, 64, 2048, 1408)
    assert tf[("dense_layers", "mlp", "w_up")].shape == (1, 2048, 10944)
    assert tf[("moe_layers", "moe", "router")].dtype == torch.float32


def test_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    model = Model(t_get_arch("qwen3-4b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator())


def _imports(path: pathlib.Path):
    """(module, line) of every import and every ``jax.`` attribute use."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, node.lineno
        elif (isinstance(node, ast.Attribute)
              and isinstance(node.value, ast.Name)
              and node.value.id in ("jax", "jnp")):
            yield "jax", node.lineno


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for mod, line in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}:{line} {mod}")
    assert not bad, bad
