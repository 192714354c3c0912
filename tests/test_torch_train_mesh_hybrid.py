"""Training over a mesh, zamba2-2.7b and seamless-m4t-large-v2: the port's train step over CPU
positions against JAX's one-device step (CPU, float32), with the checks
and tolerances of ``test_torch_train_mesh.py`` (its helpers): loss to
1e-5, every gathered gradient leaf to 1e-4 with its copies bitwise
equal, the params after 3 steps to 1e-5, over (data 1, model 2), (2, 2)
and (pod 2, data 1, model 2).  zamba2's groups of Mamba
layers and its shared attention block run over heads, and so do
seamless's encoder and decoder layers (self-attention, cross-attention
from the encoder's memory, the MLPs).
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_train_mesh import (  # noqa: E402
    MESHES,
    _check_grads,
    _check_loss,
    _check_steps,
)

FAMILIES = ["zamba2-2.7b", "seamless-m4t-large-v2"]


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
