"""Training over a mesh, deepseek-moe-16b and mamba2-2.7b: the port's train step over CPU
positions against JAX's one-device step (CPU, float32), with the checks
and tolerances of ``test_torch_train_mesh.py`` (its helpers): loss to
1e-5, every gathered gradient leaf to 1e-4 with its copies bitwise
equal, the params after 3 steps to 1e-5, over (data 1, model 2), (2, 2)
and (pod 2, data 1, model 2).  The MoE runs dropless
(``capacity_factor`` 8) under EP over (1, 2) and (2, 2), each position
its experts' grouped GEMMs and their backward; mamba2 runs its SSD scan
and its backward over half of the SSD heads a position.
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

FAMILIES = ["deepseek-moe-16b", "mamba2-2.7b"]


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
