"""The port's twins of ``examples/`` (``repro_torch.examples``), each run
in-process at reduced steps or requests on ``--device cpu``.

Each test checks its example's own claims: every request served and none
lost, the autoscale to 3 decode replicas and the recovery from the
checkpoint (``serve_disagg``); training over the grown mesh and a weight
sync onto the serving cell's layout that serves (``quickstart``); every
request served while the elastic loop moves columns (``colocate_elastic``);
the loss falling and the restored run replaying the lost steps bit for
bit (``train_100m``).  Where the control plane is deterministic (plan
summaries, event verbs, zones) it is held against the JAX package's same
spec applied on a one-device grid cycled in-process.  Without ``--device
cpu`` and without a GPU each twin raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)   # tiny tensors; leave the cores to the other test workers

import repro.core as J  # noqa: E402
from repro.configs.base import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    colocate_elastic,
    quickstart,
    serve_disagg,
    train_100m,
)

TWINS = {"serve_disagg": serve_disagg, "quickstart": quickstart,
         "colocate_elastic": colocate_elastic, "train_100m": train_100m}


def _jax_sup():
    """The examples' 2 x 4 grid, cycled from one JAX device."""
    return J.Supervisor(J.DeviceGrid.from_flat(jax.devices()[:1], 1, 2, 4,
                                               allow_reuse=True))


def _zones(sup) -> dict:
    return {n: (tuple(c.zone.pods), c.zone.c0, c.zone.c1)
            for n, c in sup.cells.items()}


def _strip(zones) -> dict:
    return {n: (tuple(p), c0, c1) for n, (p, c0, c1, _) in zones.items()}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_each_twin_needs_a_gpu_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the twin would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TWINS[name].main([])


def test_serve_disagg_autoscales_and_recovers():
    out = serve_disagg.main(["--device", "cpu", "--max-new", "4"])
    assert out["submitted"] == 18 and out["served"] == 18
    assert out["lost"] == []
    assert "grow_replicas" in out["actions"]
    assert any(cell == "decode/1" for cell, _ in out["restored"])
    assert out["affected"] == ["decode/1"] and out["requeued"] >= 1
    assert out["kv_transfers"] >= 18 and out["kv_bytes"] > 0
    assert out["cells_after_teardown"] == []
    # every cell over the grid's two data rows, one column wide
    assert all(shape == {"data": 2, "model": 1}
               for *_, shape in out["zones"].values())
    # the JAX package's control plane applies the same spec alike
    arch = j_smoke_config(j_get_arch("qwen3-4b"))
    spec = J.ClusterSpec(
        cells=(J.CellSpec("prefill", arch, "serve", ncols=1),
               J.CellSpec("decode", arch, "serve", ncols=1, replicas=2,
                          min_replicas=2, max_replicas=3,
                          slo=J.SLOTarget(tpot_p99=0.25))),
        channels=(J.ChannelSpec("prefill", "decode", kind="kv"),))
    sup = _jax_sup()
    plan = sup.apply(spec)
    assert out["plan"] == plan.summary()
    assert _strip(out["zones"]) == _zones(sup)
    assert sup.apply(J.ClusterSpec()).summary() and not sup.cells


def test_quickstart_trains_grows_syncs_and_serves():
    out = quickstart.main(["--device", "cpu", "--steps", "4",
                           "--more-steps", "2", "--max-new", "6"])
    assert len(out["tokens"]) == 6 and out["converged"]
    assert all(np.isfinite(out["xents"]))
    assert out["sync_bytes"] > 0 and out["grow_bytes"] > out["sync_bytes"]
    assert out["zones"]["trainer"][3] == {"data": 2, "model": 3}
    assert out["zones"]["server"][3] == {"data": 2, "model": 1}
    assert out["cells"] == []
    # the JAX package's control plane: the same three applies
    arch = j_smoke_config(j_get_arch("qwen3-4b"))
    spec = J.ClusterSpec(cells=(
        J.CellSpec("trainer", arch, "train", ncols=2, min_ncols=1,
                   max_ncols=3, opt_cfg=JOptConfig(lr=1e-3)),))
    sup = _jax_sup()
    plans = [sup.apply(spec).summary()]
    spec = spec.scale("trainer", 3)
    plans.append(sup.apply(spec).summary())
    spec = spec.with_cell(J.CellSpec("server", arch, "serve", ncols=1)) \
               .with_channel(J.ChannelSpec("trainer", "server"))
    plans.append(sup.apply(spec).summary())
    assert sup.reconcile().empty
    assert out["plans"] == plans
    assert _strip(out["zones"]) == _zones(sup)
    assert out["events"] == [e["op"] for e in sup.events]
    sup.apply(J.ClusterSpec())
    assert sup.table.epoch == out["epoch"]


def test_colocate_elastic_serves_every_request_while_columns_move():
    out = colocate_elastic.main(["--device", "cpu", "--ticks", "2",
                                 "--burst", "8"])
    assert out["served"] == out["submitted"] > 0
    assert out["trainer_step"] == 6 and out["converged"]
    assert all(s + b == 4 and 1 <= s <= 3 for s, b in out["widths"])
    assert out["zones"]["server"][3] == {"data": 2, "model": 1}
    assert out["zones"]["batch"][3] == {"data": 2, "model": 3}
    arch = j_smoke_config(j_get_arch("qwen3-4b"))
    sup = _jax_sup()
    plan = sup.apply(J.ClusterSpec(cells=(
        J.CellSpec("server", arch, "serve", ncols=1, min_ncols=1,
                   max_ncols=3),
        J.CellSpec("batch", arch, "train", ncols=3, min_ncols=1,
                   opt_cfg=JOptConfig(lr=1e-3)))))
    assert out["plans"][0] == plan.summary()
    assert _strip(out["zones"]) == _zones(sup)


def test_train_100m_loss_falls_and_the_restore_replays(tmp_path):
    out = train_100m.main(["--device", "cpu", "--layers", "1", "--steps",
                           "12", "--chunk", "2", "--ckpt-every", "4",
                           "--warmup", "1", "--ckpt-dir",
                           str(tmp_path / "ckpt")])
    xents = out["xents"]
    assert out["step"] == 12 and out["restored_at"] == 4
    # chunks: steps 2, 4, 6 | restored at 4 | 6, 8, 10, 12: the replayed
    # chunk is bitwise the lost one
    assert len(xents) == 7 and xents[3] == xents[2]
    assert xents[-1] < xents[0] and all(np.isfinite(xents))
    assert out["floor"] < xents[-1]
