"""Co-located serving + training under the declarative elastic loop.

The twin of ``examples/colocate_elastic.py``.  The paper's headline
scenario (Figs 10/11): a latency-critical serving cell shares a machine
with a batch training cell.  Desired state is a ClusterSpec — server
bounded to [1, 3] columns, trainer taking the rest — and a
:class:`ReconcilePolicy` closes the loop: the serving cell's batcher
records per-request TTFT into its ``CellAccounting``, the policy pulls
those live samples, and on a threshold crossing it rewrites the spec's
desired ``ncols`` and re-applies it.  The reconciler turns every +1/-1
into a real column transfer with live resharding on both cells — this
file never touches a resize/transfer primitive.

The grid is the example's, two rows of four columns, each entry a mesh
position on ``--device``: the server serves over (data 2, model 1..3)
and the trainer trains over the rest of the columns.

Run:  PYTHONPATH=src python -m repro_torch.examples.colocate_elastic
      [--device cpu] [--ticks 4 --burst 14]
"""
import argparse
import dataclasses
import itertools

import numpy as np

from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.core import (
    CellSpec,
    ClusterSpec,
    DeviceGrid,
    ElasticPolicy,
    ReconcilePolicy,
    SLOTarget,
    Supervisor,
)
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.serve.batcher import Request
from repro_torch.train.optimizer import OptConfig

MAX_LEN, SLOTS, PROMPT_LEN, MAX_NEW = 48, 4, 12, 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ticks", type=int, default=4,
                    help="serve + train ticks a phase")
    ap.add_argument("--burst", type=int, default=14,
                    help="requests a tick of the burst phase")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    grid = DeviceGrid.from_flat([device] * 8, pods=1, rows=2, cols=4)
    sup = Supervisor(grid)
    arch = smoke_config(get_arch("qwen3-4b"))

    # -- desired state: bounded serving cell + batch trainer on the rest
    spec = ClusterSpec(cells=(
        CellSpec("server", arch, "serve", ncols=1, min_ncols=1, max_ncols=3),
        CellSpec("batch", arch, "train", ncols=3, min_ncols=1,
                 opt_cfg=OptConfig(lr=1e-3)),
    ))
    plan = sup.apply(spec)
    plans = [plan.summary()]
    zones = {n: (c.zone.pods, c.zone.c0, c.zone.c1, c.mesh.shape)
             for n, c in sup.cells.items()}
    server, trainer = sup.cells["server"], sup.cells["batch"]
    server.init_serve()
    pipe = SyntheticPipeline(DataConfig(kind="bigram", vocab=256), arch,
                             ShapeConfig("t", "train", 32, 24), device=device)

    # the batcher is rebuilt after any topology change (a resize rebinds
    # the cell's model and weights: fresh step graphs, a cost the elastic
    # loop pays)
    state = {"epoch": None, "bat": None}

    def batcher():
        if state["epoch"] != server.zone_epoch:
            state["epoch"] = server.zone_epoch
            state["bat"] = server.make_batcher(batch_slots=SLOTS,
                                               max_len=MAX_LEN)
        return state["bat"]

    rng = np.random.default_rng(0)
    rid = itertools.count()

    def serve_tick(load: int):
        """Submit `load` requests and drain them; TTFT/TPOT land in the
        server cell's CellAccounting (what the policy reads)."""
        bat = batcher()
        for _ in range(load):
            prompt = rng.integers(1, arch.vocab, size=PROMPT_LEN).astype(
                np.int32)
            bat.submit(Request(rid=next(rid), prompt=prompt,
                               max_new_tokens=MAX_NEW))
        bat.run_until_drained()

    # calibrate the SLO band to this machine: lt/ut around the idle TTFT
    for _ in range(3):
        serve_tick(2)
    idle = float(np.median([r.ttft for r in server.accounting.requests
                            if r.ttft is not None]))
    slo = SLOTarget(ttft_p99=idle * 2.0)
    spec = spec.with_cell(
        dataclasses.replace(spec.cell("server"), slo=slo))
    plans.append(sup.apply(spec).summary())
    policy = ReconcilePolicy(
        sup, "server", "batch",
        ElasticPolicy(lt=idle * 1.3, ut=slo.ttft_p99, window=8,
                      percentile=99.0, cooldown=0.0, metric="ttft"),
    )
    print(f"idle TTFT {idle*1e3:.1f} ms -> band "
          f"({policy.policy.lt*1e3:.1f}, {policy.policy.ut*1e3:.1f}) ms")
    # the calibration's first tick paid the first calls; keep those TTFT
    # samples out of the policy window
    policy.pull()
    policy.samples.clear()

    widths = []
    phases = [("calm", 2), ("burst", args.burst), ("calm", 2)]
    for phase, load in phases:
        for _tick in range(args.ticks):
            serve_tick(load)
            act = policy.maybe_act()
            if act:
                # warm the rebuilt batcher (fresh mesh -> first calls)
                # and drop the tainted samples from the window
                serve_tick(2)
                policy.pull()
                policy.samples.clear()
            trainer.train_steps(pipe.get_batch, 1)
            note = f" -> {act['kind']} [{act['plan']}]" if act else ""
            widths.append((sup.cells["server"].zone.ncols,
                           sup.cells["batch"].zone.ncols))
            print(f"[{phase:5s}] server={widths[-1][0]}col "
                  f"batch={widths[-1][1]}col{note}")
    actions = [a["kind"] for a in policy.actions]
    print(f"actions: {actions}")
    served = len(server.accounting.requests)
    print(f"served {served} requests; trainer reached step {trainer.step}; "
          f"epoch {sup.table.epoch}")
    converged = sup.reconcile().empty
    print(f"reconcile converged: {converged}")
    return {"plans": plans, "zones": zones, "actions": actions,
            "widths": widths,
            "served": served, "submitted": next(rid),
            "trainer_step": trainer.step, "converged": converged,
            "events": [e["op"] for e in sup.events]}


if __name__ == "__main__":
    main()
