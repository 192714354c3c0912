"""Quickstart: the IFTS runtime in ~60 lines, declaratively.

The twin of ``examples/quickstart.py``.  Boots a supervisor over the
device grid, applies a ClusterSpec (the desired state: one training
cell), trains a tiny model, *rescales the spec* to grow the cell on the
fly, adds a serving cell + weight-sync channel to the spec, and serves a
request.  Every topology change goes through ``Supervisor.apply`` — the
reconciler turns the spec diff into create/resize/channel primitives.

The grid is the example's, two rows of four columns, each entry a mesh
position on ``--device``: the trainer trains over (data 2, model 2),
then (2, 3) after the grow, and the weight sync lays the trained params
out over the serving cell's (2, 1) mesh through the channel.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu] [--steps 20 --more-steps 10 --max-new 8]
"""
import argparse

import numpy as np

from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.core import (
    CellSpec,
    ChannelSpec,
    ClusterSpec,
    DeviceGrid,
    Supervisor,
)
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.serve.batcher import Request
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20,
                    help="train steps on 2 columns")
    ap.add_argument("--more-steps", type=int, default=10,
                    help="train steps on 3 columns")
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -- supervisor boots first (paper: the firstly-booted instance)
    grid = DeviceGrid.from_flat([device] * 8, pods=1, rows=2, cols=4)
    sup = Supervisor(grid)
    print(f"supervisor up: grid={grid.shape}, epoch={sup.table.epoch}")

    # -- desired state: one training cell (a subOS) on 2 columns
    arch = smoke_config(get_arch("qwen3-4b"))
    spec = ClusterSpec(cells=(
        CellSpec("trainer", arch, "train", ncols=2, min_ncols=1, max_ncols=3,
                 opt_cfg=OptConfig(lr=1e-3, warmup_steps=20, total_steps=400)),
    ))
    plan = sup.apply(spec)
    plans = [plan.summary()]
    print(f"applied spec -> plan [{plan.summary()}], epoch={sup.table.epoch}")
    trainer = sup.cells["trainer"]
    pipe = SyntheticPipeline(DataConfig(kind="bigram", vocab=256), arch,
                             ShapeConfig("t", "train", 32, 32), device=device)
    m = trainer.train_steps(pipe.get_batch, args.steps)
    xents = [m["xent"]]
    print(f"trained {args.steps} steps on {trainer.zone.ncols} cols: "
          f"xent={m['xent']:.3f}")

    # -- elastic grow: rewrite the DESIRED width; reconcile does the resize
    spec = spec.scale("trainer", 3)
    plan = sup.apply(spec)
    plans.append(plan.summary())
    grow = plan.by_verb("grow")[0]
    print(f"rescaled 2->3 cols [{grow.status}] "
          f"({grow.result['bytes']/1e6:.1f} MB resharded)")
    m = trainer.train_steps(pipe.get_batch, args.more_steps)
    xents.append(m["xent"])
    print(f"{args.more_steps} more steps on 3 cols: xent={m['xent']:.3f}")

    # -- add a serving cell + an on-demand weight channel to the spec
    spec = spec.with_cell(CellSpec("server", arch, "serve", ncols=1)) \
               .with_channel(ChannelSpec("trainer", "server"))
    plan = sup.apply(spec)
    plans.append(plan.summary())
    print(f"applied serving spec -> plan [{plan.summary()}]")
    server = sup.cells["server"]
    server.init_serve()
    ch = sup.find_channel("trainer", "server")
    st = ch.send(trainer.state.params,
                 (server.mesh, server.model.params_pspecs()))
    server.serve_params = ch.recv()
    print(f"weight sync: {st['bytes']/1e6:.1f} MB in "
          f"{st['seconds']*1e3:.1f} ms")

    # -- serve
    bat = server.make_batcher(batch_slots=4, max_len=64)
    bat.submit(Request(rid=0, prompt=np.array([5, 7, 11], np.int32),
                       max_new_tokens=args.max_new))
    done = bat.run_until_drained()
    print(f"served request -> tokens {done[0].output}")

    # -- converged: reconcile again is a no-op
    converged = sup.reconcile().empty
    print(f"reconcile converged: {converged}")
    events = [e["op"] for e in sup.events]
    print(f"events: {events}")
    zones = {n: (c.zone.pods, c.zone.c0, c.zone.c1, c.mesh.shape)
             for n, c in sup.cells.items()}

    # -- empty spec tears everything down
    sup.apply(ClusterSpec())
    print(f"final epoch: {sup.table.epoch}, cells: {list(sup.cells)}")
    print("done.")
    return {"plans": plans, "xents": xents, "sync_bytes": st["bytes"],
            "grow_bytes": grow.result["bytes"], "tokens": done[0].output,
            "converged": converged, "events": events, "zones": zones,
            "epoch": sup.table.epoch, "cells": list(sup.cells)}


if __name__ == "__main__":
    main()
