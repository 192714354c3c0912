"""Training entry point: boot a supervisor, spawn a training cell, run.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --steps 50 \\
        [--ckpt-dir /tmp/ckpt] [--resume]           # smoke size, cuda

The twin of ``repro.launch.train`` with the same flags plus ``--device``
(``--smoke`` is a real switch here: ``--no-smoke`` trains the full-width
config).  As the JAX entry point does, it trains through the control
plane: a ``Supervisor`` over a one-device grid applies a ``ClusterSpec``
of one train cell, whose ``train_steps`` runs the train step on the bigram
pipeline (step-deterministic, so a restart does not skew batches).  The
cell checkpoints every ``--ckpt-every`` steps (``save(blocking=False)``)
and ``--resume`` continues from the latest checkpoint.  The last line
prints the final xent beside the chain's entropy, the loss floor.  On the
card dense models train through the flash kernel and its backward, ssm
(``--arch mamba2-2.7b``) and hybrid (``--arch zamba2-2.7b``) models
through the SSD scan and its backward (and zamba2's shared attention
through flash); the moe family needs a backward of the grouped GEMM the
port does not have yet (ROADMAP queue 2 item 7) and raises there.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, smoke_config, with_opt_level
from repro_torch.configs.registry import get_arch
from repro_torch.core import (
    CellSpec,
    ClusterSpec,
    Supervisor,
    single_device_grid,
)
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.train.grad_compress import init_ef_state
from repro_torch.train.optimizer import OptConfig


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                   default=True, help="reduced widths (--no-smoke: full)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    arch = get_arch(args.arch)
    if args.smoke:
        arch = smoke_config(arch)
    arch = with_opt_level(arch, True)
    device = resolve_device(args.device)

    sup = Supervisor(single_device_grid(device))
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps,
                        m_dtype=arch.optimizer_m_dtype)
    sup.apply(ClusterSpec(cells=(CellSpec(arch.name, arch, "train", ncols=1,
                                          opt_cfg=opt_cfg),)))
    cell = sup.cells[arch.name]
    cell.init_train(torch.Generator(device=device).manual_seed(0),
                    compress=args.compress_grads)
    print(f"[train] {arch.name}: {cell.model.n_params() / 1e6:.1f}M params "
          f"on {device}")
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    pipe = SyntheticPipeline(DataConfig(kind="bigram"), arch, shape,
                             device=device)

    if args.resume and args.ckpt_dir:
        if sup.restore_from_ckpt(cell, args.ckpt_dir):
            if args.compress_grads:    # checkpoints hold no ef buffers
                cell.state = cell.state._replace(
                    ef=init_ef_state(cell.state.params))
            print(f"[train] resumed from step {cell.step}")

    t0, start, pending = time.time(), cell.step, None
    m = {}
    while cell.step < args.steps:
        n = min(10, args.steps - cell.step)
        m = cell.train_steps(pipe.get_batch, n)
        if args.ckpt_dir and cell.step % args.ckpt_every == 0:
            if pending is not None:
                pending.result()          # one save in flight; its errors
            pending = ckpt.save(args.ckpt_dir, cell.step, cell.state,
                                blocking=False)
        tput = args.batch * args.seq * (cell.step - start) / (time.time() - t0)
        print(f"[{cell.step:5d}] xent={m['xent']:.3f} lr={m['lr']:.2e} "
              f"({tput:,.0f} tok/s)")
    if pending is not None:
        pending.result()
    print(f"[train] done; xent={m.get('xent', float('nan')):.3f} "
          f"floor={pipe.bigram_entropy():.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
