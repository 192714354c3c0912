"""End-to-end run: train a ~100M-param qwen3-family model.

The twin of ``examples/train_100m.py``.  Demonstrates the full training
substrate — seeded init, microbatched train step, deterministic
restart-safe data pipeline, async checkpointing, and (the fault-tolerance
path) a mid-run simulated failure with restore from the last checkpoint
onto the cell's layout.  Loss should drop toward the bigram-chain
entropy floor.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m
      [--device cpu] [--steps 300] [--layers N --chunk N --warmup N]
(``--layers`` cuts the depth for a quick run; the widths stay.)
"""
import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import Supervisor, single_device_grid
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (
    abstract_train_state,
    train_state_pspecs,
)

ARCH_100M = ArchConfig(
    name="qwen3-100m",
    family="dense",
    num_layers=10,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2560,
    vocab=16384,
    vocab_pad_multiple=128,
    qk_norm=True,
    tie_embeddings=False,
    microbatch=1,
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=60)  # CPU demo; use 300+ on a card
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--chunk", type=int, default=10,
                   help="steps a train_steps call")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_100m"))
    p.add_argument("--layers", type=int, default=ARCH_100M.num_layers)
    p.add_argument("--warmup", type=int, default=40)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    arch = dataclasses.replace(ARCH_100M, num_layers=args.layers)

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    sup = Supervisor(single_device_grid(device))
    cell = sup.create_cell(
        "lm100m", arch, "train", ncols=1,
        opt_cfg=OptConfig(lr=6e-4, warmup_steps=args.warmup,
                          total_steps=args.steps),
    )
    print(f"model: {cell.model.n_params()/1e6:.1f}M params")
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    pipe = SyntheticPipeline(DataConfig(kind="bigram", vocab=2048), arch,
                             shape, device=device)
    floor = pipe.bigram_entropy()
    print(f"bigram entropy floor: {floor:.3f} nats")

    t0 = time.time()
    fail_at = args.steps // 2
    pending = None
    restored_at = None
    xents = []
    while cell.step < args.steps:
        if cell.step == fail_at and cell.status != "recovered-once":
            # ---- simulated node failure + restore from checkpoint --------
            print(f"[{cell.step}] simulating failure; restoring from "
                  f"checkpoint")
            if pending is not None:
                pending.result()
            step = ckpt.latest_step(args.ckpt_dir)
            target = abstract_train_state(cell.model, cell.opt_cfg)
            if cell.mesh.size > 1:
                cell.state = ckpt.restore(args.ckpt_dir, step, target,
                                          cell.mesh,
                                          train_state_pspecs(cell.model))
            else:
                cell.state = ckpt.restore(args.ckpt_dir, step, target,
                                          cell.device)
            cell.step = restored_at = step
            cell.status = "recovered-once"
            print(f"  restored at step {step} "
                  f"(data pipeline is deterministic — no batch skew)")
        m = cell.train_steps(pipe.get_batch,
                             min(args.chunk, args.steps - cell.step))
        xents.append(m["xent"])
        if cell.step % args.ckpt_every == 0:
            pending = ckpt.save(args.ckpt_dir, cell.step, cell.state,
                                blocking=False)
        tput = args.batch * args.seq * cell.step / (time.time() - t0)
        print(f"[{cell.step:4d}] xent={m['xent']:.3f} lr={m['lr']:.2e} "
              f"gnorm={m['grad_norm']:.2f} ({tput:,.0f} tok/s)")
    if pending is not None:
        pending.result()
    print(f"final xent {m['xent']:.3f} vs floor {floor:.3f}")
    return {"params": cell.model.n_params(), "xents": xents,
            "restored_at": restored_at, "step": cell.step, "floor": floor}


if __name__ == "__main__":
    main()
