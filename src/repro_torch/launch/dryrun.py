"""Dry run: trace one step of an (arch x shape x mesh) cell on ``meta``.

The twin of ``repro.launch.dryrun``.  JAX lowers and compiles each cell
for a production mesh of virtual devices and reads the compiled program;
the port has no compiler to ask, so it runs the step itself, once, over a
mesh whose every position is the ``meta`` device (shapes and dtypes, no
storage, no kernel: each kernel takes its plain version there), and
records per position:

  * ``flops_per_device``: the step's FLOPs (``FlopCounterMode``; the
    forward, the remat recompute and the backward of a train step) over
    the positions, each of which runs the same program on its part;
  * ``collective_bytes_per_device``: the bytes each collective moved, by
    XLA's op names (``collectives.recording``);
  * ``memory.argument_bytes``: the step's arguments one position holds
    (the train state or the weights and cache, and its rows of the
    batch).

XLA's temp bytes and ``memory_analysis`` have no counterpart in a traced
eager step; the record says so (``memory.temp_bytes`` is None) rather
than inventing one.  The layout is JAX's rule: a train cell of an arch
whose ``train_layout`` is ``zero3`` runs ZeRO-3 (``dp_over_model``) when
the positions divide the global batch; serving skips FSDP unless the arch
asks for it.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k \\
      --mesh single [--smoke] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (
    ArchConfig,
    ShapeConfig,
    shapes_for,
    smoke_config,
    with_opt_level,
)
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.models.param import abstract_params, shard_tree, tree_map
from repro_torch.sharding.collectives import recording
from repro_torch.sharding.rules import make_ctx
from repro_torch.sharding.sharded import Sharded
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (
    abstract_train_state,
    build_train_step,
    train_state_pspecs,
)

META = torch.device("meta")


def _batch(model, shape: ShapeConfig) -> dict:
    """The step's batch as ``meta`` tensors of the global shapes."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.empty((B, 1 if shape.kind == "decode" else S),
                      dtype=torch.int32, device=META)
    out = {"tokens": tok}
    if shape.kind == "train":
        out["labels"] = torch.empty_like(tok)
    if shape.kind == "prefill":
        out["length"] = torch.empty((B,), dtype=torch.int32, device=META)
    if shape.kind == "decode":
        out["pos"] = torch.empty((B,), dtype=torch.int32, device=META)
    if model.cfg.family == "encdec" and shape.kind != "decode":
        out["src"] = torch.empty((B, model.source_len(S), model.cfg.d_model),
                                 dtype=model.dtype, device=META)
        out["src_len"] = torch.empty((B,), dtype=torch.int32, device=META)
    return out


def _local_bytes(tree, dp: int) -> int:
    """The bytes one position holds of ``tree``: position 0's shard of a
    Sharded leaf, and its rows (1 / ``dp``) of a plain leaf (the batch,
    split over the data axes)."""
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, Sharded):
            total += t.shards[0].numel() * t.shards[0].element_size()
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size() // dp
    tree_map(add, tree)
    return total


def lower_cell(arch: ArchConfig, shape: ShapeConfig, mesh, *,
               opt_cfg: Optional[OptConfig] = None):
    """(model, step, args) of a cell on ``mesh``: ``step(*args)`` runs the
    right program once (the train step over the laid-out train state, or
    a prefill or a decode over the weights and a cache)."""
    fsdp = True if shape.kind == "train" else arch.serve_fsdp
    zero3_ok = (shape.kind == "train" and arch.train_layout == "zero3"
                and shape.global_batch % mesh.size == 0)
    ctx = make_ctx(mesh, fsdp=fsdp, dp_over_model=zero3_ok)
    model = build_model(arch, ctx)
    batch = _batch(model, shape)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig(m_dtype=arch.optimizer_m_dtype)
        state = abstract_train_state(model, opt_cfg)
        if model.sharded:
            state = shard_tree(state, train_state_pspecs(model), ctx)
        return model, build_train_step(model, opt_cfg), (state, batch)
    params = abstract_params(model.param_specs(), arch.dtype)
    cache = abstract_params(model.cache_specs(B, S), arch.dtype)
    if model.sharded:
        params = shard_tree(params, model.params_pspecs(), ctx)
        cache = shard_tree(cache, model.cache_pspecs(B, S), ctx)
    if shape.kind == "prefill":
        return model, model.prefill_ranged, (params, batch, cache)
    return model, model.decode, (params, cache, batch)


def run_cell(arch: ArchConfig, shape: ShapeConfig, mesh, mesh_name: str,
             *, verbose: bool = True) -> dict:
    """Trace one step of the cell and return its record (module doc)."""
    n_pos = mesh.size
    t0 = time.monotonic()
    model, step, args = lower_cell(arch, shape, mesh)
    t_lower = time.monotonic() - t0
    arg_bytes = _local_bytes(args, model._ctx().dp_size())
    t0 = time.monotonic()
    with recording() as colls, FlopCounterMode(display=False) as fc:
        step(*args)
    t_trace = time.monotonic() - t0
    rec = {
        "arch": arch.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "devices": n_pos,
        "dp_over_model": bool(model._ctx().dp_over_model),
        "n_params": model.n_params(),
        "lower_s": round(t_lower, 2),
        "trace_s": round(t_trace, 2),
        "flops_per_device": float(fc.get_total_flops()) / n_pos,
        "collective_bytes_per_device": dict(colls),
        "memory": {"argument_bytes": int(arg_bytes), "temp_bytes": None,
                   "note": "an eager trace has no compiled program: XLA's "
                           "temp bytes and memory_analysis have no "
                           "counterpart here"},
    }
    if verbose:
        print(f"[dryrun] {arch.name:24s} {shape.name:12s} {mesh_name:6s} "
              f"trace={t_trace:6.1f}s flops/dev={rec['flops_per_device']:.3e}"
              f" args/dev={arg_bytes / 2**30:6.2f}GiB "
              f"coll={sum(colls.values()) / 2**20:8.1f}MiB")
    return rec


def out_path(root: str, mesh_name: str, arch: str, shape: str) -> str:
    d = os.path.join(root, mesh_name)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}.json")


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="arch id (default: all)")
    p.add_argument("--shape", default=None, help="shape name (default: all)")
    p.add_argument("--mesh", default="both",
                   choices=["single", "multi", "both"])
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--level", default="optimized",
                   choices=["baseline", "optimized"])
    p.add_argument("--smoke", action="store_true",
                   help="the archs' smoke configs (seconds, not hours)")
    args = p.parse_args(argv)

    archs = [get_arch(args.arch)] if args.arch else list(ARCHS.values())
    archs = [with_opt_level(a, args.level == "optimized") for a in archs]
    if args.smoke:
        archs = [smoke_config(a) for a in archs]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True)))
    failures = []
    for arch in archs:
        shapes = [s for s in shapes_for(arch)
                  if args.shape is None or s.name == args.shape]
        for shape in shapes:
            for mesh_name, mesh in meshes:
                try:
                    rec = run_cell(arch, shape, mesh, mesh_name)
                    with open(out_path(args.out, mesh_name, arch.name,
                                       shape.name), "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:     # noqa: BLE001 - listed below
                    traceback.print_exc()
                    failures.append((arch.name, shape.name, mesh_name,
                                     str(e)[:200]))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nAll dry-run cells traced.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
