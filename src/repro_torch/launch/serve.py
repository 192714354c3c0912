"""Serving entry point: spawn a serving cell and run batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --requests 32 --slots 8 --max-new 16             # smoke size, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke  # full width
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-2.7b                  # ssm on the snapshot pool
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch seamless-m4t-large-v2        # encdec on the paged pool

The twin of ``repro.launch.serve`` with the same flags plus ``--device``.
The cache plane is the one ``KVPool.capability``
picks: paged KV for the dense, MoE and encdec families (encdec: the
decoder's self-KV paged, the cross memory dense per slot), state
snapshots for ssm (mamba2-2.7b) and hybrid (zamba2-2.7b), the dense
per-slot cache for a rolling window.  Requests carry no source features
(``src=None``), as in ``repro.launch.serve``.
As the JAX entry point does, it serves through the control plane: a
``Supervisor`` over a one-device grid applies a ``ClusterSpec`` of one
serve cell, the cell places the weights (random, from a seeded generator
on the device) and makes the batcher, which reports to the cell's
accounting and flight recorder; the last line prints the cell's serving
summary and the supervisor's event log.  On the card the decode, prefill, extend and
restore steps run as CUDA graphs, one per shape key
(``serve/step_graph.py``); the summary says, per path, how many keys
were met, how many calls ran eagerly (the path's first in the process)
and how many replayed (every other call, the key's first visit capturing
first); on the CPU every step is eager.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs.base import smoke_config, with_opt_level
from repro_torch.configs.registry import get_arch
from repro_torch.core import (
    CellSpec,
    ClusterSpec,
    Supervisor,
    single_device_grid,
)
from repro_torch.device import resolve_device
from repro_torch.serve.batcher import Request


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                   default=True, help="reduced widths (--no-smoke: full)")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--prefill-chunk", type=int, default=32,
                   help="chunked-prefill bucket size; 0 = token-at-a-time")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    arch = get_arch(args.arch)
    if args.smoke:
        arch = smoke_config(arch)
    arch = with_opt_level(arch, True)
    device = resolve_device(args.device)

    sup = Supervisor(single_device_grid(device))
    sup.apply(ClusterSpec(cells=(CellSpec(arch.name, arch, "serve",
                                          ncols=1),)))
    cell = sup.cells[arch.name]
    cell.init_serve(generator=torch.Generator(device=device).manual_seed(0))
    bat = cell.make_batcher(batch_slots=args.slots, max_len=args.max_len,
                            temperature=args.temperature,
                            prefill_chunk=args.prefill_chunk or None)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, arch.vocab,
                              size=rng.integers(2, 12)).astype(np.int32)
        bat.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.max_new))
    done = bat.run_until_drained()
    dt = time.time() - t0

    lats = sorted(r.latency for r in done)
    toks = sum(len(r.output) for r in done)
    plane = bat.pool.payload_kind if bat.pool is not None else "dense"
    print(f"[serve] {arch.name} on {device} ({plane} cache plane): "
          f"{len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    print(f"[serve] latency p50={lats[len(lats) // 2] * 1e3:.1f}ms "
          f"p99={lats[max(int(len(lats) * 0.99) - 1, 0)] * 1e3:.1f}ms")
    print(f"[serve] {graph_summary(bat)}")
    print(f"[serve] cell {cell.name}: "
          f"{json.dumps(cell.accounting.serving_summary())}; supervisor "
          f"events: {json.dumps(sup.events)}")
    return 0


def graph_summary(bat) -> str:
    """What the batcher's step-graph counters mean, in one line."""
    if bat.step_graph is None:
        return (f"steps: {bat.decode_invocations} decode, "
                f"{bat.prefill_invocations} prefill and extend, all eager "
                "(no CUDA graph on the CPU)")
    parts = []
    for path, g in bat.step_graph.stats().items():
        if g["keys"]:
            dropped = f", {g['dropped']} dropped" if g["dropped"] else ""
            parts.append(f"{path} {g['keys']} keys: {g['eager_calls']} eager, "
                         f"{g['replays']} replays ({g['captures']} captured "
                         f"first{dropped})")
    return ("step graphs (eager: the path's first call in the process; "
            "captured: a key's first visit): " + "; ".join(parts))


if __name__ == "__main__":
    raise SystemExit(main())
