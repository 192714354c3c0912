"""Serving driver: build the model and a batcher, run batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --requests 32 --slots 8 --max-new 16             # smoke size, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke  # full width
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The twin of ``repro.launch.serve`` with the same flags plus ``--device``.
Weights are random, drawn from a seeded generator on the device.  The
supervisor and cells come with ROADMAP queue 1 item 10; this driver builds
the batcher directly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import smoke_config, with_opt_level
from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.batcher import ContinuousBatcher, Request


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

    model = build_model(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device=device)
    bat = ContinuousBatcher(model, params, batch_slots=args.slots,
                            max_len=args.max_len,
                            temperature=args.temperature,
                            prefill_chunk=args.prefill_chunk or None,
                            device=device)

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
    print(f"[serve] {arch.name} on {device}: {len(done)} requests, {toks} "
          f"tokens in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    print(f"[serve] latency p50={lats[len(lats) // 2] * 1e3:.1f}ms "
          f"p99={lats[max(int(len(lats) * 0.99) - 1, 0)] * 1e3:.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
