"""Profile the decode step of the port on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --slots 8 --prompt-len 128 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --dense
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        --arch mamba2-2.7b

Builds ``--arch`` at full width (bf16, random weights from a seed,
max_len 512; qwen3-4b by default) and admits one wave of ``--slots``
prompts through the batcher, on the pool the model takes (paged KV, or
state snapshots for mamba2-2.7b and zamba2-2.7b, whose decode runs on the
dense per-slot cache either way) or, with ``--dense``, on the dense
per-slot cache alone.
Then it times ``--steps`` decode steps, runs ``--steps`` more under
``torch.profiler`` (which slows the host), and prints the wall time of
each step, the device-busy time and idle share of the profiled window,
and the device time by kernel.  A CUDA device is required.

The decode step runs as a CUDA graph (``serve/step_graph.py``): the two
warm-up steps are the key's eager step and its capture, so every timed
and profiled step is a replay (checked, and the graph counters printed;
``--prompt-len`` must keep the window in one block-table width bucket).
Device busy is the union of the device intervals the profiler records;
the count of kernels it saw says whether it sees the kernels inside the
graph.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.serve import graph_summary
from repro_torch.models.model import build_model
from repro_torch.serve.batcher import ContinuousBatcher, Request


def _busy_us(events) -> float:
    """Union of the device kernels' intervals (us): overlapping kernels on
    several streams count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--dense", action="store_true",
                   help="the dense per-slot cache (kv_pool=None)")
    args = p.parse_args(argv)

    device = resolve_device("cuda")
    arch = get_arch(args.arch)
    model = build_model(arch)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    bat = ContinuousBatcher(model, params, batch_slots=args.slots,
                            max_len=512, device=device,
                            kv_pool=None if args.dense else "auto")
    rng = np.random.default_rng(0)
    for rid in range(args.slots):
        prompt = rng.integers(1, arch.vocab, size=args.prompt_len)
        bat.submit(Request(rid=rid, max_new_tokens=2 * args.steps + 4,
                           prompt=prompt.astype(np.int32)))
    bat.step()                      # admits and prefills, then one eager decode
    bat.step()                      # captures the key's graph and replays it
    warm = bat.step_graph.stats()
    plain = []
    for _ in range(args.steps):
        t = time.monotonic()
        bat.step()                  # ends reading the tokens: synced
        plain.append(time.monotonic() - t)
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_window = time.monotonic()
        for _ in range(args.steps):
            t = time.monotonic()
            bat.step()
            walls.append(time.monotonic() - t)
        torch.cuda.synchronize()
        window = time.monotonic() - t_window
    g = bat.step_graph.stats()
    if (g["replays"] - warm["replays"] != 2 * args.steps
            or g["captures"] != warm["captures"]):
        raise RuntimeError(f"a timed or profiled step was not a replay "
                           f"(graph counters {warm} -> {g}): the window "
                           f"crossed a block-table width bucket")
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(prof.events()) / 1e6
    plane = bat.pool.payload_kind if bat.pool is not None else "dense"
    print(f"[profile] {arch.name} ({plane} cache plane): {args.slots} "
          f"slots, prompts "
          f"{args.prompt_len} tokens, {args.steps} decode steps on "
          f"{torch.cuda.get_device_name(device)}")
    for name, ws in (("unprofiled", plain), ("profiled", walls)):
        print(f"[profile] {name} step wall ms: "
              + " ".join(f"{w * 1e3:.2f}" for w in ws)
              + f" (median {np.median(ws) * 1e3:.2f})")
    print(f"[profile] {graph_summary(bat)}")
    print(f"[profile] the profiler saw {len(kernels)} device events in the "
          f"window ({len(kernels) / args.steps:.1f} a replayed step)")
    print(f"[profile] window {window * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.2f} ms, idle share {1 - busy / window:.3f}")
    # the profiler slows the host's side of every step, a graph launch
    # too: against the unprofiled step, device busy a step says more
    print(f"[profile] device busy a step {busy / args.steps * 1e3:.2f} ms, "
          f"{busy / args.steps / np.median(plain):.3f} of the unprofiled "
          f"step median")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
