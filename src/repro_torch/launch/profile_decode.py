"""Profile the decode step, or one prefill, of the port on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --slots 8 --prompt-len 128 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --dense
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --prefill cold                   # or extend (paged), restore (ssm)
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --extra-graphs 2
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch seamless-m4t-large-v2 --prefill cold      # or extend
    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --mesh 2 2                       # a cell over (data 2, model 2)

Builds ``--arch`` at full width (bf16, random weights from a seed,
max_len 512; qwen3-4b by default) and admits one wave of ``--slots``
prompts through the batcher, on the pool the model takes (paged KV, or
state snapshots for mamba2-2.7b and zamba2-2.7b, whose decode runs on the
dense per-slot cache either way) or, with ``--dense``, on the dense
per-slot cache alone.  An encdec model (seamless-m4t-large-v2) gets
seeded source features with every prompt, 96..384 frames of d_model
normal values each.
Then it times ``--steps`` decode steps, runs ``--steps`` more under
``torch.profiler`` (which slows the host), and prints the wall time of
each step, the device-busy time and idle share of the profiled window,
and the device time by kernel.  A CUDA device is required.

Every step runs as a CUDA graph (``serve/step_graph.py``): the warm-up
steps take the path's eager call and the key's capture, so every timed
and profiled step is a replay (checked, and the graph counters printed;
``--prompt-len`` must keep the window in one block-table width bucket).
Device busy is the union of the device intervals the profiler records;
the count of kernels it saw says whether it sees the kernels inside the
graph.

``--prefill`` profiles one invocation of a prefill path instead, at
chip_smoke's shapes, on the drained batcher (whose state is scratch by
then): ``cold``, the cold prefill of ``--slots`` prompts of 128 tokens;
``extend`` (paged pool), ``--slots`` suffixes of 64 tokens behind a
64-token prefix; ``restore`` (snapshot pool), the same suffixes through
the snapshot restore's dense extend over every slot.  The time to first
token of a served request is this call plus the host's bookkeeping.  On
an encdec model each prefill also encodes the rows' sources; the encoder
alone over the same sources is profiled too (eager calls, device busy),
and its busy time a call set against the replayed call's: the encoder's
share of the prefill.

``--mesh ROWS COLS`` serves from a cell over a zone of ROWS x COLS
positions of the card (``Supervisor`` -> ``Cell`` -> ``make_batcher``;
(``data`` ROWS, ``model`` COLS), FSDP over ``data``) with the same
seeded weights, and prints the collective bytes the profiled path's key
recorded per position; every position's kernels run in the one graph.

``--extra-graphs N`` (decode) times the decode replay again with N more
CUDA graphs of 2000 small kernels each alive beside the batcher's own,
as a serving batcher adds step graphs with its prefill keys: the card
runs a graph's kernels further apart once a few more graphs are alive
(``PERF.md`` §6).
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
from repro_torch.serve.serve_step import prefill_inputs
from repro_torch.serve.step_graph import extend_key, restore_key, to_device

#: the prefill paths of ``--prefill`` and the step-graph path each takes
PREFILL_PATHS = {"cold": "prefill", "extend": "extend", "restore": "restore"}


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


def sources(model, n: int, rng) -> list:
    """``n`` seeded source features of an encdec model, (96..384 frames,
    d_model) float32 normal each; [None] * n for another family."""
    if model.cfg.family != "encdec":
        return [None] * n
    return [rng.standard_normal((int(f), model.cfg.d_model))
            .astype(np.float32) for f in rng.integers(96, 385, size=n)]


def prefill_call(bat, path: str, *, prompt_len: int = 128,
                 suffix: int = 64, seed: int = 0):
    """(key, fn, state, host) of one invocation of prefill ``path`` (a key
    of ``PREFILL_PATHS``) on the drained batcher ``bat``: ``bat.B`` random
    prompts of ``prompt_len`` tokens cold; for extend and restore,
    ``bat.B`` suffixes of ``suffix`` tokens behind a prefix of
    ``prompt_len - suffix``, on consecutive arena pages; an encdec
    model's rows each carry a seeded source (:func:`sources`).  Run it with
    ``bat._run(key, fn, state, host)``; a drained batcher's state is
    scratch, so it harms nothing."""
    rng = np.random.default_rng(seed)
    V, B = bat.model.cfg.vocab, bat.B

    def tokens(n):
        return rng.integers(1, V, size=(B, n)).astype(np.int32)

    srcs = sources(bat.model, B, rng)
    if path == "cold":
        key, host = prefill_inputs(list(tokens(prompt_len)), srcs,
                                   chunk=bat.prefill_chunk,
                                   max_len=bat.max_len, model=bat.model)
        return key, bat._run_prefill, bat._prefill_state(key), host
    host = {"tokens": tokens(suffix),
            "pos": np.full(B, prompt_len - suffix, np.int32),
            "length": np.full(B, suffix, np.int32),
            **bat.model.ranged_batch_extras(srcs, bat.max_len)}
    if path == "restore":
        if not bat._snapshot:
            raise ValueError("--prefill restore needs a snapshot pool "
                             "(mamba2-2.7b, zamba2-2.7b)")
        return (restore_key(suffix), bat._run_extend,
                (bat.params, bat.cache), host)
    if not bat._paged:
        raise ValueError("--prefill extend needs a paged pool")
    pool = bat.pool
    key = extend_key(B, suffix, -(-prompt_len // pool.page_size),
                     pool.n_logical)
    host["block_table"] = (np.arange(B * key[3], dtype=np.int32)
                           .reshape(B, key[3]) % pool.num_pages)
    state = (bat.params, pool.arena, pool.kv_scales, bat._extend_rows(B))
    return key, bat._run_extend, state, host


def encoder_busy_ms(bat, host, n: int) -> float:
    """Device busy time (ms) of the encoder alone over the sources of
    ``host``, a call: ``n`` eager calls profiled, the union of their
    kernels' device intervals over ``n``.  Eager calls leave the card idle
    between launches, which the union leaves out."""
    inputs = to_device(host, bat.device)

    def call():
        bat.model._encode(bat.params, inputs["src"], inputs["src_len"])
        torch.cuda.synchronize()
    call()
    return profile_calls(call, n)[3] / n * 1e3


def profile_calls(call, n: int):
    """Time ``n`` calls of ``call`` (each ends reading its result back,
    so it is synced), then profile ``n`` more.  Returns (unprofiled walls,
    profiled walls, window seconds, device busy seconds, device kernel
    events, the profile)."""
    plain = []
    for _ in range(n):
        t = time.monotonic()
        call()
        plain.append(time.monotonic() - t)
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_window = time.monotonic()
        for _ in range(n):
            t = time.monotonic()
            call()
            walls.append(time.monotonic() - t)
        torch.cuda.synchronize()
        window = time.monotonic() - t_window
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return plain, walls, window, _busy_us(prof.events()) / 1e6, kernels, prof


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--dense", action="store_true",
                   help="the dense per-slot cache (kv_pool=None)")
    p.add_argument("--prefill", choices=sorted(PREFILL_PATHS),
                   help="profile one invocation of this prefill path")
    p.add_argument("--extra-graphs", type=int, default=0,
                   help="time the decode replay again with this many more "
                        "graphs of 2000 kernels alive")
    p.add_argument("--mesh", type=int, nargs=2, metavar=("ROWS", "COLS"),
                   help="serve from a cell over ROWS x COLS positions of "
                        "the card")
    args = p.parse_args(argv)

    device = resolve_device("cuda")
    arch = get_arch(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    kw = dict(batch_slots=args.slots, max_len=512,
              kv_pool=None if args.dense else "auto")
    cell = None
    if args.mesh:
        from repro_torch.core import (
            CellSpec,
            ClusterSpec,
            DeviceGrid,
            Supervisor,
        )
        rows, cols = args.mesh
        sup = Supervisor(DeviceGrid.from_flat([device] * (rows * cols), 1,
                                              rows, cols))
        sup.apply(ClusterSpec(cells=(CellSpec(arch.name, arch, "serve",
                                              ncols=cols),)))
        cell = sup.cells[arch.name]
        cell.init_serve(generator=gen)
        model = cell.model
        bat = cell.make_batcher(**kw)
    else:
        model = build_model(arch)
        params = model.init(gen, device=device)
        bat = ContinuousBatcher(model, params, device=device, **kw)
    rng = np.random.default_rng(0)
    srcs = sources(model, args.slots, rng)
    for rid in range(args.slots):
        prompt = rng.integers(1, arch.vocab, size=args.prompt_len)
        bat.submit(Request(rid=rid, max_new_tokens=4 * args.steps + 6,
                           prompt=prompt.astype(np.int32), src=srcs[rid]))
    if args.prefill:
        bat.run_until_drained()
        key, fn, state, host = prefill_call(bat, args.prefill,
                                            prompt_len=args.prompt_len)
        path = PREFILL_PATHS[args.prefill]

        def call():
            return bat._run(key, fn, state, host)[0].tolist()
        what = f"{args.prefill} prefill calls at key {key}"
    else:
        path = "decode"
        bat.step()                  # admits and prefills, then one decode
        call = bat.step             # ends reading the tokens: synced
        what = "decode steps"
    call()                          # the path's eager call, or a capture
    call()                          # the key's capture, if not done yet
    warm = bat.step_graph.stats()[path]
    extra = []
    if args.extra_graphs:
        alone = profile_calls(call, args.steps)[0]
        x = torch.ones(1 << 16, device=device)
        for _ in range(args.extra_graphs):
            extra.append(torch.cuda.CUDAGraph())
            with torch.cuda.graph(extra[-1]):
                y = x
                for _ in range(2000):
                    y = y * 1.0
        warm = bat.step_graph.stats()[path]
    plain, walls, window, busy, kernels, prof = profile_calls(call,
                                                              args.steps)
    g = bat.step_graph.stats()[path]
    if (g["replays"] - warm["replays"] != 2 * args.steps
            or g["captures"] != warm["captures"]):
        raise RuntimeError(f"a timed or profiled call was not a replay "
                           f"(graph counters {warm} -> {g}): the window "
                           f"crossed a block-table width bucket")
    plane = bat.pool.payload_kind if bat.pool is not None else "dense"
    where = "" if cell is None else f", a cell over {cell.mesh.shape}"
    print(f"[profile] {arch.name} ({plane} cache plane{where}): "
          f"{args.slots} slots, prompts {args.prompt_len} tokens, "
          f"{args.steps} {what} on {torch.cuda.get_device_name(device)}")
    if cell is not None:
        for key, prog in sorted(cell.accounting.programs.items()):
            print(f"[profile] collective bytes per position, step key "
                  f"{key}: {dict(prog.collective_per_device)}")
    for name, ws in (("unprofiled", plain), ("profiled", walls)):
        print(f"[profile] {name} wall ms: "
              + " ".join(f"{w * 1e3:.2f}" for w in ws)
              + f" (median {np.median(ws) * 1e3:.2f})")
    print(f"[profile] {graph_summary(bat)}")
    if extra:
        print(f"[profile] unprofiled wall median {np.median(alone) * 1e3:.2f} "
              f"ms with the batcher's graphs alone, "
              f"{np.median(plain) * 1e3:.2f} ms with {len(extra)} more "
              f"graphs of 2000 kernels alive")
    print(f"[profile] the profiler saw {len(kernels)} device events in the "
          f"window ({len(kernels) / args.steps:.1f} a replayed call)")
    print(f"[profile] window {window * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.2f} ms, idle share {1 - busy / window:.3f}")
    # the profiler slows the host's side of every call, a graph launch
    # too: against the unprofiled call, device busy a call says more
    print(f"[profile] device busy a call {busy / args.steps * 1e3:.2f} ms, "
          f"{busy / args.steps / np.median(plain):.3f} of the unprofiled "
          f"median")
    if args.prefill and model.cfg.family == "encdec":
        enc = encoder_busy_ms(bat, host, args.steps)
        print(f"[profile] the encoder alone over the same sources: device "
              f"busy {enc:.2f} ms a call, {enc / (busy / args.steps * 1e3):.3f}"
              " of the replayed call's")
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25))
    bat.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
