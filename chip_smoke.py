"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, checks that the
port's batcher gives the same greedy tokens on the card as on the CPU,
then serves full-width qwen3-4b (random weights from a seed) through the
paged decode, paged extend and prefill kernels.  Prints one JSON line of
kernel measurements, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the main path: qwen3-4b attention shapes and the serving configuration
HQ, HKV, DH, PAGE = 32, 8, 128, 16
LAYERS, LAYER = 36, 17
SLOTS, MAX_LEN, CHUNK, MAX_NEW = 8, 512, 32, 16
SHARED, TAIL_LO, TAIL_HI = 64, 8, 64


def log(msg: str):
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def rel(a, b) -> float:
    a = a.float()
    b = b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def time_ms(fn, reps: int = 25, flush=None) -> float:
    """Median device time of one call, from CUDA events around each call.

    All calls are enqueued behind a device-side sleep, so the card runs
    them back to back and the host's launch overhead stays out of the
    events.  ``flush`` (a large tensor) is rewritten before each call so
    the call finds the L2 cache cold, as a layer of the real step does."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)      # ~0.1 s: time to enqueue every call
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# --------------------------------------------------------------------------
# phase 3 inputs: layout-consistent paged arenas
# --------------------------------------------------------------------------
def build_arena(gen, kv_lens, n_log, dtype, dev, *, n_layers=LAYERS,
                sentinel_rows=()):
    """Arena (N, P, L, Hkv, Dh) in which logical page j of row b holds
    positions [j*P, min((j+1)*P, kv_len)) at every layer; unused pages and
    the clamp target page N-1 stay clean (slot_pos -1).  Rows listed in
    ``sentinel_rows`` map no page at all."""
    B = len(kv_lens)
    N = B * n_log + 2
    shape = (N, PAGE, n_layers, HKV, DH)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    sp = torch.full((N, PAGE, n_layers), -1, dtype=torch.int32)
    bt = torch.full((B, n_log), N, dtype=torch.int32)
    nxt = 0
    for b, kl in enumerate(kv_lens):
        if b in sentinel_rows:
            continue
        for j in range(-(-kl // PAGE)):
            fill = min(PAGE, kl - j * PAGE)
            sp[nxt, :fill, :] = (j * PAGE + torch.arange(fill))[:, None]
            bt[b, j] = nxt
            nxt += 1
    arena = {"slot_pos": sp.to(dev), "block_table": bt.to(dev),
             "k_scale": None, "v_scale": None}
    if dtype == torch.int8:
        from repro_torch.models.cache_utils import quantize_page
        arena["k"], arena["k_scale"] = quantize_page(k, keep_axes=(0, 2))
        arena["v"], arena["v_scale"] = quantize_page(v, keep_axes=(0, 2))
    else:
        arena["k"], arena["v"] = k.to(dtype), v.to(dtype)
    return arena


def pages_read(kv_need, n_log):
    return sum(min(-(-n // PAGE), n_log) for n in kv_need)


def main_path_prompts(seed: int = 0):
    """The two waves of the main path: 8 prompts each, every prompt a
    64-token shared prefix plus its own tail of 8..64 tokens."""
    rng = np.random.default_rng(seed)
    vocab = 151936
    shared = rng.integers(1, vocab, size=SHARED).astype(np.int32)
    waves = []
    for _ in range(2):
        tails = [rng.integers(1, vocab, size=int(n)).astype(np.int32)
                 for n in rng.integers(TAIL_LO, TAIL_HI + 1, size=SLOTS)]
        waves.append([np.concatenate([shared, t]) for t in tails])
    return waves


def pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def check_kernels(dev, kernels: dict):
    """Phase 3: each kernel against its plain version on the card, then
    timed at the main path's shapes beside the plain version and one
    PyTorch library call computing the same function."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        gather_pages_ref,
        paged_extend_attention_ref,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # (q dtype, arena dtype, tolerance on max|err| / max|ref|, reason)
    tols = [
        (f32, f32, 2e-5, "f32 both sides; only the summation order differs"),
        (bf16, bf16, 2e-2, "bf16 output rounding (8 mantissa bits)"),
        (f32, i8, 2e-4, "same int8 values and scales dequantised on both "
                        "sides; f32 summation order"),
        (bf16, i8, 2e-2, "bf16 output rounding"),
    ]
    errs = {name: 0.0 for name in kernels}

    def hold(name, out, ref, tol, why, what):
        r = rel(out, ref)
        errs[name] = max(errs[name], float((out.float() - ref.float())
                                           .abs().max()))
        ok = r < tol
        log(f"  {name:24s} {what:44s} rel={r:.3e} tol={tol:.0e} ({why})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {what}: rel {r} >= {tol}")

    # paged decode: ragged lengths, P does not divide them, L > 1 with a
    # non-zero layer, and row 7 fully sentinel (must come out finite)
    kv_lens = [512, 300, 17, 1, 255, 129, 64, 100]
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    for qdt, adt, tol, why in tols:
        a = build_arena(gen, kv_lens, 32, adt, dev, sentinel_rows=(7,))
        q = torch.randn((8, 1, HQ, DH), generator=gen, device=dev).to(qdt)
        args = (a["k"], a["v"], a["slot_pos"], a["block_table"], kl, LAYER)
        sc = dict(k_scale=a["k_scale"], v_scale=a["v_scale"])
        out = paged_decode_attention(q, *args, **sc)
        ref = paged_decode_attention_ref(q[:, 0], *args, **sc)[:, None]
        torch.cuda.synchronize()
        if not torch.isfinite(out[7].float()).all():
            raise AssertionError("paged decode: fully sentinel row not finite")
        hold("paged_decode_attention", out[:7], ref[:7], tol, why,
             f"q {qdt} arena {adt} B8 n_log32 L36 layer17")

    # paged extend: per-row offsets off page boundaries, Sq = 40 not a
    # multiple of the 32-row q tile, row 7 fully sentinel
    pos = [0, 16, 64, 5, 100, 0, 33, 7]
    S = 40
    ps = torch.tensor(pos, dtype=torch.int32, device=dev)
    for qdt, adt, tol, why in tols:
        a = build_arena(gen, [p + S for p in pos], 16, adt, dev,
                        sentinel_rows=(7,))
        q = torch.randn((8, S, HQ, DH), generator=gen, device=dev).to(qdt)
        args = (a["k"], a["v"], a["slot_pos"], a["block_table"], ps, LAYER)
        sc = dict(k_scale=a["k_scale"], v_scale=a["v_scale"])
        out = paged_extend_attention(q, *args, **sc)
        ref = paged_extend_attention_ref(q.transpose(1, 2), *args,
                                         **sc).transpose(1, 2)
        torch.cuda.synchronize()
        if not torch.isfinite(out[7].float()).all():
            raise AssertionError("paged extend: fully sentinel row not finite")
        hold("paged_extend_attention", out[:7], ref[:7], tol, why,
             f"q {qdt} arena {adt} Sq40 n_log16 L36 layer17")

    # prefill flash: Sq = 200 not a multiple of the 64-row q tile, GQA 4,
    # causal, sliding window, bidirectional, q suffix of longer keys
    for dt, tol, why, sq, skv, causal, window in [
            (bf16, 2e-2, "bf16 output rounding", 200, 200, True, None),
            (f32, 2e-5, "f32; summation order", 200, 200, True, None),
            (f32, 2e-5, "f32; summation order", 200, 200, True, 64),
            (f32, 2e-5, "f32; summation order", 200, 200, False, None),
            (f32, 2e-5, "f32; summation order", 72, 200, True, None)]:
        q = torch.randn((2, sq, HQ, DH), generator=gen, device=dev).to(dt)
        k = torch.randn((2, skv, HKV, DH), generator=gen, device=dev).to(dt)
        v = torch.randn((2, skv, HKV, DH), generator=gen, device=dev).to(dt)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            window=window).transpose(1, 2)
        torch.cuda.synchronize()
        hold("flash_attention", out, ref, tol, why,
             f"{dt} Sq{sq} Skv{skv} causal={causal} window={window}")

    # ---- timing at the main path's shapes (bf16) ----------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    waves = main_path_prompts()
    lens = [len(p) for p in waves[0]]
    elem = 2

    # prefill: the cold wave's longest bucket, all 8 rows
    S = -(-max(lens) // CHUNK) * CHUNK
    q = torch.randn((SLOTS, S, HQ, DH), generator=gen, device=dev).to(bf16)
    k = torch.randn((SLOTS, S, HKV, DH), generator=gen, device=dev).to(bf16)
    v = torch.randn((SLOTS, S, HKV, DH), generator=gen, device=dev).to(bf16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ke, ve = (x.repeat_interleave(HQ // HKV, dim=1) for x in (kt, vt))
    kern = lambda: flash_attention(q, k, v)  # noqa: E731
    n_bytes = (q.numel() * 2 + k.numel() * 2) * elem
    n_ops = 4 * DH * HQ * SLOTS * S * (S + 1) // 2
    kernels["flash_attention"].update(
        shape=f"B{SLOTS} S{S} Hq{HQ} Hkv{HKV} Dh{DH} bf16 causal",
        ms=time_ms(kern, flush=flush),
        plain_ms=time_ms(lambda: attention_ref(qt, kt, vt), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, is_causal=True), flush=flush),
        **bound(n_bytes, n_ops, bf16))

    # paged extend: the warm wave's suffixes behind the 64-token prefix
    suffix = [len(p) - SHARED for p in waves[1]]
    S = -(-max(suffix) // CHUNK) * CHUNK
    n_log = min(pow2(-(-max(len(p) for p in waves[1]) // PAGE)),
                MAX_LEN // PAGE)
    pos = [SHARED] * SLOTS
    a = build_arena(gen, [SHARED + S] * SLOTS, n_log, bf16, dev)
    ps = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn((SLOTS, S, HQ, DH), generator=gen, device=dev).to(bf16)
    args = (a["k"], a["v"], a["slot_pos"], a["block_table"], ps, LAYER)
    kd, vd, spd = gather_pages_ref(a["k"], a["v"], a["slot_pos"],
                                   a["block_table"], LAYER)
    kd, vd = (x.transpose(1, 2).repeat_interleave(HQ // HKV, dim=1)
              .contiguous() for x in (kd, vd))
    q_pos = ps[:, None] + torch.arange(S, device=dev)[None]
    mask = ((spd[:, None, :] >= 0) & (spd[:, None, :] <= q_pos[:, :, None])
            )[:, None]
    qt = q.transpose(1, 2).contiguous()
    n_slots = pages_read([SHARED + S] * SLOTS, n_log) * PAGE
    n_bytes = 2 * q.numel() * elem + n_slots * (2 * HKV * DH * elem + 4)
    n_ops = 4 * DH * HQ * SLOTS * sum(SHARED + i + 1 for i in range(S))
    kernels["paged_extend_attention"].update(
        shape=f"B{SLOTS} S{S} pos{SHARED} n_log{n_log} P{PAGE} L{LAYERS} bf16",
        ms=time_ms(lambda: paged_extend_attention(q, *args), flush=flush),
        plain_ms=time_ms(lambda: paged_extend_attention_ref(qt, *args),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask), flush=flush),
        **bound(n_bytes, n_ops, bf16))

    # paged decode: the cold wave half-way through its 16 new tokens
    kv_lens = [n + MAX_NEW // 2 for n in lens]
    n_log = min(pow2(max(kv_lens) // PAGE + 1), MAX_LEN // PAGE)
    a = build_arena(gen, kv_lens, n_log, bf16, dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.randn((SLOTS, 1, HQ, DH), generator=gen, device=dev).to(bf16)
    args = (a["k"], a["v"], a["slot_pos"], a["block_table"], kl, LAYER)
    kd, vd, spd = gather_pages_ref(a["k"], a["v"], a["slot_pos"],
                                   a["block_table"], LAYER)
    kd, vd = (x.transpose(1, 2).repeat_interleave(HQ // HKV, dim=1)
              .contiguous() for x in (kd, vd))
    mask = ((spd >= 0) & (spd < kl[:, None]))[:, None, None]
    qt = q.transpose(1, 2).contiguous()
    n_slots = pages_read(kv_lens, n_log) * PAGE
    n_bytes = 2 * q.numel() * elem + n_slots * (2 * HKV * DH * elem + 4)
    n_ops = 4 * DH * HQ * sum(kv_lens)
    kernels["paged_decode_attention"].update(
        shape=f"B{SLOTS} kv_len{min(kv_lens)}..{max(kv_lens)} n_log{n_log} "
              f"P{PAGE} L{LAYERS} bf16",
        ms=time_ms(lambda: paged_decode_attention(q, *args), flush=flush),
        plain_ms=time_ms(lambda: paged_decode_attention_ref(q[:, 0], *args),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask), flush=flush),
        **bound(n_bytes, n_ops, bf16))
    for name, e in errs.items():
        kernels[name]["max_abs_err"] = e
    for name, rep in kernels.items():
        log(f"  {name:24s} {rep['shape']}: kernel {rep['ms']:.4f} ms, "
            f"plain {rep['plain_ms']:.4f} ms, library {rep['library_ms']:.4f}"
            f" ms, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")


def bound(n_bytes: int, n_ops: int, dtype) -> dict:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "operations": n_ops}


# --------------------------------------------------------------------------
# phases 1 and 2: the card, the toolchain, the kernel build
# --------------------------------------------------------------------------
def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    name_limit = card()
    log(f"[1] card: {name_limit}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name_limit


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    lib = _build.library()
    log(f"[2] kernels ready in {time.monotonic() - t0:.1f} s "
        f"({'built' if _build.build_seconds is not None else 'cached'}: "
        f"{lib._name})")
    for line in (_build.BUILD_DIR / "ptxas.log").read_text().splitlines():
        if "registers" in line or "bytes stack" in line or "==" in line:
            log(f"[2]   {line.strip()}")


# --------------------------------------------------------------------------
# phase 4: the port's batcher on the card == on the CPU (float32, smoke)
# --------------------------------------------------------------------------
def phase_parity(dev):
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.param import params_from_numpy, tree_map
    from repro_torch.serve.batcher import ContinuousBatcher, Request

    model = Model(smoke_config(get_arch("qwen3-4b")).replace(dtype="float32"))
    ref_params = model.init(torch.Generator().manual_seed(0), device="cpu")
    host = tree_map(lambda t: t.numpy(), ref_params)
    rng = np.random.default_rng(4)      # prompts with varied greedy tokens
    shared = rng.integers(1, model.cfg.vocab, size=20).astype(np.int32)
    waves = [[np.concatenate([shared, rng.integers(1, model.cfg.vocab,
                                                   size=n).astype(np.int32)])
              for n in lens] for lens in ([3, 9, 5], [6, 2])]
    outs = {}
    for device in ("cpu", dev):
        params = params_from_numpy(host, dtype=torch.float32, device=device)
        bat = ContinuousBatcher(model, params, batch_slots=2, max_len=64,
                                prefill_chunk=8, page_size=8, device=device)
        rid = 0
        for wave in waves:              # wave 2 hits wave 1's 16-token prefix
            for p in wave:
                bat.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
                rid += 1
            bat.run_until_drained()
        outs[str(device)] = ({r.rid: r.output for r in bat.done},
                             bat.pool.prefix_hit_tokens)
    (cpu, cpu_hits), (card_, card_hits) = outs["cpu"], outs[str(dev)]
    log(f"[4] smoke f32 greedy tokens, cpu {cpu}")
    log(f"[4] smoke f32 greedy tokens, {dev} {card_}")
    if card_ != cpu or card_hits != cpu_hits or not card_hits:
        raise AssertionError(f"card tokens differ from cpu: {card_} vs {cpu} "
                             f"(prefix hits {card_hits} vs {cpu_hits})")
    log(f"[4] identical on {dev} (kernels) and cpu (plain versions), cold "
        f"and warm ({card_hits} prefix-hit tokens)")


# --------------------------------------------------------------------------
# phase 5: the main path at full width
# --------------------------------------------------------------------------
def phase_main_path(dev, name_limit: str) -> dict:
    """Full-width qwen3-4b (bf16, random weights from a seeded generator on
    the card) behind the batcher: two waves of 8 requests, the second
    sharing a 64-token prefix with the first (paged extend).  Returns the
    launches of each kernel in this run and the end-to-end numbers."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.models.model import Model
    from repro_torch.serve.batcher import ContinuousBatcher, Request

    cfg = get_arch("qwen3-4b")
    model = Model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    log(f"[5] {cfg.name} full width: {model.n_params() / 1e9:.3f} B params "
        f"({model.n_params() * 2 / 1e9:.2f} GB bf16), {cfg.num_layers} "
        f"layers, init {time.monotonic() - t0:.1f} s")

    def batcher():
        return ContinuousBatcher(model, params, batch_slots=SLOTS,
                                 max_len=MAX_LEN, page_size=PAGE,
                                 prefill_chunk=CHUNK, device=dev)

    # warm-up on a separate batcher (library handles, allocator pools)
    warm = batcher()
    warm.submit(Request(rid=-1, prompt=main_path_prompts(1)[0][0],
                        max_new_tokens=2))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()

    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention)
    bat = batcher()
    for fn in counters:
        fn.launches = 0
    reqs, step_s = [], []
    t_start = time.monotonic()
    for w, wave in enumerate(main_path_prompts()):
        for i, p in enumerate(wave):
            req = Request(rid=w * SLOTS + i, prompt=p,
                          max_new_tokens=MAX_NEW)
            reqs.append(req)
            bat.submit(req)
        while bat.queue or any(r is not None for r in bat.slot_req):
            before = (bat.prefill_invocations, bat.decode_invocations)
            t = time.monotonic()
            bat.step()
            if bat.prefill_invocations == before[0] and \
                    bat.decode_invocations > before[1]:
                step_s.append(time.monotonic() - t)
    torch.cuda.synchronize()
    wall = time.monotonic() - t_start
    launches = {fn.__name__: fn.launches for fn in counters}
    decode_steps = bat.decode_invocations

    # the main path went through all three kernels, every layer
    L = cfg.num_layers
    bad = [r.rid for r in reqs if len(r.output) != MAX_NEW
           or not all(0 <= t < cfg.vocab for t in r.output)]
    if bad:
        raise AssertionError(f"requests {bad} did not finish with {MAX_NEW} "
                             "in-vocab tokens")
    check_launches(launches, L, decode_steps)
    pool = bat.pool
    held = pool.pages_in_use - pool.evictable_pages()
    if held or any(n.refs for n in pool.tree._walk()):
        raise AssertionError(f"{held} pool pages still held after the drain")
    if pool.prefix_hit_tokens < SLOTS * SHARED:
        raise AssertionError(f"wave 2 hit only {pool.prefix_hit_tokens} "
                             "prefix tokens")
    ttft = sorted(r.ttft for r in reqs)
    toks = sum(len(r.output) for r in reqs)
    e2e = {"tokens_per_s": toks / wall, "ttft_p50_s": float(np.median(ttft)),
           "decode_step_s": float(np.median(step_s)), "wall_s": wall,
           "tokens": toks, "decode_steps": decode_steps,
           "prefill_invocations": bat.prefill_invocations,
           "prefix_hit_tokens": pool.prefix_hit_tokens,
           "launches": launches}
    log(f"[5] {len(reqs)} requests x {MAX_NEW} tokens, {decode_steps} decode "
        f"steps, {bat.prefill_invocations} prefill invocations, "
        f"{pool.prefix_hit_tokens} prefix-hit tokens; launches {launches}")
    log(f"[5] {toks / wall:.1f} tokens/s, TTFT p50 "
        f"{e2e['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
        f"{e2e['decode_step_s'] * 1e3:.2f} ms ({name_limit})")
    return e2e


def check_launches(launches: dict, n_layers: int, decode_steps: int):
    """Every kernel of the path launched; paged decode once per layer per
    decode step."""
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    if launches["paged_decode_attention"] != n_layers * decode_steps:
        raise AssertionError(f"paged decode launches {launches} != "
                             f"{n_layers} x {decode_steps} decode steps")


KERNELS = {
    "flash_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36"},
    "paged_extend_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:142"},
    "paged_decode_attention": {
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:134"},
}


def main() -> int:
    name_limit = phase_env()
    dev = torch.device("cuda")
    phase_build()
    kernels = {name: dict(meta) for name, meta in KERNELS.items()}
    log("[3] kernels against their plain versions on the card")
    check_kernels(dev, kernels)
    phase_parity(dev)
    e2e = phase_main_path(dev, name_limit)
    rows = []
    for name, rep in kernels.items():
        rows.append({"name": name, "route": "cuda", "source": rep["source"],
                     "replaces": rep["replaces"],
                     "launches": e2e["launches"][name],
                     "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                     "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                     "bound_by": rep["bound_by"],
                     "library_ms": rep["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(name_limit, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
