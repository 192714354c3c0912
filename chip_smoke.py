"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, checks that the
port's batcher gives the same greedy tokens on the card as on the CPU
(qwen3-4b, deepseek-moe-16b and mixtral-8x7b at smoke size, on the paged,
dense, token-at-a-time and rolling-window paths), then serves at full
width, with random weights from a seed:

* qwen3-4b on the paged pool (prefill, paged extend, paged decode);
* qwen3-4b on the dense per-slot cache (dense decode), then token at a
  time on the paged pool;
* deepseek-moe-16b on the paged pool (the grouped GEMM in every MoE
  layer).

Prints each phase's wall time, one JSON line of kernel measurements, the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Any failed phase raises and the script exits
non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
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
# deepseek-moe-16b's routed experts: count, d_model, expert width
MOE_E, MOE_D, MOE_F = 64, 2048, 1408


def log(msg: str):
    print(msg, flush=True)


@contextlib.contextmanager
def timed(tag: str):
    t0 = time.monotonic()
    yield
    log(f"[{tag}] phase wall {time.monotonic() - t0:.1f} s")


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


def main_path_prompts(seed: int = 0, vocab: int = 151936):
    """The two waves of the main path: 8 prompts each, every prompt a
    64-token shared prefix plus its own tail of 8..64 tokens."""
    rng = np.random.default_rng(seed)
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

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref,
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
    from repro_torch.kernels.moe_gmm.ops import gmm
    from repro_torch.kernels.moe_gmm.ref import gmm_ref
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

    # dense decode: the DECODE_CASES of tests/test_kernels.py, then the
    # main path's heads over S = 500 (not a multiple of the 32-slot key
    # tile), in f32 and bf16
    for b, hq, hkv, s_c, dh, dt in [
            (2, 8, 2, 512, 64, f32), (4, 4, 4, 256, 128, bf16),
            (1, 16, 2, 1024, 64, bf16), (3, 2, 1, 128, 32, f32),
            (8, HQ, HKV, 500, DH, f32), (8, HQ, HKV, 500, DH, bf16)]:
        tol, why = ((2e-2, "bf16 output rounding") if dt == bf16
                    else (2e-5, "f32; summation order"))
        q = torch.randn((b, 1, hq, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s_c, hkv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s_c, hkv, dh), generator=gen, device=dev).to(dt)
        kl = (torch.arange(b, dtype=torch.int32, device=dev) * 37
              + s_c // 3) % s_c + 1
        out = decode_attention(q, k, v, kl)
        ref = decode_attention_ref(q[:, 0], k, v, kl)[:, None]
        torch.cuda.synchronize()
        hold("decode_attention", out, ref, tol, why,
             f"{dt} B{b} Hq{hq} Hkv{hkv} S{s_c} Dh{dh}")
    # a rolling buffer: 48 slots (not a multiple of the key tile) holding
    # the last 48 positions at pos % 48, an empty slot, a 40-token window
    kl = torch.tensor([130, 48, 20, 300], dtype=torch.int32, device=dev)
    sp = torch.full((4, 48), -1, dtype=torch.int32, device=dev)
    for b, n in enumerate(kl.tolist()):
        p = torch.arange(max(n - 48, 0), n, dtype=torch.int32, device=dev)
        sp[b, (p % 48).long()] = p
    sp[1, 5] = -1
    for dt, tol, why in [(f32, 2e-5, "f32; summation order"),
                         (bf16, 2e-2, "bf16 output rounding")]:
        q = torch.randn((4, 1, HQ, DH), generator=gen, device=dev).to(dt)
        k = torch.randn((4, 48, HKV, DH), generator=gen, device=dev).to(dt)
        v = torch.randn((4, 48, HKV, DH), generator=gen, device=dev).to(dt)
        out = decode_attention(q, k, v, kl, slot_pos=sp, window=40)
        ref = decode_attention_ref(q[:, 0], k, v, kl, slot_pos=sp,
                                   window=40)[:, None]
        torch.cuda.synchronize()
        hold("decode_attention", out, ref, tol, why,
             f"{dt} rolling S48 window40 slot_pos wrapped")

    # grouped GEMM: the counts sweep of tests/test_kernels.py (all-zero
    # and all-full included), then deepseek-moe-16b's decode (C 8) and
    # 1024-token prefill (C 192) shapes, D 2048, F 1408, then C, D and F
    # off every tile with F not a multiple of the 8-wide weight vectors
    # (the element-wise loads), in bf16 and f32
    for e_, c_, d_, f_, counts in [
            (8, 256, 128, 256, [0, 5, 128, 256, 129, 200, 1, 64]),
            (8, 256, 128, 256, [0] * 8), (8, 256, 128, 256, [256] * 8),
            (MOE_E, 8, MOE_D, MOE_F, None), (MOE_E, 192, MOE_D, MOE_F, None),
            (4, 40, 100, 44, [40, 0, 33, 1])]:
        for dt, tol, why in [
                (bf16, 2e-2, "bf16 output rounding"),
                (f32, 1e-4, "f32; up to 2048-term sums in another order")]:
            x = torch.randn((e_, c_, d_), generator=gen, device=dev).to(dt)
            w = (torch.randn((e_, d_, f_), generator=gen, device=dev)
                 * 0.05).to(dt)
            cnt = (torch.tensor(counts, dtype=torch.int32, device=dev)
                   if counts is not None else routed_counts(gen, dev, c_))
            out = gmm(x, w, cnt)
            ref = gmm_ref(x, w, cnt)
            torch.cuda.synchronize()
            pad = torch.arange(c_, device=dev)[None] >= cnt[:, None]
            if out[pad].any():
                raise AssertionError("gmm: a row past counts is not zero")
            hold("gmm", out, ref, tol, why,
                 f"{dt} E{e_} C{c_} D{d_} F{f_} "
                 f"counts {'given' if counts else 'routed'}")

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
    # dense decode: the main path's 8 rows over their 512-slot dense cache,
    # half-way through the cold wave's 16 new tokens (the kernel stops each
    # row's key walk at kv_len: a non-rolling cache passes no slot_pos)
    k = torch.randn((SLOTS, MAX_LEN, HKV, DH), generator=gen,
                    device=dev).to(bf16)
    v = torch.randn((SLOTS, MAX_LEN, HKV, DH), generator=gen,
                    device=dev).to(bf16)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.randn((SLOTS, 1, HQ, DH), generator=gen, device=dev).to(bf16)
    ke, ve = (x.transpose(1, 2).repeat_interleave(HQ // HKV, dim=1)
              .contiguous() for x in (k, v))
    mask = (torch.arange(MAX_LEN, device=dev)[None] < kl[:, None]
            )[:, None, None]
    qt = q.transpose(1, 2).contiguous()
    n_bytes = (2 * q.numel() * elem + 4 * SLOTS
               + sum(kv_lens) * 2 * HKV * DH * elem)
    n_ops = 4 * DH * HQ * sum(kv_lens)
    kernels["decode_attention"].update(
        shape=f"B{SLOTS} S{MAX_LEN} kv_len{min(kv_lens)}..{max(kv_lens)} "
              f"Hq{HQ} Hkv{HKV} Dh{DH} bf16",
        ms=time_ms(lambda: decode_attention(q, k, v, kl), flush=flush),
        plain_ms=time_ms(lambda: decode_attention_ref(q[:, 0], k, v, kl),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, ke, ve, attn_mask=mask), flush=flush),
        **bound(n_bytes, n_ops, bf16))

    # grouped GEMM: one deepseek-moe-16b decode call (8 tokens routed
    # top-6 over 64 experts, C 8), and the 1024-token prefill call (C 192)
    for c_, tag in ((8, "decode"), (192, "prefill")):
        x = torch.randn((MOE_E, c_, MOE_D), generator=gen, device=dev).to(bf16)
        w = (torch.randn((MOE_E, MOE_D, MOE_F), generator=gen, device=dev)
             * 0.05).to(bf16)
        cnt = routed_counts(gen, dev, c_)
        busy = int((cnt > 0).sum())
        rows = int(cnt.sum())
        n_bytes = (busy * MOE_D * MOE_F * elem + rows * MOE_D * elem
                   + MOE_E * c_ * MOE_F * elem + 4 * MOE_E)
        n_ops = 2 * rows * MOE_D * MOE_F
        rep = dict(
            shape=f"E{MOE_E} C{c_} D{MOE_D} F{MOE_F} bf16, {busy} experts "
                  f"busy, {rows} rows",
            ms=time_ms(lambda: gmm(x, w, cnt), flush=flush),
            plain_ms=time_ms(lambda: gmm_ref(x, w, cnt), flush=flush),
            library_ms=time_ms(lambda: torch.bmm(x, w), flush=flush),
            **bound(n_bytes, n_ops, bf16))
        if tag == "decode":
            kernels["gmm"].update(rep)
        else:
            log(f"  gmm at the prefill shape {rep['shape']}: kernel "
                f"{rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms, "
                f"library {rep['library_ms']:.4f} ms, bound "
                f"{rep['bound_ms']:.4f} ms ({rep['bound_by']})")
    for name, e in errs.items():
        kernels[name]["max_abs_err"] = e
    for name, rep in kernels.items():
        log(f"  {name:24s} {rep['shape']}: kernel {rep['ms']:.4f} ms, "
            f"plain {rep['plain_ms']:.4f} ms, library {rep['library_ms']:.4f}"
            f" ms, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")


def routed_counts(gen, dev, capacity: int):
    """Per-expert token counts of a top-6 routing over the 64 experts of
    deepseek-moe-16b: ``capacity`` tokens at decode (8: dropless) or the
    1024 tokens behind a capacity of 192 at prefill."""
    tokens = capacity if capacity <= 64 else 1024
    scores = torch.rand((tokens, MOE_E), generator=gen, device=dev)
    topi = scores.topk(6, dim=-1).indices.reshape(-1)
    return torch.bincount(topi, minlength=MOE_E).clamp(max=capacity).to(
        torch.int32)


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
# (name, arch, batcher options, weight seed, prompt seed, waves of prompt
# tail lengths behind a 20-token shared prefix); seeds under which the
# greedy tokens vary, so a mismatch cannot hide in a constant stream
PARITY = [
    ("qwen3-4b paged, cold and warm", "qwen3-4b",
     dict(max_len=64, prefill_chunk=8), 0, 4, ([3, 9, 5], [6, 2])),
    ("deepseek-moe-16b paged, cold and warm", "deepseek-moe-16b",
     dict(max_len=64, prefill_chunk=8), 1, 4, ([3, 9, 5], [6, 2])),
    ("qwen3-4b dense cache (kv_pool=None)", "qwen3-4b",
     dict(max_len=64, prefill_chunk=8, kv_pool=None), 0, 4,
     ([3, 9, 5], [6, 2])),
    ("qwen3-4b token at a time (prefill_chunk=None)", "qwen3-4b",
     dict(max_len=64, prefill_chunk=None), 0, 4, ([3, 9, 5], [6, 2])),
    ("mixtral-8x7b rolling window 64 < max_len 128", "mixtral-8x7b",
     dict(max_len=128, prefill_chunk=8), 0, 5, ([60, 45], [70])),
]


def parity_run(dev, arch, opts, weight_seed, prompt_seed, waves):
    """The same smoke model, weights and prompts through the port's
    batcher on the CPU (plain versions) and on the card (kernels).
    Returns ({device: {rid: tokens}}, {device: prefix-hit tokens})."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.param import params_from_numpy, tree_map
    from repro_torch.serve.batcher import ContinuousBatcher, Request

    model = Model(smoke_config(get_arch(arch)).replace(dtype="float32"))
    ref_params = model.init(torch.Generator().manual_seed(weight_seed),
                            device="cpu")
    host = tree_map(lambda t: t.numpy(), ref_params)
    rng = np.random.default_rng(prompt_seed)
    shared = rng.integers(1, model.cfg.vocab, size=20).astype(np.int32)
    prompts = [[np.concatenate([shared, rng.integers(
        1, model.cfg.vocab, size=n).astype(np.int32)]) for n in lens]
        for lens in waves]
    toks, hits = {}, {}
    for device in ("cpu", dev):
        params = params_from_numpy(host, dtype=torch.float32, device=device,
                                   specs=model.param_specs())
        bat = ContinuousBatcher(model, params, batch_slots=2, page_size=8,
                                device=device, **opts)
        rid = 0
        for wave in prompts:            # wave 2 hits wave 1's prefix
            for p in wave:
                bat.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
                rid += 1
            bat.run_until_drained()
        toks[str(device)] = {r.rid: r.output for r in bat.done}
        hits[str(device)] = bat.pool.prefix_hit_tokens if bat.pool else 0
    return toks, hits


def phase_parity(dev):
    for name, arch, opts, wseed, pseed, waves in PARITY:
        toks, hits = parity_run(dev, arch, opts, wseed, pseed, waves)
        cpu, card_ = toks["cpu"], toks[str(dev)]
        log(f"[4] {name}: cpu {cpu}")
        log(f"[4] {name}: {dev} {card_}")
        if card_ != cpu or hits["cpu"] != hits[str(dev)]:
            raise AssertionError(f"{name}: card tokens differ from cpu: "
                                 f"{card_} vs {cpu} (prefix hits {hits})")
        if opts.get("kv_pool", "auto") == "auto" and opts["prefill_chunk"] \
                and arch != "mixtral-8x7b" and not hits["cpu"]:
            raise AssertionError(f"{name}: no prefix hit in wave 2")
        log(f"[4] {name}: identical on {dev} (kernels) and cpu (plain "
            f"versions), {hits['cpu']} prefix-hit tokens")


# --------------------------------------------------------------------------
# phases 5-7: the main paths at full width
# --------------------------------------------------------------------------
def full_width(dev, arch: str, tag: str):
    """(model, params) of ``arch`` at full width in bf16, random weights
    drawn from a seeded generator on the card."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    cfg = get_arch(arch)
    model = Model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name} full width: {model.n_params() / 1e9:.3f} B "
        f"params ({model.n_params() * 2 / 1e9:.2f} GB bf16), "
        f"{cfg.num_layers} layers, init {time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    return model, params


def serve(bat, waves, counters, *, max_new=MAX_NEW):
    """Drive ``bat`` through ``waves`` of prompts (draining between
    waves) with every launch counter set to 0 just before.  Returns the
    requests, the launches of each counter, the wall time and the wall
    times of the steps that only decoded."""
    from repro_torch.serve.batcher import Request
    for fn in counters:
        fn.launches = 0
    reqs, step_s = [], []
    t_start = time.monotonic()
    for wave in waves:
        for p in wave:
            req = Request(rid=len(reqs), prompt=p, max_new_tokens=max_new)
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
    return reqs, {fn.__name__: fn.launches for fn in counters}, wall, step_s


def report(tag, name_limit, bat, reqs, wall, step_s, launches, vocab,
           max_new=MAX_NEW) -> dict:
    """Check every request finished with in-vocab tokens and print the
    end-to-end numbers."""
    bad = [r.rid for r in reqs if len(r.output) != max_new
           or not all(0 <= t < vocab for t in r.output)]
    if bad:
        raise AssertionError(f"requests {bad} did not finish with {max_new} "
                             "in-vocab tokens")
    ttft = sorted(r.ttft for r in reqs)
    toks = sum(len(r.output) for r in reqs)
    e2e = {"tokens_per_s": toks / wall, "ttft_p50_s": float(np.median(ttft)),
           "decode_step_s": float(np.median(step_s)), "wall_s": wall,
           "tokens": toks, "decode_steps": bat.decode_invocations,
           "prefill_invocations": bat.prefill_invocations,
           "launches": launches}
    log(f"[{tag}] {len(reqs)} requests x {max_new} tokens, "
        f"{bat.decode_invocations} decode steps, {bat.prefill_invocations} "
        f"prefill invocations; launches {launches}")
    log(f"[{tag}] {toks / wall:.1f} tokens/s, TTFT p50 "
        f"{e2e['ttft_p50_s'] * 1e3:.1f} ms, decode step p50 "
        f"{e2e['decode_step_s'] * 1e3:.2f} ms ({name_limit})")
    return e2e


def check_drained(pool, min_hits: int):
    held = pool.pages_in_use - pool.evictable_pages()
    if held or any(n.refs for n in pool.tree._walk()):
        raise AssertionError(f"{held} pool pages still held after the drain")
    if pool.prefix_hit_tokens < min_hits:
        raise AssertionError(f"wave 2 hit only {pool.prefix_hit_tokens} "
                             "prefix tokens")


def expect(what: str, got: int, want: int):
    if got != want:
        raise AssertionError(f"{what}: {got} launches, expected {want}")


def warm_up(bat_fn, vocab: int):
    """One short request on a separate batcher (library handles, allocator
    pools), before the counted run."""
    from repro_torch.serve.batcher import Request
    warm = bat_fn()
    warm.submit(Request(rid=-1, prompt=main_path_prompts(1, vocab)[0][0],
                        max_new_tokens=2))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()


def phase_main_path(dev, name_limit: str, model, params) -> dict:
    """Full-width qwen3-4b behind the batcher on the paged pool: two waves
    of 8 requests, the second sharing a 64-token prefix with the first
    (paged extend).  Returns the launches of each kernel in this run and
    the end-to-end numbers."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.serve.batcher import ContinuousBatcher

    cfg = model.cfg

    def batcher():
        return ContinuousBatcher(model, params, batch_slots=SLOTS,
                                 max_len=MAX_LEN, page_size=PAGE,
                                 prefill_chunk=CHUNK, device=dev)

    warm_up(batcher, cfg.vocab)
    bat = batcher()
    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention)
    reqs, launches, wall, step_s = serve(bat, main_path_prompts(), counters)
    # the main path went through all three kernels, every layer
    L = cfg.num_layers
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    expect("paged decode", launches["paged_decode_attention"],
           L * bat.decode_invocations)
    check_drained(bat.pool, SLOTS * SHARED)
    e2e = report(5, name_limit, bat, reqs, wall, step_s, launches, cfg.vocab)
    log(f"[5] {bat.pool.prefix_hit_tokens} prefix-hit tokens")
    return e2e


def phase_dense(dev, name_limit: str, model, params) -> dict:
    """Full-width qwen3-4b on the dense per-slot cache (kv_pool=None): the
    cold wave's 8 requests, chunked prefill, every decode step through the
    dense decode kernel; then 2 short requests token at a time
    (prefill_chunk=None) on the paged pool."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.serve.batcher import ContinuousBatcher

    cfg = model.cfg
    L = cfg.num_layers

    def batcher():
        return ContinuousBatcher(model, params, batch_slots=SLOTS,
                                 max_len=MAX_LEN, prefill_chunk=CHUNK,
                                 kv_pool=None, device=dev)

    warm_up(batcher, cfg.vocab)
    bat = batcher()
    counters = (decode_attention, paged_decode_attention, flash_attention)
    reqs, launches, wall, step_s = serve(bat, main_path_prompts()[:1],
                                         counters)
    expect("dense decode", launches["decode_attention"],
           L * bat.decode_invocations)
    expect("paged decode on the dense cache",
           launches["paged_decode_attention"], 0)
    expect("prefill", launches["flash_attention"],
           L * bat.prefill_invocations)
    e2e = report(6, name_limit, bat, reqs, wall, step_s, launches, cfg.vocab)

    tat = ContinuousBatcher(model, params, batch_slots=2, max_len=MAX_LEN,
                            page_size=PAGE, prefill_chunk=None, device=dev)
    short = [main_path_prompts(2, cfg.vocab)[0][i][:12] for i in range(2)]
    reqs, tl, wall, step_s = serve(tat, [short], counters, max_new=4)
    expect("token at a time: prefill", tl["flash_attention"], 0)
    expect("token at a time: paged decode", tl["paged_decode_attention"],
           L * tat.decode_invocations)
    expect("token at a time: dense decode", tl["decode_attention"], 0)
    check_drained(tat.pool, 0)
    e2e["token_at_a_time"] = report("6b", name_limit, tat, reqs, wall,
                                    step_s, tl, cfg.vocab, max_new=4)
    return e2e


def phase_moe(dev, name_limit: str) -> dict:
    """Full-width deepseek-moe-16b behind the batcher on the paged pool,
    the two waves of phase 5: every MoE layer runs the grouped GEMM for
    its gate, up and down products, in every prefill, extend and decode
    invocation."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.kernels.moe_gmm.ops import gmm
    from repro_torch.serve.batcher import ContinuousBatcher

    model, params = full_width(dev, "deepseek-moe-16b", 7)
    cfg = model.cfg
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers

    def batcher():
        return ContinuousBatcher(model, params, batch_slots=SLOTS,
                                 max_len=MAX_LEN, page_size=PAGE,
                                 prefill_chunk=CHUNK, device=dev)

    warm_up(batcher, cfg.vocab)
    bat = batcher()
    counters = (gmm, flash_attention, paged_extend_attention,
                paged_decode_attention)
    reqs, launches, wall, step_s = serve(
        bat, main_path_prompts(0, cfg.vocab), counters)
    invocations = bat.decode_invocations + bat.prefill_invocations
    expect("grouped GEMM (3 per MoE layer per invocation)", launches["gmm"],
           3 * n_moe * invocations)
    expect("paged decode", launches["paged_decode_attention"],
           cfg.num_layers * bat.decode_invocations)
    expect("prefill + paged extend", launches["flash_attention"]
           + launches["paged_extend_attention"],
           cfg.num_layers * bat.prefill_invocations)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    check_drained(bat.pool, SLOTS * SHARED)
    e2e = report(7, name_limit, bat, reqs, wall, step_s, launches, cfg.vocab)
    log(f"[7] {bat.pool.prefix_hit_tokens} prefix-hit tokens, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
    return e2e


KERNELS = {
    "flash_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
        "path": 5},
    "paged_extend_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:142",
        "path": 5},
    "paged_decode_attention": {
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:134",
        "path": 5},
    "decode_attention": {
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:48",
        "path": 6},
    "gmm": {
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:25",
        "path": 7},
}


def main() -> int:
    t_all = time.monotonic()
    name_limit = phase_env()
    dev = torch.device("cuda")
    with timed(2):
        phase_build()
    kernels = {name: dict(meta) for name, meta in KERNELS.items()}
    log("[3] kernels against their plain versions on the card")
    with timed(3):
        check_kernels(dev, kernels)
    with timed(4):
        phase_parity(dev)
    runs = {}
    with timed(5):
        model, params = full_width(dev, "qwen3-4b", 5)
        runs[5] = phase_main_path(dev, name_limit, model, params)
    with timed(6):
        runs[6] = phase_dense(dev, name_limit, model, params)
    del model, params               # make room for deepseek-moe-16b
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed(7):
        runs[7] = phase_moe(dev, name_limit)
    rows = []
    for name, rep in kernels.items():
        rows.append({"name": name, "route": "cuda", "source": rep["source"],
                     "replaces": rep["replaces"],
                     "launches": runs[rep["path"]]["launches"][name],
                     "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                     "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                     "bound_by": rep["bound_by"],
                     "library_ms": rep["library_ms"]})
    log(f"[all] wall {time.monotonic() - t_all:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(name_limit, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
