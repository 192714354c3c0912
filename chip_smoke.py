"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, trains full-width
qwen3-4b (phases 13 and 13b, below), checks that the
port's batcher gives the same greedy tokens on the card as on the CPU
(qwen3-4b, deepseek-moe-16b, mixtral-8x7b, mamba2-2.7b, zamba2-2.7b and
seamless-m4t-large-v2 at smoke size, on the paged, dense,
token-at-a-time, rolling-window and snapshot paths), then serves at full
width, with random weights from a seed:

* qwen3-4b on the paged pool (prefill, paged extend, paged decode);
* qwen3-4b on the dense per-slot cache (dense decode), then token at a
  time on the paged pool;
* deepseek-moe-16b on the paged pool (the grouped GEMM in every MoE
  layer);
* mamba2-2.7b (ssm) and zamba2-2.7b (hybrid) on the snapshot pool: the
  SSD scan (one launch of ``ops.ssd``) in every Mamba layer of every
  prefill and suffix extend, a warm wave restored from interned
  chunk-boundary states; for zamba2 the attention kernels at head dim 80;
* seamless-m4t-large-v2 (encdec) on the paged pool, requests with source
  features of 96..384 frames (one a wave without): every cold prefill and
  extend encodes its rows' sources in its graph (flash, bidirectional
  under the source-length mask), the decoder's cross-attention runs
  flash under the same mask at prefill and the dense decode kernel over
  the resident cross memory at decode.

bf16 prefill flash attention, bf16 paged extend (over a bf16 or an int8
arena) and bf16 grouped GEMMs take the tensor-core kernels, float32 ones
the CUDA-core kernels; each full-width path checks by
the ``launches_tc`` counters that every launch of the three took the
tensor cores, and phase 4 (float32) that none did (the SSD scan runs on
CUDA cores in float32 in every dtype).  Paged and dense decode
are one kernel that splits each row's keys across a thread-block cluster
in one launch (block-table pages, or a dense cache's live slots); phase 3
also times paged decode at a long context (kv_len 2048-4096), and the
three calls of the encdec path under a key-length mask (the encoder's
flash, cross-attention's flash and dense decode over cross memory) as
rows of their own.  Phase 4 holds the card's greedy tokens to the CPU's
on twelve cases, an int8 paged pool and seamless with sources among
them.

The batcher's steps run as CUDA graphs on the card, one per shape key
(``serve/step_graph.py``): decode by block-table width, the cold prefill
by (padded batch, pad bucket), the paged extend by (padded batch, suffix
bucket, width), the snapshot restore by suffix bucket.  A path's first
call in the process runs eagerly, a key's first visit otherwise captures,
every later visit replays.  Every served path runs two rounds: round 2
has a new shared prefix (its first wave is cold again) and new tokens
with round 1's tail lengths (and on the encdec path new sources with
round 1's lengths), so it meets round 1's keys, and each phase
checks that every round-2 prefill, extend and restore call was a replay,
that no path captured more graphs than it met keys, that the decode steps
replayed, and that every launch count stays exact under replay.  Phase
4's twelve cases run both rounds on the CPU and on the card.  Phases 5-10
print each wave's TTFT p50, the peak memory and the graph pool's size,
then time one decode step of the drained batcher eagerly (the plain step
function on the batcher's own buffers) and replayed, and one prefill a
path (``time_prefill``: cold prefill, paged extend or restore) eagerly,
at a first visit (capture, instantiate, replay) and replayed.

Phase 11 serves full-width qwen3-4b in two cells of one supervisor on
the card (``repro_torch.core``): cell ``a``, with phase 5's weights and
batcher, serves phase 5's round 1 while cell ``b`` serves a wave of its
own, stepped in turns, and must give phase 5's tokens; a daemon tick
under an SLO set below ``a``'s measured TTFT moves a column ``b -> a``
(dropping ``a``'s graphs, moving its epoch on), and ``a``'s round 2,
recaptured at the new epoch, must give phase 5's tokens and prefix hits;
every request ends with a closed span tree in its cell's flight
recorder; a channel carries one request's pages bitwise; destroying
``b`` frees its weights.  It prints the supervisor's verb times, the
decode step with the recorder live and the Chrome trace's size, and its
launches add to the main path's rows of the kernels line.

Phase 12 serves full-width qwen3-4b disaggregated
(``repro_torch.serve.disagg``): a prefill cell and a decode spec of two
replicas joined by a ``kv`` channel, the weights fanned out from
``decode/0`` (phase 5's seed) over array channels; right after round 1's
first pump a spec scales decode to one replica, and the drain migrates
``decode/1``'s prefix pages and hands its in-flight slots to ``decode/0``
over a ``pages`` channel.  Round 1, its second wave again and round 2
must give phase 5's tokens request by request, with no requeue, every
worker prefill and replica step a graph replay; it prints tokens/s, TTFT
by wave, the decode step, the KV handoff's bytes (cold and warm a
request), the fan-out's and the migration's bytes and seconds and the
peak memory, and destroying the cells must free their memory.  Its
launches add to the main path's rows.  Phase 4 also runs the
disaggregated plane at smoke size (qwen3-4b paged with two replicas,
mamba2-2.7b on the snapshot plane, seamless with ragged sources): the
card's tokens equal the CPU's and a colocated batcher's.

Phase 3 also holds flash attention's backward kernel
(``csrc/flash_attention_bwd.cu``) against ``flash_attention_bwd_ref``
through both routes (bf16 on the tensor cores, float32 on CUDA cores)
under every mask the forward takes at head dims 64, 80 and 128, checks
that two calls are bitwise equal, and times both at qwen3-4b's training
shape (rows ``flash_attention_bwd`` and ``flash_attention_bwd_f32``; the
library's time is SDPA's forward + backward less its forward), beside
the forward with its LSE at that shape (row ``flash_attention_train``).
Phase 13 trains full-width qwen3-4b (all 36 layers, random weights from a
seed) for 6 steps through the control plane (``Supervisor.apply`` of a
train cell, ``Cell.train_steps`` on bigram batches, global batch 8 at seq
512 in the config's 2 microbatches): xent must fall, grad norms stay
finite, and every attention layer must launch the flash kernel twice a
microbatch (forward and remat recompute) and the backward kernel once,
on the tensor cores; it prints the step wall p50, tokens/s, MFU, the
step's reckoned bound, the peak memory and one profiled step's largest
kernels and the port's kernels' shares.  Phase 13b, at
smoke size, kills a train cell after an asynchronous checkpoint and
recovers it from the checkpoint (``recover_cell(ckpt_dir=)``): its next
losses must equal an uninterrupted run's bit for bit; float32 train steps
on the card must give the CPU's losses within 1e-5, their backward
launches all on the CUDA-core route; so must float32 smoke
train steps of mamba2-2.7b and zamba2-2.7b through the SSD scan's backward.

Phase 3 also holds the SSD scan's backward kernels
(``csrc/ssd_scan_bwd.cu``) against ``ssd_bwd_ref`` at mamba2's and
zamba2's training microbatch (B 4, S 512, H 80, P 64, state 128 and 64,
bf16 x, B and C: the tensor-core route; float32: the CUDA-core route)
and at smoke shapes (two groups, two P tiles, masks, an initial state,
both routes' span boundaries; bf16 and float32), checks two calls bitwise
equal in both dtypes and times both training shapes (rows
``ssd_scan_bwd`` and ``ssd_scan_bwd_zamba2``) and the float32 CUDA-core
route at both (rows ``ssd_scan_bwd_f32`` and ``ssd_scan_bwd_f32_zamba2``,
each with the kernels of a call, three traced).  Phases
14 and 14b train full-width mamba2-2.7b (64 layers, 6 steps) and
zamba2-2.7b (54 layers and the shared block, 4 steps) as phase 13 trains
qwen3-4b: every Mamba layer launches the scan twice a microbatch (forward
and remat recompute) and its backward once, zamba2's shared block the
flash kernel twice and its backward once, on the tensor cores; each
reports the SSD backward's share of a profiled step.

Phase 3 also holds the grouped GEMM's backward (``ops.gmm_bwd``: dX and
dW in ``csrc/moe_gmm.cu``) against ``gmm_bwd_ref`` at deepseek-moe-16b's
training shapes (E 64, C 240, counts from a top-6 routing of 2048 tokens;
gate and up D 2048 F 1408, down with D and F swapped) and at smoke shapes
(counts of 0, C and between, dimensions off every tile), bf16 and
float32, then the bf16 wgmma route's edges (counts at its m64 and slice
edges, F 1400, operands offset by one element on the element route),
checks the zeros past counts, the route and two calls bitwise equal, and
times dX and dW at both training shapes (rows ``gmm_bwd_dx``,
``gmm_bwd_dw`` at gate/up; the float32 route ``gmm_bwd_f32``) beside
``torch.bmm``.
Phase 15 trains deepseek-moe-16b at its published widths with its depth
cut to 6 of 28 layers (1 dense + 5 MoE; all 28 would need about 262 GB
of training state) for 4 steps as phase 13 trains qwen3-4b: every MoE
layer launches the grouped GEMM six times a microbatch (gate, up, down;
forward and remat recompute) and its backward three times (dX and dW
each), on the tensor cores; it reports MFU at the parameters a token
meets and the shares of the grouped GEMM's forward, dX, dW and the
dispatch ``cumsum`` in a profiled step.  Phase 13b also holds float32
smoke deepseek-moe-16b train steps to the CPU's.

Phase 16 serves full-width qwen3-4b from a serve cell over a zone of two
mesh positions of the card (``Supervisor.apply`` -> ``Cell`` ->
``make_batcher``; ``DeviceGrid.from_flat([dev, dev], 1, 1, 2)`` states
two positions, each ``cuda:0``): phase 5's weights (laid out by the
port's sharding rules: heads, ffn and vocab over ``model``; each
position's arena holds its 4 of the 8 kv heads) and phase 5's two rounds.
The first cold prefill's last-position logits must be within 2e-2 of the
one-position model's; it prints tokens/s, TTFT p50 by wave, the decode
step p50, the peak memory, the graph counters (one CUDA graph a key over
both positions), the collective bytes of each step key, and how many
greedy tokens agree with phase 5's; its launches add to the main path's
rows.  Phase 4 also serves float32 smoke qwen3-4b, deepseek-moe-16b
(experts over ``model``), mamba2-2.7b, zamba2-2.7b and
seamless-m4t-large-v2 (ragged sources) from a two-position cell on the
card: the tokens must equal a one-position cell's.

Phases 16b, 16c and 16d serve full-width mamba2-2.7b, zamba2-2.7b and
seamless-m4t-large-v2 the same way, with phases 8, 9 and 10's weights,
rounds and sources: each Mamba layer over 40 of its 80 SSD heads a
position, its gated norm's sum of squares and its ``out_proj`` each a
``psum``, zamba2's shared block and seamless's encoder, self- and
cross-attention over heads.  Each checks the first cold prefill's logits
against one position's: bf16 within 2e-2 or, where larger, the
one-position bf16 model's own distance from its float32 copy (two bf16
runs of one function agree no better than each agrees with float32), the
two-position bf16 model within 1.25x of that distance from float32, and
float32 copies of both within 1e-4; then that every kernel launched
exactly twice as often as in its one-position phase, equal snapshot counters (16b, 16c),
one CUDA graph a key and round 2 all replays, and prints the same
end-to-end numbers, the greedy tokens' agreement, the peak memory and the
collective bytes a step key; its launches add to its path's rows.

Phases 17a-17e serve all five families at full width (qwen3-4b,
deepseek-moe-16b, mamba2-2.7b, zamba2-2.7b, seamless-m4t-large-v2) from
a cell over a zone of two rows of two positions of the card
(``DeviceGrid.from_flat([dev] * 4, 1, 2, 2)``: (``data`` 2, ``model``
2)), with phases 5, 7, 8, 9 and 10's weights, rounds and sources: the
batch split over ``data`` (4 of the 8 slots a data row), the weights
FSDP over ``data`` (gathered layer by layer in every step), the paged
arena and the snapshot payloads whole on both data rows (the steps'
paged writes all-gathered over ``data`` and mirrored), one host schedule
(one slot table, one pool).  Each makes 16b-16d's checks at four
positions: every kernel launched exactly four times as often as in its
one-position phase, the logits rule (deepseek-moe-16b's float32 copies
at its first 4 layers; its bf16 error over all 28 is printed), equal
snapshot counters, one CUDA graph a key and round 2 all replays, and
prints the same numbers; its launches add to its path's rows.  Phase 4
also serves the five families in float32 from a (2, 2) cell on the card
with four slots (a cold pair whose second row lands in a slot of the
other data row, a warm pair extended across the data rows, a prompt
alone run whole on both): the tokens must equal a one-position cell's on
the CPU.

Phase 16 also decodes at the model level over a dense cache split on
its sequence dim between the two positions (``Model.cache_pspecs``),
with ``sharded_decode`` on (the LSE combine) and off (the cache
all-gathered, then the dense decode kernel per position): every step's
logits within 2e-2 of the one-position model's.

Phases 18a-18d train from a train cell over a zone of positions of the
card (``Supervisor.apply`` -> ``init_train`` -> ``train_steps``, as phases
13-15): 18a qwen3-4b over (``data`` 1, ``model`` 2), 18b qwen3-4b over
(2, 2), 18c mamba2-2.7b over (2, 2) (each position's SSD scan and its
backward over 40 of the 80 heads), 18d deepseek-moe-16b over (2, 2)
under EP (each position 32 of the 64 experts; phase 15's 6 of 28
layers).  Each first holds a float32 cell of its family and mesh at 2
layers and full width to a one-position cell on the card over 2 steps
(losses and grad norms within 1e-5 relative, the params leaf by leaf
within 1e-5 as ||a - b|| / ||b||; a MoE dropless), then trains at full
width on the bigram pipeline at 8 x 512 in the config's 2 microbatches
for 4 steps: the weights FSDP over ``data`` (gathered layer by layer
and their gradients reduce-scattered), TP attention and MLP over
``model``, the batch over ``data``, the vocab-parallel cross entropy,
each gradient psummed over its copies; every kernel exactly P (the
positions) times ``train_launches``; the first step's xent within
``TRAIN_XENT_LIMIT`` and its grad norm within ``TRAIN_GRAD_NORM_LIMIT``
of the one-position phase's (same weights and batch); each step's xent
and grad norm, the step wall p50, tokens/s, MFU, the peak memory (under
76 GB) and a profiled step's device busy (18d's also its collectives'
share of busy).  Their launches add to phases 13-15's rows.

Phase 19a runs phase 12's scenario and rounds over a (1, 2, 3) grid of
the card (``DeviceGrid.from_flat([dev] * 6, 1, 2, 3)``): the prefill
cell and the two decode replicas each one column over two data rows,
(``data`` 2, ``model`` 1), the weights FSDP over ``data`` and fanned out
onto each replica's layout, every payload (KV rows, page stacks, the
drained replica's pages and slots) crossing as its logical tensor into
its destination's layout, the scale-down to one replica after wave 1's
pump.  It first holds the prefill cell's first cold prefill logits to
the one-position model's (2e-2, or the bf16 model's distance from
float32 where larger), then checks 0 requeued, every slot handed off,
every worker prefill and replica step a replay of one graph a key over
its positions, and flash, paged extend and paged decode each exactly
twice phase 12's launches; it prints the fan-out's transfers and logical
bytes, the KV handoff bytes, pages migrated, TTFT p50 by wave, the
decode step p50, tokens/s, the peak memory and the tokens equal to
phase 12's.  Phase 19b serves full-width qwen3-4b on an int8 paged pool
(one float32 scale a page and layer over every kv head), phase 5's
rounds, at one position and then from a cell over (2, 2) of the card
(phase 17a's layout; each page write's scale the ``pmax`` over
``model``): the (2, 2) run's launches exactly 4x the one-position
run's, every position's scale tables and every data row's int8 arena
bitwise equal; it prints the tokens equal to phase 5's and between the
runs, the logits distance and the peak memory beside phases 5 and 17a's.
Phase 3 times the two paged kernels over an int8 arena at the main
path's shapes (rows ``paged_extend_attention_int8``,
``paged_decode_attention_int8``, their launches 19b's, the library
yardstick SDPA over the pages dequantised to bf16 beforehand), and
phase 4 adds two float32 cases on the card against the CPU: the smoke
qwen3-4b (4 kv heads) disaggregated over a (1, 2, 4) grid, a prefill
cell over (2, 2) feeding replicas over (2, 1) scaled from 2 to 1, and
an int8 paged pool over (2, 2).

Phases 20a-20d serve the four registry archs no other phase runs at
full width in bf16 on phase 5's path and traffic (the paged pool, two
rounds of two waves, ``main_path_rounds`` drawn below each arch's
vocab): chameleon-34b (the vlm family: qk-norm, 64 q heads over 8),
deepseek-coder-33b (56 over 8) and qwen2.5-32b (40 over 8, qkv bias) at
full depth, nemotron-4-340b (96 q heads of 192 over 8, a squared-ReLU
MLP) at 4 of its 96 layers (``ARCH_PHASES``).  Each makes phase 5's
checks (paged decode exactly L a decode step, flash and extend on the
tensor cores, the pool drained with every prefix hit, round 2 all
replays), requires the step graphs' counters to equal phase 5's, then
holds one paged decode after a prefill of all but the last token to the
teacher-forced prefill of the whole prompt on 32 prompts (logits within
5e-2, argmax on more than 0.9 of them, ``tests/test_models.py``'s bf16
limits), and prints tokens/s, TTFT by wave, the decode step beside its
byte yardstick (the weights but the embedding table over 3.35 TB/s),
the peak and graph-pool GB and the init seconds.  Phase 3 holds and
times the three attention kernels at each arch's heads at the main
path's shapes (rows ``<kernel>_hq<Hq>_hkv<Hkv>_dh<Dh>``, launched by
that arch's phase), phase 4 serves each arch at its own group and head
dim over one kv head in float32 on the card and the CPU, and phase 13b
trains nemotron-4-340b so (G 12 at head dim 192) with its bf16 first
moment, within 1e-5 of the CPU.

The float32 routes of prefill flash and paged extend (CUDA cores, exact
float32 products) are rows of their own: phase 3 holds them to their
plain versions under every mask, with the LSE (1e-5), at page sizes 1 to
64 with a fully sentinel row and over arena views whose rows do not
start on 16 bytes, requires two calls to be bitwise equal, and times
flash with its LSE at the training shape (row ``flash_attention_f32_train``,
its launches phase 13b's float32 steps) and the extend at row 2's shape
over a float32 and an int8 arena (rows ``paged_extend_attention_f32``
and ``paged_extend_attention_f32_int8``, their launches phase 4's), each
beside one float32 SDPA call; phases 4, 13b and 18a-18d log their
float32 forward launches, none on the tensor cores.

Prints each phase's wall time, one JSON line of kernel measurements, the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Any failed phase raises and the script exits
non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}

# the main path: qwen3-4b attention shapes and the serving configuration
HQ, HKV, DH, PAGE = 32, 8, 128, 16
LAYERS, LAYER = 36, 17
SLOTS, MAX_LEN, CHUNK, MAX_NEW = 8, 512, 32, 16
SHARED, TAIL_LO, TAIL_HI = 64, 8, 64
# deepseek-moe-16b's routed experts: count, d_model, expert width; in
# training (phase 15) a microbatch of 4 x 512 tokens routed top-6 at
# capacity factor 1.25: C = ceil(6 * 2048 * 1.25 / 64)
MOE_E, MOE_D, MOE_F = 64, 2048, 1408
MOE_TRAIN_T, MOE_TRAIN_C = 2048, 240
# mamba2-2.7b's SSD: heads, head dim, state (zamba2-2.7b: state 64), and
# zamba2-2.7b's shared attention: heads (q = kv), head dim
SSD_H, SSD_P, SSD_N, ZAMBA_N = 80, 64, 128, 64
ZAMBA_H, ZAMBA_DH = 32, 80
# snapshot handles of the full-width pools: one payload is 170 MB for
# mamba2-2.7b, so the default (slots + 2) * max_len / page would allow 54 GB
SNAP_PAGES = 64
# seamless-m4t-large-v2's attention (16 heads of 64, MHA) and its sources:
# 96..384 frames of d_model, padded to the memory of source_len(MAX_LEN)
ENC_H, ENC_DH, ENC_D = 16, 64, 1024
FRAMES_LO, FRAMES_HI = 96, 384
# the query lengths cross-attention meets on phase 10: the prompt buckets
# of its cold prefills (72..128 tokens) and extends (8..64)
CROSS_SQ = (128, 96, 64, 32)
# phases 20a-20d: the registry archs no other phase runs, served at full
# width in bf16, at full depth but nemotron-4-340b (682 GB), cut to the
# 4 of its 96 layers that fit beside its 18.9 GB embedding and head:
# (tag, arch, layers or None for all)
ARCH_PHASES = (("20a", "chameleon-34b", None),
               ("20b", "deepseek-coder-33b", None),
               ("20c", "qwen2.5-32b", None),
               ("20d", "nemotron-4-340b", 4))


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
                sentinel_rows=(), hkv=HKV, dh=DH, page=PAGE):
    """Arena (N, P, L, Hkv, Dh) of P = ``page`` in which logical page j of
    row b holds positions [j*P, min((j+1)*P, kv_len)) at every layer;
    unused pages and the clamp target page N-1 stay clean (slot_pos -1).
    Rows listed in ``sentinel_rows`` map no page at all."""
    B = len(kv_lens)
    N = B * n_log + 2
    shape = (N, page, n_layers, hkv, dh)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    sp = torch.full((N, page, n_layers), -1, dtype=torch.int32)
    bt = torch.full((B, n_log), N, dtype=torch.int32)
    nxt = 0
    for b, kl in enumerate(kv_lens):
        if b in sentinel_rows:
            continue
        for j in range(-(-kl // page)):
            fill = min(page, kl - j * page)
            sp[nxt, :fill, :] = (j * page + torch.arange(fill))[:, None]
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


def dequantised(arena) -> tuple:
    """The arena's (k, v) in bf16: an int8 arena's codes times their
    (page, layer) scales, a bf16 arena as it is."""
    if arena["k_scale"] is None:
        return arena["k"], arena["v"]
    return tuple((arena[x].float() * arena[x + "_scale"][
        :, None, :, None, None]).to(torch.bfloat16) for x in ("k", "v"))


def scale_bytes(arena, n_slots: int) -> int:
    """The bytes of the (page, layer) scales a paged call over ``n_slots``
    positions of one layer reads: one float32 for k and one for v a page
    (none for a bf16 arena)."""
    return 0 if arena["k_scale"] is None else 2 * 4 * (n_slots // PAGE)


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


def main_path_rounds(seed: int = 0, vocab: int = 151936):
    """Two rounds of the main path's two waves: round 1 is
    ``main_path_prompts``; round 2 has a new shared prefix and new tokens
    with round 1's tail lengths, so its first wave is cold again and it
    meets round 1's keys."""
    first = main_path_prompts(seed, vocab)
    rng = np.random.default_rng(seed + 1000)
    shared = rng.integers(1, vocab, size=SHARED).astype(np.int32)
    second = [[np.concatenate([shared, rng.integers(
        1, vocab, size=len(p) - SHARED).astype(np.int32)]) for p in wave]
        for wave in first]
    return first + second


def encdec_frames(seed: int = 0) -> list:
    """The source lengths (frames) of one wave of the encdec path."""
    rng = np.random.default_rng(seed + 500)
    return [int(n) for n in rng.integers(FRAMES_LO, FRAMES_HI + 1,
                                         size=SLOTS)]


def encdec_sources(seed: int = 0) -> list:
    """Sources of the four waves of ``main_path_rounds`` on the encdec
    path: each round's first wave gets (frames, d_model) normal features
    of ``encdec_frames`` lengths, its last request none (``src=None``);
    the round's second wave reuses them request by request (its prefix
    hits land under their digests); round 2 draws new values with round
    1's lengths."""
    rng = np.random.default_rng(seed + 2000)
    frames = encdec_frames(seed)
    waves = []
    for _ in range(2):
        wave = [rng.standard_normal((n, ENC_D)).astype(np.float32)
                for n in frames[:-1]] + [None]
        waves += [wave, wave]
    return waves


def arch_heads(arch: str) -> tuple:
    """(q heads, kv heads, head dim) of a registry arch."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def heads_row(kernel: str, arch: str) -> str:
    """The kernels line's row of ``kernel`` at ``arch``'s heads."""
    hq, hkv, dh = arch_heads(arch)
    return f"{kernel}_hq{hq}_hkv{hkv}_dh{dh}"


def real_heads(arch: str):
    """``smoke_config`` of ``arch`` with the arch's own attention group and
    head dim over one kv head (G q heads of the full width's head dim)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    hq, hkv, dh = arch_heads(arch)
    return smoke_config(get_arch(arch)).replace(
        num_heads=hq // hkv, num_kv_heads=1, head_dim=dh)


def pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def check_kernels(dev, kernels: dict):
    """Phase 3: each kernel against its plain version on the card, then
    timed at the main path's shapes beside the plain version and one
    PyTorch library call computing the same function."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref,
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.flash_attention.ops import (
        _flash_forward,
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
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

    def hold(name, out, ref, tol, why, what, scale=None):
        """``scale``: what the error is taken relative to (default: the
        plain version's largest entry)."""
        r = (rel(out, ref) if scale is None
             else float((out.float() - ref.float()).abs().max() / scale))
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
        hold("paged_decode_attention" + ("_int8" if adt == i8 else ""),
             out[:7], ref[:7], tol, why,
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
        route = "tensor cores" if qdt == bf16 else "CUDA cores"
        hold("paged_extend_attention" + ("_int8" if adt == i8 else ""),
             out[:7], ref[:7], tol, why,
             f"q {qdt} arena {adt} Sq40 n_log16 L36 layer17, {route}")
    # the float32 route at page sizes 1 to 64 (a 32-key tile spans 32
    # pages, or half of one), row 7 fully sentinel, and over arena views
    # whose rows do not start on 16 bytes (Dh 128 inside rows of 132, the
    # base off by one element: the kernel's element loads)
    for P, view in ((1, False), (8, False), (64, False), (PAGE, True)):
        for adt, tol, why in ((f32, 2e-5, "f32; summation order"),
                              (i8, 2e-4, "same dequantised int8 values")):
            n_log = -(-(max(pos) + S) // P)
            a = build_arena(gen, [p + S for p in pos], n_log, adt, dev,
                            n_layers=4, sentinel_rows=(7,), page=P,
                            dh=DH + 4 if view else DH)
            kv = [a["k"], a["v"]]
            if view:
                kv = [x[..., 1:DH + 1] for x in kv]
            q = torch.randn((8, S, HQ, DH), generator=gen, device=dev)
            args = (*kv, a["slot_pos"], a["block_table"], ps, 2)
            sc = dict(k_scale=a["k_scale"], v_scale=a["v_scale"])
            out = paged_extend_attention(q, *args, **sc)
            ref = paged_extend_attention_ref(q.transpose(1, 2), *args,
                                             **sc).transpose(1, 2)
            torch.cuda.synchronize()
            if out[7].any():
                raise AssertionError("float32 paged extend: a fully "
                                     "sentinel row is not 0")
            hold("paged_extend_attention" + ("_int8" if adt == i8 else ""),
                 out[:7], ref[:7], tol, why,
                 f"q f32 arena {adt} P{P} n_log{n_log}" + (
                     ", rows off 16 bytes" if view else ""))
    q = torch.zeros((1, 8, HQ, 72), dtype=bf16, device=dev)
    a72 = torch.zeros((2, PAGE, 1, HKV, 80), dtype=bf16, device=dev)
    sp1 = torch.full((2, PAGE, 1), -1, dtype=torch.int32, device=dev)
    bt1 = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    p1 = torch.zeros((1,), dtype=torch.int32, device=dev)
    for what, arena, qq in [
            ("bf16 Dh72 (not a multiple of 16)", a72[..., :72], q),
            ("bf16 arena view off 16 bytes", a72[..., 4:68], q[..., :64])]:
        try:
            paged_extend_attention(qq, arena, arena, sp1, bt1, p1, 0)
        except ValueError:
            log(f"  {'paged_extend_attention':24s} {what:44s} raises "
                "ValueError: ok")
        else:
            raise AssertionError(f"paged_extend_attention took a {what}")

    # prefill flash: Sq = 200 not a multiple of the q tile, GQA 4, causal,
    # sliding window, bidirectional, q suffix of longer keys; bf16 takes
    # the tensor-core kernel, f32 the CUDA-core kernel
    flash_cases = []
    for sq, skv, causal, window in [(200, 200, True, None),
                                    (200, 200, True, 64),
                                    (200, 200, False, None),
                                    (72, 200, True, None)]:
        flash_cases += [
            (bf16, 2e-2, "bf16 output and P rounding", sq, skv, causal, window),
            (f32, 2e-5, "f32; summation order", sq, skv, causal, window)]
    for dt, tol, why, sq, skv, causal, window in flash_cases:
        q = torch.randn((2, sq, HQ, DH), generator=gen, device=dev).to(dt)
        k = torch.randn((2, skv, HKV, DH), generator=gen, device=dev).to(dt)
        v = torch.randn((2, skv, HKV, DH), generator=gen, device=dev).to(dt)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref, ref_lse = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     window=window, return_lse=True)
        torch.cuda.synchronize()
        hold("flash_attention", out, ref.transpose(1, 2), tol, why,
             f"{dt} Sq{sq} Skv{skv} causal={causal} window={window}")
        if dt == f32:       # the LSE the backward reads, and a repeat
            out2, lse = _flash_forward(q, k, v, causal, window, None, True)
            torch.cuda.synchronize()
            hold("flash_attention", lse, ref_lse, 1e-5, why,
                 f"f32 LSE Sq{sq} Skv{skv} causal={causal} window={window}")
            if not torch.equal(out, out2):
                raise AssertionError("float32 flash: two calls differ")
    q = torch.zeros((1, 8, 2, 72), dtype=bf16, device=dev)
    try:
        flash_attention(q, q, q)
    except ValueError:
        log(f"  {'flash_attention':24s} {'bf16 Dh72 (not a multiple of 16)':44s}"
            " raises ValueError: ok")
    else:
        raise AssertionError("flash_attention took a bf16 head dim of 72")
    # flash under a key-length mask at seamless-m4t-large-v2's heads: the
    # encoder (Sq = Skv, bidirectional), cross-attention to a longer memory
    # and to a shorter one; row 1 has kv_len 0 (the kernel stores 0, the
    # plain version the mean of V: checked to be 0), row 2 one above Skv
    for sq, skv in ((200, 200), (72, 200), (200, 72)):
        name = ("flash_attention_encoder" if sq == skv
                else "flash_attention_cross")
        kl = torch.tensor([skv // 2 + 1, 0, skv + 5], dtype=torch.int32,
                          device=dev)
        for dt, tol, why in ((bf16, 2e-2, "bf16 output and P rounding"),
                             (f32, 2e-5, "f32; summation order")):
            q = torch.randn((3, sq, ENC_H, ENC_DH), generator=gen,
                            device=dev).to(dt)
            k = torch.randn((3, skv, ENC_H, ENC_DH), generator=gen,
                            device=dev).to(dt)
            v = torch.randn((3, skv, ENC_H, ENC_DH), generator=gen,
                            device=dev).to(dt)
            out = flash_attention(q, k, v, causal=False, kv_len=kl)
            ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=False,
                                kv_len=kl).transpose(1, 2)
            torch.cuda.synchronize()
            if out[1].any():
                raise AssertionError(f"{name}: a kv_len 0 row is not 0")
            hold(name, out[0::2], ref[0::2], tol, why,
                 f"{dt} Sq{sq} Skv{skv} kv_len {kl.tolist()}")

    # dense decode: the DECODE_CASES of tests/test_kernels.py, then the
    # main path's heads over S = 500 (not a multiple of the key tile), in
    # f32 and bf16, with and without a window
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
        if s_c == 500:              # a window: the live range starts late
            out = decode_attention(q, k, v, kl, window=64)
            ref = decode_attention_ref(q[:, 0], k, v, kl, window=64)[:, None]
            torch.cuda.synchronize()
            hold("decode_attention", out, ref, tol, why,
                 f"{dt} S{s_c} window64, no slot_pos")
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
    # dense decode over a cross memory (seamless): G 1 at head dim 64,
    # kv_len = src_len with a row of 0 (stores 0) and one of all 512
    kl = torch.tensor([96, 384, 0, 512, 200, 97, 255, 1], dtype=torch.int32,
                      device=dev)
    for dt, tol, why in [(f32, 2e-5, "f32; summation order"),
                         (bf16, 2e-2, "bf16 output rounding")]:
        q = torch.randn((SLOTS, 1, ENC_H, ENC_DH), generator=gen,
                        device=dev).to(dt)
        k = torch.randn((SLOTS, MAX_LEN, ENC_H, ENC_DH), generator=gen,
                        device=dev).to(dt)
        v = torch.randn((SLOTS, MAX_LEN, ENC_H, ENC_DH), generator=gen,
                        device=dev).to(dt)
        out = decode_attention(q, k, v, kl)
        ref = decode_attention_ref(q[:, 0], k, v, kl)[:, None]
        torch.cuda.synchronize()
        if out[2].any():
            raise AssertionError("decode over cross memory: a src_len 0 row "
                                 "is not 0")
        live = [b for b in range(SLOTS) if b != 2]
        hold("decode_attention_cross", out[live], ref[live], tol, why,
             f"{dt} B{SLOTS} S{MAX_LEN} Hkv{ENC_H} Dh{ENC_DH} src_len")

    # grouped GEMM: the counts sweep of tests/test_kernels.py (all-zero
    # and all-full included), then deepseek-moe-16b's decode (C 8), warm
    # extend (C 96) and 1024-token prefill (C 192) shapes, D 2048, F 1408,
    # then C, D and F off every tile with F not a multiple of the 8-wide
    # vectors (the element-wise loads), then counts at 0, 1, tile - 1,
    # tile, tile + 1 and C of the bf16 kernel's 128- and 16-row tiles, in
    # bf16 and f32
    for e_, c_, d_, f_, counts in [
            (8, 256, 128, 256, [0, 5, 128, 256, 129, 200, 1, 64]),
            (8, 256, 128, 256, [0] * 8), (8, 256, 128, 256, [256] * 8),
            (MOE_E, 8, MOE_D, MOE_F, None), (MOE_E, 96, MOE_D, MOE_F, None),
            (MOE_E, 192, MOE_D, MOE_F, None),
            (4, 40, 100, 44, [40, 0, 33, 1]),
            (8, 300, 256, 264, [0, 1, 127, 128, 129, 300, 255, 256]),
            (5, 16, 512, 384, [0, 1, 15, 16, 9])]:
        for dt, tol, why in [
                (bf16, 2e-2, "bf16 output rounding"),
                (f32, 1e-4, "f32; up to 2048-term sums in another order")]:
            x = torch.randn((e_, c_, d_), generator=gen, device=dev).to(dt)
            w = (torch.randn((e_, d_, f_), generator=gen, device=dev)
                 * 0.05).to(dt)
            cnt = (torch.tensor(counts, dtype=torch.int32, device=dev)
                   if counts is not None else routed_counts(dev, c_))
            out = gmm(x, w, cnt)
            ref = gmm_ref(x, w, cnt)
            torch.cuda.synchronize()
            pad = torch.arange(c_, device=dev)[None] >= cnt[:, None]
            if out[pad].any():
                raise AssertionError("gmm: a row past counts is not zero")
            hold("gmm", out, ref, tol, why,
                 f"{dt} E{e_} C{c_} D{d_} F{f_} "
                 f"counts {'given' if counts else 'routed'}")

    check_gmm_bwd(dev, hold)
    check_ssd(dev, gen, hold)
    check_ssd_bwd(dev, gen, hold)
    check_head_dim_80(dev, gen, hold)
    check_flash_bwd(dev, gen, hold)

    # ---- timing at the main path's shapes (bf16) ----------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    elem = 2

    # the three attention kernels of the main path at its shapes (rows 1,
    # 2 and 4), the paged ones over a bf16 and an int8 arena (phase 19b's)
    time_attention(dev, gen, flush, kernels, hold, HQ, HKV, DH, {
        "flash": "flash_attention", "extend": "paged_extend_attention",
        "extend_int8": "paged_extend_attention_int8",
        "decode": "paged_decode_attention",
        "decode_int8": "paged_decode_attention_int8"})
    # dense decode: the main path's 8 rows over their 512-slot dense cache,
    # half-way through the cold wave's 16 new tokens (a non-rolling cache
    # passes no slot_pos: the splits share each row's slots below kv_len)
    kv_lens = main_path_shapes()["kv_lens"]
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

    time_encdec(dev, gen, flush, kernels, hold)

    # grouped GEMM: one deepseek-moe-16b decode call (8 tokens routed
    # top-6 over 64 experts, C 8), the 1024-token cold prefill call (C 192)
    # and the 512-token warm extend call (C 96)
    for c_, tag in ((8, "gmm"), (192, "gmm_prefill"), (96, "extend")):
        x = torch.randn((MOE_E, c_, MOE_D), generator=gen, device=dev).to(bf16)
        w = (torch.randn((MOE_E, MOE_D, MOE_F), generator=gen, device=dev)
             * 0.05).to(bf16)
        cnt = routed_counts(dev, c_)
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
        if tag in kernels:
            kernels[tag].update(rep)
        else:
            log(f"  gmm at the warm extend shape {rep['shape']}: kernel "
                f"{rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms, "
                f"library {rep['library_ms']:.4f} ms, bound "
                f"{rep['bound_ms']:.4f} ms ({rep['bound_by']})")
    time_gmm_bwd(dev, flush, kernels)
    time_ssd(dev, gen, flush, kernels)
    time_ssd_bwd(dev, gen, flush, kernels)
    # zamba2-2.7b's shared attention over its dense cache (rows 1b-3b),
    # logged; the four registry archs of phases 20a-20d at their heads
    time_attention(dev, gen, flush, kernels, hold, ZAMBA_H, ZAMBA_H,
                   ZAMBA_DH, {"flash": "flash_attention",
                              "extend": "paged_extend_attention",
                              "decode": "decode_attention"},
                   dense=True, store=False)
    for tag, arch, layers in ARCH_PHASES:
        time_attention(dev, gen, flush, kernels, hold, *arch_heads(arch), {
            kind: heads_row(base, arch) for kind, base in (
                ("flash", "flash_attention"),
                ("extend", "paged_extend_attention"),
                ("decode", "paged_decode_attention"))},
            n_layers=layers or get_arch(arch).num_layers)
    time_long_decode(dev, gen, flush)
    time_flash_bwd(dev, gen, flush, kernels, hold)
    time_flash_f32(dev, gen, flush, kernels, hold)
    errs["gmm_prefill"] = errs["gmm"]     # one kernel, held at both shapes
    for name, e in errs.items():
        kernels[name]["max_abs_err"] = e
    for name, rep in kernels.items():
        lib = ("none" if rep["library_ms"] is None
               else f"{rep['library_ms']:.4f} ms")
        log(f"  {name:24s} {rep['shape']}: kernel {rep['ms']:.4f} ms, "
            f"plain {rep['plain_ms']:.4f} ms, library {lib}, bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_by']})")


def time_encdec(dev, gen, flush, kernels, hold) -> None:
    """The three kernel calls of the encdec path at seamless-m4t-large-v2's
    shapes (bf16, 16 heads of 64, the 512-frame memory, kv_len the wave's
    source lengths 96..384): the encoder's self-attention (B8 S512,
    bidirectional), cross-attention at prefill (B8 Sq128 against the
    memory) and at decode (the dense decode kernel, one query a row), each
    beside its plain version and one ``scaled_dot_product_attention`` call
    under the same key mask as a boolean mask.  Each flash call is first
    held against its plain version on the inputs it is timed on, and so is
    cross-attention at phase 10's other prompt buckets (Sq 96, 64 and 32:
    cold prefills and extends); decode is held at this shape in
    :func:`check_kernels`.  The bounds count the keys below
    kv_len, the only ones the kernels read: K and V bytes of those keys, Q
    and the output once, and the products 4 * Dh * Hq * Sq * kv_len a
    row."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    bf16, H, Dh, e = torch.bfloat16, ENC_H, ENC_DH, 2
    frames = encdec_frames()
    kl = torch.tensor(frames, dtype=torch.int32, device=dev)
    n_keys = sum(frames)
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev).to(bf16)  # noqa: E731
    k, v = r(SLOTS, MAX_LEN, H, Dh), r(SLOTS, MAX_LEN, H, Dh)
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(MAX_LEN, device=dev)[None] < kl[:, None]
            )[:, None, None]                           # (B, 1, 1, S)
    kv_bytes = n_keys * 2 * H * Dh * e + 4 * SLOTS
    for name, sq in (("flash_attention_encoder", MAX_LEN),
                     *(("flash_attention_cross", sq) for sq in CROSS_SQ),
                     ("decode_attention_cross", 1)):
        q = r(SLOTS, sq, H, Dh)
        qt = q.transpose(1, 2).contiguous()
        if sq == 1:
            kern = lambda: decode_attention(q, k, v, kl)  # noqa: E731
            plain = lambda: decode_attention_ref(q[:, 0], k, v, kl)  # noqa: E731
            what = f"B{SLOTS} S{MAX_LEN} Hkv{H} Dh{Dh} bf16 src_len"
        else:
            kern = lambda: flash_attention(q, k, v, causal=False,  # noqa: E731
                                           kv_len=kl)
            plain = lambda: attention_ref(qt, kt, vt, causal=False,  # noqa: E731
                                          kv_len=kl)
            what = (f"B{SLOTS} Sq{sq} Skv{MAX_LEN} H{H} Dh{Dh} bf16 "
                    "bidirectional kv_len")
            out, ref = kern(), plain().transpose(1, 2)
            torch.cuda.synchronize()
            hold(name, out, ref, 2e-2, "bf16 output and P rounding",
                 f"Sq{sq} Skv{MAX_LEN} kv_len {min(frames)}..{max(frames)}")
            if sq < CROSS_SQ[0]:    # phase 10's other buckets: held only
                continue
        kernels[name].update(
            shape=f"{what} {min(frames)}..{max(frames)}",
            ms=time_ms(kern, flush=flush),
            plain_ms=time_ms(plain, flush=flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), flush=flush),
            **bound(2 * q.numel() * e + kv_bytes,
                    4 * Dh * H * sq * n_keys, bf16))


def ssd_inputs(gen, dev, Bb, S, H, P, G, N):
    """x (B, S, H, P), dt (B, S, H), A_log (H,), B/C (B, S, G, N) float32,
    drawn as tests/test_kernels.py draws them."""
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
    dt = torch.nn.functional.softplus(r(Bb, S, H) * 0.5)
    A_log = torch.rand((H,), generator=gen, device=dev) * 1.5
    return r(Bb, S, H, P), dt, A_log, r(Bb, S, G, N) * 0.3, r(Bb, S, G, N) * 0.3


def check_ssd(dev, gen, hold):
    """The SSD scan (``ops.ssd``, one launch) against its plain version
    ``ssd_ref`` at every chunk length of the main paths (Q 1 degenerate,
    16 cold prefill, 64 warm extend, 128 and 256 on the dense cache) at
    mamba2's and zamba2's full widths, with checkpoints and without, bf16
    inputs as the full-width models hand them over; the three cases of
    tests/test_kernels.py against ``ssd_chunked``; and the pad rows'
    identity, bit for bit.  Each case also writes its checkpoints into a
    given tensor (``ckpt_out``, the snapshot prefill's workspace route),
    held to the same plain version."""
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models.mamba2 import ssd_chunked
    why = "f32 both sides; only the summation order differs"
    for Bb, S, N, Q, dt in [(1, 64, SSD_N, 1, torch.float32),
                            (2, 128, SSD_N, 16, torch.float32),
                            (2, 128, SSD_N, 16, torch.bfloat16),
                            (2, 128, ZAMBA_N, 16, torch.bfloat16),
                            (1, 128, SSD_N, 64, torch.float32),
                            (1, 128, ZAMBA_N, 64, torch.float32),
                            (1, 256, SSD_N, 128, torch.float32),
                            (1, 256, SSD_N, 256, torch.float32),
                            (1, 256, ZAMBA_N, 256, torch.bfloat16)]:
        x, dtv, A_log, B, C = ssd_inputs(gen, dev, Bb, S, SSD_H, SSD_P, 1, N)
        x, B, C = x.to(dt), B.to(dt), C.to(dt)
        out = ssd(x, dtv, A_log, B, C, chunk=Q, checkpoints=True)
        out2 = ssd(x, dtv, A_log, B, C, chunk=Q)
        buf = torch.full((Bb, S // Q, SSD_H, SSD_P, N), float("nan"),
                         device=dev)
        out3 = ssd(x, dtv, A_log, B, C, chunk=Q, checkpoints=True,
                   ckpt_out=buf)
        ref = ssd_ref(x, dtv, A_log, B, C, chunk=Q, checkpoints=True)
        torch.cuda.synchronize()
        if out3[2] is not buf:
            raise AssertionError("ssd: ckpt_out is not returned as the "
                                 "checkpoints")
        for part, o, r in zip(("y", "final", "checkpoints", "y (no ckpt)",
                               "final (no ckpt)", "checkpoints (ckpt_out)"),
                              out + out2 + out3[2:], ref + ref[:2] + ref[2:]):
            hold("ssd", o, r, 2e-5, why,
                 f"{part} B{Bb} S{S} H{SSD_H} P{SSD_P} N{N} Q{Q} "
                 f"{str(dt)[6:]}")
    for tag, (Bb, S, H, P, G, N, chunk), kw in [
            ("G2", (2, 128, 4, 16, 2, 32, 32), {}),
            ("initial state", (1, 64, 2, 8, 1, 16, 16), {"initial_state": 1}),
            ("ragged mask", (3, 64, 2, 8, 1, 16, 16), {"mask": 1})]:
        inp = ssd_inputs(gen, dev, Bb, S, H, P, G, N)
        if "initial_state" in kw:
            kw["initial_state"] = torch.randn((Bb, H, P, N), generator=gen,
                                              device=dev) * 0.2
        if "mask" in kw:
            kw["mask"] = (torch.arange(S, device=dev)[None]
                          < torch.tensor([64, 17, 1], device=dev)[:, None])
        y, h, ck = ssd(*inp, chunk=chunk, checkpoints=True, **kw)
        y_r, h_r, ck_r = ssd_chunked(*inp, chunk=chunk, checkpoints=True,
                                     **kw)
        torch.cuda.synchronize()
        if "mask" in kw:
            y, y_r = y * kw["mask"][..., None, None], y_r * kw["mask"][
                ..., None, None]
        for part, o, r in (("y", y, y_r), ("final", h, h_r),
                           ("checkpoints", ck, ck_r)):
            hold("ssd", o, r, 2e-5, why,
                 f"ops.ssd vs ssd_chunked, {tag}: {part}")
    # rows whose steps are all masked (the rows riding along a restore)
    Bb, S = 3, 64
    x, dt, A_log, B, C = ssd_inputs(gen, dev, Bb, S, SSD_H, SSD_P, 1, SSD_N)
    mask = torch.ones((Bb, S), dtype=torch.bool, device=dev)
    mask[1] = False
    init = torch.randn((Bb, SSD_H, SSD_P, SSD_N), generator=gen, device=dev)
    _, final, ck = ssd(x, dt, A_log, B, C, chunk=16, initial_state=init,
                       mask=mask, checkpoints=True)
    _, final2 = ssd(x, dt, A_log, B, C, chunk=16, initial_state=init,
                    mask=mask)
    torch.cuda.synchronize()
    exact = (torch.equal(final[1], init[1]) and torch.equal(final2[1], init[1])
             and all(torch.equal(ck[1, c], init[1]) for c in range(S // 16)))
    log(f"  {'ssd':24s} {'pad rows: the initial state kept':44s}"
        f" bit for bit: {'ok' if exact else 'FAIL'}")
    if not exact:
        raise AssertionError("ssd: a fully masked row is not an exact "
                             "identity")


# the training microbatch of mamba2-2.7b and zamba2-2.7b: one of the global
# batch 8 at seq 512 under the configs' microbatch 2
SSD_TRAIN = [("ssd_scan_bwd", SSD_N), ("ssd_scan_bwd_zamba2", ZAMBA_N)]
#: rows 6f and 6f': the float32 route at the same shapes
SSD_TRAIN_F32 = [("ssd_scan_bwd_f32", SSD_N),
                 ("ssd_scan_bwd_f32_zamba2", ZAMBA_N)]


def ssd_bwd_case(gen, dev, Bb, S, H, P, G, N, dtype, *, lens=None,
                 init=False, dfin=False):
    """Inputs of one ``ssd_bwd`` call: (x, dt, A_log, B, C, dy, d_final)
    with x, B and C in ``dtype``, and its keywords (mask from row lengths,
    an initial state)."""
    x, dt, A_log, B, C = ssd_inputs(gen, dev, Bb, S, H, P, G, N)
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
    mask = (None if lens is None else torch.arange(S, device=dev)[None]
            < torch.tensor(lens, device=dev)[:, None])
    kw = dict(chunk=256, mask=mask,
              initial_state=r(Bb, H, P, N) * 0.2 if init else None)
    return ((x.to(dtype), dt, A_log, B.to(dtype), C.to(dtype), r(Bb, S, H, P),
             r(Bb, H, P, N) if dfin else None), kw)


def check_ssd_bwd(dev, gen, hold):
    """The SSD scan's backward (``ops.ssd_bwd``: ``csrc/ssd_scan_bwd.cu``)
    against ``ssd_bwd_ref`` on the card, on the same inputs, cotangents and
    the forward kernel's states: at mamba2's and zamba2's training
    microbatch (B 4, S 512, H 80, P 64, G 1, N 128 and 64; x, B and C bf16,
    dy float32, as training hands them over; rows ``ssd_scan_bwd`` and
    ``ssd_scan_bwd_zamba2``) and at smoke shapes with two groups, a head
    dim of 80 (two P tiles), ragged masks and a fully masked row, an
    initial state and the final state's cotangent: in bf16 (the
    tensor-core route, across its span boundaries) and in float32 (the
    CUDA-core route, row ``ssd_scan_bwd_f32``, across its span boundaries
    too: S 144 is two spans of ``BWD_SPAN_F32`` sub-chunks and one of a
    single sub-chunk).  Float32 gradients within 1e-4 relative, bf16 ones
    (dx, dB, dC of bf16 inputs) 1e-2, dA_log 1e-5 of its summands' scale
    (``ssd_dA_log_scale``: its terms cancel); two calls at the training
    shape bitwise equal, in bf16 and in float32."""
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_bwd
    from repro_torch.kernels.ssd_scan.ref import (
        ssd_bwd_ref,
        ssd_dA_log_scale,
    )
    names = ("dx", "ddt", "dA_log", "dB", "dC", "d_init")
    bf16 = torch.bfloat16
    cases = [(name, (TRAIN_B, TRAIN_S, SSD_H, SSD_P, 1, n, bf16), {})
             for name, n in SSD_TRAIN] + [
        ("ssd_scan_bwd", (2, 144, 4, 80, 2, SSD_N, bf16),
         dict(lens=(144, 61), init=True, dfin=True)),
        ("ssd_scan_bwd_zamba2", (2, 80, 8, SSD_P, 1, ZAMBA_N, bf16),
         dict(lens=(80, 0), init=True, dfin=True))] + [
        (name, (TRAIN_B, TRAIN_S, SSD_H, SSD_P, 1, n, torch.float32), {})
        for name, n in SSD_TRAIN_F32] + [
        ("ssd_scan_bwd_f32", (2, 64, 4, 64, 2, SSD_N, torch.float32),
         dict(lens=(64, 0), init=True, dfin=True)),
        ("ssd_scan_bwd_f32_zamba2", (2, 96, 4, 80, 2, ZAMBA_N,
                                     torch.float32),
         dict(lens=(96, 41), dfin=True)),
        ("ssd_scan_bwd_f32_zamba2", (1, 128, 8, SSD_P, 1, ZAMBA_N,
                                     torch.float32),
         dict(init=True, dfin=True)),
        ("ssd_scan_bwd_f32", (2, 144, 4, 80, 2, SSD_N, torch.float32),
         dict(lens=(144, 61), init=True, dfin=True))]
    for name, (Bb, S, H, P, G, N, dt), kw in cases:
        args, call = ssd_bwd_case(gen, dev, Bb, S, H, P, G, N, dt, **kw)
        with torch.no_grad():
            states = ssd(*args[:5], chunk=16, checkpoints=True,
                         initial_state=call["initial_state"],
                         mask=call["mask"])[2]
        got = ssd_bwd(*args, states=states, **call)
        want = ssd_bwd_ref(*args, **call)
        torch.cuda.synchronize()
        scale = float(ssd_dA_log_scale(args[0], args[1], call["mask"],
                                       want[0], want[1]).max())
        what = f"B{Bb} S{S} H{H} P{P} G{G} N{N} {str(dt)[6:]} " + " ".join(
            f"{k}={v}" for k, v in kw.items())
        for part, g, w in zip(names, got, want):
            if part == "dA_log":
                hold(name, g, w, 1e-5, "a sum whose terms cancel",
                     f"{part} {what}", scale=scale)
            elif g.dtype == torch.bfloat16:
                hold(name, g, w, 1e-2, "bf16 output rounding",
                     f"{part} {what}")
            else:
                hold(name, g, w, 1e-4, "f32; sums in another order",
                     f"{part} {what}")
        log(f"  {name:24s} max abs err " + ", ".join(
            f"{part} {float((g.float() - w.float()).abs().max()):.3e}"
            for part, g, w in zip(names, got, want)))
        if (Bb, S) == (TRAIN_B, TRAIN_S):
            again = ssd_bwd(*args, states=states, **call)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two calls differ")
            log(f"  {name:24s} {str(dt)[6:]} two calls bitwise equal: ok")


def ssd_bwd_work(Bb, S, H, P, G, N, K, *, esize=2, tc=True):
    """(bytes, operations) of one ``ssd_bwd`` call: x, B, C read at
    ``esize`` bytes an element, dt, dy and the forward's S / K states read
    once in float32; dx, dB and dC written at ``esize``, ddt in float32.
    Operations: the products of ``train_step.ssd_step_flops``'s backward
    (T = K) in float32 (``tc=False``: the CUDA-core route), or each counted
    as many times as the tensor-core route's TF32 passes take it (``tc``:
    3 for Z = h0^T g and dx' from g and the pairs, whose operands are both
    float32; 2 for W, V, U, g x'^T, dB and dC, one float32 operand and a
    bf16 one; 1 for C B^T)."""
    n_bytes = (esize * (2 * Bb * S * H * P + 4 * Bb * S * G * N) + 8 * H
               + 4 * (2 * Bb * S * H + Bb * S * H * P
                      + Bb * (S // K) * H * P * N))
    if tc:
        n_ops = Bb * S * (H * (18 * P * N + (K + 1) * (5 * P + 4 * N))
                          + G * (K + 1) * N)
    else:
        n_ops = Bb * S * (H * (8 * P * N + 2 * (K + 1) * (P + N))
                          + G * (K + 1) * N)
    return n_bytes, n_ops


def time_ssd_bwd(dev, gen, flush, kernels) -> None:
    """Rows 6d and 6e: the backward at mamba2's and zamba2's training
    microbatch (B 4, S 512, H 80, P 64, N 128 and 64, bf16 x, B and C,
    float32 dy, no mask: what phases 14 and 14b launch, the tensor-core
    route), from the states of the forward's training launch, beside its
    plain version; rows 6f and 6f': the float32 route at mamba2's and
    zamba2's shapes (what phase 13b's float32 steps take), each with its
    share of the bound and the kernels of a call (adjoint, span, sums;
    the mean of three traced calls).  No single PyTorch call computes it (library: none).  The
    bound counts the tensor-core route's TF32 passes at 495 TFLOP/s (the
    float32 route: its products at the float32 CUDA-core peak; logged
    beside rows 6d and 6e too).  Also the forward as training runs it (a
    checkpoint every 16 steps, the states the backward reads)."""
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref
    rows = SSD_TRAIN + SSD_TRAIN_F32
    for name, N in rows:
        tc = (name, N) not in SSD_TRAIN_F32
        dt = torch.bfloat16 if tc else torch.float32
        args, call = ssd_bwd_case(gen, dev, TRAIN_B, TRAIN_S, SSD_H, SSD_P, 1,
                                  N, dt)
        with torch.no_grad():
            states = ssd(*args[:5], chunk=16, checkpoints=True)[2]
        work = ssd_bwd_work(TRAIN_B, TRAIN_S, SSD_H, SSD_P, 1, N, 16,
                            esize=2 if tc else 4, tc=tc)
        rep = dict(shape=f"B{TRAIN_B} S{TRAIN_S} H{SSD_H} P{SSD_P} G1 N{N} "
                         f"{'bf16' if tc else 'f32'} x/B/C, f32 dy, K16",
                   ms=time_ms(lambda: ssd_bwd(*args, states=states, **call),
                              flush=flush),
                   plain_ms=time_ms(lambda: ssd_bwd_ref(*args, **call),
                                    flush=flush),
                   library_ms=None,
                   **bound(*work, "tf32" if tc else torch.float32))
        cuda_core = bound(*ssd_bwd_work(TRAIN_B, TRAIN_S, SSD_H, SSD_P, 1, N,
                                        16, tc=False), torch.float32)
        fwd = time_ms(lambda: ssd(*args[:5], chunk=16, checkpoints=True),
                      flush=flush)
        log(f"  {name} {rep['shape']}: kernel {rep['ms']:.4f} ms, plain "
            f"{rep['plain_ms']:.4f} ms, bound {rep['bound_ms']:.4f} ms "
            f"({rep['bound_by']}; {rep['bytes'] / 1e9:.3f} GB, "
            f"{rep['operations'] / 1e9:.2f} G{'TF32 ' if tc else ''}FLOP; "
            f"at the float32 CUDA-core peak {cuda_core['bound_ms']:.4f} ms), "
            f"{rep['bound_ms'] / rep['ms']:.3f} of the bound; the training "
            f"forward with its states {fwd:.4f} ms")
        kernels[name].update(rep)
        if not tc:
            log(f"  {name} kernels of a call: " + kernel_split(
                lambda: ssd_bwd(*args, states=states, **call)))


#: seed of the grouped GEMM backward's phase-3 inputs
GMM_BWD_SEED = 5


def gmm_bwd_case(gen, dev, E, C, D, F, counts, dtype):
    """Inputs of one ``gmm_bwd`` call, (x, w, counts, dy): x and dy
    standard normal, w scaled by 0.05 as the forward's checks draw it;
    ``counts`` a list, or None for a routed draw of 2048 tokens (the
    training microbatch) at capacity C."""
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731
    cnt = (torch.tensor(counts, dtype=torch.int32, device=dev)
           if counts is not None else routed_counts(dev, C, MOE_TRAIN_T))
    return (r(E, C, D).to(dtype), (r(E, D, F) * 0.05).to(dtype), cnt,
            r(E, C, F).to(dtype))


def check_gmm_bwd(dev, hold):
    """The grouped GEMM's backward (``ops.gmm_bwd``: ``rt_gmm_bwd`` in
    ``csrc/moe_gmm.cu``) against ``gmm_bwd_ref`` on the card, on the same
    inputs and cotangent: deepseek-moe-16b's training shapes (E 64, C 240,
    counts from a top-6 routing of 2048 tokens; gate and up D 2048 F 1408,
    down D 1408 F 2048), then smoke shapes with counts at 0, 1, a tile's
    edges and C, all-empty and all-full experts, C, D and F off every tile
    and D or F not a multiple of 8 (the element-wise loads), each tile by
    C (16, 64 and 128 rows).  bf16 (rows ``gmm_bwd_dx`` and
    ``gmm_bwd_dw``) within 2e-2, bf16 output rounding; float32 (the
    CUDA-core route, row ``gmm_bwd_f32``) within 1e-4.  Rows of dx past
    counts and the dw of an expert with no token must be exact zeros; two
    calls at the training shape bitwise equal, and bf16 there on the
    wgmma route.  Then, from a generator of their own, the wgmma route's
    edges in bf16: counts at its m64 and 64-slot slice edges at C 240, F
    1400 (a ragged K for dX and N for dW), and an x, w or dy offset by one
    element, which must take the element route and still match.  Inputs
    come from generators of their own, so that the checks after them draw
    what they drew before these were added."""
    from repro_torch.kernels.moe_gmm.ops import gmm_bwd, takes_wgmma
    from repro_torch.kernels.moe_gmm.ref import gmm_bwd_ref
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(GMM_BWD_SEED)
    train = [(MOE_E, MOE_TRAIN_C, MOE_D, MOE_F, None),
             (MOE_E, MOE_TRAIN_C, MOE_F, MOE_D, None)]
    smoke = [(8, 256, 128, 256, [0, 5, 128, 256, 129, 200, 1, 64]),
             (8, 64, 128, 136, [0] * 8), (8, 96, 128, 256, [96] * 8),
             (4, 40, 100, 44, [40, 0, 33, 1]),
             (8, 300, 256, 264, [0, 1, 127, 128, 129, 300, 255, 256]),
             (5, 16, 512, 384, [0, 1, 15, 16, 9]),
             (3, 72, 136, 60, [72, 17, 64])]

    def one(x, w, cnt, dy, tol, why, what, names, wgmma=None):
        """Hold one call against the plain version (``names``: the rows
        of dx and dw); ``wgmma``: the route it must take."""
        n0 = gmm_bwd.launches_wgmma
        got = gmm_bwd(x, w, cnt, dy)
        want = gmm_bwd_ref(x, w, cnt, dy)
        torch.cuda.synchronize()
        if wgmma is not None and gmm_bwd.launches_wgmma - n0 != wgmma:
            raise AssertionError(f"gmm_bwd {what}: wgmma route {not wgmma}")
        pad = torch.arange(x.shape[1], device=dev)[None] >= cnt[:, None]
        if got[0][pad].any():
            raise AssertionError("gmm_bwd: a dx row past counts is not 0")
        if got[1][cnt == 0].any():
            raise AssertionError("gmm_bwd: dw of an empty expert is not 0")
        for part, name, g, r in zip(("dx", "dw"), names, got, want):
            hold(name, g, r, tol, why, f"{part} {str(x.dtype)[6:]} {what}")
        return got

    for dt, tol, why in [(bf16, 2e-2, "bf16 output rounding"),
                         (f32, 1e-4, "f32; sums in another order")]:
        names = (("gmm_bwd_f32",) * 2 if dt == f32
                 else ("gmm_bwd_dx", "gmm_bwd_dw"))
        for i, (E, C, D, F, counts) in enumerate(train + smoke):
            x, w, cnt, dy = gmm_bwd_case(gen, dev, E, C, D, F, counts, dt)
            what = (f"E{E} C{C} D{D} F{F} counts "
                    f"{'given' if counts else 'routed'}")
            got = one(x, w, cnt, dy, tol, why, what, names,
                      (dt == bf16) if i < len(train) else None)
            if i < len(train):
                again = gmm_bwd(x, w, cnt, dy)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"gmm_bwd {what}: two calls differ")
                log(f"  gmm_bwd {str(dt)[6:]} {what}: two calls bitwise "
                    f"equal{', on wgmma' if dt == bf16 else ''}: ok")
    gen = torch.Generator(device=dev).manual_seed(GMM_BWD_SEED + 2)
    edges = [(10, 240, 256, 320, [63, 64, 65, 127, 128, 129, 191, 192, 239,
                                  240]),
             (4, 240, 256, 1400, [240, 100, 0, 177])]
    for E, C, D, F, counts in edges:
        x, w, cnt, dy = gmm_bwd_case(gen, dev, E, C, D, F, counts, bf16)
        one(x, w, cnt, dy, 2e-2, "bf16 output rounding",
            f"E{E} C{C} D{D} F{F} counts {counts}",
            ("gmm_bwd_dx", "gmm_bwd_dw"), True)
    x, w, cnt, dy = gmm_bwd_case(gen, dev, 4, 240, 1408, 2048,
                                 [192, 240, 0, 131], bf16)
    for which in ("x", "w", "dy"):
        args = {"x": x, "w": w, "dy": dy}
        t = args[which]
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        args[which] = buf[1:].view(t.shape).copy_(t)
        if takes_wgmma(args["x"], args["w"], args["dy"]):
            raise AssertionError(f"gmm_bwd: {which} offset by one element "
                                 "predicted on the wgmma route")
        one(args["x"], args["w"], cnt, args["dy"], 2e-2,
            "bf16 output rounding", f"E4 C240 D1408 F2048, {which} offset "
            "by one element", ("gmm_bwd_dx", "gmm_bwd_dw"), False)
    log("  gmm_bwd wgmma edges (counts 63-240 at C 240, F 1400) on wgmma, "
        "offset x, w and dy on the element route: ok")


def gmm_bwd_work(cnt, C: int, D: int, F: int, *, dx: bool, dw: bool,
                 esize: int = 2):
    """(bytes, operations) of one ``gmm_bwd`` call over counts ``cnt``:
    dX reads the busy experts' weights and the live rows of dy and writes
    all of dx; dW reads the live rows of x and dy and writes all of dw;
    2 D F operations a live row for each part."""
    busy, rows = int((cnt > 0).sum()), int(cnt.sum())
    E = cnt.numel()
    n_bytes = 4 * E
    if dx:
        n_bytes += esize * (busy * D * F + rows * F + E * C * D)
    if dw:
        n_bytes += esize * (rows * (D + F) + E * D * F)
    if dx and dw:
        n_bytes -= esize * rows * F          # dy read once
    return n_bytes, 2 * rows * D * F * (int(dx) + int(dw))


def time_gmm_bwd(dev, flush, kernels) -> None:
    """Rows 5d-5f: the backward at deepseek-moe-16b's training shape (E 64,
    C 240, gate and up D 2048 F 1408, counts from a top-6 routing of 2048
    tokens), bf16 dX alone (row ``gmm_bwd_dx``) and dW alone (row
    ``gmm_bwd_dw``; both on the wgmma route), beside their plain versions
    and one ``torch.bmm`` (dy w^T, and x^T dy with dy's padding rows
    zeroed beforehand), with each one's share of its bound and its factor
    to ``torch.bmm``; float32 with both parts as phase 13b's steps launch
    it (row ``gmm_bwd_f32``; library: the two ``torch.bmm`` calls), and
    the float32 forward (the same CUDA-core body's kFwd pass) beside one
    ``torch.bmm``, logged.  The down projection's (D and F swapped) are
    logged beside them the same way.  Inputs from a generator of its own,
    as ``check_gmm_bwd``'s."""
    from repro_torch.kernels.moe_gmm.ops import gmm, gmm_bwd
    from repro_torch.kernels.moe_gmm.ref import gmm_bwd_ref
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(GMM_BWD_SEED + 1)
    for D, F, tag in ((MOE_D, MOE_F, "gate/up"), (MOE_F, MOE_D, "down")):
        x, w, cnt, dy = gmm_bwd_case(gen, dev, MOE_E, MOE_TRAIN_C, D, F,
                                     None, bf16)
        pad = torch.arange(MOE_TRAIN_C, device=dev)[None] >= cnt[:, None]
        dym = dy.masked_fill(pad[..., None], 0)
        wt, xt = w.transpose(1, 2), x.transpose(1, 2)
        shape = (f"E{MOE_E} C{MOE_TRAIN_C} D{D} F{F} bf16, "
                 f"{int((cnt > 0).sum())} experts busy, {int(cnt.sum())} "
                 "rows")
        reps = {}
        for part, lib in (("dx", lambda: torch.bmm(dy, wt)),
                          ("dw", lambda: torch.bmm(xt, dym))):
            kw = dict(dx=part == "dx", dw=part == "dw")
            reps[part] = dict(
                shape=f"{shape}, {part} alone",
                ms=time_ms(lambda: gmm_bwd(x, w, cnt, dy, **kw), flush=flush),
                plain_ms=time_ms(lambda: gmm_bwd_ref(x, w, cnt, dy, **kw),
                                 flush=flush),
                library_ms=time_ms(lib, flush=flush),
                **bound(*gmm_bwd_work(cnt, MOE_TRAIN_C, D, F, **kw), bf16))
        for part, rep in reps.items():
            log(f"  gmm_bwd {part} {tag} {rep['shape']}: kernel "
                f"{rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms, "
                f"torch.bmm {rep['library_ms']:.4f} ms, bound "
                f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}; "
                f"{rep['bytes'] / 1e9:.3f} GB, {rep['operations'] / 1e9:.1f} "
                f"GFLOP), {rep['bound_ms'] / rep['ms']:.3f} of the bound, "
                f"{rep['ms'] / rep['library_ms']:.3f}x torch.bmm")
            if tag == "gate/up":
                kernels[f"gmm_bwd_{part}"].update(rep)
    x, w, cnt, dy = gmm_bwd_case(gen, dev, MOE_E, MOE_TRAIN_C, MOE_D, MOE_F,
                                 None, torch.float32)
    pad = torch.arange(MOE_TRAIN_C, device=dev)[None] >= cnt[:, None]
    dym = dy.masked_fill(pad[..., None], 0)
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    rep = dict(
        shape=f"E{MOE_E} C{MOE_TRAIN_C} D{MOE_D} F{MOE_F} f32, dx and dw",
        ms=time_ms(lambda: gmm_bwd(x, w, cnt, dy), flush=flush),
        plain_ms=time_ms(lambda: gmm_bwd_ref(x, w, cnt, dy), flush=flush),
        library_ms=time_ms(lambda: (torch.bmm(dy, wt), torch.bmm(xt, dym)),
                           flush=flush),
        **bound(*gmm_bwd_work(cnt, MOE_TRAIN_C, MOE_D, MOE_F, dx=True,
                              dw=True, esize=4), torch.float32))
    log(f"  gmm_bwd_f32 {rep['shape']}: kernel {rep['ms']:.4f} ms, plain "
        f"{rep['plain_ms']:.4f} ms, two torch.bmm {rep['library_ms']:.4f} "
        f"ms, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}), "
        f"{rep['bound_ms'] / rep['ms']:.3f} of the bound, "
        f"{rep['ms'] / rep['library_ms']:.3f}x torch.bmm")
    kernels["gmm_bwd_f32"].update(rep)
    # the float32 forward (gmm_kernel's kFwd pass, the same body) at the
    # same shape, beside one torch.bmm over every capacity slot
    n_bytes = 4 * (int((cnt > 0).sum()) * MOE_D * MOE_F
                   + int(cnt.sum()) * MOE_D + MOE_E * MOE_TRAIN_C * MOE_F
                   + MOE_E)
    fwd = dict(ms=time_ms(lambda: gmm(x, w, cnt), flush=flush),
               library_ms=time_ms(lambda: torch.bmm(x, w), flush=flush),
               **bound(n_bytes, 2 * int(cnt.sum()) * MOE_D * MOE_F,
                       torch.float32))
    log(f"  gmm f32 forward E{MOE_E} C{MOE_TRAIN_C} D{MOE_D} F{MOE_F}, "
        f"{int(cnt.sum())} rows: kernel {fwd['ms']:.4f} ms, torch.bmm "
        f"{fwd['library_ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms "
        f"({fwd['bound_by']}), {fwd['bound_ms'] / fwd['ms']:.3f} of the "
        f"bound, {fwd['ms'] / fwd['library_ms']:.3f}x torch.bmm")


def check_head_dim_80(dev, gen, hold):
    """The attention kernels at zamba2-2.7b's shared block (32 q = kv
    heads of 80): prefill flash, dense decode, and extend over the dense
    per-slot cache through the paged extend kernel (the snapshot restore's
    route), each against its plain version."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import (
        KVSlice,
        dense_kv_arena,
        extend_attention_ref,
    )
    H, Dh = ZAMBA_H, ZAMBA_DH
    for dt, tol, why in [(torch.float32, 2e-5, "f32; summation order"),
                         (torch.bfloat16, 2e-2, "bf16 output rounding")]:
        r = lambda *sh: torch.randn(sh, generator=gen,  # noqa: E731
                                    device=dev).to(dt)
        q, k, v = r(2, 100, H, Dh), r(2, 100, H, Dh), r(2, 100, H, Dh)
        out = flash_attention(q, k, v)
        ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2)).transpose(1, 2)
        torch.cuda.synchronize()
        hold("flash_attention", out, ref, tol, why,
             f"{dt} Sq100 Hq{H} Hkv{H} Dh{Dh} causal")
        q, k, v = r(4, 1, H, Dh), r(4, MAX_LEN, H, Dh), r(4, MAX_LEN, H, Dh)
        kl = torch.tensor([87, 129, 1, 500], dtype=torch.int32, device=dev)
        out = decode_attention(q, k, v, kl)
        ref = decode_attention_ref(q[:, 0], k, v, kl)[:, None]
        torch.cuda.synchronize()
        hold("decode_attention", out, ref, tol, why,
             f"{dt} B4 S{MAX_LEN} Hq{H} Hkv{H} Dh{Dh}")
        # three rows at offsets 64 and 16 and one riding along at pos = S
        S = 40
        pos = torch.tensor([64, 16, MAX_LEN], dtype=torch.int32, device=dev)
        slots = torch.arange(MAX_LEN, dtype=torch.int32, device=dev)
        sp = torch.where(slots[None] < pos[:, None] + S, slots[None], -1)
        cache = KVSlice(r(3, MAX_LEN, H, Dh), r(3, MAX_LEN, H, Dh),
                        sp.contiguous())
        q = r(3, S, H, Dh)
        out = paged_extend_attention(q, *dense_kv_arena(cache), pos, 0)
        ref = extend_attention_ref(q, cache.k, cache.v, sp,
                                   pos[:, None] + slots[None, :S])
        torch.cuda.synchronize()
        hold("paged_extend_attention", out[:2], ref[:2], tol, why,
             f"{dt} dense S{MAX_LEN} as arena, Sq{S} Hq{H} Dh{Dh}")


# qwen3-4b's training shape: one microbatch of the global batch 8 at
# seq 512 under the config's microbatch 2
TRAIN_B, TRAIN_S = 4, 512


def check_flash_bwd(dev, gen, hold):
    """Flash attention's backward kernel against ``flash_attention_bwd_ref``
    on the same q, k, v, dout and the forward kernel's out and LSE, through
    both routes (bf16: the tensor-core kernels, row
    ``flash_attention_bwd``; float32: the CUDA-core kernels, row
    ``flash_attention_bwd_f32``): at qwen3-4b's training shape (causal,
    GQA 4) and under every mask the forward takes (causal, a window that
    crosses several q tiles, causal with q aligned to the end of longer
    keys, bidirectional under a key-length mask, cross-attention with Sq
    above and below Skv) at head dims 64 (seamless, MHA), 80 (zamba2, MHA)
    and 128 (qwen3-4b, GQA 4), at lengths no tile divides; and two calls
    at the training shape bitwise equal (deterministic)."""
    from repro_torch.kernels.flash_attention.ops import (
        _flash_forward,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    masks = [(2, 200, 200, True, None, None),        # (B, Sq, Skv, causal,
             (2, 200, 200, True, 64, None),          # window, kv_len)
             (2, 72, 200, True, None, None),
             (3, 200, 200, False, None, (101, 200, 37)),
             (3, 72, 200, False, None, (101, 1, 200)),
             (3, 200, 72, False, None, (37, 72, 5))]
    heads = [(ENC_H, ENC_H, ENC_DH), (ZAMBA_H, ZAMBA_H, ZAMBA_DH),
             (HQ, HKV, DH)]
    cases = [(TRAIN_B, TRAIN_S, TRAIN_S, HQ, HKV, DH, True, None, None)] + [
        (B, sq, skv, hq, hkv, dh, causal, window, kv)
        for hq, hkv, dh in heads for B, sq, skv, causal, window, kv in masks]
    for dt, name, tol, why in (
            (torch.bfloat16, "flash_attention_bwd", 2e-2,
             "bf16 P, dS and outputs; plain version float32"),
            (torch.float32, "flash_attention_bwd_f32", 1e-4,
             "f32; sums over G x Sq terms in another order")):
        for B, sq, skv, hq, hkv, dh, causal, window, kv in cases:
            r = lambda *sh: torch.randn(sh, generator=gen,  # noqa: E731
                                        device=dev).to(dt)
            q, k, v, do = r(B, sq, hq, dh), r(B, skv, hkv, dh), \
                r(B, skv, hkv, dh), r(B, sq, hq, dh)
            kl = (None if kv is None
                  else torch.tensor(kv, dtype=torch.int32, device=dev))
            out, lse = _flash_forward(q, k, v, causal, window, kl, True)
            got = flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                      window=window, kv_len=kl)
            want = flash_attention_bwd_ref(
                *(t.transpose(1, 2) for t in (q, k, v, out, do)), lse,
                causal=causal, window=window, kv_len=kl)
            torch.cuda.synchronize()
            errs = []
            for grad, g, w in zip(("dq", "dk", "dv"), got, want):
                hold(name, g, w.transpose(1, 2), tol, why,
                     f"{grad} {dt} B{B} Sq{sq} Skv{skv} Hq{hq} Hkv{hkv} "
                     f"Dh{dh} causal={causal} window={window} kv_len={kv}")
                errs.append(float((g.float() - w.transpose(1, 2).float())
                                  .abs().max()))
            log(f"  {name:24s} max abs err dq {errs[0]:.3e} dk "
                f"{errs[1]:.3e} dv {errs[2]:.3e}")
            if (B, sq) == (TRAIN_B, TRAIN_S):
                again = flash_attention_bwd(q, k, v, out, do, lse,
                                            causal=causal)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name}: two calls differ")
        log(f"  {name:24s} two calls at the training shape bitwise equal: "
            "ok")


def time_flash_bwd(dev, gen, flush, kernels, hold):
    """Rows 1e and 1f: the backward at qwen3-4b's training shape (causal,
    B4 S512 Hq32 Hkv8 Dh128) through the bf16 tensor-core route and the
    float32 CUDA-core route, each beside its plain version and, as the
    library's time, one SDPA forward + backward less its forward (SDPA
    over K/V repeated to the 32 q heads; its dK and dV are per q head).
    Row 1g: the forward with its LSE at the same shape in bf16 (phase 13
    launches it twice a layer a microbatch), held against its plain
    version and timed beside SDPA's forward."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        _flash_forward,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        flash_attention_bwd_ref,
    )
    B, S = TRAIN_B, TRAIN_S
    for dt, name in ((torch.bfloat16, "flash_attention_bwd"),
                     (torch.float32, "flash_attention_bwd_f32")):
        r = lambda *sh: torch.randn(sh, generator=gen,  # noqa: E731
                                    device=dev).to(dt)
        q, k, v, do = r(B, S, HQ, DH), r(B, S, HKV, DH), r(B, S, HKV, DH), \
            r(B, S, HQ, DH)
        out, lse = _flash_forward(q, k, v, True, None, None, True)
        plain = [t.transpose(1, 2) for t in (q, k, v, out, do)]
        lib = [t.transpose(1, 2).contiguous().requires_grad_() for t in
               (q, k.repeat_interleave(HQ // HKV, dim=2),
                v.repeat_interleave(HQ // HKV, dim=2))]
        do_t = do.transpose(1, 2).contiguous()

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(*lib, is_causal=True)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(*lib, is_causal=True)
            torch.autograd.grad(o, lib, do_t)

        elem = q.element_size()
        # q, out, dout in and dq out; k, v in and dk, dv out; the LSE in
        n_bytes = (4 * q.numel() + 4 * k.numel()) * elem + lse.numel() * 4
        n_ops = 5 * 2 * DH * HQ * B * S * (S + 1) // 2
        fwd = time_ms(sdpa_fwd, flush=flush)
        kernels[name].update(
            shape=f"B{B} S{S} Hq{HQ} Hkv{HKV} Dh{DH} {dt} causal",
            ms=time_ms(lambda: flash_attention_bwd(q, k, v, out, do, lse),
                       flush=flush),
            plain_ms=time_ms(lambda: flash_attention_bwd_ref(*plain, lse),
                             flush=flush),
            library_ms=time_ms(sdpa_fwd_bwd, flush=flush) - fwd,
            **bound(n_bytes, n_ops, dt))
        rep = kernels[name]
        log(f"  {name} library: SDPA forward {fwd:.4f} ms, forward + "
            f"backward less forward {rep['library_ms']:.4f} ms; kernel "
            f"{rep['ms']:.4f} ms, {rep['bound_ms'] / rep['ms']:.3f} of the "
            f"bound ({rep['bound_by']}), {rep['ms'] / rep['library_ms']:.3f}x "
            "SDPA")
        log(f"  {name} kernels of a call: " + kernel_split(
            lambda: flash_attention_bwd(q, k, v, out, do, lse)))
        if dt != torch.bfloat16:
            continue
        want, want_lse = attention_ref(*plain[:3], return_lse=True)
        hold("flash_attention_train", out, want.transpose(1, 2), 2e-2,
             "bf16 output rounding", f"out B{B} S{S} Hq{HQ} Hkv{HKV} Dh{DH} "
             "causal, with the LSE")
        hold("flash_attention_train", lse, want_lse, 1e-3,
             "bf16 products, float32 sums", f"lse B{B} S{S} Hq{HQ} Hkv{HKV} "
             f"Dh{DH} causal")
        n_bytes = (2 * q.numel() + 2 * k.numel()) * elem + lse.numel() * 4
        n_ops = 4 * DH * HQ * B * S * (S + 1) // 2
        kernels["flash_attention_train"].update(
            shape=f"B{B} S{S} Hq{HQ} Hkv{HKV} Dh{DH} bf16 causal, LSE",
            ms=time_ms(lambda: _flash_forward(q, k, v, True, None, None,
                                              True), flush=flush),
            plain_ms=time_ms(lambda: attention_ref(*plain[:3],
                                                   return_lse=True),
                             flush=flush),
            library_ms=fwd, **bound(n_bytes, n_ops, dt))


def time_flash_f32(dev, gen, flush, kernels, hold) -> None:
    """Rows 1i, 2e and 2e': the float32 routes of prefill flash and paged
    extend (CUDA cores, exact float32 products).  1i: the forward with
    its LSE at qwen3-4b's training shape (B4 S512, causal; what a float32
    train step launches, beside row 1f's backward), also logged at row
    1's serving shape (B8 S128, no LSE); 2e and 2e': row 2's extend (B8,
    64 suffix queries behind a 64-token prefix, n_log 8, P 16) in float32
    over a float32 and an int8 arena.  Each is held to its plain version
    (the LSE too), two calls must be bitwise equal, and each is timed
    beside its plain version, one float32 SDPA call (the forward over K/V
    repeated to the q heads; the extend's over the pages gathered
    beforehand, with a boolean mask; the backend PyTorch picks is named
    from profiled calls at 1i's shape) and its bound at the float32 peak,
    with the kernels of a call (``kernel_split``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        _flash_forward,
        paged_extend_attention,
    )
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        gather_pages_ref,
        paged_extend_attention_ref,
    )
    f32, g = torch.float32, HQ // HKV
    r = lambda *sh: torch.randn(sh, generator=gen, device=dev)  # noqa: E731

    def expand(x):      # (B, S, Hkv, Dh) -> (B, Hq, S, Dh)
        return x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()

    def repeat_equal(name, fn):
        a, b = fn(), fn()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        if not all(torch.equal(x, y) for x, y in zip(a, b)
                   if x is not None):
            raise AssertionError(f"{name}: two float32 calls differ")
        log(f"  {name:24s} two calls bitwise equal: ok")

    for B, S, lse in ((TRAIN_B, TRAIN_S, True), (SLOTS, 128, False)):
        q, k, v = r(B, S, HQ, DH), r(B, S, HKV, DH), r(B, S, HKV, DH)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ke, ve = expand(k), expand(v)
        out, got_lse = _flash_forward(q, k, v, True, None, None, lse)
        want = attention_ref(qt, kt, vt, return_lse=lse)
        name = "flash_attention_f32_train"
        shape = f"B{B} S{S} Hq{HQ} Hkv{HKV} Dh{DH} f32 causal" + (
            ", LSE" if lse else "")
        if lse:
            want, want_lse = want
            hold(name, got_lse, want_lse, 1e-5, "f32; summation order",
                 f"lse {shape}")
        hold(name, out, want.transpose(1, 2), 2e-5, "f32; summation order",
             f"out {shape}")
        repeat_equal(name, lambda: _flash_forward(q, k, v, True, None, None,
                                                  lse))

        def sdpa():
            F.scaled_dot_product_attention(qt, ke, ve, is_causal=True)

        rep = dict(
            shape=shape,
            ms=time_ms(lambda: _flash_forward(q, k, v, True, None, None, lse),
                       flush=flush),
            plain_ms=time_ms(lambda: attention_ref(qt, kt, vt,
                                                   return_lse=lse),
                             flush=flush),
            library_ms=time_ms(sdpa, flush=flush),
            **bound((2 * q.numel() + 2 * k.numel()) * 4
                    + (B * HQ * S * 4 if lse else 0),
                    4 * DH * HQ * B * S * (S + 1) // 2, f32))
        log(f"  {name} {shape}: kernel {rep['ms']:.4f} ms, "
            f"{rep['bound_ms'] / rep['ms']:.3f} of the bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}), plain "
            f"{rep['plain_ms']:.4f} ms, SDPA {rep['library_ms']:.4f} ms")
        log(f"  {name} kernels of a call: " + kernel_split(
            lambda: _flash_forward(q, k, v, True, None, None, lse)))
        if lse:
            log(f"  {name} SDPA's kernels (the backend PyTorch picks): "
                + kernel_split(sdpa))
            kernels[name].update(rep)
        del q, k, v, qt, kt, vt, ke, ve

    sh = main_path_shapes()
    S, pos0, n_log = sh["S_ext"], SHARED, sh["n_log_ext"]
    pos = torch.full((SLOTS,), pos0, dtype=torch.int32, device=dev)
    q_pos = pos[:, None] + torch.arange(S, device=dev)[None]
    q = r(SLOTS, S, HQ, DH)
    qt = q.transpose(1, 2).contiguous()
    n_ops = 4 * DH * HQ * SLOTS * sum(pos0 + i + 1 for i in range(S))
    for name, adt, tol, why in (
            ("paged_extend_attention_f32", f32, 2e-5, "f32; summation order"),
            ("paged_extend_attention_f32_int8", torch.int8, 2e-4,
             "same int8 values and scales dequantised on both sides")):
        a = build_arena(gen, [pos0 + S] * SLOTS, n_log, adt, dev)
        args = (a["k"], a["v"], a["slot_pos"], a["block_table"], pos, LAYER)
        sc = dict(k_scale=a["k_scale"], v_scale=a["v_scale"])
        kd, vd, spd = gather_pages_ref(*args[:4], LAYER, **sc)
        kd, vd = expand(kd.float()), expand(vd.float())
        mask = ((spd[:, None, :] >= 0)
                & (spd[:, None, :] <= q_pos[:, :, None]))[:, None]
        shape = (f"B{SLOTS} S{S} pos{pos0} n_log{n_log} P{PAGE} L{LAYERS} "
                 f"Hq{HQ} Hkv{HKV} Dh{DH} q f32 arena {str(adt)[6:]}")
        hold(name, paged_extend_attention(q, *args, **sc),
             paged_extend_attention_ref(qt, *args, **sc).transpose(1, 2),
             tol, why, shape)
        repeat_equal(name, lambda: paged_extend_attention(q, *args, **sc))

        def sdpa():
            F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask)

        n_slots = pages_read([pos0 + S] * SLOTS, n_log) * PAGE
        rep = dict(
            shape=shape,
            ms=time_ms(lambda: paged_extend_attention(q, *args, **sc),
                       flush=flush),
            plain_ms=time_ms(lambda: paged_extend_attention_ref(qt, *args,
                                                                **sc),
                             flush=flush),
            library_ms=time_ms(sdpa, flush=flush),
            **bound(2 * q.numel() * 4 + n_slots * (
                2 * HKV * DH * a["k"].element_size() + 4)
                + scale_bytes(a, n_slots), n_ops, f32))
        kernels[name].update(rep)
        log(f"  {name} {shape}: kernel {rep['ms']:.4f} ms, "
            f"{rep['bound_ms'] / rep['ms']:.3f} of the bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}), plain "
            f"{rep['plain_ms']:.4f} ms, SDPA {rep['library_ms']:.4f} ms")
        log(f"  {name} kernels of a call: " + kernel_split(
            lambda: paged_extend_attention(q, *args, **sc)))
        del a, args, kd, vd


def ssd_work(Bb, S, H, P, G, N, Q, *, esize=2, checkpoints=True):
    """(bytes, float32 operations) of one ``ops.ssd`` call: x, B and C
    read once at ``esize`` bytes an element, dt read once, y and the final
    state written once in float32, and with ``checkpoints`` the state
    after each of the S / Q chunks; the products of the scan's sub-chunks
    of T = min(Q, 16) steps: C B^T once per group and its product with x
    per head, at the pairs at or below each diagonal, the state update and
    the state -> output term per head."""
    nc, T = S // Q, min(Q, 16)
    n_bytes = (esize * (Bb * S * H * P + 2 * Bb * S * G * N) + 4 * H
               + 4 * (Bb * S * H + Bb * S * H * P + Bb * H * P * N))
    if checkpoints:
        n_bytes += 4 * Bb * nc * H * P * N
    n_ops = Bb * S * (G * (T + 1) * N + H * ((T + 1) * P + 4 * P * N))
    return n_bytes, n_ops


def time_ssd(dev, gen, flush, kernels) -> None:
    """The SSD scan at mamba2-2.7b's cold prefill (8 rows of the 128-token
    bucket, bf16 x, B and C as the model hands them over, a checkpoint at
    every 16-token page) and the same call without checkpoints (the
    dense-cache prefill's, one 128-step chunk), each beside its plain
    version; the first is filed as the kernel's row.  No single PyTorch
    call computes it (library: none).  The bound counts operations at the
    float32 CUDA-core peak, the route the kernel's products take."""
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    x, dt, A_log, B, C = ssd_inputs(gen, dev, SLOTS, 128, SSD_H, SSD_P, 1,
                                    SSD_N)
    x, B, C = (t.to(torch.bfloat16) for t in (x, B, C))
    for Q, ckpt in ((PAGE, True), (128, False)):
        kw = dict(chunk=Q, checkpoints=ckpt)
        rep = dict(shape=f"B{SLOTS} S128 Q{Q} H{SSD_H} P{SSD_P} N{SSD_N} "
                         f"bf16 in, f32 out, checkpoints={ckpt}",
                   ms=time_ms(lambda: ssd(x, dt, A_log, B, C, **kw),
                              flush=flush),
                   library_ms=None,
                   **bound(*ssd_work(SLOTS, 128, SSD_H, SSD_P, 1, SSD_N, Q,
                                     checkpoints=ckpt), torch.float32))
        rep["gb_per_s"] = rep["bytes"] / rep["ms"] / 1e6
        rep["plain_ms"] = time_ms(lambda: ssd_ref(x, dt, A_log, B, C, **kw),
                                  flush=flush)
        log(f"  ssd {rep['shape']}: kernel {rep['ms']:.4f} ms, plain "
            f"{rep['plain_ms']:.4f} ms, bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_by']}), "
            f"{rep['gb_per_s']:.0f} GB/s, {rep['bound_ms'] / rep['ms']:.3f}"
            " of the bound")
        if ckpt:
            kernels["ssd"].update(rep)


def main_path_shapes() -> dict:
    """The main path's attention shapes (rows 1, 2 and 4 of ``PERF.md``):
    the cold wave's prefill bucket ``S``; the warm wave's suffix bucket
    ``S_ext`` behind the shared prefix over ``n_log_ext`` pages; the decode
    step half-way through the cold wave's new tokens, ``kv_lens`` over
    ``n_log_dec`` pages."""
    waves = main_path_prompts()
    lens = [len(p) for p in waves[0]]
    kv_lens = [n + MAX_NEW // 2 for n in lens]
    return {"S": -(-max(lens) // CHUNK) * CHUNK,
            "S_ext": -(-max(len(p) - SHARED for p in waves[1]) // CHUNK)
            * CHUNK,
            "n_log_ext": min(pow2(-(-max(len(p) for p in waves[1]) // PAGE)),
                             MAX_LEN // PAGE),
            "kv_lens": kv_lens,
            "n_log_dec": min(pow2(max(kv_lens) // PAGE + 1), MAX_LEN // PAGE)}


def time_attention(dev, gen, flush, kernels, hold, hq, hkv, dh, names, *,
                   dense=False, store=True, n_layers=LAYERS):
    """The three attention kernels of a serving path at the main path's
    shapes (``main_path_shapes``), bf16, at ``hq`` q heads over ``hkv`` kv
    heads of ``dh``: the cold prefill (flash, causal), the warm suffix
    extend behind the 64-token prefix and a decode step, each held against
    its plain version (bf16 tolerance) and timed beside it, one
    ``scaled_dot_product_attention`` call (over the kv heads repeated to
    the q heads, with a boolean mask where one is needed) and its bound.

    ``names`` maps each call ("flash", "extend", "decode", and
    "extend_int8" / "decode_int8" for the same calls over an int8 arena)
    to its row.  Paged (the default): the extend and the decode read a
    paged arena of ``n_layers`` layers at its middle layer.  ``dense``
    (zamba2-2.7b's snapshot path): the extend reads the dense per-slot
    cache as an arena, the decode is the dense kernel over 512 slots at
    kv_len 87..129.  ``store``: write each row into ``kernels``, else log
    it (its error still held, under the row's kernel).  An int8 row's
    library call is SDPA over the pages dequantised to bf16 beforehand, a
    yardstick that reads bf16 where the kernel reads int8."""
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
    from repro_torch.models.layers import KVSlice, dense_kv_arena
    bf16, e, g = torch.bfloat16, 2, hq // hkv
    sh = main_path_shapes()
    heads = f"Hq{hq} Hkv{hkv} Dh{dh}"
    why = "bf16 output and P rounding"
    r = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                   device=dev).to(bf16)

    def expand(x):      # (B, S, Hkv, Dh) -> (B, Hq, S, Dh)
        return x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()

    def row(kind, shape, kern, plain, out, ref, lib, bd):
        name = names[kind]
        hold(name, out, ref, 2e-2, why, shape)
        rep = dict(shape=shape, ms=time_ms(kern, flush=flush),
                   plain_ms=time_ms(plain, flush=flush),
                   library_ms=time_ms(lib, flush=flush), **bd)
        if store:
            kernels[name].update(rep)
        else:
            log(f"  {name} {shape}: kernel {rep['ms']:.4f} ms, plain "
                f"{rep['plain_ms']:.4f} ms, library {rep['library_ms']:.4f}"
                f" ms, bound {rep['bound_ms']:.4f} ms ({rep['bound_by']})")

    # the cold prefill: 8 rows of the cold wave's bucket, causal
    S = sh["S"]
    q, k, v = r(SLOTS, S, hq, dh), r(SLOTS, S, hkv, dh), r(SLOTS, S, hkv, dh)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ke, ve = expand(k), expand(v)
    row("flash", f"B{SLOTS} S{S} {heads} bf16 causal",
        lambda: flash_attention(q, k, v), lambda: attention_ref(qt, kt, vt),
        flash_attention(q, k, v), attention_ref(qt, kt, vt).transpose(1, 2),
        lambda: F.scaled_dot_product_attention(qt, ke, ve, is_causal=True),
        bound((2 * q.numel() + 2 * k.numel()) * e,
              4 * dh * hq * SLOTS * S * (S + 1) // 2, bf16))
    del q, k, v, qt, kt, vt, ke, ve

    # the warm extend: 8 suffixes of the warm wave's bucket behind the
    # 64-token shared prefix
    S, pos0 = sh["S_ext"], SHARED
    pos = torch.full((SLOTS,), pos0, dtype=torch.int32, device=dev)
    q_pos = pos[:, None] + torch.arange(S, device=dev)[None]
    q = r(SLOTS, S, hq, dh)
    qt = q.transpose(1, 2).contiguous()
    n_ops = 4 * dh * hq * SLOTS * sum(pos0 + i + 1 for i in range(S))
    if dense:
        slots = torch.arange(MAX_LEN, dtype=torch.int32, device=dev)
        sp = torch.where(slots[None] < pos[:, None] + S, slots[None], -1)
        cache = KVSlice(r(SLOTS, MAX_LEN, hkv, dh), r(SLOTS, MAX_LEN, hkv, dh),
                        sp.contiguous())
        arena = dense_kv_arena(cache)
        kd, vd = expand(cache.k), expand(cache.v)
        mask = ((sp[:, None, :] >= 0) & (sp[:, None, :] <= q_pos[:, :, None])
                )[:, None]
        n_slots = SLOTS * (pos0 + S)
        row("extend", f"dense S{MAX_LEN} as arena, B{SLOTS} Sq{S} "
            f"pos{pos0} {heads} bf16",
            lambda: paged_extend_attention(q, *arena, pos, 0),
            lambda: paged_extend_attention_ref(qt, *arena, pos, 0),
            paged_extend_attention(q, *arena, pos, 0),
            paged_extend_attention_ref(qt, *arena, pos, 0).transpose(1, 2),
            lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                   attn_mask=mask),
            bound(2 * q.numel() * e + n_slots * (2 * hkv * dh * e + 4),
                  n_ops, bf16))
        del cache, arena, kd, vd
    for kind, adt in (("extend", bf16), ("extend_int8", torch.int8)):
        if dense or kind not in names:
            continue
        n_log = sh["n_log_ext"]
        a = build_arena(gen, [pos0 + S] * SLOTS, n_log, adt, dev,
                        n_layers=n_layers, hkv=hkv, dh=dh)
        args = (a["k"], a["v"], a["slot_pos"], a["block_table"], pos,
                n_layers // 2)
        sc = dict(k_scale=a["k_scale"], v_scale=a["v_scale"])
        kd, vd, spd = gather_pages_ref(*dequantised(a), a["slot_pos"],
                                       a["block_table"], n_layers // 2)
        kd, vd = expand(kd), expand(vd)
        mask = ((spd[:, None, :] >= 0)
                & (spd[:, None, :] <= q_pos[:, :, None]))[:, None]
        n_slots = pages_read([pos0 + S] * SLOTS, n_log) * PAGE
        row(kind, f"B{SLOTS} S{S} pos{pos0} n_log{n_log} P{PAGE} "
            f"L{n_layers} {heads} q bf16 arena {str(adt)[6:]}",
            lambda: paged_extend_attention(q, *args, **sc),
            lambda: paged_extend_attention_ref(qt, *args, **sc),
            paged_extend_attention(q, *args, **sc),
            paged_extend_attention_ref(qt, *args, **sc).transpose(1, 2),
            lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                   attn_mask=mask),
            bound(2 * q.numel() * e + n_slots * (
                2 * hkv * dh * a["k"].element_size() + 4)
                + scale_bytes(a, n_slots), n_ops, bf16))
        del a, args, kd, vd
    del q, qt

    # a decode step half-way through the cold wave's new tokens
    q = r(SLOTS, 1, hq, dh)
    qt = q.transpose(1, 2).contiguous()
    if dense:
        kv_lens = [87, 95, 103, 111, 113, 121, 127, 129]
        kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        k, v = r(SLOTS, MAX_LEN, hkv, dh), r(SLOTS, MAX_LEN, hkv, dh)
        kd, vd = expand(k), expand(v)
        mask = (torch.arange(MAX_LEN, device=dev)[None] < kl[:, None]
                )[:, None, None]
        row("decode", f"B{SLOTS} S{MAX_LEN} kv_len{kv_lens[0]}.."
            f"{kv_lens[-1]} {heads} bf16",
            lambda: decode_attention(q, k, v, kl),
            lambda: decode_attention_ref(q[:, 0], k, v, kl),
            decode_attention(q, k, v, kl),
            decode_attention_ref(q[:, 0], k, v, kl)[:, None],
            lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                   attn_mask=mask),
            bound(2 * q.numel() * e + 4 * SLOTS
                  + sum(kv_lens) * 2 * hkv * dh * e,
                  4 * dh * hq * sum(kv_lens), bf16))
        return
    kv_lens, n_log = sh["kv_lens"], sh["n_log_dec"]
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    for kind, adt in (("decode", bf16), ("decode_int8", torch.int8)):
        if kind not in names:
            continue
        a = build_arena(gen, kv_lens, n_log, adt, dev, n_layers=n_layers,
                        hkv=hkv, dh=dh)
        args = (a["k"], a["v"], a["slot_pos"], a["block_table"], kl,
                n_layers // 2)
        sc = dict(k_scale=a["k_scale"], v_scale=a["v_scale"])
        kd, vd, spd = gather_pages_ref(*dequantised(a), a["slot_pos"],
                                       a["block_table"], n_layers // 2)
        kd, vd = expand(kd), expand(vd)
        mask = ((spd >= 0) & (spd < kl[:, None]))[:, None, None]
        n_slots = pages_read(kv_lens, n_log) * PAGE
        row(kind, f"B{SLOTS} kv_len{min(kv_lens)}..{max(kv_lens)} "
            f"n_log{n_log} P{PAGE} L{n_layers} {heads} q bf16 arena "
            f"{str(adt)[6:]}",
            lambda: paged_decode_attention(q, *args, **sc),
            lambda: paged_decode_attention_ref(q[:, 0], *args, **sc),
            paged_decode_attention(q, *args, **sc),
            paged_decode_attention_ref(q[:, 0], *args, **sc)[:, None],
            lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                   attn_mask=mask),
            bound(2 * q.numel() * e + n_slots * (
                2 * hkv * dh * a["k"].element_size() + 4)
                + scale_bytes(a, n_slots), 4 * dh * hq * sum(kv_lens), bf16))
        del a, args, kd, vd


def time_long_decode(dev, gen, flush):
    """Paged decode at a long context, logged on a line of its own: the
    main path's heads, 8 rows with kv_len 2048..4096 over n_log 256 pages
    of an arena sized for them (4 layers, layer 2), beside its plain
    version and one ``scaled_dot_product_attention`` call over the
    gathered cache.  Here the split across a cluster is what keeps every
    SM reading."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.ops import (
        decode_splits,
        paged_decode_attention,
    )
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
    )
    from repro_torch.kernels.flash_attention.ref import gather_pages_ref
    bf16, n_log, layer = torch.bfloat16, 256, 2
    kv_lens = [2048 + 2048 * i // (SLOTS - 1) for i in range(SLOTS)]
    a = build_arena(gen, kv_lens, n_log, bf16, dev, n_layers=4)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.randn((SLOTS, 1, HQ, DH), generator=gen, device=dev).to(bf16)
    args = (a["k"], a["v"], a["slot_pos"], a["block_table"], kl, layer)
    out = paged_decode_attention(q, *args)
    ref = paged_decode_attention_ref(q[:, 0], *args)[:, None]
    torch.cuda.synchronize()
    r = rel(out, ref)
    if not r < 2e-2:
        raise AssertionError(f"paged decode at a long context: rel {r}")
    kd, vd, spd = gather_pages_ref(*args[:4], layer)
    kd, vd = (x.transpose(1, 2).repeat_interleave(HQ // HKV, dim=1)
              .contiguous() for x in (kd, vd))
    mask = ((spd >= 0) & (spd < kl[:, None]))[:, None, None]
    qt = q.transpose(1, 2).contiguous()
    n_slots = pages_read(kv_lens, n_log) * PAGE
    bd = bound(2 * q.numel() * 2 + n_slots * (2 * HKV * DH * 2 + 4),
               4 * DH * HQ * sum(kv_lens), bf16)
    n_split = decode_splits(n_log, SLOTS * HKV, _build.sm_count(dev))
    log(f"  paged_decode_attention at a long context, B{SLOTS} kv_len "
        f"{kv_lens[0]}..{kv_lens[-1]} n_log{n_log} P{PAGE} bf16, {n_split} "
        f"splits: rel={r:.3e} tol=2e-02, kernel "
        f"{time_ms(lambda: paged_decode_attention(q, *args), flush=flush):.4f}"
        f" ms, plain {time_ms(lambda: paged_decode_attention_ref(q[:, 0], *args), flush=flush):.4f}"
        f" ms, library {time_ms(lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask), flush=flush):.4f}"
        f" ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")


def routed_counts(dev, capacity: int, tokens: int = 0):
    """Per-expert token counts of a top-6 routing over the 64 experts of
    deepseek-moe-16b: ``capacity`` tokens at decode (8: dropless), else the
    tokens behind that capacity at inference (C = 6 * 2 * T / 64: 1024
    tokens at the cold prefill's C 192, 512 at the warm extend's C 96), or
    ``tokens`` (training: 2048 a microbatch at C 240, capacity factor
    1.25).  Drawn from a generator of their own, seeded by the capacity,
    so that the counts at a shape do not depend on what the checks before
    them drew."""
    gen = torch.Generator(device=dev).manual_seed(capacity)
    tokens = tokens or (capacity if capacity <= 64 else capacity * 16 // 3)
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
    for name, regs, spill in ptxas_summary(
            (_build.BUILD_DIR / "ptxas.log").read_text()):
        log(f"[2]   {regs:>3} registers, {spill:>3} bytes spilled: {name}")


def ptxas_summary(text: str):
    """(kernel, registers, bytes of spill stores) of each entry function in
    nvcc's ptxas report, the names demangled where c++filt is on PATH."""
    import re
    import shutil
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), spill])
            name, spill = None, 0
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True).stdout.splitlines()
        for r, d in zip(rows, out):
            r[0] = d.split("(")[0].replace("rt::", "").replace(
                "__nv_bfloat16", "bf16").replace("void ", "")
    return rows


# --------------------------------------------------------------------------
# phase 4: the port's batcher on the card == on the CPU (float32, smoke)
# --------------------------------------------------------------------------
# (name, arch, batcher options, weight seed, prompt seed, waves of prompt
# tail lengths behind a 20-token shared prefix); seeds under which the
# greedy tokens vary, so a mismatch cannot hide in a constant stream
PARITY = [
    ("qwen3-4b paged, cold and warm", "qwen3-4b",
     dict(max_len=64, prefill_chunk=8), 0, 4, ([3, 9, 5], [6, 2])),
    ("qwen3-4b int8 paged, cold and warm", "qwen3-4b",
     dict(max_len=64, prefill_chunk=8, kv_dtype="int8"), 0, 4,
     ([3, 9, 5], [6, 2])),
    ("deepseek-moe-16b paged, cold and warm", "deepseek-moe-16b",
     dict(max_len=64, prefill_chunk=8), 1, 4, ([3, 9, 5], [6, 2])),
    ("qwen3-4b dense cache (kv_pool=None)", "qwen3-4b",
     dict(max_len=64, prefill_chunk=8, kv_pool=None), 0, 4,
     ([3, 9, 5], [6, 2])),
    ("qwen3-4b token at a time (prefill_chunk=None)", "qwen3-4b",
     dict(max_len=64, prefill_chunk=None), 0, 4, ([3, 9, 5], [6, 2])),
    ("mixtral-8x7b rolling window 64 < max_len 128", "mixtral-8x7b",
     dict(max_len=128, prefill_chunk=8), 0, 5, ([60, 45], [70])),
    ("mamba2-2.7b snapshot pool, cold and warm", "mamba2-2.7b",
     dict(max_len=64, prefill_chunk=8), 0, 4, ([3, 9, 5], [6, 2])),
    ("mamba2-2.7b dense cache (kv_pool=None)", "mamba2-2.7b",
     dict(max_len=64, prefill_chunk=8, kv_pool=None), 0, 4,
     ([3, 9, 5], [6, 2])),
    ("zamba2-2.7b snapshot pool, cold and warm", "zamba2-2.7b",
     dict(max_len=64, prefill_chunk=8), 0, 4, ([3, 9, 5], [6, 2])),
    ("zamba2-2.7b dense cache (kv_pool=None)", "zamba2-2.7b",
     dict(max_len=64, prefill_chunk=8, kv_pool=None), 0, 4,
     ([3, 9, 5], [6, 2])),
    # encdec: every request but one a wave carries a source (parity_run)
    ("seamless-m4t-large-v2 paged, cold and warm", "seamless-m4t-large-v2",
     dict(max_len=64, prefill_chunk=8), 0, 5, ([3, 9, 5], [6, 2])),
    ("seamless-m4t-large-v2 token at a time, dense cache",
     "seamless-m4t-large-v2",
     dict(max_len=64, prefill_chunk=None, kv_pool=None), 0, 5,
     ([3, 9, 5], [6, 2])),
] + [
    # the four archs of phases 20a-20d at their own attention group and
    # head dim over one kv head (``real_heads``: G 8, 7, 5 at 128 and G 12
    # at 192), the float32 CUDA-core kernels behind the batcher
    (f"{arch} at its own heads, paged, cold and warm", arch,
     dict(max_len=64, prefill_chunk=8, real_heads=True), 0, 4,
     ([3, 9, 5], [6, 2])) for _, arch, _ in ARCH_PHASES]


def parity_run(dev, arch, opts, weight_seed, prompt_seed, waves):
    """The same smoke model, weights and prompts through the port's
    batcher on the CPU (plain versions) and on the card (kernels), in two
    rounds: round 2 a new shared prefix and new tokens with round 1's tail
    lengths (its prefills replay on the card).  An encdec model's requests
    carry sources: in each round's first wave ragged ones (5..40 frames)
    but the middle request's (``src=None``), which the second wave reuses
    request by request.  Returns ({device: {rid: tokens}}, {device:
    prefix-hit tokens}); on a snapshot pool the hits are the snapshot
    hits."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.param import params_from_numpy, tree_map
    from repro_torch.serve.batcher import ContinuousBatcher, Request

    opts = dict(opts)
    cfg = (real_heads(arch) if opts.pop("real_heads", False)
           else smoke_config(get_arch(arch)))
    model = Model(cfg.replace(dtype="float32"))
    ref_params = model.init(torch.Generator().manual_seed(weight_seed),
                            device="cpu")
    host = tree_map(lambda t: t.numpy(), ref_params)
    rng = np.random.default_rng(prompt_seed)
    prompts, srcs = [], []
    for _ in range(2):
        shared = rng.integers(1, model.cfg.vocab, size=20).astype(np.int32)
        prompts.append([[np.concatenate([shared, rng.integers(
            1, model.cfg.vocab, size=n).astype(np.int32)]) for n in lens]
            for lens in waves])
        first = [None] * max(len(lens) for lens in waves)
        if model.cfg.family == "encdec":
            first = [None if i == 1 else rng.standard_normal(
                (int(rng.integers(5, 41)), model.cfg.d_model)).astype(
                np.float32) for i in range(len(first))]
        srcs.append([first[:len(lens)] for lens in waves])
    toks, hits = {}, {}
    for device in ("cpu", dev):
        params = params_from_numpy(host, dtype=torch.float32, device=device,
                                   specs=model.param_specs())
        bat = ContinuousBatcher(model, params, batch_slots=2, page_size=8,
                                device=device, **opts)
        rid, mark = 0, None
        for r, (rnd, rsrc) in enumerate(zip(prompts, srcs)):
            if r and bat.step_graph is not None:
                mark = graph_mark(bat)
            for wave, wsrc in zip(rnd, rsrc):   # wave 2 hits wave 1's prefix
                for p, src in zip(wave, wsrc):
                    bat.submit(Request(rid=rid, prompt=p, max_new_tokens=6,
                                       src=src))
                    rid += 1
                bat.run_until_drained()
        toks[str(device)] = {r.rid: r.output for r in bat.done}
        if bat.step_graph is not None:
            expect_graphed(4, bat)
            # a path's first call in the process is eager, so a key of
            # round 1 may capture in round 2 here; it still replays
            expect_round2_replayed(4, bat, mark, strict=False)
            bat.close()
        if bat.pool is None:
            hits[str(device)] = 0
        elif bat.pool.payload_kind == "snapshot":
            hits[str(device)] = bat.pool.stats()["snapshot_hit_tokens"]
        else:
            hits[str(device)] = bat.pool.prefix_hit_tokens
    return toks, hits


# the disaggregated plane at smoke size: (name, arch, decode replicas,
# weight seed, prompt seed, waves of tail lengths behind a shared prefix)
DISAGG_PARITY = [
    ("qwen3-4b disaggregated, paged, 2 decode replicas", "qwen3-4b", 2, 0,
     4, ([3, 9, 5, 12], [6, 2, 11])),
    ("mamba2-2.7b disaggregated, snapshot plane", "mamba2-2.7b", 1, 0, 4,
     ([3, 9, 5], [6, 2])),
    ("seamless-m4t-large-v2 disaggregated, ragged sources",
     "seamless-m4t-large-v2", 2, 2, 6, ([3, 9, 5], [6, 2])),
]


def disagg_parity_run(dev, arch, replicas, weight_seed, prompt_seed, waves):
    """The same smoke model, weights and requests through the port's
    ``DisaggServer`` (a prefill cell, ``replicas`` decode cells, a ``kv``
    channel on a grid of one device) on the CPU and on the card, and
    through a colocated batcher on the CPU: two waves behind a 20-token
    shared prefix (the second warm in the prefill worker's and the
    replicas' pools), drained in turn; an encdec model's requests carry
    ragged sources (5..40 frames), the middle one none.  Returns ({what:
    {rid: tokens}}, {device: the card's worker and decode graph counts})."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (
        CellSpec,
        ChannelSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
    )
    from repro_torch.models.model import Model
    from repro_torch.models.param import params_from_numpy, tree_map
    from repro_torch.serve.batcher import ContinuousBatcher, Request
    from repro_torch.serve.disagg import DisaggServer

    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    model = Model(cfg)
    host = tree_map(lambda t: t.numpy(), model.init(
        torch.Generator().manual_seed(weight_seed), device="cpu"))
    rng = np.random.default_rng(prompt_seed)
    shared = rng.integers(1, cfg.vocab, size=20).astype(np.int32)
    prompts = [[np.concatenate([shared, rng.integers(
        1, cfg.vocab, size=n).astype(np.int32)]) for n in lens]
        for lens in waves]
    srcs = [[None if i == 1 or cfg.family != "encdec" else
             rng.standard_normal((int(rng.integers(5, 41)), cfg.d_model))
             .astype(np.float32) for i in range(len(w))] for w in waves]
    kw = dict(max_len=64, page_size=8)

    def drive(submit, drain):
        rid = 0
        for wave, wsrc in zip(prompts, srcs):
            for p, src in zip(wave, wsrc):
                submit(Request(rid=rid, prompt=p, max_new_tokens=6,
                               src=src))
                rid += 1
            drain()

    toks, graphs = {}, {}
    for device in ("cpu", dev):
        sup = Supervisor(DeviceGrid.from_flat([device], 1, 1, 1 + replicas,
                                              allow_reuse=True))
        spec = ClusterSpec(
            cells=(CellSpec("prefill", cfg, "serve", ncols=1),
                   CellSpec("decode", cfg, "serve", ncols=1,
                            replicas=replicas)),
            channels=(ChannelSpec("prefill", "decode", kind="kv"),))
        sup.apply(spec)
        names = spec.cell("decode").instances()
        sup.cells[names[0]].init_serve(params=params_from_numpy(
            host, dtype=torch.float32, device=device,
            specs=model.param_specs()))
        srv = DisaggServer(sup, "prefill", names, batch_slots=2, chunk=8,
                           **kw)
        drive(srv.submit, srv.run_until_drained)
        toks[str(device)] = {r.rid: r.output for r in srv.done}
        if srv.worker.step_graph is not None:
            graphs[str(device)] = {
                "worker": srv.worker.step_graph.stats(),
                "decode": [r.batcher.step_graph.stats()["decode"]
                           for r in srv.replicas]}
        st = srv.stats()
        if len(toks[str(device)]) != sum(map(len, waves)) or \
                st["requeued"] or not st["prefix_hit_tokens"]:
            raise AssertionError(f"{arch} on {device}: {st}")
        srv.close()
        for name in list(sup.cells):
            sup.destroy_cell(name)
    params = params_from_numpy(host, dtype=torch.float32, device="cpu",
                               specs=model.param_specs())
    bat = ContinuousBatcher(model, params, batch_slots=2, prefill_chunk=8,
                            device="cpu", **kw)
    drive(bat.submit, bat.run_until_drained)
    toks["colocated"] = {r.rid: r.output for r in bat.done}
    return toks, graphs


def disagg_mesh_parity_run(dev):
    """Float32 smoke qwen3-4b with four kv heads disaggregated over a
    (1, 2, 4) grid of the card (``DeviceGrid.from_flat([dev] * 8, 1, 2,
    4)``) and of ``cpu`` positions: the prefill cell over (2, 2) (its kv
    heads split over ``model``), two decode replicas over (2, 1) each
    (the heads whole), ``migrate=True``, the decode spec scaled to one
    replica right after the first wave's pump (its pages migrate, its
    slots are handed off or requeued); two waves behind a 20-token shared
    prefix.  Returns ({"cpu", device, "colocated": {rid: tokens}}, the
    card's server counters)."""
    import dataclasses

    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (
        CellSpec,
        ChannelSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
    )
    from repro_torch.models.model import Model
    from repro_torch.models.param import params_from_numpy, tree_map
    from repro_torch.serve.batcher import ContinuousBatcher, Request
    from repro_torch.serve.disagg import DisaggServer

    cfg = smoke_config(get_arch("qwen3-4b")).replace(dtype="float32",
                                                     num_kv_heads=4)
    model = Model(cfg)
    host = tree_map(lambda t: t.numpy(), model.init(
        torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(4)
    shared = rng.integers(1, cfg.vocab, size=20).astype(np.int32)
    waves = [[np.concatenate([shared, rng.integers(
        1, cfg.vocab, size=n).astype(np.int32)]) for n in lens]
        for lens in ([3, 9, 5, 12], [6, 2, 11])]
    kw = dict(max_len=64, page_size=8)
    toks, stats = {}, None
    for device in ("cpu", dev):
        sup = Supervisor(DeviceGrid.from_flat([device] * 8, 1, 2, 4))
        spec = ClusterSpec(
            cells=(CellSpec("prefill", cfg, "serve", ncols=2),
                   CellSpec("decode", cfg, "serve", ncols=1, replicas=2,
                            min_replicas=1, max_replicas=2)),
            channels=(ChannelSpec("prefill", "decode", kind="kv"),))
        sup.apply(spec)
        sup.cells["decode/0"].init_serve(params=params_from_numpy(
            host, dtype=torch.float32, device=str(device),
            specs=model.param_specs()))
        srv = DisaggServer(sup, "prefill", spec.cell("decode").instances(),
                           batch_slots=2, chunk=8, migrate=True, **kw)
        shapes = {n: c.mesh.shape for n, c in sup.cells.items()}
        if shapes != {"prefill": {"data": 2, "model": 2},
                      "decode/0": {"data": 2, "model": 1},
                      "decode/1": {"data": 2, "model": 1}}:
            raise AssertionError(f"disaggregated over a mesh: {shapes}")
        rid = 0
        for w, wave in enumerate(waves):
            for p in wave:
                srv.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
                rid += 1
            if w == 0:
                srv.pump()
                sup.apply(sup.desired.with_cell(dataclasses.replace(
                    sup.desired.cell("decode"), replicas=1)))
                srv.sync(sup.desired)
            srv.run_until_drained()
        toks[str(device)] = {r.rid: r.output for r in srv.done}
        st = srv.stats()
        if len(toks[str(device)]) != rid or not st["pages_migrated"] \
                or st["replicas"] != 1:
            raise AssertionError(f"disaggregated over a mesh on {device}: "
                                 f"{st}")
        stats = {k: st[k] for k in ("kv_bytes", "kv_transfers",
                                    "pages_migrated", "drain_handoffs",
                                    "requeued", "prefix_hit_tokens")}
        srv.close()
        for name in list(sup.cells):
            sup.destroy_cell(name)
    params = params_from_numpy(host, dtype=torch.float32, device="cpu",
                               specs=model.param_specs())
    bat = ContinuousBatcher(model, params, batch_slots=2, prefill_chunk=8,
                            device="cpu", **kw)
    rid = 0
    for wave in waves:
        for p in wave:
            bat.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
            rid += 1
        bat.run_until_drained()
    toks["colocated"] = {r.rid: r.output for r in bat.done}
    return toks, stats


# float32 smoke serve cells over two mesh positions of the card: (name,
# arch, weight seed, prompt seed, waves of tail lengths)
SHARDED_PARITY = [
    ("qwen3-4b over 2 positions, paged", "qwen3-4b", 0, 4,
     ([3, 9, 5], [6, 2])),
    ("deepseek-moe-16b over 2 positions, experts over model",
     "deepseek-moe-16b", 1, 4, ([3, 9, 5], [6, 2])),
    ("mamba2-2.7b over 2 positions, SSD heads over model, snapshot plane",
     "mamba2-2.7b", 2, 4, ([3, 9, 5], [6, 2])),
    ("zamba2-2.7b over 2 positions, snapshot plane", "zamba2-2.7b", 3, 4,
     ([3, 9, 5], [6, 2])),
    ("seamless-m4t-large-v2 over 2 positions, ragged sources",
     "seamless-m4t-large-v2", 4, 4, ([3, 9, 5], [6, 2])),
]


def sharded_parity_run(dev, arch, weight_seed, prompt_seed, waves):
    """The same float32 smoke weights and requests (encdec: and sources)
    through a serve cell of one position and a cell over two positions of
    the card (``Supervisor`` -> ``Cell`` -> ``make_batcher``), two waves
    behind a 20-token shared prefix, then the same again (its prefills
    replay).  Returns ({cell:
    {rid: tokens}}, the two-position batcher's graph counters, the
    collective bytes of its step keys)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (
        CellSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
    )
    from repro_torch.models.model import Model
    from repro_torch.models.param import params_from_numpy, tree_map
    from repro_torch.serve.batcher import Request

    cfg = smoke_config(get_arch(arch)).replace(dtype="float32")
    model = Model(cfg)
    host = tree_map(lambda t: t.numpy(), model.init(
        torch.Generator().manual_seed(weight_seed), device="cpu"))
    rng = np.random.default_rng(prompt_seed)
    shared = rng.integers(1, cfg.vocab, size=20).astype(np.int32)
    prompts = [[np.concatenate([shared, rng.integers(
        1, cfg.vocab, size=n).astype(np.int32)]) for n in lens]
        for lens in waves]
    # encdec: ragged sources, the requests of even tails without one
    srcs = [[rng.standard_normal((4 * n, cfg.d_model)).astype(np.float32)
             if cfg.family == "encdec" and n % 2 else None for n in lens]
            for lens in waves]
    toks, graphs, colls = {}, None, None
    for name, grid in (
            ("one", DeviceGrid.from_flat([dev], 1, 1, 2, allow_reuse=True)),
            ("two", DeviceGrid.from_flat([dev, dev], 1, 1, 2))):
        sup = Supervisor(grid)
        sup.apply(ClusterSpec(cells=(CellSpec("c", cfg, "serve", ncols=2),)))
        cell = sup.cells["c"]
        if cell.mesh.size != (2 if name == "two" else 1):
            raise AssertionError(f"{name}: mesh {cell.mesh}")
        cell.init_serve(params=params_from_numpy(
            host, dtype=torch.float32, device=dev, specs=model.param_specs()))
        bat = cell.make_batcher(batch_slots=2, max_len=64, page_size=8,
                                prefill_chunk=8)
        rid = 0
        for _ in range(2):
            for wave, wsrc in zip(prompts, srcs):
                for p, src in zip(wave, wsrc):
                    bat.submit(Request(rid=rid, prompt=p, max_new_tokens=6,
                                       src=src))
                    rid += 1
                bat.run_until_drained()
        toks[name] = {r.rid: r.output for r in bat.done}
        if name == "two":
            graphs = expect_graphed(4, bat)
            colls = {k: dict(v.collective_per_device)
                     for k, v in cell.accounting.programs.items()}
        bat.close()
        sup.destroy_cell("c")
    return toks, graphs, colls


#: (name, arch, weight seed, prompt seed) of phase 4's (2, 2) cases
ROWS_PARITY = [
    ("qwen3-4b over 2 rows of 2 positions, paged", "qwen3-4b", 0, 4),
    ("deepseek-moe-16b over 2 rows of 2 positions", "deepseek-moe-16b", 0,
     4),
    ("mamba2-2.7b over 2 rows of 2 positions, snapshot plane",
     "mamba2-2.7b", 0, 4),
    ("zamba2-2.7b over 2 rows of 2 positions, snapshot plane",
     "zamba2-2.7b", 0, 4),
    ("seamless-m4t-large-v2 over 2 rows of 2 positions, with sources",
     "seamless-m4t-large-v2", 0, 4),
]


def rows_parity_run(dev, arch, weight_seed, prompt_seed, cfg_kw=None,
                    bat_kw=None):
    """The same float32 smoke weights and requests through a serve cell of
    one position on the CPU and a cell over (``data`` 2, ``model`` 2) of
    the card, four slots (two a data row), three ticks behind a 20-token
    shared prefix S, twice (the second time warm, its prefills replays):
    S + 3 and S + 2 (one cold pair, its second row landing in slot 1 of
    data row 0), S + T1 + 5 and S + T2 + 5 (a warm pair, T2's page
    computed on data row 1 for slot 1), S + T2 + 3 alone (it hits T2's
    page; a group of one runs whole on both data rows).  encdec: the
    first request carries a source.  ``cfg_kw`` replaces config fields,
    ``bat_kw`` adds batcher options (an int8 pool: every position's
    scale tables must then be bitwise equal).  Returns ({"cpu", "rows":
    {rid: tokens}}, the card batcher's graph counters, the collective
    bytes of its step keys)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (
        CellSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
    )
    from repro_torch.models.model import Model
    from repro_torch.models.param import params_from_numpy, tree_map
    from repro_torch.serve.batcher import Request

    cfg = smoke_config(get_arch(arch)).replace(dtype="float32",
                                               **(cfg_kw or {}))
    model = Model(cfg)
    host = tree_map(lambda t: t.numpy(), model.init(
        torch.Generator().manual_seed(weight_seed), device="cpu"))
    rng = np.random.default_rng(prompt_seed)

    def tail(n):
        return rng.integers(1, cfg.vocab, size=n).astype(np.int32)
    shared, t1, t2 = tail(20), tail(4), tail(4)
    src = (rng.standard_normal((24, cfg.d_model)).astype(np.float32)
           if cfg.family == "encdec" else None)
    ticks = [[(np.concatenate([shared, tail(3)]), src),
              (np.concatenate([shared, tail(2)]), None)],
             [(np.concatenate([shared, t1, tail(5)]), None),
              (np.concatenate([shared, t2, tail(5)]), None)],
             [(np.concatenate([shared, t2, tail(3)]), None)]]
    toks, graphs, colls = {}, None, None
    for name, grid in (
            ("cpu", DeviceGrid.from_flat(["cpu"], 1, 1, 2, allow_reuse=True)),
            ("rows", DeviceGrid.from_flat([dev] * 4, 1, 2, 2))):
        sup = Supervisor(grid)
        sup.apply(ClusterSpec(cells=(CellSpec("c", cfg, "serve", ncols=2),)))
        cell = sup.cells["c"]
        if cell.mesh.size != (4 if name == "rows" else 1):
            raise AssertionError(f"{name}: mesh {cell.mesh}")
        cell.init_serve(params=params_from_numpy(
            host, dtype=torch.float32, device=cell.device,
            specs=model.param_specs()))
        bat = cell.make_batcher(batch_slots=4, max_len=64, page_size=8,
                                prefill_chunk=8, **(bat_kw or {}))
        rid = 0
        for _ in range(2):
            for tick in ticks:
                for p, s in tick:
                    bat.submit(Request(rid=rid, prompt=p, max_new_tokens=6,
                                       src=s))
                    rid += 1
                bat.run_until_drained()
        toks[name] = {r.rid: r.output for r in bat.done}
        if name == "rows":
            graphs = expect_graphed(4, bat)
            colls = {k: dict(v.collective_per_device)
                     for k, v in cell.accounting.programs.items()}
            for node in (bat.pool.arena if bat._paged else []):
                for leaf in node:
                    for g in cell.mesh.groups(("data",)):
                        if not all(torch.equal(leaf.shards[g[0]],
                                               leaf.shards[r])
                                   for r in g[1:]):
                            raise AssertionError(
                                f"{arch}: the data rows' arenas differ")
            scales = [t for pair in (bat.pool.kv_scales or [])
                      for t in pair]
            if any(not torch.equal(t.shards[0], x) for t in scales
                   for x in t.shards):
                raise AssertionError(f"{arch}: the positions' int8 scale "
                                     "tables differ")
        bat.close()
        sup.destroy_cell("c")
    return toks, graphs, colls


def phase_parity(dev) -> dict:
    """Phase 4: every case float32, the card's tokens equal to the CPU's.
    Returns the float32 forward routes' launches on the card (``flash``,
    the extend over a float32 arena and over an int8 one), which also
    must include none on the tensor cores."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import gmm
    from repro_torch.kernels.flash_attention.ops import paged_extend_attention
    tc0 = (flash_attention.launches_tc, gmm.launches_tc,
           paged_extend_attention.launches_tc)
    f32 = {"flash_attention_f32": 0, "paged_extend_attention_f32": 0,
           "paged_extend_attention_f32_int8": 0}

    @contextlib.contextmanager
    def counted(int8: bool = False):
        n0 = (flash_attention.launches, paged_extend_attention.launches)
        yield
        f32["flash_attention_f32"] += flash_attention.launches - n0[0]
        f32["paged_extend_attention_f32" + ("_int8" if int8 else "")] += (
            paged_extend_attention.launches - n0[1])

    for name, arch, opts, wseed, pseed, waves in PARITY:
        with counted(opts.get("kv_dtype") == "int8"):
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
    for name, arch, replicas, wseed, pseed, waves in DISAGG_PARITY:
        with counted():
            toks, graphs = disagg_parity_run(dev, arch, replicas, wseed,
                                             pseed, waves)
        log(f"[4] {name}: {dev} {toks[str(dev)]}")
        if not toks["cpu"] == toks[str(dev)] == toks["colocated"]:
            raise AssertionError(f"{name}: tokens differ: {toks}")
        log(f"[4] {name}: identical on {dev}, on cpu and in a colocated "
            f"batcher on cpu; the card's step graphs {graphs[str(dev)]}")
    for name, arch, wseed, pseed, waves in SHARDED_PARITY:
        with counted():
            toks, graphs, colls = sharded_parity_run(dev, arch, wseed, pseed,
                                                     waves)
        log(f"[4] {name}: {toks['two']}")
        if toks["one"] != toks["two"]:
            raise AssertionError(f"{name}: a two-position cell's tokens "
                                 f"differ from one position's: {toks}")
        if not colls or not all(c.get("all-reduce") for c in colls.values()):
            raise AssertionError(f"{name}: no collective recorded: {colls}")
        log(f"[4] {name}: identical to a one-position cell on {dev}; "
            f"collective bytes per step key {colls}")
    for name, arch, wseed, pseed in ROWS_PARITY:
        with counted():
            toks, graphs, colls = rows_parity_run(dev, arch, wseed, pseed)
        log(f"[4] {name}: {toks['rows']}")
        if toks["cpu"] != toks["rows"]:
            raise AssertionError(f"{name}: the (2, 2) cell's tokens on the "
                                 f"card differ from one position's on the "
                                 f"cpu: {toks}")
        if not all(c.get("all-gather") for c in colls.values()):
            raise AssertionError(f"{name}: a step key gathered nothing over "
                                 f"data: {colls}")
        log(f"[4] {name}: identical to a one-position cell on the cpu; "
            f"each data row's arena the same; collective bytes per step "
            f"key {colls}")
    name = "qwen3-4b, 4 kv heads, int8 paged pool over 2 rows of 2 positions"
    with counted(int8=True):
        toks, _, _ = rows_parity_run(dev, "qwen3-4b", 0, 4,
                                     cfg_kw=dict(num_kv_heads=4),
                                     bat_kw=dict(kv_dtype="int8"))
    log(f"[4] {name}: {toks['rows']}")
    if toks["cpu"] != toks["rows"]:
        raise AssertionError(f"{name}: the (2, 2) cell's tokens on the card "
                             f"differ from one position's on the cpu: {toks}")
    log(f"[4] {name}: identical to a one-position int8 cell on the cpu; "
        "each data row's int8 arena and every position's scale tables the "
        "same")
    name = ("qwen3-4b, 4 kv heads, disaggregated: prefill over (2, 2), "
            "replicas over (2, 1), scaled 2 -> 1")
    with counted():
        toks, stats = disagg_mesh_parity_run(dev)
    log(f"[4] {name}: {dev} {toks[str(dev)]}")
    if not toks["cpu"] == toks[str(dev)] == toks["colocated"]:
        raise AssertionError(f"{name}: tokens differ: {toks}")
    log(f"[4] {name}: identical on {dev}, on cpu positions and in a "
        f"colocated batcher on cpu; the card's server {stats}")
    if (flash_attention.launches_tc, gmm.launches_tc,
            paged_extend_attention.launches_tc) != tc0:
        raise AssertionError("a float32 run launched a tensor-core kernel")
    log(f"[4] float32 forward launches on the card (CUDA cores, none on "
        f"the tensor cores): {f32}")
    return {"launches": f32}


# --------------------------------------------------------------------------
# phases 5-7: the main paths at full width
# --------------------------------------------------------------------------
def full_width(dev, arch: str, tag: str, layers=None):
    """(model, params) of ``arch`` at full width in bf16, random weights
    drawn from a seeded generator on the card; ``layers``: the depth, when
    cut."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import Model
    cfg = get_arch(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
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


#: the int counters a wrapper may have beside ``launches``: on the tensor
#: cores, and the grouped GEMM backward's parts
SUB_COUNTS = ("launches_tc", "launches_wgmma", "launches_dx",
              "launches_dw")


def reset_counters(counters):
    """Set every launch counter of ``counters`` to 0."""
    for fn in counters:
        fn.launches = 0
        for sub in SUB_COUNTS:
            if hasattr(fn, sub):
                setattr(fn, sub, 0)
        for by in ("launches_by_capacity", "launches_kv_len"):
            if hasattr(fn, by):
                getattr(fn, by).clear()


def read_counters(counters) -> dict:
    """{name: launches} of ``counters`` (and ``name_tc``: those on the
    tensor cores; ``name_wgmma``: the grouped GEMM backward's calls on its
    wgmma route; ``name_dx``, ``name_dw``: its parts)."""
    launches = {}
    for fn in counters:
        launches[fn.__name__] = fn.launches
        for sub in SUB_COUNTS:
            if hasattr(fn, sub):
                launches[fn.__name__ + sub[len("launches"):]] = getattr(fn,
                                                                         sub)
    return launches


def serve(bat, waves, counters, *, max_new=MAX_NEW, srcs=None, hits=None):
    """Drive ``bat`` through ``waves`` of prompts (draining between
    waves; ``srcs``: the requests' sources, wave by wave) with every
    launch counter set to 0 just before.  Returns the
    requests, the launches of each counter, the wall time, the wall times
    of the steps that only decoded, and the batcher's :func:`graph_mark`
    before each wave (None on the CPU).  ``hits``, a list, gets the
    pool's prefix-hit tokens before each wave and after the last."""
    from repro_torch.serve.batcher import Request
    reset_counters(counters)
    reqs, step_s, marks = [], [], []
    t_start = time.monotonic()
    for w, wave in enumerate(waves):
        if hits is not None:
            hits.append(bat.pool.prefix_hit_tokens)
        marks.append(graph_mark(bat) if bat.step_graph is not None else None)
        for i, p in enumerate(wave):
            req = Request(rid=len(reqs), prompt=p, max_new_tokens=max_new,
                          src=None if srcs is None else srcs[w][i])
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
    if hits is not None:
        hits.append(bat.pool.prefix_hit_tokens)
    return reqs, read_counters(counters), wall, step_s, marks


def graph_mark(bat) -> tuple:
    """The batcher's step-graph counters and prefill invocations now."""
    return bat.step_graph.stats(), bat.prefill_invocations


PREFILL_PATHS = ("prefill", "extend", "restore")


def expect_round2_replayed(tag, bat, mark, *, strict: bool = True) -> dict:
    """Every prefill, extend and restore call since ``mark`` (taken before
    round 2) was a replay: none eager, no graph dropped and, with
    ``strict``, none captured.  Returns what each path's counters
    gained."""
    g, (g0, n0) = bat.step_graph.stats(), mark
    gain = {p: {k: g[p][k] - g0[p][k] for k in
                ("eager_calls", "captures", "replays", "dropped")}
            for p in PREFILL_PATHS}
    calls = bat.prefill_invocations - n0
    bad = [p for p, d in gain.items() if d["eager_calls"] or d["dropped"]
           or (strict and d["captures"])]
    if bad or sum(d["replays"] for d in gain.values()) != calls:
        raise AssertionError(f"[{tag}] round 2's {calls} prefill calls were "
                             f"not all replays: {gain}")
    log(f"[{tag}] round 2: {calls} prefill, extend and restore calls, all "
        f"replays ({ {p: d for p, d in gain.items() if any(d.values())} })")
    return gain


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
    # each wave's own TTFT p50 (the cold wave, then the warm one)
    waves = [float(np.median([r.ttft for r in reqs[i:i + SLOTS]]))
             for i in range(0, len(reqs), SLOTS)]
    e2e = {"tokens_per_s": toks / wall, "ttft_p50_s": float(np.median(ttft)),
           "ttft_p50_by_wave_s": waves,
           "decode_step_s": float(np.median(step_s)), "wall_s": wall,
           "tokens": toks, "decode_steps": bat.decode_invocations,
           "prefill_invocations": bat.prefill_invocations,
           "launches": launches}
    log(f"[{tag}] {len(reqs)} requests x {max_new} tokens, "
        f"{bat.decode_invocations} decode steps, {bat.prefill_invocations} "
        f"prefill invocations; launches {launches}")
    log(f"[{tag}] {toks / wall:.1f} tokens/s, TTFT p50 "
        f"{e2e['ttft_p50_s'] * 1e3:.1f} ms (by wave "
        f"{' / '.join(f'{w * 1e3:.1f}' for w in waves)} ms), decode step p50 "
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


def expect_graphed(tag, bat) -> dict:
    """The batcher's steps ran as CUDA graph replays: the decode steps and
    the prefill, extend and restore calls are each path's eager calls
    (its first in the process, at most one) plus its replays, and no path
    captured more graphs than it met keys (plus those it dropped when the
    checkpoint workspace grew)."""
    from repro_torch.launch.serve import graph_summary
    from repro_torch.serve.step_graph import decode_keys
    g = bat.step_graph.stats()
    paged = bat.pool is not None and bat.pool.payload_kind == "page"
    keys = len(decode_keys(bat.pool.n_logical if paged else None))
    d = g["decode"]
    prefill_calls = sum(g[p]["eager_calls"] + g[p]["replays"]
                        for p in PREFILL_PATHS)
    if (d["replays"] <= 0
            or d["replays"] + d["eager_calls"] != bat.decode_invocations
            or d["captures"] > min(keys, d["keys"])
            or prefill_calls != bat.prefill_invocations
            or any(c["eager_calls"] > 1
                   or c["captures"] > c["keys"] + c["dropped"]
                   for c in g.values())):
        raise AssertionError(f"[{tag}] steps not replayed as graphs: {g}, "
                             f"{bat.decode_invocations} decode steps, "
                             f"{bat.prefill_invocations} prefill calls, "
                             f"{keys} decode keys possible")
    log(f"[{tag}] {graph_summary(bat)}")
    return g


def memory_report(tag, bat) -> dict:
    """Peak memory allocated (since the last reset) and the bytes the
    allocator holds in the batcher's graph pool."""
    pool = tuple(bat.step_graph.pool)
    pool_b = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                 if tuple(seg.get("segment_pool_id", ())) == pool)
    out = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "graph_pool_gb": pool_b / 1e9}
    log(f"[{tag}] peak {out['peak_gb']:.2f} GB allocated; the step graphs' "
        f"pool holds {out['graph_pool_gb']:.3f} GB")
    return out


def time_prefill(tag, bat, path: str, name_limit: str, reps: int = 4,
                 firsts: int = 2) -> dict:
    """One prefill call of ``path`` ("cold", "extend", "restore") on the
    drained batcher ``bat``, at ``profile_decode.prefill_call``'s shapes
    (8 prompts of 128 tokens; 8 suffixes of 64 behind 64), timed eagerly
    (the plain step function on the batcher's own buffers, its inputs
    copied to the card), at a first visit (a fresh step graph: the copy
    into its static buffers, the capture, the instantiation and one
    replay; median of ``firsts``) and replayed in the batcher's graph
    (``reps`` calls each of eager and replayed, in turns), each call
    ending in the tokens' read-back as the batcher's does.  A drained
    batcher's state is scratch, so running it harms nothing."""
    from repro_torch.launch.profile_decode import prefill_call
    from repro_torch.serve.step_graph import StepGraph, to_device
    key, fn, state, host = prefill_call(bat, path)

    def eager():
        return fn(state, to_device(host, bat.device))[0].tolist()

    def replayed():
        return bat._run(key, fn, state, host)[0].tolist()

    def first_visit():
        probe = StepGraph(bat.device, generator=bat.step_graph.generator)
        t = time.monotonic()
        probe(key, fn, state, host)[0].tolist()
        wall = time.monotonic() - t
        probe.release()
        return wall

    replayed()              # the key's capture, if the run did not meet it
    eager()
    first = [first_visit() for _ in range(firsts)]
    walls = {"eager": [], "replayed": []}
    for _ in range(reps):
        for name, f in (("eager", eager), ("replayed", replayed)):
            t = time.monotonic()
            f()
            walls[name].append(time.monotonic() - t)
    out = {f"{k}_ms": float(np.median(v)) * 1e3 for k, v in walls.items()}
    out["first_visit_ms"] = float(np.median(first)) * 1e3
    out["key"] = list(key)
    log(f"[{tag}] one {path} prefill of the drained batcher at key {key}: "
        f"eager {out['eager_ms']:.2f} ms, first visit "
        f"{out['first_visit_ms']:.2f} ms, replayed {out['replayed_ms']:.2f} "
        f"ms (medians of {reps}, {firsts} and {reps}; {name_limit})")
    return out


def time_decode_step(tag, bat, key, name_limit: str,
                     reps: int = 10) -> dict:
    """One decode step of the drained batcher ``bat`` at ``key``, timed
    eagerly (the plain step function on the batcher's own buffers, its
    inputs copied to the card as an eager step copies them) and replayed
    (the copy into the key's static buffers, the address check, one
    replay), ``reps`` calls each in turns, each call ending in the tokens'
    read-back as a step does.  A drained batcher's state is scratch, so
    stepping it harms nothing.  Returns both medians (ms)."""
    from repro_torch.serve.step_graph import to_device
    host = {"tokens": bat.cur_tok[:, None], "pos": bat.pos}
    if key[0] == "paged":
        host["block_table"] = bat.pool.block_table[:, :key[1]]

    def eager():
        return bat._run_step(bat._decode_state(),
                             to_device(host, bat.device))[0].tolist()

    def replayed():
        return bat._decode(key, host).tolist()

    for _ in range(2):      # the key's eager step and capture, if not done
        replayed()
    eager()
    walls = {"eager": [], "replayed": []}
    for _ in range(reps):
        for name, fn in (("eager", eager), ("replayed", replayed)):
            t = time.monotonic()
            fn()
            walls[name].append(time.monotonic() - t)
    out = {f"{k}_ms": float(np.median(v)) * 1e3 for k, v in walls.items()}
    log(f"[{tag}] one decode step of the drained batcher at key {key}: "
        f"eager {out['eager_ms']:.2f} ms, replayed {out['replayed_ms']:.2f} "
        f"ms (median of {reps} each; {name_limit})")
    return out


def expect_tc(launches: dict, *names: str):
    """Every (bf16) launch of each kernel in ``names`` took its
    tensor-core kernel."""
    for name in names:
        expect(f"{name} on the tensor cores", launches[name + "_tc"],
               launches[name])


def warm_up(bat_fn, vocab: int):
    """Two short requests sharing a prefix on a separate batcher, one
    after the other, before the counted run: library handles, allocator
    pools, and each path's first call in the process (eager: the decode
    step, the cold prefill, and the paged extend or snapshot restore), so
    that every key the counted run meets captures at its first visit."""
    from repro_torch.serve.batcher import Request
    warm = bat_fn()
    for i, prompt in enumerate(main_path_prompts(1, vocab)[0][:2]):
        warm.submit(Request(rid=-1 - i, prompt=prompt, max_new_tokens=2))
        warm.run_until_drained()
    warm.close()
    del warm
    torch.cuda.synchronize()


def phase_main_path(dev, name_limit: str, model, params, tag=5,
                    timings: bool = True) -> dict:
    """Full-width qwen3-4b (or ``model``'s arch: phases 20a-20d) behind
    the batcher on the paged pool: two rounds of two waves of 8 requests,
    each round's second wave sharing a 64-token prefix with its first
    (paged extend).  Returns the launches of each kernel in this run and
    the end-to-end numbers; ``timings``: also one decode step and one cold
    and one extend prefill of the drained batcher, eager and replayed."""
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
    torch.cuda.reset_peak_memory_stats()
    bat = batcher()
    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention)
    hits = []
    reqs, launches, wall, step_s, marks = serve(
        bat, main_path_rounds(0, cfg.vocab), counters, hits=hits)
    # the main path went through all three kernels, every layer
    L = cfg.num_layers
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    expect("paged decode", launches["paged_decode_attention"],
           L * bat.decode_invocations)
    expect_tc(launches, "flash_attention", "paged_extend_attention")
    check_drained(bat.pool, SLOTS * SHARED)
    e2e = report(tag, name_limit, bat, reqs, wall, step_s, launches,
                 cfg.vocab)
    # what phase 11's cell a must reproduce, round by round
    e2e["tokens_by_round"] = [[r.output for r in reqs[:2 * SLOTS]],
                              [r.output for r in reqs[2 * SLOTS:]]]
    e2e["hits_by_round"] = [hits[2] - hits[0], hits[4] - hits[2]]
    e2e["outputs"] = [r.output for r in reqs]    # what 17a compares
    e2e["graphs"] = expect_graphed(tag, bat)
    e2e["round2"] = expect_round2_replayed(tag, bat, marks[2])
    e2e["memory"] = memory_report(tag, bat)
    log(f"[{tag}] {bat.pool.prefix_hit_tokens} prefix-hit tokens")
    if timings:
        e2e["step_ab"] = time_decode_step(tag, bat, ("paged", 8), name_limit)
        e2e["prefill_ab"] = {p: time_prefill(tag, bat, p, name_limit)
                             for p in ("cold", "extend")}
    bat.close()
    return e2e


def teacher_forcing(tag, dev, model, params) -> dict:
    """The twin of ``tests/test_models.py``'s teacher-forcing test at full
    width in bf16: every prompt of the main path's two rounds (32 rows of
    72..128 tokens) prefilled cold but for its last token
    (``prefill_ranged``), the cache laid out as a paged arena (pages of
    16), then that token decoded through one paged decode; against the
    teacher-forced prefill of the whole prompt.  The logits must agree
    within that test's bf16 limits: max |a - b| / max |b| < 5e-2 and the
    argmax on more than 0.9 of the rows."""
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.models.layers import PagedKVCache
    prompts = [p for wave in main_path_rounds(0, model.cfg.vocab)
               for p in wave]
    B, V = len(prompts), model.cfg.vocab
    S = -(-max(len(p) for p in prompts) // CHUNK) * CHUNK
    tok = np.zeros((B, S), np.int32)
    for b, p in enumerate(prompts):
        tok[b, :len(p)] = p
    tok = torch.from_numpy(tok).to(dev)
    n = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                     device=dev)
    with torch.no_grad():
        full, _ = model.prefill_ranged(
            params, {"tokens": tok, "length": n},
            model.init_cache(B, S, device=dev), in_place=True)
        _, cache = model.prefill_ranged(
            params, {"tokens": tok, "length": n - 1},
            model.init_cache(B, S, device=dev), in_place=True)
        node = cache.pop("layers")
        L, n_log = node.k.shape[0], S // PAGE

        def arena(x):   # (L, B, S, ...) -> (B * n_log + 1 pages, P, L, ...)
            pages = x.reshape((L, B * n_log, PAGE) + x.shape[3:]).movedim(
                0, 2)
            return torch.cat([pages, torch.full_like(pages[:1], -1 if
                              x.dtype == torch.int32 else 0)])
        bt = torch.arange(B * n_log, dtype=torch.int32, device=dev).view(
            B, n_log)
        paged = {"layers": PagedKVCache(arena(node.k), arena(node.v),
                                        arena(node.slot_pos), bt, 0)}
        del node, cache
        launches = paged_decode_attention.launches
        last = tok.gather(1, (n - 1).long()[:, None])
        dec, _ = model.decode(params, paged, {"tokens": last, "pos": n - 1})
        expect(f"[{tag}] teacher forcing: paged decode",
               paged_decode_attention.launches - launches, L)
    a, b = dec[:, :V].float(), full[:, :V].float()
    out = {"rel": rel(a, b), "argmax_agree": float(
        (a.argmax(-1) == b.argmax(-1)).float().mean()), "rows": B}
    log(f"[{tag}] teacher forcing at full width, bf16: {B} prompts "
        f"prefilled but their last token, which one paged decode then "
        f"reads, against the whole prompt prefilled: logits rel "
        f"{out['rel']:.3e} (tol 5e-2), argmax agreement "
        f"{out['argmax_agree']:.3f} (> 0.9)")
    if not (out["rel"] < 5e-2 and out["argmax_agree"] > 0.9):
        raise AssertionError(f"[{tag}] teacher forcing: {out}")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_arch(dev, name_limit: str, tag: str, arch: str, layers,
               ref5: dict) -> dict:
    """Phases 20a-20d: ``arch`` at full width in bf16 (``layers`` of its
    depth) on phase 5's path and traffic: its checks (paged decode L a
    step, flash and extend on the tensor cores, the pool drained with
    every prefix hit, round 2 all replays), the step graphs' counters
    equal to phase 5's (the same prompt lengths meet the same keys), then
    the full-width teacher-forcing check.  Prints the end-to-end numbers,
    the init seconds, the peak and graph-pool GB and the decode step
    beside its byte yardstick: the weights a step reads but the embedding
    table (a gather of 8 rows) over 3.35 TB/s."""
    from repro_torch.models.param import tree_leaves
    t0 = time.monotonic()
    model, params = full_width(dev, arch, tag, layers)
    init_s = time.monotonic() - t0
    e2e = phase_main_path(dev, name_limit, model, params, tag=tag,
                          timings=False)
    if e2e["graphs"] != ref5["graphs"]:
        raise AssertionError(f"[{tag}] step graphs {e2e['graphs']} differ "
                             f"from phase 5's {ref5['graphs']}")
    e2e["teacher_forcing"] = teacher_forcing(tag, dev, model, params)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    if not model.cfg.tie_embeddings:        # else the head reads it
        weight_bytes -= params["embed"].numel() * params["embed"].element_size()
    e2e["yardstick_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    e2e["init_s"] = init_s
    log(f"[{tag}] {arch}, {model.cfg.num_layers} layers: init {init_s:.1f} "
        f"s; decode step p50 {e2e['decode_step_s'] * 1e3:.2f} ms against "
        f"its yardstick {e2e['yardstick_ms']:.2f} ms ("
        f"{weight_bytes / 1e9:.2f} GB of weights but the embedding): "
        f"{e2e['decode_step_s'] * 1e3 / e2e['yardstick_ms']:.2f}x; "
        f"{e2e['tokens_per_s']:.1f} tokens/s; peak "
        f"{e2e['memory']['peak_gb']:.2f} GB, graph pool "
        f"{e2e['memory']['graph_pool_gb']:.3f} GB ({name_limit})")
    del model, params
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
    from repro_torch.serve.step_graph import DENSE_KEY

    cfg = model.cfg
    L = cfg.num_layers

    def batcher():
        return ContinuousBatcher(model, params, batch_slots=SLOTS,
                                 max_len=MAX_LEN, prefill_chunk=CHUNK,
                                 kv_pool=None, device=dev)

    warm_up(batcher, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    bat = batcher()
    counters = (decode_attention, paged_decode_attention, flash_attention)
    # the cold wave of each round
    reqs, launches, wall, step_s, marks = serve(
        bat, main_path_rounds()[::2], counters)
    expect("dense decode", launches["decode_attention"],
           L * bat.decode_invocations)
    expect("paged decode on the dense cache",
           launches["paged_decode_attention"], 0)
    expect("prefill", launches["flash_attention"],
           L * bat.prefill_invocations)
    expect_tc(launches, "flash_attention")
    e2e = report(6, name_limit, bat, reqs, wall, step_s, launches, cfg.vocab)
    e2e["graphs"] = expect_graphed(6, bat)
    e2e["round2"] = expect_round2_replayed(6, bat, marks[1])
    e2e["memory"] = memory_report(6, bat)
    e2e["step_ab"] = time_decode_step(6, bat, DENSE_KEY, name_limit)
    e2e["prefill_ab"] = {"cold": time_prefill(6, bat, "cold", name_limit)}
    bat.close()

    tat = ContinuousBatcher(model, params, batch_slots=2, max_len=MAX_LEN,
                            page_size=PAGE, prefill_chunk=None, device=dev)
    short = [main_path_prompts(2, cfg.vocab)[0][i][:12] for i in range(2)]
    reqs, tl, wall, step_s, _ = serve(tat, [short], counters, max_new=4)
    expect("token at a time: prefill", tl["flash_attention"], 0)
    expect("token at a time: paged decode", tl["paged_decode_attention"],
           L * tat.decode_invocations)
    expect("token at a time: dense decode", tl["decode_attention"], 0)
    check_drained(tat.pool, 0)
    e2e["token_at_a_time"] = report("6b", name_limit, tat, reqs, wall,
                                    step_s, tl, cfg.vocab, max_new=4)
    e2e["token_at_a_time"]["graphs"] = expect_graphed("6b", tat)
    tat.close()
    return e2e


def phase_recurrent(dev, name_limit: str, arch: str, tag: int) -> dict:
    """Full-width mamba2-2.7b or zamba2-2.7b behind the batcher on the
    snapshot pool, the two waves of phase 5: wave 1 prefills cold (the
    SSD kernel at the 16-token page chunk, a state checkpoint at every page
    boundary interned), wave 2 restores its 64-token prefix from the chain
    and extends only its tail over the dense per-slot cache (one extend
    over all slots); decode stays on the dense cache (zamba2: the dense
    decode kernel at head dim 80)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.step_graph import DENSE_KEY

    model, params = full_width(dev, arch, tag)
    cfg = model.cfg
    hybrid = cfg.family == "hybrid"
    n_attn = cfg.num_layers // cfg.hybrid_attn_every if hybrid else 0

    def batcher():
        return ContinuousBatcher(model, params, batch_slots=SLOTS,
                                 max_len=MAX_LEN, page_size=PAGE,
                                 prefill_chunk=CHUNK, pool_pages=SNAP_PAGES,
                                 device=dev)

    warm_up(batcher, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    bat = batcher()
    if bat.pool is None or bat.pool.payload_kind != "snapshot":
        raise AssertionError(f"{arch}: not on a snapshot pool")
    counters = (ssd, flash_attention, paged_extend_attention,
                decode_attention, paged_decode_attention)
    reqs, launches, wall, step_s, marks = serve(
        bat, main_path_rounds(0, cfg.vocab), counters)
    expect("SSD scan (one launch per Mamba layer per prefill and extend)",
           launches["ssd"], cfg.num_layers * bat.prefill_invocations)
    expect("prefill + dense extend attention",
           launches["flash_attention"] + launches["paged_extend_attention"],
           n_attn * bat.prefill_invocations)
    expect("dense decode", launches["decode_attention"],
           n_attn * bat.decode_invocations)
    expect("paged decode on the snapshot plane",
           launches["paged_decode_attention"], 0)
    if hybrid and min(launches["flash_attention"],
                      launches["paged_extend_attention"]) <= 0:
        raise AssertionError(f"a zamba2 attention kernel was never launched: "
                             f"{launches}")
    expect_tc(launches, "flash_attention", "paged_extend_attention")
    check_drained(bat.pool, SLOTS * SHARED)
    st = bat.pool.stats()
    if st["snapshot_hit_tokens"] < SLOTS * SHARED:
        raise AssertionError(f"wave 2 restored only {st} snapshot tokens")
    e2e = report(tag, name_limit, bat, reqs, wall, step_s, launches,
                 cfg.vocab)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] snapshot pool: {st['snapshots_interned']} payloads "
        f"interned, {st['snapshot_hit_tokens']} snapshot-hit tokens, "
        f"{st['snapshot_bytes_saved'] / 1e9:.2f} GB saved, "
        f"{st['pages_in_use']} of {st['num_pages']} handles held; peak "
        f"{peak / 1e9:.1f} GB allocated; checkpoint workspace "
        f"{bat._ckpts.capacity} (row, checkpoint) pairs, "
        f"{bat._ckpts.regrowths} regrowths")
    e2e["snapshot"] = {k: st[k] for k in ("snapshots_interned",
                                          "snapshot_hit_tokens",
                                          "snapshot_bytes_saved")}
    e2e["outputs"] = [r.output for r in reqs]    # what 16b / 16c compare
    e2e["peak_gb"] = peak / 1e9
    e2e["graphs"] = expect_graphed(tag, bat)
    e2e["round2"] = expect_round2_replayed(tag, bat, marks[2])
    e2e["memory"] = memory_report(tag, bat)
    e2e["step_ab"] = time_decode_step(tag, bat, DENSE_KEY, name_limit)
    e2e["prefill_ab"] = {p: time_prefill(tag, bat, p, name_limit)
                         for p in ("cold", "restore")}
    bat.close()
    del bat, model, params
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
    reqs, launches, wall, step_s, marks = serve(
        bat, main_path_rounds(0, cfg.vocab), counters)
    invocations = bat.decode_invocations + bat.prefill_invocations
    expect("grouped GEMM (3 per MoE layer per invocation)", launches["gmm"],
           3 * n_moe * invocations)
    # the decode step's capacity is its 8 tokens (dropless); every other
    # capacity is a prefill or extend invocation's (C 192 cold, C 96 warm)
    by_c = dict(sorted(gmm.launches_by_capacity.items()))
    launches["gmm_prefill"] = sum(n for c, n in by_c.items() if c != SLOTS)
    expect("grouped GEMM at decode (C 8)", by_c.get(SLOTS, 0),
           3 * n_moe * bat.decode_invocations)
    expect("grouped GEMM at the prefill shapes", launches["gmm_prefill"],
           3 * n_moe * bat.prefill_invocations)
    expect_tc(launches, "gmm", "flash_attention", "paged_extend_attention")
    log(f"[7] grouped GEMM launches by capacity C: {by_c}")
    expect("paged decode", launches["paged_decode_attention"],
           cfg.num_layers * bat.decode_invocations)
    expect("prefill + paged extend", launches["flash_attention"]
           + launches["paged_extend_attention"],
           cfg.num_layers * bat.prefill_invocations)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    check_drained(bat.pool, SLOTS * SHARED)
    e2e = report(7, name_limit, bat, reqs, wall, step_s, launches, cfg.vocab)
    e2e["outputs"] = [r.output for r in reqs]    # what 17b compares
    log(f"[7] {bat.pool.prefix_hit_tokens} prefix-hit tokens, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
    e2e["graphs"] = expect_graphed(7, bat)
    e2e["round2"] = expect_round2_replayed(7, bat, marks[2])
    e2e["memory"] = memory_report(7, bat)
    e2e["step_ab"] = time_decode_step(7, bat, ("paged", 8), name_limit)
    e2e["prefill_ab"] = {p: time_prefill(7, bat, p, name_limit)
                         for p in ("cold", "extend")}
    bat.close()
    del bat
    e2e["routing"] = routing_profile(batcher, cfg.vocab)
    return e2e


def encdec_launches(tag, bat, launches: dict, s_src: int, m: int = 1):
    """Check and complete the launches of the encdec path on ``bat`` (its
    layers over ``m`` mesh positions, each launching its own): the flash
    launches under a key-length mask split by (Sq, Skv) into the
    encoder's (Sq = Skv = the source length) and cross-attention's (the
    prompt's bucket against it), shapes phase 3 held, and the dense
    decode over cross memory, added to ``launches`` as rows
    ``flash_attention_encoder``, ``flash_attention_cross`` and
    ``decode_attention_cross``."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = bat.step_graph.stats()
    cold = g["prefill"]["eager_calls"] + g["prefill"]["replays"]
    warm = g["extend"]["eager_calls"] + g["extend"]["replays"]
    L, E = bat.model.cfg.num_layers, bat.model.cfg.encoder_layers
    by_shape = dict(flash_attention.launches_kv_len)
    unheld = set(by_shape) - {(sq, s_src) for sq in (s_src, *CROSS_SQ)}
    if unheld:
        raise AssertionError(f"flash under kv_len at shapes phase 3 did "
                             f"not hold: {sorted(unheld)}")
    launches["flash_attention_encoder"] = by_shape.get((s_src, s_src), 0)
    launches["flash_attention_cross"] = sum(
        n for (sq, skv), n in by_shape.items() if (sq, skv) != (s_src, s_src))
    launches["decode_attention_cross"] = launches["decode_attention"]
    log(f"[{tag}] {cold} cold prefills, {warm} extends, "
        f"{bat.decode_invocations} decode steps; flash launches under a "
        f"key-length mask by (Sq, Skv) {by_shape}")
    expect("cold prefills + extends", cold + warm, bat.prefill_invocations)
    # a cold prefill: 24 encoder, 24 causal self and 24 cross flash
    # launches a position; an extend: 24 encoder and 24 cross flash, 24
    # paged extend
    expect("flash (72 a cold prefill, 48 an extend, a position)",
           launches["flash_attention"],
           m * ((E + 2 * L) * cold + (E + L) * warm))
    expect("flash under kv_len, the encoder (24 a prefill or extend)",
           launches["flash_attention_encoder"], m * E * (cold + warm))
    expect("flash under kv_len, cross-attention (24 a prefill or extend)",
           launches["flash_attention_cross"], m * L * (cold + warm))
    expect("paged extend (24 an extend)", launches["paged_extend_attention"],
           m * L * warm)
    # a decode step: 24 paged decode (self) and 24 dense decode (cross)
    expect("paged decode (24 a step)", launches["paged_decode_attention"],
           m * L * bat.decode_invocations)
    expect("dense decode over cross memory (24 a step)",
           launches["decode_attention"], m * L * bat.decode_invocations)
    expect_tc(launches, "flash_attention", "paged_extend_attention")
    if min(cold, warm) <= 0:
        raise AssertionError(f"no cold prefill or no extend: {cold}, {warm}")


def phase_encdec(dev, name_limit: str) -> dict:
    """Full-width seamless-m4t-large-v2 behind the batcher on the paged
    pool, the two rounds of phase 5 with sources (``encdec_sources``):
    every cold prefill and every extend encodes its rows' sources (the
    flash kernel under a key-length mask in each encoder layer) inside its
    graph; the decoder's self-attention runs flash (cold), paged extend
    (warm) and paged decode, its cross-attention flash under the source
    mask (cold and warm) and the dense decode kernel over the resident
    cross memory (decode)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.models.param import tree_leaves
    from repro_torch.serve.batcher import ContinuousBatcher

    model, params = full_width(dev, "seamless-m4t-large-v2", 10)
    cfg = model.cfg
    L, E = cfg.num_layers, cfg.encoder_layers

    def batcher():
        return ContinuousBatcher(model, params, batch_slots=SLOTS,
                                 max_len=MAX_LEN, page_size=PAGE,
                                 prefill_chunk=CHUNK, device=dev)

    warm_up(batcher, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    bat = batcher()
    cross_b = sum(t.numel() * t.element_size()
                  for t in tree_leaves(bat.resident))
    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention, decode_attention)
    reqs, launches, wall, step_s, marks = serve(
        bat, main_path_rounds(0, cfg.vocab), counters,
        srcs=encdec_sources())
    encdec_launches(10, bat, launches, model.source_len(MAX_LEN))
    check_drained(bat.pool, SLOTS * SHARED)
    e2e = report(10, name_limit, bat, reqs, wall, step_s, launches,
                 cfg.vocab)
    e2e["outputs"] = [r.output for r in reqs]    # what 16d compares
    e2e["graphs"] = expect_graphed(10, bat)
    e2e["round2"] = expect_round2_replayed(10, bat, marks[2])
    e2e["memory"] = memory_report(10, bat)
    e2e["cross_memory_gb"] = cross_b / 1e9
    log(f"[10] {bat.pool.prefix_hit_tokens} prefix-hit tokens; resident "
        f"cross memory {cross_b / 1e9:.3f} GB ({L} layers x {SLOTS} slots "
        f"x {model.source_len(MAX_LEN)} frames x {ENC_H} x {ENC_DH} x K, V "
        f"bf16, and src_len)")
    e2e["step_ab"] = time_decode_step(10, bat, ("paged", 8), name_limit)
    e2e["prefill_ab"] = {p: time_prefill(10, bat, p, name_limit)
                         for p in ("cold", "extend")}
    bat.close()
    del bat, model, params
    return e2e


def routing_profile(batcher, vocab: int) -> dict:
    """The counts the MoE layers hand the grouped GEMM on phase 7's path:
    the two waves again on a fresh batcher (after the counted run), the
    model's ``gmm`` wrapped to read each call's counts back to the host.
    Logs, for each capacity C, the calls' mean number of busy experts and
    rows; with random weights the router need not spread tokens as a
    trained (load-balanced) one does, and the GEMM's cost follows the busy
    experts."""
    from repro_torch.models import moe
    seen = {}
    gmm = moe.gmm

    def spy(x, w, counts):
        c = counts.to("cpu")
        seen.setdefault(x.shape[1], []).append(
            (int((c > 0).sum()), int(c.sum())))
        return gmm(x, w, counts)

    moe.gmm = spy
    try:
        bat = batcher()
        bat.step_graph = None   # eager steps: the spy runs on every call
        serve(bat, main_path_prompts(0, vocab), ())
    finally:
        moe.gmm = gmm
    prof = {c: {"calls": len(v), "busy_experts": float(np.mean([b for b, _ in v])),
                "rows": float(np.mean([r for _, r in v]))}
            for c, v in sorted(seen.items())}
    for c, p in prof.items():
        log(f"[7] routing at C {c}: {p['calls']} calls, {p['busy_experts']:.1f} "
            f"of {MOE_E} experts busy, {p['rows']:.0f} rows a call (mean)")
    return prof


# --------------------------------------------------------------------------
# phase 11: two serve cells under the supervisor and its daemon
# --------------------------------------------------------------------------
def drive_cells(cells: dict, rids: dict, step_s: dict):
    """Step every cell's batcher in turns until each has drained all its
    waves: ``cells`` maps a name to (cell, batcher, waves, max_new), a
    cell's next wave submitted once its batcher drained the previous one
    (as ``serve`` does), its requests numbered on from ``rids[name]``.
    Each step ends with the cell's heartbeat (the liveness its
    supervisor's health check reads).  Returns {name: requests}; the wall
    times of each cell's steps that only decoded are
    appended to ``step_s[name]``."""
    from repro_torch.serve.batcher import Request
    reqs = {name: [] for name in cells}
    pending = {name: list(w) for name, (_, _, w, _) in cells.items()}

    def busy(bat):
        return bat.queue or any(r is not None for r in bat.slot_req)

    while True:
        live = 0
        for name, (cell, bat, _, max_new) in cells.items():
            if not busy(bat) and pending[name]:
                for p in pending[name].pop(0):
                    req = Request(rid=rids[name], prompt=p,
                                  max_new_tokens=max_new)
                    rids[name] += 1
                    reqs[name].append(req)
                    bat.submit(req)
            if not busy(bat):
                continue
            live += 1
            before = (bat.prefill_invocations, bat.decode_invocations)
            t = time.monotonic()
            bat.step()
            if bat.prefill_invocations == before[0] and \
                    bat.decode_invocations > before[1]:
                step_s[name].append(time.monotonic() - t)
            cell.heartbeat()
        if not live:
            break
    torch.cuda.synchronize()
    return reqs


def check_span_trees(tag, rec, reqs):
    """Every request ended with one closed span tree in the cell's
    recorder: a closed root, every span of its trace parented to it, no
    span left open."""
    if rec.open_spans:
        raise AssertionError(f"[{tag}] spans left open: "
                             f"{[s.name for s in rec.open_spans]}")
    roots = {e["trace_id"]: e for e in rec.log if e["name"] == "request"}
    rids = {r.rid for r in reqs}
    if set(roots) != rids or any(e["dur"] is None for e in roots.values()):
        raise AssertionError(f"[{tag}] request roots {sorted(roots)} for "
                             f"requests {sorted(rids)}")
    for e in rec.log:
        tid = e["trace_id"]
        if tid is None or e["name"] == "request":
            continue
        if e["parent_id"] != roots[tid]["span_id"]:
            raise AssertionError(f"[{tag}] span {e} is not parented to its "
                                 "request's root")
    names = sorted({e["name"] for e in rec.log})
    log(f"[{tag}] {len(roots)} closed span trees, "
        f"{len(rec.log)} events ({names}), none open")


def check_ttft_sketch(tag, acct):
    """The recorder's TTFT p50 (a log-bucket sketch of rel_err 0.01, its
    rank ceil(n / 2)) is within 1% of that order statistic of the request
    log ``serving_summary`` reads; ``serving_summary``'s p50 interpolates
    between it and the next one."""
    ttft = sorted(r.ttft for r in acct.requests)
    k = int(np.ceil(0.5 * len(ttft)))
    sketch = acct.recorder.hists["ttft_s"].quantile(0.5)
    summary = acct.serving_summary()["ttft_p50"]
    if not (abs(sketch - ttft[k - 1]) <= 0.01 * ttft[k - 1]
            and ttft[k - 1] <= summary <= ttft[min(k, len(ttft) - 1)]):
        raise AssertionError(
            f"[{tag}] recorder TTFT p50 {sketch} vs the log's order "
            f"statistic {ttft[k - 1]} (serving_summary p50 {summary})")
    return sketch, summary


def verb_seconds(events) -> dict:
    """Seconds of each supervisor verb in the event log: create, the
    transfer with the moves of its two resizes, destroy."""
    out = {}
    for e in events:
        if e["op"] in ("create", "destroy"):
            out[f"{e['op']} {e['cell']}"] = e["seconds"]
        elif e["op"] == "transfer":
            key = f"transfer {e['src']}->{e['dst']}"
            out[key] = e["seconds"]
            out[key + " shrink"] = e["resize_seconds"]["shrink"]
            out[key + " grow"] = e["resize_seconds"]["grow"]
    return out


def phase_cells(dev, name_limit: str, ref: dict) -> dict:
    """Full-width qwen3-4b in two serve cells of one supervisor on this
    card (a 1x1x4 grid, the device repeated): cell ``a`` (2 columns, a
    TTFT SLO) with phase 5's weight seed and batcher serves phase 5's
    round 1 while cell ``b`` (2 columns, another seed) serves a wave of
    its own, stepped in turns; ``a``'s tokens must be phase 5's.  Then a
    daemon tick under an SLO set below ``a``'s measured TTFT moves a
    column ``b -> a`` (``a``'s graphs dropped, its epoch moved on), and
    ``a`` serves round 2, recapturing its graphs at the new epoch: tokens
    and prefix hits must be phase 5's round 2.  A channel ``a -> b``
    carries one request's pages, bitwise; destroying ``b`` frees its
    weights.  Both cells' batchers report to their cell's flight
    recorder throughout."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (
        CellSpec,
        ClusterSpec,
        DeviceGrid,
        SLOTarget,
        Supervisor,
        SupervisorDaemon,
        chrome_trace,
        collect_traces,
        tree_bytes,
    )
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.models.cache_utils import read_arena_pages
    from repro_torch.models.param import tree_leaves
    from repro_torch.serve.kvpool import request_ctx_key

    cfg = get_arch("qwen3-4b")
    L = cfg.num_layers
    sup = Supervisor(DeviceGrid.from_flat([dev], 1, 1, 4, allow_reuse=True))
    spec = ClusterSpec(cells=(
        CellSpec("a", cfg, "serve", ncols=2, min_ncols=1, max_ncols=3,
                 slo=SLOTarget(ttft_p99=60.0)),
        CellSpec("b", cfg, "serve", ncols=2, min_ncols=1, max_ncols=3)))
    sup.apply(spec)
    a, b = sup.cells["a"], sup.cells["b"]
    t0 = time.monotonic()
    for cell, seed in ((a, 0), (b, 1)):
        cell.init_serve(generator=torch.Generator(device=dev)
                        .manual_seed(seed))
    torch.cuda.synchronize()
    b_weights = tree_bytes(b.serve_params)
    log(f"[11] cells a and b of {cfg.name} at full width (seeds 0 and 1): "
        f"zones {[(z.name, z.c0, z.c1) for z in sup.table.zones]}, epoch "
        f"{sup.table.epoch}, weights {time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
              prefill_chunk=CHUNK)
    bat_a, bat_b = a.make_batcher(**kw), b.make_batcher(**kw)
    daemon = SupervisorDaemon(sup)
    daemon.add_slo_policy("a", donor="b")
    rounds = main_path_rounds()
    b_wave = main_path_prompts(7, cfg.vocab)[0]
    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention)
    rids = {"a": 0, "b": 0}
    step_s = {"a": [], "b": []}
    hits = [bat_a.pool.prefix_hit_tokens]

    # round 1 on a beside a wave of b's, stepped in turns
    reset_counters(counters)
    t0 = time.monotonic()
    reqs = drive_cells({"a": (a, bat_a, rounds[:2], MAX_NEW),
                        "b": (b, bat_b, [b_wave], MAX_NEW)}, rids, step_s)
    wall1 = time.monotonic() - t0
    hits.append(bat_a.pool.prefix_hit_tokens)
    r1 = [r.output for r in reqs["a"]]
    if r1 != ref["tokens_by_round"][0]:
        bad = [i for i, (x, y) in enumerate(zip(r1, ref["tokens_by_round"][0]))
               if x != y]
        raise AssertionError(f"[11] cell a's round 1 differs from phase 5's "
                             f"at requests {bad}")
    if hits[1] - hits[0] != ref["hits_by_round"][0]:
        raise AssertionError(f"[11] round 1 hit {hits[1] - hits[0]} prefix "
                             f"tokens, phase 5 {ref['hits_by_round'][0]}")
    log(f"[11] round 1 on a beside b's wave: a's {len(r1)} requests' tokens "
        f"equal phase 5's round 1, {hits[1] - hits[0]} prefix-hit tokens "
        f"as phase 5; b served {len(reqs['b'])} requests; {wall1:.2f} s")
    check_span_trees("11 a", a.accounting.recorder, reqs["a"])
    check_span_trees("11 b", b.accounting.recorder, reqs["b"])
    sketch, summary = check_ttft_sketch("11 a", a.accounting)
    log(f"[11] a's TTFT p50: recorder sketch {sketch * 1e3:.3f} ms, "
        f"serving_summary {summary * 1e3:.3f} ms (interpolated)")

    # the daemon: an SLO below a's measured TTFT moves a column b -> a
    ttft_p99 = a.accounting.tenant_percentile("ttft", 99)
    sup.apply(sup.desired.with_cell(CellSpec(
        "a", cfg, "serve", ncols=2, min_ncols=1, max_ncols=3,
        slo=SLOTarget(ttft_p99=ttft_p99 / 2))))
    epoch, g0 = a.zone_epoch, bat_a.step_graph.stats()
    captured0 = len(bat_a.step_graph.captured())
    tick = daemon.tick()
    acts = [x for x in tick["actions"] if x["kind"] == "grow_server"]
    why = daemon.audit.query(kind="grow_server", cell="a")
    g1 = bat_a.step_graph.stats()
    dropped = sum(g1[p]["dropped"] - g0[p]["dropped"] for p in g1)
    if (len(acts) != 1 or "transfer:1" not in acts[0]["plan"]
            or (a.zone.ncols, b.zone.ncols) != (3, 1) or len(why) != 1
            or a.zone_epoch <= epoch or bat_a.step_graph.captured()
            or dropped != captured0 or bat_a.step_graph.epoch != a.zone_epoch):
        raise AssertionError(f"[11] the SLO tick did not move a column b -> "
                             f"a and drop a's graphs: {tick}, audit {why}, "
                             f"{dropped} of {captured0} graphs dropped")
    log(f"[11] daemon tick {tick['tick']}: {why[0]['reason']} (plan "
        f"{acts[0]['plan']}); a's epoch {epoch} -> {a.zone_epoch}, its "
        f"{dropped} graphs dropped; zones "
        f"{[(z.name, z.c0, z.c1) for z in sup.table.zones]}")

    # round 2 on a, recapturing its graphs at the new epoch
    reqs2 = drive_cells({"a": (a, bat_a, rounds[2:], MAX_NEW)}, rids, step_s)
    launches = read_counters(counters)
    hits.append(bat_a.pool.prefix_hit_tokens)
    r2 = [r.output for r in reqs2["a"]]
    if r2 != ref["tokens_by_round"][1] or \
            hits[2] - hits[1] != ref["hits_by_round"][1]:
        raise AssertionError(f"[11] cell a's round 2 ({hits[2] - hits[1]} "
                             "prefix-hit tokens) differs from phase 5's "
                             f"({ref['hits_by_round'][1]})")
    g2 = bat_a.step_graph.stats()
    graphs = bat_a.step_graph.captured()
    if (not graphs or any(e.epoch != a.zone_epoch for e in graphs.values())
            or sum(g2[p]["captures"] - g1[p]["captures"] for p in g2) <= 0):
        raise AssertionError(f"[11] round 2's graphs were not captured at "
                             f"epoch {a.zone_epoch}: {g2}")
    checked = sup.validate_cell_programs("a")
    check_span_trees("11 a", a.accounting.recorder, reqs["a"] + reqs2["a"])
    log(f"[11] round 2 on a: tokens and {hits[2] - hits[1]} prefix-hit "
        f"tokens equal phase 5's round 2; {len(graphs)} graphs recaptured at "
        f"epoch {a.zone_epoch}; validate_cell_programs('a') passed over "
        f"{checked} programs")

    # the main path's kernels, every layer, on the tensor cores
    decodes = bat_a.decode_invocations + bat_b.decode_invocations
    prefills = bat_a.prefill_invocations + bat_b.prefill_invocations
    if min(launches.values()) <= 0:
        raise AssertionError(f"[11] a kernel was never launched: {launches}")
    expect("[11] paged decode", launches["paged_decode_attention"],
           L * decodes)
    expect("[11] flash and paged extend",
           launches["flash_attention"] + launches["paged_extend_attention"],
           L * prefills)
    expect_tc(launches, "flash_attention", "paged_extend_attention")
    log(f"[11] launches {launches}: {decodes} decode steps and {prefills} "
        f"prefill invocations of both cells")

    # a channel a -> b: one request's interned pages, bitwise
    req = reqs2["a"][0]
    pages = [n.page for n in bat_a.pool.tree.match(req.prompt,
                                                   request_ctx_key(req))]
    stacks = read_arena_pages(bat_a.pool.arena, pages)
    ch = sup.open_channel("a", "b", kind="pages")
    stats = ch.send_pages(stacks, meta={"rid": req.rid, "pages": pages})
    env = ch.poll_pages()
    torch.cuda.synchronize()
    sent, got = tree_leaves(stacks), tree_leaves(env.cache)
    if (not pages or len(got) != len(sent)
            or not all(torch.equal(x, y) for x, y in zip(got, sent))
            or stats["bytes"] != tree_bytes(stacks)
            or ch.bytes_sent != stats["bytes"]):
        raise AssertionError(f"[11] send_pages of {len(pages)} pages did not "
                             f"arrive bitwise with its bytes counted: {stats}")
    log(f"[11] channel a -> b: {len(pages)} pages of request {req.rid}, "
        f"{stats['bytes']} bytes, bitwise equal")

    # the recorder's cost on the decode step, and the trace
    a_step = float(np.median(step_s["a"]))
    rec_step = a.accounting.recorder.hists["decode_step_s"].quantile(0.5)
    trace = chrome_trace(collect_traces(
        sup, {n: c.accounting.recorder for n, c in sup.cells.items()}),
        audit=daemon.audit)
    log(f"[11] decode step p50 with the recorder live {a_step * 1e3:.2f} ms "
        f"(the recorder's own decode_step_s p50 {rec_step * 1e3:.2f} ms), "
        f"phase 5 without one {ref['decode_step_s'] * 1e3:.2f} ms; "
        f"Chrome trace {len(trace['traceEvents'])} events ({name_limit})")

    # destroy b: its weights, pool and graphs go
    bat_b.close()
    del bat_b, b
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    sup.destroy_cell("b")
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    if freed < b_weights or "b" in sup.cells or ch.open:
        raise AssertionError(f"[11] destroying b freed {freed} bytes, its "
                             f"weights are {b_weights}")
    log(f"[11] destroy b freed {freed / 1e9:.2f} GB (weights "
        f"{b_weights / 1e9:.2f} GB)")
    verbs = verb_seconds(sup.events)
    log(f"[11] supervisor verbs (event log seconds, {name_limit}): " +
        ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in verbs.items()))
    bat_a.close()
    sup.destroy_cell("a")
    return {"launches": launches, "verb_seconds": verbs,
            "decode_step_s": a_step, "recorder_decode_step_s": rec_step,
            "trace_events": len(trace["traceEvents"]), "freed_b": freed}


# --------------------------------------------------------------------------
# phase 12: disaggregated serving and the cluster cache plane
# --------------------------------------------------------------------------
def drive_disagg(srv, waves, reqs, step_s, *, after_pump=None):
    """Submit each wave of prompts to ``srv`` (requests numbered on from
    ``len(reqs)``) and step until it drained, before the next wave.
    ``after_pump(wave)``, when given, runs once right after the wave's
    first pump, before any decode step.  The wall times of the ticks that
    only decoded go to ``step_s``."""
    from repro_torch.serve.batcher import Request
    for w, wave in enumerate(waves):
        for p in wave:
            req = Request(rid=len(reqs), prompt=p, max_new_tokens=MAX_NEW)
            reqs.append(req)
            srv.submit(req)
        if after_pump is not None:
            srv.pump()
            after_pump(w)
        while srv._busy():
            n0 = srv.worker.invocations
            t = time.monotonic()
            srv.step()
            if srv.worker.invocations == n0:
                step_s.append(time.monotonic() - t)
    torch.cuda.synchronize()


def phase_disagg(dev, name_limit: str, ref: dict, tag=12,
                 ref12=None) -> dict:
    """Full-width qwen3-4b disaggregated on this card (a 1x1x4 grid, the
    device repeated): a prefill cell and a decode spec of 2 replicas
    joined by a ``kv`` channel; ``decode/0`` takes phase 5's weight seed,
    the prefill cell and ``decode/1`` pull the weights over array
    channels.  ``DisaggServer(migrate=True)`` serves phase 5's round 1;
    right after its first wave's pump a spec scales ``decode`` to 1
    replica: the reconciler's drain hook migrates ``decode/1``'s prefix
    pages and hands its in-flight slots to ``decode/0`` over a ``pages``
    channel, and the sync detaches it.  Then round 1's wave 2 again and
    phase 5's round 2, on the survivor.  Tokens must be phase 5's, request
    by request (the replay wave's round 1's wave 2's), with no requeue;
    every worker prefill and replica step a graph replay.

    Phase 19a (``tag`` "19a", ``ref12`` phase 12's numbers) runs the same
    over a (1, 2, 3) grid (``DeviceGrid.from_flat([dev] * 6, 1, 2, 3)``):
    every cell one column over two data rows, (``data`` 2, ``model`` 1),
    the weights FSDP over ``data`` and fanned out onto each cell's
    layout, each payload crossing as its logical tensor into the
    replica's layout.  The first cold prefill's logits are held to the
    one-position model's first; every kernel must launch exactly twice
    phase 12's count, and the tokens' agreement with phase 12's is
    printed."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (
        CellSpec,
        ChannelSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
        tree_bytes,
    )
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.serve.disagg import DisaggServer

    cfg = get_arch("qwen3-4b")
    L = cfg.num_layers
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = ref12 is not None
    sup = Supervisor(DeviceGrid.from_flat([dev] * 6, 1, 2, 3) if mesh else
                     DeviceGrid.from_flat([dev], 1, 1, 4, allow_reuse=True))
    spec = ClusterSpec(
        cells=(CellSpec("prefill", cfg, "serve", ncols=1),
               CellSpec("decode", cfg, "serve", ncols=1, replicas=2,
                        min_replicas=1, max_replicas=2)),
        channels=(ChannelSpec("prefill", "decode", kind="kv"),))
    sup.apply(spec)
    m = sup.cells["prefill"].mesh.size          # positions a cell
    if {c.mesh.size for c in sup.cells.values()} != {m} or \
            m != (2 if mesh else 1):
        raise AssertionError(f"[{tag}] cells {[(n, c.mesh.shape) for n, c in sup.cells.items()]}")
    sup.cells["decode/0"].init_serve(
        generator=torch.Generator(device=dev).manual_seed(0))
    weights = tree_bytes(sup.cells["decode/0"].serve_params)
    logits = (mesh_logits(tag, dev, sup.cells["prefill"].model)
              if mesh else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    srv = DisaggServer(sup, "prefill", spec.cell("decode").instances(),
                       batch_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                       chunk=CHUNK, migrate=True)
    torch.cuda.synchronize()
    fanout_wall = time.monotonic() - t0
    arrays = [ch for ch in sup.channels if ch.kind == "array"]
    fanout = {"bytes": sum(ch.bytes_sent for ch in arrays),
              "transfers": sum(ch.transfers for ch in arrays),
              "enqueue_s": sum(ch.seconds for ch in arrays),
              "server_build_wall_s": fanout_wall}
    if fanout["transfers"] != 2 or fanout["bytes"] != 2 * weights:
        raise AssertionError(f"[{tag}] weight fan-out {fanout}, weights "
                             f"{weights} bytes")
    log(f"[{tag}] cells {sorted(sup.cells)} on zones "
        f"{[(z.name, z.c0, z.c1) for z in sup.table.zones]}, each over "
        f"{sup.cells['prefill'].mesh.shape}; weight fan-out decode/0 -> "
        f"prefill, decode/1: {fanout['transfers']} transfers, "
        f"{fanout['bytes'] / 1e9:.2f} GB logical, "
        f"{fanout['enqueue_s'] * 1e3:.2f} ms to enqueue, the server built "
        f"in {fanout_wall:.2f} s with the copies landed")
    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention)
    rounds = main_path_rounds()
    reqs, step_s = [], []
    scale = {}

    def scale_down(w):
        if w:
            return
        victim = srv.replicas[1]
        held = sum(r is not None for r in victim.batcher.slot_req)
        t = time.monotonic()
        sup.apply(sup.desired.with_cell(dataclasses.replace(
            sup.desired.cell("decode"), replicas=1)))
        out = srv.sync(sup.desired)
        torch.cuda.synchronize()
        pages = [ch for ch in sup.channels if ch.kind == "pages"]
        scale.update(held=held, sync=out, wall_s=time.monotonic() - t,
                     bytes=sum(ch.bytes_sent for ch in pages),
                     transfers=sum(ch.transfers for ch in pages),
                     enqueue_s=sum(ch.seconds for ch in pages),
                     pages_migrated=srv.pages_migrated,
                     handoffs=srv.drain_handoffs)

    reset_counters(counters)
    t_start = time.monotonic()
    drive_disagg(srv, rounds[:2], reqs, step_s, after_pump=scale_down)
    survivor = srv.replicas[0].batcher
    drive_disagg(srv, rounds[1:2] + rounds[2:], reqs, step_s)
    wall = time.monotonic() - t_start
    launches = read_counters(counters)
    st = srv.stats()

    out = [r.output for r in reqs]
    if mesh:
        # bf16 over a mesh: the agreement with phase 12's tokens
        want = ref12["outputs"]
        same = [sum(a == b for a, b in zip(o, w)) for o, w in zip(out, want)]
        agree = f"{sum(same)} of {sum(map(len, want))} tokens equal phase " \
            f"12's ({sum(o == w for o, w in zip(out, want))} of " \
            f"{len(want)} requests whole)"
    else:
        # the same tokens as phase 5, request by request
        want = ref["tokens_by_round"][0] + \
            ref["tokens_by_round"][0][SLOTS:] + ref["tokens_by_round"][1]
        bad = [r.rid for r, o, w in zip(reqs, out, want) if o != w]
        if bad:
            raise AssertionError(f"[12] requests {bad} differ from phase "
                                 f"5's (the replay wave is rids "
                                 f"{2 * SLOTS}..{3 * SLOTS - 1})")
        agree = ("tokens equal phase 5's request by request (the replay "
                 "wave's its round 1 wave 2's)")
    if (scale["sync"]["detached"] != ["decode/1"] or st["requeued"]
            or not scale["held"] or scale["handoffs"] != scale["held"]
            or scale["pages_migrated"] <= 0 or len(srv.done) != len(reqs)
            or any(len(r.output) != MAX_NEW for r in reqs)):
        raise AssertionError(f"[{tag}] the scale-down did not hand off: "
                             f"{scale}, {st['requeued']} requeued")
    log(f"[{tag}] {len(reqs)} requests: {agree}; scale-down "
        f"2 -> 1 replica after wave 1's pump: {scale['handoffs']} in-flight "
        f"slots of {scale['held']} handed off, {scale['pages_migrated']} "
        f"prefix pages migrated, over {scale['transfers']} pages transfers "
        f"of {scale['bytes'] / 1e6:.2f} MB ({scale['enqueue_s'] * 1e3:.2f} "
        f"ms to enqueue); apply + sync {scale['wall_s'] * 1e3:.1f} ms; "
        f"0 requeued")

    # every worker prefill and replica step after warm-up: a replay
    g = srv.worker.step_graph.stats()
    d = survivor.step_graph.stats()["decode"]
    calls = sum(g[p]["eager_calls"] + g[p]["replays"] for p in g)
    if (any(c["eager_calls"] or c["dropped"] for c in g.values())
            or calls != srv.worker.invocations or d["eager_calls"]
            or d["replays"] != survivor.decode_invocations):
        raise AssertionError(f"[{tag}] not every step replayed: worker {g} "
                             f"({srv.worker.invocations} invocations), "
                             f"survivor decode {d} "
                             f"({survivor.decode_invocations} steps)")
    if not (srv.worker.step_graph.capture and
            survivor.step_graph.capture):
        raise AssertionError(f"[{tag}] the positions sit on one card, yet "
                             "the steps do not capture")
    log(f"[{tag}] worker: {srv.worker.invocations} prefill invocations, all "
        f"replays of one graph a key over its {m} positions "
        f"({ {p: c for p, c in g.items() if c['keys']} }); survivor: "
        f"{survivor.decode_invocations} decode steps, all replays ({d})")

    # the kernels of the path, every layer, on the tensor cores
    decodes = st["decode_invocations"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"[{tag}] a kernel was never launched: "
                             f"{launches}")
    expect(f"[{tag}] paged decode", launches["paged_decode_attention"],
           m * L * decodes)
    expect(f"[{tag}] flash and paged extend",
           launches["flash_attention"] + launches["paged_extend_attention"],
           m * L * srv.worker.invocations)
    expect_tc(launches, "flash_attention", "paged_extend_attention")
    if mesh:
        for name, want in ref12["launches"].items():
            expect(f"[{tag}] {name}: 2 x phase 12's", launches[name],
                   2 * want)

    # end to end
    toks = sum(len(r.output) for r in reqs)
    ttft = [float(np.median([r.ttft for r in reqs[i:i + SLOTS]]))
            for i in range(0, len(reqs), SLOTS)]
    per_req = {}
    for e in sup.cells["prefill"].accounting.recorder.log:
        if e["name"] == "channel":
            kind = "cold" if e["trace_id"] // SLOTS in (0, 3) else "warm"
            per_req.setdefault(kind, []).append(e["attrs"]["bytes"])
    handoff = {"bytes": st["kv_bytes"], "transfers": st["kv_transfers"],
               "enqueue_s": st["kv_seconds"],
               "bytes_per_request": {k: float(np.mean(v))
                                     for k, v in per_req.items()}}
    # decode/1 handed its slots off before its first decode step
    replica_step = {"decode/0": sup.cells["decode/0"].accounting.recorder
                    .hists["decode_step_s"].quantile(0.5)}
    if "decode_step_s" in srv._detached_hists:
        replica_step["decode/1"] = \
            srv._detached_hists["decode_step_s"].quantile(0.5)
    peak = torch.cuda.max_memory_allocated()
    e2e = {"tokens_per_s": toks / wall, "ttft_p50_by_wave_s": ttft,
           "decode_step_s": float(np.median(step_s)), "wall_s": wall,
           "replica_decode_step_p50_s": replica_step, "handoff": handoff,
           "fanout": fanout, "scale_down": {k: v for k, v in scale.items()
                                            if k != "sync"},
           "peak_gb": peak / 1e9, "launches": launches,
           "worker_invocations": srv.worker.invocations,
           "decode_invocations": decodes, "outputs": out,
           "logits": logits}
    log(f"[{tag}] {len(reqs)} requests x {MAX_NEW} tokens in {wall:.2f} s: "
        f"{toks / wall:.1f} tokens/s; TTFT p50 by wave "
        f"{' / '.join(f'{w * 1e3:.1f}' for w in ttft)} ms (wave 3 the "
        f"replay); decode step p50 by replica (recorder) "
        + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in replica_step.items())
        + f", a decode-only tick {e2e['decode_step_s'] * 1e3:.2f} ms")
    log(f"[{tag}] KV handoff: {handoff['transfers']} transfers, "
        f"{handoff['bytes'] / 1e6:.2f} MB, {handoff['enqueue_s'] * 1e3:.2f} "
        f"ms to enqueue; bytes a request "
        + ", ".join(f"{k} {v / 1e6:.3f} MB"
                    for k, v in handoff["bytes_per_request"].items())
        + f"; peak {peak / 1e9:.2f} GB allocated; launches {launches} "
        f"({name_limit})")
    e2e["verb_seconds"] = verb_seconds(sup.events)
    log(f"[{tag}] supervisor verbs (event log seconds, {name_limit}): " +
        ", ".join(f"{k} {v * 1e3:.3f} ms"
                  for k, v in e2e["verb_seconds"].items()))

    # destroy the cells: the weights, pools and graphs go
    srv.close()
    del srv, survivor
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    for name in list(sup.cells):
        sup.destroy_cell(name)
    gc.collect()
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    left = torch.cuda.memory_allocated() - base
    if freed < 2 * weights or left > 1e9:
        raise AssertionError(f"[{tag}] destroying the cells freed {freed} "
                             f"bytes, {left} bytes are left above the "
                             "phase's start")
    log(f"[{tag}] destroy freed {freed / 1e9:.2f} GB; "
        f"{left / 1e6:.1f} MB left above the phase's start")
    e2e["freed_gb"] = freed / 1e9
    return e2e


def mesh_logits(tag, dev, model2, params2=None, model1=None,
                params1=None) -> dict:
    """The first cold prefill of phase 5's round 1 (its first bucket's
    prompts) through ``model2``, a model over a mesh of the card, on
    ``params2`` (default phase 5's weights laid out by its rules), against
    the one-position model on phase 5's weights (``model1``, ``params1``,
    drawn anew when not given): the last-position logits must lie within
    phases 16-17's limit, 2e-2 or, where larger, the one-position bf16
    model's distance from its float32 copy.  Returns the distances."""
    from repro_torch.models.model import Model
    from repro_torch.models.param import shard_tree, tree_map
    from repro_torch.serve.serve_step import bucket_len, prefill_inputs
    if model1 is None:
        model1, params1 = full_width(dev, "qwen3-4b", tag)
    if params2 is None:
        params2 = shard_tree(params1, model2.params_pspecs(), model2.ctx)
    wave = main_path_rounds(0, model1.cfg.vocab)[0]
    b0 = bucket_len(len(wave[0]), CHUNK, MAX_LEN)
    prompts = [p for p in wave if bucket_len(len(p), CHUNK, MAX_LEN) == b0]
    key, host = prefill_inputs(prompts, [None] * len(prompts), chunk=CHUNK,
                               max_len=MAX_LEN, model=model1)
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                 else v).to(dev) for k, v in host.items()}
    n, V = len(prompts), model1.cfg.vocab

    def last_logits(model, params):
        with torch.no_grad():
            out, _ = model.prefill_ranged(params, batch, model.init_cache(
                key[1], MAX_LEN, device=dev), in_place=True)
        return out[:n, :V].float()

    l2 = last_logits(model2, params2)
    l1 = last_logits(model1, params1)
    del params2
    p32 = tree_map(lambda t: t.float(), params1)
    l1_32 = last_logits(Model(model1.cfg.replace(dtype="float32")), p32)
    del p32
    err, acc = rel(l2, l1), rel(l1, l1_32)
    limit = max(2e-2, acc)
    log(f"[{tag}] first cold prefill ({n} prompts, key {key}) over "
        f"{model2.ctx.mesh.shape}: last-position logits rel {err:.3e} "
        f"against the one-position model (tol {limit:.3e}: 2e-2, or the "
        f"one-position bf16 model's distance from float32 where larger); "
        f"the mesh's bf16 against the float32 one-position model "
        f"{rel(l2, l1_32):.3e}, one position's {acc:.3e}")
    if not err < limit:
        raise AssertionError(f"[{tag}] logits rel {err} >= {limit}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"logits_rel": err, "limit": limit, "bf16_vs_f32": acc,
            "mesh_vs_f32": rel(l2, l1_32)}


# --------------------------------------------------------------------------
# phase 19b: qwen3-4b at full width on an int8 paged pool
# --------------------------------------------------------------------------
def phase_int8(dev, name_limit: str, ref5: dict, ref17a: dict) -> dict:
    """Full-width qwen3-4b on an int8 paged pool (``kv_dtype="int8"``: one
    float32 scale a page and layer over every kv head, the pages
    quantised on write and dequantised in the paged kernels), phase 5's
    weights and two rounds, first behind a batcher at one position, then
    from a cell over (``data`` 2, ``model`` 2) of the card (phase 17a's
    layout: each position's arena holds its 4 of the 8 kv heads, whole on
    both data rows; each page write's scale the ``pmax`` over ``model`` of
    the positions' maxima).  Checks every kernel launched exactly 4x the
    one-position run's count (prefill and the paged extend over the int8
    arena all on the tensor cores), every position's scale tables and every
    data row's
    int8 arena bitwise equal, one CUDA graph a key; prints the tokens'
    agreement with phase 5 (the bf16 arena) and between the two runs, the
    first cold prefill's logits against the one-position model, the peak
    memory beside phases 5 and 17a's, and times the one-position drained
    batcher's extend call as phase 5 times its own.  Returns the launches
    of both runs together (the kernels line's int8 rows) and each run's
    numbers."""
    from repro_torch.core import (
        CellSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
    )
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.serve.batcher import ContinuousBatcher

    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention)
    rounds = main_path_rounds()
    model1, params1 = full_width(dev, "qwen3-4b", "19b")
    cfg = model1.cfg
    L = cfg.num_layers
    out = {}

    def run(name, bat_fn, m):
        tag = f"19b {name}"
        warm_up(bat_fn, cfg.vocab)
        torch.cuda.reset_peak_memory_stats()
        bat = bat_fn()
        if bat.pool.arena[0].k.dtype != torch.int8:
            raise AssertionError(f"[{tag}] the arena is not int8")
        reqs, launches, wall, step_s, marks = serve(bat, rounds, counters)
        expect(f"[{tag}] paged decode over the int8 arena",
               launches["paged_decode_attention"],
               m * L * bat.decode_invocations)
        expect(f"[{tag}] prefill + paged extend over the int8 arena",
               launches["flash_attention"]
               + launches["paged_extend_attention"],
               m * L * bat.prefill_invocations)
        expect_tc(launches, "flash_attention", "paged_extend_attention")
        check_drained(bat.pool, SLOTS * SHARED)
        e2e = report(tag, name_limit, bat, reqs, wall, step_s, launches,
                     cfg.vocab)
        e2e["outputs"] = [r.output for r in reqs]
        e2e["graphs"] = expect_graphed(tag, bat)
        e2e["round2"] = expect_round2_replayed(tag, bat, marks[2])
        e2e["memory"] = memory_report(tag, bat)
        if m == 1:   # beside phase 5's extend call over the bf16 arena
            e2e["extend_ab"] = time_prefill(tag, bat, "extend", name_limit)
        return bat, e2e

    bat, out["one"] = run("one position", lambda: ContinuousBatcher(
        model1, params1, batch_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        prefill_chunk=CHUNK, kv_dtype="int8", device=dev), 1)
    bat.close()
    del bat
    gc.collect()
    torch.cuda.empty_cache()
    sup = Supervisor(DeviceGrid.from_flat([dev] * 4, 1, 2, 2))
    sup.apply(ClusterSpec(cells=(CellSpec(cfg.name, cfg, "serve",
                                          ncols=2),)))
    cell = sup.cells[cfg.name]
    if cell.mesh.shape != {"data": 2, "model": 2}:
        raise AssertionError(f"[19b] the cell's mesh is {cell.mesh}")
    cell.init_serve(params=params1)
    out["logits"] = mesh_logits("19b", dev, cell.model, cell.serve_params,
                                model1, params1)
    del model1, params1
    gc.collect()
    torch.cuda.empty_cache()
    bat, out["mesh"] = run("(2, 2)", lambda: cell.make_batcher(
        batch_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
        prefill_chunk=CHUNK, kv_dtype="int8"), 4)
    one, mesh = out["one"], out["mesh"]
    for name, want in one["launches"].items():
        expect(f"[19b] {name}: 4 x the one-position int8 run's",
               mesh["launches"][name], 4 * want)
    groups = cell.mesh.groups(("data",))
    for node, scales in zip(bat.pool.arena, bat.pool.kv_scales):
        for table in scales:
            if not all(torch.equal(table.shards[0], x)
                       for x in table.shards):
                raise AssertionError("[19b] the positions' scale tables "
                                     "differ")
        for leaf in node:
            for g in groups:
                if not all(torch.equal(leaf.shards[g[0]], leaf.shards[r])
                           for r in g[1:]):
                    raise AssertionError("[19b] the data rows' int8 arenas "
                                         "differ")

    def agree(a, b):
        return [sum(x == y for o, w in zip(a, b) for x, y in zip(o, w)),
                sum(map(len, b))]
    out["agreement"] = {"one_int8_vs_phase5": agree(one["outputs"],
                                                    ref5["outputs"]),
                        "mesh_int8_vs_one_int8": agree(mesh["outputs"],
                                                       one["outputs"]),
                        "mesh_int8_vs_17a": agree(mesh["outputs"],
                                                  ref17a["outputs"])}
    a = out["agreement"]
    log(f"[19b] greedy tokens equal: one-position int8 against phase 5 "
        f"(bf16 arena) {a['one_int8_vs_phase5'][0]} of "
        f"{a['one_int8_vs_phase5'][1]}; (2, 2) int8 against one-position "
        f"int8 {a['mesh_int8_vs_one_int8'][0]} of "
        f"{a['mesh_int8_vs_one_int8'][1]}; (2, 2) int8 against phase 17a "
        f"(bf16) {a['mesh_int8_vs_17a'][0]} of {a['mesh_int8_vs_17a'][1]}")
    log(f"[19b] every position's scale tables and every data row's int8 "
        f"arena bitwise equal; peak {one['memory']['peak_gb']:.2f} GB at one "
        f"position (phase 5, bf16 arena: {ref5['memory']['peak_gb']:.2f} "
        f"GB), {mesh['memory']['peak_gb']:.2f} GB over (2, 2) (phase 17a: "
        f"{ref17a['memory']['peak_gb']:.2f} GB) ({name_limit})")
    out["launches"] = {k: one["launches"][k] + mesh["launches"][k]
                       for k in one["launches"]}
    bat.close()
    sup.destroy_cell(cfg.name)
    return out


#: phase 16's model-level decode over a cache split on its sequence dim:
#: rows, prompt tokens, then decode steps
SEQ_ROWS, SEQ_PROMPT, SEQ_STEPS = 4, 192, 4


def seq_sharded_decode(dev, model1, params1, ctx, params) -> dict:
    """The model-level sequence-sharded decode: ``model1``'s config built
    over ``ctx`` (``params``: laid out by its ``params_pspecs``) with a
    dense cache laid out by ``Model.cache_pspecs`` (its sequence dim over
    ``model``), prefilled with SEQ_PROMPT tokens, then SEQ_STEPS decode
    steps with ``sharded_decode`` on (the LSE combine: each position
    attends over its own slots) and off (the owning position writes the
    token, the cache is all-gathered, the dense decode kernel runs per
    position).  Every step's logits must be within 2e-2 of the
    one-position model's on the same tokens; the gather path must launch
    the dense decode kernel once a layer a position a step, the LSE path
    never, and the prefill flash once a layer a position; the LSE path
    must move fewer collective bytes a step.  Returns each path's error,
    launches and collective bytes a step."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.model import build_model
    from repro_torch.sharding.collectives import recording

    cfg = model1.cfg
    B, S = SEQ_ROWS, SEQ_PROMPT + SEQ_STEPS
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)).to(dev)

    def run(model, params, cache):
        steps = []
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks[:, :SEQ_PROMPT]},
                                     cache)
            for p in range(SEQ_PROMPT, S):
                with recording() as coll:
                    logits, cache = model.decode(params, cache, {
                        "tokens": toks[:, p:p + 1],
                        "pos": torch.full((B,), p, dtype=torch.int32,
                                          device=dev)})
                steps.append((logits[:, :cfg.vocab], dict(coll)))
        return steps

    ref = run(model1, params1, model1.init_cache(B, S, device=dev))
    counters = (decode_attention, flash_attention)
    out = {}
    for sd, name in ((False, "gathered"), (True, "lse")):
        model = build_model(cfg.replace(sharded_decode=sd), ctx)
        cache = model.init_cache(B, S, device=dev,
                                 pspecs=model.cache_pspecs(B, S))
        if "model" not in cache["layers"].k.spec.axes_of(2):
            raise AssertionError(f"[16] the cache's layout "
                                 f"{cache['layers'].k.spec} does not split "
                                 "its sequence dim over model")
        reset_counters(counters)
        got = run(model, params, cache)
        out[name] = {"logits_rel": max(rel(a, b) for (a, _), (b, _)
                                       in zip(got, ref)),
                     "launches": read_counters(counters),
                     "collective_bytes": got[-1][1]}
        log(f"[16] decode over a cache split on its sequence dim, "
            f"{name}: B {B}, {SEQ_PROMPT} prompt tokens, {SEQ_STEPS} steps; "
            f"logits rel {out[name]['logits_rel']:.3e} against one "
            f"position (tol 2e-2); launches {out[name]['launches']}; "
            f"collective bytes a step per position "
            f"{out[name]['collective_bytes']}")
    L, m = cfg.num_layers, ctx.mesh.size
    for name, want in (("gathered", SEQ_STEPS * L * m), ("lse", 0)):
        got = out[name]
        if not got["logits_rel"] < 2e-2:
            raise AssertionError(f"[16] {name}: logits rel "
                                 f"{got['logits_rel']} >= 2e-2")
        expect(f"{name} dense decode", got["launches"]["decode_attention"],
               want)
        expect(f"{name} prefill flash", got["launches"]["flash_attention"],
               L * m)
    moved = {k: sum(v["collective_bytes"].values()) for k, v in out.items()}
    if not moved["lse"] < moved["gathered"]:
        raise AssertionError(f"[16] the LSE combine moves {moved['lse']} "
                             f"bytes a step, the gather {moved['gathered']}")
    return out


# --------------------------------------------------------------------------
# phase 16: qwen3-4b served from a cell over two mesh positions
# --------------------------------------------------------------------------
def phase_sharded(dev, name_limit: str, ref: dict) -> dict:
    """Full-width qwen3-4b from a serve cell over a zone of two mesh
    positions of the card (heads, ffn and vocab over ``model``), phase
    5's weights and two rounds.  Returns the launches, the end-to-end
    numbers, the logits' error against the one-position model, the
    greedy tokens' agreement with phase 5, the graph counters and the
    collective bytes of each step key."""
    from repro_torch.core import (
        CellSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
    )
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.serve.serve_step import bucket_len, prefill_inputs
    from repro_torch.sharding.collectives import recording

    model1, params1 = full_width(dev, "qwen3-4b", 16)   # phase 5's weights
    cfg = model1.cfg
    sup = Supervisor(DeviceGrid.from_flat([dev, dev], 1, 1, 2))
    sup.apply(ClusterSpec(cells=(CellSpec(cfg.name, cfg, "serve",
                                          ncols=2),)))
    cell = sup.cells[cfg.name]
    if cell.mesh.shape != {"data": 1, "model": 2} or not cell.model.sharded:
        raise AssertionError(f"[16] the cell's mesh is {cell.mesh}")
    cell.init_serve(params=params1)
    # the first cold prefill's logits against the one-position model's
    wave = main_path_rounds()[0]
    b0 = bucket_len(len(wave[0]), CHUNK, MAX_LEN)
    group = [p for p in wave if bucket_len(len(p), CHUNK, MAX_LEN) == b0]
    key, host = prefill_inputs(group, [None] * len(group), chunk=CHUNK,
                               max_len=MAX_LEN, model=model1)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    with torch.no_grad():
        l1, _ = model1.prefill_ranged(params1, batch, model1.init_cache(
            key[1], MAX_LEN, device=dev), in_place=True)
        with recording() as pre_log:
            l2, _ = cell.model.prefill_ranged(
                cell.serve_params, batch, cell.model.init_cache(
                    key[1], MAX_LEN, device=dev), in_place=True)
    n, V = len(group), cfg.vocab
    err = rel(l2[:n, :V], l1[:n, :V])
    log(f"[16] first cold prefill ({n} prompts, key {key}): last-position "
        f"logits rel {err:.3e} against the one-position model (tol 2e-2); "
        f"collectives {dict(pre_log)}")
    if not err < 2e-2:
        raise AssertionError(f"[16] logits rel {err} >= 2e-2")
    del l1, l2, batch
    seq = seq_sharded_decode(dev, model1, params1, cell.model.ctx,
                             cell.serve_params)
    del model1, params1
    gc.collect()
    torch.cuda.empty_cache()

    def batcher():
        return cell.make_batcher(batch_slots=SLOTS, max_len=MAX_LEN,
                                 page_size=PAGE, prefill_chunk=CHUNK)

    warm_up(batcher, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    bat = batcher()
    if not bat.step_graph.capture:
        raise AssertionError("[16] both positions sit on one card, yet "
                             "the steps do not capture")
    counters = (flash_attention, paged_extend_attention,
                paged_decode_attention)
    hits = []
    reqs, launches, wall, step_s, marks = serve(
        bat, main_path_rounds(0, cfg.vocab), counters, hits=hits)
    L, m = cfg.num_layers, cell.mesh.size
    expect("paged decode", launches["paged_decode_attention"],
           m * L * bat.decode_invocations)
    expect_tc(launches, "flash_attention", "paged_extend_attention")
    check_drained(bat.pool, SLOTS * SHARED)
    e2e = report(16, name_limit, bat, reqs, wall, step_s, launches,
                 cfg.vocab)
    e2e["logits_rel"] = err
    e2e["seq_decode"] = seq
    want = [t for rnd in ref["tokens_by_round"] for r in rnd for t in r]
    got = [t for r in reqs for t in r.output]
    same = sum(a == b for a, b in zip(got, want))
    e2e["token_agreement"] = [same, len(want)]
    first = sum(a[0] == b[0] for a, b in zip(
        [r.output for r in reqs], [r for rnd in ref["tokens_by_round"]
                                   for r in rnd]))
    log(f"[16] greedy tokens equal to phase 5's: {same} of {len(want)}; "
        f"first tokens {first} of {len(reqs)} (bf16 row-parallel sums "
        "round differently from one device's)")
    e2e["graphs"] = expect_graphed(16, bat)
    e2e["round2"] = expect_round2_replayed(16, bat, marks[2])
    log("[16] steps captured as one CUDA graph a key over both positions "
        "(one card)")
    e2e["memory"] = memory_report(16, bat)
    log(f"[16] peak {e2e['memory']['peak_gb']:.2f} GB over both positions "
        f"of the card ({name_limit})")
    e2e["collective_bytes"] = {
        k: dict(v.collective_per_device)
        for k, v in cell.accounting.programs.items()}
    for k, v in sorted(e2e["collective_bytes"].items()):
        log(f"[16] collective bytes per position, step key {k}: {v} "
            f"({name_limit})")
    e2e["step_ab"] = time_decode_step(16, bat, ("paged", 8), name_limit)
    bat.close()
    sup.destroy_cell(cfg.name)
    return e2e


# --------------------------------------------------------------------------
# phases 16b-16d: mamba2, zamba2 and seamless served over two positions;
# 17a-17e: all five families over two rows of two positions
# --------------------------------------------------------------------------
#: (tag, arch, the one-position phase whose weights and traffic it runs)
SHARDED_FAMILIES = (("16b", "mamba2-2.7b", 8), ("16c", "zamba2-2.7b", 9),
                    ("16d", "seamless-m4t-large-v2", 10))
ROW_FAMILIES = (("17a", "qwen3-4b", 5), ("17b", "deepseek-moe-16b", 7),
                ("17c", "mamba2-2.7b", 8), ("17d", "zamba2-2.7b", 9),
                ("17e", "seamless-m4t-large-v2", 10))
#: deepseek-moe-16b's depth for the float32 logits check over two rows
#: (float32 copies of its 16.4 B parameters do not fit beside the bf16
#: weights): its dense layer and the first 3 MoE layers
MOE_F32_LAYERS = 4


def phase_sharded_family(dev, name_limit: str, arch: str, tag: str,
                         ref: dict, rows: int = 1) -> dict:
    """Full-width ``arch`` from a serve cell over a zone of ``rows`` rows
    of two mesh positions of the card ((``data`` 1, ``model`` 2), phases
    16b-16d; (2, 2), phases 17a-17e: the batch split over ``data``, FSDP
    weights gathered layer by layer, the paged arena and the snapshot
    payloads whole on both data rows, the paged writes mirrored), with
    the one-position phase's (``ref``) weights, two rounds and, for
    seamless, sources: qwen3-4b's attention over 16 of 32 heads and its
    MLP over 4864 of 9728 a position; deepseek-moe-16b's 64 experts, 32
    a position; mamba2-2.7b and zamba2-2.7b on the snapshot pool, each
    Mamba layer over 40 of its 80 SSD heads a position (the gated norm's
    sum of squares and ``out_proj`` each a ``psum``), zamba2's shared
    attention (16 of 32 heads of 80) and MLP tensor-parallel; seamless's
    encoder, decoder self- and cross-attention over 8 of 16 heads a
    position, its cross memory laid out by heads.  Returns the launches
    (each kernel the one-position phase's times the positions, one
    launch a position), the end-to-end numbers, the first cold prefill's
    logits error against the one-position model (bf16, and float32
    copies of both; deepseek-moe-16b's at ``MOE_F32_LAYERS`` layers), the
    greedy tokens' agreement with the one-position phase, the snapshot
    counters, the graph counters, the peak memory and the collective
    bytes of each step key."""
    from repro_torch.core import (
        CellSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
    )
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        paged_extend_attention,
    )
    from repro_torch.kernels.moe_gmm.ops import gmm
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.models.model import Model, build_model
    from repro_torch.models.param import shard_tree, tree_map
    from repro_torch.serve.serve_step import bucket_len, prefill_inputs
    from repro_torch.serve.step_graph import DENSE_KEY
    from repro_torch.sharding.collectives import recording

    model1, params1 = full_width(dev, arch, tag)    # the phase's weights
    cfg = model1.cfg
    recurrent = cfg.family in ("ssm", "hybrid")
    sup = Supervisor(DeviceGrid.from_flat([dev] * (2 * rows), 1, rows, 2))
    sup.apply(ClusterSpec(cells=(CellSpec(cfg.name, cfg, "serve",
                                          ncols=2),)))
    cell = sup.cells[cfg.name]
    if cell.mesh.shape != {"data": rows, "model": 2} or \
            not cell.model.sharded:
        raise AssertionError(f"[{tag}] the cell's mesh is {cell.mesh}")
    cell.init_serve(params=params1)
    rounds = main_path_rounds(0, cfg.vocab)
    srcs = encdec_sources() if cfg.family == "encdec" else None
    # the first cold prefill's logits against the one-position model's,
    # in bf16 and through float32 copies of both
    wave = rounds[0]
    b0 = bucket_len(len(wave[0]), CHUNK, MAX_LEN)
    idx = [i for i, p in enumerate(wave)
           if bucket_len(len(p), CHUNK, MAX_LEN) == b0]
    prompts = [wave[i] for i in idx]
    if cfg.family == "moe":
        # a position's expert capacity comes from its own tokens (JAX's
        # per-shard body): compare where both are dropless, 64 tokens on
        # one position (its inference capacity is then its token count),
        # 32 a data row
        idx, prompts = [0, 1], [p[:CHUNK] for p in wave[:2]]
    key, host = prefill_inputs(
        prompts, [srcs[0][i] if srcs else None for i in idx],
        chunk=CHUNK, max_len=MAX_LEN, model=model1)
    batch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                 else v).to(dev) for k, v in host.items()}
    n, V = len(idx), cfg.vocab

    def last_logits(model, params):
        with torch.no_grad():
            out, _ = model.prefill_ranged(params, batch, model.init_cache(
                key[1], MAX_LEN, device=dev), in_place=True)
        return out[:n, :V].float()

    with recording() as pre_log:
        l2 = last_logits(cell.model, cell.serve_params)
    l1 = last_logits(model1, params1)
    err_full = rel(l2, l1)
    where = "all layers"
    if cfg.family == "moe":
        # the float32 checks at MOE_F32_LAYERS layers, the same weights'
        # first layers (copies: the full tree goes now)
        cfg = cfg.replace(num_layers=MOE_F32_LAYERS)
        k = MOE_F32_LAYERS - cfg.moe.first_dense_layers
        params1 = {name: tree_map(
            lambda t: (t[:k] if name == "moe_layers" else t).clone(), v)
            for name, v in params1.items()}
        model1 = Model(cfg)
        cut = build_model(cfg, cell.model.ctx)
        l2 = last_logits(cut, shard_tree(params1, cut.params_pspecs(),
                                         cut.ctx))
        l1 = last_logits(model1, params1)
        where = f"{MOE_F32_LAYERS} of {cell.arch.num_layers} layers"
        del cut
        cfg = cell.arch
    f32 = model1.cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params1)
    del model1, params1
    l1_32 = last_logits(Model(f32), p32)
    two32 = build_model(f32, cell.model.ctx)
    l2_32 = last_logits(two32, shard_tree(p32, two32.params_pspecs(),
                                          two32.ctx))
    err, err32 = rel(l2, l1), rel(l2_32, l1_32)
    acc = [rel(l1, l1_32), rel(l2, l1_32)]
    # two bf16 runs of one function agree no better than each agrees with
    # float32: the limit is 2e-2 or, where larger, the one-position bf16
    # model's own distance from its float32 copy; the mesh's model must
    # be as accurate (within 1.25x of that distance)
    limit = max(2e-2, acc[0])
    m = cell.mesh.size
    log(f"[{tag}] first cold prefill ({n} prompts, key {key}): last-position "
        f"logits rel {err_full:.3e} against the one-position model, all "
        f"layers; at {where}: {err:.3e} (tol {limit:.3e}: 2e-2, or the "
        f"one-position bf16 model's distance from float32 where larger); "
        f"float32 copies of both {err32:.3e} (tol 1e-4); bf16 against the "
        f"float32 one-position model: one position {acc[0]:.3e}, {m} "
        f"positions {acc[1]:.3e}; collectives {dict(pre_log)}")
    if not err < limit:
        raise AssertionError(f"[{tag}] logits rel {err} >= {limit}")
    if not acc[1] <= 1.25 * acc[0]:
        raise AssertionError(f"[{tag}] the {m}-position bf16 model is "
                             f"{acc[1]} from float32, one position {acc[0]}")
    if not err32 < 1e-4:
        raise AssertionError(f"[{tag}] float32 logits rel {err32} >= 1e-4")
    del l1, l2, l1_32, l2_32, batch, p32, two32
    gc.collect()
    torch.cuda.empty_cache()

    def batcher():
        kw = {"pool_pages": SNAP_PAGES} if recurrent else {}
        return cell.make_batcher(batch_slots=SLOTS, max_len=MAX_LEN,
                                 page_size=PAGE, prefill_chunk=CHUNK, **kw)

    warm_up(batcher, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    bat = batcher()
    if not bat.step_graph.capture:
        raise AssertionError(f"[{tag}] both positions sit on one card, yet "
                             "the steps do not capture")
    counters = (ssd, flash_attention, paged_extend_attention,
                decode_attention, paged_decode_attention, gmm)
    reqs, launches, wall, step_s, marks = serve(bat, rounds, counters,
                                                srcs=srcs)
    if cfg.family == "encdec":
        encdec_launches(tag, bat, launches, cell.model.source_len(MAX_LEN),
                        m)
    elif cfg.family in ("dense", "moe"):
        expect("paged decode (one a layer a position a step)",
               launches["paged_decode_attention"],
               m * cfg.num_layers * bat.decode_invocations)
        expect("prefill + paged extend (one a layer a position a call)",
               launches["flash_attention"]
               + launches["paged_extend_attention"],
               m * cfg.num_layers * bat.prefill_invocations)
        expect_tc(launches, "flash_attention", "paged_extend_attention")
        if cfg.family == "moe":
            # each position's decode capacity is its data row's slots
            n_moe = cfg.num_layers - cfg.moe.first_dense_layers
            c_dec = SLOTS // rows
            by_c = dict(sorted(gmm.launches_by_capacity.items()))
            launches["gmm_prefill"] = sum(n for c, n in by_c.items()
                                          if c != c_dec)
            expect(f"grouped GEMM at decode (C {c_dec})", by_c.get(c_dec, 0),
                   m * 3 * n_moe * bat.decode_invocations)
            expect("grouped GEMM at the prefill shapes",
                   launches["gmm_prefill"],
                   m * 3 * n_moe * bat.prefill_invocations)
            expect_tc(launches, "gmm")
            log(f"[{tag}] grouped GEMM launches by capacity C (all "
                f"positions): {by_c}")
    else:
        n_attn = (cfg.num_layers // cfg.hybrid_attn_every
                  if cfg.family == "hybrid" else 0)
        expect("SSD scan (one a Mamba layer a position a prefill or extend)",
               launches["ssd"], m * cfg.num_layers * bat.prefill_invocations)
        expect("prefill + dense extend attention",
               launches["flash_attention"]
               + launches["paged_extend_attention"],
               m * n_attn * bat.prefill_invocations)
        expect("dense decode", launches["decode_attention"],
               m * n_attn * bat.decode_invocations)
        expect("paged decode on the snapshot plane",
               launches["paged_decode_attention"], 0)
        expect_tc(launches, "flash_attention", "paged_extend_attention")
    # the one-position phase ran the same traffic in as many invocations
    # (one host schedule): every kernel launched once a position
    same = (bat.prefill_invocations == ref["prefill_invocations"]
            and bat.decode_invocations == ref["decode_steps"])
    if not same:
        raise AssertionError(f"[{tag}] {bat.prefill_invocations} prefill and "
                             f"{bat.decode_invocations} decode invocations, "
                             f"the one-position phase "
                             f"{ref['prefill_invocations']} and "
                             f"{ref['decode_steps']}")
    for name, want in ref["launches"].items():
        expect(f"{name}: {m} x the one-position phase's", launches[name],
               m * want)
    check_drained(bat.pool, SLOTS * SHARED)
    e2e = report(tag, name_limit, bat, reqs, wall, step_s, launches,
                 cfg.vocab)
    e2e["logits_rel"] = err
    e2e["logits_rel_all_layers"] = err_full
    e2e["logits_rel_f32"] = err32
    e2e["bf16_vs_f32"] = acc
    if recurrent:
        st = bat.pool.stats()
        e2e["snapshot"] = {k: st[k] for k in ref["snapshot"]}
        if e2e["snapshot"] != ref["snapshot"]:
            raise AssertionError(f"[{tag}] snapshot counters {e2e['snapshot']}"
                                 f", the one-position phase's "
                                 f"{ref['snapshot']}")
        log(f"[{tag}] snapshot pool: {st['snapshots_interned']} payloads "
            f"interned, {st['snapshot_hit_tokens']} snapshot-hit tokens, "
            f"{st['snapshot_bytes_saved'] / 1e9:.2f} GB saved (logical "
            f"bytes, as the one-position phase's); checkpoint workspace "
            f"{bat._ckpts.capacity} (row, checkpoint) pairs a position, "
            f"{bat._ckpts.regrowths} regrowths")
    want = [t for r in ref["outputs"] for t in r]
    got = [t for r in reqs for t in r.output]
    e2e["outputs"] = [r.output for r in reqs]       # what 19b compares
    e2e["token_agreement"] = [sum(a == b for a, b in zip(got, want)),
                              len(want)]
    first = sum(r.output[0] == w[0] for r, w in zip(reqs, ref["outputs"]))
    log(f"[{tag}] greedy tokens equal to the one-position phase's: "
        f"{e2e['token_agreement'][0]} of {len(want)}; first tokens {first} "
        f"of {len(reqs)} (bf16 row-parallel sums round differently from "
        "one device's)")
    e2e["graphs"] = expect_graphed(tag, bat)
    e2e["round2"] = expect_round2_replayed(tag, bat, marks[2])
    log(f"[{tag}] steps captured as one CUDA graph a key over all {m} "
        "positions (one card)")
    e2e["memory"] = memory_report(tag, bat)
    log(f"[{tag}] peak {e2e['memory']['peak_gb']:.2f} GB over the {m} "
        f"positions of the card ({name_limit})")
    e2e["collective_bytes"] = {
        k: dict(v.collective_per_device)
        for k, v in cell.accounting.programs.items()}
    for k, v in sorted(e2e["collective_bytes"].items()):
        log(f"[{tag}] collective bytes per position, step key {k}: {v} "
            f"({name_limit})")
    e2e["step_ab"] = time_decode_step(
        tag, bat, DENSE_KEY if recurrent else ("paged", 8), name_limit)
    bat.close()
    sup.destroy_cell(cfg.name)
    del bat, cell, sup
    return e2e


# --------------------------------------------------------------------------
# phase 13: qwen3-4b trained at full width; 13b: checkpoint and recovery
# --------------------------------------------------------------------------
TRAIN_STEPS, TRAIN_BATCH = 6, 8
# steps of phases 14b (zamba2-2.7b) and 15 (deepseek-moe-16b): fewer than
# phase 13's and 14's, to keep the run's wall time
TRAIN_STEPS_14B = 4
# phase 15's depth: deepseek-moe-16b's first 6 of 28 layers (1 dense + 5
# MoE, 3.443 B parameters), as much training state as one card holds
MOE_TRAIN_LAYERS = 6


def train_launches(cfg, steps: int) -> dict:
    """The exact launch counts of ``steps`` full-width train steps of
    ``cfg`` (each of its ``microbatch`` microbatches runs every layer under
    remat): an attention layer launches the flash kernel twice (forward
    and recompute) and its backward once, all on the tensor cores; a
    Mamba layer the SSD scan twice and its backward once, on the tensor
    cores (bf16); zamba2's shared block (every ``hybrid_attn_every`` Mamba
    layers) counts as an attention layer; a MoE layer launches the grouped
    GEMM six times (gate, up and down, forward and recompute) and its
    backward three times, each with dX and dW, on its wgmma route."""
    micro = steps * cfg.microbatch
    n_ssd = micro * cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    n_attn = (0 if cfg.family == "ssm"
              else micro * cfg.num_layers // cfg.hybrid_attn_every
              if cfg.family == "hybrid" else micro * cfg.num_layers)
    n_moe = (micro * (cfg.num_layers - cfg.moe.first_dense_layers)
             if cfg.family == "moe" else 0)
    return {"flash_attention": 2 * n_attn, "flash_attention_tc": 2 * n_attn,
            "flash_attention_bwd": n_attn, "flash_attention_bwd_tc": n_attn,
            "gmm": 6 * n_moe, "gmm_tc": 6 * n_moe, "gmm_bwd": 3 * n_moe,
            "gmm_bwd_tc": 3 * n_moe, "gmm_bwd_wgmma": 3 * n_moe,
            "gmm_bwd_dx": 3 * n_moe,
            "gmm_bwd_dw": 3 * n_moe, "ssd": 2 * n_ssd, "ssd_bwd": n_ssd,
            "ssd_bwd_tc": n_ssd}


def phase_train(dev, name_limit: str, arch: str = "qwen3-4b",
                tag: str = "13", steps: int = TRAIN_STEPS,
                layers: int = 0, mesh: tuple = (), ref: dict = None,
                collectives: bool = False) -> dict:
    """``arch`` at full width and full depth (``layers``: cut to that many
    layers) trained for ``steps`` steps through the control plane:
    ``Supervisor.apply`` of a train cell, ``init_train`` from a seeded
    generator on the card, ``train_steps``
    on the bigram pipeline, global batch 8 at seq 512 in the config's 2
    microbatches, bf16 params with float32 AdamW moments and float32
    gradient accumulators.  Every layer runs its forward kernels twice
    (the remat recompute) and its backward kernel once
    (``train_launches``); the launch counts must be exactly those.
    Prints each step's xent and grad norm, the step wall p50 over steps
    2 on, tokens/s, MFU at 6 N T against 989 TFLOP/s (N the parameters a
    token meets, ``train_step.active_params``), the step's reckoned
    bound (the SSD forward's float32 products at 67 TFLOP/s, its
    backward's TF32 passes at 495, the rest at 989) and the peak memory,
    which must stay under 76 GB, then one profiled step's largest
    kernels, the port's kernels' shares, the SSD backward's and, for a
    moe model, the grouped GEMM's forward, dX and dW and the dispatch
    ``cumsum``'s.

    ``mesh`` (rows, cols): the cell's zone is ``rows`` x ``cols`` positions
    of the card, (``data`` rows, ``model`` cols); every count is then P =
    rows x cols times ``train_launches``, the bound is the P positions'
    (each runs its part), the profiled step also reports the collectives'
    share of busy, and the first step's xent and grad norm must sit
    within ``TRAIN_XENT_LIMIT`` and ``TRAIN_GRAD_NORM_LIMIT`` of ``ref``'s
    (the one-position phase's, same weights and batches).  ``collectives``: the profiled step records the
    CPU side too, each collective under its range (their share of busy);
    a mesh step otherwise records the device's kernels alone (a trace of
    every position's CPU ops costs tens of seconds)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import (
        CellSpec,
        ClusterSpec,
        DeviceGrid,
        Supervisor,
        single_device_grid,
    )
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.moe_gmm.ops import gmm, gmm_bwd
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_bwd
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_span
    from repro_torch.train.train_step import active_params, ssd_step_flops
    cfg = get_arch(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n_rows, n_cols = mesh or (1, 1)
    n_pos = n_rows * n_cols
    sup = Supervisor(DeviceGrid.from_flat([dev] * n_pos, 1, n_rows, n_cols)
                     if mesh else single_device_grid(dev))
    opt = OptConfig(lr=1e-4, warmup_steps=1, total_steps=100)
    sup.apply(ClusterSpec(cells=(CellSpec("train", cfg, "train",
                                          ncols=n_cols, opt_cfg=opt),)))
    cell = sup.cells["train"]
    t0 = time.monotonic()
    cell.init_train(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = cell.model.n_params()
    if mesh and cell.mesh.shape != {"data": n_rows, "model": n_cols}:
        raise AssertionError(f"[{tag}] cell mesh {cell.mesh.shape}")
    log(f"[{tag}] {cfg.name} train cell over {cell.mesh.shape}: "
        f"{n / 1e9:.3f} B params, "
        f"{cfg.num_layers} layers, microbatch {cfg.microbatch}, init "
        f"{time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated "
        "(bf16 params, float32 m and v)")
    pipe = SyntheticPipeline(DataConfig(kind="bigram"), cfg,
                             ShapeConfig("train", "train", TRAIN_S,
                                         TRAIN_BATCH), device=dev)
    batches = [pipe.get_batch(i) for i in range(steps)]
    counters = (flash_attention, flash_attention_bwd, gmm, gmm_bwd, ssd,
                ssd_bwd)
    reset_counters(counters)
    rows, walls = [], []
    for i in range(steps):
        t0 = time.monotonic()
        m = cell.train_steps(batches.__getitem__, 1)   # floats: synchronised
        walls.append(time.monotonic() - t0)
        rows.append(m)
        log(f"[{tag}] step {i + 1}: xent {m['xent']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.2e} wall "
            f"{walls[-1] * 1e3:.1f} ms")
    launches = read_counters(counters)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite([r["xent"], r["grad_norm"]]).all() for r in rows):
        raise AssertionError(f"[{tag}] a metric is not finite: {rows}")
    if not rows[-1]["xent"] < rows[0]["xent"]:
        raise AssertionError(f"[{tag}] xent did not fall: {rows[0]['xent']}"
                             f" -> {rows[-1]['xent']}")
    for key, want in train_launches(cfg, steps).items():
        expect(f"[{tag}] {key} launches", launches[key], n_pos * want)
    if peak > 76e9:
        raise AssertionError(f"[{tag}] peak {peak / 1e9:.2f} GB over 76 GB")
    xent_rel = gn_rel = None
    if ref is not None:
        xent_rel = abs(rows[0]["xent"] - ref["xent"][0]) / ref["xent"][0]
        if xent_rel > TRAIN_XENT_LIMIT:
            raise AssertionError(
                f"[{tag}] first step's xent {rows[0]['xent']} against the "
                f"one-position cell's {ref['xent'][0]}: rel {xent_rel:.3e} "
                f"over {TRAIN_XENT_LIMIT}")
        log(f"[{tag}] first step's xent {rows[0]['xent']:.6f} against the "
            f"one-position cell's {ref['xent'][0]:.6f} (same weights and "
            f"batch, bf16): rel {xent_rel:.3e} (limit {TRAIN_XENT_LIMIT})")
        gn_rel = (abs(rows[0]["grad_norm"] - ref["grad_norm"][0])
                  / ref["grad_norm"][0])
        log(f"[{tag}] first step's grad norm {rows[0]['grad_norm']:.6f} "
            f"against the one-position cell's {ref['grad_norm'][0]:.6f}: "
            f"rel {gn_rel:.3e} (limit {TRAIN_GRAD_NORM_LIMIT})")
        if gn_rel > TRAIN_GRAD_NORM_LIMIT:
            raise AssertionError(
                f"[{tag}] first step's grad norm rel {gn_rel:.3e} over "
                f"{TRAIN_GRAD_NORM_LIMIT}")
    step_s = float(np.median(walls[1:]))
    tokens = TRAIN_BATCH * TRAIN_S
    t0 = time.monotonic()
    busy, shares, ranges = profile_step(
        lambda: cell.train_steps(lambda _: batches[0], 1),
        collectives=collectives, cpu=collectives or not mesh)
    log(f"[{tag}] the profiled step took {time.monotonic() - t0:.1f} s "
        "with the trace's processing")
    prog = cell.accounting.programs["train_step"]
    ssd_flops = ssd_step_flops(cfg, TRAIN_BATCH, TRAIN_S)
    # the SSD backward's products, in float32 and as its tensor-core
    # route's TF32 passes; the forward's stay float32 on CUDA cores
    bwd_f32 = bwd_tf32 = 0
    if ssd_flops:
        sc = cfg.ssm
        dims = (sc.expand * cfg.d_model // sc.head_dim, sc.head_dim,
                sc.ngroups, sc.d_state, ssd_bwd_span(TRAIN_S, sc.chunk))
        bwd_f32, bwd_tf32 = (cfg.num_layers * ssd_bwd_work(
            TRAIN_BATCH, TRAIN_S, *dims, tc=tc)[1] for tc in (False, True))
    # the card runs every position's part: per-position figures x P
    flops, nbytes = prog.flops_per_device * n_pos, prog.bytes_per_device * n_pos
    yard = max((flops - ssd_flops)
               / PEAK_FLOPS[torch.bfloat16]
               + (ssd_flops - bwd_f32) / PEAK_FLOPS[torch.float32]
               + bwd_tf32 / PEAK_FLOPS["tf32"],
               nbytes / HBM_BYTES_PER_S)
    n_act = active_params(cell.model)
    mfu = 6 * n_act * tokens / step_s / PEAK_FLOPS[torch.bfloat16]
    log(f"[{tag}] step wall p50 (steps 2-{steps}) {step_s * 1e3:.1f} ms; "
        f"{tokens / step_s:,.0f} tokens/s; MFU {mfu:.4f} at 6 N T (N "
        f"{n_act / 1e9:.4f} B a token meets) against "
        f"989 TFLOP/s; reckoned step {flops / 1e12:.1f} "
        f"TFLOP ({ssd_flops / 1e12:.2f} of them the SSD scan's, the "
        f"forward's {(ssd_flops - bwd_f32) / 1e12:.2f} in float32, the "
        f"backward's {bwd_tf32 / 1e12:.2f} as TF32 passes) and "
        f"{nbytes / 1e9:.1f} GB of state "
        f"traffic: bound {yard * 1e3:.1f} ms; peak {peak / 1e9:.2f} GB "
        f"allocated; launches {launches} ({name_limit})")
    log(f"[{tag}] one more step under torch.profiler: device busy "
        f"{busy * 1e3:.1f} ms of a {step_s * 1e3:.1f} ms wall p50; largest "
        f"kernel shares: " + "; ".join(
            f"{name} {t / busy:.3f} ({n} x {t / n * 1e6:.1f} us)"
            for name, t, n in shares[:8]))
    coll_s = sum(ranges.values())
    if collectives:
        log(f"[{tag}] the collectives in that step (device time under "
            f"their ranges, forward, recompute and backward): "
            f"{coll_s * 1e3:.1f} ms, {coll_s / busy:.3f} of busy: " +
            "; ".join(f"{k} {t * 1e3:.1f} ms" for k, t in ranges.items()) +
            f"; bytes a position moved in the first step "
            f"{dict(prog.collective_per_device)}")
    log(f"[{tag}] the port's kernels in that step: " + "; ".join(
        f"{name} {t / busy:.3f} ({n} x {t / n * 1e6:.1f} us)"
        for name, t, n in shares if name.startswith(("void rt::", "rt::"))))
    ssd_bwd_s = sum(t for name, t, _ in shares
                    if "rt::ssd_bwd_" in name or "rt::ssd_scan_bwd_" in name)
    if ssd_bwd_s:
        log(f"[{tag}] the SSD backward's kernels (adjoint, spans, sums) in "
            f"that step: {ssd_bwd_s * 1e3:.1f} ms, {ssd_bwd_s / busy:.3f} "
            f"of busy")
    if cfg.family == "moe":
        parts = {"the grouped GEMM's forward": "rt::gmm_tc_kernel",
                 "its backward's dX": "rt::gmm_dx_wgmma_kernel",
                 "its backward's dW": "rt::gmm_dw_wgmma_kernel",
                 "the dispatch cumsum (scan kernels)": "scan"}
        msg = []
        for what, key in parts.items():
            hit = [(t, c) for name, t, c in shares
                   if key in name.lower() and (key != "scan"
                                               or "rt::" not in name)]
            t = sum(t for t, _ in hit)
            msg.append(f"{what} {t / busy:.3f} ({t * 1e3:.1f} ms, "
                       f"{sum(c for _, c in hit)} kernels)")
        log(f"[{tag}] shares of busy in that step: " + "; ".join(msg))
    sup.destroy_cell("train")
    del cell, batches, pipe
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    if left > 1e9:
        raise AssertionError(f"[{tag}] {left} bytes left after destroy")
    return {"launches": launches, "xent": [r["xent"] for r in rows],
            "grad_norm": [r["grad_norm"] for r in rows],
            "step_s": step_s, "tokens_per_s": tokens / step_s, "mfu": mfu,
            "peak_gb": peak / 1e9, "busy_s": busy, "coll_s": coll_s,
            "xent_rel": xent_rel, "grad_norm_rel": gn_rel}


# --------------------------------------------------------------------------
# phases 18a-18d: train cells over a mesh of positions of the card
# --------------------------------------------------------------------------
#: (tag, arch, (data, model), the one-position phase it stands beside,
#: layers (0: all), steps) of each train phase over a mesh
MESH_TRAIN = (("18a", "qwen3-4b", (1, 2), 13, 0, 4),
              ("18b", "qwen3-4b", (2, 2), 13, 0, 4),
              ("18c", "mamba2-2.7b", (2, 2), 14, 0, 4),
              ("18d", "deepseek-moe-16b", (2, 2), 15, MOE_TRAIN_LAYERS, 4))
#: the one mesh phase whose profiled step records the collectives' share
#: of busy: the CPU side of a step over four positions costs tens of
#: seconds to trace (87 s for qwen3-4b's 36 layers), so the 6 layers of
#: deepseek-moe-16b's (2, 2) step carry it
MESH_PROFILED = "18d"
#: the relative distance a mesh cell's first bf16 step's xent may sit from
#: the one-position cell's on the same weights and batch: each position's
#: partial products are rounded to bf16 before their float32 psum where
#: the one-position matmul rounds the whole sum once, so every TP layer
#: output differs by up to bf16's unit roundoff (3.9e-3) entry by entry;
#: the xent is a mean of 4096 tokens' logsumexp less the label's logit,
#: in which those independent roundings average out, and an error that
#: does not average (a wrong block, a missed psum) moves it by far more
TRAIN_XENT_LIMIT = 1e-3
#: the relative distance a mesh cell's first bf16 step's grad norm may sit
#: from the one-position cell's: it reads every backward kernel at the
#: per-position shapes (flash's dq and dk/dv, the SSD backward, the
#: grouped GEMM's dX and dW) and every cotangent collective.  Its
#: gradients carry the same bf16 roundings as the xent's logits, summed
#: over fewer terms and squared, so it moves more: 9e-5 (qwen3-4b over
#: (2, 2)), 3.0e-4 (mamba2-2.7b) and 5.0e-4 (deepseek-moe-16b) on an
#: H100 at 700 W; a backward that drops or doubles one position's part
#: moves it by a share of the whole norm, tens of times the limit
TRAIN_GRAD_NORM_LIMIT = 3e-3
#: the float32 parity's cut: layers, steps, rows of its batch, tokens
MESH_F32_LAYERS, MESH_F32_STEPS, MESH_F32_B, MESH_F32_S = 2, 2, 8, 128


def mesh_train_parity(dev, tag: str, arch: str, mesh: tuple) -> dict:
    """A float32 train cell over ``mesh`` (rows, cols) of the card against
    a one-position cell on the card, both from ``init_train``'s seeded
    weights on the card: ``MESH_F32_LAYERS`` layers at full width,
    ``MESH_F32_STEPS`` steps of the bigram pipeline at ``MESH_F32_B`` x
    ``MESH_F32_S`` in the config's microbatches (a MoE at capacity factor
    E, dropless: a position's capacity comes from its own tokens).  The
    losses and grad norms must agree within 1e-5 relative, and so must
    the params after the steps, leaf by leaf as ||a - b|| / ||b|| (an
    entry whose float32 gradient is rounding noise may move by the
    learning rate either way, so the largest entry's error is printed,
    not held).  Every backward runs on the CUDA-core route: each cell's
    flash_attention_bwd, gmm_bwd and ssd_bwd launches are logged (the
    mesh cell's returned), none on the tensor cores."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import DeviceGrid, Supervisor, single_device_grid
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.moe_gmm.ops import gmm_bwd
    from repro_torch.kernels.ssd_scan.ops import ssd_bwd
    from repro_torch.models.param import gather_tree, jax_leaves
    from repro_torch.train.optimizer import OptConfig
    cfg = get_arch(arch).replace(num_layers=MESH_F32_LAYERS, dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    pipe = SyntheticPipeline(DataConfig(kind="bigram"), cfg, ShapeConfig(
        "t", "train", MESH_F32_S, MESH_F32_B), device=dev)
    batches = [pipe.get_batch(i) for i in range(MESH_F32_STEPS)]
    rows, cols = mesh
    out = {}
    counters = (flash_attention, flash_attention_bwd, gmm_bwd, ssd_bwd)
    for name, grid in (("one", single_device_grid(dev)),
                       ("mesh", DeviceGrid.from_flat([dev] * rows * cols, 1,
                                                     rows, cols))):
        sup = Supervisor(grid)
        cell = sup.create_cell("p", cfg, "train", ncols=cols if name ==
                               "mesh" else 1, opt_cfg=OptConfig())
        cell.init_train(torch.Generator(device=dev).manual_seed(0))
        reset_counters(counters)
        mets = [cell.train_steps(batches.__getitem__, 1)
                for _ in range(MESH_F32_STEPS)]
        launches = read_counters(counters)
        tc = sum(launches.get(k, 0) for k in (
            "flash_attention_tc", "flash_attention_bwd_tc", "gmm_bwd_tc",
            "ssd_bwd_tc"))
        if tc or not any(launches.get(k, 0) for k in (
                "flash_attention_bwd", "gmm_bwd", "ssd_bwd")):
            raise AssertionError(f"[{tag}] float32 {name}: backward "
                                 f"launches {launches}")
        bwd = {k: launches.get(k, 0) for k in (
            "flash_attention_bwd", "gmm_bwd", "ssd_bwd")}
        log(f"[{tag}] float32 {name}: flash forward launches "
            f"{launches['flash_attention']}, backward launches {bwd}, none "
            "on the tensor cores")
        if name == "mesh":
            out["f32_bwd_launches"] = bwd
        out[name] = ([(m["loss_step"], m["grad_norm"]) for m in mets],
                     [t.float().cpu() for t in
                      jax_leaves(gather_tree(cell.state.params))])
        sup.destroy_cell("p")
        del cell, sup
        gc.collect()
        torch.cuda.empty_cache()
    bwd_launches = out.pop("f32_bwd_launches")
    (m1, p1), (m2, p2) = out["one"], out["mesh"]
    metric_rel = max(abs(a - b) / abs(b) for x, y in zip(m2, m1)
                     for a, b in zip(x, y))
    norm_rel = max(float(torch.linalg.vector_norm(a - b)
                         / torch.linalg.vector_norm(b).clamp(min=1e-30))
                   for a, b in zip(p2, p1))
    entry_rel = max(float((a - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in zip(p2, p1))
    log(f"[{tag}] float32 {arch} ({MESH_F32_LAYERS} layers, full width) "
        f"over {rows} x {cols} positions against one position on the card, "
        f"{MESH_F32_STEPS} steps at {MESH_F32_B} x {MESH_F32_S}: (loss, grad "
        f"norm) {m2} vs {m1}, worst rel {metric_rel:.2e}; params after the "
        f"steps worst ||a - b|| / ||b|| {norm_rel:.2e} (tol 1e-5), worst "
        f"largest-entry error {entry_rel:.2e}")
    if metric_rel > 1e-5 or norm_rel > 1e-5:
        raise AssertionError(f"[{tag}] float32 parity: metrics rel "
                             f"{metric_rel}, params rel {norm_rel}")
    return {"f32_bwd_launches": bwd_launches,
            "f32_metric_rel": metric_rel, "f32_param_rel": norm_rel,
            "f32_entry_rel": entry_rel}


def phase_train_mesh(dev, name_limit: str, tag: str, arch: str, mesh: tuple,
                     ref: dict, layers: int, steps: int) -> dict:
    """Phases 18a-18d: the float32 parity (``mesh_train_parity``), then
    ``arch`` trained at full width through a train cell over ``mesh``
    (``phase_train``; its launches exactly P times ``train_launches``,
    its first xent beside the one-position phase ``ref``'s)."""
    t0 = time.monotonic()
    parity = mesh_train_parity(dev, tag, arch, mesh)
    log(f"[{tag}] the float32 parity took {time.monotonic() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    run = phase_train(dev, name_limit, arch, tag, steps, layers=layers,
                      mesh=mesh, ref=ref, collectives=tag == MESH_PROFILED)
    run.update(parity)
    return run


def kernel_split(fn, calls: int = 3) -> str:
    """The kernels of ``calls`` traced calls of ``fn``, each with its mean
    device time a launch and its launches: a trace of a single call has
    come back without its kernels late in a long run."""
    _, split, _ = profile_step(lambda: [fn() for _ in range(calls)],
                               cpu=False)
    return ", ".join(f"{k_[:50]} {t / n * 1e3:.4f} ms x {n}"
                     for k_, t, n in split)


def profile_step(fn, collectives: bool = False, cpu: bool = True):
    """(device busy seconds, [(kernel, seconds, calls)] of every kernel,
    the largest device time first, {collective op: device seconds}) of
    one call of ``fn`` under torch.profiler; busy is the union of the
    kernels' intervals (``launch.profile_decode`` reads it the same way).
    ``collectives`` (with ``cpu``): each collective runs under a profiler
    range (``collectives.ANNOTATE``) and the device time of the kernels
    launched under each op's ranges is summed.  ``cpu`` False: the
    device's activity alone is traced."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_decode import _busy_us
    from repro_torch.sharding import collectives as C
    torch.cuda.synchronize()
    C.ANNOTATE = collectives
    try:
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if cpu else [])) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        C.ANNOTATE = False
    ranges = {}
    if collectives:
        for a in prof.key_averages():
            if a.key.startswith("collective::"):
                ranges[a.key[12:]] = (ranges.get(a.key[12:], 0.0)
                                      + a.device_time_total * 1e-6)
    events = prof.events()
    by_name = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + (e.time_range.end - e.time_range.start)
                               * 1e-6, n + 1)
    rows = sorted(((k[:60], t, n) for k, (t, n) in by_name.items()),
                  key=lambda r: -r[1])
    return _busy_us(events) * 1e-6, rows, ranges


def phase_train_recovery(dev, name_limit: str) -> dict:
    """Phase 13b, at smoke size (a full-width TrainState is 48 GB on
    disk): a train cell trains 4 steps with ``save(blocking=False)`` after
    step 2; ``fail_column`` kills it and ``recover_cell(ckpt_dir=)``
    restores it on another column of the card; steps 3-4 must give an
    uninterrupted run's xent bit for bit.  Then float32 smoke train steps
    on the card must give the CPU's losses within 1e-5 relative (on the
    same weights, drawn on the CPU: a CUDA generator draws other
    numbers), for qwen3-4b, through the SSD scan's backward kernel
    mamba2-2.7b and zamba2-2.7b, through the grouped GEMM's backward
    deepseek-moe-16b, and nemotron-4-340b at its own heads (G 12 at head
    dim 192) with its bf16 first moment, all their backward launches on
    the CUDA-core route."""
    import shutil

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import ShapeConfig, smoke_config
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import DeviceGrid, Supervisor
    from repro_torch.core.resharding import reshard_tree
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.moe_gmm.ops import gmm_bwd
    from repro_torch.kernels.ssd_scan.ops import ssd_bwd
    from repro_torch.models.param import DTYPES, jax_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_train_state
    d = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=100)

    def run(cfg, device, kill: bool, cpu_weights: bool = False,
            opt_cfg=opt):
        sup = Supervisor(DeviceGrid.from_flat([torch.device(device)], 1, 1,
                                              2, allow_reuse=True))
        cell = sup.create_cell("t", cfg, "train", ncols=1, opt_cfg=opt_cfg)
        cell.init_train(torch.Generator(device=device).manual_seed(0))
        if cpu_weights:
            cell.state, _ = reshard_tree(init_train_state(
                cell.model, torch.Generator().manual_seed(0), opt_cfg),
                cell.device)
        pipe = SyntheticPipeline(DataConfig(kind="bigram"), cfg,
                                 ShapeConfig("t", "train", 64, 8),
                                 device=device)
        xent = []
        for i in range(4):
            if kill and i == 2:
                fut.result(timeout=120)
                sup.fail_column(0, cell.zone.c0)
                cell = sup.recover_cell("t", ckpt_dir=d)
                if cell.step != 2 or cell.state.params["embed"].device.type \
                        != torch.device(device).type:
                    raise AssertionError(f"[13b] recovered at step "
                                         f"{cell.step}")
            m = cell.train_steps(pipe.get_batch, 1)
            xent.append(m["xent"])
            if kill and i == 1:
                fut = ckpt.save(d, cell.step, cell.state, blocking=False)
        m_dtypes = {m.dtype for m in jax_leaves(cell.state.opt.m)}
        if m_dtypes != {DTYPES[opt_cfg.m_dtype]}:
            raise AssertionError(f"[13b] first moments {m_dtypes}, not "
                                 f"{opt_cfg.m_dtype}")
        return xent, [e["op"] for e in sup.events]

    fwd = {}     # each float32 card run's flash forward launches

    def card_run(arch, cfg, **kw):
        """``run`` of a float32 ``cfg`` on the card, its flash forward
        launches counted into ``fwd``, none on the tensor cores."""
        n0, tc0 = flash_attention.launches, flash_attention.launches_tc
        out = run(cfg, dev, kill=False, cpu_weights=True, **kw)
        fwd[arch] = flash_attention.launches - n0
        expect(f"[13b] {arch} float32 flash forward launches on the tensor "
               "cores", flash_attention.launches_tc - tc0, 0)
        return out

    cfg = smoke_config(get_arch("qwen3-4b"))
    want, _ = run(cfg, dev, kill=False)
    got, ops = run(cfg, dev, kill=True)
    if got != want:
        raise AssertionError(f"[13b] xent after recovery {got} != "
                             f"uninterrupted {want}")
    log(f"[13b] smoke qwen3-4b bf16 on the card: killed after step 2 "
        f"(checkpoint saved asynchronously), recovered from it; xent "
        f"{got} equal the uninterrupted run's bit for bit; events {ops}")
    f32 = cfg.replace(dtype="float32")
    reset_counters((flash_attention_bwd,))
    card_x, _ = card_run("qwen3-4b", f32)
    launches = read_counters((flash_attention_bwd,))
    if launches["flash_attention_bwd"] == 0:
        raise AssertionError("[13b] the float32 steps launched no backward")
    expect("[13b] float32 backward launches on the tensor cores",
           launches["flash_attention_bwd_tc"], 0)
    cpu_x, _ = run(f32, "cpu", kill=False, cpu_weights=True)
    worst = max(abs(a - b) / abs(b) for a, b in zip(card_x, cpu_x))
    if worst > 1e-5:
        raise AssertionError(f"[13b] float32 card {card_x} vs CPU {cpu_x}: "
                             f"rel {worst}")
    log(f"[13b] float32 smoke train steps: card xent {card_x}, CPU "
        f"{cpu_x}, worst rel {worst:.2e} (tol 1e-5); backward launches "
        f"{launches}")
    ssm_rel, ssd_f32 = {}, {}
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        f32 = smoke_config(get_arch(arch)).replace(dtype="float32")
        reset_counters((ssd_bwd,))
        card_x, _ = card_run(arch, f32)
        n_bwd = ssd_bwd.launches
        if n_bwd == 0:
            raise AssertionError(f"[13b] {arch}: no SSD backward launch")
        expect(f"[13b] {arch} float32 SSD backward launches on the tensor "
               "cores", ssd_bwd.launches_tc, 0)
        ssd_f32[arch] = n_bwd
        cpu_x, _ = run(f32, "cpu", kill=False, cpu_weights=True)
        ssm_rel[arch] = max(abs(a - b) / abs(b) for a, b in zip(card_x,
                                                                 cpu_x))
        if ssm_rel[arch] > 1e-5:
            raise AssertionError(f"[13b] {arch} float32 card {card_x} vs "
                                 f"CPU {cpu_x}: rel {ssm_rel[arch]}")
        log(f"[13b] float32 smoke {arch} train steps: card xent {card_x}, "
            f"CPU {cpu_x}, worst rel {ssm_rel[arch]:.2e} (tol 1e-5); SSD "
            f"backward launches {n_bwd}")
    f32 = smoke_config(get_arch("deepseek-moe-16b")).replace(dtype="float32")
    reset_counters((gmm_bwd,))
    card_x, _ = card_run("deepseek-moe-16b", f32)
    gmm_f32 = read_counters((gmm_bwd,))
    if gmm_f32["gmm_bwd"] == 0 or gmm_f32["gmm_bwd_dw"] == 0:
        raise AssertionError("[13b] deepseek-moe-16b: no grouped GEMM "
                             "backward launch")
    expect("[13b] deepseek-moe-16b float32 grouped GEMM backward launches "
           "on the tensor cores", gmm_f32["gmm_bwd_tc"], 0)
    expect("[13b] deepseek-moe-16b float32 grouped GEMM backward launches "
           "on wgmma", gmm_f32["gmm_bwd_wgmma"], 0)
    cpu_x, _ = run(f32, "cpu", kill=False, cpu_weights=True)
    moe_rel = max(abs(a - b) / abs(b) for a, b in zip(card_x, cpu_x))
    if moe_rel > 1e-5:
        raise AssertionError(f"[13b] deepseek-moe-16b float32 card {card_x} "
                             f"vs CPU {cpu_x}: rel {moe_rel}")
    log(f"[13b] float32 smoke deepseek-moe-16b train steps: card xent "
        f"{card_x}, CPU {cpu_x}, worst rel {moe_rel:.2e} (tol 1e-5); "
        f"grouped GEMM backward launches {gmm_f32}")
    # nemotron-4-340b at its own heads (G 12 at head dim 192) with its bf16
    # first moment: the float32 flash backward at head dim 192
    f32 = real_heads("nemotron-4-340b").replace(dtype="float32")
    opt_m = dataclasses.replace(opt, m_dtype=f32.optimizer_m_dtype)
    reset_counters((flash_attention_bwd,))
    card_x, _ = card_run("nemotron-4-340b", f32, opt_cfg=opt_m)
    nem = read_counters((flash_attention_bwd,))
    if nem["flash_attention_bwd"] == 0:
        raise AssertionError("[13b] nemotron-4-340b: no backward launch")
    expect("[13b] nemotron-4-340b float32 backward launches on the tensor "
           "cores", nem["flash_attention_bwd_tc"], 0)
    cpu_x, _ = run(f32, "cpu", kill=False, cpu_weights=True, opt_cfg=opt_m)
    nem_rel = max(abs(a - b) / abs(b) for a, b in zip(card_x, cpu_x))
    if nem_rel > 1e-5:
        raise AssertionError(f"[13b] nemotron-4-340b float32 card {card_x} "
                             f"vs CPU {cpu_x}: rel {nem_rel}")
    log(f"[13b] float32 nemotron-4-340b train steps at G 12, head dim 192, "
        f"first moment {opt_m.m_dtype}: card xent {card_x}, CPU {cpu_x}, "
        f"worst rel {nem_rel:.2e} (tol 1e-5); backward launches {nem}")
    shutil.rmtree(d, ignore_errors=True)
    log(f"[13b] float32 flash forward launches (CUDA cores, none on the "
        f"tensor cores): {fwd}")
    return {"xent": got, "f32_rel": worst, "ssm_f32_rel": ssm_rel,
            "moe_f32_rel": moe_rel, "nemotron_f32_rel": nem_rel,
            "launches": {
                "flash_attention_f32": sum(fwd.values()),
                "flash_attention_bwd_f32": launches["flash_attention_bwd"],
                "ssd_scan_bwd_f32": ssd_f32["mamba2-2.7b"],
                "ssd_scan_bwd_f32_zamba2": ssd_f32["zamba2-2.7b"],
                "gmm_bwd_f32": gmm_f32["gmm_bwd"]}}


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
    # the paged kernels over an int8 arena (one float32 scale a page and
    # layer, dequantised in the kernel): phase 19b's path, at one
    # position and over (2, 2); launches those of both of its runs
    "paged_extend_attention_int8": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:142",
        "path": "19b", "count": "paged_extend_attention"},
    "paged_decode_attention_int8": {
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:134",
        "path": "19b", "count": "paged_decode_attention"},
    "decode_attention": {
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:48",
        "path": 6},
    "gmm": {
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:25",
        "path": 7},
    # the same kernel at its prefill shape; launches: those at C != 8
    "gmm_prefill": {
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:25",
        "path": 7},
    "ssd": {
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:35",
        "path": 8},
    # the flash kernel under a key-length mask on the encdec path:
    # launches those of the encoder (Sq = Skv = the source length) and of
    # cross-attention
    "flash_attention_encoder": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
        "path": 10},
    "flash_attention_cross": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
        "path": 10},
    # the dense decode kernel over the resident cross memory
    "decode_attention_cross": {
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:48",
        "path": 10},
    # the flash kernel with its LSE at the training shape: launches those
    # of phase 13 (forward and remat recompute)
    "flash_attention_train": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
        "path": 13, "count": "flash_attention"},
    # the backward of the flash kernel (the TPU package has none: JAX
    # trains through chunked_attention's XLA gradient): the bf16
    # tensor-core route on phase 13, the float32 CUDA-core route on phase
    # 13b's float32 steps
    "flash_attention_bwd": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
        "path": 13, "count": "flash_attention_bwd_tc"},
    "flash_attention_bwd_f32": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
        "path": "13b", "count": "flash_attention_bwd_f32"},
    # the float32 routes of the forward kernels (CUDA cores, exact float32
    # products): flash with its LSE at the training shape, its launches
    # those of phase 13b's float32 train steps; the extend over a float32
    # and an int8 arena, their launches phase 4's (every case float32)
    "flash_attention_f32_train": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:36",
        "path": "13b", "count": "flash_attention_f32"},
    "paged_extend_attention_f32": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:142",
        "path": 4},
    "paged_extend_attention_f32_int8": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:142",
        "path": 4},
    # the backward of the SSD scan (the TPU package has none: JAX trains
    # through jax.grad of the plain ssd_chunked): the bf16 tensor-core
    # route at mamba2's training microbatch (phase 14) and zamba2's (phase
    # 14b), the float32 CUDA-core route on phase 13b's float32 steps
    # (mamba2's at N 128, zamba2's at N 64)
    "ssd_scan_bwd": {
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:35",
        "path": 14, "count": "ssd_bwd_tc"},
    "ssd_scan_bwd_zamba2": {
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:35",
        "path": "14b", "count": "ssd_bwd_tc"},
    "ssd_scan_bwd_f32": {
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:35",
        "path": "13b", "count": "ssd_scan_bwd_f32"},
    "ssd_scan_bwd_f32_zamba2": {
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:35",
        "path": "13b", "count": "ssd_scan_bwd_f32_zamba2"},
    # the backward of the grouped GEMM (the TPU package has none: JAX
    # trains the MoE block through einsums and XLA's gradients): dX and dW
    # of the bf16 wgmma route at deepseek-moe-16b's training shape (phase
    # 15; launches: each part's), the float32 CUDA-core route on
    # phase 13b's float32 steps (launches: calls, each with both parts)
    "gmm_bwd_dx": {
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:25",
        "path": 15, "count": "gmm_bwd_dx"},
    "gmm_bwd_dw": {
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:25",
        "path": 15, "count": "gmm_bwd_dw"},
    "gmm_bwd_f32": {
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/moe_gmm.py:25",
        "path": "13b", "count": "gmm_bwd_f32"},
}


def arch_kernels() -> dict:
    """The kernels line's rows of phases 20a-20d: the three attention
    kernels of the main path at each arch's heads (``heads_row``), timed
    in phase 3, their launches those of the arch's phase."""
    return {heads_row(base, arch): {**KERNELS[base], "path": tag,
                                     "count": base}
            for tag, arch, _ in ARCH_PHASES
            for base in ("flash_attention", "paged_extend_attention",
                         "paged_decode_attention")}


def main() -> int:
    t_all = time.monotonic()
    name_limit = phase_env()
    dev = torch.device("cuda")
    with timed(2):
        phase_build()
    kernels = {name: dict(meta)
               for name, meta in {**KERNELS, **arch_kernels()}.items()}
    log("[3] kernels against their plain versions on the card")
    with timed(3):
        check_kernels(dev, kernels)
    runs = {}
    with timed(4):
        runs[4] = phase_parity(dev)
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
    for tag, arch in ((8, "mamba2-2.7b"), (9, "zamba2-2.7b")):
        gc.collect()                # free the previous model
        torch.cuda.empty_cache()
        with timed(tag):
            runs[tag] = phase_recurrent(dev, name_limit, arch, tag)
    gc.collect()
    torch.cuda.empty_cache()
    with timed(10):
        runs[10] = phase_encdec(dev, name_limit)
    gc.collect()
    torch.cuda.empty_cache()
    with timed(11):
        runs[11] = phase_cells(dev, name_limit, runs[5])
    gc.collect()
    torch.cuda.empty_cache()
    with timed(12):
        runs[12] = phase_disagg(dev, name_limit, runs[5])
    gc.collect()
    torch.cuda.empty_cache()
    with timed(13):
        runs[13] = phase_train(dev, name_limit)
    with timed("13b"):
        runs["13b"] = phase_train_recovery(dev, name_limit)
    gc.collect()
    torch.cuda.empty_cache()
    with timed(14):
        runs[14] = phase_train(dev, name_limit, "mamba2-2.7b", "14")
    with timed("14b"):
        runs["14b"] = phase_train(dev, name_limit, "zamba2-2.7b", "14b",
                                  TRAIN_STEPS_14B)
    gc.collect()
    torch.cuda.empty_cache()
    with timed(15):
        runs[15] = phase_train(dev, name_limit, "deepseek-moe-16b", "15",
                               TRAIN_STEPS_14B, layers=MOE_TRAIN_LAYERS)
    for tag, arch, mesh, ref, layers, steps in MESH_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        with timed(tag):
            runs[tag] = phase_train_mesh(dev, name_limit, tag, arch, mesh,
                                         runs[ref], layers, steps)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed(16):
        runs[16] = phase_sharded(dev, name_limit, runs[5])
    for tag, arch, ref in SHARDED_FAMILIES:
        gc.collect()                # free the previous model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with timed(tag):
            runs[tag] = phase_sharded_family(dev, name_limit, arch, tag,
                                             runs[ref])
    for tag, arch, ref in ROW_FAMILIES:
        gc.collect()                # free the previous model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with timed(tag):
            runs[tag] = phase_sharded_family(dev, name_limit, arch, tag,
                                             runs[ref], rows=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed("19a"):
        runs["19a"] = phase_disagg(dev, name_limit, runs[5], tag="19a",
                                   ref12=runs[12])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed("19b"):
        runs["19b"] = phase_int8(dev, name_limit, runs[5], runs["17a"])
    for tag, arch, layers in ARCH_PHASES:
        gc.collect()                # free the previous model
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"[{tag}] {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            "allocated before the phase")
        with timed(tag):
            runs[tag] = phase_arch(dev, name_limit, tag, arch, layers,
                                   runs[5])
    # the phases that run a path's kernels again: 11, 12, 16, 17a and 19a
    # the main path's, 16b-16d those of paths 8-10 over two positions,
    # 17b-17e those of paths 7-10 over two rows of two positions, 18a-18d
    # those of the train paths 13-15 over a mesh
    again = {5: (11, 12, 16, "17a", "19a"), 7: ("17b",), 8: ("16b", "17c"),
             9: ("16c", "17d"), 10: ("16d", "17e"), 13: ("18a", "18b"),
             14: ("18c",), 15: ("18d",)}
    rows = []
    for name, rep in kernels.items():
        count = rep.get("count", name)
        launches = runs[rep["path"]]["launches"][count]
        launches += sum(runs[t]["launches"][count]
                        for t in again.get(rep["path"], ()))
        if launches == 0:
            raise AssertionError(f"{name}: no launch on phase {rep['path']}")
        rows.append({"name": name, "route": "cuda", "source": rep["source"],
                     "replaces": rep["replaces"],
                     "launches": launches,
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
