"""Serving programs: chunked prefill, dense decode and sampling.

Prompts are padded to *chunk buckets* (multiples of the batcher's
``prefill_chunk``) and same-bucket prompts share one
``Model.prefill_ranged`` invocation; the first output token is sampled
from the same invocation.  ``build_serve_step`` decodes over a dense
per-slot cache; the paged decode and extend steps live in
``serve/kvpool.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.model import Model


def sample_tokens(logits, generator: Optional[torch.Generator],
                  temperature: float = 0.0):
    """logits (B, V) -> token ids (B,).  Temperature 0 is greedy; above 0
    draws from ``generator``."""
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def bucket_len(prompt_len: int, chunk: int, max_len: int) -> int:
    """Pad a prompt length up to the next chunk multiple, capped at the
    cache length (the cap binds last)."""
    b = -(-prompt_len // chunk) * chunk
    return min(max(b, chunk), max_len)


def supports_chunked_prefill(model: Model, max_len: int) -> bool:
    """Is ``Model.prefill_ranged`` exact for this model at ``max_len``?
    A rolling window shorter than the cache is not."""
    cfg = model.cfg
    return model.chunked_prefill_exact and (
        cfg.sliding_window is None or cfg.sliding_window >= max_len)


def build_prefill_step(model: Model, temperature: float = 0.0) -> Callable:
    """prefill_step(params, cache, batch, generator) -> (first_tokens,
    logits, cache) over ``Model.prefill_ranged``."""
    def prefill_step(params, cache, batch, generator):
        logits, cache = model.prefill_ranged(params, batch, cache)
        return sample_tokens(logits, generator, temperature), logits, cache
    return prefill_step


def build_serve_step(model: Model, temperature: float = 0.0) -> Callable:
    """serve_step(params, cache, batch, generator) -> (next_tokens, logits,
    cache): one decode step over a dense per-slot cache, which it updates
    in place.  ``batch`` = {tokens (B, 1), pos (B,)}."""
    def serve_step(params, cache, batch, generator):
        logits, cache = model.decode(params, cache, batch)
        return sample_tokens(logits, generator, temperature), logits, cache
    return serve_step


def run_prefill_prompts(step_fn: Callable, params, scratch_cache, prompts,
                        *, chunk: int, max_len: int, generator, device):
    """Bucket-pad B same-bucket prompts and run ONE ``prefill_step``.

    Zero-length rows are dummy batch padding (``length`` 0).  Rows are
    independent under prefill attention, so the batched invocation equals
    B single-row ones.  Returns (first_tokens list, B-row KV cache)."""
    B = len(prompts)
    s_pad = bucket_len(max(len(p) for p in prompts), chunk, max_len)
    tokens = np.zeros((B, s_pad), np.int32)
    lengths = np.zeros((B,), np.int32)
    for i, p in enumerate(prompts):
        if len(p) and bucket_len(len(p), chunk, max_len) != s_pad:
            raise ValueError(f"prompt {i} (len {len(p)}) is not in bucket "
                             f"{s_pad}")
        tokens[i, :len(p)] = p
        lengths[i] = len(p)
    batch = {"tokens": torch.from_numpy(tokens).to(device),
             "length": torch.from_numpy(lengths).to(device)}
    toks, _logits, cache = step_fn(params, scratch_cache, batch, generator)
    return toks.tolist(), cache


def run_prefill_group(step_fn: Callable, params, scratch: Callable, reqs,
                      *, chunk: int, max_len: int, generator, device,
                      accounting=None):
    """ONE prefill invocation over a same-bucket request group, the batch
    padded to the next power of two with dummy zero-length rows.
    ``scratch`` is a ``batch -> cache`` factory.  Returns (first_tokens,
    b_pad-row cache, b_pad)."""
    B = len(reqs)
    b_pad = 1 << (B - 1).bit_length()
    prompts = [r.prompt for r in reqs] + [np.zeros(0, np.int32)] * (b_pad - B)
    toks, cache = run_prefill_prompts(
        step_fn, params, scratch(b_pad), prompts, chunk=chunk,
        max_len=max_len, generator=generator, device=device)
    if accounting is not None and b_pad != B:
        accounting.record_counter("prefill_dummy_rows", b_pad - B)
    return toks, cache, b_pad
