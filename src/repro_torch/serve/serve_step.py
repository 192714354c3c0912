"""Serving programs: chunked prefill, dense extend and decode, sampling.

Prompts are padded to *chunk buckets* (multiples of the batcher's
``prefill_chunk``) and same-bucket prompts share one
``Model.prefill_ranged`` invocation; the first output token is sampled
from the same invocation.  ``build_serve_step`` decodes and
``build_extend_step`` suffix-extends over a dense per-slot cache; the
paged decode and extend steps live in ``serve/kvpool.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.model import Model


def sample_tokens(logits, generator: Optional[torch.Generator],
                  temperature: float = 0.0):
    """logits (B, V) -> token ids (B,).  Temperature 0 is greedy; above 0
    draws from ``generator`` what ``torch.multinomial(probs, 1)`` draws
    (the argmax of probs over exponential noise, its own method for one
    sample), without its checks of ``probs``, which read device values
    back to the host and so cannot run inside a CUDA graph."""
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / noise).argmax(dim=-1).to(torch.int32)


def bucket_len(prompt_len: int, chunk: int, max_len: int) -> int:
    """Pad a prompt length up to the next chunk multiple, capped at the
    cache length (the cap binds last)."""
    b = -(-prompt_len // chunk) * chunk
    return min(max(b, chunk), max_len)


def supports_chunked_prefill(model: Model, max_len: int) -> bool:
    """Is ``Model.prefill_ranged`` exact for this model at ``max_len``?
    Every ported family's is (KV pad slots masked, recurrent pad steps
    kept out of the scan); only a rolling window shorter than the cache
    keeps prompts token at a time."""
    cfg = model.cfg
    return model.chunked_prefill_exact and (
        cfg.sliding_window is None or cfg.sliding_window >= max_len)


def build_prefill_step(model: Model, temperature: float = 0.0,
                       checkpoint_every: Optional[int] = None) -> Callable:
    """prefill_step(params, cache, batch, generator) -> (first_tokens,
    logits, cache) over ``Model.prefill_ranged``.  With
    ``checkpoint_every`` (ssm / hybrid snapshot pools) the third output is
    ``(cache, ckpts)``, the recurrent-state checkpoints beside the cache;
    the batching helpers pass it through untouched."""
    def prefill_step(params, cache, batch, generator):
        if checkpoint_every is None:
            logits, cache = model.prefill_ranged(params, batch, cache)
        else:
            logits, cache, ckpts = model.prefill_ranged(
                params, batch, cache, checkpoint_every=checkpoint_every)
            cache = (cache, ckpts)
        return sample_tokens(logits, generator, temperature), logits, cache
    return prefill_step


def build_extend_step(model: Model, temperature: float = 0.0) -> Callable:
    """extend_step(params, cache, batch, generator) -> (first_tokens,
    logits, cache): the suffix-only sibling of ``prefill_step`` over a
    dense per-slot cache whose rows already hold each request's restored
    prefix.  ``batch`` = {tokens (B, S_ext), pos (B,) prefix offsets,
    length (B,) suffix lengths}; the cache is updated in place."""
    def extend_step(params, cache, batch, generator):
        logits, cache = model.prefill_extend(params, batch, cache)
        return sample_tokens(logits, generator, temperature), logits, cache
    return extend_step


def build_serve_step(model: Model, temperature: float = 0.0) -> Callable:
    """serve_step(params, cache, batch, generator) -> (next_tokens, logits,
    cache): one decode step over a dense per-slot cache.  ``batch`` =
    {tokens (B, 1), pos (B,)}.  The step updates ``cache`` in place and
    returns it, the same tensors, not copies: the decode step's CUDA graph
    (``serve/step_graph.py``) replays on the addresses it captured."""
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
