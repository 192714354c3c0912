"""Serving programs: chunked prefill, dense extend and decode, sampling.

Prompts are padded to *chunk buckets* (multiples of the batcher's
``prefill_chunk``) and same-bucket prompts share one
``Model.prefill_ranged`` invocation, which writes into the batcher's
scratch cache (and, on a snapshot pool, its checkpoint workspace) in
place; the first output token is sampled from the same invocation.
``build_serve_step`` decodes and ``build_extend_step`` suffix-extends over
a dense per-slot cache; the paged decode and extend steps live in
``serve/kvpool.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.param import resolve_dtype
from repro_torch.sharding.sharded import Sharded
from repro_torch.serve.step_graph import prefill_key


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
    """prefill_step(params, cache, batch, generator, ckpt_out=None) ->
    (first_tokens, logits, cache) over ``Model.prefill_ranged``, in place:
    the new cache is written into ``cache``'s own tensors (the batcher's
    scratch cache), which come back as the cache.  With
    ``checkpoint_every`` (ssm / hybrid snapshot pools) the third output is
    ``(cache, ckpts)``, the recurrent-state checkpoints beside the cache,
    written into ``ckpt_out`` when given (a :class:`CheckpointWorkspace`'s
    views)."""
    def prefill_step(params, cache, batch, generator, ckpt_out=None):
        if checkpoint_every is None:
            logits, cache = model.prefill_ranged(params, batch, cache,
                                                 in_place=True)
        else:
            logits, cache, ckpts = model.prefill_ranged(
                params, batch, cache, checkpoint_every=checkpoint_every,
                in_place=True, ckpt_out=ckpt_out)
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


def prefill_inputs(prompts, srcs, *, chunk: int, max_len: int, model):
    """The host inputs of ONE prefill over same-bucket prompts, the batch
    padded to the next power of two with dummy zero-length rows: (key
    ``("prefill", b_pad, s_pad)``, {tokens (b_pad, s_pad), length (b_pad,)}
    int32, plus ``model.ranged_batch_extras`` of the rows' sources
    ``srcs`` (per-row encdec source features or None)).  Rows are
    independent under prefill attention, so the batched invocation equals
    B single-row ones."""
    b_pad = 1 << (len(prompts) - 1).bit_length()
    s_pad = bucket_len(max(len(p) for p in prompts), chunk, max_len)
    tokens = np.zeros((b_pad, s_pad), np.int32)
    lengths = np.zeros((b_pad,), np.int32)
    for i, p in enumerate(prompts):
        if len(p) and bucket_len(len(p), chunk, max_len) != s_pad:
            raise ValueError(f"prompt {i} (len {len(p)}) is not in bucket "
                             f"{s_pad}")
        tokens[i, :len(p)] = p
        lengths[i] = len(p)
    extras = model.ranged_batch_extras(
        list(srcs) + [None] * (b_pad - len(srcs)), max_len)
    return prefill_key(b_pad, s_pad), {"tokens": tokens, "length": lengths,
                                       **extras}


def run_prefill_prompts(run: Callable, prompts, *, chunk: int,
                        max_len: int, model: Model, srcs=None):
    """ONE prefill invocation over same-bucket prompts (``srcs``: their
    sources, default none): ``run(key, host)`` runs the prefill step at
    ``key`` on the host arrays of :func:`prefill_inputs` and returns the
    first tokens (b_pad,) on the device; the cache it wrote is the
    caller's scratch for that key.  Returns (the b_pad first tokens as a
    list, key)."""
    srcs = list(srcs) if srcs is not None else [None] * len(prompts)
    key, host = prefill_inputs(prompts, srcs, chunk=chunk, max_len=max_len,
                               model=model)
    return run(key, host).tolist(), key


def run_prefill_prompt(run: Callable, prompt, *, chunk: int, max_len: int,
                       model: Model, src=None):
    """:func:`run_prefill_prompts` of one prompt: (first token, key)."""
    toks, key = run_prefill_prompts(run, [prompt], chunk=chunk,
                                    max_len=max_len, model=model, srcs=[src])
    return toks[0], key


def run_prefill_group(run: Callable, reqs, *, chunk: int, max_len: int,
                      model: Model, accounting=None):
    """ONE prefill invocation over a same-bucket request group
    (:func:`run_prefill_prompts` of their prompts and sources), the
    dummy rows of its padding counted as ``prefill_dummy_rows``.
    Returns (first_tokens list, key)."""
    toks, key = run_prefill_prompts(run, [r.prompt for r in reqs],
                                    chunk=chunk, max_len=max_len,
                                    model=model, srcs=[r.src for r in reqs])
    b_pad = key[1]
    if accounting is not None and b_pad != len(reqs):
        accounting.record_counter("prefill_dummy_rows", b_pad - len(reqs))
    return toks, key


def grow_capacity(capacity: int, need: int) -> int:
    """The growth plan of a :class:`CheckpointWorkspace` holding
    ``capacity`` (row, checkpoint) pairs and asked for ``need``: unchanged
    when it suffices, else exactly ``need``.  It grows with what the
    batcher meets, never to B x max_len / page up front (43.5 GB on
    mamba2-2.7b)."""
    return max(capacity, need)


class CheckpointWorkspace:
    """Where the snapshot prefill writes its state checkpoints: one buffer
    per leaf of ``Model.checkpoint_specs``, each holding ``capacity``
    (row, checkpoint) pairs, the largest b_pad x checkpoints reserved so
    far (:meth:`pairs`: over several data rows, the rows one position
    holds of a b_pad the rules split).  ``views(b, nb)`` are contiguous views of the buffers' fronts
    shaped as the checkpoints of b rows of nb checkpoints, what
    ``Model.prefill_ranged(ckpt_out=...)`` writes into.  :meth:`reserve`
    regrows the buffers when a larger key comes (their contents and
    addresses are dropped; ``regrowths`` counts it).  Over a sharded model
    each buffer is one per position at the local shapes (a Sharded of flat
    tensors) and the views are laid out by position, as
    ``Model.init_checkpoints`` lays out checkpoints."""

    def __init__(self, model: Model, device):
        self.model, self.device = model, device
        self.capacity = self.regrowths = 0
        self._flat = None

    def _local_specs(self, b: int, nb: int):
        """The checkpoint specs of b rows as one position holds them."""
        m = self.model
        if not m.sharded:
            return m.checkpoint_specs(b, nb)
        return m.local.checkpoint_specs(m.local_batch(b), nb)

    def _alloc(self, cap: int):
        specs = self._local_specs(1, cap)

        def flat(dev):
            return [torch.empty(int(np.prod(s.shape)), device=dev,
                                dtype=resolve_dtype(s, self.model.cfg.dtype))
                    for s in specs]
        if not self.model.sharded:
            return flat(self.device)
        mesh = self.model.ctx.mesh
        per = [flat(d) for d in mesh.positions]
        return [Sharded(list(bufs), mesh) for bufs in zip(*per)]

    def pairs(self, b: int, nb: int) -> int:
        """The (row, checkpoint) pairs a position holds of ``b`` rows of
        ``nb`` checkpoints."""
        m = self.model
        return (m.local_batch(b) if m.sharded else b) * nb

    def reserve(self, pairs: int) -> bool:
        """Hold at least ``pairs`` (row, checkpoint) pairs; True when the
        buffers were (re)allocated."""
        cap = grow_capacity(self.capacity, pairs)
        if cap == self.capacity:
            return False
        self.regrowths += self._flat is not None
        self._flat = None                   # free the old buffers first
        self._flat = self._alloc(cap)
        self.capacity = cap
        return True

    def rebind(self, model: Model):
        """Hold the same capacity in ``model``'s layout (after a resize
        across meshes); the contents are scratch and go, the old buffers
        first.  Not a regrowth."""
        self.model = model
        if self._flat is not None:
            self._flat = None
            self._flat = self._alloc(self.capacity)

    def views(self, b: int, nb: int):
        """The checkpoints of ``b`` rows of ``nb`` checkpoints, as views
        into the buffers (``reserve(pairs(b, nb))`` first)."""
        if self.pairs(b, nb) > self.capacity:
            raise ValueError(f"{b} x {nb} checkpoints exceed the workspace's "
                             f"{self.capacity}")
        specs = self._local_specs(b, nb)
        m = self.model
        if not m.sharded:
            return type(specs)(*(f[:int(np.prod(s.shape))].view(s.shape)
                                 for f, s in zip(self._flat, specs)))
        trees = [type(specs)(*(f.shards[r][:int(np.prod(s.shape))]
                               .view(s.shape)
                               for f, s in zip(self._flat, specs)))
                 for r in range(m.ctx.mesh.size)]
        return m.zip_local(trees, m.checkpoint_specs(b, nb), b)
