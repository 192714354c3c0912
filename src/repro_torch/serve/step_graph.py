"""The decode step as one CUDA graph per batcher shape.

The port's counterpart of the JAX batcher's ``jax.jit(step,
donate_argnums=...)`` (``repro/serve/batcher.py``): XLA compiles one
program per shape, and each call launches it and updates the donated
buffers in place.  A :class:`StepGraph` holds one ``torch.cuda.CUDAGraph``
per key, (path, block-table width): the paged plane has one key per
power-of-two width bucket up to the pool's ``n_logical``
(:func:`decode_keys`), the dense per-slot cache one.  Each key has its
own static int32 input buffers on the device (tokens (B, 1), pos (B,) and
on the paged plane the trimmed block table (B, width)); every call copies
the host's arrays into them, through one pinned staging buffer.

For each key:

* the first call runs the step eagerly on the static buffers, and is the
  real step.  It builds and binds the kernels, sets their shared-memory
  attributes and runs their once-per-instantiation occupancy checks, so
  the capture meets none of them.  No extra warm-up step runs: the Mamba
  state and conv-state updates are not idempotent.
* the second call captures the step, then replays it; every later call
  replays.  Before each replay the data pointer of every tensor the graph
  captured (params, arena, scales, resident or cache, and the static
  buffers) is checked: one that moved raises.  There is no eager
  fallback.

The step updates its state in place (``build_serve_step``,
``build_paged_serve_step``), so a replay's state is the caller's own
tensors; a capture whose step returned a new state tensor raises.  All
graphs of one StepGraph share one memory pool, freed by :meth:`release`
or when the StepGraph is dropped.  A capture launches nothing, so it
leaves the kernels' launch counters as they were; each replay adds what
the captured step counted (``kernels/_build.py``).  At temperature above
0 the sampling generator is registered with every graph, so each replay
draws new numbers, the ones the eager step would have drawn.  A capture
that fails raises; it leaves PyTorch's CUDA generators in capture mode,
so the process draws no more random numbers on the card: it is fatal.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.models.param import tree_leaves

Key = Tuple[str, Optional[int]]
#: the one key of a batcher on the dense per-slot cache
DENSE_KEY: Key = ("dense", None)


def paged_key(n_active: int, n_logical: int) -> Key:
    """The key of a paged decode step whose deepest busy slot writes its
    ``n_active``-th logical page: the power-of-two width bucket covering
    it, capped at the pool's ``n_logical``."""
    return ("paged", min(1 << (n_active - 1).bit_length(), n_logical))


def decode_keys(n_logical: Optional[int]) -> List[Key]:
    """Every key a batcher's decode step can take: one per width bucket on
    a paged pool of ``n_logical`` logical pages a slot, the dense key when
    ``n_logical`` is None."""
    if n_logical is None:
        return [DENSE_KEY]
    return [paged_key(n, n_logical) for n in range(1, n_logical + 1)
            if n == 1 or n & (n - 1) == 0 or n == n_logical]


def leaf_addresses(tree) -> Tuple[int, ...]:
    """Data pointers of the tensor leaves of ``tree``, in flatten order."""
    return tuple(t.data_ptr() for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


def check_unmoved(captured: Tuple[int, ...], tree, what: str):
    """Raise unless ``tree``'s tensor leaves sit where ``captured`` says."""
    now = leaf_addresses(tree)
    if now != captured:
        moved = (len(now) - len(captured) if len(now) != len(captured)
                 else sum(a != b for a, b in zip(now, captured)))
        raise RuntimeError(
            f"{what}: {moved} input tensor(s) of the captured decode step "
            "moved since the capture (a graph replays on the addresses it "
            "captured); the step's state must be updated in place")


class _Entry:
    """One key's static input buffers and, once captured, its graph."""

    def __init__(self, host: Dict[str, np.ndarray], device):
        self.shapes = {k: np.shape(v) for k, v in host.items()}
        n = sum(int(np.prod(s)) for s in self.shapes.values())
        self.staging = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.buffer = torch.empty(n, dtype=torch.int32, device=device)
        self.inputs, self._host, at = {}, {}, 0
        stage = self.staging.numpy()
        for k, s in self.shapes.items():
            size = int(np.prod(s))
            self.inputs[k] = self.buffer[at:at + size].view(s)
            self._host[k] = stage[at:at + size].reshape(s)
            at += size
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tokens = None
        self.delta: _build.Counts = {}
        self.addresses: Tuple[int, ...] = ()

    def load(self, host: Dict[str, np.ndarray]):
        """Copy the host arrays into the static buffers: one copy, which
        returns once it has landed, so the staging buffer is free again."""
        for k, v in host.items():
            if np.shape(v) != self.shapes[k]:
                raise ValueError(f"input {k!r} {np.shape(v)} does not fit "
                                 f"the key's {self.shapes[k]}")
            self._host[k][...] = v
        self.buffer.copy_(self.staging)


class StepGraph:
    """A batcher's decode-step graphs, one per key, in one memory pool.

    ``__call__(key, fn, state, host)`` runs one step: ``fn(state,
    inputs) -> (tokens, state)`` is the plain step over the device
    ``inputs`` (name -> tensor), ``host`` the same inputs as int32 numpy
    arrays.  Counters: ``eager_steps`` (first calls of a key),
    ``captures`` and ``replays`` (every call after the first, the one that
    captures included); ``eager_steps + replays`` is the number of
    steps."""

    def __init__(self, device, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle()
        self._entries: Dict[Key, _Entry] = {}
        self.captures = self.replays = self.eager_steps = 0

    def __call__(self, key: Key, fn: Callable, state, host):
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(host, self.device)
            entry.load(host)
            self.eager_steps += 1
            return fn(state, entry.inputs)
        entry.load(host)
        if entry.graph is None:
            self._capture(entry, fn, state)
        check_unmoved(entry.addresses, (state, entry.inputs), f"key {key}")
        entry.graph.replay()
        _build.add_launch_counts(entry.delta)
        self.replays += 1
        return entry.tokens, state

    def _capture(self, entry: _Entry, fn: Callable, state):
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _build.launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                tokens, out = fn(state, entry.inputs)
        finally:
            after = _build.launch_counts()
            _build.set_launch_counts(before)   # nothing ran yet
        check_unmoved(leaf_addresses(state), out, "capture")
        entry.graph, entry.tokens = graph, tokens
        entry.delta = _build.launch_delta(before, after)
        entry.addresses = leaf_addresses((state, entry.inputs))
        self.captures += 1

    def stats(self) -> dict:
        return {"keys": len(self._entries), "captures": self.captures,
                "replays": self.replays, "eager_steps": self.eager_steps}

    def release(self):
        """Drop every graph and static buffer; the pool's memory returns
        to the allocator once no graph holds it."""
        self._entries.clear()
