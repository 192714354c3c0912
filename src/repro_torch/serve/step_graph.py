"""The batcher's steps as CUDA graphs, one per batcher shape.

The port's counterpart of the JAX batcher's jitted steps
(``repro/serve/batcher.py``): XLA compiles one program per shape for the
decode step, the cold prefill, the paged extend and the snapshot
restore's dense extend, and each call launches it on donated or new
buffers.  A :class:`StepGraph` holds one ``torch.cuda.CUDAGraph`` per
key.  A key is a tuple whose first item names its kind:

* decode: ``("paged", width)``, one per power-of-two block-table width
  bucket up to the pool's ``n_logical`` (:func:`decode_keys`), or
  ``("dense", None)`` on the dense per-slot cache;
* cold prefill: ``("prefill", b_pad, s_pad)``, the batch padded to a
  power of two and the prompts to their pad bucket;
* paged extend: ``("extend", b_pad, s_pad, width)``, the width trimmed
  as decode trims it, to cover the longest prompt;
* the snapshot restore's dense extend over all slots: ``("restore",
  s_pad)``; a disaggregated prefill worker's over its b_pad scratch
  rows: ``("restore", s_pad, b_pad)``.

At 8 slots, max_len 512 and chunk 32 that is at most 6 decode, 64
prefill, 384 extend and 16 restore keys, captured as they are met.

Each key has its own static input buffers on the device (tokens,
length, pos, the trimmed block table: what its step reads, int32; an
encdec step's source features in the model dtype), one buffer per dtype;
every call copies the host's inputs into them through one pinned staging
buffer per dtype.

The policy, one for every path (a StepGraph built with ``capture=False``,
for a step over mesh positions on distinct cards, runs every call eagerly
and counts it as an eager call; a step over positions on one card is
captured as one graph like any other):

* the first call of a path (decode, prefill, extend, restore) in the
  process runs its step eagerly, and is the real step: it warms PyTorch's
  and cuBLAS's lazy state (handles, workspaces) outside any capture.  The
  kernels' own one-time setup (module loading, shared-memory attributes)
  is done when their library is bound (``kernels/_build.py``).
* every other first visit of a key captures the step, then replays it;
  every later visit replays.  A capture executes nothing, so the
  non-idempotent Mamba state updates run once.  Before each replay the
  data pointer of every tensor the graph captured (params, arena, caches,
  the checkpoint workspace, the static buffers) is checked: one that
  moved raises.  There is no eager fallback.

Every step updates its state in place (the prefill into the batcher's
scratch cache and checkpoint workspace, ``Model.prefill_ranged(
in_place=True)``), so a replay's state is the caller's own tensors; a
capture whose step returned a new state tensor raises.  A graph keeps
only its sampled tokens: the rest of its memory is scratch in the one
pool all graphs of a StepGraph share, freed by :meth:`release` or when
the StepGraph is dropped (a :meth:`drop` that leaves no graph starts a
new pool).  Each capture records the StepGraph's
``epoch``: the partition-table epoch its cell's zone was bound at
(``core/cell.py``; 0 for a batcher outside a cell).  A cell's resize
drops every graph and moves the epoch on, so the next visit of a key
captures again; ``core/guard.py`` refuses a graph whose epoch is not its
cell's.  A capture launches nothing, so it leaves the
kernels' launch counters as they were; each replay adds what the
captured step counted (``kernels/_build.py``).  At temperature above 0
the sampling generator is registered with every graph, so each replay
draws new numbers, the ones the eager step would have drawn.  A capture
that fails raises; it leaves PyTorch's CUDA generators in capture mode,
so the process draws no more random numbers on the card: it is fatal.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.models.param import tree_leaves

Key = Tuple
#: the one key of a batcher's decode step on the dense per-slot cache
DENSE_KEY: Key = ("dense", None)
#: the path each kind of key belongs to
PATH_OF = {"paged": "decode", "dense": "decode", "prefill": "prefill",
           "extend": "extend", "restore": "restore"}
PATHS = ("decode", "prefill", "extend", "restore")
#: (device, path) whose first call in this process ran eagerly
_WARMED: Set[Tuple[str, str]] = set()


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


def prefill_key(b_pad: int, s_pad: int) -> Key:
    return ("prefill", b_pad, s_pad)


def extend_key(b_pad: int, s_pad: int, n_pages: int, n_logical: int) -> Key:
    """The key of a paged extend whose longest prompt spans ``n_pages``
    pages: its block table is trimmed to the decode step's width bucket
    for that page count."""
    return ("extend", b_pad, s_pad, paged_key(n_pages, n_logical)[1])


def restore_key(s_pad: int, b_pad: Optional[int] = None) -> Key:
    """The key of a dense suffix extend over a snapshot restore: over all
    of a batcher's slots, or (``b_pad``) over the b_pad rows of a
    disaggregated prefill worker's scratch cache."""
    return ("restore", s_pad) if b_pad is None else ("restore", s_pad, b_pad)


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
            f"{what}: {moved} input tensor(s) of the captured step moved "
            "since the capture (a graph replays on the addresses it "
            "captured); the step's state must be updated in place")


def host_tensor(value) -> torch.Tensor:
    """A host input as a CPU tensor: a tensor as it is, a numpy array (the
    int32 inputs; a view, such as the trimmed block table) copied."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.array(value))


def to_device(host: Dict, device) -> Dict[str, torch.Tensor]:
    """The host inputs as new tensors on ``device``: what an eager step
    reads."""
    return {k: host_tensor(v).to(device) for k, v in host.items()}


class _Entry:
    """One key's static input buffers and, once captured, its graph."""

    def __init__(self, host: Dict, device):
        self.shapes = {k: tuple(np.shape(v)) for k, v in host.items()}
        dtypes = {k: host_tensor(v).dtype for k, v in host.items()}
        self.inputs, self._host = {}, {}
        self._copies: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for dt in dict.fromkeys(dtypes.values()):
            keys = [k for k in host if dtypes[k] == dt]
            n = sum(int(np.prod(self.shapes[k])) for k in keys)
            staging = torch.empty(n, dtype=dt, pin_memory=True)
            buffer = torch.empty(n, dtype=dt, device=device)
            at = 0
            for k in keys:
                size = int(np.prod(self.shapes[k]))
                self.inputs[k] = buffer[at:at + size].view(self.shapes[k])
                self._host[k] = staging[at:at + size].view(self.shapes[k])
                at += size
            self._copies.append((buffer, staging))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.epoch: Optional[int] = None     # the StepGraph's at capture
        self.tokens = None
        self.delta: _build.Counts = {}
        self.addresses: Tuple[int, ...] = ()

    def load(self, host: Dict):
        """Copy the host inputs into the static buffers: one copy a dtype,
        which returns once it has landed, so the staging buffers are free
        again."""
        for k, v in host.items():
            if tuple(np.shape(v)) != self.shapes[k]:
                raise ValueError(f"input {k!r} {np.shape(v)} does not fit "
                                 f"the key's {self.shapes[k]}")
            self._host[k].copy_(host_tensor(v))
        for buffer, staging in self._copies:
            buffer.copy_(staging)


class StepGraph:
    """A batcher's step graphs, one per key, in one memory pool.

    ``__call__(key, fn, state, host)`` runs one step: ``fn(state,
    inputs) -> (tokens, state)`` is the plain step over the device
    ``inputs`` (name -> tensor), ``host`` the same inputs on the host
    (int32 numpy arrays, or CPU tensors of another dtype).  :meth:`stats` counts per path the keys met, the eager calls
    (the path's first call in the process), the captures, the replays
    (every other call, those that captured included: ``eager_calls +
    replays`` is the number of calls) and the graphs dropped
    (:meth:`drop`)."""

    def __init__(self, device, generator: Optional[torch.Generator] = None,
                 capture: bool = True):
        self.device = torch.device(device)
        self.generator = generator
        # False: every call runs eagerly and counts as an eager call (a
        # step over mesh positions on distinct cards: one graph cannot
        # span them)
        self.capture = capture
        self.epoch = 0          # recorded by each capture (see above)
        self.pool = torch.cuda.graph_pool_handle()
        self._entries: Dict[Key, _Entry] = {}
        self._met: Dict[str, Set[Key]] = {p: set() for p in PATHS}
        self._counts = {p: {"eager_calls": 0, "captures": 0, "replays": 0,
                            "dropped": 0} for p in PATHS}

    def __call__(self, key: Key, fn: Callable, state, host):
        path = PATH_OF[key[0]]
        counts = self._counts[path]
        self._met[path].add(key)
        if not self.capture:
            counts["eager_calls"] += 1
            return fn(state, to_device(host, self.device))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(host, self.device)
            warm = (str(self.device), path)
            if warm not in _WARMED:
                entry.load(host)
                out = fn(state, entry.inputs)
                _WARMED.add(warm)
                counts["eager_calls"] += 1
                return out
        entry.load(host)
        if entry.graph is None:
            self._capture(entry, fn, state)
            counts["captures"] += 1
        check_unmoved(entry.addresses, (state, entry.inputs), f"key {key}")
        entry.graph.replay()
        _build.add_launch_counts(entry.delta)
        counts["replays"] += 1
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
        entry.graph, entry.tokens, entry.epoch = graph, tokens, self.epoch
        entry.delta = _build.launch_delta(before, after)
        entry.addresses = leaf_addresses((state, entry.inputs))

    def drop(self, path: str):
        """Drop the graphs of ``path`` (a buffer they write was
        reallocated, or the cell's zone changed): each key captures again
        at its next visit.  Once no graph is left, later captures go to a
        new pool: the allocator keeps a pool whose every graph is gone
        until its memory is freed, and refuses a capture into it."""
        for key in [k for k in self._entries if PATH_OF[k[0]] == path]:
            if self._entries.pop(key).graph is not None:
                self._counts[path]["dropped"] += 1
        if not self.captured():
            self.pool = torch.cuda.graph_pool_handle()

    def captured(self) -> Dict[Key, _Entry]:
        """The keys that hold a graph, with their entries (static inputs
        and the epoch of the capture)."""
        return {k: e for k, e in self._entries.items() if e.graph is not None}

    def stats(self) -> dict:
        """{path: {keys, eager_calls, captures, replays, dropped}}."""
        return {p: {"keys": len(self._met[p]), **self._counts[p]}
                for p in PATHS}

    def release(self):
        """Drop every graph and static buffer; the pool's memory returns
        to the allocator once no graph holds it."""
        self._entries.clear()
