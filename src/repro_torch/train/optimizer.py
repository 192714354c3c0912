"""AdamW and its schedule, written out (the port of
``repro/train/optimizer.py``).

States are plain trees shaped as the parameters, so a
:class:`~repro_torch.core.cell.Cell` moves them as it moves its params.
The math is JAX's, float32 per leaf: global-norm clipping, bias-corrected
moments, weight decay on the matrices (``ndim >= 2``), the moments stored
in ``OptConfig.m_dtype`` / ``v_dtype``.  Unlike JAX's pure update, the
port updates the parameters and moments in place, leaf by leaf, so that
AdamW's float32 temporaries never exceed a few copies of one leaf (the
largest of qwen3-4b, its tied embedding, is 389 M values: 1.56 GB in
float32).  Plain PyTorch: JAX leaves the update to XLA, outside any
Pallas kernel.

Over a mesh the leaves are :class:`~repro_torch.sharding.sharded.Sharded`
and the state is laid out as the parameters (:func:`adam_state_pspecs`:
m and v take their parameter's PartitionSpec, ``step`` is replicated).
:func:`global_norm` is the norm of the logical gradient: each leaf's
float32 sum of squares ``psum``-ed over the axes its layout splits, a
copy of a replicated leaf counted once; AdamW then runs shard by shard
with the same clip scale, learning rate and bias corrections everywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.param import DTYPES, jax_leaves, tree_map
from repro_torch.sharding.collectives import psum
from repro_torch.sharding.rules import P
from repro_torch.sharding.sharded import Sharded, first

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # memory knobs for the big archs
    m_dtype: str = "float32"
    v_dtype: str = "float32"


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32, on the params' device
    m: Any                  # tree like params
    v: Any


def cosine_schedule(cfg: OptConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> float32 learning rate: linear warmup, then a
    cosine from ``lr`` down to ``min_lr_ratio * lr`` at ``total_steps``."""
    def sched(step):
        step = step.to(F32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
        return cfg.lr * warm * frac
    return sched


def split_axes(x: Sharded) -> tuple:
    """The mesh axes ``x``'s layout splits it over."""
    spec = x.spec if x.spec is not None else P()
    return tuple(dict.fromkeys(a for d in range(len(spec))
                               for a in spec.axes_of(d)))


def copy_axes(x: Sharded) -> tuple:
    """The mesh axes over which ``x`` is replicated: its copies."""
    split = split_axes(x)
    return tuple(a for a in x.mesh.axis_names if a not in split)


def _sum_squares(g) -> torch.Tensor:
    """A leaf's float32 sum of squares; a Sharded leaf's over its logical
    tensor (each position's part ``psum``-ed over its split axes), read
    at position 0."""
    if not isinstance(g, Sharded):
        return torch.sum(torch.square(g.to(F32)))
    part = Sharded([torch.sum(torch.square(s.to(F32))) for s in g.shards],
                   g.mesh)
    return first(psum(part, split_axes(g)))


def global_norm(tree) -> torch.Tensor:
    """float32 sqrt of the sum of squares of every leaf (of every logical
    leaf, over a mesh), on the first leaf's device (position 0's)."""
    total = None
    for g in jax_leaves(tree):
        sq = _sum_squares(g)
        total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to global norm at most ``max_norm``, its norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), tree), norm


def init_adam_state(params, cfg: OptConfig) -> AdamState:
    """Zero moments shaped (and, over a mesh, laid out) as ``params``,
    and step 0 (over a mesh, on every position)."""
    def zeros(dtype):
        return tree_map(lambda p: torch.zeros_like(p, dtype=DTYPES[dtype]),
                        params)
    leaf = jax_leaves(params)[0]
    if isinstance(leaf, Sharded):
        step = Sharded([torch.zeros((), dtype=torch.int32, device=d)
                        for d in leaf.mesh.positions], leaf.mesh, P())
    else:
        step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    return AdamState(step=step, m=zeros(cfg.m_dtype), v=zeros(cfg.v_dtype))


def adam_state_pspecs(param_pspecs) -> AdamState:
    """The layout of an AdamState: m and v take their parameter's
    PartitionSpec, ``step`` is replicated."""
    return AdamState(step=P(), m=param_pspecs, v=param_pspecs)


def _update_leaf(p, g, m, v, scale, lr, bc1, bc2, cfg: OptConfig):
    """One parameter tensor's AdamW update, in place."""
    dev = p.device
    scale, lr, bc1, bc2 = (t.to(dev) for t in (scale, lr, bc1, bc2))
    b1, b2 = cfg.beta1, cfg.beta2
    # the clipped gradient in its own dtype, as JAX rounds it
    g32 = (g.to(F32) * scale).to(g.dtype).to(F32)
    m32 = torch.mul(m.to(F32), b1).add_((1 - b1) * g32)
    v32 = torch.mul(v.to(F32), b2).add_(torch.square(g32).mul_(1 - b2))
    del g32
    m.copy_(m32)
    v.copy_(v32)
    # delta = m_hat / (sqrt(v_hat) + eps), in place over m32
    delta = m32.div_(bc1).div_(v32.div_(bc2).sqrt_().add_(cfg.eps))
    del v32
    p32 = p.to(F32)
    if p.dim() >= 2 and cfg.weight_decay:
        delta.add_(p32, alpha=cfg.weight_decay)
    p.copy_(p32.sub_(delta.mul_(lr)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamState,
                 cfg: OptConfig) -> Tuple[Any, AdamState, dict]:
    """One AdamW step, in place: ``params`` and the moments of ``state``
    are updated leaf by leaf (``grads`` is read, not written); a Sharded
    leaf shard by shard.  Returns (params, the new state, {"grad_norm",
    "lr"}), float32 0-d tensors in the metrics (position 0's)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    if isinstance(step, Sharded):
        step.spec = P()
    s0 = first(step)
    lr = cosine_schedule(cfg)(s0)
    bc1 = 1 - cfg.beta1 ** s0.to(F32)
    bc2 = 1 - cfg.beta2 ** s0.to(F32)
    for p, g, m, v in zip(jax_leaves(params), jax_leaves(grads),
                          jax_leaves(state.m), jax_leaves(state.v)):
        if isinstance(p, Sharded):
            for parts in zip(p.shards, g.shards, m.shards, v.shards):
                _update_leaf(*parts, scale, lr, bc1, bc2, cfg)
        else:
            _update_leaf(p, g, m, v, scale, lr, bc1, bc2, cfg)
    return params, AdamState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
