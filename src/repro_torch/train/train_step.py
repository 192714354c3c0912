"""Train step: loss -> grads (microbatched) -> AdamW update, the port of
``repro/train/train_step.py``.

Gradient accumulation runs over microbatches into float32 accumulators,
then casts to the parameter dtype, as JAX's ``lax.scan`` does; optional
int8 error-feedback compression slots in between accumulation and the
optimizer.  One microbatch's gradients land in one buffer tree shaped as
the parameters: a layer-stacked (L, ...) parameter is handed to
``Model.loss`` as L autograd leaves (views of its layers, see
:class:`_Stacked`) whose gradients autograd adds in place into the views
of the buffer's layers, so no per-layer gradient is ever scattered into
a zero tensor of the whole stack.  The parameters and optimizer state
are updated in place (``adamw_update``).

Over a mesh (a model built over a sharded ctx) the state is a tree of
:class:`~repro_torch.sharding.sharded.Sharded` leaves laid out by
:func:`train_state_pspecs`, and each shard is an autograd leaf of its
own, with its own ``.grad`` (the layer views built per position).  The
loss is the same on every position; it is read, and the backward run,
at position 0 alone, and the collectives' backwards (their duals) carry
its cotangent to every position's shards.  Each leaf's gradient is then
the ``psum`` of its copies over the axes its layout does not split
(float32 in position order, rounded once, so every copy holds the same
bits), before the microbatches' float32 accumulation, as GSPMD reduces
JAX's gradient inside each microbatch.  The batch splits into
microbatches whose rows the data axes divide (``resolve_microbatch``
with the ctx's ``dp_size``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_bwd_span
from repro_torch.models.model import Model
from repro_torch.models.param import (
    DTYPES,
    abstract_params,
    is_pspec,
    jax_leaves,
    tree_map,
)
from repro_torch.sharding.collectives import psum
from repro_torch.sharding.sharded import Sharded, first, local_shape
from repro_torch.train import grad_compress
from repro_torch.train.optimizer import (
    AdamState,
    OptConfig,
    adam_state_pspecs,
    adamw_update,
    copy_axes,
    init_adam_state,
)

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    ef: Optional[Any] = None      # error-feedback buffers (grad compression)


def init_train_state(model: Model, generator: torch.Generator,
                     opt_cfg: OptConfig, *, compress: bool = False,
                     device=None) -> TrainState:
    """Parameters from ``model.init(generator)`` on ``device`` (default:
    the generator's), zero moments and, with ``compress``, zero bfloat16
    error-feedback buffers."""
    params = model.init(generator,
                        device=generator.device if device is None else device)
    return TrainState(
        params=params,
        opt=init_adam_state(params, opt_cfg),
        ef=grad_compress.init_ef_state(params) if compress else None,
    )


def train_state_pspecs(model: Model, *, compress: bool = False
                       ) -> TrainState:
    """The layout of a TrainState (JAX's ``train_state_pspecs``): params
    by the model's rules, m and v as their parameters, ``step``
    replicated, error-feedback buffers as the parameters."""
    pp = model.params_pspecs()
    return TrainState(params=pp, opt=adam_state_pspecs(pp),
                      ef=pp if compress else None)


def abstract_train_state(model: Model, opt_cfg: OptConfig, *,
                         compress: bool = False) -> TrainState:
    """A TrainState of ``meta`` tensors of the logical shapes and dtypes
    (JAX's ``abstract_train_state``)."""
    params = abstract_params(model.param_specs(), model.cfg.dtype)

    def like(dtype):
        return tree_map(lambda p: torch.empty_like(p, dtype=DTYPES[dtype]),
                        params)
    return TrainState(
        params=params,
        opt=AdamState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=like(opt_cfg.m_dtype), v=like(opt_cfg.v_dtype)),
        ef=like("bfloat16") if compress else None)


def _split_microbatches(batch, n: int) -> List[Any]:
    """(B, ...) leaves -> n batches of (B/n, ...) leaves, in order."""
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape(n, b // n, *x.shape[1:])
    parts = tree_map(split, batch)
    return [tree_map(lambda x, i=i: x[i], parts) for i in range(n)]


def resolve_microbatch(want: int, global_batch: int, dp: int) -> int:
    """Largest n <= want with n | B and dp | (B/n) (shardable microbatches)."""
    for n in range(min(want, max(global_batch // max(dp, 1), 1)), 0, -1):
        if global_batch % n == 0 and (global_batch // n) % max(dp, 1) == 0:
            return n
    return 1


class _Stacked:
    """A layer-stacked parameter as ``Model.loss`` slices it: item i is
    an autograd leaf viewing layer i (or, stacked twice, a ``_Stacked``
    of it), its ``.grad`` set to the view of layer i of ``grad``, so that
    autograd accumulates into the buffer in place."""

    def __init__(self, param, grad, depth: int):
        self.shape = param.shape
        self.parts = [_grad_leaf(param[i], grad[i], depth - 1)
                      for i in range(param.shape[0])]

    def __getitem__(self, i):
        return self.parts[i]


def _grad_leaf(param, grad, depth: int):
    """``param`` as the autograd leaf (a Sharded: one leaf per position)
    whose ``.grad`` is ``grad``; a ``_Stacked`` of them for ``depth``
    leading layer dims."""
    if depth:
        return _Stacked(param, grad, depth)
    if isinstance(param, Sharded):
        return Sharded([_grad_leaf(p, g, 0) for p, g in
                        zip(param.shards, grad.shards)], param.mesh,
                       param.spec)
    leaf = param.detach().requires_grad_()
    leaf.grad = grad
    return leaf


@torch.no_grad()
def reduce_copies(grads):
    """Each Sharded gradient leaf made the sum of its copies over the axes
    its layout does not split, in place: every copy then holds the
    gradient of the logical parameter, bit for bit the same."""
    for g in jax_leaves(grads):
        if isinstance(g, Sharded):
            total = psum(g, copy_axes(g))
            if total is not g:
                for dst, src in zip(g.shards, total.shards):
                    dst.copy_(src)


def _layer_depth(spec) -> int:
    """Leading "layers" axes of a parameter's spec."""
    n = 0
    while n < len(spec.logical) and spec.logical[n] == "layers":
        n += 1
    return n


def build_train_step(
    model: Model, opt_cfg: OptConfig, *, compress: bool = False
) -> Callable[[TrainState, Any], Tuple[TrainState, dict]]:
    """Returns train_step(state, batch) -> (state, metrics): JAX's
    metrics (loss, xent, aux: the microbatches' means; grad_norm, lr;
    loss_step), float32 0-d tensors on the params' device.  The state's
    tensors are updated in place and come back in the returned state."""
    specs = model.param_specs()

    def accumulate(params, mb, gbuf):
        """Add one microbatch's gradients into ``gbuf``; (loss, metrics),
        read at position 0 over a mesh."""
        leaves = tree_map(lambda p, g, s: _grad_leaf(p, g, _layer_depth(s)),
                          params, gbuf, specs)
        loss, metrics = model.loss(leaves, mb)
        # over a mesh the backward runs on this thread: a layer's
        # recompute spans every position, and positions on distinct
        # cards would otherwise unpack its saved tensors from their
        # cards' autograd threads at once
        with torch.autograd.set_multithreading_enabled(not model.sharded):
            first(loss).backward()
        reduce_copies(gbuf)
        return first(loss).detach(), {k: first(v).detach()
                                      for k, v in metrics.items()}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        params = state.params
        global_batch = jax_leaves(batch)[0].shape[0]
        n_micro = resolve_microbatch(max(model.cfg.microbatch, 1),
                                     global_batch, model._ctx().dp_size())
        grads = tree_map(torch.zeros_like, params)
        if n_micro == 1:
            loss, metrics = accumulate(params, batch, grads)
        else:
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
            losses, metricses = [], []
            for i, mb in enumerate(_split_microbatches(batch, n_micro)):
                if i:
                    for g in jax_leaves(grads):
                        g.zero_()
                l, m = accumulate(params, mb, grads)
                losses.append(l)
                metricses.append(m)
                for a, g in zip(jax_leaves(acc), jax_leaves(grads)):
                    a.add_(g.to(F32) / n_micro)
            # the float32 sums cast to the params' dtype, leaf by leaf
            for g, a in zip(jax_leaves(grads), jax_leaves(acc)):
                g.copy_(a)
                a.set_()
            del acc
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}

        ef = state.ef
        if compress:
            grads, ef = grad_compress.apply_ef_compression(grads, ef)

        new_params, new_opt, opt_metrics = adamw_update(params, grads,
                                                        state.opt, opt_cfg)
        metrics = dict(metrics, **opt_metrics, loss_step=loss)
        return TrainState(params=new_params, opt=new_opt, ef=ef), metrics

    return train_step


def step_cost(model: Model, opt_cfg: OptConfig, batch, *,
              compress: bool = False) -> dict:
    """What one train step over ``batch`` costs, reckoned from the config
    and the batch shape (the cell's ``register_program`` figures):

    * ``flops``: 6 N T for the N parameters a token meets
      (:func:`active_params`: a MoE layer's routed experts count top_k of
      num_experts) over the T tokens (forward and backward), plus the
      attention products: causal self-attention 6 B
      S^2 Hq Dh a layer (half of 12), bidirectional encoder attention and
      cross-attention 12 B Sq Skv Hq Dh a layer; and the SSD scan's
      (``ssd_step_flops``).
    * ``bytes``: the step's state traffic: each microbatch reads the
      params three times (forward, remat recompute, backward) and writes
      its gradients, the float32 accumulation (more than one microbatch)
      reads and writes its accumulators once a microbatch and casts them
      back, error-feedback compression reads and writes its buffers and
      the gradients, and AdamW reads params, gradients, m and v and writes
      params, m and v.
    * ``arg_bytes``: the train state and the batch.

    Over a mesh every figure is one position's, as JAX's
    ``cost_analysis`` is per device: the FLOPs are the step's over the
    positions (each runs the same program on its part), the state its
    shards' (the parameters it holds, :func:`local_params`) and the batch
    its rows'."""
    cfg = model.cfg
    leaves = jax_leaves(batch)
    B, S = batch["tokens"].shape
    N = local_params(model)
    n_pos = model.ctx.mesh.size if model.sharded else 1
    dp = model._ctx().dp_size()
    Hq, Dh = cfg.num_heads, cfg.resolved_head_dim
    flops = 6.0 * active_params(model) * B * S
    n_self = (0 if cfg.family == "ssm" else model._n_groups
              if cfg.family == "hybrid" else cfg.num_layers)
    flops += 6.0 * n_self * B * S * S * Hq * Dh + ssd_step_flops(cfg, B, S)
    if cfg.family == "encdec":
        s_src = batch["src"].shape[1]
        flops += 12.0 * B * Hq * Dh * (cfg.encoder_layers * s_src * s_src
                                       + cfg.num_layers * S * s_src)
    width = torch.tensor([], dtype=model.dtype).element_size()
    P = N * width                                    # params, and grads
    M = N * torch.tensor([], dtype=DTYPES[opt_cfg.m_dtype]).element_size()
    V = N * torch.tensor([], dtype=DTYPES[opt_cfg.v_dtype]).element_size()
    n_micro = resolve_microbatch(max(cfg.microbatch, 1), B, dp)
    nbytes = n_micro * 4 * P
    if n_micro > 1:
        A = 4 * N
        nbytes += n_micro * (2 * A + P) + A + P
    if compress:
        nbytes += 4 * P                              # ef (bf16) and grads
    nbytes += 2 * P + M + V + P + M + V
    arg = (P + M + V + (P if compress else 0)
           + sum(t.numel() * t.element_size() for t in leaves) // dp + 4)
    return {"flops": flops / n_pos, "bytes": float(nbytes),
            "arg_bytes": int(arg)}


def local_params(model: Model) -> int:
    """The parameters one position holds: every one on one device; over
    a mesh its shards' under the rules' layout (``params_pspecs``)."""
    if not model.sharded:
        return model.n_params()
    mesh = model.ctx.mesh
    counts = []
    tree_map(lambda s, ps: counts.append(
        math.prod(local_shape(mesh, ps, s.shape))), model.param_specs(),
        model.params_pspecs(), is_leaf=is_pspec)
    return sum(counts)


def active_params(model: Model) -> float:
    """The parameters one token meets: all of them, but of a MoE layer's
    routed experts only top_k of num_experts, N - R + R k / E with R =
    n_moe_layers 3 d_model d_expert E (the reckoning of JAX's
    ``benchmarks/roofline.py::model_flops``).  The state traffic still
    counts every parameter: at a training batch every expert is busy."""
    cfg = model.cfg
    n = float(model.n_params())
    m = cfg.moe
    if m is None:
        return n
    routed = ((cfg.num_layers - m.first_dense_layers) * 3 * cfg.d_model
              * m.d_expert * m.num_experts)
    return n - routed + routed * m.top_k / m.num_experts


def ssd_step_flops(cfg, B: int, S: int) -> float:
    """The SSD scan's products in one train step over B rows of S tokens
    (ssm and hybrid; 0 for the other families): each Mamba layer runs the
    forward twice (the remat recompute) and the backward, in sub-chunks
    of T = ``ssd_bwd_span(S, chunk)`` steps, with H heads of P, G groups
    and state N:

    * forward, B S (H (4 P N + (T + 1) P) + G (T + 1) N): the state update
      and the state -> output term, and the step pairs at or below each
      sub-chunk's diagonal (C B^T once a group, its product with x' a
      head);
    * backward, B S (H (8 P N + 2 (T + 1) (P + N)) + G (T + 1) N): h0^T g,
      H^T x', H B^T and the adjoint update, the pairs g . x' and their
      products with g, C and B, and C B^T once a group.

    The forward runs in float32 on CUDA cores (67 TFLOP/s on an H100, not
    the 989 of the bf16 products); the backward, for bf16 x, B and C, on
    the tensor cores in split TF32 passes, and in float32 on CUDA cores
    otherwise."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    s = cfg.ssm
    H, P, G, N = s.expand * cfg.d_model // s.head_dim, s.head_dim, \
        s.ngroups, s.d_state
    T = ssd_bwd_span(S, s.chunk)
    fwd = H * (4 * P * N + (T + 1) * P) + G * (T + 1) * N
    bwd = H * (8 * P * N + 2 * (T + 1) * (P + N)) + G * (T + 1) * N
    return float(cfg.num_layers * B * S * (2 * fwd + bwd))
