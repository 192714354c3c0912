"""Model assembly for the dense, vlm, moe, ssm, hybrid and encdec
families: specs, init, caches, the training loss, prefill, ranged prefill,
suffix extend, decode, the recurrent-state snapshots of the ssm and hybrid
families and the cross memory of the encdec family.

The JAX ``Model`` scans a layer function over stacked parameters; here a
plain Python loop walks the stacked ``(L, ...)`` leaves, stack by stack
(DeepSeekMoE: its leading dense layers, then the MoE layers; Zamba2: the
groups of Mamba layers, each followed by the shared attention block;
encdec: the encoder layers over the source, then the decoder layers),
each stack with its own cache node.  A paged cache
(:class:`~repro_torch.models.layers.PagedKVCache`) is not stacked per
layer: one arena per stack serves its layers, the loop rebinds the view's
``layer`` index, and attention updates the arena in place.  Prefill,
decode and extend over a dense per-slot cache (KV and Mamba state alike)
also write the stacked cache in place: ``prefill`` and ``prefill_ranged``
into a new cache, as JAX's return one, or on request
(``prefill_ranged(in_place=True)``) into the cache they were given, the
state checkpoints into a given tree (``ckpt_out``).  The encdec decoder's
cross memory is written in place too, by ``encode_cross_into`` alone:
inside a prefill, a suffix extend given the rows' sources, and the
token-at-a-time admission (into the slot's rows).

Built with a sharded ``ctx`` (a mesh of more than one position,
``build_model(cfg, ctx)``), every family runs over the mesh: parameters
and caches are trees of :class:`~repro_torch.sharding.sharded.Sharded`
leaves (``shard_tree`` lays out a full tree by
:meth:`Model.params_pspecs`), each layer runs tensor- and
expert-parallel (``layers.attention_sharded``, ``moe.moe_block_sharded``,
``mamba2.mamba_block(ctx)``, the encdec layers' ``ctx``), the embedding
and the logits are vocab-parallel, and the logits come back gathered,
one tensor.  The batch splits over the data axes as the rules split it
(a batch they do not divide runs whole on every data row).
A serving cache (:meth:`init_cache` without ``pspecs``: the batcher's
scratch caches, the pool's arena, the resident rows) is laid out by
position, as each position's layers read it: KV and cross memory by
heads, the Mamba state as conv [x_r | B | C] and ssm by SSD heads
(``sharded.zip_positions``), and so are the state checkpoints
(:meth:`init_checkpoints`), each split over the data axes by its batch
dim; a snapshot sliced from them has one row, whole on every data row
(:meth:`slice_checkpoint` gathers it from the data row that holds it,
:meth:`restore_state_row` writes it where its slot lies); a cache
laid out by :meth:`cache_pspecs` (its sequence dim over ``model``)
decodes through the sequence-sharded paths.  Without a ctx, or over one
position, the model is the one-device model it always was.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models import zamba2 as zmb
from repro_torch.models.cache_utils import (
    init_resident,
    kv_cache_nodes,
    mask_pad_slots_,
)
from repro_torch.models.layers import (
    NEG_INF,
    KVSlice,
    PagedKVCache,
    batch_axes,
    batch_split,
    embed_spec,
    kv_slice_specs,
    local_attn_cfg,
    logits_fn,
    norm_spec,
    out_spec,
    pad_vocab,
    rms_norm,
)
from repro_torch.models.mamba2 import MambaState, local_ssm_cfg, mamba_dims
from repro_torch.models.param import (
    DTYPES,
    PSpec,
    abstract_params,
    count_params,
    init_params,
    resolve_dtype,
    shard_tree,
    tree_leaves,
    tree_map,
    tree_map_pspec,
)
from repro_torch.sharding.collectives import (
    all_gather,
    axis_index,
    pmax,
    psum,
    relayout,
)
from repro_torch.sharding.rules import P, ShardCtx, single_device_ctx
from repro_torch.sharding.sharded import (
    Sharded,
    first,
    move_rows,
    take_rows,
    zip_positions,
)

F32 = torch.float32


def stack_specs(specs, n: int):
    """Stack per-layer PSpecs along a leading 'layers' dim."""
    def bump(s: PSpec) -> PSpec:
        init = s.init
        if init[0] == "normal" and init[1] >= 0:
            init = ("normal", init[1] + 1)
        return PSpec((n,) + s.shape, ("layers",) + s.logical, init, s.dtype)
    return tree_map_pspec(bump, specs)


class Model:
    """The training and serving surface of one architecture of any
    registered family."""

    def __init__(self, cfg: ArchConfig, ctx=None):
        self.cfg = cfg
        self.ctx = ctx
        self.sharded = ctx is not None and ctx.sharded
        self.vocab_padded = pad_vocab(cfg.vocab, cfg.vocab_pad_multiple)
        self.dtype = DTYPES[cfg.dtype]
        # the ctx the layers take: a sharded one, else None; under ZeRO-3
        # (``dp_over_model``) one whose batch axes hold the model axis and
        # which splits no layer over it (every layer runs data-parallel)
        self._lctx = ctx if self.sharded else None
        if self.sharded and ctx.dp_over_model:
            self._lctx = ShardCtx(mesh=ctx.mesh,
                                  batch_axes=tuple(ctx.rules()["batch"]),
                                  model_axis=None, fsdp=ctx.fsdp)
        if self.sharded:
            # each position's shapes: its heads and its Mamba inner width
            # under TP
            lc = self._lctx
            self.local = Model(local_ssm_cfg(local_attn_cfg(cfg, lc), lc))

    # -- parameters ------------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        specs: Dict[str, Any] = {
            "embed": embed_spec(self.vocab_padded, d),
            "final_norm": norm_spec(d),
        }
        if not cfg.tie_embeddings:
            specs["out"] = out_spec(d, self.vocab_padded)
        if cfg.family == "ssm":
            specs["mamba_layers"] = stack_specs(zmb.mamba_layer_specs(cfg),
                                                cfg.num_layers)
            return specs
        if cfg.family == "hybrid":
            inner = stack_specs(zmb.mamba_layer_specs(cfg),
                                cfg.hybrid_attn_every)
            specs["groups"] = stack_specs(inner, self._n_groups)
            specs["shared"] = zmb.shared_block_specs(cfg)
            return specs
        if cfg.family == "encdec":
            specs["src_proj"] = PSpec((d, d), ("embed", None), ("normal", 0))
            specs["enc_layers"] = stack_specs(
                encdec_mod.enc_layer_specs(cfg), cfg.encoder_layers)
            specs["enc_norm"] = norm_spec(d)
            specs["dec_layers"] = stack_specs(
                encdec_mod.dec_layer_specs(cfg), cfg.num_layers)
            return specs
        if cfg.family != "moe":
            specs["layers"] = stack_specs(tfm.dense_layer_specs(cfg),
                                          cfg.num_layers)
            return specs
        fd = cfg.moe.first_dense_layers
        if fd:
            specs["dense_layers"] = stack_specs(
                tfm.dense_layer_specs(cfg, d_ff=cfg.moe.dense_d_ff), fd)
        specs["moe_layers"] = stack_specs(tfm.moe_layer_specs(cfg, self.ctx),
                                          cfg.num_layers - fd)
        return specs

    @property
    def _n_groups(self) -> int:
        """Hybrid: the number of (Mamba layers, shared block) groups."""
        return self.cfg.num_layers // self.cfg.hybrid_attn_every

    def _stacks(self):
        """(params / cache key, layer function, depth) of each attention
        layer stack, in the order the layers run."""
        cfg = self.cfg
        if cfg.family != "moe":
            return [("layers", tfm.dense_layer, cfg.num_layers)]
        fd = cfg.moe.first_dense_layers
        out = [("dense_layers", tfm.dense_layer, fd)] if fd else []
        return out + [("moe_layers", tfm.moe_layer, cfg.num_layers - fd)]

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters on ``device`` drawn from ``generator`` (a
        generator on the same device).  A sharded model draws the same
        full tree on ``device`` and lays it out over its mesh."""
        params = init_params(self.param_specs(), generator, self.cfg.dtype,
                             resolve_device(device))
        if self.sharded:
            params = shard_tree(params, self.params_pspecs(), self.ctx)
        return params

    def _ctx(self):
        return self.ctx if self.ctx is not None else single_device_ctx()

    def params_pspecs(self):
        """The rules' PartitionSpec of every parameter (JAX's
        ``Model.params_pspecs``)."""
        return self._ctx().params_pspecs(self.param_specs())

    def cache_pspecs(self, batch: int, max_len: int):
        """The rules' PartitionSpec of every cache leaf: the sequence dim
        over ``kv_seq`` (JAX's ``Model.cache_pspecs``)."""
        return self._ctx().params_pspecs(self.cache_specs(batch, max_len))

    def position_tree(self, build, global_tree, batch: int = 1):
        """A tree of Sharded leaves, position ``r``'s tree ``build(
        local_model, device_r, local_batch)``; ``global_tree`` (PSpecs or
        tensors) names the logical shapes.  A dim a position holds less of
        is split over ``model``, a ``batch`` dim over the data axes as the
        rules split ``batch`` rows: the serving layout by position."""
        n = self.local_batch(batch)
        trees = [build(self.local, d, n) for d in self.ctx.mesh.positions]
        return self.zip_local(trees, global_tree, batch)

    def local_batch(self, batch: int) -> int:
        """The rows of a ``batch``-row tensor one position holds."""
        n = batch
        for a in self.ctx.pspec(("batch",), (batch,)).axes_of(0):
            n //= self.ctx.axis_sizes[a]
        return n

    def zip_local(self, trees, global_tree, batch: int = 1):
        """Per-position trees (position ``r``'s of ``self.local``'s
        shapes) -> one tree of Sharded leaves laid out as
        :meth:`position_tree` lays them out."""
        b_axes = self.ctx.pspec(("batch",), (batch,)).axes_of(0)
        return zip_positions(trees, self.ctx.mesh, global_tree, b_axes)

    def abstract_params(self):
        return abstract_params(self.param_specs(), self.cfg.dtype)

    def n_params(self) -> int:
        return count_params(self.param_specs())

    # -- caches ----------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"mamba_layers": stack_specs(
                self._mamba_state_specs(batch), cfg.num_layers)}
        kv = kv_slice_specs(cfg, batch, max_len)
        if cfg.family == "encdec":
            L, s_src = cfg.num_layers, self.source_len(max_len)
            cross = PSpec((L, batch, s_src, cfg.num_kv_heads,
                           cfg.resolved_head_dim),
                          ("layers", "batch", "kv_seq", None, None),
                          ("const", 0.0))
            return {"dec_layers": encdec_mod.DecCache(
                self_kv=stack_specs(kv, L), cross_k=cross, cross_v=cross,
                # valid source frames per row; 0 (init) = no memory yet
                src_len=PSpec((L, batch), ("layers", "batch"), ("const", 0),
                              dtype="int32"))}
        if cfg.family == "hybrid":
            return {"groups": zmb.ZambaGroupCache(
                mamba=stack_specs(stack_specs(self._mamba_state_specs(batch),
                                              cfg.hybrid_attn_every),
                                  self._n_groups),
                shared=stack_specs(kv, self._n_groups))}
        return {key: stack_specs(kv, n) for key, _, n in self._stacks()}

    def _mamba_state_specs(self, batch: int) -> MambaState:
        d_inner, H, G, N, K = mamba_dims(self.cfg)
        return MambaState(
            conv=PSpec((batch, K - 1, d_inner + 2 * G * N),
                       ("batch", None, "inner"), ("const", 0.0)),
            ssm=PSpec((batch, H, self.cfg.ssm.head_dim, N),
                      ("batch", "ssm_heads", None, None), ("const", 0.0),
                      dtype="float32"),
        )

    def checkpoint_specs(self, batch: int, n_ckpt: int) -> MambaState:
        """PSpecs of the stacked state checkpoints ``prefill_ranged`` gives
        for ``batch`` rows and ``n_ckpt`` checkpoints a row (ssm / hybrid):
        conv (..., B, nb, K-1, C) and ssm (..., B, nb, H, P, N) float32,
        the stack dims (L,) in front for ssm, (G, E) for hybrid."""
        per = MambaState(*(
            PSpec((batch, n_ckpt) + s.shape[1:], ("batch", None) + s.logical[1:],
                  s.init, s.dtype)
            for s in self._mamba_state_specs(batch)))
        if self.cfg.family == "ssm":
            return stack_specs(per, self.cfg.num_layers)
        return stack_specs(stack_specs(per, self.cfg.hybrid_attn_every),
                           self._n_groups)

    def init_checkpoints(self, batch: int, n_ckpt: int, device="cuda"):
        """Uninitialised stacked state checkpoints of
        :meth:`checkpoint_specs` on ``device``; a sharded model's laid out
        by position, as its Mamba layers write them."""
        def empty(model, dev, b):
            return tree_map_pspec(
                lambda sp: torch.empty(
                    sp.shape, dtype=resolve_dtype(sp, self.cfg.dtype),
                    device=dev),
                model.checkpoint_specs(b, n_ckpt))
        if not self.sharded:
            return empty(self, resolve_device(device), batch)
        return self.position_tree(empty, self.checkpoint_specs(batch, n_ckpt),
                                  batch)

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   pspecs=None):
        """A cache at its init values on ``device``.  A sharded model's is
        laid out by ``pspecs`` (e.g. :meth:`cache_pspecs`), or by heads,
        as attention reads it, without them."""
        if not self.sharded:
            return init_params(self.cache_specs(batch, max_len), None,
                               self.cfg.dtype, resolve_device(device))
        if pspecs is not None:
            full = init_params(self.cache_specs(batch, max_len), None,
                               self.cfg.dtype, resolve_device(device))
            return shard_tree(full, pspecs, self.ctx)
        return self.position_tree(
            lambda m, d, b: m.init_cache(b, max_len, device=d),
            self.cache_specs(batch, max_len), batch)

    def source_len(self, seq_len: int) -> int:
        """Encoder source length for encdec shapes (audio capped at 4k
        frames): the frames a cache row of ``seq_len`` positions holds."""
        return int(min(seq_len, 4096) * self.cfg.source_len_ratio)

    # -- capabilities (as the JAX Model states them) ---------------------
    @property
    def chunked_prefill_exact(self) -> bool:
        """``prefill_ranged`` is exact on bucket-padded prompts: KV
        families mask pad slots; ssm and hybrid mask pad steps out of the
        SSD scan and snapshot the conv state at each row's last token;
        encdec masks each row's pad source frames by its ``src_len``."""
        return True

    @property
    def supports_paged_kv(self) -> bool:
        """Every positional cache leaf is causal KV that can live in a
        paged arena with prefix sharing (encdec: its decoder self-KV, the
        cross memory riding the dense resident remainder; pages are shared
        only between requests with byte-identical sources).  Recurrent
        state folds the whole history into one state and shares snapshots
        instead."""
        return self.cfg.family in ("dense", "vlm", "moe", "encdec")

    @property
    def supports_snapshot_state(self) -> bool:
        """The serve cache is a recurrent state that can be snapshotted at
        chunk boundaries and restored to seed a suffix-only prefill."""
        return self.cfg.family in ("ssm", "hybrid")

    @property
    def decode_state_positional(self) -> bool:
        """Every per-slot cache leaf is position-masked KV, so a reused
        slot's stale rows are invisible; recurrent state and encdec cross
        memory are not, and a token-at-a-time admit must reset them
        first."""
        return self.cfg.family in ("dense", "vlm", "moe")

    # -- forward ---------------------------------------------------------
    def _embed_tokens(self, params, tokens):
        if self.sharded:
            return self._embed_sharded(params["embed"], tokens)
        return F.embedding(tokens.long(), params["embed"]).to(self.dtype)

    def _logits(self, params, x, rows: int = 0):
        """Logits of x (B, S, D); a sharded model's x is batch-local and
        ``rows`` is the global batch B."""
        if self.sharded:
            return self._logits_sharded(params, x, rows)
        w = params["embed"].T if self.cfg.tie_embeddings else params["out"]
        return logits_fn(x, w, self.cfg.vocab)

    # -- the vocab-parallel ends of a sharded model ------------------------
    def _vocab_axis(self):
        """The axis the vocab-parallel ends split the vocab over: the
        model axis when it divides the padded vocab, else None (and
        always None under ZeRO-3, where the model axis splits the
        batch)."""
        m = self.ctx.model_axis
        if self.ctx.dp_over_model:
            return None
        return m if m and self.vocab_padded % self.ctx.model_size() == 0 \
            else None

    def _embed_sharded(self, embed, tokens):
        """Vocab-parallel lookup: each position reads the rows of its
        vocab block (zeros for the others), then a ``psum`` over
        ``model``; the batch split as the rules split it."""
        tok = batch_split(self.ctx, tokens).long()
        v_ax = self._vocab_axis()
        emb = relayout(embed, P(v_ax, None))
        if v_ax is None:
            return F.embedding(tok, emb).to(self.dtype)
        n = emb.shape[0]
        local = tok.sub(axis_index(self.ctx.mesh, v_ax), alpha=n)
        ok = (local >= 0) & (local < n)
        x = F.embedding(local.clamp(0, n - 1), emb) * ok[..., None].to(
            emb.dtype)
        return psum(x, v_ax).to(self.dtype)

    def _head_sharded(self, params):
        """The output head (D, V) in its compute layout: the vocab over
        :meth:`_vocab_axis`, the embed dim whole."""
        v_ax = self._vocab_axis()
        if self.cfg.tie_embeddings:
            return relayout(params["embed"], P(v_ax, None)).T
        return relayout(params["out"], P(None, v_ax))

    def _logits_sharded(self, params, x, rows: int):
        """Vocab-parallel logits, all-gathered over ``model`` and over the
        batch axes: one (B, S, V) float32 tensor, the padded tail
        masked."""
        v_ax = self._vocab_axis()
        logits = torch.einsum("bsd,dv->bsv", x, self._head_sharded(params))
        if v_ax is not None:
            logits = all_gather(logits, v_ax, dim=2)
        b_axes = self.ctx.pspec(("batch",), (rows,)).axes_of(0)
        if b_axes:
            logits = all_gather(logits, b_axes, dim=0)
        logits = first(logits).to(F32)
        V = logits.shape[-1]
        if V != self.cfg.vocab:
            mask = torch.arange(V, device=logits.device) < self.cfg.vocab
            logits = torch.where(mask, logits, NEG_INF)
        return logits

    def _backbone(self, params, x, *, mode: str, cache=None, pos=None,
                  x0=None, mask=None, ckpt_every=None, ckpt_out=None):
        """The layer loop over every stack.  Prefill and decode write a
        dense stacked cache in place, through the per-layer views (extend
        stacks the per-layer slices anew); a PagedKVCache rides the loop
        with its ``layer`` rebound and its arena updated in place.

        ``mask`` (B, S) marks the real tokens of bucket-padded rows; the
        recurrent families thread it into the SSD scan (KV families need
        none).  ``x0`` is the embedding output the hybrid shared block
        concatenates.  ``ckpt_every`` (prefill, ssm / hybrid): each Mamba
        stack's new state becomes ``(state, checkpoints)``, the
        checkpoints written into ``ckpt_out`` (the stacked checkpoints'
        tree), split apart by ``_split_checkpoints``."""
        cfg = self.cfg
        if cfg.family == "ssm":
            node = None if cache is None else cache["mamba_layers"]
            x, new = self._mamba_stack(params["mamba_layers"], x, node,
                                       mode=mode, mask=mask,
                                       ckpt_every=ckpt_every,
                                       ckpt_out=ckpt_out)
            return x, ({} if node is None else {"mamba_layers": new})
        if cfg.family == "hybrid":
            return self._hybrid_backbone(params, x, mode=mode, cache=cache,
                                         pos=pos, x0=x0, mask=mask,
                                         ckpt_every=ckpt_every,
                                         ckpt_out=ckpt_out)
        new_cache = {}
        for key, layer_fn, n in self._stacks():
            stacked = params[key]
            node = None if cache is None else cache[key]
            in_place = (isinstance(node, PagedKVCache)
                        or mode in ("decode", "prefill"))
            new_slices = []
            for i in range(n):
                lp = tree_map(lambda a: a[i], stacked)
                if node is None:
                    csl = None
                elif isinstance(node, PagedKVCache):
                    csl = node._replace(layer=i)
                else:
                    csl = KVSlice(*(a[i] for a in node))
                x, ncsl = layer_fn(lp, x, cfg, mode=mode, cache=csl, pos=pos,
                                   ctx=self._lctx)
                if not in_place and ncsl is not None:
                    new_slices.append(ncsl)
            if node is None:
                continue
            if isinstance(node, PagedKVCache):
                new_cache[key] = node._replace(layer=0)
            elif in_place:
                new_cache[key] = node
            else:
                new_cache[key] = KVSlice(*(torch.stack(f)
                                           for f in zip(*new_slices)))
        return x, new_cache

    def _mamba_stack(self, stacked, x, node, *, mode, mask, ckpt_every,
                     ckpt_out=None):
        """Run a stack of Mamba layers.  ``node``: the stack's MambaState
        (leaves (n, B, ...)) or None; every mode writes the new states
        into it in place (a prefill reads nothing of it: it starts from
        zero state).  Returns (x, node), the node paired with
        ``ckpt_out`` (leaves (n, B, nb, ...)), which receives the
        checkpoints, under ``ckpt_every``."""
        cfg = self.cfg
        for i in range(tree_leaves(stacked)[0].shape[0]):
            lp = tree_map(lambda a: a[i], stacked)
            st = None if node is None else MambaState(*(a[i] for a in node))
            ck = (None if ckpt_out is None
                  else MambaState(*(a[i] for a in ckpt_out)))
            x, new = zmb.mamba_layer(lp, x, cfg, mode=mode,
                                     state=None if mode == "prefill" else st,
                                     mask=mask, ckpt_every=ckpt_every,
                                     ckpt_out=ck, ctx=self._lctx)
            if ckpt_every is not None:
                new = new[0]
            if st is not None:
                for dst, src in zip(st, new):
                    dst.copy_(src)
        if node is None:
            return x, None
        return x, node if ckpt_every is None else (node, ckpt_out)

    def _hybrid_backbone(self, params, x, *, mode, cache, pos, x0, mask,
                         ckpt_every, ckpt_out=None):
        """Zamba2: per group, its Mamba layers then the shared attention
        block on ``concat(x, x0)`` with the group's own KV cache, both
        written in place."""
        cfg = self.cfg
        node = None if cache is None else cache["groups"]
        for g in range(self._n_groups):
            gp = tree_map(lambda a: a[g], params["groups"])
            m_node = (None if node is None
                      else MambaState(*(a[g] for a in node.mamba)))
            ck = (None if ckpt_out is None
                  else MambaState(*(a[g] for a in ckpt_out)))
            x, _ = self._mamba_stack(gp, x, m_node, mode=mode, mask=mask,
                                     ckpt_every=ckpt_every, ckpt_out=ck)
            kv = None if node is None else KVSlice(*(a[g] for a in node.shared))
            x, _ = zmb.shared_block(params["shared"], x, x0, cfg, mode=mode,
                                    cache=kv, pos=pos, ctx=self._lctx)
        if node is None:
            return x, {}
        if ckpt_every is not None:
            node = node._replace(mamba=(node.mamba, ckpt_out))
        return x, {"groups": node}

    def _encode(self, params, src, src_len=None, *, remat: bool = False):
        """src (B, S_src, d_model) -> encoder memory; ``src_len`` (B,)
        masks pad frames out of the bidirectional self-attention.
        ``remat``: each layer recomputed in the backward (training).  A
        sharded model splits the rows as the rules split the batch and
        reads ``src_proj`` whole on every position."""
        cfg = self.cfg
        w = params["src_proj"]
        if self.sharded:
            src = batch_split(self.ctx, src)
            if src_len is not None:
                src_len = batch_split(self.ctx, src_len)
            w = relayout(w, P(None, None))
        x = src.to(self.dtype) @ w
        for i in range(cfg.encoder_layers):
            lp = tree_map(lambda a: a[i], params["enc_layers"])
            x = (_remat(encdec_mod.enc_layer, lp, x, cfg, src_len,
                        self._lctx) if remat
                 else encdec_mod.enc_layer(lp, x, cfg, src_len, self._lctx))
        return rms_norm(x, params["enc_norm"], cfg.rms_eps)

    def _decode_stack(self, params, x, *, mode, cache, pos=None):
        """The encdec decoder layers.  Each layer sees a DecCache of views
        into the stacked cache (its self KV: the dense rows of layer i, or
        the paged view rebound to layer i; its cross memory), which it
        updates in place; the cache comes back as it was given."""
        node = cache["dec_layers"]
        for i in range(self.cfg.num_layers):
            lp = tree_map(lambda a: a[i], params["dec_layers"])
            kv = node.self_kv
            kv = (kv._replace(layer=i) if isinstance(kv, PagedKVCache)
                  else KVSlice(*(a[i] for a in kv)))
            csl = encdec_mod.DecCache(kv, node.cross_k[i], node.cross_v[i],
                                      node.src_len[i])
            x, _ = encdec_mod.dec_layer(lp, x, self.cfg, mode=mode,
                                        cache=csl, pos=pos, ctx=self._lctx)
        return x, cache

    def _encdec_prefill(self, params, batch, cache):
        """Encode the batch's sources into ``cache``'s cross memory, then
        the decoder in prefill mode over it (both in place).  Returns (x,
        cache)."""
        self.encode_cross_into(params, cache["dec_layers"], batch["src"],
                               batch.get("src_len"))
        x = self._embed_tokens(params, batch["tokens"])
        return self._decode_stack(params, x, mode="prefill", cache=cache)

    def encode_cross_into(self, params, node, src, src_len=None):
        """Encode sources ``src`` (B, S_src, d_model) into the cross memory
        and ``src_len`` of ``node``, a stacked DecCache of B rows (or views
        of some rows), in place: every decoder layer's cross K/V
        projection of the encoder output; the one writer of cross memory.
        ``src_len`` None: every frame is valid."""
        if src_len is None:
            src_len = torch.full((src.shape[0],), src.shape[1],
                                 dtype=torch.int32, device=src.device)
        memory = self._encode(params, src, src_len)
        rows = self._split_rows(src_len)
        for i in range(self.cfg.num_layers):
            cp = tree_map(lambda a: a[i], params["dec_layers"]["cross"])
            ck, cv = encdec_mod.cross_kv(cp, memory, self.cfg, self._lctx)
            node.cross_k[i].copy_(ck)
            node.cross_v[i].copy_(cv)
            node.src_len[i].copy_(rows)

    def _last_logits(self, params, x, length):
        last = (length.long() - 1).clamp(0, x.shape[1] - 1)
        if self.sharded:
            last = batch_split(self.ctx, last)
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        x_last = rms_norm(x_last, params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x_last, length.shape[0])[:, 0]

    # -- training ---------------------------------------------------------
    def loss(self, params, batch):
        """Training loss of a batch {tokens (B, S), labels (B, S); encdec:
        src (B, S_src, d_model), optional src_len (B,)}: ``(loss, {"loss",
        "xent", "aux"})`` with ``loss = xent + 0.01 * aux`` (aux: the MoE
        load-balance loss summed over layers, 0 elsewhere), as JAX's
        ``Model.loss``.  Each layer (hybrid: each group of Mamba layers
        with its shared block) is recomputed in the backward, the
        counterpart of JAX's ``jax.checkpoint`` with ``nothing_saveable``.
        Under ZeRO-3 (``ctx.dp_over_model``) with 1024 tokens a row or
        more the head runs over sequence chunks of 512, each recomputed
        in the backward (:meth:`_chunked_xent`), as JAX's.

        Over a mesh the batch splits over the data axes, the layers run
        tensor- and expert-parallel, and the cross entropy is
        vocab-parallel: each position reduces its own vocab block of the
        float32 logits to a max, a sum of exponentials and the label's
        logit, ``pmax`` / ``psum`` over ``model`` combine them, and the
        token sums are ``psum``-ed over the batch axes (JAX's math; no
        position holds the (B, S, V) logits).  The results are the same
        on every position; a caller reads them at one."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = labels.shape
        aux = torch.zeros((), dtype=F32, device=tokens.device)
        x = self._embed_tokens(params, tokens)
        if self.sharded:
            labels = batch_split(self.ctx, labels)
        if cfg.family == "encdec":
            src_len = batch.get("src_len")
            memory = self._encode(params, batch["src"], src_len, remat=True)
            if src_len is not None and self.sharded:
                src_len = batch_split(self.ctx, src_len)
            x, aux = self._train_stack(
                params["dec_layers"], x, aux, encdec_mod.dec_layer,
                memory=memory, src_len=src_len)
        elif cfg.family == "ssm":
            x, aux = self._train_stack(params["mamba_layers"], x, aux,
                                       zmb.mamba_layer)
        elif cfg.family == "hybrid":
            x0 = x
            for g in range(self._n_groups):
                gp = tree_map(lambda a: a[g], params["groups"])
                x = _remat(self._train_group, params["shared"], gp, x, x0)
        else:
            for key, layer_fn, _ in self._stacks():
                x, aux = self._train_stack(params[key], x, aux, layer_fn)
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        chunked = self._ctx().dp_over_model and S >= 1024
        total = (self._chunked_xent(params, x, labels) if chunked
                 else self._xent_sum(params, x, labels))
        b_ax = batch_axes(self.ctx, B) if self.sharded else ()
        if b_ax:
            total = psum(total, b_ax)
        xent = total / (B * S)
        loss = xent + 0.01 * aux
        return loss, {"loss": loss, "xent": xent, "aux": aux}

    def _xent_sum(self, params, x, labels):
        """The float32 sum over this position's tokens of logsumexp
        minus the label's logit.  Over a mesh each position reduces its
        vocab block (:meth:`_vocab_axis`): its max (``pmax``, no
        gradient), its sum of exponentials and its label logit (each
        ``psum``-ed over the vocab axis)."""
        if not self.sharded:
            logits = self._logits(params, x)
            lse = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, labels.long()[..., None])[..., 0]
            return (lse - ll).sum()
        v_ax = self._vocab_axis()
        logits = torch.einsum("bsd,dv->bsv", x,
                              self._head_sharded(params)).to(F32)
        n = logits.shape[-1]
        rank = axis_index(self.ctx.mesh, v_ax or ())
        # each position's global vocab columns, on its own device
        col = Sharded([torch.arange(k * n, (k + 1) * n, device=s.device)
                       for s, k in zip(logits.shards, rank.shards)],
                      self.ctx.mesh)
        if v_ax is not None:
            labels = labels.sub(rank, alpha=n)
        if self.vocab_padded != self.cfg.vocab:
            logits = torch.where(col < self.cfg.vocab, logits, NEG_INF)
        m = logits.detach().amax(dim=-1)
        if v_ax is not None:
            m = pmax(m, v_ax)
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        ok = (labels >= 0) & (labels < n)
        ll = logits.gather(-1, labels.clamp(0, n - 1).long()[..., None])
        ll = ll[..., 0] * ok
        if v_ax is not None:
            se, ll = psum(se, v_ax), psum(ll, v_ax)
        return (torch.log(se) + m - ll).sum()

    def _chunked_xent(self, params, x, labels, chunk: int = 512):
        """:meth:`_xent_sum` over sequence chunks of ``chunk`` tokens, each
        chunk's head and loss recomputed in the backward, so no
        full-sequence logits are kept (JAX's ``_chunked_xent``, reached
        under ZeRO-3 only); the float32 chunk sums added in order."""
        S = x.shape[1]
        assert S % chunk == 0, (S, chunk)
        total = None
        for i in range(S // chunk):
            sl = (slice(None), slice(i * chunk, (i + 1) * chunk))
            part = _remat(self._xent_sum, params, x[sl], labels[sl])
            total = part if total is None else total + part
        return total

    def _train_stack(self, stacked, x, aux, layer_fn, **kw):
        """Run a layer stack in train mode, each layer under remat; a
        layer's second output, when not None, is its auxiliary loss."""
        for i in range(tree_leaves(stacked)[0].shape[0]):
            lp = tree_map(lambda a: a[i], stacked)
            x, a = _remat(layer_fn, lp, x, self.cfg, mode="train",
                          ctx=self._lctx, **kw)
            if a is not None:
                aux = aux + a
        return x, aux

    def _train_group(self, shared, gp, x, x0):
        """Zamba2 train mode: a group's Mamba layers, then the shared
        block on ``concat(x, x0)``."""
        for i in range(self.cfg.hybrid_attn_every):
            lp = tree_map(lambda a: a[i], gp)
            x, _ = zmb.mamba_layer(lp, x, self.cfg, mode="train",
                                   ctx=self._lctx)
        x, _ = zmb.shared_block(shared, x, x0, self.cfg, mode="train",
                                ctx=self._lctx)
        return x

    def prefill(self, params, batch, cache):
        """Whole prompts (B, S): logits at the last position + new cache
        (``cache`` fixes its shapes and is left untouched)."""
        cache = tree_map(torch.empty_like, cache)
        if self.cfg.family == "encdec":
            x, new_cache = self._encdec_prefill(params, batch, cache)
        else:
            x = self._embed_tokens(params, batch["tokens"])
            x, new_cache = self._backbone(params, x, mode="prefill",
                                          cache=cache, x0=x)
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.rms_eps)
        return (self._logits(params, x, batch["tokens"].shape[0])[:, 0],
                new_cache)

    def prefill_ranged(self, params, batch, cache, *, checkpoint_every=None,
                       in_place=False, ckpt_out=None):
        """Bucket-padded prompts in one invocation.

        ``batch`` = {tokens (B, S_pad) int32, length (B,) int32}; row b's
        prompt is ``tokens[b, :length[b]]`` (``length`` 0 marks a dummy
        padding row).  encdec batches add {src (B, S_src, d_model),
        src_len (B,)} (:meth:`ranged_batch_extras`): the encoder runs
        under the ``src_len`` mask, and the cache carries the cross memory
        and the mask for decode.  Returns (logits (B, V) at each row's last real
        token, cache exact at each row's length: KV pad slots' ``slot_pos``
        masked to -1, recurrent state untouched by pad steps).

        ``checkpoint_every`` (ssm / hybrid; must divide S_pad): also
        return the stacked recurrent-state checkpoints after every
        ``checkpoint_every`` positions, ``(logits, cache, ckpts)``, for
        :meth:`slice_checkpoint`.  Checkpoints past a row's length are pad
        garbage and must not be read.

        The default is JAX's contract: a new cache, ``cache`` read only
        for its shapes and left untouched.  ``in_place``: the same values
        are written into ``cache``'s own tensors, which come back as the
        cache.  ``ckpt_out`` (with ``checkpoint_every``): a tree shaped as
        the checkpoints (:meth:`checkpoint_specs`) that receives them and
        comes back as ``ckpts``."""
        tokens, length = batch["tokens"], batch["length"]
        if checkpoint_every is not None:
            if not self.supports_snapshot_state:
                raise NotImplementedError(
                    f"no state checkpoints for family {self.cfg.family!r}")
            if tokens.shape[1] % checkpoint_every:
                raise ValueError(
                    f"S_pad={tokens.shape[1]} not a multiple of "
                    f"checkpoint_every={checkpoint_every}")
            if ckpt_out is None:
                ckpt_out = self.init_checkpoints(
                    tokens.shape[0], tokens.shape[1] // checkpoint_every,
                    tokens.device)
        elif ckpt_out is not None:
            raise ValueError("ckpt_out needs checkpoint_every")
        if not in_place:
            cache = tree_map(torch.empty_like, cache)
        if self.cfg.family == "encdec":
            x, new_cache = self._encdec_prefill(params, batch, cache)
        else:
            x = self._embed_tokens(params, tokens)
            x, new_cache = self._backbone(
                params, x, mode="prefill", cache=cache, x0=x,
                mask=self._split_rows(self._length_mask(tokens, length)),
                ckpt_every=checkpoint_every, ckpt_out=ckpt_out)
        logits = self._last_logits(params, x, length)
        if checkpoint_every is None:
            return logits, self._mask_pad(new_cache, length)
        new_cache, ckpts = self._split_checkpoints(new_cache)
        return logits, self._mask_pad(new_cache, length), ckpts

    def _mask_pad(self, cache, length):
        """``mask_pad_slots_``; over a mesh, by each slot's position (a
        cache split on its sequence dim holds a block of slots)."""
        if not self.sharded:
            return mask_pad_slots_(cache, length)
        n = batch_split(self.ctx, length)
        for node in kv_cache_nodes(cache):
            node.slot_pos.masked_fill_(node.slot_pos >= n[:, None], -1)
        return cache

    def prefill_extend(self, params, batch, cache):
        """Suffix-only prefill behind a resident prefix (prefix sharing).

        ``batch`` = {tokens (B, S_ext), pos (B,), length (B,)}: row b's
        suffix ``tokens[b, :length[b]]`` continues a prompt whose first
        ``pos[b]`` positions already sit in ``cache``: interned pages of a
        paged cache, or, for ssm / hybrid, a snapshot restored into the
        dense per-slot cache (the suffix mask keeps pad steps out of the
        scan; a ``length`` 0 row is an identity update, and its attention
        writes drop when ``pos`` is past the cache).  encdec reads its
        cross memory from the cache; given the rows' sources (``src``,
        ``src_len`` as :meth:`ranged_batch_extras` makes them, one row per
        cache row) it first encodes them into the cache's cross memory.
        The cache is updated in place.  Returns (logits at each row's last
        real suffix token, cache)."""
        tokens, pos, length = batch["tokens"], batch["pos"], batch["length"]
        x = self._embed_tokens(params, tokens)
        if self.cfg.family == "encdec":
            if "src" in batch:
                self.encode_cross_into(params, cache["dec_layers"],
                                       batch["src"], batch.get("src_len"))
            x, new_cache = self._decode_stack(params, x, mode="extend",
                                              cache=cache, pos=pos)
        else:
            x, new_cache = self._backbone(
                params, x, mode="extend", cache=cache, pos=pos, x0=x,
                mask=self._split_rows(self._length_mask(tokens, length)))
        return self._last_logits(params, x, length), new_cache

    def _split_rows(self, t):
        """A per-row input (B, ...) as the layers see it: split over the
        batch axes when the rules split B over more than one data row,
        else as it is."""
        if self.sharded and batch_axes(self.ctx, t.shape[0]):
            return batch_split(self.ctx, t)
        return t

    @staticmethod
    def _length_mask(tokens, length):
        """(B, S) bool: the real tokens of each bucket-padded row."""
        return (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < length[:, None])

    def decode(self, params, cache, batch):
        """One token per row: batch = {tokens (B, 1), pos (B,)}."""
        x = self._embed_tokens(params, batch["tokens"])     # (B,1,D)
        if self.cfg.family == "encdec":
            x, new_cache = self._decode_stack(params, x, mode="decode",
                                              cache=cache, pos=batch["pos"])
        else:
            x, new_cache = self._backbone(params, x, mode="decode",
                                          cache=cache, pos=batch["pos"],
                                          x0=x)
        x = rms_norm(x, params["final_norm"], self.cfg.rms_eps)
        return (self._logits(params, x, batch["tokens"].shape[0])[:, 0],
                new_cache)

    # -- the batch helpers of the serving layer (family knowledge here) ----
    def ranged_batch_extras(self, srcs, max_len: int) -> dict:
        """Extra batch keys of a prefill or extend over ``len(srcs)`` rows,
        as CPU tensors.  ``srcs``: per-row source features (S_src_i,
        d_model) or None (no source: zero features, ``src_len`` 0).
        Families without side inputs return {}; encdec returns {src
        (B, S_src, d_model) in the model dtype, src_len (B,) int32},
        padded to the cache's source length so every key has one shape."""
        if self.cfg.family != "encdec":
            return {}
        s_src = self.source_len(max_len)
        src = torch.zeros((len(srcs), s_src, self.cfg.d_model),
                          dtype=self.dtype)
        src_len = torch.zeros((len(srcs),), dtype=torch.int32)
        for i, s in enumerate(srcs):
            if s is None:
                continue
            n = min(len(s), s_src)
            src[i, :n] = torch.from_numpy(
                np.asarray(s, np.float32)[:n]).to(self.dtype)
            src_len[i] = n
        return {"src": src, "src_len": src_len}

    def encode_cross_rows(self, params, srcs, max_len: int):
        """Cross memory rows as JAX's batcher installs them: (cross_k
        (L, B, S_src, Hkv, Dh), cross_v, src_len (B,)) on the params'
        device, for :func:`~repro_torch.models.cache_utils.
        install_cross_memory`; None when this family has no cross memory
        or no row carries a source.  The port's own batcher encodes
        straight into a slot's rows (:meth:`encode_cross_into`)."""
        if self.cfg.family != "encdec" or all(s is None for s in srcs):
            return None
        dev = params["src_proj"].device
        extras = {k: v.to(dev)
                  for k, v in self.ranged_batch_extras(srcs, max_len).items()}
        node = init_resident(self, len(srcs), max_len, dev)["dec_layers"]
        self.encode_cross_into(params, node, extras["src"],
                               extras["src_len"])
        return node.cross_k, node.cross_v, extras["src_len"]

    # -- recurrent-state snapshots (the ssm / hybrid cache-plane payload) --
    def _split_checkpoints(self, new_cache):
        """Split the ``(state, checkpoints)`` pair of the checkpointing
        backbone into (cache, ckpts); ckpts leaves carry the chunk axis
        right after batch: ssm (L, B, nb, ...), hybrid (G, E, B, nb, ...)."""
        if self.cfg.family == "ssm":
            states, ck = new_cache["mamba_layers"]
            return {**new_cache, "mamba_layers": states}, ck
        g = new_cache["groups"]
        states, ck = g.mamba
        return {**new_cache, "groups": g._replace(mamba=states)}, ck

    @property
    def _state_batch_axis(self) -> int:
        """Batch axis of the stacked recurrent-state leaves: ssm stacks
        (L,) in front, hybrid (G, E)."""
        return 1 if self.cfg.family == "ssm" else 2

    def slice_checkpoint(self, ckpts, row: int, chunk_idx: int):
        """One row's recurrent state after chunk ``chunk_idx``, as a 1-row
        state shaped like the recurrent part of a dense cache row: the
        snapshot payload :meth:`restore_state_row` writes back.  A copy: a
        view would keep the whole checkpoint tensor of its prefill
        alive.  Over a mesh each position copies its own part, and the
        payload keeps the checkpoints' layout by position, its one row
        whole on every data row (gathered from the data row that holds
        ``row``)."""
        ax = self._state_batch_axis
        idx = (slice(None),) * (ax + 1) + (chunk_idx,)
        return MambaState(*(take_rows(a[idx], ax, [row]) for a in ckpts))

    def state_node(self, cache) -> MambaState:
        """The stacked recurrent state of a cache (ssm / hybrid)."""
        return (cache["mamba_layers"] if self.cfg.family == "ssm"
                else cache["groups"].mamba)

    def restore_state_row(self, cache, state, row: int):
        """Write a 1-row snapshot ``state`` over slot ``row``'s recurrent
        cache leaves, in place (over a mesh, each position holding the
        slot its part); KV leaves (hybrid shared attention) are the
        caller's.  Returns ``cache``."""
        for dst, src in zip(self.state_node(cache), state):
            move_rows(dst, self._state_batch_axis, [row], src, [0])
        return cache


def _remat(fn, *args, **kw):
    """``fn(*args, **kw)`` with its activations recomputed in the backward
    instead of saved (non-reentrant ``torch.utils.checkpoint``)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kw)


def build_model(cfg: ArchConfig, ctx=None) -> Model:
    """The model of ``cfg``; over ``ctx``'s mesh when it holds more than
    one position."""
    return Model(cfg, ctx)
