"""Model assembly for the dense, vlm and moe families: specs, init,
caches, prefill, ranged prefill, suffix extend and decode.

The JAX ``Model`` scans a layer function over stacked parameters; here a
plain Python loop walks the stacked ``(L, ...)`` leaves, stack by stack
(DeepSeekMoE: its leading dense layers, then the MoE layers), each stack
with its own cache node.  A paged cache
(:class:`~repro_torch.models.layers.PagedKVCache`) is not stacked per
layer: one arena per stack serves its layers, the loop rebinds the view's
``layer`` index, and attention updates the arena in place.  Decode over a
dense per-slot cache also writes the stacked cache in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.cache_utils import mask_pad_slots
from repro_torch.models.layers import (
    KVSlice,
    PagedKVCache,
    embed_spec,
    kv_slice_specs,
    logits_fn,
    norm_spec,
    out_spec,
    pad_vocab,
    rms_norm,
)
from repro_torch.models.param import (
    DTYPES,
    PSpec,
    abstract_params,
    count_params,
    init_params,
    tree_map,
    tree_map_pspec,
)

#: ROADMAP queue 1 item that ports each family not yet ported
FAMILY_ITEM = {"encdec": 7, "ssm": 8, "hybrid": 8}


def stack_specs(specs, n: int):
    """Stack per-layer PSpecs along a leading 'layers' dim."""
    def bump(s: PSpec) -> PSpec:
        init = s.init
        if init[0] == "normal" and init[1] >= 0:
            init = ("normal", init[1] + 1)
        return PSpec((n,) + s.shape, ("layers",) + s.logical, init, s.dtype)
    return tree_map_pspec(bump, specs)


class Model:
    """The serving surface of one dense or MoE architecture."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family not in ("dense", "vlm", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 "
                f"item {FAMILY_ITEM.get(cfg.family, '?')})")
        self.cfg = cfg
        self.vocab_padded = pad_vocab(cfg.vocab, cfg.vocab_pad_multiple)
        self.dtype = DTYPES[cfg.dtype]

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
        if cfg.family != "moe":
            specs["layers"] = stack_specs(tfm.dense_layer_specs(cfg),
                                          cfg.num_layers)
            return specs
        fd = cfg.moe.first_dense_layers
        if fd:
            specs["dense_layers"] = stack_specs(
                tfm.dense_layer_specs(cfg, d_ff=cfg.moe.dense_d_ff), fd)
        specs["moe_layers"] = stack_specs(tfm.moe_layer_specs(cfg),
                                          cfg.num_layers - fd)
        return specs

    def _stacks(self):
        """(params / cache key, layer function, depth) of each layer stack,
        in the order the layers run."""
        cfg = self.cfg
        if cfg.family != "moe":
            return [("layers", tfm.dense_layer, cfg.num_layers)]
        fd = cfg.moe.first_dense_layers
        out = [("dense_layers", tfm.dense_layer, fd)] if fd else []
        return out + [("moe_layers", tfm.moe_layer, cfg.num_layers - fd)]

    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters on ``device`` drawn from ``generator`` (a
        generator on the same device)."""
        return init_params(self.param_specs(), generator, self.cfg.dtype,
                           resolve_device(device))

    def abstract_params(self):
        return abstract_params(self.param_specs(), self.cfg.dtype)

    def n_params(self) -> int:
        return count_params(self.param_specs())

    # -- caches ----------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        kv = kv_slice_specs(self.cfg, batch, max_len)
        return {key: stack_specs(kv, n) for key, _, n in self._stacks()}

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return init_params(self.cache_specs(batch, max_len), None,
                           self.cfg.dtype, resolve_device(device))

    # -- capabilities (as the JAX Model states them) ---------------------
    @property
    def chunked_prefill_exact(self) -> bool:
        return True

    @property
    def supports_paged_kv(self) -> bool:
        return True

    # -- forward ---------------------------------------------------------
    def _embed_tokens(self, params, tokens):
        return F.embedding(tokens.long(), params["embed"]).to(self.dtype)

    def _logits(self, params, x):
        w = params["embed"].T if self.cfg.tie_embeddings else params["out"]
        return logits_fn(x, w, self.cfg.vocab)

    def _backbone(self, params, x, *, mode: str, cache=None, pos=None):
        """The layer loop over every stack.  In prefill a dense KVSlice
        cache is read per layer and the new per-layer slices are stacked
        back; decode writes a dense stacked cache in place, through the
        per-layer views; a PagedKVCache rides the loop with its ``layer``
        rebound and its arena updated in place."""
        cfg = self.cfg
        new_cache = {}
        for key, layer_fn, n in self._stacks():
            stacked = params[key]
            node = None if cache is None else cache[key]
            in_place = isinstance(node, PagedKVCache) or mode == "decode"
            new_slices = []
            for i in range(n):
                lp = tree_map(lambda a: a[i], stacked)
                if node is None:
                    csl = None
                elif isinstance(node, PagedKVCache):
                    csl = node._replace(layer=i)
                else:
                    csl = KVSlice(*(a[i] for a in node))
                x, ncsl = layer_fn(lp, x, cfg, mode=mode, cache=csl, pos=pos)
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

    def _last_logits(self, params, x, length):
        last = (length.long() - 1).clamp(0, x.shape[1] - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        x_last = rms_norm(x_last, params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x_last)[:, 0]

    def prefill(self, params, batch, cache):
        """Whole prompts (B, S): logits at the last position + new cache."""
        x = self._embed_tokens(params, batch["tokens"])
        x, new_cache = self._backbone(params, x, mode="prefill", cache=cache)
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x)[:, 0], new_cache

    def prefill_ranged(self, params, batch, cache):
        """Bucket-padded prompts in one invocation.

        ``batch`` = {tokens (B, S_pad) int32, length (B,) int32}; row b's
        prompt is ``tokens[b, :length[b]]`` (``length`` 0 marks a dummy
        padding row).  Returns (logits (B, V) at each row's last real
        token, cache with the pad slots' ``slot_pos`` masked to -1)."""
        tokens, length = batch["tokens"], batch["length"]
        x = self._embed_tokens(params, tokens)
        x, new_cache = self._backbone(params, x, mode="prefill", cache=cache)
        logits = self._last_logits(params, x, length)
        return logits, mask_pad_slots(new_cache, length)

    def prefill_extend(self, params, batch, cache):
        """Suffix-only prefill behind a resident prefix (prefix sharing).

        ``batch`` = {tokens (B, S_ext), pos (B,), length (B,)}: row b's
        suffix ``tokens[b, :length[b]]`` continues a prompt whose first
        ``pos[b]`` positions already sit in the paged ``cache``.  Suffix
        K/V is written into the arena in place.  Returns (logits at each
        row's last real suffix token, cache)."""
        tokens, pos, length = batch["tokens"], batch["pos"], batch["length"]
        x = self._embed_tokens(params, tokens)
        x, new_cache = self._backbone(params, x, mode="extend", cache=cache,
                                      pos=pos)
        return self._last_logits(params, x, length), new_cache

    def decode(self, params, cache, batch):
        """One token per row: batch = {tokens (B, 1), pos (B,)}."""
        x = self._embed_tokens(params, batch["tokens"])     # (B,1,D)
        x, new_cache = self._backbone(params, x, mode="decode", cache=cache,
                                      pos=batch["pos"])
        x = rms_norm(x, params["final_norm"], self.cfg.rms_eps)
        return self._logits(params, x)[:, 0], new_cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
