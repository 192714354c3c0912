"""Deterministic synthetic data pipeline (the port of
``repro/data/pipeline.py``).

Two generators:
  * ``uniform``: i.i.d. uniform tokens (throughput shapes).
  * ``bigram``:  sequences from a fixed random bigram chain — a learnable
    task (a trained LM's loss approaches the chain's conditional entropy),
    what ``launch/train.py`` and ``chip_smoke.py`` train on.

Every batch is drawn from numpy exactly as the JAX pipeline draws it (the
same generators, seeds and calls), so both packages see the same batches
bit for bit; the tensors go to the device asked for.  The encdec family
gets source frames from a fixed random "frontend" projection of the
shifted targets, in bfloat16 as JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataConfig:
    kind: str = "bigram"          # uniform | bigram
    seed: int = 1234
    vocab: int = 512
    branching: int = 8            # bigram: nonzero successors per token


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, arch: ArchConfig, shape: ShapeConfig,
                 device="cuda"):
        self.cfg = cfg
        self.arch = arch
        self.shape = shape
        self.device = resolve_device(device)
        self.vocab = min(cfg.vocab, arch.vocab)
        rng = np.random.default_rng(cfg.seed)
        if cfg.kind == "bigram":
            # sparse row-stochastic transition matrix
            succ = rng.integers(0, self.vocab, size=(self.vocab, cfg.branching))
            probs = rng.dirichlet(np.ones(cfg.branching), size=self.vocab)
            self._succ, self._probs = succ, probs
        if arch.family == "encdec":
            # fixed random "frontend" projecting token ids to frame embeddings
            self._frontend = rng.standard_normal(
                (self.vocab, arch.d_model)).astype(np.float32) / np.sqrt(arch.d_model)

    def _sample_tokens(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        if self.cfg.kind == "uniform":
            return rng.integers(0, self.vocab, size=(batch, seq + 1)).astype(np.int32)
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cur = toks[:, t]
            choice = np.array(
                [rng.choice(self.cfg.branching, p=self._probs[c]) for c in cur]
            )
            toks[:, t + 1] = self._succ[cur, choice]
        return toks.astype(np.int32)

    def bigram_entropy(self) -> float:
        """Conditional entropy of the chain (nats) — the loss floor."""
        p = self._probs
        h_rows = -(p * np.log(p + 1e-12)).sum(-1)
        return float(h_rows.mean())

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.get_batch(step)
            step += 1

    def get_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Deterministic batch for a step (restart-safe): tokens and labels
        (B, S) int32, and for encdec src (B, S_src, d_model) bfloat16."""
        shape, arch = self.shape, self.arch
        rng = np.random.default_rng((self.cfg.seed, step))
        toks = self._sample_tokens(rng, shape.global_batch, shape.seq_len)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }
        if arch.family == "encdec":
            # source frames = frontend embeddings of the (shifted) targets,
            # truncated/padded to the source length
            s_src = min(shape.seq_len, 4096)
            src_tok = toks[:, 1:1 + s_src]
            if src_tok.shape[1] < s_src:
                src_tok = np.pad(src_tok, ((0, 0), (0, s_src - src_tok.shape[1])))
            batch["src"] = self._frontend[src_tok].astype(np.float32)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k == "src":
                t = t.to(torch.bfloat16)
            out[k] = t.to(self.device)
        return out
