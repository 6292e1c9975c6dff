"""Deterministic synthetic LM data (port of ``repro/data/synthetic.py``).

Tokens are drawn from a seeded bigram chain, so the stream has learnable
structure (the loss falls within a few hundred steps). ``BigramStream`` is a
numpy copy of the reference's: the same seed gives the same tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


class BigramStream:
    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # each token can be followed by `branch` successors
        self.table = rng.integers(0, vocab_size,
                                  size=(vocab_size, branch)).astype(np.int32)
        self.rng = rng

    def sample(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        out[:, 0] = self.rng.integers(0, self.vocab, size=batch)
        choice = self.rng.integers(0, self.table.shape[1], size=(batch, seq))
        for t in range(seq):
            out[:, t + 1] = self.table[out[:, t], choice[:, t]]
        return out


class DataPipeline:
    """Yields {'tokens', 'labels'} batches, (batch, seq) int64 on ``device``;
    an encoder-decoder's batch adds the encoder's stub input, ``enc_embeds``
    (batch, enc_seq, d_model) f32 standard normal, drawn after the batch's
    tokens from a second generator seeded ``seed + 1``, as the reference's.
    The same seed gives the reference's numbers.

    The vlm family (the image stub) and a mesh are not ported: the model
    raises for that family, and the port trains on one card."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 mesh=None, device="cuda"):
        if cfg.family == "vlm":
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported")
        if mesh is not None:
            raise NotImplementedError("a mesh is not ported: the port trains on one card")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.stream = BigramStream(cfg.vocab_size, seed)
        self.rng = np.random.default_rng(seed + 1)
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self):
        chain = torch.from_numpy(self.stream.sample(self.batch, self.seq).astype(np.int64))
        chain = chain.to(self.device)
        batch = {"tokens": chain[:, :-1], "labels": chain[:, 1:]}
        if self.cfg.is_encdec:
            enc = self.rng.standard_normal(
                (self.batch, self.cfg.enc_seq, self.cfg.d_model)).astype(np.float32)
            batch["enc_embeds"] = torch.from_numpy(enc).to(self.device)
        return batch
