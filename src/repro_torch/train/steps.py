"""Prefill and serve steps (port of ``repro/train/steps.py``'s serving half)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward, logits_fn


def make_prefill_step(cfg: ModelConfig):
    """(params, batch, cache) -> (next_token_logits (B, V), cache)."""

    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        h, cache = forward(cfg, params, batch, mode="prefill", cache=cache)
        return logits_fn(cfg, params, h[:, -1:])[:, 0], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, token (B, 1), pos) -> (logits, cache)."""

    @torch.inference_mode()
    def serve_step(params, cache, token, pos: int):
        h, cache = forward(cfg, params, {"tokens": token}, mode="decode",
                           pos=pos, cache=cache)
        return logits_fn(cfg, params, h)[:, 0], cache

    return serve_step
