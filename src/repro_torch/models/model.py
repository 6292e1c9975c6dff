"""Model assembly: embed -> n_repeat x pattern of blocks -> final norm (+ logits).

Port of the attention/MLP path of ``repro/models/model.py``. A Python loop
over the ``n_repeat`` stacked layers takes the place of ``lax.scan``.
Modes: 'train' (full sequence, no cache), 'prefill' (full sequence, fills
the cache), 'decode' (one token against the cache).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import attn_block, mlp_block, norm

INVALID_POS = 2 ** 30       # kpos of a cache slot that holds no key


def _mixer_window(cfg: ModelConfig, mixer: str) -> int:
    return cfg.window if mixer == "attn_local" else 0   # 0 = full attention


def embed_tokens(cfg: ModelConfig, params, tokens):
    x = params["embed"][tokens].to(getattr(torch, cfg.dtype))
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    if cfg.abs_pos:
        raise NotImplementedError("absolute positions are not ported")
    return x


def logits_fn(cfg: ModelConfig, params, hidden):
    """hidden: (B, S, D) -> (B, S, V) float32 (small S only — decode)."""
    h = norm(cfg, params, hidden, prefix="final_norm")
    logits = (h @ params["unembed"]).float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def forward(cfg: ModelConfig, params, batch: dict, *, mode: str = "train",
            pos: int = 0, cache=None):
    """Returns (hidden (B, S, D), cache); the cache is updated in place."""
    x = embed_tokens(cfg, params, batch["tokens"])
    dec = params["dec"]
    for r in range(cfg.n_repeat):
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            key = f"b{i}_{mixer}"
            if not mixer.startswith("attn"):
                raise NotImplementedError(f"mixer {mixer!r} is not ported")
            p = {n: t[r] for n, t in dec[key].items()}
            c = None if cache is None else {n: t[r] for n, t in cache[key].items()}
            x = attn_block(cfg, p, x, mode=mode, pos=pos, cache=c,
                           window=_mixer_window(cfg, mixer))
            if ffn == "mlp":
                x = mlp_block(cfg, {n: t[r] for n, t in dec[f"b{i}_mlp"].items()}, x)
            elif ffn:
                raise NotImplementedError(f"ffn {ffn!r} is not ported")
    return x, cache


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *,
               device="cuda"):
    """Zero K/V and invalid kpos for every attention block, stacked over n_repeat."""
    dev = resolve_device(device)
    R, B = cfg.n_repeat, batch_size
    dt = getattr(torch, cfg.dtype)
    cache = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if not mixer.startswith("attn"):
            raise NotImplementedError(f"mixer {mixer!r} is not ported")
        w = _mixer_window(cfg, mixer)
        L = min(max_seq, w) if w else max_seq
        cache[f"b{i}_{mixer}"] = {
            "k": torch.zeros((R, B, L, cfg.n_kv_heads, cfg.head_dim), dtype=dt, device=dev),
            "v": torch.zeros((R, B, L, cfg.n_kv_heads, cfg.head_dim), dtype=dt, device=dev),
            "kpos": torch.full((R, L), INVALID_POS, dtype=torch.int32, device=dev)}
    return cache
