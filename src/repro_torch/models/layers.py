"""Norms, the MLP, and the attention block (projections + KV-cache management).

Port of ``repro/models/layers.py``. ``norm`` goes through the RMSNorm op and
attention through the flash-attention op: on CUDA tensors both launch the
port's kernels, on CPU tensors their plain versions. Unlike the functional
reference, the blocks write the KV cache in place (a (R, B, L, Hkv, hd)
stack is too large to copy every decode step).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models.attention import rope


def norm(cfg: ModelConfig, p, x, prefix: str = "norm"):
    if cfg.norm != "rmsnorm" or not cfg.norm_f32:
        raise NotImplementedError("only f32-statistics RMSNorm is ported")
    return rmsnorm(x, p[f"{prefix}_scale"], eps=1e-6)


def mlp_block(cfg: ModelConfig, p, x):
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported")
    h = norm(cfg, p, x)
    up = F.silu(h @ p["w_gate"]) * (h @ p["w_up"])      # SwiGLU
    return x + up @ p["w_down"]


def _split_heads(t, hd):
    B, S, HD = t.shape
    return t.view(B, S, HD // hd, hd)


def attn_block(cfg: ModelConfig, p, x, *, mode: str, pos: int, cache,
               window: int):
    """Causal self attention with an optional ring KV cache.

    mode: 'train' (no cache), 'prefill' (build cache), 'decode' (1 token).
    pos:  absolute position of x[:, 0] (python int).
    cache: {'k','v': (B, L, Hkv, hd), 'kpos': (L,) int32} or None; updated
    in place. Keys are stored RoPE'd; masking uses the absolute positions in
    'kpos' (2**30 marks an unwritten slot).
    """
    hd = cfg.head_dim
    B, S, _ = x.shape
    h = norm(cfg, p, x)
    q = _split_heads(h @ p["wq"], hd)
    k = _split_heads(h @ p["wk"], hd)
    v = _split_heads(h @ p["wv"], hd)

    positions = pos + torch.arange(S, device=x.device, dtype=torch.int32)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if mode == "train" or cache is None:
        out = flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, q_offset=pos,
                              chunk=cfg.attn_chunk)
    elif mode == "prefill":
        L = cache["k"].shape[1]
        out = flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, q_offset=pos,
                              chunk=cfg.attn_chunk)
        # store the last min(S, L) keys/values; ring convention: position p
        # lives at slot p % L so decode overwrites the oldest entry.
        if S >= L:
            shift = (pos + S - L) % L
            cache["k"].copy_(torch.roll(k[:, S - L:], shift, dims=1))
            cache["v"].copy_(torch.roll(v[:, S - L:], shift, dims=1))
            cache["kpos"].copy_(torch.roll(positions[S - L:], shift, dims=0))
        else:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
            cache["kpos"][:S] = positions
    elif mode == "decode":
        slot = pos % cache["k"].shape[1]
        cache["k"][:, slot:slot + S] = k
        cache["v"][:, slot:slot + S] = v
        cache["kpos"][slot:slot + S] = positions
        out = flash_attention(q, cache["k"], cache["v"], causal=True,
                              window=window, softcap=cfg.attn_softcap,
                              q_offset=pos, kv_pos=cache["kpos"],
                              chunk=cfg.attn_chunk)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return x + out.reshape(B, S, -1) @ p["wo"]
