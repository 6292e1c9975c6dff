"""Norms, the MLP, and the attention block (projections + KV-cache management).

Port of ``repro/models/layers.py``. RMSNorm goes through the RMSNorm op and
attention through the flash-attention op: on CUDA tensors both launch the
port's kernels, on CPU tensors their plain versions. LayerNorm and the GELU
MLP are plain PyTorch on every device, as they are plain ``jnp`` in the
reference. Unlike the functional reference, the blocks write the KV cache
in place (a (R, B, L, Hkv, hd) stack is too large to copy every decode
step).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models.attention import rope


def norm(cfg: ModelConfig, p, x, prefix: str = "norm"):
    if not cfg.norm_f32:
        raise NotImplementedError("only f32-statistics norms are ported")
    if cfg.norm == "layernorm":
        # plain PyTorch on every device: the reference has no kernel for it
        xf = x.float()
        xf = xf - xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p[f"{prefix}_scale"].float() \
            + p[f"{prefix}_bias"].float()
        return out.to(x.dtype)
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    return rmsnorm(x, p[f"{prefix}_scale"], eps=1e-6)


def mlp_block(cfg: ModelConfig, p, x):
    h = norm(cfg, p, x)
    up = h @ p["w_up"]
    if cfg.act == "silu":
        up = F.silu(h @ p["w_gate"]) * up                 # SwiGLU
    elif cfg.act == "gelu":
        up = F.gelu(up, approximate="tanh")               # jax.nn.gelu's default
    else:
        raise NotImplementedError(f"act {cfg.act!r} is not ported")
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
