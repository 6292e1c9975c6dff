"""Norms, the MLP, the attention block (projections + KV-cache management),
whisper's cross attention and sinusoidal positions.

Port of ``repro/models/layers.py``. RMSNorm goes through the RMSNorm op and
attention through the flash-attention op: on CUDA tensors both launch the
port's kernels, on CPU tensors their plain versions. LayerNorm and the GELU
MLP are plain PyTorch on every device, as they are plain ``jnp`` in the
reference. Unlike the functional reference, the blocks write the KV cache
in place (a (R, B, L, Hkv, hd) stack is too large to copy every decode
step).

``norm_slots``, ``mlp_block_slots`` and ``attn_block_slots`` are the train
forms of S trials at once, as the reference's blocks under ``jax.vmap``
over a population's slots: every weight carries a leading slot axis, the
activations are ``(S, B*T, D)``, the projections one ``bmm`` each, RMSNorm
the op's slot case and attention one flash call over ``S*B`` sequences.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_slots
from repro_torch.models.attention import rope


def _check_norm(cfg: ModelConfig):
    if not cfg.norm_f32:
        raise NotImplementedError("only f32-statistics norms are ported")
    if cfg.norm not in ("layernorm", "rmsnorm"):
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")


def _layernorm(x, scale, bias):
    """Plain PyTorch on every device: the reference has no kernel for it.
    ``scale`` and ``bias`` broadcast against x."""
    xf = x.float()
    xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float() + bias.float()).to(x.dtype)


def norm(cfg: ModelConfig, p, x, prefix: str = "norm"):
    _check_norm(cfg)
    if cfg.norm == "layernorm":
        return _layernorm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"])
    return rmsnorm(x, p[f"{prefix}_scale"], eps=1e-6)


def norm_slots(cfg: ModelConfig, p, x, prefix: str = "norm"):
    """``norm`` of S trials: x (S, ..., D), each slot's scale (and bias) a
    row of an (S, D) weight."""
    _check_norm(cfg)
    scale = p[f"{prefix}_scale"].contiguous()
    if cfg.norm == "layernorm":
        row = scale.shape[:1] + (1,) * (x.dim() - 2) + scale.shape[1:]
        return _layernorm(x, scale.view(row), p[f"{prefix}_bias"].reshape(row))
    return rmsnorm_slots(x, scale, eps=1e-6)


def _mlp_up(cfg: ModelConfig, up, gate):
    """The MLP's hidden activation from ``up = h w_up`` and ``gate()``,
    which computes ``h w_gate`` (SwiGLU only)."""
    if cfg.act == "silu":
        return F.silu(gate()) * up                        # SwiGLU
    if cfg.act == "gelu":
        return F.gelu(up, approximate="tanh")             # jax.nn.gelu's default
    raise NotImplementedError(f"act {cfg.act!r} is not ported")


def mlp_block(cfg: ModelConfig, p, x):
    h = norm(cfg, p, x)
    up = _mlp_up(cfg, h @ p["w_up"], lambda: h @ p["w_gate"])
    return x + up @ p["w_down"]


def mlp_block_slots(cfg: ModelConfig, p, x):
    """``mlp_block`` of S trials: x (S, N, D), weights (S, ...)."""
    h = norm_slots(cfg, p, x)
    up = _mlp_up(cfg, torch.bmm(h, p["w_up"]), lambda: torch.bmm(h, p["w_gate"]))
    return torch.baddbmm(x, up, p["w_down"])


def _split_heads(t, hd):
    B, S, HD = t.shape
    return t.view(B, S, HD // hd, hd)


def attn_block(cfg: ModelConfig, p, x, *, mode: str, pos: int, cache,
               window: int, causal: bool = True):
    """Self attention with an optional ring KV cache.

    mode: 'train' (no cache), 'prefill' (build cache), 'decode' (1 token).
    pos:  absolute position of x[:, 0] (python int).
    cache: {'k','v': (B, L, Hkv, hd), 'kpos': (L,) int32} or None; updated
    in place. Keys are stored RoPE'd; masking uses the absolute positions in
    'kpos' (2**30 marks an unwritten slot).
    causal: applies where there is no cache (train mode); False is the
    encoder's self attention. Prefill and decode are causal.
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
        out = flash_attention(q, k, v, causal=causal, window=window,
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


def cross_attn_block(cfg: ModelConfig, p, x, *, mode: str, enc_out=None, cache=None):
    """Whisper's cross attention from the decoder onto the encoder's states.

    With ``enc_out`` (B, enc_seq, D), k and v are projected from it and, at
    prefill, written in place into ``cache['ck']`` / ``cache['cv']`` (B,
    enc_seq, Hkv, hd); without it they are read from the cache (decode, or a
    prefill that was given no encoder input, which reads the cache's zeros).
    The attention is not causal and has no positions.
    """
    hd = cfg.head_dim
    B, S, _ = x.shape
    h = norm(cfg, p, x, prefix="c_norm")
    q = _split_heads(h @ p["c_wq"], hd)
    if enc_out is not None:
        k = _split_heads(enc_out @ p["c_wk"], hd)
        v = _split_heads(enc_out @ p["c_wv"], hd)
        if mode == "prefill" and cache is not None:
            cache["ck"].copy_(k)
            cache["cv"].copy_(v)
    else:
        k, v = cache["ck"], cache["cv"]
    out = flash_attention(q, k, v, causal=False, softcap=cfg.attn_softcap,
                          chunk=cfg.attn_chunk)
    return x + out.reshape(B, S, -1) @ p["c_wo"]


def sinusoidal_positions(seq: int, d: int, offset: int = 0, dtype=torch.float32,
                         device=None):
    """(seq, d) sin | cos of positions offset .. offset + seq - 1, computed in
    f32 and then cast, as the reference's. The denominators 10000^(2i/d),
    with the exponent 2i/d in f32, are raised in f64 and rounded once to
    f32, so every device gets the same f32 value: an f32 ``pow`` may differ
    by an ulp between devices, which at position 1,500 moves an angle by
    about 1e-4."""
    pos = (offset + torch.arange(seq, device=device)).float()[:, None]
    expo = 2 * torch.arange(d // 2, device=device, dtype=torch.float32)[None, :] / d
    ang = pos / torch.pow(10000.0, expo.double()).float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def attn_block_slots(cfg: ModelConfig, p, x, *, batch: int, window: int):
    """``attn_block``'s train mode for S trials: x (S, batch * T, D), each
    weight (S, ...). RoPE's positions are shared; the slots' sequences go
    to one flash call as a batch of S * batch."""
    hd = cfg.head_dim
    S, N, _ = x.shape
    T = N // batch
    h = norm_slots(cfg, p, x)
    q = torch.bmm(h, p["wq"]).view(S * batch, T, -1, hd)
    k = torch.bmm(h, p["wk"]).view(S * batch, T, -1, hd)
    v = torch.bmm(h, p["wv"]).view(S * batch, T, -1, hd)
    if cfg.use_rope:
        positions = torch.arange(T, device=x.device, dtype=torch.int32)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
                          q_offset=0, chunk=cfg.attn_chunk)
    return torch.baddbmm(x, out.reshape(S, N, -1), p["wo"])
