"""Attention: GQA + RoPE + sliding window + logit softcap.

Plain PyTorch versions of ``repro/models/attention.py``: the chunked
online-softmax form (``chunked_attention``) and the quadratic form
(``reference_attention``). They are the CPU path of the flash-attention
dispatch and the yardstick the CUDA kernel is held against. Layout is the
model's (B, S, H, hd) throughout.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX half-split RoPE. x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(scores, cap):
    if cap and cap > 0.0:
        return torch.tanh(scores / cap) * cap
    return scores


def _make_mask(q_pos, kv_pos, causal, window):
    """(Sq, C) bool validity mask from absolute positions."""
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask


def _attend_block(qf, k, v, q_pos, kv_pos, causal, window, softcap):
    s = torch.einsum("bsngh,bcnh->bngsc", qf, k.float())
    s = _softcap(s, softcap)
    mask = _make_mask(q_pos, kv_pos, causal, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = p * mask.any(-1).to(p.dtype)[:, None]
    out = torch.einsum("bngsc,bcnh->bngsh", p, v.float())
    return out.permute(0, 3, 1, 2, 4)                           # (B,Sq,Hkv,G,hd)


def _online_update(carry, qf, kj, vj, q_pos, pj, causal, window, softcap):
    m, l, acc = carry
    s = torch.einsum("bsngh,bcnh->bngsc", qf, kj.float())
    s = _softcap(s, softcap)
    mask = _make_mask(q_pos, pj, causal, window)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully-masked rows keep p = 0 (avoid exp(-inf - -inf) = 1)
    p = torch.where((m_new > NEG_INF / 2)[..., None],
                    torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(torch.clamp(m - m_new, max=0.0))
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bngsc,bcnh->bngsh", p, vj.float())
    return m_new, l, acc


def chunked_attention(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Skv, Hkv, hd)
    v: torch.Tensor,            # (B, Skv, Hkv, hd)
    *,
    causal: bool = True,
    window: int = 0,            # 0 = full
    softcap: float = 0.0,
    q_offset: int = 0,          # absolute position of q[:, 0]
    kv_positions: Optional[torch.Tensor] = None,  # (Skv,) absolute, default iota
    chunk: int = 512,
) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    dev = q.device
    qf = (q.float() * hd ** -0.5).reshape(B, Sq, Hkv, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)

    if Skv <= chunk or Sq == 1:
        # single pass (decode or short kv)
        return _attend_block(
            qf, k, v, q_pos, kv_positions, causal, window,
            softcap).to(q.dtype).reshape(B, Sq, Hq, hd)

    carry = (torch.full((B, Hkv, G, Sq), NEG_INF, device=dev),
             torch.zeros((B, Hkv, G, Sq), device=dev),
             torch.zeros((B, Hkv, G, Sq, hd), device=dev))
    for c0 in range(0, Skv, chunk):   # full chunks, then the remainder
        c1 = min(c0 + chunk, Skv)
        carry = _online_update(carry, qf, k[:, c0:c1], v[:, c0:c1], q_pos,
                               kv_positions[c0:c1], causal, window, softcap)
    _, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]            # (B,Hkv,G,Sq,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)
    return out.to(q.dtype)


def reference_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_offset=0):
    """Quadratic oracle (small shapes only)."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    dev = q.device
    qf = (q.float() * hd ** -0.5).reshape(B, Sq, Hkv, Hq // Hkv, hd)
    out = _attend_block(qf, k, v, q_offset + torch.arange(Sq, device=dev),
                        torch.arange(Skv, device=dev), causal, window, softcap)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)
