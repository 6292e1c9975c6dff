"""Plain versions of flash attention: the chunked online-softmax form, the
quadratic form, and the split-KV form of the decode kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import (NEG_INF, _online_update,  # noqa: F401
                                          chunked_attention, reference_attention)


def split_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       n_split: int, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, q_offset: int = 0,
                       kv_positions: Optional[torch.Tensor] = None,
                       tile: int = 64) -> torch.Tensor:
    """The plain twin of the split-KV decode kernel (``csrc/flash_decode.cu``).

    The keys are cut into ``n_split`` contiguous ranges of whole ``tile``-key
    tiles. Each range gives an unnormalised partial (m, l, o) in f32 by an
    online softmax over its tiles; a range whose keys are all hidden keeps
    m = -1e30, l = 0, o = 0. The combine weighs each partial by
    exp(m - max m) and divides the summed o by the summed l; a row with no
    visible key gives 0. Nothing on the main path calls it: it holds the
    kernel's arithmetic up against ``chunked_attention``.
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    dev = q.device
    qf = (q.float() * hd ** -0.5).reshape(B, Sq, Hkv, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)
    n_tiles = max(1, -(-Skv // tile))
    per = -(-n_tiles // n_split)
    parts = []
    for s in range(n_split):
        carry = (torch.full((B, Hkv, G, Sq), NEG_INF, device=dev),
                 torch.zeros((B, Hkv, G, Sq), device=dev),
                 torch.zeros((B, Hkv, G, Sq, hd), device=dev))
        for t in range(s * per, min((s + 1) * per, n_tiles)):
            lo, hi = t * tile, min((t + 1) * tile, Skv)
            carry = _online_update(carry, qf, k[:, lo:hi], v[:, lo:hi], q_pos,
                                   kv_positions[lo:hi], causal, window, softcap)
        parts.append(carry)
    m = torch.stack([p[0] for p in parts], -1)                  # (B,Hkv,G,Sq,n)
    l = torch.stack([p[1] for p in parts], -1)
    o = torch.stack([p[2] for p in parts], -2)                  # (B,Hkv,G,Sq,n,hd)
    top = m.amax(-1, keepdim=True)
    w = torch.where(top > NEG_INF / 2, torch.exp(m - top), 0.0)
    total = (w * l).sum(-1)
    out = (w[..., None] * o).sum(-2) / torch.clamp(total, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)    # (B,Sq,Hq,hd)
    return out.to(q.dtype)
