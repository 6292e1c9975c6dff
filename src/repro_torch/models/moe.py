"""Mixture-of-Experts: top-k routing, sort-based dispatch, grouped expert FFN.

Port of the single-device path of ``repro/models/moe.py`` (``moe_local``);
the port does not shard, so ``moe_block`` is ``moe_local``. The expert FFN
runs through the grouped-matmul op: on CUDA tensors the port's kernel, on
CPU tensors its plain version. Nothing here waits on the host: group sizes
are counted on the device, rows are gathered and combined with index ops,
and no boolean indexing or ``.item()`` is used.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gmm.ops import gmm
from repro_torch.models.layers import norm


def _router(cfg: ModelConfig, p, x):
    """x: (T, D) -> top-k probs (T, k), indices (T, k), aux loss scalar."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch load balance: fraction routed to e (top-1 proxy) x mean prob
    e = cfg.n_experts
    f = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_i[:, 0], torch.ones_like(top_i[:, 0], dtype=torch.float32)) / x.shape[0]
    aux = e * torch.sum(f * probs.mean(0)) * cfg.router_aux_coef
    return top_p, top_i, aux


def _sorted_dispatch(cfg: ModelConfig, x_flat, top_i, top_p):
    """Sort the T*k assignments by expert id (stably, as ``jnp.argsort``).
    Returns gathered rows, gates, source row ids and the sorted expert ids."""
    k = cfg.top_k
    eid = top_i.reshape(-1)
    gate = top_p.reshape(-1)
    order = torch.argsort(eid, stable=True)
    src = torch.div(order, k, rounding_mode="floor")
    return (x_flat.index_select(0, src), gate.index_select(0, order), src,
            eid.index_select(0, order))


def _expert_ffn(cfg: ModelConfig, p, xs, group_sizes):
    """SwiGLU over rows of ``xs`` sorted by expert: three grouped matmuls."""
    if cfg.act != "silu":
        raise NotImplementedError(f"act {cfg.act!r} is not ported")
    up = gmm(xs, p["we_up"], group_sizes)
    up = F.silu(gmm(xs, p["we_gate"], group_sizes)) * up
    return gmm(up, p["we_down"], group_sizes)


def moe_local(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (x + moe(x), aux loss)."""
    B, S, D = x.shape
    h = norm(cfg, p, x)
    hf = h.reshape(B * S, D)
    top_p, top_i, aux = _router(cfg, p, hf)
    xs, gates, src, eid_sorted = _sorted_dispatch(cfg, hf, top_i, top_p)
    gs = torch.zeros(cfg.n_experts, dtype=torch.int32, device=x.device).index_add_(
        0, eid_sorted, torch.ones_like(eid_sorted, dtype=torch.int32))
    out = _expert_ffn(cfg, p, xs, gs)
    out = out * gates[:, None].to(out.dtype)
    y = torch.zeros((B * S, D), dtype=out.dtype, device=x.device).index_add_(0, src, out)
    return x + y.reshape(B, S, D).to(x.dtype), aux


def moe_block(cfg: ModelConfig, p, x):
    """The single-device path: the port runs no mesh."""
    return moe_local(cfg, p, x)
