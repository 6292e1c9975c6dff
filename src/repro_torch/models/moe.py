"""Mixture-of-Experts: top-k routing, sort-based dispatch, grouped expert FFN.

Port of the single-device path of ``repro/models/moe.py`` (``moe_local``);
the port does not shard, so ``moe_block`` is ``moe_local``. The expert FFN
runs through the grouped-matmul op: on CUDA tensors the port's kernel, on
CPU tensors its plain version. Nothing here waits on the host: group sizes
are counted on the device, rows are gathered and combined with index ops,
and no boolean indexing or ``.item()`` is used.

``moe_block_slots`` is the train form of S trials at once, the reference's
``moe_local`` under ``jax.vmap`` over a population's slots: each slot
routes its tokens with its own router and has its own aux loss; the
assignments of every slot are sorted at once by ``slot * E + expert``, and
each expert product is one grouped matmul over the S * E groups of (slot,
expert), the weights seen as (S * E, D, F).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gmm.ops import gmm
from repro_torch.models.layers import norm, norm_slots


def _router(cfg: ModelConfig, p, x):
    """x: (..., N, D), router (..., D, E) -> top-k probs (..., N, k),
    indices (..., N, k), aux loss (...): a leading slot axis routes each
    slot's tokens with its own router and gives each its own aux loss."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch load balance: fraction routed to e (top-1 proxy) x mean prob
    e = cfg.n_experts
    f = torch.zeros((*probs.shape[:-2], e), dtype=torch.float32, device=x.device).scatter_add_(
        -1, top_i[..., 0], torch.ones_like(top_i[..., 0], dtype=torch.float32)) / x.shape[-2]
    aux = e * torch.sum(f * probs.mean(-2), dim=-1) * cfg.router_aux_coef
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


def _routed_ffn(cfg: ModelConfig, p, x_flat, top_i, top_p, n_groups):
    """Dispatch the rows of ``x_flat`` (N, D) to their ``n_groups`` groups
    (``top_i`` (..., k) holds each row's group ids), run the expert FFN and
    combine the gated outputs back onto their rows -> (N, D)."""
    xs, gates, src, gid_sorted = _sorted_dispatch(cfg, x_flat, top_i, top_p)
    gs = torch.zeros(n_groups, dtype=torch.int32, device=x_flat.device).index_add_(
        0, gid_sorted, torch.ones_like(gid_sorted, dtype=torch.int32))
    out = _expert_ffn(cfg, p, xs, gs)
    out = out * gates[:, None].to(out.dtype)
    return torch.zeros(x_flat.shape, dtype=out.dtype, device=x_flat.device).index_add_(
        0, src, out)


def moe_local(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (x + moe(x), aux loss)."""
    B, S, D = x.shape
    hf = norm(cfg, p, x).reshape(B * S, D)
    top_p, top_i, aux = _router(cfg, p, hf)
    y = _routed_ffn(cfg, p, hf, top_i, top_p, cfg.n_experts)
    return x + y.reshape(B, S, D).to(x.dtype), aux


def moe_block(cfg: ModelConfig, p, x):
    """The single-device path: the port runs no mesh."""
    return moe_local(cfg, p, x)


def moe_block_slots(cfg: ModelConfig, p, x):
    """``moe_local`` of S trials: x (S, N, D), each weight (S, ...) ->
    (x + moe(x), each slot's aux loss (S,)). Slot s's assignments sort as
    its own ``argsort`` would (the key's slot part keeps the slots apart, the
    stable sort each slot's order within), so group s * E + e holds slot s's
    rows for its expert e."""
    S, N, D = x.shape
    E = cfg.n_experts
    h = norm_slots(cfg, p, x)
    top_p, top_i, aux = _router(cfg, p, h)
    key = top_i + (torch.arange(S, device=x.device) * E)[:, None, None]
    grouped = {n: p[n].reshape(S * E, *p[n].shape[2:]) for n in ("we_up", "we_gate", "we_down")}
    y = _routed_ffn(cfg, grouped, h.reshape(S * N, D), key, top_p, S * E)
    return x + y.reshape(S, N, D).to(x.dtype), aux
