"""Mamba (selective state-space) block: conv1d + input-dependent SSM scan.

Port of ``repro/models/ssm.py``. Every mode runs the scan through the
selective-scan op: prefill and train over the whole sequence, decode with
S = 1 (the reference computes that step inline; it is the same recurrence).
On CUDA tensors the op launches the port's kernel, on CPU tensors its plain
version. State cache: {'conv': (B, k-1, d_inner), 'ssm': (B, d_inner,
d_state) f32}, written in place.

``mamba_block_slots`` is the train form of S trials at once, the
reference's block under ``jax.vmap`` over a population's slots: every
weight with a leading slot axis, the projections one ``bmm`` each, the
conv with each slot's own taps and the scan one ``selective_scan_slots``
call over every slot's sequences.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan.ops import selective_scan, selective_scan_slots
from repro_torch.models.layers import norm, norm_slots


def _ssm_params(cfg: ModelConfig, p, x_conv):
    """x_conv: (..., di) -> dt (..., di), B (..., st), C (..., st)."""
    st, r = cfg.ssm_d_state, cfg.dt_rank
    bcd = x_conv @ p["x_proj"]
    dt = F.softplus(bcd[..., :r] @ p["dt_proj"] + p["dt_bias"])
    return dt, bcd[..., r:r + st], bcd[..., r + st:]


def _causal_conv(cfg: ModelConfig, p, x, conv_state=None):
    """Depthwise causal conv along S. x: (..., S, di); conv_state: (..., k-1,
    di); ``conv_w[i]`` and ``conv_b`` broadcast against x. Returns
    (silu(conv(x) + bias), the last k-1 inputs)."""
    k, S = cfg.ssm_conv, x.shape[-2]
    if conv_state is None:
        pad = x.new_zeros((*x.shape[:-2], k - 1, x.shape[-1]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)                # (..., S+k-1, di)
    out = sum(xp[..., i:i + S, :] * p["conv_w"][i] for i in range(k))
    return F.silu(out + p["conv_b"]), xp[..., S:, :]


def mamba_block(cfg: ModelConfig, p, x, *, mode: str, cache=None):
    """x: (B, S, D) -> x + mamba(x). ``cache`` ({'conv', 'ssm'} of one layer,
    or None) is read first and then updated in place."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    B, S, _ = x.shape
    h = norm(cfg, p, x)
    u, z = (h @ p["in_proj"]).chunk(2, dim=-1)      # (B, S, di) each
    a = -torch.exp(p["a_log"].float())

    u_conv, new_conv = _causal_conv(cfg, p, u, None if cache is None else cache["conv"])
    dt, b_ssm, c_ssm = _ssm_params(cfg, p, u_conv)
    h0 = (cache["ssm"] if cache is not None else
          torch.zeros((B, cfg.ssm_d_inner, cfg.ssm_d_state), dtype=torch.float32,
                      device=x.device))
    y, hT = selective_scan(u_conv, dt, a, b_ssm, c_ssm, p["d_skip"], h0)

    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(hT)
    return x + out


def mamba_block_slots(cfg: ModelConfig, p, x, *, batch: int):
    """``mamba_block``'s train mode for S trials: x (S, batch * T, D), each
    weight (S, ...). Returns x + mamba(x)."""
    S, N, _ = x.shape
    T, di, st = N // batch, cfg.ssm_d_inner, cfg.ssm_d_state
    h = norm_slots(cfg, p, x)
    u, z = torch.bmm(h, p["in_proj"]).chunk(2, dim=-1)         # (S, N, di) each
    a = -torch.exp(p["a_log"].float())                          # (S, di, st)
    # each slot's taps, bias and dt bias broadcast against its rows
    conv = {"conv_w": p["conv_w"].transpose(0, 1)[:, :, None, None],   # (k, S, 1, 1, di)
            "conv_b": p["conv_b"][:, None, None]}
    u_conv, _ = _causal_conv(cfg, conv, u.reshape(S, batch, T, di))
    u_conv = u_conv.reshape(S, N, di)
    dt, b_ssm, c_ssm = _ssm_params(cfg, dict(p, dt_bias=p["dt_bias"][:, None]), u_conv)
    rows = (S * batch, T)
    h0 = torch.zeros((S * batch, di, st), dtype=torch.float32, device=x.device)
    y, _ = selective_scan_slots(u_conv.reshape(*rows, di), dt.reshape(*rows, di), a,
                                b_ssm.reshape(*rows, st), c_ssm.reshape(*rows, st),
                                p["d_skip"].contiguous(), h0)
    return torch.baddbmm(x, y.reshape(S, N, di).to(x.dtype) * F.silu(z), p["out_proj"])
