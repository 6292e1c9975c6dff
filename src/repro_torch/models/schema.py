"""Parameter schema and init for the attention, mamba, MLP and MoE blocks.

Port of the attn/mamba/mlp/moe and encoder-decoder part of
``repro/models/schema.py``: a model
is a nested dict of ``ParamDef`` leaves, with per-layer weights stacked on a
leading ``n_repeat`` axis. ``init_params`` draws them with the reference's
shapes and scales (normal x 1/sqrt(fan_in), embedding scale 1.0, norm scales
ones and LayerNorm biases zeros, mamba's A and dt-bias inits) from a
``torch.Generator``; the random
numbers differ from ``jax.random``'s. The weights
live in ``ModelParams``, an ``nn.Module`` that keeps the reference's
nested-dict layout, so weights carry across as a rename
(``models/convert.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"       # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.0         # 0 -> 1/sqrt(fan_in)


@dataclass(frozen=True)
class Dims:
    """Derived dimensions. The reference pads heads and vocab to its model-axis
    size; the port does not shard, so they are the config's own."""
    cfg: ModelConfig

    @property
    def hq(self) -> int:
        return self.cfg.n_heads

    @property
    def hkv(self) -> int:
        return self.cfg.n_kv_heads

    @property
    def hd(self) -> int:
        return self.cfg.head_dim

    @property
    def d(self) -> int:
        return self.cfg.d_model

    @property
    def v(self) -> int:
        return self.cfg.vocab_size


def _norm_schema(cfg: ModelConfig, name: str = "norm") -> dict:
    d = {f"{name}_scale": ParamDef((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        d[f"{name}_bias"] = ParamDef((cfg.d_model,), "zeros")
    return d


def attn_schema(cfg: ModelConfig, dims: Dims, cross: bool = False) -> dict:
    """Self attention's weights; with ``cross`` (an encoder-decoder's
    decoder layer) also the cross attention's, prefixed ``c_``."""
    hq, hkv, hd, d = dims.hq, dims.hkv, dims.hd, dims.d
    sch = {
        "wq": ParamDef((d, hq * hd)),
        "wk": ParamDef((d, hkv * hd)),
        "wv": ParamDef((d, hkv * hd)),
        "wo": ParamDef((hq * hd, d)),
    }
    sch.update(_norm_schema(cfg))
    if cross:
        sch.update({
            "c_wq": ParamDef((d, hq * hd)),
            "c_wk": ParamDef((d, hkv * hd)),
            "c_wv": ParamDef((d, hkv * hd)),
            "c_wo": ParamDef((hq * hd, d)),
        })
        sch.update({f"c_{k}": v for k, v in _norm_schema(cfg).items()})
    return sch


def mlp_schema(cfg: ModelConfig, dims: Dims) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    sch = {"w_up": ParamDef((d, f)), "w_down": ParamDef((f, d))}
    if cfg.act == "silu":  # SwiGLU
        sch["w_gate"] = ParamDef((d, f))
    sch.update(_norm_schema(cfg))
    return sch


def moe_schema(cfg: ModelConfig, dims: Dims) -> dict:
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    sch = {
        "router": ParamDef((d, e)),
        "we_up": ParamDef((e, d, f)),
        "we_down": ParamDef((e, f, d)),
    }
    if cfg.act == "silu":
        sch["we_gate"] = ParamDef((e, d, f))
    sch.update(_norm_schema(cfg))
    return sch


def mamba_schema(cfg: ModelConfig, dims: Dims) -> dict:
    d, di, st, dtr = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank
    sch = {
        "in_proj": ParamDef((d, 2 * di)),
        "conv_w": ParamDef((cfg.ssm_conv, di)),
        "conv_b": ParamDef((di,), "zeros"),
        "x_proj": ParamDef((di, dtr + 2 * st)),
        "dt_proj": ParamDef((dtr, di)),
        "dt_bias": ParamDef((di,), "ssm_dt"),
        "a_log": ParamDef((di, st), "ssm_a"),
        "d_skip": ParamDef((di,), "ones"),
        "out_proj": ParamDef((di, d)),
    }
    sch.update(_norm_schema(cfg))
    return sch


_FFN_SCHEMAS = {"mlp": mlp_schema, "moe": moe_schema}


def _stack(sch: dict, n: int) -> dict:
    return {k: ParamDef((n,) + v.shape, v.init, v.scale) for k, v in sch.items()}


def model_schema(cfg: ModelConfig) -> dict:
    if cfg.family == "vlm":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported")
    dims = Dims(cfg)
    sch: dict = {
        "embed": ParamDef((dims.v, cfg.d_model), "normal", 1.0),
        "unembed": ParamDef((cfg.d_model, dims.v)),
    }
    sch.update({f"final_{k}": v for k, v in _norm_schema(cfg).items()})
    dec: dict = {}
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        if mixer.startswith("attn"):
            mixer_sch = attn_schema(cfg, dims, cross=cfg.is_encdec)
        elif mixer == "mamba":
            mixer_sch = mamba_schema(cfg, dims)
        else:
            raise NotImplementedError(f"mixer {mixer!r} is not ported")
        dec[f"b{i}_{mixer}"] = _stack(mixer_sch, cfg.n_repeat)
        if ffn in _FFN_SCHEMAS:
            dec[f"b{i}_{ffn}"] = _stack(_FFN_SCHEMAS[ffn](cfg, dims), cfg.n_repeat)
        elif ffn:
            raise NotImplementedError(f"ffn {ffn!r} is not ported")
    sch["dec"] = dec
    if cfg.is_encdec:
        sch["enc"] = {"b0_attn": _stack(attn_schema(cfg, dims), cfg.n_enc_layers),
                      "b0_mlp": _stack(mlp_schema(cfg, dims), cfg.n_enc_layers)}
        sch.update({f"enc_final_{k}": v for k, v in _norm_schema(cfg).items()})
    return sch


def _leaves(sch: dict, prefix: str = ""):
    for k in sorted(sch):
        v = sch[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(model_schema(cfg)))


class ModelParams(nn.Module):
    """A model's weights in the reference's nested-dict layout.

    ``params["embed"]``, ``params["final_norm_scale"]`` and
    ``params["dec"]["b0_attn_local"]["wq"]`` (stacked on a leading
    ``n_repeat`` axis) index as the JAX pytree does. Weights are built
    frozen (``requires_grad=False``) for serving; a train step turns on
    ``requires_grad`` for them (``train/steps.py``).
    """

    def __init__(self, tree: dict):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, nn.ModuleDict({
                    blk: nn.ParameterDict({
                        n: nn.Parameter(t, requires_grad=False)
                        for n, t in leaves.items()})
                    for blk, leaves in val.items()}))
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


# a leaf of more elements is drawn a slice at a time, along its first axis
# longer than one: grok-1's stacked expert weights (6 x 8 x 6144 x 32768 at
# the 6 layers one card serves) would need a 38.7 GB f32 draw beside their
# 19.3 GB in bf16; kimi-k2's at one layer (1 x 384 x 7168 x 2048) 22.5 GB,
# so they are drawn an expert at a time
_DRAW_WHOLE = 1 << 32


def _init_leaf(d: ParamDef, generator: torch.Generator, device, dtype):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "ssm_a":
        # mamba: A = -exp(a_log), a_log = log(1..d_state) broadcast
        a = torch.log(torch.arange(1, d.shape[-1] + 1, dtype=torch.float32, device=device))
        return torch.empty(d.shape, dtype=dtype, device=device).copy_(a)
    if d.init == "ssm_dt":
        return torch.full(d.shape, math.log(math.e - 1), dtype=dtype, device=device)  # softplus^-1(1)
    scale = d.scale or 1.0 / math.sqrt(max(d.shape[0] if len(d.shape) == 1
                                           else d.shape[-2], 1))
    if math.prod(d.shape) > _DRAW_WHOLE:
        # one slice at a time along the first axis longer than one, so the
        # f32 draw never holds the leaf
        out = torch.empty(d.shape, dtype=dtype, device=device)
        axis = next((i for i, n in enumerate(d.shape) if n > 1), 0)
        rows = out.view(-1, *d.shape[axis + 1:])
        for i in range(rows.shape[0]):
            rows[i] = torch.randn(d.shape[axis + 1:], generator=generator,
                                  device=device).mul_(scale)
        return out
    x = torch.randn(d.shape, generator=generator, device=device)
    return (x.mul_(scale)).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> ModelParams:
    """Random weights drawn from ``generator``, which lives on ``device``."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)

    def build(sch):
        return {k: build(v) if isinstance(v, dict)
                else _init_leaf(v, generator, dev, dt)
                for k, v in sorted(sch.items())}

    with torch.no_grad():
        return ModelParams(build(model_schema(cfg)))
