"""Carry the JAX package's weights into the port.

``params_from_numpy`` takes the reference's ``init_params`` pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns ``ModelParams``
with the same nested-dict, stacked-``n_repeat`` layout: a rename, not a
reshape. With the same weights the port computes what the reference
computes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.schema import ModelParams, model_schema


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":        # ml_dtypes bf16: numpy has no native bf16
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)     # a copy: writable, owned


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> ModelParams:
    dev = resolve_device(device)

    def convert(sch, sub, path):
        if set(sch) != set(sub):
            raise ValueError(f"{path or '/'}: keys {sorted(sub)} != schema {sorted(sch)}")
        out = {}
        for k, d in sorted(sch.items()):
            if isinstance(d, dict):
                out[k] = convert(d, sub[k], f"{path}/{k}")
                continue
            a = np.asarray(sub[k])
            if a.shape != d.shape:
                raise ValueError(f"{path}/{k}: shape {a.shape} != schema {d.shape}")
            out[k] = _to_tensor(a, dev)
        return out

    return ModelParams(convert(model_schema(cfg), tree, ""))


def a3c_params_from_numpy(tree: dict, cfg, device="cuda"):
    """The reference's GA3C net (``repro.rl.network.init_net`` as numpy
    arrays) as an ``rl.network.A3CNet`` of ``cfg``: the convolutions are
    OIHW in both; the linear weights ``fcw`` / ``pw`` / ``vw`` are (in, out)
    there and (out, in) here, so they are transposed. Both flatten NCHW."""
    from repro_torch.rl.network import LINEAR, A3CNet, param_shapes

    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    if set(tree) != set(shapes):
        raise ValueError(f"keys {sorted(tree)} != {sorted(shapes)}")
    net = A3CNet(cfg, device=dev)
    with torch.no_grad():
        for name, shape in shapes.items():
            a = np.asarray(tree[name], np.float32)
            a = a.T if name in LINEAR else a
            if a.shape != shape:
                raise ValueError(f"{name}: shape {a.shape} != {shape}")
            getattr(net, name).copy_(_to_tensor(a, dev))
    return net
