"""Minimal checkpointer for weights and other trees of tensors (port of
``repro/checkpoint/checkpointer.py``).

A tree (a ``ModelParams`` or any ``nn.Module``, or nested dicts of tensors)
is flattened to the reference's "/"-joined keys (``dec/b0_attn/wq``) and
written with ``torch.save``: numpy, the reference's format, has no bf16.
Metadata goes to a JSON sidecar, ``<path>.json``, as in the reference.
"""
from __future__ import annotations

import json
import os

import torch
from torch import nn

from repro_torch.models.schema import ModelParams


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, nn.Module):
        return {prefix + n.replace(".", "/"): t for n, t in tree.named_parameters()}
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, (dict, nn.Module)):
                flat.update(_flatten(v, f"{prefix}{k}/"))
            else:
                flat[f"{prefix}{k}"] = v
        return flat
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def save(path: str, tree, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: t.detach().cpu() for k, t in _flatten(tree).items()}
    tmp = path + ".tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f)


def restore(path: str, like):
    """Restore into the structure of ``like``: a ``ModelParams`` (a new one
    is returned) or nested dicts of tensors, each leaf in the dtype and on
    the device of ``like``'s."""
    flat = torch.load(path, map_location="cpu", weights_only=True)

    def leaf(key, ref):
        if key not in flat:
            raise KeyError(f"{path}: no tensor {key!r}")
        t = flat[key]
        if t.shape != ref.shape:
            raise ValueError(f"{key}: {tuple(t.shape)} != {tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype)

    def build(tree, prefix):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict) else leaf(f"{prefix}{k}", v)
                for k, v in tree.items()}

    if isinstance(like, ModelParams):
        nested: dict = {}
        for key, ref in _flatten(like).items():
            *outer, name = key.split("/")
            node = nested
            for part in outer:
                node = node.setdefault(part, {})
            node[name] = leaf(key, ref)
        return ModelParams(nested)
    return build(like, "")


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)
