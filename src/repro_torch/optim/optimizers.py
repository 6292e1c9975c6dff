"""Optimizers (port of ``repro/optim/optimizers.py``, without the ZeRO specs,
which need a mesh).

* ``rmsprop``: non-centered RMSProp, the optimizer A3C/GA3C uses: one
  accumulator, no momentum, eps inside the square root
  (``p -= lr * g / sqrt(g2 + eps)``, eps 0.1), which ``torch.optim.RMSprop``
  (``sqrt(g2) + eps``) does not compute.
* ``adamw``: for the LM objectives; bias correction at ``t = step + 1``.

Weights are a ``ModelParams`` (or any ``nn.Module``) or a mapping of name to
tensor, and are updated in place. The state's accumulators are f32 tensors
keyed by the same names; each update is computed in f32 and cast back to the
weight's dtype. Nothing here waits on the host: the step count, learning rate
and gradient norm stay on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig


class OptState(NamedTuple):
    step: torch.Tensor          # () int32
    acc1: dict                  # rmsprop: sq-avg; adam: m
    acc2: Optional[dict]        # adam: v; rmsprop: None


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(tc: TrainConfig, params) -> OptState:
    named = _named(params)
    dev = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}

    step = torch.zeros((), dtype=torch.int32, device=dev)
    return OptState(step, zeros(), None if tc.optimizer == "rmsprop" else zeros())


def _scalar(v, device) -> torch.Tensor:
    """An f32 scalar on ``device``; a Python number is filled there (no copy
    from the host, which would wait on the card)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def learning_rate(tc: TrainConfig, step, base=None, warmup=None) -> torch.Tensor:
    """f32 scalar on ``step``'s device. ``base`` overrides
    ``tc.learning_rate`` and ``warmup`` ``tc.warmup_steps`` (floats or
    tensors: how a population of trials runs one step over per-trial
    values). A ``warmup`` at or below 1 means none."""
    lr = _scalar(tc.learning_rate if base is None else base, step.device)
    if warmup is not None:
        w = torch.clamp(_scalar(warmup, step.device), min=1.0)
        return lr * torch.clamp((step + 1) / w, max=1.0)
    if tc.warmup_steps:
        lr = lr * torch.clamp((step + 1) / tc.warmup_steps, max=1.0)
    return lr


def _clip_by_global_norm(grads: dict, max_norm):
    """(scale, global norm) of ``grads``, both f32 scalars: the reference's
    ``min(1, max_norm / max(norm, 1e-9))``, or 1 where ``max_norm`` is None
    or a Python 0 (a tensor always clips). The reference returns the scaled
    gradients; here each is scaled in f32 as its weight is updated, so no
    second copy of all of them is made."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    no_clip = max_norm is None or (isinstance(max_norm, (int, float)) and not max_norm)
    if no_clip:
        return torch.ones((), dtype=torch.float32, device=gn.device), gn
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def _update(tc: TrainConfig, p, g, state: OptState, n: str, lr, bc1=None, bc2=None):
    """Updates weight ``p`` (named ``n``) and its accumulators in place from
    its clipped f32 gradient ``g``: the one formula of ``apply_updates`` and
    ``apply_updates_slots``. ``lr`` and AdamW's bias corrections ``bc1`` /
    ``bc2`` are scalars, or broadcast over a leading slot axis."""
    if tc.optimizer == "rmsprop":
        # g2 <- d*g2 + (1-d)*g^2 ; p -= lr*g/sqrt(g2+eps)
        d = tc.rmsprop_decay
        a = state.acc1[n].mul_(d).add_((1 - d) * g * g)
        p.copy_(p.float() - lr * g / torch.sqrt(a + tc.rmsprop_eps))
        return
    b1, b2 = tc.adam_b1, tc.adam_b2
    m = state.acc1[n].mul_(b1).add_((1 - b1) * g)
    v = state.acc2[n].mul_(b2).add_((1 - b2) * g * g)
    pf = p.float()
    step_ = lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
    if tc.weight_decay:
        step_ = step_ + lr * tc.weight_decay * pf
    p.copy_(pf - step_)


@torch.no_grad()
def apply_updates(tc: TrainConfig, params, grads: dict, state: OptState, lr=None,
                  grad_clip=None, warmup_steps=None):
    """Returns (params, new_state, grad_norm); ``params`` and the state's
    accumulators are updated in place. ``lr``, ``grad_clip`` and
    ``warmup_steps`` override their config twins."""
    named = _named(params)
    scale, gnorm = _clip_by_global_norm(
        grads, tc.grad_clip if grad_clip is None else grad_clip)
    lr = learning_rate(tc, state.step, base=lr, warmup=warmup_steps)
    if tc.optimizer == "rmsprop":
        for n, p in named.items():
            _update(tc, p, grads[n].float() * scale, state, n, lr)
        return params, OptState(state.step + 1, state.acc1, None), gnorm
    if tc.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    t = state.step + 1
    bc1 = 1 - torch.pow(_scalar(tc.adam_b1, t.device), t)
    bc2 = 1 - torch.pow(_scalar(tc.adam_b2, t.device), t)
    for n, p in named.items():
        _update(tc, p, grads[n].float() * scale, state, n, lr, bc1, bc2)
    return params, OptState(t, state.acc1, state.acc2), gnorm


@torch.no_grad()
def apply_updates_slots(tc: TrainConfig, params: dict, grads: dict, state: OptState, lr,
                        grad_clip=None, warmup_steps=None):
    """``apply_updates`` over S trials at once, as the reference's under
    ``jax.vmap``: every weight, gradient and accumulator carries a leading
    slot axis, ``state.step`` is ``(S,)`` and ``lr`` an ``(S,)`` tensor;
    ``grad_clip`` and ``warmup_steps`` (``(S,)`` tensors, or None for their
    config twins) are each slot's own, and AdamW's bias correction is taken
    at each slot's own step. Each slot's gradients are clipped by that
    slot's own global norm (a norm over the whole stack would tie each
    trial's step to the others'). Returns (params, new_state, grad_norm
    ``(S,)``); ``params`` and the accumulators are updated in place."""
    if tc.optimizer not in ("rmsprop", "adamw"):
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    s = lr.shape[0]

    def per_slot(v, like):
        return v.view((s,) + (1,) * (like.dim() - 1))

    gn = torch.sqrt(torch.stack([torch.sum(torch.square(g.float()).reshape(s, -1), 1)
                                 for g in grads.values()]).sum(0))
    max_norm = tc.grad_clip if grad_clip is None else grad_clip
    if isinstance(max_norm, torch.Tensor) or max_norm:
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    else:
        scale = torch.ones_like(gn)
    lr = learning_rate(tc, state.step, base=lr, warmup=warmup_steps)
    if tc.optimizer == "rmsprop":
        for n, p in params.items():
            _update(tc, p, grads[n].float() * per_slot(scale, p), state, n, per_slot(lr, p))
        return params, state._replace(step=state.step + 1), gn
    t = state.step + 1
    bc1 = 1 - torch.pow(_scalar(tc.adam_b1, t.device), t)
    bc2 = 1 - torch.pow(_scalar(tc.adam_b2, t.device), t)
    for n, p in params.items():
        _update(tc, p, grads[n].float() * per_slot(scale, p), state, n, per_slot(lr, p),
                per_slot(bc1, p), per_slot(bc2, p))
    return params, OptState(t, state.acc1, state.acc2), gn
