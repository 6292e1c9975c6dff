"""Train, prefill and serve steps (port of ``repro/train/steps.py``).

The LM loss chunks over the sequence so that (B, S, V) logits are made one
chunk at a time. ``make_train_step`` differentiates ``lm_loss + aux`` with
``torch.autograd.grad`` and applies the optimizer to the weights in place.
``lm_loss_slots`` is the loss of S trials at once, one mean a slot.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.layers import norm, norm_slots
from repro_torch.models.model import forward, logits_fn
from repro_torch.optim.optimizers import OptState, apply_updates


def _xent_chunk(cfg: ModelConfig, params, h, labels):
    """h: (B, C, D), labels: (B, C) -> summed xent (f32 scalar)."""
    return _xent(cfg, (h @ params["unembed"]).float(), labels).sum()


def _xent(cfg: ModelConfig, logits, labels):
    """f32 logits (..., V) and labels (...) -> the xent of each position."""
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    vpad = logits.shape[-1]
    if vpad != cfg.vocab_size:      # mask vocab-padding columns
        cols = torch.arange(vpad, device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - gold


def lm_loss(cfg: ModelConfig, params, hidden, labels, chunk: int = 1024):
    """Chunked cross-entropy, the mean over tokens. hidden: (B, S, D) before
    the final norm; labels: (B, S) int. Whole chunks of ``chunk`` positions,
    then the rest."""
    h = norm(cfg, params, hidden, prefix="final_norm")
    B, S, _ = h.shape
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        tot = tot + _xent_chunk(cfg, params, h[:, c0:c0 + chunk],
                                labels[:, c0:c0 + chunk])
    return tot / (B * S)


def lm_loss_slots(cfg: ModelConfig, params, hidden, labels, chunk: int = 1024):
    """``lm_loss`` of S trials: each slot's own chunked mean, (S,) f32.
    hidden: (S, B*T, D) before the final norm (``forward_slots``); labels:
    (S, B, T); each weight with a leading slot axis. The slots' losses are
    independent, so the gradient of their sum is each slot's own."""
    S, B, T = labels.shape
    h = norm_slots(cfg, params, hidden, prefix="final_norm").view(S, B, T, -1)
    chunk = min(chunk, T)
    tot = torch.zeros(S, dtype=torch.float32, device=h.device)
    for c0 in range(0, T, chunk):
        hc = h[:, :, c0:c0 + chunk]
        logits = torch.bmm(hc.reshape(S, -1, hc.shape[-1]), params["unembed"]).float()
        tot = tot + _xent(cfg, logits, labels[:, :, c0:c0 + chunk].reshape(S, -1)).sum(1)
    return tot / (B * T)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch`` is ``DataPipeline``'s: ``tokens`` and ``labels``, and for an
    encoder-decoder ``enc_embeds``, on which ``forward`` runs the encoder
    once, outside ``remat``'s checkpoints (the reference's ``encode`` runs
    outside its checkpointed scan body too). ``params`` (``ModelParams``)
    are updated in place and returned; every weight is made to require a
    gradient. ``metrics`` holds ``loss``, ``aux_loss`` and ``grad_norm`` as
    scalars on the device: the step never waits on the host for them. The
    optimizer runs in the profiler range ``optimizer``."""

    def loss_fn(params, batch):
        h, _, aux = forward(cfg, params, batch, mode="train", remat=tc.remat)
        loss = lm_loss(cfg, params, h, batch["labels"], tc.loss_chunk)
        return loss + aux, (loss, aux)

    def train_step(params, opt_state: OptState, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        total, (loss, aux) = loss_fn(params, batch)
        grads = torch.autograd.grad(total, list(named.values()), materialize_grads=True)
        del total
        with torch.profiler.record_function("optimizer"):
            params, opt_state, gnorm = apply_updates(
                tc, params, dict(zip(named, grads)), opt_state)
        metrics = {"loss": loss.detach(), "aux_loss": aux.detach(), "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch, cache) -> (next_token_logits (B, V), cache). The batch
    is ``forward``'s: ``tokens``, and for an encoder-decoder ``enc_embeds``
    (B, enc_seq, d_model), which runs the encoder and fills ``ck`` / ``cv``."""

    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        h, cache, _ = forward(cfg, params, batch, mode="prefill", cache=cache)
        return logits_fn(cfg, params, h[:, -1:])[:, 0], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, token (B, 1), pos) -> (logits, cache)."""

    @torch.inference_mode()
    def serve_step(params, cache, token, pos: int):
        h, cache, _ = forward(cfg, params, {"tokens": token}, mode="decode",
                              pos=pos, cache=cache)
        return logits_fn(cfg, params, h)[:, 0], cache

    return serve_step
