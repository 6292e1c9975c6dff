"""Model assembly: embed -> n_repeat x pattern of blocks -> final norm (+ logits).

Port of ``repro/models/model.py`` for the attention, mamba, MLP and MoE
blocks and the encoder-decoder family (whisper: ``encode``, then cross
attention after each decoder attention block). A Python loop over the
``n_repeat`` stacked layers takes the place of ``lax.scan``; ``remat``
checkpoints each repetition as the reference's ``jax.checkpoint(body)``
does.
Modes: 'train' (full sequence, no cache), 'prefill' (full sequence, fills
the cache), 'decode' (one token against the cache).

``forward_slots`` is the train forward of S trials at once, each with its
own weights on a leading slot axis: the reference's ``forward`` under
``jax.vmap`` over a population's slots (``population/objectives/lm.py``),
for the attention, mamba, MLP and MoE blocks, with each slot's aux loss.
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (attn_block, attn_block_slots, cross_attn_block,
                                      mlp_block, mlp_block_slots, norm,
                                      sinusoidal_positions)
from repro_torch.models.moe import moe_block, moe_block_slots
from repro_torch.models.ssm import mamba_block, mamba_block_slots

INVALID_POS = 2 ** 30       # kpos of a cache slot that holds no key


def _mixer_window(cfg: ModelConfig, mixer: str) -> int:
    return cfg.window if mixer == "attn_local" else 0   # 0 = full attention


def embed_tokens(cfg: ModelConfig, params, tokens, pos: int = 0):
    """tokens (B, S) at positions pos .. pos + S - 1 -> (B, S, D)."""
    x = params["embed"][tokens].to(getattr(torch, cfg.dtype))
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    if cfg.abs_pos:
        x = x + sinusoidal_positions(tokens.shape[-1], cfg.d_model, offset=pos,
                                     dtype=x.dtype, device=x.device)
    return x


def encode(cfg: ModelConfig, params, enc_embeds):
    """Whisper's encoder: frame embeddings (B, enc_seq, D) -> encoder states,
    each layer non-causal self attention and the MLP, then
    ``enc_final_norm``."""
    x = enc_embeds.to(getattr(torch, cfg.dtype))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, dtype=x.dtype, device=x.device)
    enc = params["enc"]
    for r in range(cfg.n_enc_layers):
        x = attn_block(cfg, _layer(enc["b0_attn"], r), x, mode="train", pos=0, cache=None,
                       window=0, causal=False)
        x = mlp_block(cfg, _layer(enc["b0_mlp"], r), x)
    return norm(cfg, params, x, prefix="enc_final_norm")


def logits_fn(cfg: ModelConfig, params, hidden):
    """hidden: (B, S, D) -> (B, S, V) float32 (small S only — decode)."""
    h = norm(cfg, params, hidden, prefix="final_norm")
    logits = (h @ params["unembed"]).float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _layer(stack: dict, r: int) -> dict:
    """Layer ``r`` of a block's weights or cache, stacked over n_repeat."""
    return {n: t[r] for n, t in stack.items()}


def _apply_superblock(cfg: ModelConfig, dec: dict, r: int, x, *, mode: str,
                      pos: int, cache, enc_out=None):
    """One repetition ``r`` of the pattern -> (x, its MoE layers' aux
    losses, a list). An encoder-decoder's attention block is followed by
    its cross attention onto ``enc_out`` (or the cached encoder K/V)."""
    auxes = []
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        key = f"b{i}_{mixer}"
        p = _layer(dec[key], r)
        c = None if cache is None else _layer(cache[key], r)
        if mixer.startswith("attn"):
            x = attn_block(cfg, p, x, mode=mode, pos=pos, cache=c,
                           window=_mixer_window(cfg, mixer))
            if cfg.is_encdec:
                x = cross_attn_block(cfg, p, x, mode=mode, enc_out=enc_out, cache=c)
        elif mixer == "mamba":
            x = mamba_block(cfg, p, x, mode=mode, cache=c)
        else:
            raise NotImplementedError(f"mixer {mixer!r} is not ported")
        if ffn == "mlp":
            x = mlp_block(cfg, _layer(dec[f"b{i}_mlp"], r), x)
        elif ffn == "moe":
            x, a = moe_block(cfg, _layer(dec[f"b{i}_moe"], r), x)
            auxes.append(a)
        elif ffn:
            raise NotImplementedError(f"ffn {ffn!r} is not ported")
    return x, auxes


# 2-D matmuls: the projections, MLPs and router, not the batched attention
# products (the reference's ``dots_with_no_batch_dims_saveable``)
_SAVED_BY_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward(cfg: ModelConfig, params, batch: dict, *, mode: str = "train",
            pos: int = 0, cache=None, remat: str = "none"):
    """Returns (hidden (B, S, D), cache, aux loss); the cache is updated in
    place. In train mode the aux loss is the sum of the MoE layers'
    load-balance losses (an f32 scalar on the hidden's device, 0 without MoE
    layers). In prefill and decode it is None: their callers discard it, and
    summing it would add launches to every serving step.

    An encoder-decoder runs ``encode`` on ``batch['enc_embeds']`` where the
    batch has it, in every mode; prefill without it reads the cache's zero
    ``ck`` / ``cv``, as the reference's serving engine does, and train mode
    without it raises.

    ``remat`` (train mode): 'none' keeps every activation for the backward;
    'full' recomputes each repetition of the pattern in the backward
    (``torch.utils.checkpoint``), 'dots' keeps its 2-D matmul outputs and
    recomputes the rest. A recomputed repetition launches its kernels again.
    """
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    enc_out = None
    if cfg.is_encdec:
        if "enc_embeds" in batch:
            enc_out = encode(cfg, params, batch["enc_embeds"])
        elif mode == "train" or cache is None:
            raise ValueError(f"{cfg.name}: train mode (or a forward without a cache) needs "
                             "the encoder's input, batch['enc_embeds'] (B, enc_seq, d_model)")
    x = embed_tokens(cfg, params, batch["tokens"], pos=pos)
    dec = params["dec"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device) if mode == "train" else None
    for r in range(cfg.n_repeat):
        body = partial(_apply_superblock, cfg, dec, r, mode=mode, pos=pos, cache=cache,
                       enc_out=enc_out)
        if remat == "none" or cache is not None or not torch.is_grad_enabled():
            x, auxes = body(x)
        elif remat == "full":
            x, auxes = checkpoint(body, x, use_reentrant=False)
        else:
            x, auxes = checkpoint(body, x, use_reentrant=False,
                                  context_fn=partial(create_selective_checkpoint_contexts,
                                                     _save_dots))
        if aux is not None:
            aux = _add_aux(aux, auxes)
    return x, cache, aux


def _add_aux(aux, auxes):
    """``aux`` plus one repetition's MoE aux losses: the repetition's sum
    first, then the total (the reference's order)."""
    if not auxes:
        return aux
    part = auxes[0]
    for a in auxes[1:]:
        part = part + a
    return aux + part


def nest_params(named: dict) -> dict:
    """Weights by ``ModelParams`` name (``dec.b0_attn.wq``) as the nested
    layout the model reads (``params["dec"]["b0_attn"]["wq"]``)."""
    out: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def embed_tokens_slots(cfg: ModelConfig, params, tokens):
    """tokens (S, B, T) -> (S, B*T, D), each slot's rows of its own table."""
    S, V = params["embed"].shape[:2]
    rows = tokens.reshape(S, -1) + (torch.arange(S, device=tokens.device) * V)[:, None]
    x = params["embed"].reshape(S * V, -1)[rows].to(getattr(torch, cfg.dtype))
    if cfg.scale_embed:
        x = x * math.sqrt(cfg.d_model)
    if cfg.abs_pos:
        raise NotImplementedError("absolute positions are not ported to the slot axis")
    return x


def forward_slots(cfg: ModelConfig, params, tokens):
    """The train forward of S trials: ``params`` nested as ``forward``'s,
    every weight with a leading slot axis; tokens (S, B, T). Returns the
    hidden (S, B*T, D) before the final norm and each slot's aux loss (S,)
    f32: the sum of its MoE layers' load-balance losses in ``forward``'s
    order, zeros without MoE layers."""
    batch = tokens.shape[1]
    x = embed_tokens_slots(cfg, params, tokens)
    dec = params["dec"]
    aux = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for r in range(cfg.n_repeat):
        auxes = []
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            p = {n: t[:, r] for n, t in dec[f"b{i}_{mixer}"].items()}
            if mixer.startswith("attn"):
                x = attn_block_slots(cfg, p, x, batch=batch, window=_mixer_window(cfg, mixer))
            elif mixer == "mamba":
                x = mamba_block_slots(cfg, p, x, batch=batch)
            else:
                raise NotImplementedError(f"mixer {mixer!r} is not ported")
            if ffn == "mlp":
                x = mlp_block_slots(cfg, {n: t[:, r] for n, t in dec[f"b{i}_mlp"].items()}, x)
            elif ffn == "moe":
                x, a = moe_block_slots(cfg, {n: t[:, r] for n, t in dec[f"b{i}_moe"].items()}, x)
                auxes.append(a)
            elif ffn:
                raise NotImplementedError(f"ffn {ffn!r} is not ported")
        aux = _add_aux(aux, auxes)
    return x, aux


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *,
               device="cuda"):
    """Zero K/V and invalid kpos for every attention block (and zero
    encoder K/V, ``ck`` / ``cv`` (R, B, enc_seq, Hkv, hd), for an
    encoder-decoder's), zero conv window and f32 SSM state for every mamba
    block, stacked over n_repeat."""
    dev = resolve_device(device)
    R, B = cfg.n_repeat, batch_size
    dt = getattr(torch, cfg.dtype)
    cache = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer.startswith("attn"):
            w = _mixer_window(cfg, mixer)
            L = min(max_seq, w) if w else max_seq
            ent = {
                "k": torch.zeros((R, B, L, cfg.n_kv_heads, cfg.head_dim), dtype=dt, device=dev),
                "v": torch.zeros((R, B, L, cfg.n_kv_heads, cfg.head_dim), dtype=dt, device=dev),
                "kpos": torch.full((R, L), INVALID_POS, dtype=torch.int32, device=dev)}
            if cfg.is_encdec:
                for n in ("ck", "cv"):
                    ent[n] = torch.zeros((R, B, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim),
                                         dtype=dt, device=dev)
        elif mixer == "mamba":
            di = cfg.ssm_d_inner
            ent = {
                "conv": torch.zeros((R, B, cfg.ssm_conv - 1, di), dtype=dt, device=dev),
                "ssm": torch.zeros((R, B, di, cfg.ssm_d_state), dtype=torch.float32,
                                   device=dev)}
        else:
            raise NotImplementedError(f"mixer {mixer!r} is not ported")
        cache[f"b{i}_{mixer}"] = ent
    return cache
