"""LM training trials as a ``PopulationObjective`` (port of
``repro/population/objectives/lm.py``).

Per-trial learning rate, gradient-clip norm and warmup ride the slot axis
as ``(S,)`` tensors into one AdamW update of every slot of a bucket over a
``configs.registry`` model's ``reduced()`` config: one forward
(``models.model.forward_slots``), one loss (``train.steps.lm_loss_slots``:
each slot's own mean, summed, so each slot gets its own gradient) and one
``optim.apply_updates_slots`` (each slot clipped by its own norm, warmed up
and bias-corrected at its own step). Each slot's gradient is that of its
loss plus its MoE aux loss (zero without MoE layers), as the reference's
``loss_fn`` returns ``loss + aux``; its metric stays ``-loss``. On the card
the slots' RMSNorms are the kernel's slot case (one scale row a slot),
their attention one flash call over every slot's sequences, a mamba
block's scan one call of the scan kernel's slot case (each slot's own A and
D) and a MoE block's three expert products one grouped matmul each over
the slots' (slot, expert) groups.

* traced:      ``learning_rate``, ``grad_clip``, ``warmup_steps``;
* structural:  ``loss_chunk``: the bucket key is the *effective* chunk
  ``min(loss_chunk, seq)``, so chunk sizes the sequence truncates to the
  same loss share one bucket (at the reference's seq 32 every chunk of
  ``lm_space`` does);
* learner:     ``(params, opt_state)``: the weights by ``ModelParams``
  name, each ``(S, ...)``, and the AdamW state;
* carry:       ``(n, loss_sum, generator)``: updates taken, their summed
  ``-loss`` (the phase metric is mean ``-loss``, higher is better, as
  ``train.trainer.make_lm_objective``'s), and the trial's own
  ``torch.Generator``, which draws its weights and then every update's
  data draws (``lm_draws``);
* cost:        ``batch * seq`` tokens per update per slot.

Data is the seeded bigram chain of ``data.synthetic.BigramStream``: the
table (the reference's exact values from ``data_seed``) is shared by every
slot, each slot draws its chains' starts and successor choices from its
generator, and ``bigram_chain`` walks the table for all slots at once.

``make_step`` is one path at every capacity: the reference's capacity-1
squeeze exists for GA3C's parity with its thread backend, and the LM
objective has no thread twin (its data and shape differ from
``make_lm_objective``'s).
"""
from __future__ import annotations

from typing import Any, Dict, Hashable

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import forward_slots, nest_params
from repro_torch.models.schema import init_params
from repro_torch.optim.optimizers import apply_updates_slots, init_opt_state
from repro_torch.population.objectives import LM_SPEC, HparamSpec, PopulationObjective
from repro_torch.train.steps import lm_loss_slots

BRANCH = 8      # successors a token in the bigram table (BigramStream's)


def lm_draws(gen: torch.Generator, batch: int, seq: int, vocab: int):
    """One update's draws of one trial from its generator, on the
    generator's device: the chains' first tokens ``(batch,)`` and each
    step's successor choices ``(seq, batch)``, the draws of the
    reference's ``_bigram_chain``."""
    start = torch.randint(0, vocab, (batch,), generator=gen, device=gen.device)
    choice = torch.randint(0, BRANCH, (seq, batch), generator=gen, device=gen.device)
    return start, choice


def bigram_chain(table: torch.Tensor, start: torch.Tensor, choice: torch.Tensor):
    """(S, batch, seq + 1) tokens of S slots' chains: ``start`` (S, batch),
    ``choice`` (S, seq, batch); the walk of the reference's
    ``_bigram_chain`` for every slot at once."""
    tok, toks = start, [start]
    for t in range(choice.shape[1]):
        tok = table[tok, choice[:, t]]
        toks.append(tok)
    return torch.stack(toks, -1)


class LMObjective(PopulationObjective):
    name = "lm"

    def __init__(self, arch: str = "yi-9b", batch: int = 2, seq: int = 32,
                 data_seed: int = 0, device="cuda", init_device=None):
        """``init_device``: where each trial's generator lives, drawing its
        weights and data (default ``device``), copied to ``device``; two
        objectives on two devices with one ``init_device`` train alike."""
        from repro_torch.configs.registry import get_config
        self.arch = arch
        self.batch = batch
        self.seq = seq
        self.data_seed = data_seed
        self.device = resolve_device(device)
        self.init_device = self.device if init_device is None else resolve_device(init_device)
        self.cfg = get_config(arch).reduced()
        # lr / clip / warmup are each slot's own inside the step; the config
        # values are only the (unused) defaults
        self.tc = TrainConfig(optimizer="adamw")
        rng = np.random.default_rng(data_seed)
        self.table = torch.from_numpy(
            rng.integers(0, self.cfg.vocab_size, size=(self.cfg.vocab_size, BRANCH))
            .astype(np.int64)).to(self.device)

    @classmethod
    def hparam_spec(cls) -> HparamSpec:
        return LM_SPEC

    def bucket_key(self, hparams: Dict[str, Any]) -> int:
        return min(int(hparams.get("loss_chunk", 1024)), self.seq)

    def cache_key(self) -> Hashable:
        return ("lm", self.arch, self.batch, self.seq, self.data_seed)

    def init_slot_state(self, seed: int, hparams: Dict[str, Any]):
        gen = torch.Generator(device=self.init_device).manual_seed(seed)
        params = init_params(self.cfg, gen, device=self.init_device).to(self.device)
        named = {n: p.detach() for n, p in params.named_parameters()}
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return (named, init_opt_state(self.tc, named)), (zero, zero.clone(), gen)

    def make_step(self, structural: Hashable, capacity: int):
        cfg, tc, table, dev = self.cfg, self.tc, self.table, self.device
        batch, seq, chunk = self.batch, self.seq, int(structural)

        def step(learner, carry, lr, grad_clip, warmup_steps):
            (params, opt), (n, loss_sum, gens) = learner, carry
            starts, choices = zip(*(lm_draws(g, batch, seq, cfg.vocab_size) for g in gens))
            chain = bigram_chain(table, torch.stack(starts).to(dev), torch.stack(choices).to(dev))
            # the slots' weights as autograd leaves on the same memory: the
            # update writes them in place
            trainable = {k: v.detach().requires_grad_() for k, v in params.items()}
            tree = nest_params(trainable)
            hidden, aux = forward_slots(cfg, tree, chain[..., :-1])
            loss = lm_loss_slots(cfg, tree, hidden, chain[..., 1:], chunk)
            grads = torch.autograd.grad((loss + aux).sum(), list(trainable.values()))
            _, opt, _ = apply_updates_slots(tc, trainable, dict(zip(trainable, grads)), opt, lr,
                                            grad_clip=grad_clip, warmup_steps=warmup_steps)
            return (params, opt), (n + 1, loss_sum - loss.detach(), gens)
        return step

    def progress(self, carry):
        return carry[0], carry[1]

    def update_cost(self, structural: Hashable) -> int:
        return self.batch * self.seq
