"""LM Trainer: config -> params -> data -> train step (port of
``repro/train/trainer.py``).

Used by ``launch/train.py`` and the LM objective of a tuning search.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.synthetic import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models.schema import init_params
from repro_torch.optim.optimizers import init_opt_state
from repro_torch.train.steps import make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, batch: int, seq: int,
                 seed: int = 0, device="cuda", init_device=None):
        """``init_device``: where the weights are drawn (default ``device``),
        then copied to ``device``; each device's generator draws its own
        weights, so two runs that must start alike draw on one of them."""
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        init_dev = self.device if init_device is None else resolve_device(init_device)
        gen = torch.Generator(device=init_dev).manual_seed(seed)
        self.params = init_params(cfg, gen, device=init_dev).to(self.device)
        self.opt_state = init_opt_state(tc, self.params)
        self.data = DataPipeline(cfg, batch, seq, seed=seed, device=self.device)
        self._step = make_train_step(cfg, tc)
        self.step_count = 0
        self.losses: list = []

    def run(self, steps: int, log_every: int = 0) -> float:
        """Run ``steps`` updates; returns the mean loss of the last quarter."""
        it = iter(self.data)
        for i in range(steps):
            batch = next(it)
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            self.losses.append(loss)
            self.step_count += 1
            if log_every and (i + 1) % log_every == 0:
                print(f"step {self.step_count:5d}  loss {loss:.4f}  "
                      f"grad_norm {float(metrics['grad_norm']):.3f}", flush=True)
        tail = self.losses[-max(1, steps // 4):]
        return sum(tail) / len(tail)


def make_lm_objective(arch: str, steps_per_phase: int = 30, batch: int = 8,
                      seq: int = 64, seed: int = 0, device="cuda", init_device=None):
    """A tuning objective over a reduced-config LM: metric = -loss (higher is
    better, the search service's convention). ``loss_chunk`` among the
    hyperparameters makes a trial's cost depend on its config. Each trial's
    ``Trainer`` draws its weights on ``init_device`` (default ``device``)."""
    from repro_torch.configs.registry import get_config

    def objective(hparams: dict, phase: int, state):
        if state is None:
            cfg = get_config(arch).reduced()
            tc = TrainConfig(
                learning_rate=float(hparams.get("learning_rate", 3e-4)),
                optimizer=str(hparams.get("optimizer", "adamw")),
                grad_clip=float(hparams.get("grad_clip", 1.0)),
                warmup_steps=int(hparams.get("warmup_steps", 0)),
                loss_chunk=int(hparams.get("loss_chunk", 1024)))
            state = Trainer(cfg, tc, batch, seq, seed=seed, device=device,
                            init_device=init_device)
        mean_loss = state.run(steps_per_phase)
        return -mean_loss, state

    return objective
