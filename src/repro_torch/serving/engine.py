"""Batched serving engine: batched prefill + lockstep greedy decode.

Port of ``repro/serving/engine.py``. Requests with the same (prompt length,
max_new_tokens) are served together in groups of ``batch_size``; a short
group is padded with zero prompts. Each group gets a fresh cache, one
prefill and ``max_new_tokens`` decode steps. Tokens stay on the device until
the group is done, so decode never waits on the host. ``_run_one`` serves
one request alone in a batch of one, as the reference's single-request
path does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import init_cache
from repro_torch.train.steps import make_prefill_step, make_serve_step


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray           # (S,) int
    max_new_tokens: int = 16
    output: list = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 max_seq: int, device="cuda"):
        self.device = resolve_device(device)
        wdev = params["embed"].device
        if wdev.type != self.device.type:
            raise ValueError(f"params live on {wdev}, engine device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_size
        self.max_seq = max_seq
        self._prefill = make_prefill_step(cfg)
        self._decode = make_serve_step(cfg)
        self.queue: List[Request] = []
        self.done: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _run_one(self, req: Request):
        """Single-request path: a batch of one with its own cache."""
        req.output.extend(self._generate(np.asarray(req.prompt)[None], req.max_new_tokens)[0])
        req.done = True
        return req

    def run_batch(self):
        """Drain the queue: batched prefill + lockstep decode per group."""
        by_len: dict = {}
        for r in self.queue:
            by_len.setdefault((len(r.prompt), r.max_new_tokens), []).append(r)
        self.queue.clear()
        for (plen, mnt), group in by_len.items():
            for i in range(0, len(group), self.B):
                self._run_group(group[i:i + self.B], plen, mnt)
        return self.done

    def _run_group(self, reqs: List[Request], plen: int, mnt: int):
        prompts = np.zeros((self.B, plen), np.int64)
        prompts[:len(reqs)] = np.stack([r.prompt for r in reqs])
        out = self._generate(prompts, mnt)
        for j, r in enumerate(reqs):
            r.output.extend(out[j])
            r.done = True
            self.done.append(r)

    def _generate(self, prompts: np.ndarray, mnt: int) -> list:
        """Greedy tokens, a list for each row of ``prompts`` (B, plen): one
        prefill and ``mnt`` decode steps on a fresh cache of B rows."""
        tokens = torch.from_numpy(prompts.astype(np.int64)).to(self.device)
        cache = init_cache(self.cfg, prompts.shape[0], self.max_seq, device=self.device)
        logits, cache = self._prefill(self.params, {"tokens": tokens}, cache)
        pos = prompts.shape[1]
        tok = logits.argmax(-1, keepdim=True)
        emitted = []
        for _ in range(mnt):
            emitted.append(tok)
            logits, cache = self._decode(self.params, cache, tok, pos)
            tok = logits.argmax(-1, keepdim=True)
            pos += 1
        return torch.cat(emitted, 1).tolist() if emitted else [[] for _ in prompts]
