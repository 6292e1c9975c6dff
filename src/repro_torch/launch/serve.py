"""Batched serving driver for the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --requests 8 --batch 4 --prompt-len 512 --max-new 16 --max-seq 1024

Runs on the GPU; ``--device cpu`` runs the plain PyTorch path (use
``--reduced`` there). Returns the served requests. As the reference's
engine, it feeds prompts only: an encoder-decoder (``--arch
whisper-large-v3``) runs no encoder, and its cross attention reads the
cache's zeros.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    engine = ServingEngine(cfg, params, args.batch, args.max_seq, device=dev)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        engine.submit(Request(i, rng.integers(0, cfg.vocab_size, size=args.prompt_len),
                              max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = engine.run_batch()       # ends in a device-to-host copy of the tokens
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in done)
    print(f"arch={cfg.name} device={dev}: served {len(done)} requests, "
          f"{total_new} tokens in {dt:.3f}s ({total_new / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.request_id}: {r.output[:8]}...")
    return done


if __name__ == "__main__":
    main()
