"""LM training entry point for the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 10 --batch 4 --seq 512

Runs on the GPU; ``--device cpu --reduced`` runs the plain PyTorch path at
the smoke-test size. An encoder-decoder (``--arch whisper-large-v3``) trains
on the pipeline's frame embeddings beside the tokens. The port trains on one
card: ``--data-parallel`` and ``--model-parallel`` above 1 raise.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.data_parallel * args.model_parallel > 1:
        raise NotImplementedError("data or model parallelism is not ported: "
                                  "the port trains on one card")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    tc = TrainConfig(learning_rate=args.lr, optimizer=args.optimizer)
    trainer = Trainer(cfg, tc, args.batch, args.seq, seed=args.seed, device=args.device)
    n_params = sum(p.numel() for p in trainer.params.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq}")
    t0 = time.time()
    final = trainer.run(args.steps, log_every=max(1, args.steps // 20))
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt/args.steps*1e3:.0f} ms/step); "
          f"loss {trainer.losses[0]:.4f} -> {final:.4f}")
    if args.checkpoint:
        from repro_torch.checkpoint import checkpointer
        checkpointer.save(args.checkpoint, trainer.params,
                          {"arch": cfg.name, "steps": trainer.step_count})
        print(f"checkpoint written to {args.checkpoint}")


if __name__ == "__main__":
    main()
