"""One config's AdamW steps from the same weights and batches on two devices,
step by step.

  PYTHONPATH=src python -m repro_torch.launch.train_devices \\
      --arch starcoder2-3b --layers 2 --dtype float32 --steps 10 \\
      --batch 4 --seq 512 --lr 3e-4

The weights are drawn on the CPU from seed 0 and copied to each device
of ``--devices`` (default ``cuda,cpu``); every device trains on the same
seeded bigram batches through ``Trainer``. On the card the forward runs the
port's kernels, on the CPU their plain versions, and both take the plain
version's gradient, so their loss curves agree to rounding: a rise or fall
that both show belongs to the config and its learning rate, not to the
kernels. Prints each step's loss and grad norm as it runs, then one JSON
line: each device's losses and seconds, and the largest difference from
the first device's loss at each step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: as published)")
    ap.add_argument("--dtype", default="", help="the weights' dtype (default: the config's)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--devices", default="cuda,cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    tc = TrainConfig(optimizer="adamw", learning_rate=args.lr)
    devices = args.devices.split(",")
    trainers = [Trainer(cfg, tc, args.batch, args.seq, seed=0, device=d, init_device="cpu")
                for d in devices]
    seconds = []
    for tr in trainers:
        t0 = time.perf_counter()
        tr.run(args.steps, log_every=1)
        seconds.append(time.perf_counter() - t0)
    first = trainers[0].losses
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": args.batch, "seq": args.seq, "lr": args.lr, "steps": args.steps,
           "runs": [{"device": d, "losses": tr.losses, "seconds": s}
                    for d, tr, s in zip(devices, trainers, seconds)],
           "max_abs_diff_by_step": [max(abs(tr.losses[i] - first[i]) for tr in trainers)
                                    for i in range(args.steps)]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
