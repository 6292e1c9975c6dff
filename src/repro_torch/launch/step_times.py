"""Repeated timings of one model's serving steps on the card.

  PYTHONPATH=src python -m repro_torch.launch.step_times \\
      --arch jamba-v0.1-52b --layers 8 --repeats 5

Serves the requests of ``chip_smoke.py``'s phase 3 (8 requests, batch 4,
prompt 512, 16 new tokens, max_seq 1024, seed-0 weights) and prints one JSON
line with, for each of ``--repeats`` rounds:

- ``decode_ms``: decode ms a step, CUDA events over 16 steps
  after two warm-up steps (phase 3's reading);
- ``tokens_per_s``: served tokens/s of ``ServingEngine.run_batch`` (host
  clock);
- ``host_enqueue_ms``: the host's time to issue one decode step onto an
  idle card (host clock, no sync inside the step), the median of
  16 steps;

and, from one profiled run of 16 decode steps, the host's self
CPU time and the device's busy time per step (the profiler's own cost is
in the first). Medians of each list are printed beside it.

It calls only the port's entry points, so the same file times another
checkout: ``PYTHONPATH=<checkout>/src python <this file> ...``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_cache
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.train.steps import make_prefill_step, make_serve_step

# chip_smoke.py's phase 3: requests, batch, prompt and new tokens, max_seq
N_REQ, BATCH, PROMPT, NEW, MAX_SEQ = 8, 4, 512, 16, 1024


def _decode_profile(one_decode, steps):
    """Host self CPU ms and device busy ms per decode step, one profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one_decode()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sum(a.self_cpu_time_total for a in events if a.device_type == DeviceType.CPU)
    device = sum(a.self_device_time_total for a in events if a.device_type == DeviceType.CUDA)
    return host / 1e3 / steps, device / 1e3 / steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--layers", type=int, default=0, help="cut to this many layers (0: all)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--label", default="", help="copied into the output line")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")        # a timing of the card: no CPU path
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServingEngine(cfg, params, BATCH, MAX_SEQ, device=dev)

    def serve():
        rng = np.random.default_rng(0)
        for i in range(N_REQ):
            engine.submit(Request(i, rng.integers(0, cfg.vocab_size, size=PROMPT),
                                  max_new_tokens=NEW))
        engine.done.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run_batch()       # ends in a device-to-host copy of the tokens
        torch.cuda.synchronize()
        return sum(len(r.output) for r in done) / (time.perf_counter() - t0)

    decode = make_serve_step(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT))).to(dev)
    cache = init_cache(cfg, BATCH, MAX_SEQ, device=dev)
    make_prefill_step(cfg)(params, {"tokens": tokens}, cache)
    tok = tokens[:, -1:]
    pos = [PROMPT]

    def one_decode():
        decode(params, cache, tok, pos[0])
        pos[0] += 1

    def decode_ms():
        pos[0] = PROMPT
        for _ in range(2):
            one_decode()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(NEW):
            one_decode()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / NEW

    def host_enqueue_ms():
        pos[0] = PROMPT
        times = []
        for _ in range(NEW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_decode()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    serve()                             # warm-up: kernel builds, allocator, cuBLAS plans
    rounds = {"decode_ms": [], "tokens_per_s": [], "host_enqueue_ms": []}
    for _ in range(args.repeats):
        rounds["tokens_per_s"].append(serve())
        rounds["decode_ms"].append(decode_ms())
        rounds["host_enqueue_ms"].append(host_enqueue_ms())
    pos[0] = PROMPT
    host_ms, device_ms = _decode_profile(one_decode, NEW)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"label": args.label, "arch": cfg.name, "n_layers": cfg.n_layers,
           **rounds, **{f"median_{k}": statistics.median(v) for k, v in rounds.items()},
           "profiled_host_self_cpu_ms_per_step": host_ms,
           "profiled_device_busy_ms_per_step": device_ms,
           "device": smi.strip().splitlines()[0] if smi.strip() else None}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
