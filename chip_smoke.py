#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:
  0. device: a CUDA card must be present; prints its name and power limit;
  1. build: compiles the port's CUDA kernels from the repository's sources;
  2. kernels vs plain versions on the card, on seeded inputs, each case
     printed with its max abs error and tolerance; plus a reduced gemma2-2b
     served on the card (kernels) and on the CPU (plain path), which must
     agree;
  3. serve: full-width gemma2-2b (26 layers, bf16, seed-0 weights) through
     ``ServingEngine``: 8 requests, batch 4, prompt 512, 16 new tokens,
     max_seq 1024. Every RMSNorm and attention must have gone through the
     kernels (launch counts 53 and 26 per forward);
     Prints prefill ms, decode ms per step and tokens/s, and a profile of
     one prefill and one decode step (device busy share, top kernels);
  4. times at the serving shapes, after warm-up: each kernel's, its plain
     version's and the library call's device time per call (the summed
     kernel time under the profiler), the kernel's CUDA-event time per call
     of back-to-back launches (host launch cost included), and its bound.
The last two lines are the kernels' JSON line and the result line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ARCH, N_REQ, BATCH, PROMPT, NEW, MAX_SEQ = "gemma2-2b", 8, 4, 512, 16, 1024
INVALID = 2 ** 30


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof):
    """The profiler's device-side events (kernels, copies, sets)."""
    from torch.autograd import DeviceType
    kern = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    assert kern, "the profiler saw no device time"
    return kern


def device_ms(fn, iters=20, warmup=3):
    """Device time per call: the summed time of the kernels ``fn`` launches,
    without the host's launch gaps (which CUDA events around back-to-back
    launches of a small kernel would measure instead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(a.self_device_time_total for a in device_kernels(prof)) / 1e3 / iters


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models.model import init_cache
    from repro_torch.models.schema import init_params
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    # -- 0. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    # -- 2. kernels vs plain versions ----------------------------------------
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dev, dtype)

    err = {"rmsnorm": 0.0, "flash_attention": 0.0}

    def check(name, label, out, ref, tol):
        e = (out.float() - ref.float()).abs().max().item()
        ok = math.isfinite(e) and e <= tol
        log(f"[kernel] {name} {label}: max_abs_err {e:.3e} tol {tol:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, f"{name} {label}: {e} > {tol}"
        err[name] = max(err[name], e)

    for shape in [(2048, 2304), (4, 2304), (3, 77, 2304)]:
        for dt in (torch.bfloat16, torch.float32):
            x = t(*shape, dtype=dt)
            sc = (t(shape[-1]) + 1.0).to(dt)
            tol = 5e-2 if dt == torch.bfloat16 else 1e-5
            check("rmsnorm", f"{shape} {dt}", rmsnorm(x, sc), rmsnorm_ref(x, sc), tol)
    # the last position of a prefill, as logits_fn sees it: rows S*D apart
    x = t(4, 512, 2304, dtype=torch.bfloat16)[:, -1:]
    sc = (t(2304) + 1.0).to(torch.bfloat16)
    check("rmsnorm", "(4, 512, 2304)[:, -1:] bf16", rmsnorm(x, sc), rmsnorm_ref(x, sc), 5e-2)

    def flash_case(label, B, Hq, Hkv, Sq, Skv, hd, causal, window, cap, dt,
                   q_offset, kv_pos=None):
        q, k, v = t(B, Sq, Hq, hd, dtype=dt), t(B, Skv, Hkv, hd, dtype=dt), \
            t(B, Skv, Hkv, hd, dtype=dt)
        kp = None if kv_pos is None else torch.as_tensor(kv_pos, dtype=torch.int32,
                                                         device=dev)
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                              q_offset=q_offset, kv_pos=kp)
        ref = chunked_attention(q, k, v, causal=causal, window=window, softcap=cap,
                                q_offset=q_offset, kv_positions=kp)
        check("flash_attention", label, out, ref,
              2e-2 if dt == torch.bfloat16 else 1e-4)

    # the case list of tests/test_kernels.py (FLASH_CASES)
    for (B, Hq, Hkv, Sq, Skv, hd, causal, window, cap, dt) in [
            (2, 4, 2, 64, 64, 32, True, 0, 0.0, torch.float32),
            (1, 8, 8, 128, 128, 64, True, 0, 0.0, torch.float32),
            (2, 4, 1, 96, 96, 32, True, 32, 0.0, torch.float32),
            (1, 4, 2, 64, 64, 32, True, 0, 50.0, torch.float32),
            (1, 2, 2, 80, 208, 16, False, 0, 0.0, torch.float32),
            (2, 4, 2, 64, 64, 32, True, 0, 0.0, torch.bfloat16),
            (1, 2, 1, 33, 65, 32, True, 0, 0.0, torch.float32)]:
        flash_case(f"B{B} Hq{Hq} Hkv{Hkv} {Sq}x{Skv} hd{hd} causal={causal} "
                   f"w{window} cap{cap} {dt}", B, Hq, Hkv, Sq, Skv, hd, causal,
                   window, cap, dt, Skv - Sq if causal else 0)
    # the serving shapes: prefill of a local and a global layer
    for window in (4096, 0):
        for dt in (torch.bfloat16, torch.float32):
            flash_case(f"prefill B4 S512 Hq8 Hkv4 hd256 w{window} cap50 {dt}",
                       4, 8, 4, 512, 512, 256, True, window, 50.0, dt, 0)
    # decode against a half-written cache of 1024 slots
    half = np.where(np.arange(1024) < 512, np.arange(1024), INVALID)
    for window in (4096, 0):
        flash_case(f"decode Sq1 L1024 half-invalid w{window}", 4, 8, 4, 1, 1024,
                   256, True, window, 50.0, torch.bfloat16, 511, half)
    # a wrapped ring: position p lives at slot p % L
    pos, L = 1500, 1024
    ring = np.empty(L, np.int64)
    for p in range(pos - L + 1, pos + 1):
        ring[p % L] = p
    flash_case("decode wrapped ring L1024 w256", 4, 8, 4, 1, L, 256, True, 256,
               50.0, torch.bfloat16, pos, ring)
    flash_case("decode wrapped ring L1024 w256 f32", 2, 8, 4, 1, L, 256, True, 256,
               50.0, torch.float32, pos, ring)

    # the reduced model, served on the card and on the CPU, must agree
    rcfg = get_config(ARCH).reduced()
    rparams = init_params(rcfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [rng.integers(0, rcfg.vocab_size, size=12) for _ in range(3)]
    outs = {}
    for d in ("cpu", "cuda"):
        eng = ServingEngine(rcfg, rparams.to(d), batch_size=3, max_seq=64, device=d)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=6))
        outs[d] = [r.output for r in eng.run_batch()]
    log(f"[reduced] tokens cpu {outs['cpu']} cuda {outs['cuda']}")
    assert outs["cpu"] == outs["cuda"], "reduced gemma2-2b: card and CPU disagree"

    # -- 3. serve full-width gemma2-2b --------------------------------------
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"vocab {cfg.vocab_size} {cfg.dtype}, "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B params "
        f"initialised in {time.perf_counter() - t0:.1f}s")

    def requests():
        r = np.random.default_rng(0)
        return [Request(i, r.integers(0, cfg.vocab_size, size=PROMPT),
                        max_new_tokens=NEW) for i in range(N_REQ)]

    engine = ServingEngine(cfg, params, BATCH, MAX_SEQ, device=dev)
    finite = []

    def recorded(step):
        def run(*args):
            logits, cache = step(*args)
            finite.append(torch.isfinite(logits).all())
            return logits, cache
        return run

    engine._prefill = recorded(engine._prefill)
    engine._decode = recorded(engine._decode)
    for r in requests():
        engine.submit(r)
    rmsnorm.launches = 0
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_batch()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.launches, "flash_attention": flash_attention.launches}
    forwards = len(finite)
    per_forward = {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers}
    log(f"[serve] {len(done)} requests, {forwards} forwards, launches {launches}")
    assert forwards == (N_REQ // BATCH) * (1 + NEW), forwards
    assert len(done) == N_REQ
    assert all(len(r.output) == NEW and all(0 <= x < cfg.vocab_size for x in r.output)
               for r in done), "bad outputs"
    assert all(bool(f) for f in finite), "non-finite logits"
    for name, n in per_forward.items():
        assert launches[name] == n * forwards, (name, launches[name], n * forwards)
    log(f"[serve] req 0: {done[0].output}")

    # steady-state serving: a second, uncounted run of the same requests
    engine.done.clear()
    for r in requests():
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_batch()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT))).to(dev)
    cache = init_cache(cfg, BATCH, MAX_SEQ, device=dev)
    prefill_ms = cuda_ms(lambda: prefill(params, {"tokens": tokens}, cache),
                         iters=5, warmup=1)
    tok = tokens[:, -1:]
    step = [PROMPT]

    def one_decode():
        decode(params, cache, tok, step[0])
        step[0] += 1

    decode_ms = cuda_ms(one_decode, iters=NEW, warmup=2)
    serve = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
             "tokens_per_s": N_REQ * NEW / serve_s, "serve_s": serve_s,
             "first_run_s": first_s, "batch": BATCH, "prompt_len": PROMPT,
             "max_new": NEW, "requests": N_REQ,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log("[serve] " + json.dumps(serve))

    # where a step's time goes: device busy share and the top kernels
    def profiled(label, fn):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = device_kernels(prof)
        busy_ms = sum(a.self_device_time_total for a in kern) / 1e3
        log(f"[profile] {label}: wall {wall_ms:.3f} ms under the profiler, "
            f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
            f"{sum(a.count for a in kern)} kernels")
        for a in sorted(kern, key=lambda a: -a.self_device_time_total)[:8]:
            log(f"[profile]   {a.self_device_time_total / 1e3:9.3f} ms {a.count:5d}x "
                f"{a.key[:90]}")

    profiled("prefill", lambda: prefill(params, {"tokens": tokens}, cache))
    profiled("decode step", one_decode)
    del cache

    # -- 4. times at the serving shapes --------------------------------------
    def rms_times(rows):
        x = t(rows, cfg.d_model, dtype=torch.bfloat16)
        sc = (t(cfg.d_model) + 1.0).to(torch.bfloat16)
        nbytes = 2 * x.numel() * 2 + sc.numel() * 2
        b_ms, b_by = bound(nbytes, 4 * x.numel(), "bfloat16")
        return {"shape": f"({rows}, {cfg.d_model}) bf16",
                "ms": device_ms(lambda: rmsnorm(x, sc)),
                "event_ms": cuda_ms(lambda: rmsnorm(x, sc)),
                "plain_ms": device_ms(lambda: rmsnorm_ref(x, sc)),
                "library_ms": device_ms(lambda: torch.nn.functional.rms_norm(
                    x, (cfg.d_model,), sc, 1e-6)),
                "bound_ms": b_ms, "bound_by": b_by}

    def flash_times(Sq, Skv, q_offset, kv_pos, window, library):
        B, Hq, Hkv, hd = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = t(B, Sq, Hq, hd, dtype=torch.bfloat16)
        k, v = t(B, Skv, Hkv, hd, dtype=torch.bfloat16), t(B, Skv, Hkv, hd, dtype=torch.bfloat16)
        kp = None if kv_pos is None else torch.as_tensor(kv_pos, dtype=torch.int32, device=dev)
        kpos = np.arange(Skv) if kv_pos is None else np.asarray(kv_pos)
        qpos = q_offset + np.arange(Sq)
        valid = kpos[None, :] <= qpos[:, None]
        if window:
            valid &= kpos[None, :] > qpos[:, None] - window
        flops = 4 * hd * int(valid.sum()) * B * Hq
        # K/V of a slot no query attends to (unwritten, or masked for all) is
        # never read: the kernel skips such tiles before loading them
        read = int(valid.any(axis=0).sum())
        nbytes = 2 * (2 * q.numel() + 2 * B * Hkv * hd * read) + (4 * Skv if kp is not None else 0)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap, q_offset=q_offset)
        res = {"shape": f"B{B} Sq{Sq} Skv{Skv} Hq{Hq} Hkv{Hkv} hd{hd} bf16 w{window} "
                        f"cap{cfg.attn_softcap}",
               "ms": device_ms(lambda: flash_attention(q, k, v, kv_pos=kp, **kw)),
               "event_ms": cuda_ms(lambda: flash_attention(q, k, v, kv_pos=kp, **kw)),
               "plain_ms": device_ms(lambda: chunked_attention(q, k, v, kv_positions=kp, **kw)),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        if library:   # SDPA, causal, no softcap: a yardstick only
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
            res["library_ms"] = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        return res

    rms_prefill, rms_decode = rms_times(BATCH * PROMPT), rms_times(BATCH)
    fa_prefill = flash_times(PROMPT, PROMPT, 0, None, cfg.window, True)
    written = PROMPT + NEW // 2
    fa_decode = flash_times(1, MAX_SEQ, written - 1,
                            np.where(np.arange(MAX_SEQ) < written, np.arange(MAX_SEQ), INVALID),
                            cfg.window, False)
    kernels = []
    for name, src, replaces, main_t, dec_t in [
            ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/rmsnorm.py:22", rms_prefill, rms_decode),
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:75", fa_prefill, fa_decode)]:
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "launches_per_forward": per_forward[name],
            "max_abs_err": err[name], **main_t, "kernel_ms": main_t["ms"],
            "decode": dec_t, "device": smi})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
