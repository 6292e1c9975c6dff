#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:
  0. device: a CUDA card must be present; prints its name and power limit,
     its SM count and maximum SM clock (the SFU's rate, for the scan's
     bound);
  1. build: compiles the port's CUDA kernels from the repository's sources;
     prints the registers, local memory (spills) and shared memory of every
     flash-attention kernel, of the tiled and decode grouped-matmul kernels,
     of the warp-per-row RMSNorm kernel at each width it is built for and
     of the prefill scan kernel, as ``cudaFuncGetAttributes`` reports them
     for the loaded library;
  2. kernels vs plain versions on the card, on seeded inputs, each case
     printed with its max abs error and tolerance (RMSNorm and flash
     attention at gemma2-2b's and jamba's shapes, grouped matmul and
     selective scan at the JAX tests' and jamba's shapes). Each RMSNorm and
     scan call asserts which kernel served it. RMSNorm in bf16 at the widths
     2304 and 4096 runs the warp kernel (prefill and decode rows, an f32
     scale, the last position of a prefill), with the block kernel held on
     the same inputs past the dispatch; f32, widths 256, 1000 and 257, and
     rows a width + 4 apart run the block kernel. The scan from 32 steps
     runs the prefill kernel, held to the plain version carried out in f64,
     and below them the sequential kernel, held to the f32 plain version
     (its own order of sums), each with the other kernel held past the
     dispatch: S = 77 and 600, d_inner 130, strided b and c, jamba's
     prefill and decode; the prefill kernel's distance from the f32 plain
     version is printed beside. At S = 1024 and 2048 in f32 (states that
     barely decay) the prefill kernel must be nearer the f64 scan than the
     f32 plain version is; both distances are printed. Flash in bf16
     runs on the split-KV kernel (Sq x G <= 16) or the tensor-core kernel,
     each case asserting which one served it: every head dim, ragged
     tiles, rings mostly unwritten, wrapped with a window, and both sides
     of the Sq x G = 16 edge; f32 runs on the FMA kernel. bf16 flash is
     held to 2e-2 everywhere and 8e-3 where |ref| < 1, and its max error by
     output magnitude is printed. Grouped matmul in bf16 runs on the tiled
     kernel (at least 128 rows) or the decode kernel (fewer), each case
     asserting which served it: empty and 1-row groups, groups off the
     128-row tile, groups of 16, 17 and 33 rows (one to three of the decode
     kernel's 16-row slots), T = 1, rows past the last group, D and F
     multiples of 8 but not of 32 or 64, both sides of the 128-row edge,
     jamba's prefill and decode; f32 runs on the small kernel, which is
     also held in bf16 at jamba's decode shapes, called past the dispatch.
     The zoo's shapes: flash at yi-9b's, grok-1's (softcap 30) and
     starcoder2's head groups (8, 6, 12) at hd 128, prefill on the
     tensor-core kernel and decode on split-KV; RMSNorm in bf16 at grok's
     width 6144 on the block kernel; gmm at grok's 8 experts of 6144 ->
     32768 and back, at prefill on the tiled kernel and decode on the decode
     kernel. phi3-mini-3.8b's and kimi-k2's shapes: flash at head dims 96
     (32 over 32 heads) and 112 (64 over 8) on all three kernels (the
     tensor-core kernel at prefill, split-KV at decode, the FMA kernel in
     f32), RMSNorm in bf16 at 3072 and 7168 on the block kernel, gmm at
     kimi's 384 experts of 7168 -> 2048 and back, at prefill on the tiled
     kernel and at a decode step's 32 rows (most groups empty) on the decode
     kernel. Where |out| reaches 4: flash at gemma2's, phi3's and kimi's
     prefill shapes with v ~ N(0, 2^2) clipped to |v| <= 7.9 (hundreds of
     outputs in [4, 8), none at 8), held to 2e-2 (8e-3 where |ref| < 1)
     against the plain version run on f32 copies of the same bf16 inputs,
     with the count of outputs in [4, 8) and the distance from the bf16 plain
     output printed. Plus a reduced gemma2-2b, a reduced hybrid (jamba's
     8-block pattern), reduced yi-9b, grok-1, starcoder2, phi3 and kimi (one
     layer and a 2-layer stack each) and phi3 and kimi reduced at their real
     head dims, served on the card (kernels) and on the CPU (plain path),
     which must agree;
  3. serve: full-width gemma2-2b (26 layers, bf16, seed-0 weights) through
     ``ServingEngine``: 8 requests, batch 4, prompt 512, 16 new tokens,
     max_seq 1024. Every RMSNorm and attention must have gone through the
     kernels (launch counts 53 and 26 per forward), every RMSNorm on the
     warp kernel, attention on the tensor-core kernel at prefill and the
     split-KV kernel at decode (26 each per forward);
     Prints prefill ms, decode ms per step and tokens/s, and a profile of
     one prefill and one decode step (device busy share, top kernels, the
     host's self CPU time and top host events), and one decode step under
     ``torch.cuda.set_sync_debug_mode("error")``. A profile is of 3 calls,
     and a session that lost kernel events is retaken, as phase 4's are;
     then one more prefill and decode step print the largest |attention
     output|;
  3b. serve: full-width jamba-v0.1-52b cut to 8 layers (one period of its
     block: 7 mamba, 1 attention, 4 MoE, 4 MLP layers; bf16, seed-0
     weights), gemma2-2b freed first, with the same requests. Launch counts
     per forward come from the pattern: RMSNorm 17, flash 1 (tensor-core at
     prefill, split-KV at decode), selective scan 7 (the prefill kernel at
     prefill, the sequential one at decode), grouped matmul 12 (the tiled
     kernel at prefill, the decode kernel at decode), every RMSNorm on the
     warp kernel. The same
     timings, profile and sync check; then the group sizes each MoE layer
     routes in one prefill and decode step;
  3c-3e. serve, each model freed before the next is built: yi-9b whole (97
     RMSNorm on the warp kernel, 48 flash per forward), grok-1-314b at full
     width cut to 6 of 64 layers (13 RMSNorm on the block kernel, d_model
     6144 not being a warp width; 6 flash; 18 gmm, tiled at prefill and
     decode at decode; its routing as jamba's), starcoder2-3b whole
     (LayerNorm and GELU plain PyTorch: 0 RMSNorm, 30 flash); the same
     timings, profiles, sync check and |attention output|;
  3f-3g. serve phi3-mini-3.8b whole (65 RMSNorm on the block kernel, d_model
     3072 not being a warp width; 32 flash at head dim 96, 32 q-heads over 32
     kv-heads) and kimi-k2 at full width cut to 1 of 61 layers (3 RMSNorm on
     the block kernel at 7168, 1 flash at head dim 112, 3 gmm over 384
     experts at top-8, tiled at prefill and decode at decode; its routing as
     grok's, with the experts that get no row counted); the same timings,
     profiles, sync check and |attention output|;
  4. times at the serving shapes, after warm-up: each kernel's, its plain
     version's and the library call's device time per call (the summed
     kernel time under the profiler, with a 256 MB scratch buffer read
     before every call so that no input is left in the 50 MB L2; the
     flush's own kernels are left out of the sums), the kernel's CUDA-event
     time per call of back-to-back launches (no flush, host launch cost
     included), and its bound: the largest of its bytes over the memory
     rate, its FLOPs over the peak and, for the scan, its exponentials over
     the SFU's rate. A split-KV call's device time sums its split
     and combine kernels. Grouped matmul is timed at the served model's
     routing (first MoE layer), and checked against its plain version
     there too, and at decode steps of batch 16, 32, 63, 64, 80, 96, 112 and
     128 (drawn top-2 routing: 32 to 256 rows), on both sides of the
     128-row edge; the scan also at S = 31 and 32, both sides of its edge,
     and at jamba's prefill with the JAX tests' draws (states that barely
     decay, da near 1);
     beside the kernel that serves a row, the other kernels named for it
     (RMSNorm: the block kernel; scan: the other one) are timed on the same
     inputs, called past the dispatch. The zoo's rows: flash at yi-9b's,
     grok-1's and starcoder2's prefill and decode, RMSNorm at (2048, 6144)
     and (4, 6144) on the block kernel, gmm at grok's served routing, up
     and down, prefill and decode (drawn after grok-6 is freed); flash at
     phi3's and kimi's prefill and decode, RMSNorm at (2048, 3072), (4,
     3072), (2048, 7168) and (4, 7168) on the block kernel, gmm at kimi's
     served routing, up and down, prefill and decode;
  5. train: the reduced gemma2-2b and a reduced hybrid with a MoE layer
     take 3 AdamW steps on the card and on the CPU from the same seed, whose
     losses, aux losses and grad norms must agree. Then full-width gemma2-2b
     (nothing cut) and full-width jamba cut to two layers of its block
     (mamba + MoE, attention + MLP: all four kernels) each take 10 AdamW
     steps through ``Trainer`` (lr 3e-4, batch 4 x 512 bigram tokens; an
     out-of-memory error fails the run): every loss finite, the mean of the
     last 3 below the first, and per step the kernel launches of one forward
     (the backward recomputes the plain versions and launches none): gemma2
     53 RMSNorm (warp) and 26 flash (tensor-core); jamba-2 5 RMSNorm, 1
     flash, 1 scan (prefill kernel), 3 gmm (tiled). Then starcoder2-3b
     whole, the same way at lr 1e-4: 30 flash and 0 RMSNorm a step (its
     reduced config also takes the card-vs-CPU steps, as do phi3's and
     kimi's reduced configs at their real head dims, 96 and 112, whose
     training forward runs the FMA flash kernel there). Prints step ms (CUDA
     events, median of steps 3-10), tokens/s, peak memory, and a profiled
     eleventh step split into the four kernels' forwards, the
     plain-recompute backward of each op, cuBLAS and the optimizer;
  6. search: HyperTrick's LM search through ``repro_torch.launch.tune.main``
     (the thread backend: node threads that each train a trial phase by
     phase through ``make_lm_objective`` and report after each phase).
     6a: the CLI's defaults (yi-9b's reduced config in f32, batch 8 x 64
     tokens, 12 workers on 4 node threads, 5 phases of 25 steps, r 0.25,
     seed 0): no trial crashed, every trial 1 to 5 reports (5 when it
     completed), every metric finite, the best above -ln(512), alpha in
     (0, 1], and the launch counters at the steps taken times 3 RMSNorm
     (block kernel) and 1 flash (FMA kernel) a step. Prints wall time,
     occupancy, alpha, trial-steps/s, tokens/s and peak memory. 6b: the same
     search on one node thread inside one CUDA-only profiler session (the
     device's busy share): the same configurations by trial id, and every
     (trial, phase) both runs trained within ``SEARCH_NODES_ATOL``. 6c: one
     node, HyperTrick(w0 4, 3 phases, r 0.25, seed 0) at 4 steps a phase on
     the card and on the CPU, every trial's weights drawn on the CPU: the
     same trials, statuses and reports, metrics within TRAIN_ATOL +
     TRAIN_RTOL * |cpu|; a differing decision prints each report's metric
     and cut. 6d: searches of 4 workers on 2 node threads, 2 phases of 4
     steps, at jamba (RMSNorm, flash, the prefill scan) and grok-1 (RMSNorm,
     flash, the small gmm), their launch counts held as in 6a. Phase 2 holds
     the block RMSNorm and the FMA flash kernel at the trial shapes, and
     phase 4 times them there beside ``F.rms_norm`` and SDPA.
Seconds per phase are printed as each ends. The last two lines are the
kernels' JSON line and the result line.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import collections
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLUSH_BYTES = 256 << 20     # scratch read between timed calls: over 2 x the 50 MB L2

ARCH, N_REQ, BATCH, PROMPT, NEW, MAX_SEQ = "gemma2-2b", 8, 4, 512, 16, 1024
# jamba at full width, one period of its 8-layer block: the 32 published
# layers (51.6B parameters, 103 GB in bf16) do not fit one 80 GB card
HYBRID, HYBRID_LAYERS = "jamba-v0.1-52b", 8
# yi-9b (8.83B parameters, 17.7 GB) and starcoder2-3b (3.18B) are served
# whole; grok-1 at full width cut to 6 of its 64 layers: 6 are 31.13B
# parameters (62.3 GB in bf16), 7 would be 72.1 GB, too little of one 80 GB
# card left to serve in; all 64 are 316.5B (633 GB)
YI, STARCODER = "yi-9b", "starcoder2-3b"
GROK, GROK_LAYERS = "grok-1-314b", 6
# phi3-mini-3.8b (3.82B parameters, 7.6 GB) is served whole; kimi-k2 at full
# width cut to 1 of its 61 layers, one period of its pattern: 19.38B
# parameters (38.8 GB in bf16); 2 layers would be 72.8 GB, more than grok's
# 7 (72.1 GB); all 61 are 1.04T
PHI3 = "phi3-mini-3.8b"
KIMI, KIMI_LAYERS = "kimi-k2-1t-a32b", 1
# the reduced configs of phi3 and kimi at their own head dims, 96 and 112
# (reduced() gives 64); phi3 keeps MHA, as its 32 q-heads over 32 kv-heads
REAL_HEAD_DIM = {PHI3: dict(head_dim=96, d_model=384, n_kv_heads=4),
                 KIMI: dict(head_dim=112, d_model=448)}
INVALID = 2 ** 30
# phase 5: AdamW steps at lr 3e-4 of batch TRAIN_BATCH x TRAIN_SEQ bigram
# tokens; jamba at full width cut to two layers of
# its block, ("mamba", "moe") then ("attn", "mlp"): with AdamW's f32 moments
# the 8-layer serve cut (13.3B parameters, 160 GB) does not fit one card
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 10, 4, 512, 3e-4
# starcoder2-3b trains at lr 1e-4: from its seed-0 weights AdamW at 3e-4
# (or 1e-3) makes its loss rise over these 10 steps on an H100, as
# ``python -m repro_torch.launch.train --arch starcoder2-3b --steps 10
# --batch 4 --seq 512 --lr 3e-4`` shows, and the CPU's plain versions make
# it rise the same way from the same weights and batches
# (``python -m repro_torch.launch.train_devices``; PERF.md §4)
STARCODER_TRAIN_LR = 1e-4
HYBRID_TRAIN_PATTERN = slice(3, 5)
# the reduced models' 3 AdamW steps, card against CPU, in f32: loss, aux and
# grad norm within TRAIN_ATOL + TRAIN_RTOL * |cpu| (the f32 kernels sum in
# another order than the plain versions; a loss is a mean over 128 tokens)
REDUCED_TRAIN_STEPS, TRAIN_ATOL, TRAIN_RTOL = 3, 1e-5, 1e-5
# phase 6: the search CLI's defaults (``repro_torch.launch.tune``: yi-9b, 12
# workers on 4 node threads, 5 phases of 25 steps, HyperTrick at r 0.25, seed
# 0); every trial trains the arch's reduced config (f32) at the LM
# objective's batch 8 x 64 tokens, the reference's trial shape
SEARCH_W0, SEARCH_NODES, SEARCH_PHASES, SEARCH_STEPS, SEARCH_R = 12, 4, 5, 25, 0.25
SEARCH_BATCH, SEARCH_SEQ = 8, 64
# 6b: each (trial, phase) metric of the 4-thread search against the 1-thread
# one; a trial's numbers depend on its hyperparameters alone
SEARCH_NODES_ATOL = 0.0
# 6c: one node, HyperTrick(lm_space, w0 4, 3 phases, r 0.25, seed 0), 4 steps
# a phase, on the card and on the CPU from one CPU draw of the weights; each
# phase's metric within TRAIN_ATOL + TRAIN_RTOL * |cpu|
SEARCH_DEV_W0, SEARCH_DEV_PHASES, SEARCH_DEV_STEPS = 4, 3, 4
# 6d: small searches of the archs whose reduced configs run the scan (jamba)
# and the grouped matmul (grok-1), 4 workers on 2 node threads
SEARCH_KERNEL_ARGV = ["--workers", "4", "--nodes", "2", "--phases", "2",
                      "--steps-per-phase", "4"]


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


def device_kernels(prof, required=True, skip_lead_in=False):
    """The profiler's device-side events (kernels, copies, sets) summed by
    name, as ``key_averages`` sums them: ``.key``, ``.count`` and
    ``.self_device_time_total`` (µs). Read from the profiler's raw kineto
    events: a session over a whole search holds over a million kernels,
    and building the profiler's Python record of each takes minutes. A
    range's span on the device (``record_function``'s) is no kernel and is
    left out. With ``skip_lead_in``, a session's lead-in (``lead_in``) is
    left out by its place in the trace: it ran on a stream of its own, and
    only the events on the stream of the session's last event are kept."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    if skip_lead_in and evs:
        stream = max(evs, key=lambda e: e.end_ns()).device_resource_id()
        timed = [e for e in evs if e.device_resource_id() == stream]
        # nothing but the lead-in's fills runs on another stream
        assert len(evs) - len(timed) <= LEAD_IN, (len(evs) - len(timed), LEAD_IN)
        evs = timed
    sums = {}
    for e in evs:
        n, us = sums.get(e.name(), (0, 0.0))
        sums[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    kern = [Kernel(k, n, us) for k, (n, us) in sums.items()]
    assert kern or not required, "the profiler saw no device time"
    return kern


Kernel = collections.namedtuple("Kernel", "key count self_device_time_total")


# A profiler session on an H100 drops the first one or two kernel events
# it would record, now and then or every time: an L2 flush's memset, a
# grok-6 prefill's first RMSNorm. So every session opens with LEAD_IN int8
# fills on a stream of their own, which take that loss.
LEAD_IN = 4


def lead_in():
    """Launch the lead-in's fills on a stream of their own and wait for them."""
    import torch
    with torch.cuda.stream(torch.cuda.Stream()):
        mark = torch.empty(LEAD_IN, dtype=torch.int8, device="cuda")
        for i in range(LEAD_IN):
            mark[i:i + 1].fill_(1)
    torch.cuda.synchronize()


# profiler sessions of the timed phases: taken, and retaken for lost events
SESSIONS = {"taken": 0, "retaken": 0}


def profiled_session(fn, iters, sessions=5, ignore=frozenset(), ours=None):
    """The profiler's device events of ``iters`` calls of ``fn``, and its
    wall ms a call. A profiler session now and then records no device event
    at all, and one that loses events reads short: past the lead-in, an
    H100 lost 1-5 of 20 calls' kernels in sessions of ``torch._grouped_mm``
    and of the plain attention. So a session is kept only
    when it is whole, else taken again, up to ``sessions`` in all, and if
    none is whole the run fails. Whole means: every call of ``fn`` launches
    the same kernels, so each key's count is a multiple of ``iters``; or,
    for a model step (``ours`` given: the port's kernels one call launches,
    as the launch counters read), exactly ``ours`` x ``iters`` of the port's
    kernel events, since its PyTorch ops may pick another kernel call by
    call (a jamba-8 prefill's ``index_select`` launched its vectorized
    gather 14 times in 3 calls on an H100). Keys in ``ignore`` (the L2
    flush's own, which no time includes) are held only where a timed call
    shares them, a count over ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for session in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        SESSIONS["taken"] += 1
        kern = device_kernels(prof, required=False, skip_lead_in=True)
        if ours is None:
            off = {a.key[:60]: a.count for a in kern if a.count % iters
                   and not (a.key in ignore and a.count < iters)}
        else:
            port = {a.key: a.count for a in kern if is_port_kernel(a.key)}
            off = {}
            if sum(port.values()) != ours * iters:
                off = {f"the port's kernels, of {ours * iters}": sum(port.values()),
                       **{k.replace("(anonymous namespace)::", "")[:50]: n
                          for k, n in port.items()}}
        if not off and any(a.key not in ignore for a in kern):
            return kern, wall_ms
        SESSIONS["retaken"] += 1
        what = f"counts off {iters} calls: {off}" if off else "no event of the timed calls"
        log(f"[profile] session {session + 1} of {sessions} recorded {what}; again")
    raise AssertionError(f"the profiler recorded no whole session of {iters} calls")


PORT_KERNEL = re.compile(
    r"(^|[\s:])(rmsnorm_kernel|rmsnorm_warp_kernel|flash_kernel|flash_prefill_kernel|"
    r"flash_split_kernel|flash_combine_kernel|gmm_kernel|gmm_prefill_kernel|"
    r"gmm_decode_kernel|scan_kernel|scan_prefill_kernel)[<(]")


def is_port_kernel(name):
    """A profiler key of one of the port's CUDA kernels (``csrc/*.cu``)."""
    return PORT_KERNEL.search(name) is not None


class L2Flush:
    """Reads every byte of a 256 MB scratch buffer (over 2 x the H100's 50 MB
    L2) when called, so that a call timed after it reads its inputs from
    device memory, as a serving step does a layer's weights. A read leaves
    clean lines, so the timed call pays no write-back of the flush's bytes.
    ``keys`` are the profiler keys of the flush's own kernels, found by
    profiling it alone, and ``ms`` their device time per call there."""

    def __init__(self, iters=10):
        import torch
        self.buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        kern, _ = profiled_session(self, iters)
        assert all(a.count == iters for a in kern), [(a.key[:60], a.count) for a in kern]
        self.keys = {a.key for a in kern}
        self.ms = {a.key: a.self_device_time_total / 1e3 / iters for a in kern}

    def __call__(self):
        self.buf.sum()


def device_ms_by_kernel(fn, flush, iters=20, warmup=3):
    """Device time per call of each kernel ``fn`` launches, {name: ms}, from
    the profiler's kernel events: without the host's launch gaps (which CUDA
    events around back-to-back launches of a small kernel would measure).
    ``flush`` (an ``L2Flush``) runs before every call; its kernels are left
    out. Where a timed call launches a kernel under one of the flush's keys
    (SDPA launches memsets, as the flush does), that key's time is kept,
    less the flush's own time per call."""
    def flushed():
        flush()
        fn()

    for _ in range(warmup):
        flushed()
    out = {}
    for a in profiled_session(flushed, iters, ignore=flush.keys)[0]:
        ms = a.self_device_time_total / 1e3 / iters
        if a.key in flush.keys:
            if a.count <= iters:    # the flush's own, once a call
                continue
            ms = max(ms - flush.ms[a.key], 0.0)     # a timed call's too
        # "void (anonymous namespace)::flash_split_kernel<256>(...)" -> "flash_split_kernel<256>"
        name = a.key.replace("void ", "").replace("(anonymous namespace)::", "")
        name = name.split("(")[0][:60]
        out[name] = out.get(name, 0.0) + ms
    return out


def device_ms(fn, flush, iters=20, warmup=3):
    """Device time per call: the summed time of the kernels ``fn`` launches."""
    return sum(device_ms_by_kernel(fn, flush, iters, warmup).values())


# the SFU's rate: 16 exponentials (MUFU.EX2) a clock on each SM (the CUDA
# programming guide's throughput table for compute capability 9.0); the SM
# count and the card's maximum SM clock are read in phase 0
SFU_PER_CLOCK_PER_SM = 16
SFU = {"rate": None}        # exponentials a second on this card


def bound(nbytes, flops, dtype, exps=0):
    """The least time (ms) the card could take: the largest of the bytes over
    the memory rate, the FLOPs over the peak rate for ``dtype`` and the
    exponentials over the SFU's rate, with what sets it: ``bytes`` or
    ``operations`` (FLOPs or exponentials; ``bound_unit`` below says which)."""
    t = {"bytes": nbytes / PEAK_BYTES * 1e3, "flops": flops / PEAK_FLOPS[dtype] * 1e3,
         "sfu": exps / SFU["rate"] * 1e3 if exps else 0.0}
    unit = max(t, key=t.get)
    return t[unit], "bytes" if unit == "bytes" else "operations", unit


def matmul_bound_ms(cfg, tokens):
    """A training step's floor: 6 N T FLOPs over the bf16 peak, with N the
    weights a token meets (every weight but the embedding table; the
    experts' at top_k of n_experts) and T ``tokens``. Returns (ms, N)."""
    from repro_torch.models.schema import _leaves, model_schema
    n = 0.0
    for name, d in _leaves(model_schema(cfg)):
        leaf = name.split("/")[-1]
        if leaf == "embed":
            continue
        share = cfg.top_k / cfg.n_experts if leaf in ("we_up", "we_gate", "we_down") else 1.0
        n += math.prod(d.shape) * share
    return 6 * n * tokens / PEAK_FLOPS["bfloat16"] * 1e3, n


def per_forward(cfg):
    """Kernel launches in one forward, from the config's block pattern and
    norm: a norm per mixer and per FFN plus the final norm (RMSNorm's kernel;
    LayerNorm is plain PyTorch), a flash call per attention layer, a scan per
    mamba layer, three grouped matmuls per MoE."""
    R, pat = cfg.n_repeat, cfg.pattern
    norms = R * sum(1 + bool(ffn) for _, ffn in pat) + 1
    return {"rmsnorm": norms if cfg.norm == "rmsnorm" else 0,
            "flash_attention": R * sum(m.startswith("attn") for m, _ in pat),
            "selective_scan": R * sum(m == "mamba" for m, _ in pat),
            "gmm": 3 * R * sum(ffn == "moe" for _, ffn in pat)}


def kernel_attrs(lib, fn, n, *args):
    """Registers, local memory (spills and stack) a thread and static shared
    memory a block of one kernel, as ``cudaFuncGetAttributes`` reports them
    for the library loaded in this run (an ``*_attrs`` export filling ``n``
    ints), with the dynamic shared memory its launch asks for."""
    from repro_torch.kernels import _build
    out = (ctypes.c_int * n)()
    _build.check(lib, fn(*args, out), fn.__name__)
    r = {"registers": out[0], "local_bytes": out[1], "static_smem_bytes": out[2]}
    if n == 4:
        r["dynamic_smem_bytes"] = out[3]
    elif n == 5:    # one ring stage when each split has one tile, two otherwise
        r["dynamic_smem_bytes_1_2_stages"] = [out[3], out[4]]
    return r


def flash_resources(lib, head_dims):
    """``kernel_attrs`` of every flash-attention kernel."""
    res = {"flash_combine_kernel": kernel_attrs(lib, lib.flash_combine_attrs, 3)}
    for hd in head_dims:
        res[f"flash_prefill_kernel<{hd}>"] = kernel_attrs(lib, lib.flash_prefill_attrs, 4, hd)
        res[f"flash_split_kernel<{hd}>"] = kernel_attrs(lib, lib.flash_split_kv_attrs, 5, hd)
        res[f"flash_kernel<float,{hd}>"] = kernel_attrs(lib, lib.flash_attention_attrs, 4, hd)
    return res


def skewed_sizes(total, E, empty):
    """Router-like group sizes: a decaying share per expert, one empty."""
    w = 1.0 / (np.arange(E) + 1.0) ** 0.7
    w[empty] = 0.0
    s = np.floor(total * w / w.sum()).astype(int)
    s[0] += total - s.sum()
    return s.tolist()


def routed_sizes(tokens, E, k, seed):
    """A decode step's group sizes: top-``k`` of ``E`` experts drawn per
    token for ``tokens`` tokens from one seeded draw."""
    pick = np.random.default_rng(seed)
    return np.bincount(np.concatenate([pick.choice(E, k, replace=False)
                                       for _ in range(tokens)]), minlength=E).tolist()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS, kernel_for
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import chunked_attention
    from repro_torch.kernels.gmm.gmm import kernel_for as gmm_kernel_for
    from repro_torch.kernels.gmm.gmm import launch as gmm_launch
    from repro_torch.kernels.gmm.ops import gmm
    from repro_torch.kernels.gmm.ref import TILE_M, gmm_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import WARP_WIDTHS as RMS_WARP_WIDTHS
    from repro_torch.kernels.rmsnorm.rmsnorm import kernel_for as rms_kernel_for
    from repro_torch.kernels.rmsnorm.rmsnorm import launch as rms_launch
    from repro_torch.kernels.rmsnorm.rmsnorm import row_stride
    from repro_torch.kernels.selective_scan.ops import selective_scan
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan.selective_scan import kernel_for as scan_kernel_for
    from repro_torch.kernels.selective_scan.selective_scan import launch as scan_launch
    from repro_torch.models.model import init_cache
    from repro_torch.models.schema import count_params, init_params
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    kernel_ops = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                  "selective_scan": selective_scan, "gmm": gmm}
    clock = {"t": time.perf_counter()}

    def phase_done(name):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - clock['t']:.1f} s")
        clock["t"] = now

    def zero_counts():
        for op in kernel_ops.values():
            op.launches = 0
        flash_attention.launches_split_kv = flash_attention.launches_tensor_core = 0
        flash_attention.launches_fma = 0
        gmm.launches_tiled = gmm.launches_decode = gmm.launches_small = 0
        rmsnorm.launches_warp = rmsnorm.launches_block = 0
        selective_scan.launches_prefill = selective_scan.launches_sequential = 0

    # -- 0. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    SFU["rate"] = SFU_PER_CLOCK_PER_SM * n_sm * float(clk) * 1e6
    log(f"{n_sm} SMs, max SM clock {clk} MHz: {SFU['rate'] / 1e12:.3f} T exponentials/s "
        "on the SFU")
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {device_name}")
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_done("0 device")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load_library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    flash_res = flash_resources(lib, HEAD_DIMS)
    gmm_res = {"gmm_prefill_kernel": kernel_attrs(lib, lib.gmm_prefill_attrs, 4),
               "gmm_decode_kernel": kernel_attrs(lib, lib.gmm_decode_attrs, 4)}
    scan_res = {f"scan_prefill_kernel<{name}>": kernel_attrs(
        lib, lib.selective_scan_prefill_attrs, 4, _build.DTYPES[dt])
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    rms_res = {f"rmsnorm_warp_kernel<D{D}>": kernel_attrs(lib, lib.rmsnorm_warp_attrs, 4, D)
               for D in RMS_WARP_WIDTHS}
    for name, r in sorted({**flash_res, **gmm_res, **rms_res, **scan_res}.items()):
        log(f"[build] {name}: {json.dumps(r)}")

    phase_done("1 build")

    # -- 2. kernels vs plain versions ----------------------------------------
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def t(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dev, dtype)

    def td(*shape, dtype=torch.float32, scale=1.0):
        """Seeded normals drawn on the card (large tensors); past 2^31
        elements (kimi's 384 stacked experts) a leading slice at a time, so
        no f32 draw holds the whole tensor."""
        if math.prod(shape) > 1 << 31:
            out = torch.empty(shape, dtype=dtype, device=dev)
            for i in range(shape[0]):
                out[i] = torch.randn(shape[1:], generator=gen, device=dev) * scale
            return out
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    err = {name: 0.0 for name in kernel_ops}

    def check(name, label, out, ref, tol, rtol=0.0, bulk=None):
        """Pass if |out - ref| <= tol + rtol * |ref| everywhere and, with
        ``bulk`` = (limit, below), |out - ref| <= limit where |ref| < below."""
        diff = (out.double() - ref.double()).abs()
        e = diff.max().item()
        excess = (diff - rtol * ref.double().abs()).max().item() if rtol else e
        ok = math.isfinite(e) and excess <= tol
        note = ""
        if bulk is not None:
            small = ref.double().abs() < bulk[1]
            eb = diff[small].max().item() if small.any().item() else 0.0
            ok = ok and eb <= bulk[0]
            note = f", {eb:.3e} where |ref| < {bulk[1]:g} (limit {bulk[0]:.0e})"
        log(f"[kernel] {name} {label}: max_abs_err {e:.3e} tol {tol:.0e}"
            + (f" + {rtol:.1e}*|ref|" if rtol else "") + note + f" {'ok' if ok else 'FAIL'}")
        assert ok, f"{name} {label}: {e} > {tol} (+ {rtol}*|ref|){note}"
        err[name] = max(err[name], e)
        return e

    hcfg, cfg0 = get_config(HYBRID), get_config(ARCH)
    rms_err_by_kernel = {"warp": 0.0, "block": 0.0}

    def rms_counts():
        return {"warp": rmsnorm.launches_warp, "block": rmsnorm.launches_block}

    def rms_case(label, x, sc, want=None):
        """One RMSNorm call through the dispatch, which must move the counter
        of ``kernel_for``'s kernel (``want``, where given) alone; where that
        is the warp kernel, the block kernel is held on the same inputs too,
        past the dispatch."""
        tol = 5e-2 if x.dtype == torch.bfloat16 else 1e-5
        kind, before = rms_kernel_for(x, sc), rms_counts()
        assert want in (None, kind), (label, kind, want)
        out = rmsnorm(x, sc)
        moved = {n: c - before[n] for n, c in rms_counts().items()}
        assert moved == {n: int(n == kind) for n in moved}, (label, kind, moved)
        ref = rmsnorm_ref(x, sc)
        e = check("rmsnorm", f"[{kind}] {label}", out, ref, tol)
        rms_err_by_kernel[kind] = max(rms_err_by_kernel[kind], e)
        if kind == "warp":      # NaN wherever the kernel writes nothing
            o = torch.full_like(out, math.nan)
            rms_launch("block", x, sc, o, x.numel() // x.shape[-1], row_stride(x), 1e-6)
            e = check("rmsnorm", f"[block, past the dispatch] {label}", o, ref, tol)
            rms_err_by_kernel["block"] = max(rms_err_by_kernel["block"], e)

    # gemma2-2b's width, jamba's at its prefill and decode rows, and widths
    # no warp kernel is built for (the reduced models' 256, 1000, 257)
    for shape in [(2048, 2304), (4, 2304), (3, 77, 2304),
                  (BATCH * PROMPT, hcfg.d_model), (BATCH, hcfg.d_model), (3, 77, 256),
                  (5, 1000), (7, 257)]:
        for dt in (torch.bfloat16, torch.float32):
            rms_case(f"{shape} {dt}", t(*shape, dtype=dt), (t(shape[-1]) + 1.0).to(dt))
    for D in (2304, hcfg.d_model):
        # an f32 scale on bf16 rows
        rms_case(f"(4, {D}) bf16, f32 scale", t(4, D, dtype=torch.bfloat16), t(D) + 1.0)
        # the last position of a prefill, as logits_fn sees it: rows S*D apart
        rms_case(f"(4, 512, {D})[:, -1:] bf16", t(4, 512, D, dtype=torch.bfloat16)[:, -1:],
                 (t(D) + 1.0).to(torch.bfloat16))
        # rows D + 4 apart: not a multiple of 8, so the block kernel
        rms_case(f"(6, {D + 4})[:, :{D}] bf16", t(6, D + 4, dtype=torch.bfloat16)[:, :D],
                 (t(D) + 1.0).to(torch.bfloat16))
    rms_case("(4, 9, 1000)[:, -1:] bf16", t(4, 9, 1000, dtype=torch.bfloat16)[:, -1:],
             (t(1000) + 1.0).to(torch.bfloat16))
    # grok-1's width 6144, phi3's 3072 and kimi's 7168 are not ones the warp
    # kernel is built for: the block kernel serves their prefill and decode
    # rows and a prefill's last position
    gfull, kfull = get_config(GROK), get_config(KIMI)
    for zname in (GROK, PHI3, KIMI):
        zw = get_config(zname).d_model
        for shape in [(BATCH * PROMPT, zw), (BATCH, zw), (BATCH, PROMPT, zw)]:
            x = t(*shape, dtype=torch.bfloat16)
            rms_case(f"{zname} {shape} bf16" + ("[:, -1:]" if len(shape) == 3 else ""),
                     x[:, -1:] if len(shape) == 3 else x, (t(zw) + 1.0).to(torch.bfloat16),
                     want="block")
    log(f"[kernel] rmsnorm max_abs_err by kernel: {json.dumps(rms_err_by_kernel)}")

    # bf16 flash: the kernel and the plain version each round the output to
    # bf16, so the two may sit one bf16 ulp apart (1.56e-2 in [2, 4)), which
    # the 2e-2 limit admits; the bulk, |ref| < 1, is held to 8e-3, two ulps
    # of [0.5, 1). Where |ref| reaches 4 one ulp is 3.1e-2: those cases are
    # held to the plain version run in f32 instead (flash_large_out_case)
    FLASH_BF16_BULK = (8e-3, 1.0)
    # against the f32 plain version the bulk's error is the kernel's own
    # output rounding, half an ulp of [0.5, 1) (1.95e-3), when P reaches the
    # PV product whole; with P rounded to bf16 once it read 6.8e-3 to 7.1e-3
    FLASH_LARGE_OUT_BULK = (4e-3, 1.0)
    MAG_EDGES = (0.0, 0.5, 1.0, 2.0, 4.0, 8.0, math.inf)
    flash_bf16_by_mag = {f"[{lo:g}, {hi:g})": 0.0 for lo, hi in zip(MAG_EDGES, MAG_EDGES[1:])}

    def flash_counts():
        return {"split_kv": flash_attention.launches_split_kv,
                "tensor_core": flash_attention.launches_tensor_core,
                "fma": flash_attention.launches_fma}

    def flash_case(label, B, Hq, Hkv, Sq, Skv, hd, causal, window, cap, dt,
                   q_offset, kv_pos=None, want=None):
        q, k, v = t(B, Sq, Hq, hd, dtype=dt), t(B, Skv, Hkv, hd, dtype=dt), \
            t(B, Skv, Hkv, hd, dtype=dt)
        kp = None if kv_pos is None else torch.as_tensor(kv_pos, dtype=torch.int32,
                                                         device=dev)
        kind, before = kernel_for(dt, Sq, Hq, Hkv), flash_counts()
        assert want in (None, kind), (label, kind, want)
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap,
                              q_offset=q_offset, kv_pos=kp)
        moved = {n: c - before[n] for n, c in flash_counts().items()}
        assert moved == {n: int(n == kind) for n in moved}, (label, kind, moved)
        ref = chunked_attention(q, k, v, causal=causal, window=window, softcap=cap,
                                q_offset=q_offset, kv_positions=kp)
        bf = dt == torch.bfloat16
        check("flash_attention", f"[{kind}] {label}", out, ref, 2e-2 if bf else 1e-4,
              bulk=FLASH_BF16_BULK if bf else None)
        if bf:
            flash_by_magnitude(out, ref)

    def flash_by_magnitude(out, ref):
        """The error against the output's magnitude, over every bf16 case."""
        diff, mag = (out.float() - ref.float()).abs(), ref.float().abs()
        for (lo, hi), key in zip(zip(MAG_EDGES, MAG_EDGES[1:]), flash_bf16_by_mag):
            sel = (mag >= lo) & (mag < hi)
            if sel.any().item():
                flash_bf16_by_mag[key] = max(flash_bf16_by_mag[key], diff[sel].max().item())

    flash_large_out = {}

    def flash_large_out_case(zname, window):
        """``zname``'s prefill (batch 4, prompt 512) where |out| reaches 4: q,
        k ~ N(0, 1), v ~ N(0, 2^2) clipped to |v| <= 7.9, so rows that see
        few keys give outputs in [4, 8) and none reaches 8. The kernel's bf16
        output is held to the plain version run on f32 copies of the same
        bf16 inputs (an f32 p times an f32 v, the reference's arithmetic): its
        own rounding costs up to half an ulp there, 1.5625e-2, within 2e-2,
        and the bulk is held to 4e-3 (``FLASH_LARGE_OUT_BULK``). Its distance
        from the bf16 plain output is printed as a record only: two bf16
        results may sit one ulp (3.1e-2) apart there when both are right."""
        zc = get_config(zname)
        B, Hq, Hkv, hd, cap = BATCH, zc.n_heads, zc.n_kv_heads, zc.head_dim, zc.attn_softcap
        q = td(B, PROMPT, Hq, hd, dtype=torch.bfloat16)
        k = td(B, PROMPT, Hkv, hd, dtype=torch.bfloat16)
        v = td(B, PROMPT, Hkv, hd, scale=2.0).clamp_(-7.9, 7.9).to(torch.bfloat16)
        kw = dict(causal=True, window=window, softcap=cap)
        kind, before = kernel_for(q.dtype, PROMPT, Hq, Hkv), flash_counts()
        assert kind == "tensor_core", (zname, kind)
        out = flash_attention(q, k, v, **kw)
        moved = {n: c - before[n] for n, c in flash_counts().items()}
        assert moved == {"split_kv": 0, "tensor_core": 1, "fma": 0}, (zname, moved)
        ref = chunked_attention(q.float(), k.float(), v.float(), **kw)
        mag = ref.abs()
        band = (mag >= 4) & (mag < 8)
        n4 = int(band.sum().item())
        assert n4 >= 100 and mag.max().item() < 8, (zname, n4, mag.max().item())
        label = (f"{zname} prefill B{B} S{PROMPT} Hq{Hq} Hkv{Hkv} hd{hd} w{window} cap{cap}, "
                 "v ~ N(0, 2^2) clipped to 7.9")
        e = check("flash_attention", f"[{kind}] {label}, against f32", out, ref, 2e-2,
                  bulk=FLASH_LARGE_OUT_BULK)
        flash_by_magnitude(out, ref)
        e4 = (out.float() - ref)[band].abs().max().item()
        d_bf = (out.float() - chunked_attention(q, k, v, **kw).float()).abs().max().item()
        log(f"[kernel] flash_attention [{kind}] {zname}: {n4} outputs in [4, 8), max error "
            f"there {e4:.3e} (half an ulp 1.5625e-2, limit 2e-2); {d_bf:.3e} from the bf16 "
            "plain output (a record)")
        flash_large_out[zname] = {"shape": label, "n_in_4_8": n4, "max_abs_err_in_4_8": e4,
                                  "max_abs_err": e, "max_abs_diff_from_bf16_plain": d_bf}

    def ring_pos(L, pos, written=None):
        """Slot positions of a ring of L slots holding positions <= pos (p at
        p % L), or only the first ``written``; unwritten slots hold 2**30."""
        ring = np.full(L, INVALID, np.int64)
        for p in range(0 if written is not None else max(0, pos - L + 1),
                       (written - 1 if written is not None else pos) + 1):
            ring[p % L] = p
        return ring

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
    half = ring_pos(1024, 511, 512)
    for window in (4096, 0):
        flash_case(f"decode Sq1 L1024 half-invalid w{window}", 4, 8, 4, 1, 1024,
                   256, True, window, 50.0, torch.bfloat16, 511, half)
    # a wrapped ring: position p lives at slot p % L
    ring = ring_pos(1024, 1500)
    flash_case("decode wrapped ring L1024 w256", 4, 8, 4, 1, 1024, 256, True, 256,
               50.0, torch.bfloat16, 1500, ring)
    flash_case("decode wrapped ring L1024 w256 f32", 2, 8, 4, 1, 1024, 256, True, 256,
               50.0, torch.float32, 1500, ring)
    # jamba's attention layer: Hq 32 over Hkv 8, hd 128, full causal, no softcap
    for dt in (torch.bfloat16, torch.float32):
        flash_case(f"jamba prefill B4 S512 Hq32 Hkv8 hd128 {dt}", 4, 32, 8, 512, 512,
                   128, True, 0, 0.0, dt, 0)
        flash_case(f"jamba decode Sq1 L1024 half-invalid {dt}", 4, 32, 8, 1, 1024,
                   128, True, 0, 0.0, dt, 511, half)
    # the zoo's groups at their serving shapes, hd 128: yi 32 over 4 (G 8),
    # grok 48 over 8 (G 6) with its softcap 30, starcoder2 24 over 2 (G 12);
    # groups of 6 and 12 are not powers of two; phi3 32 over 32 (G 1) at hd
    # 96, kimi 64 over 8 (G 8) at hd 112
    for zname in (YI, GROK, STARCODER, PHI3, KIMI):
        zc = get_config(zname)
        Hq, Hkv, hd, cap = zc.n_heads, zc.n_kv_heads, zc.head_dim, zc.attn_softcap
        tag = f"{zname} Hq{Hq} Hkv{Hkv} G{Hq // Hkv} hd{hd} cap{cap}"
        flash_case(f"{tag} prefill B4 S512 bf16", 4, Hq, Hkv, 512, 512, hd, True, 0, cap,
                   torch.bfloat16, 0, want="tensor_core")
        flash_case(f"{tag} decode Sq1 L1024 half-invalid bf16", 4, Hq, Hkv, 1, 1024, hd,
                   True, 0, cap, torch.bfloat16, 511, half, want="split_kv")
        flash_case(f"{tag} decode wrapped ring L1024 bf16", 4, Hq, Hkv, 1, 1024, hd, True, 0,
                   cap, torch.bfloat16, 1500, ring_pos(1024, 1500), want="split_kv")
    # the FMA kernel (f32) at phi3's and kimi's head dims and groups
    for zname in (PHI3, KIMI):
        zc = get_config(zname)
        Hq, Hkv, hd = zc.n_heads, zc.n_kv_heads, zc.head_dim
        tag = f"{zname} Hq{Hq} Hkv{Hkv} G{Hq // Hkv} hd{hd}"
        flash_case(f"{tag} prefill B1 S128 f32", 1, Hq, Hkv, 128, 128, hd, True, 0, 0.0,
                   torch.float32, 0, want="fma")
        flash_case(f"{tag} decode Sq1 L1024 half-invalid f32", 4, Hq, Hkv, 1, 1024, hd, True,
                   0, 0.0, torch.float32, 511, half, want="fma")
    # where |out| reaches 4: gemma2's local layer (window 4096, softcap 50),
    # phi3's and kimi's prefill
    flash_large_out_case(ARCH, cfg0.window)
    flash_large_out_case(PHI3, 0)
    flash_large_out_case(KIMI, 0)
    # both bf16 kernels at every head dim; ragged tiles (33 x 65, 100 x 100)
    bf16 = torch.bfloat16
    for hd in HEAD_DIMS:
        flash_case(f"B2 Hq4 Hkv2 96x96 hd{hd} cap50 bf16", 2, 4, 2, 96, 96, hd, True, 0,
                   50.0, bf16, 0)
        flash_case(f"decode Sq1 ring L300 251 written hd{hd} cap50 bf16", 2, 8, 4, 1, 300,
                   hd, True, 0, 50.0, bf16, 250, ring_pos(300, 250, 251))
    flash_case("B1 Hq2 Hkv1 33x65 hd32 bf16", 1, 2, 1, 33, 65, 32, True, 0, 0.0, bf16, 32)
    flash_case("B2 Hq8 Hkv4 100x100 hd256 w40 cap50 bf16", 2, 8, 4, 100, 100, 256, True,
               40, 50.0, bf16, 0)
    # a ring with 8 of 1024 slots written: most splits find no key
    flash_case("decode Sq1 L1024 8 written hd256 bf16", 4, 8, 4, 1, 1024, 256, True, 0,
               50.0, bf16, 7, ring_pos(1024, 7, 8))
    flash_case("decode wrapped ring L1024 w256 hd128 G4 bf16", 4, 32, 8, 1, 1024, 128,
               True, 256, 0.0, bf16, 1500, ring_pos(1024, 1500))
    # the dispatch's edge: Sq x G = 16 is split-KV, 17 the tensor-core kernel
    flash_case("Sq8 x G2 = 16 ring L256 w32 bf16", 1, 8, 4, 8, 256, 64, True, 32, 30.0,
               bf16, 120, ring_pos(256, 127))
    flash_case("Sq17 x G1 = 17 ring L256 w32 bf16", 1, 1, 1, 17, 256, 64, True, 32, 30.0,
               bf16, 120, ring_pos(256, 136))

    log(f"[kernel] flash_attention bf16 max_abs_err by |ref|: {json.dumps(flash_bf16_by_mag)}")
    log(f"[kernel] flash_attention where |ref| reaches 4: {json.dumps(flash_large_out)}")

    # gmm: f32 sums over D in another order; bf16 output rounded once on both
    # sides, so the two may differ by one bf16 ulp of the value (2**-7 rel.)
    gmm_tol = {torch.float32: (2e-4, 0.0), torch.bfloat16: (1e-2, 2 ** -7)}
    jamba_prefill_sizes = skewed_sizes(BATCH * PROMPT * hcfg.top_k, hcfg.n_experts, 5)
    jamba_decode_sizes = [2, 0, 1, 0, 0, 1, 0, 0, 2, 0, 0, 0, 1, 0, 0, 1]   # 8 rows

    gmm_err_by_kernel = {"tiled": 0.0, "decode": 0.0, "small": 0.0}

    def gmm_counts():
        return {"tiled": gmm.launches_tiled, "decode": gmm.launches_decode,
                "small": gmm.launches_small}


    def gmm_case(label, sizes, D, Fo, dt, scale=1.0, tail=0, beside=(), want=None):
        """``tail`` rows past the last group, whose output must be 0; each
        kernel named in ``beside`` is held on the same inputs too, called
        past the dispatch; ``want``, where given, the kernel that must serve."""
        x = td(sum(sizes) + tail, D, dtype=dt)
        w = td(len(sizes), D, Fo, dtype=dt, scale=scale)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        kind, before = gmm_kernel_for(x, w), gmm_counts()
        assert want in (None, kind), (label, kind, want)
        out = gmm(x, w, gs)
        moved = {n: c - before[n] for n, c in gmm_counts().items()}
        assert moved == {n: int(n == kind) for n in moved}, (label, kind, moved)
        ref = gmm_ref(x, w, gs)
        e = check("gmm", f"[{kind}] {label} {dt}", out, ref, *gmm_tol[dt])
        gmm_err_by_kernel[kind] = max(gmm_err_by_kernel[kind], e)
        assert not out[sum(sizes):].any(), f"gmm {label}: rows past the groups are not 0"
        for other in beside:      # NaN wherever the kernel writes nothing
            o = torch.full_like(out, math.nan)
            gmm_launch(other, x, w, gs, o)
            e = check("gmm", f"[{other}, past the dispatch] {label} {dt}", o, ref,
                      *gmm_tol[dt])
            gmm_err_by_kernel[other] = max(gmm_err_by_kernel[other], e)

    for dt in (torch.float32, torch.bfloat16):
        # tests/test_kernels.py::test_gmm_vs_ragged_dot
        for sizes, D, Fo in [([30, 0, 17, 40, 13], 32, 48), ([4, 4, 4, 4], 16, 16),
                             ([128], 64, 32), ([0, 0, 50], 32, 64)]:
            gmm_case(f"sizes {sizes} D{D} F{Fo}", sizes, D, Fo, dt)
        # jamba's expert FFN: up/gate (4096 -> 14336) and down (14336 -> 4096),
        # at prefill (B4 x 512 tokens x top-2) and decode (B4 x top-2 = 8 rows)
        d, f = hcfg.d_model, hcfg.expert_d_ff
        # the small kernel still serves bf16 calls of odd widths or
        # alignments: hold it in bf16 at jamba's decode shapes too
        for tag, sizes in (("prefill", jamba_prefill_sizes), ("decode", jamba_decode_sizes)):
            beside = ("small",) if tag == "decode" and dt == torch.bfloat16 else ()
            gmm_case(f"jamba {tag} up T{sum(sizes)} {d}->{f} sizes {sizes}", sizes, d, f,
                     dt, d ** -0.5, beside=beside)
            gmm_case(f"jamba {tag} down T{sum(sizes)} {f}->{d}", sizes, f, d, dt, f ** -0.5,
                     beside=beside)
    # the tiled kernel's edges (bf16; f32 stays on the small kernel)
    for label, sizes, tail, D, Fo in [
            ("empty and 1-row groups, sizes off 128", [0, 1, 200, 77, 0, 300], 0, 256, 384),
            ("50 rows past the last group", [130, 1, 0, 5], 50, 512, 256),
            ("D200 F328: multiples of 8, not of 32", [100, 28, 0, 300], 0, 200, 328),
            (f"T{TILE_M - 1}, below the edge", [60, 0, 67], 0, 256, 256),
            (f"T{TILE_M}, at the edge", [60, 0, 68], 0, 256, 256),
            # the decode kernel's edges: its 16-row slots, K steps of 64
            ("T1", [0, 1, 0, 0], 0, 4096, 1024),
            ("a group of 16 rows, one slot", [16, 0, 1], 0, 512, 512),
            ("a group of 17 rows, two slots", [17, 2, 0], 0, 512, 512),
            ("a group of 33 rows, three slots", [33, 0, 0, 5], 0, 512, 512),
            ("empty groups between full ones", [3, 0, 0, 0, 4, 0, 0, 1], 0, 1024, 512),
            ("20 rows past the last group, T34", [5, 0, 9], 20, 512, 256),
            ("D200 F328 below the edge: multiples of 8, not of 64", [40, 28, 0, 30], 0, 200,
             328)]:
        gmm_case(f"{label} sizes {sizes} D{D} F{Fo}", sizes, D, Fo, torch.bfloat16,
                 D ** -0.5, tail)
    # grok-1's expert FFN, 8 experts of 6144 -> 32768 (1.61e9 weights a
    # projection: 64-bit offsets) and back (K = 32768 f32 sums), at prefill
    # (B4 x 512 tokens x top-2, one expert empty: the tiled kernel, 256
    # column tiles at up) and decode (8 rows: the decode kernel)
    gd, gf = gfull.d_model, gfull.expert_d_ff
    for tag, sizes, want in (
            ("prefill", skewed_sizes(BATCH * PROMPT * gfull.top_k, gfull.n_experts, 5), "tiled"),
            ("decode", [2, 1, 0, 1, 2, 0, 1, 1], "decode")):
        gmm_case(f"grok {tag} up T{sum(sizes)} {gd}->{gf} sizes {sizes}", sizes, gd, gf,
                 torch.bfloat16, gd ** -0.5, want=want)
        gmm_case(f"grok {tag} down T{sum(sizes)} {gf}->{gd}", sizes, gf, gd, torch.bfloat16,
                 gf ** -0.5, want=want)
    # kimi-k2's expert FFN, 384 experts of 7168 -> 2048 (5.6e9 weights, 11.3
    # GB a projection) and back, at prefill (B4 x 512 tokens x top-8 = 16,384
    # rows over all 384 experts, one empty: the tiled kernel) and decode (B4 x
    # top-8 = 32 rows, at most 32 experts with rows: the decode kernel, most
    # groups empty); every block walks all 384 group sizes
    kd, kf, kE, kk = kfull.d_model, kfull.expert_d_ff, kfull.n_experts, kfull.top_k
    for tag, sizes, want in (("prefill", skewed_sizes(BATCH * PROMPT * kk, kE, 5), "tiled"),
                             ("decode", routed_sizes(BATCH, kE, kk, seed=2), "decode")):
        n_rows = sum(1 for g in sizes if g)
        gmm_case(f"kimi {tag} up T{sum(sizes)} {kd}->{kf}, {n_rows} of {kE} groups with rows",
                 sizes, kd, kf, torch.bfloat16, kd ** -0.5, want=want)
        gmm_case(f"kimi {tag} down T{sum(sizes)} {kf}->{kd}", sizes, kf, kd, torch.bfloat16,
                 kf ** -0.5, want=want)
    log(f"[kernel] gmm max_abs_err by kernel: {json.dumps(gmm_err_by_kernel)}")

    # selective scan: f32 sums over d_state in another order; bf16 as gmm
    scan_tol = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-2, 2 ** -7)}

    def scan_inputs(B, S, di, st, dt, model_like, strided=False):
        """The JAX test's distributions (``strided``: b and c sliced out of
        one tensor, rows 2 * st + 3 elements apart), or the mamba block's: A =
        -(1..st) as initialised, dt = softplus around its init, b and c
        sliced out of one x_proj output; a nonzero h0."""
        if model_like:
            a = -torch.arange(1, st + 1, dtype=torch.float32, device=dev).expand(di, st).contiguous()
            dtv = F.softplus(td(B, S, di) * 0.5 + math.log(math.e - 1)).to(dt)
            bcd = td(B, S, hcfg.dt_rank + 2 * st, dtype=dt)
            b, c = bcd[..., hcfg.dt_rank:hcfg.dt_rank + st], bcd[..., hcfg.dt_rank + st:]
            d_skip = torch.ones(di, dtype=dt, device=dev)
        else:
            a = -td(di, st).abs()
            dtv = (td(B, S, di).abs() * 0.1 + 0.01).to(dt)
            if strided:
                bc = td(B, S, 2 * st + 3, dtype=dt)
                b, c = bc[..., :st], bc[..., st + 3:]
            else:
                b, c = td(B, S, st, dtype=dt), td(B, S, st, dtype=dt)
            d_skip = torch.ones(di, dtype=dt, device=dev)
        return td(B, S, di, dtype=dt), dtv, a, b, c, d_skip, td(B, di, st, scale=0.2)

    scan_err_by_kernel = {"prefill": 0.0, "sequential": 0.0}
    scan_vs_f32_plain = [0.0]     # the prefill kernel's largest distance from it

    def scan_counts():
        return {"prefill": selective_scan.launches_prefill,
                "sequential": selective_scan.launches_sequential}

    def scan_case(label, B, S, di, st, dt, model_like=False, strided=False, beside=True):
        """One scan through the dispatch, which must move the counter of
        ``kernel_for``'s kernel alone; with ``beside``, the other kernel is
        held on the same inputs too, past the dispatch (NaN wherever it
        writes nothing). The sequential kernel sums in the plain version's
        order and is held to it; the prefill kernel sums in the associative
        form's, and is held to the plain version carried out in f64 (over
        hundreds of steps that barely decay, the f32 plain version's own
        rounding reaches the f32 limit); its distance from the f32 plain
        version is printed beside."""
        args = scan_inputs(B, S, di, st, dt, model_like, strided)
        kind, before = scan_kernel_for(args[0]), scan_counts()
        y, hT = selective_scan(*args)
        moved = {n: c - before[n] for n, c in scan_counts().items()}
        assert moved == {n: int(n == kind) for n in moved}, (label, kind, moved)
        ref32 = selective_scan_ref(*args)
        yardstick = {"sequential": ref32,
                     "prefill": selective_scan_ref(*(x.double() for x in args))}
        other = "sequential" if kind == "prefill" else "prefill"
        yo, ho = torch.full_like(y, math.nan), torch.full_like(hT, math.nan)
        if beside:
            scan_launch(other, *args, yo, ho)
        for name, yk, hk in ((kind, y, hT), (other, yo, ho))[:2 if beside else 1]:
            k = name if name == kind else f"{name}, past the dispatch"
            ry, rh = yardstick[name]
            e = max(check("selective_scan", f"[{k}] {label} {dt} y", yk, ry, *scan_tol[dt]),
                    check("selective_scan", f"[{k}] {label} {dt} hT", hk, rh,
                          *scan_tol[torch.float32]))
            scan_err_by_kernel[name] = max(scan_err_by_kernel[name], e)
            if name == "prefill":      # for the record: its distance from the f32 one
                d32 = [(a.double() - b.double()).abs().max().item()
                       for a, b in ((yk, ref32[0]), (hk, ref32[1]))]
                scan_vs_f32_plain[0] = max(scan_vs_f32_plain[0], *d32)
                log(f"[kernel] selective_scan [{k}] {label} {dt}: {d32[0]:.3e} (y), "
                    f"{d32[1]:.3e} (hT) from the f32 plain version")

    for dt in (torch.float32, torch.bfloat16):
        # tests/test_kernels.py::test_selective_scan_vs_ref, with the
        # sequential kernel held beside as before; then, for the prefill
        # kernel, S = 77 (two tiles, runs cut short), S = 600 (ten tiles), di
        # = 130 (an item of 2 channels past 128), b and c strided (rows an
        # odd number of elements apart). The sequential kernel is not held
        # beside these: its f32 sums over hundreds of barely decaying steps
        # stray up to the limit from the plain version's (PERF.md §7)
        for B, S, di, st, strided, beside in [
                (1, 64, 32, 4, False, True), (2, 128, 64, 8, False, True),
                (1, 32, 16, 16, False, True), (2, 77, 40, 5, False, False),
                (2, 600, 24, 16, False, False), (1, 96, 130, 16, False, False),
                (2, 300, 64, 16, True, False)]:
            scan_case(f"B{B} S{S} di{di} st{st}" + (" b, c strided" if strided else ""),
                      B, S, di, st, dt, strided=strided, beside=beside)
        di, st = hcfg.ssm_d_inner, hcfg.ssm_d_state
        scan_case(f"jamba prefill B{BATCH} S{PROMPT} di{di} st{st}", BATCH, PROMPT, di, st,
                  dt, True)
        scan_case(f"jamba decode B{BATCH} S1 di{di} st{st} h0!=0", BATCH, 1, di, st, dt, True)
    # long prompts, f32, states that barely decay: no f32 scan holds 2e-5
    # against the f64 one there (the f32 plain version's step-by-step
    # rounding strays furthest); the prefill kernel must be nearer it
    scan_long = {}
    for B, S, di, st in [(2, 1024, 64, 16), (2, 2048, 64, 16)]:
        args = scan_inputs(B, S, di, st, torch.float32, False)
        kind, before = scan_kernel_for(args[0]), scan_counts()
        y, hT = selective_scan(*args)
        assert kind == "prefill" and scan_counts()["prefill"] == before["prefill"] + 1
        ry, rh = selective_scan_ref(*(x.double() for x in args))
        py, ph = selective_scan_ref(*args)
        d = {k: max((yk.double() - ry).abs().max().item(), (hk.double() - rh).abs().max().item())
             for k, (yk, hk) in {"prefill": (y, hT), "f32 plain": (py, ph)}.items()}
        ok = d["prefill"] <= d["f32 plain"]
        scan_long[f"B{B} S{S} di{di} st{st} f32"] = d
        log(f"[kernel] selective_scan [prefill] B{B} S{S} di{di} st{st} float32: "
            f"{d['prefill']:.3e} from the f64 scan, the f32 plain version {d['f32 plain']:.3e}: "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, (S, d)
    log(f"[kernel] selective_scan max_abs_err by kernel: {json.dumps(scan_err_by_kernel)}; "
        f"the prefill kernel's largest distance from the f32 plain version "
        f"{scan_vs_f32_plain[0]:.3e}")

    def served_on_card_and_cpu(label, rcfg):
        rparams = init_params(rcfg, torch.Generator().manual_seed(0), device="cpu")
        prompts = [rng.integers(0, rcfg.vocab_size, size=12) for _ in range(3)]
        outs = {}
        for d in ("cpu", "cuda"):
            eng = ServingEngine(rcfg, rparams.to(d), batch_size=3, max_seq=64, device=d)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, p, max_new_tokens=6))
            outs[d] = [r.output for r in eng.run_batch()]
        log(f"[reduced] {label} tokens cpu {outs['cpu']} cuda {outs['cuda']}")
        assert outs["cpu"] == outs["cuda"], f"{label}: card and CPU disagree"

    # the reduced models, served on the card and on the CPU, must agree
    served_on_card_and_cpu(ARCH, get_config(ARCH).reduced())
    served_on_card_and_cpu(f"{HYBRID} 8-block pattern", dataclasses.replace(
        hcfg.reduced(), pattern=hcfg.pattern, n_layers=HYBRID_LAYERS))
    # the zoo's reduced configs (f32: the FMA flash kernel, the block
    # RMSNorm, the small gmm; starcoder2's LayerNorm and GELU plain on both),
    # one layer and a 2-layer stack
    for zname in (YI, GROK, STARCODER, PHI3, KIMI):
        zc = get_config(zname).reduced()
        served_on_card_and_cpu(f"{zname} reduced", zc)
        served_on_card_and_cpu(f"{zname} reduced, 2 layers",
                               dataclasses.replace(zc, n_layers=2 * len(zc.pattern)))
    # phi3 and kimi reduced at their own head dims (the FMA flash kernel at
    # 96 and 112)
    for zname, dims in REAL_HEAD_DIM.items():
        served_on_card_and_cpu(f"{zname} reduced at hd {dims['head_dim']}",
                               dataclasses.replace(get_config(zname).reduced(), **dims))

    # the search's trial shapes: yi-9b reduced in f32 at batch 8 x 64 tokens
    # (the block RMSNorm, the FMA flash kernel)
    trial_cfg = get_config(YI).reduced()
    rms_case(f"the search's trial rows ({SEARCH_BATCH}, {SEARCH_SEQ}, {trial_cfg.d_model}) f32",
             t(SEARCH_BATCH, SEARCH_SEQ, trial_cfg.d_model), t(trial_cfg.d_model) + 1.0,
             want="block")
    flash_case(f"the search's trial B{SEARCH_BATCH} S{SEARCH_SEQ}", SEARCH_BATCH,
               trial_cfg.n_heads, trial_cfg.n_kv_heads, SEARCH_SEQ, SEARCH_SEQ,
               trial_cfg.head_dim, True, 0, 0.0, torch.float32, 0, want="fma")

    phase_done("2 kernels vs plain")

    # -- 3. serve ------------------------------------------------------------
    def serve_model(cfg, params):
        def requests():
            r = np.random.default_rng(0)
            return [Request(i, r.integers(0, cfg.vocab_size, size=PROMPT),
                            max_new_tokens=NEW) for i in range(N_REQ)]

        engine = ServingEngine(cfg, params, BATCH, MAX_SEQ, device=dev)
        finite, steps = [], {"prefill": 0, "decode": 0}

        def recorded(step, kind):
            def run(*args):
                logits, cache = step(*args)
                finite.append(torch.isfinite(logits).all())
                steps[kind] += 1
                return logits, cache
            return run

        engine._prefill = recorded(engine._prefill, "prefill")
        engine._decode = recorded(engine._decode, "decode")
        for r in requests():
            engine.submit(r)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run_batch()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {name: op.launches for name, op in kernel_ops.items()}
        by_kernel, gmm_by_kernel, rms_by_kernel = flash_counts(), gmm_counts(), rms_counts()
        scan_by_kernel = scan_counts()
        forwards = len(finite)
        expect = per_forward(cfg)
        log(f"[serve] {len(done)} requests, {forwards} forwards ({steps}), launches "
            f"{launches}, flash by kernel {by_kernel}, gmm by kernel {gmm_by_kernel}, "
            f"rmsnorm by kernel {rms_by_kernel}, selective_scan by kernel {scan_by_kernel}")
        assert forwards == (N_REQ // BATCH) * (1 + NEW), forwards
        assert len(done) == N_REQ
        assert all(len(r.output) == NEW and all(0 <= x < cfg.vocab_size for x in r.output)
                   for r in done), "bad outputs"
        assert all(bool(f) for f in finite), "non-finite logits"
        for name, n in expect.items():
            assert launches[name] == n * forwards, (name, launches[name], n * forwards)
        # bf16 rows of the config's width: on the warp kernel where it is
        # built for that width (WARP_WIDTHS), else on the block kernel
        n_rms = expect["rmsnorm"]
        rms_served = "warp" if cfg.d_model in RMS_WARP_WIDTHS else "block"
        assert rms_by_kernel == {k: n_rms * forwards * (k == rms_served)
                                 for k in ("warp", "block")}, rms_by_kernel
        log(f"[serve] rmsnorm per forward: {n_rms} {rms_served} calls (d_model "
            f"{cfg.d_model}; norm {cfg.norm}: LayerNorm is plain PyTorch)")
        # the scan: the prefill kernel at prefill, the sequential one at decode
        n_scan = expect["selective_scan"]
        assert scan_by_kernel == {"prefill": n_scan * steps["prefill"],
                                  "sequential": n_scan * steps["decode"]}, (scan_by_kernel, steps)
        log(f"[serve] selective_scan per forward: {n_scan} prefill calls per prefill, "
            f"{n_scan} sequential calls per decode step")
        # bf16 attention: the tensor-core kernel at prefill, split-KV at decode
        n_attn = expect["flash_attention"]
        assert by_kernel == {"split_kv": n_attn * steps["decode"],
                             "tensor_core": n_attn * steps["prefill"], "fma": 0}, (
            by_kernel, steps)
        log(f"[serve] flash per forward: {n_attn} tensor-core calls per prefill, "
            f"{n_attn} split-KV calls per decode step")
        # bf16 grouped matmul: the tiled kernel at prefill, the decode one at
        # decode, the small one never
        n_gmm = expect["gmm"]
        assert gmm_by_kernel == {"tiled": n_gmm * steps["prefill"],
                                 "decode": n_gmm * steps["decode"],
                                 "small": 0}, (gmm_by_kernel, steps)
        log(f"[serve] gmm per forward: {n_gmm} tiled calls per prefill, "
            f"{n_gmm} decode calls per decode step, 0 small")
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
        serve = {"arch": cfg.name, "n_layers": cfg.n_layers,
                 "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
                 "tokens_per_s": N_REQ * NEW / serve_s, "serve_s": serve_s,
                 "first_run_s": first_s, "batch": BATCH, "prompt_len": PROMPT,
                 "max_new": NEW, "requests": N_REQ,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log("[serve] " + json.dumps(serve))

        # where a step's time goes: device busy share and the top kernels
        def profiled(label, fn, iters=3):
            """``iters`` calls of ``fn`` under the profiler, per call: the
            device's events in a session that is retaken, as phase 4's are,
            when it lost kernel events (``profiled_session``: the port's
            kernels as many as the launch counters read in one call before
            it, a split-KV call launching its combine too), then the host's
            in another."""
            zero_counts()
            fn()
            torch.cuda.synchronize()
            ours = (sum(op.launches for op in kernel_ops.values())
                    + flash_attention.launches_split_kv)
            kern, wall_ms = profiled_session(fn, iters, ours=ours)
            busy_ms = sum(a.self_device_time_total for a in kern) / 1e3 / iters
            log(f"[profile] {label}: wall {wall_ms:.3f} ms under the profiler, "
                f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
                f"{sum(a.count for a in kern) // iters} kernels ({ours} the port's); "
                f"per call, mean of {iters}")
            for a in sorted(kern, key=lambda a: -a.self_device_time_total)[:10]:
                log(f"[profile]   {a.self_device_time_total / 1e3 / iters:9.3f} ms "
                    f"{a.count // iters:5d}x {a.key[:90]}")
            # where the host's time goes (the profiler's own cost included),
            # from a session of its own: the device's events are read above
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            host = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU]
            log(f"[profile]   host: {sum(a.self_cpu_time_total for a in host) / 1e3 / iters:.3f} "
                f"ms self CPU time in {sum(a.count for a in host) // iters} events, the most:")
            for a in sorted(host, key=lambda a: -a.self_cpu_time_total)[:6]:
                log(f"[profile]   host {a.self_cpu_time_total / 1e3 / iters:9.3f} ms "
                    f"{a.count // iters:5d}x {a.key[:90]}")
            return busy_ms

        serve["prefill_busy_ms"] = profiled(
            f"{cfg.name} prefill", lambda: prefill(params, {"tokens": tokens}, cache))
        serve["decode_busy_ms"] = profiled(f"{cfg.name} decode step", one_decode)
        # any host sync in a decode step (a .item(), a boolean index, a
        # bincount, ...) raises in this mode
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            one_decode()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[sync] {cfg.name}: one decode step ran with no host sync "
            "(set_sync_debug_mode('error'))")
        return (launches, expect, forwards, by_kernel, gmm_by_kernel, rms_by_kernel,
                scan_by_kernel, serve)

    def init_on_card(cfg, note=""):
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()    # what an earlier phase left behind
        torch.cuda.reset_peak_memory_stats()    # the peak of this model's serving alone
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        log(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
            f"vocab {cfg.vocab_size} {cfg.dtype}, "
            f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}B params "
            f"initialised in {time.perf_counter() - t0:.2f}s ({held / 1e9:.3f} GB "
            f"allocated on the card before){note}")
        return params

    def probe(cfg, params):
        """One prefill of the first batch of prompts and the decode step after
        it, run after the counted serve: the largest |attention output| of
        each (the flash kernels' outputs, as each attention layer multiplies
        them by its ``wo``; from |ref| >= 4 one bf16 ulp, 3.1e-2, exceeds
        phase 2's 2e-2 limit, and ``flash_large_out_case`` holds the kernel
        there against the f32 plain version) and, for a model with MoE
        layers, the group sizes each routes (its router's top-k experts,
        counted as ``moe_local`` counts them), the traffic phase 4 times gmm
        at, and how many experts get no row. A ``TorchFunctionMode`` sees
        both calls; no module is patched."""
        from torch.overrides import TorchFunctionMode
        wo = {t.untyped_storage().data_ptr() for n, t in params.named_parameters()
              if n.endswith(".wo")}
        routed, amax = [], []

        class Watch(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if (func is torch.Tensor.matmul      # ``a @ b`` reaches the mode so
                        and args[1].untyped_storage().data_ptr() in wo):
                    amax.append(args[0].abs().amax())
                elif func is torch.topk:
                    routed.append(torch.bincount(out.indices.reshape(-1),
                                                 minlength=cfg.n_experts))
                return out

        prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)
        r = np.random.default_rng(0)
        tokens = torch.from_numpy(np.stack([r.integers(0, cfg.vocab_size, size=PROMPT)
                                            for _ in range(BATCH)])).to(dev)
        cache = init_cache(cfg, BATCH, MAX_SEQ, device=dev)
        with Watch():
            logits, cache = prefill(params, {"tokens": tokens}, cache)
            n_moe, n_attn = len(routed), len(amax)
            decode(params, cache, logits.argmax(-1)[:, None], PROMPT)
        assert n_attn == per_forward(cfg)["flash_attention"], (n_attn, per_forward(cfg))
        assert 3 * n_moe == per_forward(cfg)["gmm"], (n_moe, per_forward(cfg))
        attn = {"prefill": max(a.item() for a in amax[:n_attn]),
                "decode": max(a.item() for a in amax[n_attn:])}
        over = max(attn.values()) >= 4.0
        log(f"[attn] {cfg.name}: largest |attention output| {json.dumps(attn)}"
            + (": reaches 4, where phase 2 holds the kernel to the f32 plain version"
               if over else ": below 4"))
        found = {"attn_abs_max": attn}
        if routed:
            sizes = {"prefill": [s.tolist() for s in routed[:n_moe]],
                     "decode": [s.tolist() for s in routed[n_moe:]]}
            for step, per_layer in sizes.items():
                for i, s in enumerate(per_layer):
                    log(f"[routing] {cfg.name} {step} MoE layer {i}: "
                        f"{sum(1 for n in s if n)} of {len(s)} experts get rows, sizes {s}")
            found["routed"] = {step: per_layer[0] for step, per_layer in sizes.items()}
            found["experts_without_rows"] = {step: [sum(1 for n in s if not n) for s in per_layer]
                                             for step, per_layer in sizes.items()}
            log(f"[routing] {cfg.name}: experts with no row, per MoE layer, of {cfg.n_experts}: "
                f"{json.dumps(found['experts_without_rows'])}")
        return found

    def serve_phase(cfg, key, note=""):
        """Serve ``cfg`` at full width (``serve_model``) from seed-0 weights
        drawn on the card, probe it, and free it before the next model."""
        params = init_on_card(cfg, note)
        paths[key] = serve_model(cfg, params)
        probes[key] = probe(cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    paths, probes = {}, {}
    cfg = get_config(ARCH)
    serve_phase(cfg, ARCH)

    phase_done("3 serve gemma2-2b")

    # -- 3b. serve full-width jamba, one period of its block ----------------
    jcfg = dataclasses.replace(hcfg, n_layers=HYBRID_LAYERS)
    jamba_key = f"{HYBRID}-{HYBRID_LAYERS}L"
    serve_phase(jcfg, jamba_key,
                f"; cut to {HYBRID_LAYERS} of {hcfg.n_layers} layers (one period of the "
                f"block; all {hcfg.n_layers} are {count_params(hcfg) / 1e9:.2f}B params, "
                f"{2 * count_params(hcfg) / 1e9:.0f} GB in bf16, over one card's 80 GB)")
    routed = probes[jamba_key]["routed"]

    phase_done("3b serve jamba-8")

    # -- 3c-3e. serve yi-9b and starcoder2-3b whole, grok-1 cut ---------------
    ycfg, scfg = get_config(YI), get_config(STARCODER)
    serve_phase(ycfg, YI, "; nothing cut")
    phase_done("3c serve yi-9b")
    gcfg = dataclasses.replace(gfull, n_layers=GROK_LAYERS)
    grok_key = f"{GROK}-{GROK_LAYERS}L"
    serve_phase(gcfg, grok_key, (
        f"; cut to {GROK_LAYERS} of {gfull.n_layers} layers, every width as published (one "
        f"layer with the embeddings' share is {count_params(dataclasses.replace(gfull, n_layers=1)) / 1e9:.2f}B; "
        f"{GROK_LAYERS + 1} layers are {2 * count_params(dataclasses.replace(gfull, n_layers=GROK_LAYERS + 1)) / 1e9:.1f} GB "
        f"in bf16, all {gfull.n_layers} {count_params(gfull) / 1e9:.1f}B params, "
        f"{2 * count_params(gfull) / 1e9:.0f} GB, over one card's 80 GB)"))
    routed_grok = probes[grok_key]["routed"]
    phase_done("3d serve grok-6")
    serve_phase(scfg, STARCODER, "; nothing cut")
    phase_done("3e serve starcoder2-3b")

    # -- 3f-3g. serve phi3-mini-3.8b whole, kimi-k2 cut to one layer -------
    pcfg = get_config(PHI3)
    serve_phase(pcfg, PHI3, "; nothing cut")
    phase_done("3f serve phi3-mini-3.8b")
    kcfg = dataclasses.replace(kfull, n_layers=KIMI_LAYERS)
    kimi_key = f"{KIMI}-{KIMI_LAYERS}L"
    kimi_2 = 2 * count_params(dataclasses.replace(kfull, n_layers=2)) / 1e9
    serve_phase(kcfg, kimi_key, (
        f"; cut to {KIMI_LAYERS} of {kfull.n_layers} layers, one period of its pattern, every "
        f"width as published (2 layers are {kimi_2:.1f} GB in bf16, all {kfull.n_layers} "
        f"{count_params(kfull) / 1e12:.2f}T params)"))
    routed_kimi = probes[kimi_key]["routed"]
    log(f"[profile] phase 3's profiler sessions: {SESSIONS}")
    SESSIONS.update(taken=0, retaken=0)
    phase_done("3g serve kimi-1")

    # -- 4. times at the serving shapes --------------------------------------
    flush = L2Flush()
    dtype_name = {torch.bfloat16: "bf16", torch.float32: "f32"}

    def rms_times(rows, D, dtype=torch.bfloat16):
        """The serving kernel's row, with the block kernel timed on the same
        inputs past the dispatch where the warp kernel serves."""
        x = t(rows, D, dtype=dtype)
        sc = (t(D) + 1.0).to(dtype)
        nbytes = 2 * x.numel() * x.element_size() + sc.numel() * sc.element_size()
        b_ms, b_by, _ = bound(nbytes, 4 * x.numel(), str(dtype).split(".")[-1])
        kind = rms_kernel_for(x, sc)
        res = {"shape": f"({rows}, {D}) {dtype_name[dtype]}", "kernel": kind,
               "ms": device_ms(lambda: rmsnorm(x, sc), flush),
               "event_ms": cuda_ms(lambda: rmsnorm(x, sc)),
               "plain_ms": device_ms(lambda: rmsnorm_ref(x, sc), flush),
               "library_ms": device_ms(lambda: torch.nn.functional.rms_norm(
                   x, (D,), sc, 1e-6), flush),
               "bound_ms": b_ms, "bound_by": b_by}
        if kind == "warp":
            o = torch.empty_like(x)
            res["block_kernel_ms"] = device_ms(
                lambda: rms_launch("block", x, sc, o, rows, D, 1e-6), flush)
        return res

    def flash_times(acfg, Sq, Skv, q_offset, kv_pos, window, dtype=torch.bfloat16, B=BATCH):
        Hq, Hkv, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
        q = t(B, Sq, Hq, hd, dtype=dtype)
        k, v = t(B, Skv, Hkv, hd, dtype=dtype), t(B, Skv, Hkv, hd, dtype=dtype)
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
        nbytes = q.element_size() * (2 * q.numel() + 2 * B * Hkv * hd * read) + (
            4 * Skv if kp is not None else 0)
        b_ms, b_by, _ = bound(nbytes, flops, str(dtype).split(".")[-1])
        cap = acfg.attn_softcap
        kw = dict(causal=True, window=window, softcap=cap, q_offset=q_offset)
        # a split-KV call is its split kernel and its combine kernel
        by_kernel = device_ms_by_kernel(lambda: flash_attention(q, k, v, kv_pos=kp, **kw),
                                        flush)
        res = {"shape": f"B{B} Sq{Sq} Skv{Skv} Hq{Hq} Hkv{Hkv} hd{hd} {dtype_name[dtype]} "
                        f"w{window} cap{cap}",
               "kernel": kernel_for(q.dtype, Sq, Hq, Hkv),
               "ms": sum(by_kernel.values()), "by_kernel_ms": by_kernel,
               "event_ms": cuda_ms(lambda: flash_attention(q, k, v, kv_pos=kp, **kw)),
               "plain_ms": device_ms(lambda: chunked_attention(q, k, v, kv_positions=kp, **kw),
                                     flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_note": "SDPA without the softcap: not the same function" if cap
               else "SDPA: the same function"}
        # SDPA, a yardstick only, without the softcap: causal at prefill; at
        # decode a boolean mask from kv_pos (causal and window)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        if kp is None:
            res["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        else:
            mask = torch.from_numpy(valid).to(dev)[None, None]
            res["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        return res

    def gmm_times(sizes, D, Fo, routing="served routing", beside=("small",), plain_iters=20):
        """The serving kernel's row, and each kernel named in ``beside``
        timed on the same inputs, called past the dispatch. The plain version
        launches several kernels a group: ``plain_iters`` calls of it are
        timed (after one warm-up when fewer than 20)."""
        T, E = sum(sizes), len(sizes)
        x = td(T, D, dtype=torch.bfloat16)
        w = td(E, D, Fo, dtype=torch.bfloat16, scale=D ** -0.5)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        kind = gmm_kernel_for(x, w)
        out = gmm(x, w, gs)
        ref = gmm_ref(x, w, gs)
        e = check("gmm", f"[{kind}] {routing} T{T} {D}->{Fo} bf16", out, ref,
                  *gmm_tol[torch.bfloat16])
        gmm_err_by_kernel[kind] = max(gmm_err_by_kernel[kind], e)
        active = sum(1 for s in sizes if s)     # only these panels are read
        nbytes = 2 * (T * D + active * D * Fo + T * Fo) + 4 * E
        b_ms, b_by, _ = bound(nbytes, 2 * T * D * Fo, "bfloat16")
        # torch._grouped_mm is a yardstick only; the port never calls it
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        lib_out = torch._grouped_mm(x, w, offs=offs)
        res = {"shape": f"T{T} D{D} F{Fo} E{E} ({active} groups with rows, "
                        f"{routing}) bf16",
               "kernel": kind,
               "ms": device_ms(lambda: gmm(x, w, gs), flush),
               "event_ms": cuda_ms(lambda: gmm(x, w, gs)),
               "plain_ms": device_ms(lambda: gmm_ref(x, w, gs), flush, iters=plain_iters,
                                     warmup=3 if plain_iters >= 20 else 1),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": device_ms(lambda: torch._grouped_mm(x, w, offs=offs), flush),
               "library_max_abs_diff": (lib_out.float() - out.float()).abs().max().item()}
        for other in beside:
            # a yardstick of this run; the served path never takes it here
            assert other != kind, (other, kind)
            o = torch.full_like(out, math.nan)      # NaN wherever it writes nothing
            gmm_launch(other, x, w, gs, o)
            e = check("gmm", f"[{other}, timed beside {kind}] {routing} T{T} {D}->{Fo} bf16",
                      o, ref, *gmm_tol[torch.bfloat16])
            gmm_err_by_kernel[other] = max(gmm_err_by_kernel[other], e)
            res[f"{other}_kernel_ms"] = device_ms(
                lambda: gmm_launch(other, x, w, gs, o), flush)
        return res

    def scan_times(S, model_like=True):
        """The serving kernel's row, with the other kernel timed on the same
        inputs past the dispatch; the mamba block's draws, or the JAX tests'
        (b and c sliced as the block slices them)."""
        di, st = hcfg.ssm_d_inner, hcfg.ssm_d_state
        args = scan_inputs(BATCH, S, di, st, torch.bfloat16, model_like, strided=True)
        n = BATCH * S * di
        # u, dt, y (bf16); the b, c slices; A (f32), D; h0, hT (f32)
        nbytes = 3 * 2 * n + 2 * 2 * BATCH * S * st + 4 * di * st + 2 * di + 2 * 4 * BATCH * di * st
        # per state: dt*A, exp, the state FMA and product, the y FMA;
        # per channel: dt*u and the D*u FMA; one exponential per (t, s) on
        # the SFU
        b_ms, b_by, b_unit = bound(nbytes, n * (7 * st + 3), "float32", exps=n * st)
        kind = scan_kernel_for(args[0])
        other = "sequential" if kind == "prefill" else "prefill"
        y, hT = torch.empty_like(args[0]), torch.empty_like(args[-1])
        draws = "the mamba block's draws" if model_like else "the JAX tests' draws"
        return {"shape": f"B{BATCH} S{S} di{di} st{st} bf16, {draws}", "kernel": kind,
                "ms": device_ms(lambda: selective_scan(*args), flush),
                "event_ms": cuda_ms(lambda: selective_scan(*args)),
                f"{other}_kernel_ms": device_ms(lambda: scan_launch(other, *args, y, hT), flush),
                "plain_ms": device_ms(lambda: selective_scan_ref(*args), flush,
                                      iters=5 if S > 1 else 20, warmup=1),
                "library_ms": None, "library_note": "no PyTorch call computes the scan",
                "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
                "bound_note": "bytes, f32 FLOPs or exponentials on the SFU "
                              "(16 a clock an SM at the max SM clock), whichever is largest"}

    rms_prefill, rms_decode = rms_times(BATCH * PROMPT, cfg.d_model), rms_times(BATCH, cfg.d_model)
    rms_jamba = {"prefill": rms_times(BATCH * PROMPT, hcfg.d_model),
                 "decode": rms_times(BATCH, hcfg.d_model)}
    fa_prefill = flash_times(cfg, PROMPT, PROMPT, 0, None, cfg.window)
    written = PROMPT + NEW // 2
    half_written = ring_pos(MAX_SEQ, written - 1, written)
    fa_decode = flash_times(cfg, 1, MAX_SEQ, written - 1, half_written, cfg.window)
    fa_jamba = {"prefill": flash_times(hcfg, PROMPT, PROMPT, 0, None, 0),
                "decode": flash_times(hcfg, 1, MAX_SEQ, written - 1, half_written, 0)}
    d, f = hcfg.d_model, hcfg.expert_d_ff
    gmm_prefill = gmm_times(routed["prefill"], d, f)

    def drawn_sizes(batch):
        """A decode step's group sizes at batch ``batch``: top-2 of 16
        experts drawn per token, the first ``batch`` tokens of one seeded
        draw (so batch 128 routes as in earlier runs)."""
        return routed_sizes(batch, hcfg.n_experts, hcfg.top_k, seed=1)

    gmm_more = {"prefill_down": gmm_times(routed["prefill"], f, d),
                "decode": gmm_times(routed["decode"], d, f),
                "decode_down": gmm_times(routed["decode"], f, d)}
    # between the served ends, decode steps of more sequences, up/gate: the
    # decode kernel up to T = 126, then both sides of the 128-row edge and
    # the range up to T = 256, each timed with the kernel of the other side
    for batch, beside in ((16, ("small",)), (32, ("small",)), (63, ("tiled", "small")),
                          (64, ("decode", "small")), (80, ("decode",)), (96, ("decode",)),
                          (112, ("decode",)), (128, ("decode", "small"))):
        sizes = drawn_sizes(batch)
        gmm_more[f"batch{batch}_decode"] = gmm_times(
            sizes, d, f, f"batch-{batch} decode routing", beside)
        if batch == 128:
            gmm_more["batch128_decode_down"] = gmm_times(
                sizes, f, d, "batch-128 decode routing", beside)
    scan_prefill, scan_decode = scan_times(PROMPT), scan_times(1)
    # both sides of the dispatch's edge (kernel_for: the prefill kernel from
    # 32 steps), each with the other kernel beside it
    scan_edge = {f"S{S}": scan_times(S) for S in (31, 32)}
    scan_jax_draws = scan_times(PROMPT, model_like=False)
    # the zoo's rows: flash at yi's, grok's and starcoder2's serving shapes;
    # grok's RMSNorm width on the block kernel; grok's expert FFN at its
    # served routing (inputs drawn after grok-6 was freed: the f32 plain
    # version of one projection alone holds 6.4 GB)
    fa_zoo = {z.name: {"prefill": flash_times(z, PROMPT, PROMPT, 0, None, 0),
                       "decode": flash_times(z, 1, MAX_SEQ, written - 1, half_written, 0)}
              for z in (ycfg, gcfg, scfg, pcfg, kcfg)}
    rms_grok, rms_phi3, rms_kimi = ({"prefill": rms_times(BATCH * PROMPT, z.d_model),
                                     "decode": rms_times(BATCH, z.d_model)}
                                    for z in (gcfg, pcfg, kcfg))
    gd, gf = gcfg.d_model, gcfg.expert_d_ff
    gmm_grok = {f"{step}_{proj}": gmm_times(routed_grok[step], *dims, "grok served routing",
                                            beside=())
                for step in ("prefill", "decode")
                for proj, dims in (("up", (gd, gf)), ("down", (gf, gd)))}
    # kimi's expert FFN at its served routing: 384 experts' weights, 11.3 GB
    # a projection; the plain version launches some 1,500 kernels a call at
    # prefill, so 3 of its calls are timed
    gmm_kimi = {f"{step}_{proj}": gmm_times(routed_kimi[step], *dims, "kimi served routing",
                                            beside=(), plain_iters=3)
                for step in ("prefill", "decode")
                for proj, dims in (("up", (kd, kf)), ("down", (kf, kd)))}
    # the search's trial shapes (yi-9b reduced in f32, batch 8 x 64 tokens):
    # a training step's forward launches the FMA flash kernel once and the
    # block RMSNorm three times
    fa_search = flash_times(trial_cfg, SEARCH_SEQ, SEARCH_SEQ, 0, None, 0, torch.float32,
                            SEARCH_BATCH)
    rms_search = rms_times(SEARCH_BATCH * SEARCH_SEQ, trial_cfg.d_model, torch.float32)
    assert (fa_search["kernel"], rms_search["kernel"]) == ("fma", "block"), (
        fa_search["kernel"], rms_search["kernel"])
    log(f"[times] the search's trial shapes: flash {json.dumps(fa_search)}; rmsnorm "
        f"{json.dumps(rms_search)}")
    log(f"[profile] phase 4's profiler sessions: {SESSIONS}")
    phase_done("4 times")

    # -- 5. train -------------------------------------------------------------
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import DataPipeline
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train.steps import make_train_step
    from repro_torch.train.trainer import Trainer

    del flush
    gc.collect()
    torch.cuda.empty_cache()

    def reduced_steps(rcfg, d):
        """REDUCED_TRAIN_STEPS AdamW steps from seed-0 weights drawn on the
        CPU: each step's loss, aux loss and grad norm."""
        tc = TrainConfig(optimizer="adamw", learning_rate=1e-3)
        params = init_params(rcfg, torch.Generator().manual_seed(0), device="cpu").to(d)
        state, step = init_opt_state(tc, params), make_train_step(rcfg, tc)
        data = DataPipeline(rcfg, 2, 64, seed=0, device=d)
        out = []
        for _ in range(REDUCED_TRAIN_STEPS):
            params, state, m = step(params, state, next(data))
            out.append({k: v.item() for k, v in m.items()})
        return out

    hybrid_train_pattern = hcfg.pattern[HYBRID_TRAIN_PATTERN]
    assert hybrid_train_pattern == (("mamba", "moe"), ("attn", "mlp")), hybrid_train_pattern
    for label, rcfg in ((ARCH, get_config(ARCH).reduced()),
                        (f"{HYBRID} {hybrid_train_pattern}", dataclasses.replace(
                            hcfg.reduced(), pattern=hybrid_train_pattern, n_layers=2)),
                        (STARCODER, scfg.reduced()),
                        *((f"{zname} at hd {dims['head_dim']}",
                           dataclasses.replace(get_config(zname).reduced(), **dims))
                          for zname, dims in REAL_HEAD_DIM.items())):
        cpu, card = reduced_steps(rcfg, "cpu"), reduced_steps(rcfg, dev)
        worst = 0.0
        for i, (a, b) in enumerate(zip(cpu, card)):
            for key in a:
                excess = abs(b[key] - a[key]) - TRAIN_RTOL * abs(a[key])
                worst = max(worst, abs(b[key] - a[key]))
                assert math.isfinite(b[key]) and excess <= TRAIN_ATOL, (label, i, key, a, b)
        log(f"[train] reduced {label}: {REDUCED_TRAIN_STEPS} AdamW steps, card {card}, "
            f"cpu {cpu}; max |card - cpu| {worst:.3e} (limit {TRAIN_ATOL:g} + "
            f"{TRAIN_RTOL:g} * |cpu|) ok")

    def profiled_step(tcfg, trainer):
        """One more step under the profiler, its device time split: the four
        kernels' forwards, each op's plain-recompute backward (the
        ``PlainGrad.backward[...]`` ranges, their matmuls included), cuBLAS
        outside those ranges, the optimizer (the train step's ``optimizer``
        range) and the rest."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.run(1)
            torch.cuda.synchronize()
        ranges = {}

        def kernels_under(ev):
            found = [(k.name, k.duration) for k in ev.kernels]
            for ch in ev.cpu_children:
                found += kernels_under(ch)
            return found

        for ev in prof.events():
            if ev.name == "optimizer" or ev.name.startswith("PlainGrad.backward["):
                ranges.setdefault(ev.name, []).extend(kernels_under(ev))
        # a range's own span on the device (its gpu_user_annotation, which
        # covers the gaps between its kernels) is no kernel: left out
        ranges = {k: [(n, d) for n, d in v if n not in ranges] for k, v in ranges.items()}
        kern = [a for a in device_kernels(prof) if a.key not in ranges]
        busy = sum(a.self_device_time_total for a in kern) / 1e3

        def is_blas(name):
            return any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "nvjet", "cublas"))

        ours = sum(a.self_device_time_total for a in kern if is_port_kernel(a.key)) / 1e3
        blas = sum(a.self_device_time_total for a in kern if is_blas(a.key)) / 1e3
        plain = {k[len("PlainGrad.backward["):-1]: sum(d for _, d in v) / 1e3
                 for k, v in ranges.items() if k != "optimizer"}
        plain_blas = sum(d for k, v in ranges.items() if k != "optimizer"
                         for n, d in v if is_blas(n)) / 1e3
        opt = sum(d for _, d in ranges.get("optimizer", [])) / 1e3
        split = {"device_busy_ms": busy, "forward_kernels_ms": ours,
                 "plain_recompute_backward_ms": sum(plain.values()),
                 "plain_recompute_backward_ms_by_op": plain,
                 "cublas_ms": blas, "cublas_inside_plain_recompute_ms": plain_blas,
                 "cublas_outside_plain_recompute_ms": blas - plain_blas,
                 "optimizer_ms": opt}
        split["other_ms"] = busy - ours - split["plain_recompute_backward_ms"] - (
            blas - plain_blas) - opt
        log(f"[train] {tcfg.name} profiled step: {json.dumps(split)}")
        for a in sorted(kern, key=lambda a: -a.self_device_time_total)[:12]:
            log(f"[profile]   {a.self_device_time_total / 1e3:9.3f} ms {a.count:5d}x "
                f"{a.key[:90]}")
        return split

    def train_model(tcfg, batch, note, lr):
        """TRAIN_STEPS AdamW steps of ``Trainer`` at full width, each one
        ``Trainer.run(1)`` between two CUDA events."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(tcfg, TrainConfig(optimizer="adamw", learning_rate=lr),
                          batch, TRAIN_SEQ, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in trainer.params.parameters())
        log(f"[train] {tcfg.name}: {tcfg.n_layers} layers {tcfg.pattern} d_model "
            f"{tcfg.d_model} {tcfg.dtype}, {n_params / 1e9:.3f}B params, weights + grads "
            f"(bf16) + AdamW moments (f32) {12 * n_params / 1e9:.1f} GB, set up in "
            f"{time.perf_counter() - t0:.1f}s{note}")
        events = []
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            trainer.run(1)
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {name: op.launches for name, op in kernel_ops.items()}
        by = (flash_counts(), gmm_counts(), rms_counts(), scan_counts())
        expect = per_forward(tcfg)
        losses = trainer.losses
        log(f"[train] {tcfg.name}: losses {losses}; launches {launches}, flash by kernel "
            f"{by[0]}, gmm by kernel {by[1]}, rmsnorm by kernel {by[2]}, selective_scan by "
            f"kernel {by[3]}")
        assert all(math.isfinite(x) for x in losses), losses
        assert sum(losses[-3:]) / 3 < losses[0], f"{tcfg.name}: the loss did not fall"
        for name, n in expect.items():
            assert launches[name] == n * TRAIN_STEPS, (name, launches[name], n * TRAIN_STEPS)
        assert by[0] == {"split_kv": 0, "tensor_core": expect["flash_attention"] * TRAIN_STEPS,
                         "fma": 0}
        assert by[1] == {"tiled": expect["gmm"] * TRAIN_STEPS, "decode": 0, "small": 0}
        assert by[2] == {"warp": expect["rmsnorm"] * TRAIN_STEPS, "block": 0}
        assert by[3] == {"prefill": expect["selective_scan"] * TRAIN_STEPS, "sequential": 0}
        log(f"[train] {tcfg.name} per step: {expect} kernel launches, all in the forward")
        step_ms = [s.elapsed_time(e) for s, e in events]
        med = float(np.median(step_ms[2:]))
        bound_ms, active = matmul_bound_ms(tcfg, batch * TRAIN_SEQ)
        res = {"arch": tcfg.name, "n_layers": tcfg.n_layers, "params": n_params,
               "batch": batch, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": lr,
               "step_ms": step_ms, "step_ms_median_3_10": med,
               "matmul_bound_ms": bound_ms, "matmul_bound_weights": active,
               "tokens_per_s": batch * TRAIN_SEQ / (med / 1e3), "run_s": wall_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss_first": losses[0], "loss_last3_mean": sum(losses[-3:]) / 3}
        log("[train] " + json.dumps(res))
        res["profile"] = profiled_step(tcfg, trainer)
        del trainer
        return (launches, expect, TRAIN_STEPS, *by), res

    train_cfgs = [(cfg, "", TRAIN_LR),
                  (dataclasses.replace(hcfg, n_layers=2, pattern=hybrid_train_pattern),
                   f"; cut to 2 of {hcfg.n_layers} layers (two of its block; the "
                   f"{HYBRID_LAYERS}-layer serve cut with AdamW's moments is "
                   f"{12 * count_params(jcfg) / 1e9:.0f} GB, with RMSProp's "
                   f"{8 * count_params(jcfg) / 1e9:.0f} GB)", TRAIN_LR),
                  (scfg, "; nothing cut (LayerNorm and GELU are plain PyTorch)",
                   STARCODER_TRAIN_LR)]
    # not trained here: yi-9b runs gemma2-2b's modules (and at 12 bytes a
    # weight needs 106 GB); one grok-1 layer with the embeddings is 6.53B
    # weights, 78 GB with AdamW's moments
    # phi3-mini-3.8b: starcoder2-3b's 65.45 GB peak (PERF.md §4) scaled by
    # their weights is about 78.6 GB, too close to the card's 80; one kimi
    # layer with AdamW's moments is 233 GB
    log(f"[train] not trained: {YI} ({12 * count_params(ycfg) / 1e9:.0f} GB with AdamW), "
        f"{GROK} (one layer {12 * count_params(dataclasses.replace(gcfg, n_layers=1)) / 1e9:.0f}"
        f" GB with AdamW), {PHI3} ({12 * count_params(pcfg) / 1e9:.0f} GB of weights, grads and "
        f"AdamW moments before activations), {KIMI} (one layer {12 * count_params(kcfg) / 1e9:.0f}"
        " GB with AdamW)")
    trained = {}
    for tcfg, note, lr in train_cfgs:
        path, trained[tcfg.name] = train_model(tcfg, TRAIN_BATCH, note, lr)
        paths[f"train {tcfg.name}-{tcfg.n_layers}L"] = path
    phase_done("5 train")

    # -- 6. search ------------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.completion import expected_alpha
    from repro_torch.core.executor import ThreadCluster
    from repro_torch.core.hypertrick import HyperTrick, dcm_threshold
    from repro_torch.core.search_space import lm_space
    from repro_torch.launch import tune
    from repro_torch.train.trainer import make_lm_objective

    gc.collect()
    torch.cuda.empty_cache()

    def all_counts():
        """The launch counters, and how many calls each kernel served."""
        return ({name: op.launches for name, op in kernel_ops.items()},
                flash_counts(),
                gmm_counts(), rms_counts(), scan_counts())

    def trial_table(res):
        """{trial id: (hparams, status, [metric a phase])} of a search."""
        return {tr.trial_id: (tr.hparams, tr.status.value, [m for m, _ in tr.reports])
                for tr in res.service.db.trials.values()}

    def search(label, argv, arch, w0, phases, steps_per_phase, profiled=False, bar=False):
        """``tune.main(argv)`` on the card. No trial may crash; each trial
        reports 1 to ``phases`` times, all of them when it completed, every
        metric finite; with ``bar`` the best beats a uniform guess
        (-ln vocab). The launch counters must read the steps the trials took
        times ``per_forward`` of the arch's reduced config, each on the f32
        kernels (block RMSNorm, FMA flash, the prefill scan, the small gmm).
        With ``profiled`` the search runs in one CUDA-only profiler session,
        whose summed kernel time over the search's wall time is the device's
        busy share."""
        rcfg = get_config(arch).reduced()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lead_in()
                res = tune.main(argv)
                torch.cuda.synchronize()
                stopped = time.perf_counter()
            stop_s = time.perf_counter() - stopped
        else:
            res = tune.main(argv)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, fa_by, gmm_by, rms_by, scan_by = all_counts()
        summary, table = res.summary(), trial_table(res)
        assert summary["n_trials"] == w0 and len(table) == w0, (label, summary)
        assert "crashed" not in summary["by_status"], (label, summary["by_status"])
        for tid, (hp, status, ms) in table.items():
            assert status in ("completed", "killed"), (label, tid, status)
            assert 1 <= len(ms) <= phases and (status != "completed" or len(ms) == phases), (
                label, tid, status, ms)
            assert all(math.isfinite(m) for m in ms), (label, tid, ms)
        assert 0 < summary["alpha"] <= 1, (label, summary["alpha"])
        if bar:
            assert summary["best_metric"] > -math.log(rcfg.vocab_size), (label, summary)
        steps = steps_per_phase * sum(len(ms) for _, _, ms in table.values())
        expect = per_forward(rcfg)
        log(f"[search] {label}: {steps} trial-steps, launches {launches}, flash by kernel "
            f"{fa_by}, gmm by kernel {gmm_by}, rmsnorm by kernel {rms_by}, selective_scan by "
            f"kernel {scan_by}; per step {expect}")
        for name, n in expect.items():
            assert launches[name] == n * steps, (label, name, launches[name], n * steps)
        assert fa_by == {"split_kv": 0, "tensor_core": 0,
                         "fma": expect["flash_attention"] * steps}, (label, fa_by)
        assert rms_by == {"warp": 0, "block": expect["rmsnorm"] * steps}, (label, rms_by)
        assert gmm_by == {"tiled": 0, "decode": 0, "small": expect["gmm"] * steps}, (label, gmm_by)
        assert scan_by == {"prefill": expect["selective_scan"] * steps, "sequential": 0}, (
            label, scan_by)
        wall = res.wall_time
        out = {"search": label, "arch": rcfg.name, "argv": argv, "trials": w0,
               "nodes": res.n_nodes, "phases": phases, "steps_per_phase": steps_per_phase,
               "batch": SEARCH_BATCH, "seq": SEARCH_SEQ, "wall_s": wall, "run_s": run_s,
               "occupancy": res.occupancy, "alpha": res.service.db.completion_rate(phases),
               "expected_alpha": expected_alpha(SEARCH_R, phases),
               "by_status": summary["by_status"], "best_metric": summary["best_metric"],
               "trial_steps": steps, "trial_steps_per_s": steps / wall,
               "tokens_per_s": steps * SEARCH_BATCH * SEARCH_SEQ / wall,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches_per_step": expect}
        if profiled:
            t0 = time.perf_counter()
            kern = device_kernels(prof, skip_lead_in=True)
            busy_ms = sum(a.self_device_time_total for a in kern) / 1e3
            out.update(device_busy_ms=busy_ms, profiled_wall_s=wall,
                       profiler_stop_s=stop_s, profiler_read_s=time.perf_counter() - t0,
                       device_busy_share=busy_ms / 1e3 / wall,
                       device_kernels=sum(a.count for a in kern),
                       port_kernel_ms=sum(a.self_device_time_total for a in kern
                                          if is_port_kernel(a.key)) / 1e3)
            for a in sorted(kern, key=lambda a: -a.self_device_time_total)[:8]:
                log(f"[profile]   {a.self_device_time_total / 1e3:9.3f} ms {a.count:7d}x "
                    f"{a.key[:90]}")
        log(f"[search] {smi}: " + json.dumps(out))
        return (launches, expect, steps, fa_by, gmm_by, rms_by, scan_by), out, res

    searches = {}
    # 6a: the CLI's defaults, 4 node threads, without the profiler
    path, searches["6a"], res_4 = search(
        f"6a {YI}, {SEARCH_NODES} nodes", [], YI, SEARCH_W0, SEARCH_PHASES, SEARCH_STEPS,
        bar=True)
    paths[f"search {YI} {SEARCH_NODES} nodes"] = path
    phase_done("6a search, 4 node threads")

    # 6b: the same search on one node thread, in one profiler session: the
    # same configurations by trial id (one numpy stream), and every (trial,
    # phase) both trained within SEARCH_NODES_ATOL
    path, searches["6b"], res_1 = search(
        f"6b {YI}, 1 node", ["--nodes", "1"], YI, SEARCH_W0, SEARCH_PHASES, SEARCH_STEPS,
        profiled=True, bar=True)
    paths[f"search {YI} 1 node"] = path
    t4, t1 = trial_table(res_4), trial_table(res_1)
    assert [t4[i][0] for i in sorted(t4)] == [t1[i][0] for i in sorted(t1)], "configs differ"
    pairs = [(i, ph, t4[i][2][ph], t1[i][2][ph]) for i in sorted(t4)
             for ph in range(min(len(t4[i][2]), len(t1[i][2])))]
    worst = max(abs(a - b) for _, _, a, b in pairs)
    unequal = sum(a != b for _, _, a, b in pairs)
    searches["6b"].update(compared=len(pairs), unequal=unequal, max_abs_diff=worst,
                          atol=SEARCH_NODES_ATOL)
    log(f"[search] 6b against 6a: {len(pairs)} (trial, phase) metrics both trained, "
        f"{unequal} not bit-equal, max |4 nodes - 1 node| {worst:.3e} (limit "
        f"{SEARCH_NODES_ATOL:g}); statuses 4 nodes {[t4[i][1] for i in sorted(t4)]}, "
        f"1 node {[t1[i][1] for i in sorted(t1)]}")
    for i, ph, a, b in pairs:
        assert abs(a - b) <= SEARCH_NODES_ATOL, ("6b", i, ph, a, b)
    phase_done("6b search, 1 node thread, profiled")

    # 6c: card against CPU, one node: the weights of every trial drawn on the
    # CPU from seed 0 and copied to its device
    def devices_search(d):
        zero_counts()
        policy = HyperTrick(lm_space(), SEARCH_DEV_W0, SEARCH_DEV_PHASES, SEARCH_R, seed=0)
        objective = make_lm_objective(YI, steps_per_phase=SEARCH_DEV_STEPS, seed=0, device=d,
                                      init_device="cpu")
        return ThreadCluster(1, objective).run(policy)

    def report_cuts(res):
        """(trial, phase, metric, cut) of each report in order: the sqrt(r)
        quantile of the phase's metrics so far, which HyperTrick held the
        metric to past its collection mode (None within it)."""
        seen, out = {}, []
        for rec in res.records:
            ms = seen.setdefault(rec.phase, [])
            ms.append(rec.metric)
            cut = (None if len(ms) - 1 < dcm_threshold(SEARCH_DEV_W0, SEARCH_R, rec.phase)
                   else float(np.quantile(ms, math.sqrt(SEARCH_R))))
            out.append((rec.trial_id, rec.phase, rec.metric, cut))
        return out

    res_card = devices_search(dev)
    launches, fa_by, gmm_by, rms_by, scan_by = all_counts()
    tc_card = trial_table(res_card)
    dev_steps = SEARCH_DEV_STEPS * sum(len(ms) for _, _, ms in tc_card.values())
    expect = per_forward(trial_cfg)
    for name, n in expect.items():
        assert launches[name] == n * dev_steps, ("6c", name, launches[name], n * dev_steps)
    paths[f"search {YI} card vs CPU"] = (launches, expect, dev_steps, fa_by, gmm_by, rms_by,
                                         scan_by)
    res_cpu = devices_search("cpu")
    tc_cpu = trial_table(res_cpu)
    same = ({i: (hp, st, len(ms)) for i, (hp, st, ms) in tc_card.items()}
            == {i: (hp, st, len(ms)) for i, (hp, st, ms) in tc_cpu.items()})
    if not same:
        for (i, ph, mc, cc), (_, _, mu, cu) in zip(report_cuts(res_card), report_cuts(res_cpu)):
            log(f"[search] 6c trial {i} phase {ph}: card {mc!r} cut {cc!r}, cpu {mu!r} cut "
                f"{cu!r}; distance to the cut card "
                f"{None if cc is None else abs(mc - cc)!r}, cpu "
                f"{None if cu is None else abs(mu - cu)!r}")
    assert same, ("6c: card and CPU decided differently",
                  {i: v[1:] for i, v in tc_card.items()}, {i: v[1:] for i, v in tc_cpu.items()})
    dev_worst = 0.0
    for i in tc_card:
        for ph, (a, b) in enumerate(zip(tc_card[i][2], tc_cpu[i][2])):
            dev_worst = max(dev_worst, abs(a - b))
            assert abs(a - b) - TRAIN_RTOL * abs(b) <= TRAIN_ATOL, ("6c", i, ph, a, b)
    searches["6c"] = {"trials": SEARCH_DEV_W0, "phases": SEARCH_DEV_PHASES,
                      "steps_per_phase": SEARCH_DEV_STEPS, "card_steps": dev_steps,
                      "statuses": {i: v[1] for i, v in tc_card.items()},
                      "card_metrics": {i: v[2] for i, v in tc_card.items()},
                      "cpu_metrics": {i: v[2] for i, v in tc_cpu.items()},
                      "max_abs_diff": dev_worst, "atol": TRAIN_ATOL, "rtol": TRAIN_RTOL,
                      "card_wall_s": res_card.wall_time, "cpu_wall_s": res_cpu.wall_time}
    log(f"[search] 6c card against CPU: same trials, statuses and reports "
        f"{searches['6c']['statuses']}; max |card - cpu| {dev_worst:.3e} (limit "
        f"{TRAIN_ATOL:g} + {TRAIN_RTOL:g} * |cpu|) ok")
    phase_done("6c search, card against CPU")

    # 6d: the scan (jamba) and the grouped matmul (grok-1) under concurrent trials
    for arch, kernel in ((HYBRID, "selective_scan"), (GROK, "gmm")):
        assert per_forward(get_config(arch).reduced())[kernel] > 0, (arch, kernel)
        path, searches[f"6d {arch}"], _ = search(
            f"6d {arch}, 2 nodes", ["--arch", arch, *SEARCH_KERNEL_ARGV], arch, 4, 2, 4)
        paths[f"search {arch} 2 nodes"] = path
    phase_done("6d search, all four kernels")
    log("[search] summary " + json.dumps(searches))


    kernels = []
    for name, src, replaces, main_t, dec_t, more in [
            ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/rmsnorm.py:22", rms_prefill, rms_decode,
             {"jamba": rms_jamba, "grok": rms_grok, "phi3": rms_phi3, "kimi": rms_kimi,
              "search": rms_search}),
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:75", fa_prefill, fa_decode,
             {"jamba": fa_jamba, "zoo": fa_zoo, "search": fa_search}),
            ("gmm", "src/repro_torch/kernels/csrc/gmm_prefill.cu",
             "src/repro/kernels/gmm/gmm.py:28", gmm_prefill, gmm_more["decode"],
             {**{k: v for k, v in gmm_more.items() if k != "decode"}, "grok": gmm_grok,
              "kimi": gmm_kimi}),
            ("selective_scan", "src/repro_torch/kernels/csrc/scan_prefill.cu",
             "src/repro/kernels/selective_scan/selective_scan.py:51", scan_prefill,
             scan_decode, {"edge": scan_edge, "jax_draws": scan_jax_draws})]:
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(p[0][name] for p in paths.values()),
            "launches_by_path": {k: p[0][name] for k, p in paths.items()},
            "launches_per_forward": {k: p[1][name] for k, p in paths.items()},
            "max_abs_err": err[name], **main_t, "kernel_ms": main_t["ms"],
            "decode": dec_t, **more, "device": smi})
        if name == "rmsnorm":
            kernels[-1]["sources"] = ["src/repro_torch/kernels/csrc/rmsnorm.cu"]
            for served in ("warp", "block"):
                kernels[-1][f"launches_{served}"] = sum(p[5][served] for p in paths.values())
                kernels[-1][f"launches_{served}_by_path"] = {k: p[5][served]
                                                             for k, p in paths.items()}
            kernels[-1]["resources"] = rms_res
            kernels[-1]["max_abs_err_by_kernel"] = rms_err_by_kernel
        if name == "selective_scan":
            kernels[-1]["sources"] = ["src/repro_torch/kernels/csrc/scan_prefill.cu",
                                      "src/repro_torch/kernels/csrc/selective_scan.cu"]
            for served in ("prefill", "sequential"):
                kernels[-1][f"launches_{served}"] = sum(p[6][served] for p in paths.values())
                kernels[-1][f"launches_{served}_by_path"] = {k: p[6][served]
                                                             for k, p in paths.items()}
            kernels[-1]["resources"] = scan_res
            kernels[-1]["max_abs_err_by_kernel"] = scan_err_by_kernel
            kernels[-1]["prefill_max_abs_diff_from_f32_plain"] = scan_vs_f32_plain[0]
            kernels[-1]["long_f32_max_abs_err_from_f64"] = scan_long
        if name == "flash_attention":
            kernels[-1]["sources"] = ["src/repro_torch/kernels/csrc/flash_prefill.cu",
                                      "src/repro_torch/kernels/csrc/flash_decode.cu",
                                      "src/repro_torch/kernels/csrc/flash_attention.cu"]
            for served in ("tensor_core", "split_kv", "fma"):
                kernels[-1][f"launches_{served}"] = sum(p[3][served] for p in paths.values())
                kernels[-1][f"launches_{served}_by_path"] = {k: p[3][served]
                                                             for k, p in paths.items()}
            kernels[-1]["resources"] = flash_res
            kernels[-1]["bf16_max_abs_err_by_ref_magnitude"] = flash_bf16_by_mag
            kernels[-1]["bf16_where_ref_reaches_4"] = flash_large_out
        if name == "gmm":
            kernels[-1]["sources"] = ["src/repro_torch/kernels/csrc/gmm_prefill.cu",
                                      "src/repro_torch/kernels/csrc/gmm_decode.cu",
                                      "src/repro_torch/kernels/csrc/gmm.cu"]
            for served in ("tiled", "decode", "small"):
                kernels[-1][f"launches_{served}"] = sum(p[4][served] for p in paths.values())
                kernels[-1][f"launches_{served}_by_path"] = {k: p[4][served]
                                                             for k, p in paths.items()}
            kernels[-1]["resources"] = gmm_res
            kernels[-1]["max_abs_err_by_kernel"] = gmm_err_by_kernel
        assert kernels[-1]["launches"] > 0, f"{name}: no launch on the main paths"
    serves = {k: {**p[7], **probes[k]} for k, p in paths.items() if k in probes}
    log("[serve] summary " + json.dumps(serves))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
