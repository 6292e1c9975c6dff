#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which passes or ends the script with a non-zero exit:
  0. device: a CUDA card must be present; prints its name and power limit,
     its SM count and maximum SM clock (the SFU's rate, for the scan's
     bound);
  1. build: compiles the port's CUDA kernels from the repository's sources;
     prints the registers, local memory (spills) and shared memory of every
     flash-attention kernel (3h prints whisper's hd-64 ones again), of
     the tiled and decode grouped-matmul kernels,
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
     kernel. whisper-large-v3's flash calls (MHA, 20 heads at hd 64), not
     causal: 1500 x 1500, 224 x 1500 and 100 x 1500 on the tensor-core
     kernel (q rows and keys off the 64-row tile), 1 x 1500 with no kv_pos
     on split-KV, and 1500 x 1500 in f32 at the reduced config's heads on
     the FMA kernel; and the decoder's causal ring of 448 slots at a decode
     step on split-KV. Where |out| reaches 4: flash at gemma2's, phi3's
     and kimi's prefill shapes, whisper's prefill of 224 and its cross
     attention onto 1,500 frames at prefill and at a decode step (split-KV;
     q x 30, so one key carries most of each row), with v ~ N(0, 2^2)
     clipped to |v| <= 7.9 (hundreds of outputs in [4, 8), none at 8),
     held to 2e-2 (8e-3 where |ref| < 1)
     against the plain version run on f32 copies of the same bf16 inputs,
     with the count of outputs in [4, 8) and the distance from the bf16 plain
     output printed. The population engine's mamba and MoE buckets: the
     scan's slot case (an A and a D a slot, ``rows_per_a``) at 12 slots x 2
     x T of jamba reduced in f32, T = 16 (the sequential kernel), 32 and 64
     (the prefill kernel), and at 3 slots x 2 in bf16 at d_inner 130 (a
     slot's D rows not 16 bytes apart), each with the other kernel's slot
     case held past the dispatch; the small gmm in f32 over 12 slots x 4
     experts = 48 groups of grok-1 reduced (256 -> 256). Plus a reduced
     gemma2-2b, a reduced hybrid (jamba's
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
  3h. serve whisper-large-v3 whole (32 encoder and 32 decoder layers, 1.601B
     weights, bf16, seed-0 weights): 8 requests in groups of 4, prompts of
     224 tokens, 16 new tokens, a decoder cache of 448 (the v3 card's
     max_target_positions), each group's encoder frames (4, 1500, 1280) bf16
     drawn from seed 0; a prefill step of {"tokens", "enc_embeds"} and 16
     decode steps, greedy. Launches exact: 96 tensor-core flash calls a
     prefill (32 encoder, 32 self, 32 cross, none causal but the self), 64
     split-KV calls a decode step, no RMSNorm (LayerNorm). Prints prefill
     ms with the encoder's share apart, decode ms a step, tokens/s, peak
     GB, the greedy tokens, profiles of a prefill, of the encoder and of a
     decode step, the sync check and the largest |attention output| of
     each kind (encoder, self, cross, as each multiplies its ``wo`` or
     ``c_wo``). Then ``python -m repro_torch.launch.serve --arch
     whisper-large-v3`` at the same shapes in this process, which feeds
     prompts only, as the reference's engine: 64 tensor-core calls a
     prefill, and its tokens equal the steps' run with zero ck / cv; and the
     reduced config at enc_seq 1,500 in f32 on the card against the CPU
     from one CPU draw (the FMA kernel): prefill and 6 decode steps' logits
     within 1e-4, the greedy tokens equal; then the same at every width as
     published (d_model 1280, 20 heads, d_ff 5120, the 51,866-token
     vocabulary, 1,500 frames), the depth cut to 2 encoder and 2 decoder
     layers, batch 1, a prompt of 224 into the cache of 448 and 4 decode
     steps: logits within 1e-4, the greedy tokens equal;
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
     served routing, up and down, prefill and decode; flash at whisper's
     five calls (encoder 1500 x 1500, cross 224 x 1500 and 1 x 1500, all
     three not causal and beside SDPA with is_causal False; the decoder's
     224 x 224 and its ring of 448 at a decode step). The flash bound counts
     an exponential a visible score on the SFU beside the FLOPs;
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
     training forward runs the FMA flash kernel there, and whisper's, whose
     batches carry the pipeline's encoder frames). Then whisper-large-v3
     whole at lr 3e-4, batch 4 x 448 decoder tokens (the v3 card's
     max_target_positions) with the pipeline's (4, 1500, 1280) f32 frames:
     96 tensor-core flash calls a step (32 encoder and 32 cross, not
     causal; 32 self), 0 split-KV, 0 FMA, 0 RMSNorm; its 6 N T bound counts
     the frames for the encoder's weights and the cross k / v. Prints step
     ms (CUDA events, median of steps 3-10), tokens/s (and frames/s), peak
     memory, and a profiled eleventh step split into the four kernels'
     forwards, the plain-recompute backward of each op, cuBLAS and the
     optimizer; the pipeline's draw of a batch on the host clock; for the
     LayerNorm models, their LayerNorms' forward and backward timed apart
     at the step's shapes;
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
     search cut to 1 phase on one node thread inside one CUDA-only profiler
     session (the device's busy share): the same configurations by trial id,
     and every (trial, phase) both runs trained within
     ``SEARCH_NODES_ATOL``. 6c: one
     node, HyperTrick(w0 4, 3 phases, r 0.25, seed 0) at 4 steps a phase on
     the card and on the CPU, every trial's weights drawn on the CPU: the
     same trials, statuses and reports, metrics within TRAIN_ATOL +
     TRAIN_RTOL * |cpu|; a differing decision prints each report's metric
     and cut. 6d: searches of 4 workers on 2 node threads, 2 phases of 4
     steps, at jamba (RMSNorm, flash, the prefill scan), grok-1 (RMSNorm,
     flash, the small gmm) and whisper-large-v3 (3 FMA flash calls a trial
     step: encoder, self and cross; no RMSNorm), their launch counts held
     as in 6a. Phase 2 holds
     the block RMSNorm and the FMA flash kernel at the trial shapes, and
     phase 4 times them there beside ``F.rms_norm`` and SDPA.
     Every search here passes ``--objective lm``. Phase 2 also holds
     RMSNorm's slot case (a scale row a slot, the block kernel) at 12 slots
     of the population engine's rows, (12, 64, 256) and (12, 512, 256) in
     f32 and the latter in bf16, and the FMA flash kernel over 12 slots'
     sequences; phase 4 times the slot case at both shapes beside its
     plain version and the shared-scale block kernel on the same rows (no
     (no single PyTorch call takes a scale a slot). Phase 4 also times the
     scan's slot case at the mamba bucket's call (12 slots x 2 x 32, jamba
     reduced, the sequential kernel beside it) and the small gmm at the MoE
     bucket's (1,536 rows over 48 groups, 256 -> 256 f32), beside their
     plain versions and, for gmm, ``torch._grouped_mm`` where it takes f32;
  7. the GA3C search, the paper's own (``repro_torch.launch.tune
     --objective rl``, the CLI's default). No kernel of the port runs on it:
     every launch counter must read 0 after each part. 7a: the reference's
     default search (GA3C on pong, 16 envs a trial, 12 workers on 4 node
     threads, 5 phases, r 0.25, seed 0) cut to 8 episodes a phase: no trial
     crashed, every trial 1 to 5 reports (5 when it completed), every metric
     finite and in pong's score range [-3, 3], alpha in (0, 1]. Prints wall
     time, trial-phases, updates, env frames/s, updates/s, occupancy, alpha
     beside ``expected_alpha`` and peak memory. 7b: a search of 4 workers
     and 1 phase of 12 episodes on one node thread in one CUDA-only
     profiler session (busy share, kernels an update and an env step) and
     on 4 threads without it: every (trial, phase) both trained within
     ``RL_NODES_ATOL``. 7c: ``GA3CTrainer`` on boxing on the card and on the
     CPU from one CPU draw of the weights and of every rollout draw, 3
     updates: the same actions, rewards and dones, loss and grad norm within
     TRAIN_ATOL + TRAIN_RTOL * |cpu|. 7d: each game one phase of 16 episodes
     with a finite score; boxing at lr 1e-3, gamma 0.9, t_max 8 over 4
     phases of 24 episodes must end above its first phase;
  8. the population engine (``repro_torch.launch.tune --backend
     vectorized``): every live trial trains at once from one host thread,
     the trials that share a t_max in one bucket stepped together. Every
     launch counter must read 0 after each part. 8a: 7a's search on it (12
     trials, 12 distinct t_max: 12 buckets of one slot), held to 7a's
     checks; prints its buckets, wall time, env frames/s, updates/s,
     occupancy, alpha beside ``expected_alpha`` and peak memory beside 7a's.
     8b: every (trial, phase) metric both 8a and 7a trained, by trial id: a
     trial whose t_max no other trial drew (a one-slot bucket throughout,
     the thread trainer's own update) within ``RL_NODES_ATOL``; the others
     counted and printed, not held. 8c: a random search over the learning
     rate at t_max 8, 12 workers in one bucket of 12 slots, 2 phases of 12
     episodes, in one CUDA-only profiler session, and the same search at
     one slot: busy share, kernels a step of the bucket (below
     ``POP_KERNEL_RATIO`` x one slot's), env frames/s, updates/s; then a
     bucket of 4 trials against the same 4 trials trained alone, 3 updates
     on the same draws: the same actions, rewards and dones, weights within
     TRAIN_ATOL + TRAIN_RTOL * |alone|;
  9. LM trials on the population engine and PBT's clone (``tune --backend
     vectorized --objective lm`` / ``--scheduler pbt``). 9a: the CLI's
     defaults (yi-9b reduced, f32, batch 2 x 32, 12 workers in 12 slots, 5
     phases of 25 steps, HyperTrick at r 0.25, seed 0): one bucket, no
     trial crashed, 1 to 5 reports a trial, every metric finite, the best
     above -ln(512), alpha in (0, 1], and the launch counters at the
     bucket's steps x (3 RMSNorm slot calls on the block kernel + 1 FMA
     flash call), no warp RMSNorm, gmm or scan; prints wall time,
     trial-steps/s, tokens/s, occupancy, alpha beside ``expected_alpha`` and
     peak memory. 9b: one bucket of 12 slots at 8 x 64 (the thread
     backend's trial shape), a random search over the learning rate, 2
     phases of 25 steps, in one CUDA-only profiler session, beside the same
     at one slot: busy share, kernels a step of the bucket (below
     ``POP_KERNEL_RATIO`` x one slot's), trial-steps/s, tokens/s. 9c:
     ``repro_torch.launch.population_checks``' 4 trials in one bucket
     against each alone in a bucket of one, 3 updates on the same draws,
     within its limits (``slot_faults``: each slot's summed AdamW second
     moments, its weights outside TRAIN_ATOL + TRAIN_RTOL * |alone|, its
     largest |bucket - alone| over its lr, its summed -loss); then two
     bucket steps on the card against the CPU from one CPU draw of the
     weights and data, each slot's summed loss within TRAIN_ATOL +
     TRAIN_RTOL * |cpu| (the second step's loss is taken after the first
     update, so the backward is held too). 9d: ``--scheduler pbt`` on the engine for GA3C (4 workers, 3
     phases of 2 episodes, 2 envs) and LM (4 workers, 3 phases of 4 steps):
     every trial completed and at least one clone copied on the device (a
     run without one is repeated at the next seed, up to ``PBT_SEEDS``);
     then one clone on the card under ``set_sync_debug_mode("error")``: the
     child's learner bit-equal to the parent's, its carry unchanged. 9e:
     9a's search cut to 3 phases over jamba's reduced config (a mamba
     block: 5 slot RMSNorm,
     1 FMA flash and 1 call of the scan's slot case on the prefill kernel a
     step of the bucket) and grok-1's (a MoE block: 3 slot RMSNorm, 1 FMA
     flash and 3 small gmm over the slots' 48 (slot, expert) groups), each
     held as 9a with those counts exact; two
     bucket steps of each on the card against the CPU within 9c's limits,
     every token routed to the same experts on both in the first; jamba's bucket of 4
     against the same trials alone within 9c's limits
     (``population_checks.slot_rows`` with ``arch``); and jamba's search on
     one population worker of 12 slots (a tune subprocess), equal to 9e's
     trials as 11a is to 9a's;
 10. the control plane (``repro_torch.launch.tune --backend server /
     process``): the CLI as a subprocess, its trials in worker processes
     (``python -m repro_torch.distributed.worker``) against the TCP server
     in the launcher; each run's summary from ``--out``, its trials, the
     workers' phase seconds (``trial.phase`` spans) and its start-up (from
     its spawn to the first acquire and to the first report) from
     ``--journal``, and each worker's launch counters from its closing line. 10a: 6a's search
     on --backend server, 12 workers on 4 worker processes: 6a's checks,
     the same configuration by trial id as 6a, every (trial, phase) both
     trained within ``SEARCH_NODES_ATOL`` (each difference printed), and
     the workers' summed launches at the reported steps x (3 block RMSNorm
     + 1 FMA flash), no warp RMSNorm, gmm or scan; prints wall time,
     occupancy, trial-steps/s, tokens/s and trial-steps a busy second
     beside 6a's. 10b: the same search cut to 3 phases with a fresh
     journal, its process group SIGKILLed once 12 reports are journaled,
     then the same command with --resume: no (trial, phase) journaled
     twice, the budget's 12 configurations completed or killed with 1 to 3
     reports, every metric
     equal to 6a's for the same configuration and phase (the requeued
     ones trained from phase 0 again), the resumed workers' launches held
     as 10a's; prints the time to the kill, the resumed wall time and the
     configurations requeued. 10c: Hyperband on --backend process (4
     phases, eta 2, 10 worker processes, 4 steps a phase): bracket 0's
     cohorts (phase, n, demoted) (0, 4, 2), (1, 2, 1), bracket 1's (1, 3,
     2), 5 killed and 5 completed, launches held as 10a's. 10d: 7a's GA3C
     search on --backend process, 4 worker processes: 7a's checks, every
     worker counter 0; prints wall time, env frames/s, updates/s (the
     workers' trainers' counts) and env frames a busy second beside 7a's
     (4 threads) and 7b's (1 thread). 10e: 6d's whisper-large-v3 search on
     --backend process, 2 worker processes: 6d's checks, the same
     configuration by trial id as 6d's, every (trial, phase) both trained
     within ``SEARCH_NODES_ATOL``, the workers' launches at the reported
     steps x 3 FMA flash calls.
 11. the population worker (``tune --backend process / server --slots N``:
     each worker process is ``python -m repro_torch.population.worker``,
     one population engine leasing a batch of trials), each run the CLI as
     a subprocess as in phase 10. 11a: 9a's LM search on --backend server,
     one worker of 12 slots, against 9a's trials (the same command on
     --backend vectorized): the same configuration by trial id, the same
     ``by_status``, every (trial, phase) metric both trained equal
     (each difference printed), and each worker's launches at its steps of
     the bucket x (3 slot-case RMSNorm + 1 FMA flash), no warp RMSNorm, gmm
     or scan. 11b: the same search on two workers of 6 slots: the same
     configurations, every (trial, phase) metric both trained within 9c's
     limit on a slot's summed -loss (``population_checks.slot_faults``:
     RTOL |summed -loss| + ATOL a step), launches as 11a's. 11c: 7a's GA3C
     search on --backend process, two workers of 6 slots (12 distinct
     t_max: one-slot buckets, the trainer's own update) against 8a's
     trials: every (trial, phase) both trained equal, every worker counter
     0. 11d: the pooled bracket of tests/test_bracket_barrier.py:362, two
     population workers of 2 slots, eta 3, 64 updates a phase: one rung of
     n 4 at phase 0, more than one distinct phase-0 metric, its one demoted
     trial the pooled bottom metric and every trial at the top metric
     promoted, both nodes reporting, 1 killed and 3 completed. Each run
     prints wall time, occupancy, alpha, trial-steps/s
     and tokens/s or env frames/s and updates/s, and its start-up, beside
     9a's, 8a's and 10a's.
 12. the paper's baselines, in this process through the port's Python API
     (the tune CLI reaches neither): ``SyncCluster.run_sh``, synchronous
     Successive Halving with a barrier at each phase and the bottom quarter
     killed at each, and ``EvolutionaryHyperTrick``, whose freed nodes
     restart from a mutated top-quartile configuration after a warmup of
     fresh draws. 12a: ``run_sh`` of 6a's 12 configurations (by trial id)
     over 6a's LM objective on 4 node threads, cut to 2 phases, evict 0.25:
     12 and 9 trials a phase, 5 killed and 7 completed, each record's
     node its index among the phase's survivors mod 4, every
     (configuration, phase) both trained equal to 6a's, and the launches at
     the trial steps x (3 block RMSNorm + 1 FMA flash), no other kernel.
     12b: ``run_sh`` of 7a's 12 configurations over 7a's GA3C objective, 4
     node threads, 2 phases, evict 0.25: 12 and 9 trials, 5 killed and 7
     completed, equal to 7a's, every counter 0. 12c:
     ``EvolutionaryHyperTrick(lm_space, w0 12, 2 phases, r 0.25, seed 0)``
     on ``ThreadCluster`` over 12a's objective: trials 0-5 carry 6a's
     configurations and metrics, at least one mutated child trained, each
     child's parent reported before it and each child's learning rate its
     parent's x 0.5, 0.8, 1.25 or 2 within the space's bounds; launches as
     12a's. Each run prints wall time, trial-steps/s and tokens/s or env
     frames/s and updates/s, occupancy, alpha beside ``expected_alpha``
     (HyperTrick's at r 0.25) and peak memory, beside 6a's or 7a's.
 13. the paper's simulator, the trace and the load generator: host code of
     the search (numpy and sockets), in this process; every launch counter
     must read 0 after each part. 13a: the paper's figures on
     ``core/simulator.py`` at the JAX package's benchmark arguments
     (``SIM_TOY``, ``SIM_TABLE3``, ``SIM_GAMES``): the toy problem (16
     configurations, 6 nodes, Np 4, r 0.25, seeds 0-29) under HyperTrick,
     dynamic and static Successive Halving and grid search, with grid's alpha
     1.0, every occupancy at most 1, static SH's mean makespan not below
     dynamic's and grid's above HyperTrick's; Table 3 (``paper_brackets``,
     46 ``paper_rl_space`` configurations on 46 nodes, 27 phases, seeds 0-9,
     pong and boxing), HyperTrick's mean makespan below Hyperband's and its
     occupancy above. Prints each policy's means and grid / HyperTrick. 13b:
     ``replay_trace`` of 1000 synthetic hosts (2 % failing) through the real
     service and rung barrier (``TRACE_1000``), journaled to a file: the
     first rung pooled 990 or more, demotions, requeues equal to lease reaps
     and above 0, park, demote and stop verdicts, no trial left running,
     completed and crashed trials; the journal replayed into a fresh service
     gives every trial's status, reports and best metric. Prints the summary
     and the host seconds of the trace and of the replay. 13c: ``run_load``
     against ``MetaoptServer`` at 200 hosts x 1 slot x 2 phases (batched) and
     2 x 64 x 3 (batched and per trial), each with no error, the exact report
     and acquire counts and every trial completed with the load's metrics;
     then ``run_sim_load(1000, 2000, 4)``: 8,000 reports, 2,000 trials.
     Prints each row's reports/s, p50 and p99, and the batched / per-trial
     ratio (not held: a wall-clock ratio).
 14. the journal's readers (``repro_torch.telemetry``: ``export``,
     ``critical_path``, ``tailer``, ``dashboard``) over the journals this
     run's searches wrote, in this process; host code, every launch counter
     must read 0 after it. 14a: the journals of 10a, 10c, 11a and 13b, each
     exported as a Chrome trace that validates, with one trial track a
     trial and ``export.main --require-trials N`` at 0 for its N trials and
     1 for N + 1; every trial's compile, step, rpc, park-wait and idle
     within 1 % of its wall (``critical_path.attribute``); ``dashboard
     --once`` showing the phase's trial count and best score and the
     per-bracket table; in 10c and 13b, whose rungs park trials, a trial
     with park-wait above 0. Prints each journal's per-bracket table and
     its shares of the summed trial wall. 14b: 10a's journal, tailed by a
     thread of this process (``JournalTailer``, 4096 bytes a poll, every 50
     ms) while its search ran: the tailed events equal the finished
     journal's, none skipped, and a ``SearchView`` fed live holds the same
     trials, best score, reaps and cohort waits as one built from the
     finished journal. Prints the polls and how many found a torn line.
Seconds per phase are printed as each ends. The last two lines are the
kernels' JSON line and the result line.

``trial_seed`` (``repro_torch.rl.ga3c``) seeds each trial on the population
engine with Python's salted ``hash`` of its hyperparameters, so the script
re-executes itself once under ``PYTHONHASHSEED=0`` (``SMOKE_HASH_SEED``):
phase 11's worker processes inherit the pin, and the same trial draws the
same weights and data there as in 8a and 9a.
"""
from __future__ import annotations

import atexit
import ctypes
import dataclasses
import gc
import collections
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
# the hash seed the script runs under (see the end of the docstring)
SMOKE_HASH_SEED = "0"

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FLUSH_BYTES = 256 << 20     # scratch read between timed calls: over 2 x the 50 MB L2

ARCH, N_REQ, BATCH, PROMPT, NEW, MAX_SEQ = "gemma2-2b", 8, 4, 512, 16, 1024
# whisper-large-v3 (1.601B parameters, 3.2 GB in bf16) is served whole with
# the same requests at the v3 card's limits: prompts of 224 tokens into a
# decoder cache of max_target_positions 448, the encoder over
# max_source_positions 1,500 frames
WHISPER, WHISPER_PROMPT, WHISPER_MAX_SEQ = "whisper-large-v3", 224, 448
# 3h's full-width logits, card against CPU in f32: every width as published,
# the depth cut to 2 encoder and 2 decoder layers, batch 1, 4 decode steps
WHISPER_FULL_LAYERS, WHISPER_FULL_DECODE = 2, 4
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
# 6b's search is cut to 1 of 6a's 5 phases (3 before whisper's phase 3h, 2
# before whisper's training): every trial's phase-0 metric is held as
# before, and its profiler session holds fewer events
SEARCH_PROFILED_PHASES = 1
# 6c: one node, HyperTrick(lm_space, w0 4, 3 phases, r 0.25, seed 0), 4 steps
# a phase, on the card and on the CPU from one CPU draw of the weights; each
# phase's metric within TRAIN_ATOL + TRAIN_RTOL * |cpu|
SEARCH_DEV_W0, SEARCH_DEV_PHASES, SEARCH_DEV_STEPS = 4, 3, 4
# 6d: small searches of the archs whose reduced configs run the scan (jamba)
# and the grouped matmul (grok-1), 4 workers on 2 node threads
SEARCH_KERNEL_ARGV = ["--objective", "lm", "--workers", "4", "--nodes", "2", "--phases", "2",
                      "--steps-per-phase", "4"]
# phase 7: the reference's default search (``repro_torch.launch.tune`` with
# no argument but ``--objective rl``): GA3C on pong, 16 envs a trial, 12
# workers on 4 node threads, 5 phases, HyperTrick at r 0.25, seed 0; pong's
# episode score lies in [-3, 3]. Cut: 8 episodes a phase, not 60. Uncut, the
# search alone took 350 s on an H100 (PERF.md §4), which would take the
# smoke past 700 s; the net, the envs and the game are not cut
RL_GAME, RL_W0, RL_NODES, RL_PHASES, RL_EPISODES, RL_ENVS, RL_R = "pong", 12, 4, 5, 8, 16, 0.25
RL_ARGV = ["--objective", "rl", "--episodes-per-phase", str(RL_EPISODES)]
RL_SCORE = 3.0
# 7b: a smaller search, 4 workers over 1 phase of 12 episodes, on one node
# thread in one profiler session and on 4 without it: each (trial, phase)
# metric both trained within RL_NODES_ATOL (no sum on the GA3C path depends
# on the order of its threads: rl/network.py)
RL_SMALL_ARGV = ["--objective", "rl", "--workers", "4", "--phases", "1",
                 "--episodes-per-phase", "12"]
RL_NODES_ATOL = 0.0
# 7c: GA3CTrainer on boxing on the card and on the CPU, one CPU draw of the
# weights and of every rollout draw, RL_DEV_UPDATES updates: the same actions,
# rewards and dones; loss and grad norm within TRAIN_ATOL + TRAIN_RTOL * |cpu|
RL_DEV_GAME, RL_DEV_UPDATES = "boxing", 3
# 7d: each game one phase of RL_SHORT_EPISODES episodes; then the port of
# tests/test_envs_rl.py::test_ga3c_trainer_boxing_learns on the card
RL_SHORT_EPISODES = 16
RL_LEARN_HP = dict(learning_rate=1e-3, gamma=0.9, t_max=8)
RL_LEARN_PHASES, RL_LEARN_EPISODES, RL_LEARN_MAX_UPDATES = 4, 24, 400
# phase 8: the population engine (``--backend vectorized``). 8a: 7a's search
# (the reference's default, cut to RL_EPISODES a phase) with every trial on
# the engine, from one host thread; its trials draw 12 distinct t_max, so
# 12 buckets of one slot. 8c: one bucket of POP_SLOTS slots, a random search
# over lr ~ LogUniform(1e-4, 1e-3) at gamma 0.99 and t_max POP_T_MAX, 2
# phases of 12 episodes, profiled, beside the same search at one slot; at
# POP_SLOTS slots its kernels a step of the bucket must stay below
# POP_KERNEL_RATIO x one slot's (a loop over slots would give about 12 x).
# Then POP_PARITY_SLOTS trials in one bucket against the same trials trained
# alone, POP_PARITY_UPDATES updates: the same actions, rewards and dones;
# weights within TRAIN_ATOL + TRAIN_RTOL * |alone|
POP_ARGV = ["--backend", "vectorized", *RL_ARGV]
POP_SLOTS, POP_PHASES, POP_EPISODES, POP_T_MAX = 12, 2, 12, 8
POP_KERNEL_RATIO = 3.0
POP_PARITY_SLOTS, POP_PARITY_UPDATES = 4, 3
# phase 9: LM trials on the population engine. 9a: the CLI's defaults
# (``tune --backend vectorized --objective lm``: yi-9b reduced in f32, the
# reference's trial batch 2 x 32, 12 workers in 12 slots, 5 phases of 25
# steps, HyperTrick at r 0.25, seed 0): every trial draws a loss_chunk of
# 256 or more, so one bucket (key min(loss_chunk, 32)); each step of the
# bucket launches 3 RMSNorm slot calls and 1 FMA flash call
POP_LM_ARGV = ["--backend", "vectorized", "--objective", "lm"]
POP_LM_BATCH, POP_LM_SEQ = 2, 32
# 9b: one bucket of POP_SLOTS slots at the thread backend's trial shape
# (SEARCH_BATCH x SEARCH_SEQ), a random search over the learning rate, 2
# phases of 25 steps, profiled, beside the same search at one slot
POP_LM_PHASES, POP_LM_STEPS = 2, 25
# 9e: 9a's search over the reduced configs whose blocks run the scan's slot
# case (jamba: a mamba block) and gmm over the slots' (slot, expert) groups
# (grok-1: a MoE block of 4 experts, top-2); kimi-k2's reduced MoE block is
# grok-1's in shape and is held on the CPU only
BLOCK_ARCHS = (HYBRID, GROK)
# 9e's searches and its population worker's are cut to 3 of 9a's 5 phases
# (5 before whisper's training); each is held as before
BLOCK_PHASES = 3
BLOCK_ARGV = [*POP_LM_ARGV, "--phases", str(BLOCK_PHASES)]
# 9c: ``repro_torch.launch.population_checks``' comparison at engine seed
# 0: its trials in one bucket against each alone, its limits
# (``slot_faults``). Twenty seeds of it on an H100 and its coupled controls
# are in PERF.md
# 9d: PBT through the CLI on the engine, the reference's recipe for rl and a
# short LM run. A run may execute no clone on the device and be right: a
# population of 4 whose reports come in rising order gets no CLONE verdict,
# and a GA3C parent of another t_max may have finished and left its slot
# before its child reports (``python -m repro_torch.launch.population_checks
# pbt --objective rl --seeds 24 --device cpu``: 4 and 6 of 24 runs copied
# no slot; lm 2 of 12 and 3 of 24). So a run without a clone on the device
# is repeated at the next seed, up to PBT_SEEDS runs
PBT_RL_ARGV = ["--backend", "vectorized", "--scheduler", "pbt", "--workers", "4", "--phases",
               "3", "--episodes-per-phase", "2", "--n-envs", "2"]
PBT_LM_ARGV = ["--backend", "vectorized", "--objective", "lm", "--scheduler", "pbt",
               "--workers", "4", "--phases", "3", "--steps-per-phase", "4"]
PBT_SEEDS = 10


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
    shares them, a count over ``iters``, and then may fall up to LEAD_IN
    short of a multiple of ``iters``: an H100 dropped the session's first
    flush memset in 4 of 5 sessions of the plain gmm, whose own memsets
    share the key (139 of 7 x 20)."""
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
                   and not (a.key in ignore and (a.count < iters
                                                 or a.count % iters >= iters - LEAD_IN))}
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


def matmul_bound_ms(cfg, tokens, frames=0):
    """A training step's floor: 6 N T FLOPs over the bf16 peak, with N the
    weights a token meets (every weight but the embedding table; the
    experts' at top_k of n_experts) and T ``tokens``. An encoder-decoder's
    encoder weights and its cross attention's k / v projections meet the
    encoder's ``frames`` instead (the attention products are not counted).
    Returns (ms, N, the FLOPs)."""
    from repro_torch.models.schema import _leaves, model_schema
    n, flops = 0.0, 0.0
    for name, d in _leaves(model_schema(cfg)):
        leaf = name.split("/")[-1]
        if leaf == "embed":
            continue
        share = cfg.top_k / cfg.n_experts if leaf in ("we_up", "we_gate", "we_down") else 1.0
        n += math.prod(d.shape) * share
        on_frames = name.startswith("enc") or leaf in ("c_wk", "c_wv")
        flops += 6 * math.prod(d.shape) * share * (frames if on_frames else tokens)
    return flops / PEAK_FLOPS["bfloat16"] * 1e3, n, flops


def per_forward(cfg, encoder=False):
    """Kernel launches in one forward, from the config's block pattern and
    norm: a norm per mixer and per FFN plus the final norm (RMSNorm's kernel;
    LayerNorm is plain PyTorch), a flash call per attention layer, a scan per
    mamba layer, three grouped matmuls per MoE. An encoder-decoder's
    attention layer adds its cross attention's flash call, and with
    ``encoder`` (a forward given the encoder's input) each encoder layer
    one more; its norms, LayerNorms, are not counted."""
    R, pat = cfg.n_repeat, cfg.pattern
    attn = R * sum(m.startswith("attn") for m, _ in pat)
    if cfg.is_encdec:
        assert cfg.norm != "rmsnorm", ("an encoder-decoder's RMSNorms are not counted", cfg.name)
        attn = 2 * attn + (cfg.n_enc_layers if encoder else 0)
    norms = R * sum(1 + bool(ffn) for _, ffn in pat) + 1
    return {"rmsnorm": norms if cfg.norm == "rmsnorm" else 0,
            "flash_attention": attn,
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


def slot_routed_sizes(slots, tokens, E, k, seed):
    """A MoE bucket's group sizes over its (slot, expert) groups, slot-major:
    each slot's ``routed_sizes`` of ``tokens`` tokens, drawn in turn."""
    return [g for s in range(slots) for g in routed_sizes(tokens, E, k, seed + s)]


def trial_table(res):
    """{trial id: (hparams, status, [metric a phase])} of a search."""
    return {tr.trial_id: (tr.hparams, tr.status.value, [m for m, _ in tr.reports])
            for tr in res.service.db.trials.values()}


def no_launches(label, all_counts):
    """The launch counters, each of which must read 0: nothing on the GA3C
    path, nor in phase 13's host code, goes through the port's four
    kernels."""
    counts = all_counts()
    for c in counts:
        assert not any(c.values()), (label, "a kernel launched on a path that runs none",
                                     counts)
    return counts


def rl_search(label, argv, run, w0, phases, episodes, smi, zero_counts, all_counts,
              profiled=False):
    """``run()``, a GA3C search on the card (``argv`` names it): no trial
    crashed, each trial reported 1 to ``phases`` times (all of them when it
    completed), every metric finite and a score of pong, alpha in (0, 1],
    no kernel of the port launched. With ``profiled`` it runs in one
    CUDA-only profiler session: the device's busy share, and the kernels a
    search step (``engine.step_s``'s count of the population engine's loop,
    each a step of every bucket; on the thread backend no such count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.completion import expected_alpha

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profiled:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in()
            res = run()
            torch.cuda.synchronize()
    else:
        res = run()
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = no_launches(label, all_counts)
    summary, tab = res.summary(), trial_table(res)
    assert summary["n_trials"] == w0, (label, summary)
    assert "crashed" not in summary["by_status"], (label, summary["by_status"])
    hold_trials(label, tab, phases, w0, score=RL_SCORE)
    alpha = res.service.db.completion_rate(phases)
    assert 0 < alpha <= 1, (label, alpha)
    wall = res.wall_time
    iterations = res.service.metrics.histogram("engine.step_s").count
    out = {"search": label, "argv": argv, "game": RL_GAME, "trials": w0,
           "nodes": res.n_nodes, "phases": phases, "episodes_per_phase": episodes,
           "n_envs": RL_ENVS, "wall_s": wall,
           "run_s": run_s, "trial_phases": len(res.records), "updates": res.updates,
           "env_frames": res.env_steps, "env_frames_per_s": res.env_steps / wall,
           "updates_per_s": res.updates / wall, "occupancy": res.occupancy,
           "alpha": alpha, "expected_alpha": expected_alpha(RL_R, phases),
           "by_status": summary["by_status"], "best_metric": summary["best_metric"],
           "best_hparams": summary["best_hparams"],
           "buckets": len({hp.get("t_max") for hp, _, _ in tab.values()}),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if iterations:
        out["engine_iterations"] = iterations
    if profiled:
        t0 = time.perf_counter()
        kern = device_kernels(prof, skip_lead_in=True)
        busy_ms = sum(a.self_device_time_total for a in kern) / 1e3
        n_kern = sum(a.count for a in kern)
        out.update(device_busy_ms=busy_ms, device_busy_share=busy_ms / 1e3 / wall,
                   device_kernels=n_kern, kernels_per_update=n_kern / res.updates,
                   kernels_per_env_step=n_kern / (res.env_steps / RL_ENVS),
                   profiler_read_s=time.perf_counter() - t0)
        if iterations:
            t_maxes = {hp["t_max"] for hp, _, _ in tab.values()}
            assert len(t_maxes) == 1, (label, "one bucket's steps to count", t_maxes)
            out["kernels_per_bucket_env_step"] = n_kern / (iterations * t_maxes.pop())
        for a in sorted(kern, key=lambda a: -a.self_device_time_total)[:8]:
            log(f"[profile]   {a.self_device_time_total / 1e3:9.3f} ms {a.count:7d}x "
                f"{a.key[:90]}")
    log(f"[rl] {smi}: " + json.dumps(out))
    return counts, out, res


def rl_phase(dev, smi, zero_counts, all_counts, phase_done):
    """Phase 7: HyperTrick's search over GA3C, the reference's default,
    through ``repro_torch.launch.tune.main`` on the card (7a, 7b), GA3C card
    against CPU (7c), every game and a learning curve on the card (7d).
    Nothing on the GA3C path goes through the port's four kernels: every
    counter must read 0 after each part. Returns the launch records of the
    two searches (for the kernels' line), the phase's numbers and 7a's
    result."""
    import torch
    from repro_torch.launch import tune
    from repro_torch.rl.ga3c import GA3CHyperParams, GA3CTrainer

    def search(label, argv, w0, phases, episodes, profiled=False):
        return rl_search(label, argv, lambda: tune.main(argv), w0, phases, episodes, smi,
                         zero_counts, all_counts, profiled)

    paths, rl = {}, {}
    # 7a: the reference's default search
    counts, rl["7a"], res_7a = search(f"7a {RL_GAME}, {RL_NODES} nodes", RL_ARGV, RL_W0,
                                      RL_PHASES, RL_EPISODES)
    paths[f"search rl {RL_GAME} {RL_NODES} nodes"] = counts
    phase_done("7a GA3C search, 4 node threads")

    # 7b: a smaller search on one node thread in one profiler session, and
    # on 4 without it: the same configurations by trial id, and every (trial,
    # phase) both trained within RL_NODES_ATOL
    counts, rl["7b"], res_1 = search(f"7b {RL_GAME}, 1 node", [*RL_SMALL_ARGV, "--nodes", "1"],
                                     4, 1, 12, profiled=True)
    paths[f"search rl {RL_GAME} 1 node"] = counts
    _, rl["7b 4 nodes"], res_4 = search(f"7b {RL_GAME}, 4 nodes",
                                        [*RL_SMALL_ARGV, "--nodes", "4"], 4, 1, 12)
    t1, t4 = trial_table(res_1), trial_table(res_4)
    assert [t1[i][0] for i in sorted(t1)] == [t4[i][0] for i in sorted(t4)], "configs differ"
    pairs = [(i, ph, t4[i][2][ph], t1[i][2][ph]) for i in sorted(t4)
             for ph in range(min(len(t4[i][2]), len(t1[i][2])))]
    worst = max(abs(a - b) for _, _, a, b in pairs)
    unequal = sum(a != b for _, _, a, b in pairs)
    rl["7b"].update(compared=len(pairs), unequal=unequal, max_abs_diff=worst,
                    atol=RL_NODES_ATOL)
    log(f"[rl] 7b 1 node against 4: {len(pairs)} (trial, phase) metrics both trained, "
        f"{unequal} not bit-equal, max |4 nodes - 1 node| {worst:.3e} (limit "
        f"{RL_NODES_ATOL:g})")
    for i, ph, a, b in pairs:
        assert abs(a - b) <= RL_NODES_ATOL, ("7b", i, ph, a, b)
    phase_done("7b GA3C search, 1 node thread profiled, and 4")

    # 7c: card against CPU, one CPU draw of the weights and of every draw
    zero_counts()
    hp = GA3CHyperParams(**RL_LEARN_HP)
    card = GA3CTrainer(RL_DEV_GAME, hp, n_envs=RL_ENVS, seed=0, device=dev, init_device="cpu")
    cpu = GA3CTrainer(RL_DEV_GAME, hp, n_envs=RL_ENVS, seed=0, device="cpu", init_device="cpu")
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for u in range(RL_DEV_UPDATES):
        (tc, mc), (tu, mu) = card.step(), cpu.step()
        for f in ("actions", "rewards", "dones"):
            assert torch.equal(getattr(tc, f).cpu(), getattr(tu, f)), ("7c", u, f)
        for k in worst:
            a, b = float(mc[k]), float(mu[k])
            worst[k] = max(worst[k], abs(a - b))
            assert abs(a - b) - TRAIN_RTOL * abs(b) <= TRAIN_ATOL, ("7c", u, k, a, b)
    w_diff = max(float((p.detach().cpu() - q.detach()).abs().max())
                 for p, q in zip(card.net.parameters(), cpu.net.parameters()))
    no_launches("7c", all_counts)
    rl["7c"] = {"game": RL_DEV_GAME, "updates": RL_DEV_UPDATES, "n_envs": RL_ENVS,
                "max_abs_diff": worst, "weights_max_abs_diff": w_diff,
                "atol": TRAIN_ATOL, "rtol": TRAIN_RTOL}
    log(f"[rl] 7c card against CPU, {RL_DEV_GAME}, {RL_DEV_UPDATES} updates of "
        f"{hp.t_max} x {RL_ENVS}: the same actions, rewards and dones; max |card - cpu| loss "
        f"{worst['loss']:.3e}, grad norm {worst['grad_norm']:.3e} (limit {TRAIN_ATOL:g} + "
        f"{TRAIN_RTOL:g} * |cpu|); weights after {w_diff:.3e}")
    phase_done("7c GA3C card against CPU")

    # 7d: every game, one short phase; then boxing learns
    zero_counts()
    rl["7d"] = {}
    for game in ("pong", "boxing", "centipede", "pacman"):
        t0 = time.perf_counter()
        tr = GA3CTrainer(game, GA3CHyperParams(), n_envs=RL_ENVS, seed=0, device=dev)
        score = tr.run_episodes(RL_SHORT_EPISODES, max_updates=400)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert math.isfinite(score) and tr.episodes >= RL_SHORT_EPISODES, (game, score, tr.episodes)
        rl["7d"][game] = {"score": score, "episodes": tr.episodes, "updates": tr.updates,
                          "env_frames": tr.env_steps, "wall_s": wall,
                          "env_frames_per_s": tr.env_steps / wall}
        log(f"[rl] 7d {game}: {json.dumps(rl['7d'][game])}")
    t0 = time.perf_counter()
    tr = GA3CTrainer("boxing", GA3CHyperParams(**RL_LEARN_HP), n_envs=RL_ENVS, seed=0, device=dev)
    scores = [tr.run_episodes(RL_LEARN_EPISODES, max_updates=RL_LEARN_MAX_UPDATES)
              for _ in range(RL_LEARN_PHASES)]
    torch.cuda.synchronize()
    rl["7d"]["boxing learns"] = {"scores": scores, "updates": tr.updates,
                                 "wall_s": time.perf_counter() - t0}
    log(f"[rl] 7d boxing learns: {RL_LEARN_PHASES} phases of {RL_LEARN_EPISODES} episodes, "
        f"scores {scores}")
    assert scores[-1] > scores[0], ("7d: boxing did not learn", scores)
    no_launches("7d", all_counts)
    phase_done("7d GA3C, every game and a learning curve")
    log("[rl] summary " + json.dumps(rl))
    return paths, rl, res_7a


def population_phase(dev, smi, zero_counts, all_counts, phase_done, rl, res_7a):
    """Phase 8: the population engine on the card. 8a: 7a's search on the
    vectorized backend; 8b: its (trial, phase) metrics against 7a's; 8c: a
    batched bucket profiled against one slot, and a bucket against the same
    trials trained alone. Every launch counter reads 0 after each part.
    Returns the launch records of the searches and the phase's numbers."""
    from unittest import mock

    import torch
    from repro_torch.core.executor import PopulationCluster
    from repro_torch.core.hypertrick import RandomSearchPolicy
    from repro_torch.core.search_space import Categorical, LogUniform, SearchSpace
    from repro_torch.launch import tune
    from repro_torch.population.engine import PopulationEngine, TrialLease
    from repro_torch.population.objectives import ga3c as ga3c_objective
    from repro_torch.rl.ga3c import GA3CHyperParams, GA3CTrainer, trial_seed

    paths, pop = {}, {}
    # 8a: the reference's default search on the population engine
    counts, pop["8a"], res_8a = rl_search(
        f"8a {RL_GAME}, vectorized", POP_ARGV, lambda: tune.main(POP_ARGV), RL_W0, RL_PHASES,
        RL_EPISODES, smi, zero_counts, all_counts)
    paths[f"search rl {RL_GAME} vectorized"] = counts
    a, b = pop["8a"], rl["7a"]
    log(f"[population] 8a against 7a ({RL_W0} trials, {RL_PHASES} phases of {RL_EPISODES} "
        f"episodes): {a['buckets']} buckets on 1 host thread against {RL_NODES} node threads; "
        f"wall {a['wall_s']:.2f} s ({b['wall_s']:.2f}), env frames/s "
        f"{a['env_frames_per_s']:.0f} ({b['env_frames_per_s']:.0f}), updates/s "
        f"{a['updates_per_s']:.2f} ({b['updates_per_s']:.2f}), occupancy {a['occupancy']:.3f} "
        f"({b['occupancy']:.3f}), alpha {a['alpha']:.3f} ({b['alpha']:.3f}; expected "
        f"{a['expected_alpha']:.3f}), peak GB {a['peak_mem_gb']:.3f} ({b['peak_mem_gb']:.3f})")
    phase_done("8a population search, the reference's default")

    # 8b: by trial id against 7a. A trial whose t_max no other trial drew had
    # a bucket of one slot throughout (a bucket never shrinks): the thread
    # trainer's own update, so bit-equal; the others ran batched
    t7, t8 = trial_table(res_7a), trial_table(res_8a)
    assert [t7[i][0] for i in sorted(t7)] == [t8[i][0] for i in sorted(t8)], "configs differ"
    shared = collections.Counter(hp["t_max"] for hp, _, _ in t8.values())
    held, other = [], []
    for i in sorted(t8):
        alone = shared[t8[i][0]["t_max"]] == 1
        for ph in range(min(len(t7[i][2]), len(t8[i][2]))):
            (held if alone else other).append((i, ph, t8[i][2][ph], t7[i][2][ph]))
    worst = max((abs(x - y) for _, _, x, y in held), default=0.0)
    pop["8b"] = {"compared": len(held), "unequal": sum(x != y for _, _, x, y in held),
                 "max_abs_diff": worst, "atol": RL_NODES_ATOL,
                 "batched_trials": sum(1 for _, (hp, _, _) in t8.items()
                                       if shared[hp["t_max"]] > 1),
                 "batched_compared": len(other),
                 "batched_unequal": sum(x != y for _, _, x, y in other),
                 "batched_max_abs_diff": max((abs(x - y) for _, _, x, y in other),
                                             default=0.0)}
    log(f"[population] 8b against 7a: {len(held)} (trial, phase) metrics of one-slot buckets "
        f"both trained, {pop['8b']['unequal']} not bit-equal, max |8a - 7a| {worst:.3e} "
        f"(limit {RL_NODES_ATOL:g}); trials in batched buckets {pop['8b']['batched_trials']}: "
        f"{len(other)} compared, {pop['8b']['batched_unequal']} unequal, max "
        f"{pop['8b']['batched_max_abs_diff']:.3e} (not held)")
    for i, ph, x, y in held:
        assert abs(x - y) <= RL_NODES_ATOL, ("8b", i, ph, x, y)
    phase_done("8b population against the thread backend")

    # 8c: one batched bucket, profiled, beside the same search at one slot
    space = SearchSpace({"learning_rate": LogUniform(1e-4, 1e-3),
                         "gamma": Categorical((0.99,)), "t_max": Categorical((POP_T_MAX,))})

    def bucket_search(slots):
        label = f"8c {slots} slot{'s' if slots > 1 else ''}, one bucket"
        argv = [f"RandomSearchPolicy over lr, t_max {POP_T_MAX}", f"{slots} workers",
                f"{POP_PHASES} phases of {POP_EPISODES} episodes"]
        return rl_search(label, argv, lambda: PopulationCluster(
            slots, game=RL_GAME, episodes_per_phase=POP_EPISODES, n_envs=RL_ENVS, seed=0,
            device=dev).run(RandomSearchPolicy(space, slots, POP_PHASES, seed=0)),
            slots, POP_PHASES, POP_EPISODES, smi, zero_counts, all_counts, profiled=True)

    counts, pop["8c"], _ = bucket_search(POP_SLOTS)
    paths[f"search rl {RL_GAME} one bucket of {POP_SLOTS}"] = counts
    _, pop["8c one slot"], _ = bucket_search(1)
    k12 = pop["8c"]["kernels_per_bucket_env_step"]
    k1 = pop["8c one slot"]["kernels_per_bucket_env_step"]
    pop["8c"]["kernel_ratio_to_one_slot"] = k12 / k1
    log(f"[population] 8c: kernels a step of the bucket {k12:.1f} at {POP_SLOTS} slots, "
        f"{k1:.1f} at one ({k12 / k1:.2f} x, limit {POP_KERNEL_RATIO:g} x); busy share "
        f"{pop['8c']['device_busy_share']:.4f} ({pop['8c one slot']['device_busy_share']:.4f});"
        f" env frames/s {pop['8c']['env_frames_per_s']:.0f} "
        f"({pop['8c one slot']['env_frames_per_s']:.0f}); updates/s "
        f"{pop['8c']['updates_per_s']:.2f} ({pop['8c one slot']['updates_per_s']:.2f})")
    assert k12 < POP_KERNEL_RATIO * k1, ("8c: launches grow with the slots", k12, k1)

    # a bucket of POP_PARITY_SLOTS against the same trials trained alone
    zero_counts()
    hps = [dict(learning_rate=lr, gamma=g, t_max=POP_T_MAX, beta=be) for lr, g, be in
           ((1e-3, 0.99, 0.01), (3e-4, 0.95, 0.02), (2e-3, 0.9, 0.0), (5e-4, 0.99, 0.05))]
    assert len(hps) == POP_PARITY_SLOTS
    engine = PopulationEngine(RL_GAME, max_slots=POP_PARITY_SLOTS, n_envs=RL_ENVS,
                              episodes_per_phase=10 ** 9, max_updates=10 ** 9, seed=0,
                              device=dev)
    engine._admit_grouped([TrialLease(i, hp) for i, hp in enumerate(hps)], now=0.0)
    bucket = engine.buckets[POP_T_MAX]
    assert bucket.capacity == POP_PARITY_SLOTS, bucket.capacity
    alone = [GA3CTrainer(RL_GAME, GA3CHyperParams(**hp), n_envs=RL_ENVS,
                         seed=trial_seed(0, hp), device=dev) for hp in hps]
    trajs, batched_update = [], ga3c_objective.ga3c_update_slots

    def recorded(*args, **kw):
        out = batched_update(*args, **kw)
        trajs.append(out[0])
        return out

    with mock.patch.object(ga3c_objective, "ga3c_update_slots", recorded):
        for u in range(POP_PARITY_UPDATES):
            bucket.step()
            for i, tr in enumerate(alone):
                t_alone, _ = tr.step()
                for f in ("actions", "rewards", "dones"):
                    assert torch.equal(getattr(trajs[-1], f)[i], getattr(t_alone, f)), (
                        "8c", u, i, f)
    params, w_diff = bucket.learner[0], 0.0
    for i, tr in enumerate(alone):
        for name, p in tr.net.named_parameters():
            d = (params[name][i] - p.detach()).abs()
            w_diff = max(w_diff, float(d.max()))
            assert bool((d <= TRAIN_ATOL + TRAIN_RTOL * p.detach().abs()).all()), ("8c", i, name)
    no_launches("8c", all_counts)
    pop["8c parity"] = {"slots": POP_PARITY_SLOTS, "updates": POP_PARITY_UPDATES,
                        "weights_max_abs_diff": w_diff, "atol": TRAIN_ATOL, "rtol": TRAIN_RTOL}
    log(f"[population] 8c a bucket of {POP_PARITY_SLOTS} against the same trials alone, "
        f"{POP_PARITY_UPDATES} updates: the same actions, rewards and dones; weights max "
        f"|bucket - alone| {w_diff:.3e} (limit {TRAIN_ATOL:g} + {TRAIN_RTOL:g} * |alone|)")
    phase_done(f"8c one bucket of {POP_SLOTS} slots, profiled, and a bucket against lone "
               "trainers")
    log("[population] summary " + json.dumps(pop))
    return paths, pop, t8


def hold_bucket_counts(label, counts, steps, expect, seq):
    """The launches of ``steps`` steps of LM buckets (``counts`` as
    ``all_counts`` gives them) at ``expect`` a step (``per_forward`` of the
    reduced config: a bucket of any number of slots launches what one
    trial's forward does): every RMSNorm the slot case of the block kernel,
    every flash call the FMA kernel, every scan the slot case of
    ``kernel_for``'s kernel at ``seq`` steps, every gmm the small kernel
    over the slots' (slot, expert) groups."""
    from repro_torch.kernels.selective_scan.selective_scan import PREFILL_MIN_STEPS
    launches, fa_by, gmm_by, rms_by, scan_by = counts
    for name, n in expect.items():
        assert launches[name] == n * steps, (label, name, launches[name], n * steps)
    assert fa_by == {"split_kv": 0, "tensor_core": 0, "fma": expect["flash_attention"] * steps}, (
        label, fa_by)
    n_rms, n_scan = expect["rmsnorm"] * steps, expect["selective_scan"] * steps
    assert rms_by == {"warp": 0, "block": n_rms, "slots": n_rms}, (label, rms_by)
    prefill = seq >= PREFILL_MIN_STEPS
    assert scan_by == {"prefill": n_scan * prefill, "sequential": n_scan * (not prefill),
                       "slots": n_scan}, (label, scan_by)
    assert gmm_by == {"tiled": 0, "decode": 0, "small": expect["gmm"] * steps}, (label, gmm_by)


def population_lm_phase(dev, smi, zero_counts, all_counts, phase_done):
    """Phase 9: LM trials on the population engine and PBT's clone on the
    card. 9a: the CLI's vectorized LM search at its defaults; 9b: a bucket
    of 12 slots at the thread backend's trial shape, profiled, beside one
    slot; 9c: a bucket against the same trials alone, and a bucket step on
    the card against the CPU; 9d: PBT on the engine for GA3C and LM, and one
    clone under ``set_sync_debug_mode("error")``. Returns the launch records
    of the LM paths (for the kernels' line) and the phase's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.core.completion import expected_alpha
    from repro_torch.core.executor import PopulationCluster
    from repro_torch.core.hypertrick import RandomSearchPolicy
    from repro_torch.core.scheduler import ReportReply
    from repro_torch.core.search_space import Categorical, LogUniform, SearchSpace
    from repro_torch.launch import population_checks as pc
    from repro_torch.launch import tune
    from repro_torch.population.engine import PopulationEngine, TrialLease
    from repro_torch.population.objectives.lm import LMObjective

    rcfg = get_config(YI).reduced()
    expect = per_forward(rcfg)
    paths, out = {}, {}

    def lm_search(label, run, w0, phases, steps, batch, seq, profiled=False, bar=True,
                  arch=YI):
        """``run()`` on the card: no trial crashed, 1 to ``phases`` reports
        a trial (all of them when it completed), every metric finite, with
        ``bar`` the best above -ln(vocab), alpha in (0, 1], one bucket, and the launch
        counters at the bucket's steps x ``per_forward`` of ``arch``'s reduced
        config (``hold_bucket_counts``)."""
        rc = get_config(arch).reduced()
        ex = per_forward(rc)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lead_in()
                res = run()
                torch.cuda.synchronize()
        else:
            res = run()
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, fa_by, gmm_by, rms_by, scan_by = all_counts()
        summary, tab = res.summary(), trial_table(res)
        assert summary["n_trials"] == w0, (label, summary)
        assert "crashed" not in summary["by_status"], (label, summary["by_status"])
        hold_trials(label, tab, phases, w0)
        if bar:
            assert summary["best_metric"] > -math.log(rc.vocab_size), (label, summary)
        alpha = res.service.db.completion_rate(phases)
        assert 0 < alpha <= 1, (label, alpha)
        buckets = {min(hp.get("loss_chunk", 1024), seq) for hp, _, _ in tab.values()}
        assert len(buckets) == 1, (label, buckets)
        iterations = res.service.metrics.histogram("engine.step_s").count
        log(f"[population-lm] {label}: {iterations} steps of the bucket, {res.updates} "
            f"trial-steps, launches {launches}, flash by kernel {fa_by}, rmsnorm by kernel "
            f"{rms_by}, gmm by kernel {gmm_by}, scan by kernel {scan_by}; per step of the "
            f"bucket {ex}")
        hold_bucket_counts(label, (launches, fa_by, gmm_by, rms_by, scan_by), iterations, ex,
                           seq)
        wall = res.wall_time
        row = {"search": label, "arch": rc.name, "trials": w0, "slots": res.n_nodes,
               "buckets": len(buckets), "phases": phases, "steps_per_phase": steps,
               "batch": batch, "seq": seq, "wall_s": wall, "run_s": run_s,
               "bucket_steps": iterations, "trial_steps": res.updates,
               "trial_steps_per_s": res.updates / wall,
               "tokens_per_s": res.updates * batch * seq / wall,
               "occupancy": res.occupancy, "alpha": alpha,
               "expected_alpha": expected_alpha(SEARCH_R, phases),
               "by_status": summary["by_status"], "best_metric": summary["best_metric"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches_per_bucket_step": ex}
        if profiled:
            kern = device_kernels(prof, skip_lead_in=True)
            busy_ms = sum(a.self_device_time_total for a in kern) / 1e3
            n_kern = sum(a.count for a in kern)
            row.update(device_busy_ms=busy_ms, device_busy_share=busy_ms / 1e3 / wall,
                       device_kernels=n_kern, kernels_per_bucket_step=n_kern / iterations,
                       port_kernel_ms=sum(a.self_device_time_total for a in kern
                                          if is_port_kernel(a.key)) / 1e3)
            for a in sorted(kern, key=lambda a: -a.self_device_time_total)[:8]:
                log(f"[profile]   {a.self_device_time_total / 1e3:9.3f} ms {a.count:7d}x "
                    f"{a.key[:90]}")
        log(f"[population-lm] {smi}: " + json.dumps(row))
        return (launches, ex, iterations, fa_by, gmm_by, rms_by, scan_by), row, res

    # 9a: the CLI's vectorized LM search at its defaults
    path, out["9a"], res_9a = lm_search(
        f"9a {YI}, vectorized", lambda: tune.main(POP_LM_ARGV), SEARCH_W0, SEARCH_PHASES,
        SEARCH_STEPS, POP_LM_BATCH, POP_LM_SEQ)
    paths[f"search {YI} vectorized"] = path
    a = out["9a"]
    log(f"[population-lm] 9a: {a['buckets']} bucket of {a['slots']} slots; wall "
        f"{a['wall_s']:.2f} s, trial-steps/s {a['trial_steps_per_s']:.2f}, tokens/s "
        f"{a['tokens_per_s']:.0f}, occupancy {a['occupancy']:.3f}, alpha {a['alpha']:.3f} "
        f"(expected {a['expected_alpha']:.3f}), peak GB {a['peak_mem_gb']:.3f}")
    phase_done("9a LM search, vectorized")

    # 9b: one bucket at the thread backend's trial shape, profiled, and one slot
    space = SearchSpace({"learning_rate": LogUniform(1e-4, 1e-2),
                         "loss_chunk": Categorical((1024,)), "grad_clip": Categorical((1.0,)),
                         "warmup_steps": Categorical((1,))})

    def bucket_search(slots):
        label = (f"9b {slots} slot{'s' if slots > 1 else ''}, one bucket, "
                 f"{SEARCH_BATCH} x {SEARCH_SEQ}")
        return lm_search(label, lambda: PopulationCluster(
            slots, objective=LMObjective(YI, batch=SEARCH_BATCH, seq=SEARCH_SEQ, device=dev),
            episodes_per_phase=POP_LM_STEPS, seed=0, device=dev).run(
                RandomSearchPolicy(space, slots, POP_LM_PHASES, seed=0)),
            slots, POP_LM_PHASES, POP_LM_STEPS, SEARCH_BATCH, SEARCH_SEQ, profiled=True,
            bar=slots > 1)      # a lone trial's drawn lr may be too small to learn in 50 steps

    path, out["9b"], _ = bucket_search(POP_SLOTS)
    paths[f"search {YI} one bucket of {POP_SLOTS}"] = path
    path, out["9b one slot"], _ = bucket_search(1)
    paths[f"search {YI} one bucket of 1"] = path
    k12, k1 = out["9b"]["kernels_per_bucket_step"], out["9b one slot"]["kernels_per_bucket_step"]
    out["9b"]["kernel_ratio_to_one_slot"] = k12 / k1
    log(f"[population-lm] 9b: kernels a step of the bucket {k12:.1f} at {POP_SLOTS} slots, "
        f"{k1:.1f} at one ({k12 / k1:.2f} x, limit {POP_KERNEL_RATIO:g} x); busy share "
        f"{out['9b']['device_busy_share']:.4f} ({out['9b one slot']['device_busy_share']:.4f}); "
        f"trial-steps/s {out['9b']['trial_steps_per_s']:.2f} "
        f"({out['9b one slot']['trial_steps_per_s']:.2f}); tokens/s "
        f"{out['9b']['tokens_per_s']:.0f} ({out['9b one slot']['tokens_per_s']:.0f})")
    assert k12 < POP_KERNEL_RATIO * k1, ("9b: launches grow with the slots", k12, k1)
    phase_done(f"9b one LM bucket of {POP_SLOTS} slots, profiled, and one slot")

    # 9c: a bucket against the same trials alone, on the same draws (each
    # slot's generator is seeded by trial_seed, in this process)
    hps = pc.SLOT_HPARAMS

    def lm_engine(n, device, init_device=None, arch=YI):
        return PopulationEngine(
            LMObjective(arch, device=device, init_device=init_device), max_slots=n,
            episodes_per_phase=10 ** 9, max_updates=10 ** 9, seed=0, device=device)

    def card_against_cpu(label, arch):
        """Two steps of a bucket of ``hps`` on the card and on the CPU from
        one CPU draw of the weights and of the data: each slot's summed loss
        within TRAIN_ATOL + TRAIN_RTOL |cpu|. The second step's loss is
        taken on the weights the first update made, so it holds the
        backward on the card (the aux gradient, the scan's and gmm's
        recomputed backwards) against the CPU's. A ``TorchFunctionMode``
        sees each router's ``topk`` in the first step (no module is
        patched): where the model has MoE layers, every token must pick the
        same experts on both devices; a token that does not is printed with
        its margin between the k-th and (k+1)-th probability."""
        from torch.overrides import TorchFunctionMode
        rc = get_config(arch).reduced()
        k, n_routers = rc.top_k, sum(f == "moe" for _, f in rc.pattern) * rc.n_repeat
        sums, routed = {}, {}

        class Watch(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is torch.topk:
                    top = torch.topk(args[0].detach(), k + 1, dim=-1).values
                    routed[key].append((out.indices.cpu(), (top[..., -2] - top[..., -1]).cpu()))
                return out

        for d in ("cpu", dev):
            key = str(d)
            routed[key] = []
            e = lm_engine(len(hps), d, init_device="cpu", arch=arch)
            e._admit_grouped([TrialLease(i, hp) for i, hp in enumerate(hps)], now=0.0)
            with Watch():
                e.buckets[POP_LM_SEQ].step()
            e.buckets[POP_LM_SEQ].step()
            sums[key] = e.buckets[POP_LM_SEQ].carry[1].cpu()
        assert len(routed["cpu"]) == len(routed[str(dev)]) == n_routers, (
            label, arch, len(routed["cpu"]), len(routed[str(dev)]), n_routers)
        flips = []
        for (ci, cm), (gi, _) in zip(routed["cpu"], routed[str(dev)]):
            apart = (ci != gi).any(-1)
            flips += cm[apart].tolist()
        card, cpu = sums[str(dev)], sums["cpu"]
        dev_diff = float((card - cpu).abs().max())
        row = {"arch": arch, "slots": len(hps), "loss_max_abs_diff": dev_diff,
               "card": card.tolist(), "cpu": cpu.tolist(), "moe_layers": len(routed["cpu"]),
               "tokens_routed_apart": len(flips), "their_margins": flips}
        log(f"[population-lm] {label} two bucket steps of {arch}, card against CPU: summed losses "
            f"{(-card).tolist()} and {(-cpu).tolist()}, max |card - cpu| {dev_diff:.3e} (limit "
            f"{TRAIN_ATOL:g} + {TRAIN_RTOL:g} |cpu|); {len(routed['cpu'])} routers, tokens "
            f"routed apart {len(flips)} (margins {flips})")
        assert not flips, (label, arch, "tokens routed apart", flips)
        assert bool(((card - cpu).abs() - TRAIN_RTOL * cpu.abs() <= TRAIN_ATOL).all()), (
            label, arch, card, cpu)
        return row

    zero_counts()
    slots = pc.slot_rows(0, dev)
    torch.cuda.synchronize()
    launches, fa_by, gmm_by, rms_by, scan_by = all_counts()
    steps = pc.UPDATES * (1 + len(hps))
    assert launches["rmsnorm"] == expect["rmsnorm"] * steps == rms_by["slots"], (launches, rms_by)
    assert fa_by["fma"] == expect["flash_attention"] * steps, fa_by
    paths[f"{YI} bucket of {len(hps)} and alone"] = (launches, expect, steps, fa_by, gmm_by,
                                                     rms_by, scan_by)
    faults = [pc.slot_faults(r) for r in slots]
    out["9c"] = {"slots": len(hps), "updates": pc.UPDATES, "by_slot": slots, "faults": faults}
    v_rel = [f"{r['v_sum_rel_diff']:.1e}" for r in slots]
    log(f"[population-lm] 9c a bucket of {len(hps)} against the same trials alone, "
        f"{pc.UPDATES} updates: summed second moments {v_rel} apart (limit {pc.V_RTOL:g} "
        f"relative); weights outside {pc.ATOL:g} + {pc.RTOL:g} |alone| "
        f"{[r['outside_limit'] for r in slots]} of {slots[0]['weights']} (limit "
        f"{pc.OUTLIERS}), max |bucket - alone| / lr {[round(r['over_lr'], 4) for r in slots]} "
        f"(limit {pc.MAX_OVER_LR:g}); summed -loss "
        f"{max(r['loss_sum_abs_diff'] for r in slots):.3e}; limits broken {faults}")
    assert not any(faults), ("9c", faults, slots)
    # two bucket steps on the card against the CPU, one CPU draw of the
    # weights and of the data
    out["9c card vs cpu"] = card_against_cpu("9c", YI)
    phase_done("9c LM bucket against lone trials, and card against CPU")

    # 9d: PBT on the engine through the CLI, GA3C and LM
    for kind, argv in (("rl", PBT_RL_ARGV), ("lm", PBT_LM_ARGV)):
        runs = []
        for seed in range(PBT_SEEDS):
            zero_counts()
            t0 = time.perf_counter()
            res = tune.main([*argv, "--seed", str(seed)])
            torch.cuda.synchronize()
            summary = res.summary()
            runs.append({"seed": seed, "wall_s": time.perf_counter() - t0,
                         "clones": summary.get("clones", 0),
                         "clones_on_device": summary.get("clones_on_device", 0),
                         "by_status": summary["by_status"], "best_metric": summary["best_metric"],
                         "launches": all_counts()[0]})
            log(f"[population-lm] 9d PBT {kind}: {json.dumps(runs[-1])}")
            assert summary["by_status"] == {"completed": 4}, (kind, summary)
            if kind == "rl":
                no_launches(f"9d {kind}", all_counts)
            if runs[-1]["clones_on_device"]:
                break
        assert runs[-1]["clones"] >= 1 and runs[-1]["clones_on_device"] >= 1, (kind, runs)
        out[f"9d pbt {kind}"] = runs
    # one clone on the card under the sync check: bit-equal learner, the
    # child's carry kept
    e = lm_engine(2, dev)
    e._admit_grouped([TrialLease(i, hp) for i, hp in enumerate(hps[:2])], now=0.0)
    b = e.buckets[POP_LM_SEQ]
    b.step()
    carry = [t[1].clone() if isinstance(t, torch.Tensor) else t[1]
             for t in b.leaves[b._n_learner:]]
    gen_state = carry[-1].get_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e._exploit(b, 1, b.meta[1], ReportReply("continue", clone_from=0, perturb=dict(
            hps[0], learning_rate=7e-4)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    learner = [t for t in b.leaves[:b._n_learner] if isinstance(t, torch.Tensor)]
    assert e.clones == 1 and all(torch.equal(t[1], t[0]) for t in learner), "9d clone"
    after = [t[1] if isinstance(t, torch.Tensor) else t[1] for t in b.leaves[b._n_learner:]]
    assert all(torch.equal(x, y) for x, y in zip(carry[:-1], after[:-1])), "9d carry"
    assert after[-1] is carry[-1] and torch.equal(after[-1].get_state(), gen_state), "9d gen"
    out["9d clone"] = {"leaves_copied": len(learner), "bit_equal": True, "carry_kept": True,
                       "sync_debug_mode": "error"}
    log(f"[population-lm] 9d one clone on the card under set_sync_debug_mode('error'): "
        f"{len(learner)} learner leaves bit-equal to the parent's, the child's carry kept")
    phase_done("9d PBT on the engine, GA3C and LM, and a clone under the sync check")

    # 9e: 9a's search over jamba's reduced config (a mamba block: the scan's
    # slot case) and grok-1's (a MoE block: gmm over the slots' (slot,
    # expert) groups), each held as 9a, then one bucket step on the card
    # against the CPU
    tables = {}
    for arch in BLOCK_ARCHS:
        label = f"9e {arch}"
        path, out[label], res = lm_search(
            f"{label}, vectorized", lambda a=arch: tune.main([*BLOCK_ARGV, "--arch", a]),
            SEARCH_W0, BLOCK_PHASES, SEARCH_STEPS, POP_LM_BATCH, POP_LM_SEQ, arch=arch)
        paths[f"search {arch} vectorized"] = path
        tables[arch] = trial_table(res)
        out[f"{label} card vs cpu"] = card_against_cpu(label, arch)
    # jamba's bucket of 4 against the same trials alone (9c's comparison and
    # limits)
    zero_counts()
    slots = pc.slot_rows(0, dev, arch=HYBRID)
    torch.cuda.synchronize()
    steps = pc.UPDATES * (1 + len(hps))
    jexpect = per_forward(get_config(HYBRID).reduced())
    counts = all_counts()
    hold_bucket_counts(f"9e {HYBRID} slots", counts, steps, jexpect, POP_LM_SEQ)
    paths[f"{HYBRID} bucket of {len(hps)} and alone"] = (counts[0], jexpect, steps, *counts[1:])
    faults = [pc.slot_faults(r) for r in slots]
    out[f"9e {HYBRID} slots"] = {"slots": len(hps), "updates": pc.UPDATES, "by_slot": slots,
                                  "faults": faults}
    v_rel = [f"{r['v_sum_rel_diff']:.1e}" for r in slots]
    log(f"[population-lm] 9e {HYBRID}: a bucket of {len(hps)} against the same trials alone: "
        f"summed second moments {v_rel} apart; weights outside "
        f"{[r['outside_limit'] for r in slots]} of {slots[0]['weights']}, max |bucket - alone| "
        f"/ lr "
        f"{[round(r['over_lr'], 4) for r in slots]}; summed -loss "
        f"{max(r['loss_sum_abs_diff'] for r in slots):.3e}; limits broken {faults}")
    assert not any(faults), ("9e", HYBRID, faults, slots)
    # jamba's search on one population worker of 12 slots (a tune
    # subprocess, as 11a), held to 9e's trials as 11a is held to 9a's
    with tempfile.TemporaryDirectory() as tmp:
        argv = [*POPW_LM_ARGV, "--arch", HYBRID, "--phases", str(BLOCK_PHASES), "--nodes", "1",
                "--slots", str(POP_SLOTS)]
        t0 = time.perf_counter()
        proc, out_path, jpath = tune_process(argv, tmp, "9e-worker")
        stdout = finish(proc, "9e worker")
        run_s = time.perf_counter() - t0
        summary = json.load(open(out_path))
        table, _, _ = journal_trials(jpath)
    label = f"9e {HYBRID}, 1 population worker of {POP_SLOTS} slots"
    hold_trials(label, table, BLOCK_PHASES, SEARCH_W0)
    same_configs(label, table, tables[HYBRID])
    assert summary["by_status"] == out[f"9e {HYBRID}"]["by_status"], (
        label, summary["by_status"], out[f"9e {HYBRID}"]["by_status"])
    pairs = both_trained(table, tables[HYBRID])
    unequal = [(t, ph, a, b) for t, ph, a, b in pairs if a != b]
    for t, ph, a, b in unequal:
        log(f"[population-lm] {label} trial {t} phase {ph}: {a!r} against 9e's {b!r}")
    lines = population_workers(stdout, label, 1, jexpect)
    wsteps = sum(c["engine_steps"] for c in lines.values())
    wcounts, _ = worker_counts(stdout, label, 1)
    paths[f"population worker lm {HYBRID} 1 x {POP_SLOTS}"] = (wcounts[0], jexpect, wsteps,
                                                              *wcounts[1:])
    out[label] = {"argv": argv, "wall_s": summary["wall_time"], "run_s": run_s,
                  "by_status": summary["by_status"], "bucket_steps": wsteps,
                  "compared_with_9e": len(pairs), "unequal": len(unequal)}
    log(f"[population-lm] {smi}: {label} " + json.dumps(out[label]))
    assert not unequal, (label, unequal)
    phase_done("9e LM searches of jamba and grok-1 on the engine, card against CPU, slots "
               "against lone trials, and a population worker")
    log("[population-lm] summary " + json.dumps(out))
    return paths, out, trial_table(res_9a)


# phase 10: the control plane. The tune CLI runs as a subprocess, its
# trials in worker processes (``python -m repro_torch.distributed.worker``)
# against the TCP server in the launcher; each run's summary comes from
# ``--out``, its trials from ``--journal`` (both under a temporary
# directory) and each worker's launch counters from its closing line on the
# captured stdout. 10a: 6a's search (the CLI's LM defaults) on --backend
# server, 12 workers on 4 worker processes. 10b: the same with a fresh
# journal, its process group SIGKILLed once CONTROL_KILL_AFTER reports are
# journaled, then --resume. 10c: Hyperband (the reference's acceptance
# scenario, tests/test_scheduler.py:133) with LM trials on --backend
# process. 10d: 7a's GA3C search on --backend process, 4 worker processes
CONTROL_NODES, CONTROL_KILL_AFTER = 4, 12
CONTROL_LM_ARGV = ["--backend", "server", "--objective", "lm"]
# 10b's search is 10a's cut to 3 of its 5 phases (before whisper's
# training): killed after 12 reports as before, its metrics held to 6a's for
# the same configuration and phase
CONTROL_RESUME_PHASES = 3
CONTROL_RESUME_ARGV = [*CONTROL_LM_ARGV, "--phases", str(CONTROL_RESUME_PHASES)]
CONTROL_HB_ARGV = ["--backend", "process", "--objective", "lm", "--scheduler", "hyperband",
                   "--phases", "4", "--eta", "2", "--nodes", "10", "--steps-per-phase", "4"]
CONTROL_HB_RUNGS = {0: [(0, 4, 2), (1, 2, 1)], 1: [(1, 3, 2)]}
CONTROL_RL_ARGV = ["--backend", "process", *RL_ARGV]
# 10e: 6d's whisper search on --backend process, its 2 nodes 2 worker
# processes, each (trial, phase) both trained held to 6d's
CONTROL_WHISPER_ARGV = ["--backend", "process", "--arch", WHISPER, *SEARCH_KERNEL_ARGV]
CONTROL_TIMEOUT = 300


def tune_process(argv, tmp, name):
    """``python -m repro_torch.launch.tune argv --out --journal`` in a
    session of its own (its worker processes join its process group)."""
    out, journal = os.path.join(tmp, f"{name}.json"), os.path.join(tmp, f"{name}.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.tune", *argv, "--out", out,
         "--journal", journal], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, start_new_session=True)
    return proc, out, journal


def finish(proc, label, timeout=CONTROL_TIMEOUT):
    """Wait for a tune subprocess (its workers hold its pipes, so the end
    of output is the end of every worker); kill its process group if it
    overruns. Returns its stdout."""
    import signal
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        raise AssertionError((label, f"no end in {timeout} s", stderr[-4000:]))
    assert proc.returncode == 0, (label, proc.returncode, stderr[-4000:])
    return stdout


def journal_trials(path):
    """{trial id: (hparams, status, [metric a phase])} from a journal, its
    (trial id, phase) reports in order, and the seconds the workers spent
    in phases (the server's ``trial.phase`` spans)."""
    from repro_torch.distributed.journal import read_events
    table, reports, busy = {}, [], 0.0
    for ev in read_events(path):
        tid = ev.get("trial_id")
        if ev["ev"] == "span" and ev["name"] == "trial.phase":
            busy += ev["dur"]
        elif ev["ev"] == "acquire":
            table[tid] = [ev["hparams"], "running", []]
        elif ev["ev"] == "report":
            assert len(table[tid][2]) == ev["phase"], ("journal phase order", ev)
            table[tid][2].append(ev["metric"])
            reports.append((tid, ev["phase"]))
        elif ev["ev"] == "status":
            table[tid][1] = ev["status"]
    return {t: tuple(v) for t, v in table.items()}, reports, busy


def start_up(path, t_spawn):
    """Seconds from a tune subprocess's spawn (``time.monotonic()``, the
    clock the server journals and every process shares) to its first
    journaled acquire (the launcher's and a worker's start-up), to its
    first report (a worker's first phase too) and to its last report."""
    from repro_torch.distributed.journal import read_events
    ts = {"acquire": [], "report": []}
    for ev in read_events(path):
        if ev["ev"] in ts and ev.get("t") is not None and ev["t"] >= t_spawn:
            ts[ev["ev"]].append(ev["t"] - t_spawn)
    return {"first_acquire_s": min(ts["acquire"]), "first_report_s": min(ts["report"]),
            "last_report_s": max(ts["report"])}


def worker_counts(stdout, label, n_workers):
    """The summed launch counters of the workers' closing lines, as
    ``all_counts`` gives them, and the GA3C trainers' env steps and
    updates."""
    from repro_torch.distributed.worker import parse_closing_line
    lines = [c for c in map(parse_closing_line, stdout.splitlines()) if c is not None]
    assert sorted(c["node"] for c in lines) == list(range(n_workers)), (label, lines)
    tot = collections.defaultdict(int)
    for c in lines:
        for op, counters in c["launches"].items():
            for k, v in counters.items():
                tot[(op, k)] += v
    launches = {op: tot[(op, "launches")] for op in
                ("rmsnorm", "flash_attention", "selective_scan", "gmm")}
    by = lambda op, names: {n: tot[(op, f"launches_{n}")] for n in names}  # noqa: E731
    counts = (launches, by("flash_attention", ("split_kv", "tensor_core", "fma")),
              by("gmm", ("tiled", "decode", "small")), by("rmsnorm", ("warp", "block", "slots")),
              by("selective_scan", ("prefill", "sequential", "slots")))
    return counts, (sum(c.get("env_steps", 0) for c in lines),
                    sum(c.get("updates", 0) for c in lines))


def hold_lm_counts(label, counts, steps, expect):
    """The launches of an LM search (``counts`` as ``all_counts`` gives
    them) at ``steps`` trial steps x ``expect`` (``per_forward`` of the
    reduced config), each on the f32 kernels: block RMSNorm, FMA flash, the
    small gmm, the prefill scan. Returns the search's launch record."""
    launches, fa_by, gmm_by, rms_by, scan_by = counts
    for name, n in expect.items():
        assert launches[name] == n * steps, (label, name, launches[name], n * steps)
    assert fa_by == {"split_kv": 0, "tensor_core": 0, "fma": expect["flash_attention"] * steps}, (
        label, fa_by)
    assert rms_by == {"warp": 0, "block": expect["rmsnorm"] * steps, "slots": 0}, (label, rms_by)
    assert gmm_by == {"tiled": 0, "decode": 0, "small": expect["gmm"] * steps}, (label, gmm_by)
    assert scan_by == {"prefill": expect["selective_scan"] * steps, "sequential": 0,
                       "slots": 0}, (label, scan_by)
    return (launches, expect, steps, fa_by, gmm_by, rms_by, scan_by)


def hold_trials(label, table, phases, w0=None, score=None):
    """No trial crashed but those ``table`` marks reclaimed; every other
    trial 1 to ``phases`` reports (all when it completed), every metric
    finite (and a score of pong within ``score``)."""
    if w0 is not None:
        assert len(table) == w0, (label, len(table))
    for tid, (hp, status, ms) in table.items():
        if status == "crashed":
            continue
        assert status in ("completed", "killed"), (label, tid, status)
        assert 1 <= len(ms) <= phases and (status != "completed" or len(ms) == phases), (
            label, tid, status, ms)
        assert all(math.isfinite(m) and (score is None or abs(m) <= score) for m in ms), (
            label, tid, ms)


def control_plane_phase(smi, phase_done, out_6a, table_6a, rl, kept, table_6d_whisper):
    """Phase 10: the control plane on the card (10a-10e above). Returns the
    launch records of its searches, counted in the worker processes, its
    numbers and 10a's live tail (phase 14). 10a's and 10c's journals go
    into ``kept``."""
    import signal
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.completion import expected_alpha

    expect = per_forward(get_config(YI).reduced())
    paths, out = {}, {}
    key = lambda hp: json.dumps(hp, sort_keys=True)  # noqa: E731
    by_config_6a = {(key(hp), ph): m for hp, _, ms in table_6a.values()
                    for ph, m in enumerate(ms)}

    with tempfile.TemporaryDirectory() as tmp:
        # 10a: 6a's search on the server backend, 4 worker processes
        t0, spawned = time.perf_counter(), time.monotonic()
        proc, out_path, jpath = tune_process(CONTROL_LM_ARGV, tmp, "10a")
        tail = LiveTail(jpath)          # 14b: the journal tailed as it is written
        try:
            stdout = finish(proc, "10a")
        finally:
            tail.stop()
        run_s = time.perf_counter() - t0
        tail.drain()
        summary = json.load(open(out_path))
        table, reports, busy = journal_trials(jpath)
        hold_trials("10a", table, SEARCH_PHASES, SEARCH_W0)
        assert "crashed" not in summary["by_status"] and 0 < summary["alpha"] <= 1, summary
        assert summary["best_metric"] > -math.log(get_config(YI).reduced().vocab_size), summary
        assert {t: hp for t, (hp, _, _) in table.items()} == {
            t: hp for t, (hp, _, _) in table_6a.items()}, "10a: configs differ from 6a's"
        pairs = [(t, ph, ms[ph], table_6a[t][2][ph]) for t, (_, _, ms) in sorted(table.items())
                 for ph in range(min(len(ms), len(table_6a[t][2])))]
        unequal = [(t, ph, a, b) for t, ph, a, b in pairs if abs(a - b) > SEARCH_NODES_ATOL]
        for t, ph, a, b in unequal:
            log(f"[control] 10a trial {t} phase {ph}: processes {a!r}, 6a threads {b!r}, "
                f"difference {a - b!r}")
        steps = SEARCH_STEPS * len(reports)
        counts, _ = worker_counts(stdout, "10a", CONTROL_NODES)
        paths["control lm server 4 processes"] = hold_lm_counts("10a", counts, steps, expect)
        wall = summary["wall_time"]
        out["10a"] = {"argv": CONTROL_LM_ARGV, "trials": len(table), "processes": CONTROL_NODES,
                      "wall_s": wall, "run_s": run_s, "occupancy": summary["occupancy"],
                      "alpha": summary["alpha"],
                      "expected_alpha": expected_alpha(SEARCH_R, SEARCH_PHASES),
                      "by_status": summary["by_status"], "trial_steps": steps,
                      "trial_steps_per_s": steps / wall,
                      "tokens_per_s": steps * SEARCH_BATCH * SEARCH_SEQ / wall,
                      "phase_busy_s": busy, "trial_steps_per_busy_s": steps / busy,
                      "compared_with_6a": len(pairs), "unequal": len(unequal),
                      "max_abs_diff": max(abs(a - b) for _, _, a, b in pairs),
                      "atol": SEARCH_NODES_ATOL, "launches": counts[0],
                      "start_up": start_up(jpath, spawned),
                      "6a_threads": {k: out_6a[k] for k in (
                          "wall_s", "occupancy", "trial_steps_per_s", "tokens_per_s")}}
        log(f"[control] {smi}: " + json.dumps(out["10a"]))
        assert not unequal, ("10a: metrics differ from 6a's", unequal)
        keep_journal(kept, "10a", jpath, len(table), summary["best_metric"], parks=False)
        phase_done("10a LM search, server backend, 4 worker processes")

        # 10b: the same search killed once CONTROL_KILL_AFTER reports are
        # journaled, then resumed from its journal
        t0, spawned = time.perf_counter(), time.monotonic()
        proc, out_path, jpath = tune_process(CONTROL_RESUME_ARGV, tmp, "10b")
        try:
            while time.perf_counter() - t0 < CONTROL_TIMEOUT and proc.poll() is None:
                if os.path.exists(jpath) and sum(
                        r == "report" for r in (json.loads(ln).get("ev") for ln in
                                                open(jpath) if ln.endswith("\n"))
                ) >= CONTROL_KILL_AFTER:
                    break
                time.sleep(0.05)
        finally:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
        killed_s = time.perf_counter() - t0
        _, before, _ = journal_trials(jpath)
        assert CONTROL_KILL_AFTER <= len(before), ("10b: kill", len(before))
        killed_start_up = start_up(jpath, spawned)
        resumed_at = time.monotonic()
        proc, out_path, _ = tune_process([*CONTROL_RESUME_ARGV, "--resume"], tmp, "10b")
        stdout = finish(proc, "10b resume")
        summary = json.load(open(out_path))
        table, both, _ = journal_trials(jpath)
        assert len(both) == len(set(both)), "10b: a (trial, phase) journaled twice"
        assert len(before) < len(both), ("10b: killed after the search's end", len(before))
        hold_trials("10b", table, CONTROL_RESUME_PHASES)
        crashed = [t for t, (_, st_, _) in table.items() if st_ == "crashed"]
        assert len(table) - len(crashed) == SEARCH_W0, ("10b", len(table), crashed)
        assert 0 < summary["alpha"] <= 1, summary
        held = missing = 0
        for hp, _, ms in table.values():
            for ph, m in enumerate(ms):
                want = by_config_6a.get((key(hp), ph))
                if want is None:
                    missing += 1
                    continue
                held += 1
                assert abs(m - want) <= SEARCH_NODES_ATOL, ("10b", hp, ph, m, want)
        steps = SEARCH_STEPS * (len(both) - len(before))
        counts, _ = worker_counts(stdout, "10b", CONTROL_NODES)
        paths["control lm server resumed"] = hold_lm_counts("10b", counts, steps, expect)
        out["10b"] = {"killed_after_s": killed_s, "reports_before_kill": len(before),
                      "resumed_wall_s": summary["wall_time"], "reclaimed": len(crashed),
                      "requeued_configs": len(crashed), "reports": len(both),
                      "held_against_6a": held, "not_trained_by_6a": missing,
                      "by_status": summary["by_status"], "alpha": summary["alpha"],
                      "launches": counts[0], "start_up_killed_run": killed_start_up,
                      "start_up_resumed_run": start_up(jpath, resumed_at)}
        log(f"[control] {smi}: 10b " + json.dumps(out["10b"]))
        phase_done("10b LM search killed and resumed")

        # 10c: Hyperband, every bracket at once, LM trials in 10 processes
        t0, spawned = time.perf_counter(), time.monotonic()
        proc, out_path, jpath = tune_process(CONTROL_HB_ARGV, tmp, "10c")
        stdout = finish(proc, "10c")
        summary = json.load(open(out_path))
        table, reports, _ = journal_trials(jpath)
        hold_trials("10c", table, 4, 10)
        by_b = collections.defaultdict(list)
        for e in sorted(summary["rungs"], key=lambda e: (e["bracket"], e["phase"])):
            by_b[e["bracket"]].append((e["phase"], e["n"], len(e["demoted"])))
        assert dict(by_b) == CONTROL_HB_RUNGS, ("10c rungs", summary["rungs"])
        assert summary["by_status"] == {"killed": 5, "completed": 5}, summary["by_status"]
        steps = 4 * len(reports)
        counts, _ = worker_counts(stdout, "10c", 10)
        paths["control lm hyperband 10 processes"] = hold_lm_counts("10c", counts, steps, expect)
        out["10c"] = {"rungs": dict(by_b), "by_status": summary["by_status"],
                      "wall_s": summary["wall_time"], "run_s": time.perf_counter() - t0,
                      "trial_steps": steps, "launches": counts[0],
                      "start_up": start_up(jpath, spawned)}
        log(f"[control] {smi}: 10c " + json.dumps(out["10c"]))
        keep_journal(kept, "10c", jpath, len(table), summary["best_metric"], parks=True)
        phase_done("10c Hyperband, process backend, 10 worker processes")

        # 10d: 7a's GA3C search on 4 worker processes; no kernel of the port
        t0, spawned = time.perf_counter(), time.monotonic()
        proc, out_path, jpath = tune_process(CONTROL_RL_ARGV, tmp, "10d")
        stdout = finish(proc, "10d")
        summary = json.load(open(out_path))
        table, reports, busy = journal_trials(jpath)
        hold_trials("10d", table, RL_PHASES, RL_W0, score=RL_SCORE)
        assert "crashed" not in summary["by_status"] and 0 < summary["alpha"] <= 1, summary
        counts, (env_steps, updates) = worker_counts(stdout, "10d", RL_NODES)
        for c in counts:
            assert not any(c.values()), ("10d: a kernel launched on the GA3C path", counts)
        paths[f"control rl {RL_GAME} 4 processes"] = (
            counts[0], {name: 0 for name in counts[0]}, 0, *counts[1:])
        wall = summary["wall_time"]
        out["10d"] = {"argv": CONTROL_RL_ARGV, "processes": RL_NODES, "wall_s": wall,
                      "run_s": time.perf_counter() - t0, "trial_phases": len(reports),
                      "updates": updates, "env_frames": env_steps,
                      "env_frames_per_s": env_steps / wall, "updates_per_s": updates / wall,
                      "phase_busy_s": busy, "env_frames_per_busy_s": env_steps / busy,
                      "occupancy": summary["occupancy"], "alpha": summary["alpha"],
                      "expected_alpha": expected_alpha(RL_R, RL_PHASES),
                      "by_status": summary["by_status"],
                      "start_up": start_up(jpath, spawned),
                      "7a_4_threads": {k: rl["7a"][k] for k in (
                          "wall_s", "env_frames_per_s", "updates_per_s")},
                      "7b_1_thread": {k: rl["7b"][k] for k in (
                          "wall_s", "env_frames_per_s", "updates_per_s")}}
        log(f"[control] {smi}: 10d " + json.dumps(out["10d"]))
        phase_done("10d GA3C search, process backend, 4 worker processes")

        # 10e: 6d's whisper search on 2 worker processes
        t0, spawned = time.perf_counter(), time.monotonic()
        proc, out_path, jpath = tune_process(CONTROL_WHISPER_ARGV, tmp, "10e")
        stdout = finish(proc, "10e")
        summary = json.load(open(out_path))
        table, reports, busy = journal_trials(jpath)
        hold_trials("10e", table, 2, 4)
        assert "crashed" not in summary["by_status"] and 0 < summary["alpha"] <= 1, summary
        same_configs("10e", table, table_6d_whisper)
        pairs = both_trained(table, table_6d_whisper)
        unequal = [(t, ph, a, b) for t, ph, a, b in pairs if abs(a - b) > SEARCH_NODES_ATOL]
        for t, ph, a, b in unequal:
            log(f"[control] 10e trial {t} phase {ph}: processes {a!r}, 6d threads {b!r}, "
                f"difference {a - b!r}")
        steps = 4 * len(reports)
        wexpect = per_forward(get_config(WHISPER).reduced(), encoder=True)
        counts, _ = worker_counts(stdout, "10e", 2)
        paths[f"control lm {WHISPER} 2 processes"] = hold_lm_counts("10e", counts, steps, wexpect)
        out["10e"] = {"argv": CONTROL_WHISPER_ARGV, "trials": len(table), "processes": 2,
                      "wall_s": summary["wall_time"], "run_s": time.perf_counter() - t0,
                      "by_status": summary["by_status"], "trial_steps": steps,
                      "trial_steps_per_s": steps / summary["wall_time"],
                      "phase_busy_s": busy, "compared_with_6d": len(pairs),
                      "unequal": len(unequal),
                      "max_abs_diff": max(abs(a - b) for _, _, a, b in pairs),
                      "atol": SEARCH_NODES_ATOL, "launches": counts[0],
                      "start_up": start_up(jpath, spawned)}
        log(f"[control] {smi}: 10e " + json.dumps(out["10e"]))
        assert pairs and not unequal, ("10e: metrics differ from 6d's", unequal)
        phase_done(f"10e {WHISPER} LM search, process backend, 2 worker processes")
    log("[control] summary " + json.dumps(out))
    return paths, out, tail


# phase 11: the population worker. Each run is the tune CLI as a subprocess
# (as in phase 10), its worker processes population engines that lease a
# batch of trials (``--slots``), under the script's pinned hash seed
# (SMOKE_HASH_SEED), so a trial draws what it drew in 8a and 9a. 11a: 9a's
# LM search on one worker of 12 slots; 11b: on two of 6; 11c: 7a's GA3C
# search on two workers of 6; 11d: the pooled bracket of
# tests/test_bracket_barrier.py:362, at 64 updates a phase (the reference's
# test takes 3): 64 updates at t_max 4 are 256 steps, pong's step limit, so
# every env ends an episode in phase 0 whatever its draws, and the phase-0
# metrics can differ (at 3 updates no episode ends and every metric reads
# 0.0; on the CPU's draws the first episodes end at 16 updates)
POPW_LM_ARGV = ["--backend", "server", "--objective", "lm"]
POPW_LM_LAYOUTS = {"11a": (1, 12), "11b": (2, 6)}
POPW_RL_ARGV = ["--backend", "process", *RL_ARGV, "--nodes", "2", "--slots", "6"]
POPW_BRACKET = dict(spec={"kind": "rl", "game": "pong", "episodes_per_phase": 2,
                          "max_updates": 64, "seed": 0}, trials=4, phases=2, nodes=2, slots=2,
                    eta=3)

# phase 12: the paper's baselines through the port's Python API. 12a:
# SyncCluster.run_sh of 6a's configurations over 6a's objective; 12b: of
# 7a's over 7a's GA3C objective; both at SH_EVICT, cut to SH_PHASES phases
# (one eviction between phases and one at the end: each further phase adds
# a round of the slowest survivors to the smoke's time); 12c:
# EvolutionaryHyperTrick over 6a's objective on 4 node threads, its warmup
# (warmup_frac 0.5: 6 fresh draws) HyperTrick's first draws at seed 0. The
# counts a run_sh must give, from Python's round (12 at 0.25 keep 9; 9 keep
# 7), as the reference gives them on the CPU
SH_PHASES, SH_EVICT = 2, 0.25
SH_PER_PHASE, SH_BY_STATUS = [12, 9], {"killed": 5, "completed": 7}
# 12c is cut to 2 phases (3 before whisper's training): trials 0-5 still
# carry 6a's configurations and metrics, and the children come after them
EVO_PHASES, EVO_WARMUP = 2, 6
PERTURB_FACTORS = (0.5, 0.8, 1.25, 2.0)


def population_workers(stdout, label, n_workers, slots_expect=None):
    """Each population worker's closing line (``parse_closing_line``), by
    node; with ``slots_expect`` (launches a step of the LM bucket) each
    worker's counters held at its steps of the bucket x that
    (``hold_bucket_counts`` at the LM objective's sequence length)."""
    from repro_torch.distributed.worker import parse_closing_line
    lines = {c["node"]: c for c in map(parse_closing_line, stdout.splitlines())
             if c is not None and "reports" in c}
    assert sorted(lines) == list(range(n_workers)), (label, lines)
    for node, c in lines.items():
        la, steps = c["launches"], c["engine_steps"]
        if slots_expect is None:
            assert not any(v for op in la.values() for v in op.values()), (label, node, la)
            continue
        by = lambda op, names: {n: la[op][f"launches_{n}"] for n in names}  # noqa: E731
        counts = ({op: la[op]["launches"] for op in la},
                  by("flash_attention", ("split_kv", "tensor_core", "fma")),
                  by("gmm", ("tiled", "decode", "small")),
                  by("rmsnorm", ("warp", "block", "slots")),
                  by("selective_scan", ("prefill", "sequential", "slots")))
        hold_bucket_counts(f"{label} node {node}", counts, steps, slots_expect, POP_LM_SEQ)
    return lines


def same_configs(label, table, ref):
    assert {t: hp for t, (hp, _, _) in table.items()} == {
        t: hp for t, (hp, _, _) in ref.items()}, f"{label}: configs differ by trial id"


def near(row, keys):
    """The entries of ``row`` under ``keys``, where it has them: an earlier
    run's numbers, printed beside a run's."""
    return {k: row[k] for k in keys if k in row}


def both_trained(table, ref):
    """(trial, phase, metric here, metric in ``ref``) of every (trial,
    phase) both runs trained."""
    return [(t, ph, ms[ph], ref[t][2][ph]) for t, (_, _, ms) in sorted(table.items())
            for ph in range(min(len(ms), len(ref[t][2])))]


def population_worker_phase(smi, phase_done, beside, table_9a, table_8a, kept):
    """Phase 11: the population worker on the card (11a-11d above).
    ``beside``: 9a's, 8a's and 10a's rows of this run, printed beside each
    run's; ``table_9a`` / ``table_8a``: their trials, which 11a-11b and 11c
    are held against. Returns the launch records of the LM runs (counted in
    the worker processes) and the phase's numbers; 11a's journal goes into
    ``kept`` (phase 14)."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.core.executor import ProcessCluster
    from repro_torch.core.hypertrick import RandomSearchPolicy
    from repro_torch.core.search_space import Categorical, LogUniform, SearchSpace
    from repro_torch.launch import population_checks as pc

    expect = per_forward(get_config(YI).reduced())
    paths, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # 11a / 11b: 9a's search, held against 9a's trials
        for label, (nodes, slots) in POPW_LM_LAYOUTS.items():
            argv = [*POPW_LM_ARGV, "--nodes", str(nodes), "--slots", str(slots)]
            t0, spawned = time.perf_counter(), time.monotonic()
            proc, out_path, jpath = tune_process(argv, tmp, label)
            stdout = finish(proc, label)
            run_s = time.perf_counter() - t0
            summary = json.load(open(out_path))
            table, reports, busy = journal_trials(jpath)
            hold_trials(label, table, SEARCH_PHASES, SEARCH_W0)
            assert "crashed" not in summary["by_status"] and 0 < summary["alpha"] <= 1, summary
            same_configs(label, table, table_9a)
            pairs = both_trained(table, table_9a)
            if label == "11a":
                # one engine of 12 slots, as 9a's: the same bucket, the same
                # decisions, so the same numbers
                assert summary["by_status"] == beside["9a"]["by_status"], (
                    label, summary["by_status"], beside["9a"]["by_status"])
                limit = lambda b: 0.0  # noqa: E731
            else:
                # buckets of 6 against one of 12: 9c's limit on a slot's
                # summed -loss (pc.slot_faults), over a phase's steps
                limit = lambda b: (pc.RTOL * abs(b) + pc.ATOL) * SEARCH_STEPS  # noqa: E731
            over = []
            for t, ph, a, b in pairs:
                d = (a - b) * SEARCH_STEPS
                if a != b or label != "11a":      # 11a: each difference; 11b: every pair
                    log(f"[popworker] {label} trial {t} phase {ph}: {a!r} against 9a's "
                        f"{b!r}: summed -loss {d!r} apart (limit {limit(b)!r})")
                if abs(d) > limit(b):
                    over.append((t, ph, a, b))
            lines = population_workers(stdout, label, nodes, expect)
            steps = sum(c["engine_steps"] for c in lines.values())
            updates = sum(c["updates"] for c in lines.values())
            assert updates == SEARCH_STEPS * len(reports), (label, updates, len(reports))
            counts, _ = worker_counts(stdout, label, nodes)
            paths[f"population worker lm {nodes} x {slots}"] = (counts[0], expect, steps,
                                                               *counts[1:])
            wall = summary["wall_time"]
            out[label] = {
                "argv": argv, "processes": nodes, "slots": slots, "wall_s": wall,
                "run_s": run_s, "occupancy": summary["occupancy"], "alpha": summary["alpha"],
                "by_status": summary["by_status"], "trial_steps": updates,
                "bucket_steps": steps, "trial_steps_per_s": updates / wall,
                "tokens_per_s": updates * POP_LM_BATCH * POP_LM_SEQ / wall,
                "phase_busy_s": busy, "compared_with_9a": len(pairs),
                "unequal": sum(a != b for _, _, a, b in pairs),
                "max_abs_diff": max((abs(a - b) for _, _, a, b in pairs), default=0.0),
                "outside_limit": len(over), "launches": counts[0],
                "start_up": start_up(jpath, spawned), "device_busy_share": "not measured",
                "9a_vectorized": near(beside["9a"], ("wall_s", "occupancy", "alpha",
                                                     "trial_steps_per_s", "tokens_per_s")),
                "10a_4_processes": near(beside["10a"], ("wall_s", "occupancy", "alpha",
                                                        "trial_steps_per_s", "tokens_per_s",
                                                        "start_up"))}
            log(f"[popworker] {smi}: {label} " + json.dumps(out[label]))
            assert not over, (label, "metrics outside the limit", over)
            if label in READ_JOURNALS:
                keep_journal(kept, label, jpath, len(table), summary["best_metric"],
                             parks=False)
            phase_done(f"{label} LM search, {nodes} population worker(s) of {slots} slots")

        # 11c: 7a's GA3C search on two population workers of 6 slots, held
        # against 8a's trials
        t0, spawned = time.perf_counter(), time.monotonic()
        proc, out_path, jpath = tune_process(POPW_RL_ARGV, tmp, "11c")
        stdout = finish(proc, "11c")
        run_s = time.perf_counter() - t0
        summary = json.load(open(out_path))
        table, reports, busy = journal_trials(jpath)
        hold_trials("11c", table, RL_PHASES, RL_W0, score=RL_SCORE)
        assert "crashed" not in summary["by_status"] and 0 < summary["alpha"] <= 1, summary
        same_configs("11c", table, table_8a)
        assert len({hp["t_max"] for hp, _, _ in table.values()}) == RL_W0, "11c: t_max repeat"
        pairs = both_trained(table, table_8a)
        unequal = [p for p in pairs if abs(p[2] - p[3]) > RL_NODES_ATOL]
        for t, ph, a, b in unequal:
            log(f"[popworker] 11c trial {t} phase {ph}: {a!r} against 8a's {b!r}")
        lines = population_workers(stdout, "11c", 2)
        counts, (env_steps, updates) = worker_counts(stdout, "11c", 2)
        for c in counts:
            assert not any(c.values()), ("11c: a kernel launched on the GA3C path", counts)
        paths[f"population worker rl {RL_GAME} 2 x 6"] = (
            counts[0], {name: 0 for name in counts[0]}, 0, *counts[1:])
        wall = summary["wall_time"]
        out["11c"] = {
            "argv": POPW_RL_ARGV, "processes": 2, "slots": 6, "wall_s": wall, "run_s": run_s,
            "occupancy": summary["occupancy"], "alpha": summary["alpha"],
            "by_status": summary["by_status"], "trial_phases": len(reports),
            "updates": updates, "env_frames": env_steps, "env_frames_per_s": env_steps / wall,
            "updates_per_s": updates / wall, "phase_busy_s": busy,
            "compared_with_8a": len(pairs), "unequal": len(unequal),
            "atol": RL_NODES_ATOL, "start_up": start_up(jpath, spawned),
            "device_busy_share": "not measured",
            "8a_vectorized": near(beside["8a"], ("wall_s", "occupancy", "alpha",
                                                 "env_frames_per_s", "updates_per_s")),
            "10d_4_processes": near(beside["10d"], ("wall_s", "occupancy", "alpha",
                                                    "env_frames_per_s", "updates_per_s",
                                                    "start_up"))}
        log(f"[popworker] {smi}: 11c " + json.dumps(out["11c"]))
        assert pairs and not unequal, ("11c: metrics differ from 8a's", unequal)
        phase_done("11c GA3C search, 2 population workers of 6 slots")

    # 11d: the reference's pooled bracket, 2 population workers x 2 slots;
    # the workers write their closing lines to this process's stdout, caught
    # in a file for the run
    b = POPW_BRACKET
    space = SearchSpace({"learning_rate": LogUniform(1e-4, 1e-3), "t_max": Categorical((4,)),
                         "gamma": Categorical((0.99,))})
    cluster = ProcessCluster(b["nodes"], b["spec"], lease_ttl=30.0, heartbeat_interval=1.0,
                             slots=b["slots"], bracket_eta=b["eta"])
    t0 = time.perf_counter()
    with tempfile.TemporaryFile(mode="w+") as caught:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(caught.fileno(), 1)
        try:
            res = cluster.run(RandomSearchPolicy(space, b["trials"], b["phases"], seed=0))
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        caught.seek(0)
        stdout = caught.read()
    s = res.summary()
    rungs = s["rungs"]
    by_trial = {r.trial_id: r.metric for r in res.records if r.phase == 0}
    out["11d"] = {"rungs": rungs, "by_status": s["by_status"], "wall_s": res.wall_time,
                  "run_s": time.perf_counter() - t0,
                  "nodes": sorted({r.node for r in res.records}), "phase_0": by_trial,
                  "distinct_phase_0_metrics": len(set(by_trial.values()))}
    log(f"[popworker] {smi}: 11d " + json.dumps(out["11d"]))
    assert s["n_trials"] == b["trials"], s
    assert rungs and rungs[0]["phase"] == 0 and rungs[0]["n"] == 4, rungs
    assert len(rungs[0]["demoted"]) == 4 // b["eta"], rungs
    assert len(by_trial) == 4 and len(set(by_trial.values())) > 1, (
        "11d: every phase-0 metric equal, so the demotion is not held", by_trial)
    assert by_trial[rungs[0]["demoted"][0]] == min(by_trial.values()), (rungs, by_trial)
    # with ties at the bottom the line above holds only a demotion of the top:
    # every trial at the largest metric is also held to be promoted
    best = {t for t, m in by_trial.items() if m == max(by_trial.values())}
    assert best <= set(rungs[0]["promoted"]), (rungs, by_trial)
    assert {r.node for r in res.records} == {0, 1}, res.records
    assert s["by_status"] == {"killed": 1, "completed": 3}, s["by_status"]
    population_workers(stdout, "11d", b["nodes"])
    phase_done("11d pooled bracket, 2 population workers of 2 slots")
    log("[popworker] summary " + json.dumps(out))
    return paths, out


def baselines_phase(dev, smi, zero_counts, all_counts, phase_done, table_6a, out_6a,
                    table_7a, out_7a):
    """Phase 12: SyncCluster's Successive Halving with LM (12a) and GA3C
    (12b) trials, and EvolutionaryHyperTrick with LM trials (12c), on the
    card in this process. ``table_6a`` / ``table_7a``: the trials the runs
    take their configurations from and are held against; ``out_6a`` /
    ``out_7a``: their rows, printed beside. Returns the launch records (for
    the kernels' line) and the phase's numbers."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.completion import expected_alpha
    from repro_torch.core.evolution import EvolutionaryHyperTrick
    from repro_torch.core.executor import SyncCluster, ThreadCluster
    from repro_torch.core.search_space import Categorical, lm_space
    from repro_torch.rl.ga3c import make_rl_objective
    from repro_torch.train.trainer import make_lm_objective

    expect = per_forward(get_config(YI).reduced())
    paths, out = {}, {}
    lm_keys = ("wall_s", "trial_steps_per_s", "tokens_per_s", "occupancy", "alpha",
               "peak_mem_gb")
    rl_keys = ("wall_s", "env_frames_per_s", "updates_per_s", "occupancy", "alpha",
               "peak_mem_gb")

    def lm_objective():
        return make_lm_objective(YI, SEARCH_STEPS, batch=SEARCH_BATCH, seq=SEARCH_SEQ, seed=0,
                                 device=dev)

    def timed(run):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, all_counts()

    def held(label, table, ref, atol):
        """(pairs both trained, those unequal) of ``table`` against the
        earlier search's ``ref``, by trial id; each difference printed."""
        pairs = both_trained(table, ref)
        unequal = [p for p in pairs if abs(p[2] - p[3]) > atol]
        for t, ph, a, b in pairs:
            if a != b:
                log(f"[baselines] {label} trial {t} phase {ph}: {a!r} against {b!r}")
        return pairs, unequal

    def sh_checks(label, res):
        per_phase = [[r for r in res.records if r.phase == p] for p in range(SH_PHASES)]
        assert [len(rs) for rs in per_phase] == SH_PER_PHASE, (
            label, [len(rs) for rs in per_phase])
        assert all(r.node == i % res.n_nodes for rs in per_phase for i, r in enumerate(rs)), (
            label, [(r.trial_id, r.phase, r.node) for r in res.records])
        summary = res.summary()
        assert summary["by_status"] == SH_BY_STATUS, (label, summary["by_status"])
        alpha = res.service.db.completion_rate(SH_PHASES)
        assert alpha == sum(SH_PER_PHASE) / (SH_PHASES * 12), (label, alpha)
        return summary, alpha

    def lm_row(label, res, run_s, n_phases, counts, pairs, unequal):
        steps = SEARCH_STEPS * len(res.records)
        path = hold_lm_counts(label, counts, steps, expect)
        wall = res.wall_time
        summary = res.summary()
        row = {"nodes": res.n_nodes, "phases": n_phases, "steps_per_phase": SEARCH_STEPS,
               "batch": SEARCH_BATCH, "seq": SEARCH_SEQ, "wall_s": wall, "run_s": run_s,
               "trial_phases": len(res.records), "trial_steps": steps,
               "trial_steps_per_s": steps / wall,
               "tokens_per_s": steps * SEARCH_BATCH * SEARCH_SEQ / wall,
               "occupancy": res.occupancy, "alpha": res.service.db.completion_rate(n_phases),
               "expected_alpha": expected_alpha(SEARCH_R, n_phases),
               "by_status": summary["by_status"], "best_metric": summary["best_metric"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "compared_with_6a": len(pairs), "unequal": len(unequal),
               "atol": SEARCH_NODES_ATOL, "launches": counts[0],
               "6a_thread_hypertrick": near(out_6a, lm_keys)}
        return path, row

    # 12a: Successive Halving of 6a's configurations with LM trials
    configs = [table_6a[i][0] for i in sorted(table_6a)]
    res, run_s, counts = timed(lambda: SyncCluster(SEARCH_NODES, lm_objective()).run_sh(
        configs, SH_PHASES, SH_EVICT))
    label = "12a"
    _, alpha = sh_checks(label, res)
    table = trial_table(res)
    hold_trials(label, table, SH_PHASES, SEARCH_W0)
    same_configs(label, table, table_6a)
    pairs, unequal = held(label, table, table_6a, SEARCH_NODES_ATOL)
    path, out[label] = lm_row(label, res, run_s, SH_PHASES, counts, pairs, unequal)
    out[label]["sh_alpha"] = alpha
    paths[f"sync sh {YI} {SEARCH_NODES} nodes"] = path
    log(f"[baselines] {smi}: {label} Successive Halving, {YI} " + json.dumps(out[label]))
    assert pairs and not unequal, (label, "metrics differ from 6a's", unequal)
    phase_done("12a Successive Halving, LM trials, 4 node threads")

    # 12b: Successive Halving of 7a's configurations with GA3C trials
    configs = [table_7a[i][0] for i in sorted(table_7a)]
    objective = make_rl_objective(RL_GAME, RL_EPISODES, n_envs=RL_ENVS, seed=0, device=dev)
    res, run_s, counts = timed(lambda: SyncCluster(RL_NODES, objective).run_sh(
        configs, SH_PHASES, SH_EVICT))
    label = "12b"
    summary, alpha = sh_checks(label, res)
    no_launches(label, lambda: counts)
    table = trial_table(res)
    hold_trials(label, table, SH_PHASES, RL_W0, score=RL_SCORE)
    same_configs(label, table, table_7a)
    pairs, unequal = held(label, table, table_7a, RL_NODES_ATOL)
    env_steps = sum(tr.env_steps for tr in objective.trainers)
    updates = sum(tr.updates for tr in objective.trainers)
    wall = res.wall_time
    out[label] = {"game": RL_GAME, "nodes": res.n_nodes, "phases": SH_PHASES,
                  "episodes_per_phase": RL_EPISODES, "n_envs": RL_ENVS, "wall_s": wall,
                  "run_s": run_s, "trial_phases": len(res.records), "updates": updates,
                  "env_frames": env_steps, "env_frames_per_s": env_steps / wall,
                  "updates_per_s": updates / wall, "occupancy": res.occupancy,
                  "alpha": alpha, "expected_alpha": expected_alpha(RL_R, SH_PHASES),
                  "by_status": summary["by_status"], "best_metric": summary["best_metric"],
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "compared_with_7a": len(pairs), "unequal": len(unequal),
                  "atol": RL_NODES_ATOL, "7a_thread_hypertrick": near(out_7a, rl_keys)}
    paths[f"sync sh rl {RL_GAME} {RL_NODES} nodes"] = (
        counts[0], {name: 0 for name in counts[0]}, 0, *counts[1:])
    log(f"[baselines] {smi}: {label} Successive Halving, GA3C {RL_GAME} "
        + json.dumps(out[label]))
    assert pairs and not unequal, (label, "metrics differ from 7a's", unequal)
    phase_done("12b Successive Halving, GA3C trials, 4 node threads")

    # 12c: evolutionary HyperTrick with LM trials; the policy's _mutate is
    # wrapped here to record each (parent, child) and the trials launched
    # before the child
    label = "12c"
    space = lm_space()
    policy = EvolutionaryHyperTrick(space, SEARCH_W0, EVO_PHASES, SEARCH_R, seed=0)
    assert policy.warmup == EVO_WARMUP, policy.warmup
    mutations = []
    mutate = policy._mutate

    def recording(hp):
        parent = next(t for t in policy.db.trials.values() if t.hparams is hp)
        child = mutate(hp)
        mutations.append({"parent": parent.trial_id, "parent_reports": len(parent.reports),
                          "launched_before": len(policy.db.trials), "parent_hp": dict(hp),
                          "child_hp": child})
        return child

    policy._mutate = recording
    res, run_s, counts = timed(lambda: ThreadCluster(SEARCH_NODES, lm_objective()).run(policy))
    summary = res.summary()
    table = trial_table(res)
    assert summary["n_trials"] == SEARCH_W0, (label, summary)
    assert "crashed" not in summary["by_status"], (label, summary["by_status"])
    hold_trials(label, table, EVO_PHASES, SEARCH_W0)
    warm = {i: table[i] for i in range(EVO_WARMUP)}
    same_configs(label, warm, {i: table_6a[i] for i in range(EVO_WARMUP)})
    pairs, unequal = held(label, warm, table_6a, SEARCH_NODES_ATOL)
    children = []
    for m in mutations:
        # trial ids count the acquires, and the child's is the next one
        child = m["launched_before"]
        assert table[child][0] == m["child_hp"], (label, m, table[child][0])
        assert m["parent_reports"] >= 1 and m["parent"] < child, (
            label, "a parent had not reported before its child", m)
        lo, hi = space.params["learning_rate"].lo, space.params["learning_rate"].hi
        assert any(m["child_hp"]["learning_rate"] == float(np.clip(
            m["parent_hp"]["learning_rate"] * f, lo, hi)) for f in PERTURB_FACTORS), (label, m)
        for k, p in space.params.items():
            v = m["child_hp"][k]
            assert (v in p.values) if isinstance(p, Categorical) else p.lo <= v <= p.hi, (
                label, k, v)
        children.append({"child": child, "parent": m["parent"],
                         "child_phase_0": table[child][2][0],
                         "parent_phase_0": table[m["parent"]][2][0],
                         "child_lr": m["child_hp"]["learning_rate"],
                         "parent_lr": m["parent_hp"]["learning_rate"]})
    path, out[label] = lm_row(label, res, run_s, EVO_PHASES, counts, pairs, unequal)
    out[label]["children"] = children
    paths[f"evolutionary hypertrick {YI} {SEARCH_NODES} nodes"] = path
    log(f"[baselines] {smi}: {label} evolutionary HyperTrick, {YI} " + json.dumps(out[label]))
    for c in children:
        log(f"[baselines] 12c child {c['child']} of {c['parent']}: phase 0 {c['child_phase_0']!r}"
            f" against its parent's {c['parent_phase_0']!r} (lr {c['child_lr']:.3e} from "
            f"{c['parent_lr']:.3e})")
    assert pairs and not unequal, (label, "warmup metrics differ from 6a's", unequal)
    assert children, (label, "no mutated child was launched")
    phase_done("12c evolutionary HyperTrick, LM trials, 4 node threads")
    log("[baselines] summary " + json.dumps(out))
    return paths, out


# phase 13: the paper's simulator, the trace and the load generator, host
# code of the port's search (numpy and sockets: no device, no kernel).
# 13a: the paper's figures at the arguments of the JAX package's benchmark,
# benchmarks/metaopt_benches.py: the toy problem of Figs. 2/3/8/9 (:36-59)
# and Table 3, HyperTrick against Hyperband (:95-123), on pong and boxing,
# whose workload optima are its GAME_PARAMS (:18-26, paper Table 1)
SIM_GAMES = {"pong": dict(lr_opt=6e-4, gamma_opt=0.995, t_opt=8, plateau=21),
             "boxing": dict(lr_opt=3e-4, gamma_opt=0.95, t_opt=12, plateau=100)}
SIM_TOY = dict(configs=16, nodes=6, phases=4, r=0.25, seeds=30, cost_spread=0.6)
SIM_TABLE3 = dict(configs=46, nodes=46, phases=27, seeds=10)
# 13b: the 1000-host acceptance trace of tests/test_telemetry.py:273-306
TRACE_1000 = dict(w0=1000, phases=5, r=0.3, seed=0, hosts=1000, host_seed=7, fail_frac=0.02,
                  fail_horizon=20.0, eta=3, lease_ttl=10.0)
# 13c: run_load's shapes of tests/load/test_server_load.py:29-62 (hosts,
# slots, phases, batched), then run_sim_load's 1000-host tier at its defaults
LOAD_SHAPES = [(200, 1, 2, True), (2, 64, 3, True), (2, 64, 3, False)]
SIM_LOAD = (1000, 2000, 4)

# phase 14: the journal's readers. 14a reads the journals of these phases
# (kept past their phases' temporary directories); 14b tails 10a's journal
# live, TAIL_MAX_BYTES a poll every TAIL_INTERVAL_S
READ_JOURNALS = ("10a", "10c", "11a", "13b")
TAIL_MAX_BYTES, TAIL_INTERVAL_S = 4096, 0.05


class LiveTail:
    """A thread of this process that polls a journal with the port's
    ``JournalTailer`` while a search writes it, and feeds each poll's
    events to a ``SearchView`` stamped with their arrival
    (``time.monotonic()``). A poll found a torn line when the journal ended
    mid-line at the size the tailer measured (and that size lay within the
    poll's budget)."""

    def __init__(self, path):
        import threading

        from repro_torch.telemetry.dashboard import SearchView
        from repro_torch.telemetry.tailer import JournalTailer
        self.tailer = JournalTailer(path, max_bytes=TAIL_MAX_BYTES)
        self.view = SearchView()
        self.events, self.polls, self.torn = [], 0, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _poll(self):
        t, before = self.tailer, self.tailer.offset
        batch = t.poll()
        self.polls += 1
        if t.size - before <= TAIL_MAX_BYTES and t.offset < t.size:
            self.torn += 1
        self.events.extend(batch)
        self.view.apply_all(batch, mono=time.monotonic())
        return batch

    def _run(self):
        while not self._stop.wait(TAIL_INTERVAL_S):
            self._poll()

    def stop(self):
        self._stop.set()
        self._thread.join()

    def drain(self):
        """After ``stop``: poll until the finished journal is read."""
        while self._poll():
            pass


def keep_journal(kept, label, path, trials, best, parks):
    """Copy a phase's journal where phase 14 reads it, beside the trial
    count and best score the phase printed and whether its rungs park
    trials."""
    dest = os.path.join(kept["dir"], f"{label}.jsonl")
    shutil.copyfile(path, dest)
    kept["journals"][label] = {"path": dest, "trials": trials, "best": best, "parks": parks}


def simulator_phase(smi, phase_done, zero_counts, all_counts, kept):
    """Phase 13: the paper's simulator (13a), the 1000-host trace replayed
    through the real service and its journal replayed (13b), and the load
    generator against the port's server and at the 1000-host tier (13c).
    Nothing here runs on the card, so every launch counter must read 0
    after it. 13b's journal goes into ``kept`` (phase 14). Returns the
    phase's numbers."""
    import tempfile
    from repro_torch.core.completion import hyperband_alpha, paper_brackets, solve_r_for_alpha
    from repro_torch.core.hypertrick import HyperTrick, RandomSearchPolicy
    from repro_torch.core.search_space import LogUniform, SearchSpace, Uniform, paper_rl_space
    from repro_torch.core.service import OptimizationService, TrialStatus
    from repro_torch.core.simulator import (GA3CWorkload, ToyWorkload, replay_trace,
                                            simulate_grid, simulate_hyperband,
                                            simulate_hypertrick, simulate_successive_halving,
                                            synthetic_trace)
    from repro_torch.distributed.journal import Journal, replay_journal
    from repro_torch.distributed.loadgen import run_load, run_sim_load
    from repro_torch.distributed.server import MetaoptServer

    zero_counts()
    out = {}
    mean = lambda xs: float(np.mean(xs))

    # -- 13a: the toy problem and Table 3 --------------------------------------
    t0 = time.perf_counter()
    toy = SIM_TOY
    cfgs = [{"id": i} for i in range(toy["configs"])]
    agg = {k: {"makespan": [], "occupancy": [], "alpha": []}
           for k in ("hypertrick", "sh_dynamic", "sh_static", "grid")}
    for seed in range(toy["seeds"]):
        wl = lambda: ToyWorkload(seed, cost_spread=toy["cost_spread"])
        args = (cfgs, toy["nodes"], toy["phases"])
        ht = simulate_hypertrick(wl(), *args, toy["r"], seed=seed)
        assert {e.worker for e in ht.timeline} == set(range(toy["configs"])), seed
        assert len(ht.db.trials) == toy["configs"], seed
        for res in (ht, simulate_successive_halving(wl(), *args, toy["r"], seed=seed),
                    simulate_successive_halving(wl(), *args, toy["r"], seed=seed, static=True),
                    simulate_grid(wl(), *args, seed=seed)):
            assert 0 < res.occupancy <= 1.0 + 1e-9, (res.name, seed, res.occupancy)
            agg[res.name]["makespan"].append(res.makespan)
            agg[res.name]["occupancy"].append(res.occupancy)
            agg[res.name]["alpha"].append(res.completion_rate)
    toy_out = {k: {m: mean(v) for m, v in a.items()} for k, a in agg.items()}
    assert all(a == 1.0 for a in agg["grid"]["alpha"]), agg["grid"]["alpha"]
    assert toy_out["sh_static"]["makespan"] >= toy_out["sh_dynamic"]["makespan"], toy_out
    assert toy_out["grid"]["makespan"] > toy_out["hypertrick"]["makespan"], toy_out
    toy_out["grid_over_hypertrick"] = (toy_out["grid"]["makespan"]
                                       / toy_out["hypertrick"]["makespan"])
    log(f"[sim] {smi}: 13a toy problem ({toy['configs']} configurations, {toy['nodes']} nodes, "
        f"Np {toy['phases']}, r {toy['r']}, seeds 0-{toy['seeds'] - 1}): "
        + json.dumps(toy_out) + " (the paper's grid / HyperTrick: 1.56)")

    brackets = paper_brackets()
    r = solve_r_for_alpha(hyperband_alpha(brackets), SIM_TABLE3["phases"])
    space = paper_rl_space()
    table3 = {}
    for game, params in SIM_GAMES.items():
        acc = {k: {"makespan": [], "occupancy": [], "time_to_best": [], "best": []}
               for k in ("hypertrick", "hyperband")}
        for seed in range(SIM_TABLE3["seeds"]):
            cfgs = space.sample_n(SIM_TABLE3["configs"], seed=seed)
            wl = GA3CWorkload(seed=seed, **params)
            hb = simulate_hyperband(wl, cfgs, brackets, SIM_TABLE3["nodes"], seed=seed)
            ht = simulate_hypertrick(wl, cfgs, SIM_TABLE3["nodes"], SIM_TABLE3["phases"], r,
                                     seed=seed)
            for k, res in (("hypertrick", ht), ("hyperband", hb)):
                assert 0 < res.occupancy <= 1.0 + 1e-9, (game, k, seed, res.occupancy)
                acc[k]["makespan"].append(res.makespan)
                acc[k]["occupancy"].append(res.occupancy)
                acc[k]["time_to_best"].append(res.time_to_best)
                acc[k]["best"].append(res.best_metric)
        table3[game] = {k: {m: mean(v) for m, v in a.items()} for k, a in acc.items()}
        ht_m, hb_m = table3[game]["hypertrick"], table3[game]["hyperband"]
        assert ht_m["makespan"] < hb_m["makespan"], (game, table3[game])
        assert ht_m["occupancy"] > hb_m["occupancy"], (game, table3[game])
        log(f"[sim] {smi}: 13a Table 3 {game} ({SIM_TABLE3['configs']} configurations, "
            f"{SIM_TABLE3['nodes']} nodes, {SIM_TABLE3['phases']} phases at r {r:.4f}, seeds "
            f"0-{SIM_TABLE3['seeds'] - 1}): " + json.dumps(table3[game]))
    out["13a"] = {"toy": toy_out, "table3": table3, "r": r,
                  "host_s": time.perf_counter() - t0}
    no_launches("13a", all_counts)
    phase_done("13a the paper's simulator: the toy problem and Table 3")

    # -- 13b: the 1000-host trace and its journal -------------------------------
    tr = TRACE_1000

    def policy():
        return HyperTrick(SearchSpace({"x": Uniform(0.0, 1.0)}), w0=tr["w0"],
                          n_phases=tr["phases"], eviction_rate=tr["r"], seed=tr["seed"])

    hosts = synthetic_trace(tr["hosts"], seed=tr["host_seed"], fail_frac=tr["fail_frac"],
                            fail_horizon=tr["fail_horizon"])
    with tempfile.TemporaryDirectory(prefix="smoke13b-") as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        t0 = time.perf_counter()
        with Journal(path) as j:
            res = replay_trace(policy(), ToyWorkload(seed=0), hosts, bracket_eta=tr["eta"],
                               lease_ttl=tr["lease_ttl"], seed=tr["seed"], journal=j)
        trace_s = time.perf_counter() - t0
        fresh = OptimizationService(policy(), bracket_eta=tr["eta"])
        t0 = time.perf_counter()
        n_events = replay_journal(path, fresh)
        replay_s = time.perf_counter() - t0
        keep_journal(kept, "13b", path, res.n_trials, res.best_metric, parks=True)
    c, h = res.metrics["counters"], res.metrics["histograms"]
    statuses = collections.Counter(t.status.value for t in res.service.db.trials.values())
    assert res.n_hosts == tr["hosts"] and res.n_trials >= tr["w0"], res.summary()
    assert res.makespan > 0 and 0 < res.occupancy <= 1.0, res.summary()
    assert res.rung_log and res.rung_log[0]["n"] >= 990, res.rung_log[:1]
    assert sum(len(g["demoted"]) for g in res.rung_log) > 0, res.rung_log
    assert c["service.requeues"] == c["server.lease_reaps"] > 0, c
    for verdict in ("park", "demote", "stop"):
        assert c[f"service.verdicts.{verdict}"] > 0, (verdict, c)
    assert c["service.env_steps"] > 0, c
    assert h["service.cohort_wait_s"]["p99"] >= h["service.cohort_wait_s"]["p50"] > 0, h
    assert TrialStatus.RUNNING.value not in statuses, statuses
    assert statuses["completed"] > 0 and statuses["crashed"] > 0, statuses
    # the journal replayed in a fresh service gives the trace's final trials
    want = {t: (rec.status, rec.reports, rec.best_metric)
            for t, rec in res.service.db.trials.items()}
    got = {t: (rec.status, rec.reports, rec.best_metric) for t, rec in fresh.db.trials.items()}
    assert got == want, "13b: the replayed journal's trials differ from the trace's"
    assert fresh.db.summary() == res.service.db.summary()
    out["13b"] = {**res.summary(), "occupancy_exact": res.occupancy,
                  "rung0_n": res.rung_log[0]["n"],
                  "demoted": sum(len(g["demoted"]) for g in res.rung_log),
                  "by_status": dict(sorted(statuses.items())),
                  "verdicts": {k.rsplit(".", 1)[1]: v for k, v in c.items()
                               if k.startswith("service.verdicts.")},
                  "journal_events": n_events, "trace_host_s": trace_s,
                  "journal_replay_host_s": replay_s}
    log(f"[sim] {smi}: 13b 1000-host trace " + json.dumps(out["13b"]))
    no_launches("13b", all_counts)
    phase_done("13b the 1000-host trace, journaled and replayed")

    # -- 13c: the load generator ------------------------------------------------
    rows = []
    for hosts_n, slots, phases, batched in LOAD_SHAPES:
        svc = OptimizationService(RandomSearchPolicy(
            SearchSpace({"x": LogUniform(0.01, 100.0)}), hosts_n * slots, phases, seed=0))
        with MetaoptServer(svc, lease_ttl=60.0) as server:
            stats = run_load(server.host, server.port, hosts=hosts_n, slots=slots,
                             phases=phases, batched=batched)
        row = stats.to_row()
        assert stats.errors == 0, row
        assert stats.reports == hosts_n * slots * phases, row
        assert stats.acquired == hosts_n * slots, row
        assert stats.p99_ms is not None, row
        for tid, rec in svc.db.trials.items():
            assert rec.status is TrialStatus.COMPLETED, (row, tid, rec.status)
            assert [m for m, _ in rec.reports] == [float(p + tid % 7) for p in range(phases)], (
                row, tid, rec.reports)
        rows.append(row)
        log(f"[sim] {smi}: 13c run_load " + json.dumps(row))
    per_trial = next(r for r in rows if not r["batched"])
    batched_64 = next(r for r in rows if r["batched"] and r["slots"] == per_trial["slots"])
    ratio = batched_64["reports_per_s"] / per_trial["reports_per_s"]
    log(f"[sim] {smi}: 13c batched / per-trial reports/s at {per_trial['hosts']} hosts x "
        f"{per_trial['slots']} slots: {ratio:.2f} (printed, not held: a wall-clock ratio)")
    sim = run_sim_load(*SIM_LOAD)
    n_hosts, n_trials, n_phases = SIM_LOAD
    assert sim.reports == n_trials * n_phases and sim.acquired == n_trials, sim.to_row()
    assert sim.errors == 0 and sim.p99_ms is not None, sim.to_row()
    log(f"[sim] {smi}: 13c run_sim_load{SIM_LOAD} " + json.dumps(sim.to_row()))
    out["13c"] = {"run_load": rows, "batched_over_per_trial": ratio, "sim": sim.to_row()}
    no_launches("13c", all_counts)
    phase_done("13c the load generator: sockets and the 1000-host tier")
    log("[sim] summary " + json.dumps(out))
    return out


def readers_phase(smi, phase_done, zero_counts, all_counts, kept, tail):
    """Phase 14: the port's journal readers over the journals this run's
    searches wrote (14a) and 10a's journal as ``tail``, a ``LiveTail``,
    read it live (14b).
    Host code: every launch counter must read 0 after it. Returns the
    phase's numbers."""
    import contextlib
    import io

    from repro_torch.distributed.journal import read_events
    from repro_torch.telemetry import critical_path, dashboard, export
    from repro_torch.telemetry.dashboard import SearchView

    zero_counts()
    t_phase = time.perf_counter()
    out = {}
    # -- 14a: export, attribution and the dashboard over each journal ------------
    log(f"[readers] {smi}: compile is engine.compile spans, the host seconds of a "
        "bucket's first step with no device sync (host start-up, not device work); step "
        "is the trials' trial.phase spans; shares are of the summed trial wall")
    with tempfile.TemporaryDirectory(prefix="smoke14-") as tmp:
        for label in READ_JOURNALS:
            k = kept["journals"][label]
            t0 = time.perf_counter()
            path = k["path"]
            table, _, _ = journal_trials(path)
            n = len(table)
            assert n == k["trials"], (label, "trials in the journal", n, k["trials"])
            trace_path = os.path.join(tmp, f"{label}.json")
            counts = export.export_journal(path, trace_path)
            with open(trace_path, encoding="utf-8") as f:
                assert export.validate_chrome_trace(json.load(f)) == counts, label
            assert counts["trial_tracks"] == n, (label, counts, n)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                codes = [export.main(["--journal", path, "--out", trace_path,
                                      "--require-trials", str(need)]) for need in (n, n + 1)]
            assert codes == [0, 1], (label, codes, printed.getvalue())
            events = list(read_events(path))
            per_trial = critical_path.attribute(events)
            assert set(table) <= set(per_trial), (label, set(table) - set(per_trial))
            walls = {t: r for t, r in per_trial.items() if r["wall"] > 0}
            assert walls, label
            off = [(t, r) for t, r in walls.items()
                   if abs(sum(r[b] for b in critical_path.BUCKETS) - r["wall"]) > 0.01 * r["wall"]]
            assert not off, (label, "buckets off the wall by more than 1 %", off[:3])
            parked = sum(r["park_wait"] > 0 for r in walls.values())
            assert parked or not k["parks"], (label, "no trial waited at a rung")
            per_bracket = critical_path.aggregate(walls)
            table_txt = critical_path.format_table(per_bracket)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                assert dashboard.main(["--journal", path, "--once"]) == 0
            panel = printed.getvalue()
            assert f"trials: {n} acquired" in panel, (label, panel)
            assert f"best score: {k['best']:.6g} (" in panel, (label, k["best"], panel)
            assert table_txt and table_txt in panel, (label, panel)
            wall = sum(r["wall"] for r in walls.values())
            out[label] = {
                "events": len(events), "trials": n, "trials_with_wall": len(walls),
                "export": counts, "wall_sum_s": wall,
                "shares": {b: sum(r[b] for r in walls.values()) / wall
                           for b in critical_path.BUCKETS},
                "by_bracket": {b: {**agg, "shares": {
                    k_: agg[k_] / agg["wall"] for k_ in critical_path.BUCKETS}}
                    for b, agg in per_bracket.items()},
                "trials_parked": parked, "host_s": time.perf_counter() - t0}
            log(f"[readers] {smi}: 14a {label} " + json.dumps(out[label]))
            log(f"[readers] 14a {label}, from dashboard --once:\n{table_txt}")
    no_launches("14a", all_counts)
    phase_done("14a the readers over 10a's, 10c's, 11a's and 13b's journals")

    # -- 14b: 10a's journal, tailed while its search ran ------------------------
    events = list(read_events(kept["journals"]["10a"]["path"]))
    assert tail.events == events, ("14b: tailed events differ from the journal's",
                                   len(tail.events), len(events))
    assert tail.tailer.skipped == 0, tail.tailer.skipped
    post = SearchView()
    post.apply_all(events)
    for key in ("trials", "best", "reaps"):
        assert getattr(tail.view, key) == getattr(post, key), ("14b", key)
    assert list(tail.view.cohort_waits) == list(post.cohort_waits), "14b: cohort waits"
    out["14b"] = {"events": len(events), "polls": tail.polls, "torn_polls": tail.torn,
                  "skipped": tail.tailer.skipped, "trials": len(post.trials),
                  "best": post.best, "reaps": post.reaps,
                  "cohort_waits": len(post.cohort_waits),
                  "max_bytes": TAIL_MAX_BYTES, "interval_s": TAIL_INTERVAL_S}
    log(f"[readers] {smi}: 14b " + json.dumps(out["14b"]))
    no_launches("14b", all_counts)
    phase_done("14b 10a's journal tailed live")
    log(f"[phase] 14 the journal's readers, in all: {time.perf_counter() - t_phase:.1f} s")
    log("[readers] summary " + json.dumps(out))
    return out


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
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_slots
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_slots_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import WARP_WIDTHS as RMS_WARP_WIDTHS
    from repro_torch.kernels.rmsnorm.rmsnorm import kernel_for as rms_kernel_for
    from repro_torch.kernels.rmsnorm.rmsnorm import launch as rms_launch
    from repro_torch.kernels.rmsnorm.rmsnorm import row_stride
    from repro_torch.kernels.selective_scan.ops import selective_scan, selective_scan_slots
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref, selective_scan_slots_ref
    from repro_torch.kernels.selective_scan.selective_scan import kernel_for as scan_kernel_for
    from repro_torch.kernels.selective_scan.selective_scan import launch as scan_launch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import encode, init_cache
    from repro_torch.models.schema import count_params, init_params
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    kernel_ops = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                  "selective_scan": selective_scan, "gmm": gmm}
    clock = {"t": time.perf_counter(), "start": time.perf_counter()}

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
        rmsnorm.launches_warp = rmsnorm.launches_block = rmsnorm.launches_slots = 0
        selective_scan.launches_prefill = selective_scan.launches_sequential = 0
        selective_scan.launches_slots = 0

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
    rms_err_by_kernel = {"warp": 0.0, "block": 0.0, "slots": 0.0}

    def rms_counts():
        return {"warp": rmsnorm.launches_warp, "block": rmsnorm.launches_block,
                "slots": rmsnorm.launches_slots}

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

    def flash_large_out_case(zname, window, Sq=PROMPT, Skv=PROMPT, causal=True, q_scale=1.0):
        """``zname``'s heads at Sq x Skv (batch 4; the prefill of 512 by
        default) where |out| reaches 4: q, k ~ N(0, 1) (q times
        ``q_scale``), v ~ N(0, 2^2) clipped to |v| <= 7.9, so rows that see
        few keys give outputs in [4, 8) and none reaches 8; not causal, no
        row sees few keys, and ``q_scale`` sharpens the scores so that a few
        keys carry each row. The kernel's bf16 output is held to the plain
        version run on f32 copies of the same bf16 inputs (an f32 p times an
        f32 v, the reference's arithmetic): its own rounding costs up to
        half an ulp there, 1.5625e-2, within 2e-2, and the bulk is held to
        4e-3 (``FLASH_LARGE_OUT_BULK``). Its distance from the bf16 plain
        output is printed as a record only: two bf16 results may sit one ulp
        (3.1e-2) apart there when both are right."""
        zc = get_config(zname)
        B, Hq, Hkv, hd, cap = BATCH, zc.n_heads, zc.n_kv_heads, zc.head_dim, zc.attn_softcap
        q = (td(B, Sq, Hq, hd) * q_scale).to(torch.bfloat16)
        k = td(B, Skv, Hkv, hd, dtype=torch.bfloat16)
        v = td(B, Skv, Hkv, hd, scale=2.0).clamp_(-7.9, 7.9).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, softcap=cap)
        kind, before = kernel_for(q.dtype, Sq, Hq, Hkv), flash_counts()
        assert kind == ("split_kv" if Sq == 1 else "tensor_core"), (zname, kind)
        out = flash_attention(q, k, v, **kw)
        moved = {n: c - before[n] for n, c in flash_counts().items()}
        assert moved == {n: int(n == kind) for n in moved}, (zname, moved)
        ref = chunked_attention(q.float(), k.float(), v.float(), **kw)
        mag = ref.abs()
        band = (mag >= 4) & (mag < 8)
        n4 = int(band.sum().item())
        assert n4 >= 100 and mag.max().item() < 8, (zname, n4, mag.max().item())
        label = (f"{zname} B{B} {Sq}x{Skv} Hq{Hq} Hkv{Hkv} hd{hd} w{window} cap{cap}"
                 + ("" if causal else " not causal")
                 + (f", q x {q_scale:g}" if q_scale != 1 else "")
                 + ", v ~ N(0, 2^2) clipped to 7.9")
        e = check("flash_attention", f"[{kind}] {label}, against f32", out, ref, 2e-2,
                  bulk=FLASH_LARGE_OUT_BULK)
        flash_by_magnitude(out, ref)
        e4 = (out.float() - ref)[band].abs().max().item()
        d_bf = (out.float() - chunked_attention(q, k, v, **kw).float()).abs().max().item()
        log(f"[kernel] flash_attention [{kind}] {label}: {n4} outputs in [4, 8), max error "
            f"there {e4:.3e} (half an ulp 1.5625e-2, limit 2e-2); {d_bf:.3e} from the bf16 "
            "plain output (a record)")
        flash_large_out[label] = {"shape": label, "n_in_4_8": n4, "max_abs_err_in_4_8": e4,
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
    # phi3's and kimi's prefill (whisper's below)
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
    # whisper-large-v3's calls (MHA, 20 heads at hd 64, no softcap), none
    # causal but the decoder's own: the encoder's self attention over 1,500
    # frames and cross attention at prefill on the tensor-core kernel (1500 =
    # 23 x 64 + 28: a tile of q rows and of keys partly past the end), 100
    # query rows (a warp's 16 rows partly past Sq); cross attention's decode
    # step with no kv_pos on split-KV (24 tiles in 4 splits); the decoder's
    # ring of 448 slots at a decode step; the FMA kernel not causal at the
    # reduced config's heads (4 over 2), as the card-against-CPU check of 3h
    # runs it
    wc = get_config(WHISPER)
    WH, whd, wS = wc.n_heads, wc.head_dim, wc.enc_seq
    for Sq in (wS, WHISPER_PROMPT, 100):
        flash_case(f"whisper not causal B{BATCH} Hq{WH} Hkv{WH} hd{whd} {Sq}x{wS} bf16", BATCH,
                   WH, WH, Sq, wS, whd, False, 0, 0.0, bf16, 0, want="tensor_core")
    flash_case(f"whisper cross decode not causal, no kv_pos, B{BATCH} Hq{WH} Sq1 Skv{wS} bf16",
               BATCH, WH, WH, 1, wS, whd, False, 0, 0.0, bf16, 0, want="split_kv")
    w_pos = WHISPER_PROMPT + NEW // 2 - 1
    flash_case(f"whisper self decode ring L{WHISPER_MAX_SEQ} {w_pos + 1} written B{BATCH} "
               f"Hq{WH} bf16", BATCH, WH, WH, 1, WHISPER_MAX_SEQ, whd, True, 0, 0.0, bf16, w_pos,
               ring_pos(WHISPER_MAX_SEQ, w_pos, w_pos + 1), want="split_kv")
    wr = wc.reduced()
    flash_case(f"whisper reduced not causal B2 Hq{wr.n_heads} Hkv{wr.n_kv_heads} hd{wr.head_dim} "
               f"{wS}x{wS} f32", 2, wr.n_heads, wr.n_kv_heads, wS, wS, wr.head_dim, False, 0,
               0.0, torch.float32, 0, want="fma")
    # whisper's outputs reach 4 too (3h's probe): the decoder's causal
    # prefill of 224, and cross attention onto 1,500 frames at prefill
    # (tensor-core) and at a decode step (split-KV), scores sharpened
    flash_large_out_case(WHISPER, 0, WHISPER_PROMPT, WHISPER_PROMPT)
    for Sq in (WHISPER_PROMPT, 1):
        flash_large_out_case(WHISPER, 0, Sq, wS, causal=False, q_scale=30.0)

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
                "sequential": selective_scan.launches_sequential,
                "slots": selective_scan.launches_slots}

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
    # the population engine's buckets (phase 9): RMSNorm's slot case, one
    # scale row a slot, on the block kernel; flash over the slots' sequences
    # as one batch (the FMA kernel, the same function)

    def rms_slots_case(label, x, sc):
        tol = 5e-2 if x.dtype == torch.bfloat16 else 1e-5
        before = rms_counts()
        out = rmsnorm_slots(x, sc)
        moved = {n: c - before[n] for n, c in rms_counts().items()}
        assert moved == {"warp": 0, "block": 1, "slots": 1}, (label, moved)
        e = check("rmsnorm", f"[block, a scale a slot] {label}", out, rmsnorm_slots_ref(x, sc),
                  tol)
        rms_err_by_kernel["slots"] = max(rms_err_by_kernel["slots"], e)

    width = trial_cfg.d_model
    for rows, dt in ((POP_LM_BATCH * POP_LM_SEQ, torch.float32),
                     (SEARCH_BATCH * SEARCH_SEQ, torch.float32),
                     (SEARCH_BATCH * SEARCH_SEQ, torch.bfloat16)):
        rms_slots_case(f"({POP_SLOTS}, {rows}, {width}) {dt}",
                       t(POP_SLOTS, rows, width, dtype=dt), (t(POP_SLOTS, width) + 1.0).to(dt))
    flash_case(f"the LM bucket's {POP_SLOTS} slots x B{POP_LM_BATCH} S{POP_LM_SEQ}",
               POP_SLOTS * POP_LM_BATCH,
               trial_cfg.n_heads, trial_cfg.n_kv_heads, POP_LM_SEQ, POP_LM_SEQ,
               trial_cfg.head_dim, True, 0, 0.0, torch.float32, 0, want="fma")
    # the mamba and MoE buckets (phase 9e): the scan's slot case, each
    # slot's own A and D, at both kernels, and the grouped matmul over the
    # slots' (slot, expert) groups
    jrc, grc = get_config(HYBRID).reduced(), get_config(GROK).reduced()

    def scan_slots_inputs(S, B, T, di, st, dt):
        """The JAX test's distributions, an A and a D a slot; b and c
        sliced out of one x_proj output, as the mamba block slices them."""
        a = -td(S, di, st).abs() - 0.05
        dtv = (td(S * B, T, di).abs() * 0.1 + 0.01).to(dt)
        bcd = td(S * B, T, jrc.dt_rank + 2 * st, dtype=dt)
        b, c = bcd[..., jrc.dt_rank:jrc.dt_rank + st], bcd[..., jrc.dt_rank + st:]
        return (td(S * B, T, di, dtype=dt), dtv, a, b, c, (td(S, di) + 1.0).to(dt),
                td(S * B, di, st, scale=0.2))

    def scan_slots_case(label, S, B, T, di, st, dt):
        """The slot case through the dispatch, which must move the counter
        of ``kernel_for``'s kernel and the slot counter alone; the other
        kernel's slot case held beside, past the dispatch. Yardsticks as
        ``scan_case``'s: the f64 plain version for the prefill kernel, the
        f32 one for the sequential kernel."""
        args = scan_slots_inputs(S, B, T, di, st, dt)
        kind, before = scan_kernel_for(args[0]), scan_counts()
        y, hT = selective_scan_slots(*args)
        moved = {n: c - before[n] for n, c in scan_counts().items()}
        assert moved == {n: int(n in (kind, "slots")) for n in moved}, (label, kind, moved)
        yardstick = {"sequential": selective_scan_slots_ref(*args),
                     "prefill": selective_scan_slots_ref(*(x.double() for x in args))}
        other = "sequential" if kind == "prefill" else "prefill"
        yo, ho = torch.full_like(y, math.nan), torch.full_like(hT, math.nan)
        scan_launch(other, *args, yo, ho, rows_per_a=B)
        for name, yk, hk in ((kind, y, hT), (other, yo, ho)):
            k = (name if name == kind else f"{name}, past the dispatch") + ", a slot's A and D"
            ry, rh = yardstick[name]
            e = max(check("selective_scan", f"[{k}] {label} {dt} y", yk, ry, *scan_tol[dt]),
                    check("selective_scan", f"[{k}] {label} {dt} hT", hk, rh,
                          *scan_tol[torch.float32]))
            scan_err_by_kernel[name] = max(scan_err_by_kernel[name], e)
            scan_err_by_kernel["slots"] = max(scan_err_by_kernel["slots"], e)

    scan_err_by_kernel["slots"] = 0.0
    jdi, jst = jrc.ssm_d_inner, jrc.ssm_d_state
    for T in (16, POP_LM_SEQ, 64):      # the sequential kernel, then the prefill kernel
        scan_slots_case(f"the mamba bucket's {POP_SLOTS} slots x B{POP_LM_BATCH} T{T} di{jdi} "
                        f"st{jst}", POP_SLOTS, POP_LM_BATCH, T, jdi, jst, torch.float32)
    # bf16 and a width whose D rows are not 16-byte apart (each kernel
    # copies a slot's A, h0 and D element by element there)
    for T in (16, 64):
        scan_slots_case(f"3 slots x B2 T{T} di130 st{jst}", 3, 2, T, 130, jst, torch.bfloat16)
    gsizes = slot_routed_sizes(POP_SLOTS, POP_LM_BATCH * POP_LM_SEQ, grc.n_experts, grc.top_k,
                               seed=3)
    gmm_case(f"the MoE bucket's {POP_SLOTS} slots x {grc.n_experts} experts, "
             f"{len(gsizes)} groups, T{sum(gsizes)} {grc.d_model}->{grc.expert_d_ff}", gsizes,
             grc.d_model, grc.expert_d_ff, torch.float32, grc.d_model ** -0.5, want="small")

    phase_done("2 kernels vs plain")

    # -- 3. serve ------------------------------------------------------------
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

    def counted(run):
        """``run()`` from launch counters set to 0, the card synchronised on
        both sides: its result, its wall s, the launches by op and the
        flash, gmm, RMSNorm and scan launches by kernel."""
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0,
                {name: op.launches for name, op in kernel_ops.items()}, flash_counts(),
                gmm_counts(), rms_counts(), scan_counts())

    def steady_steps(cfg, params, batch, prompt, max_seq, label="prefill"):
        """A prefill step of ``batch`` (BATCH rows of ``prompt`` tokens) into
        a fresh cache of ``max_seq`` and the decode steps after it, at steady
        state: the ms of each (CUDA events), then its device busy ms under
        the profiler (from position ``prompt`` again), then one decode step
        under ``set_sync_debug_mode("error")``, where any host sync (a
        ``.item()``, a boolean index, a bincount, ...) raises."""
        prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)
        cache = init_cache(cfg, BATCH, max_seq, device=dev)
        prefill_ms = cuda_ms(lambda: prefill(params, batch, cache), iters=5, warmup=1)
        tok = batch["tokens"][:, -1:]
        step = [prompt]

        def one_decode():
            decode(params, cache, tok, step[0])
            step[0] += 1

        decode_ms = cuda_ms(one_decode, iters=NEW, warmup=2)
        step[0] = prompt
        times = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
                 "prefill_busy_ms": profiled(f"{cfg.name} {label}",
                                             lambda: prefill(params, batch, cache)),
                 "decode_busy_ms": profiled(f"{cfg.name} decode step", one_decode)}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            one_decode()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[sync] {cfg.name}: one decode step ran with no host sync "
            "(set_sync_debug_mode('error'))")
        return times

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
        (done, first_s, launches, by_kernel, gmm_by_kernel, rms_by_kernel,
         scan_by_kernel) = counted(engine.run_batch)
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
                                 for k in ("warp", "block", "slots")}, rms_by_kernel
        log(f"[serve] rmsnorm per forward: {n_rms} {rms_served} calls (d_model "
            f"{cfg.d_model}; norm {cfg.norm}: LayerNorm is plain PyTorch)")
        # the scan: the prefill kernel at prefill, the sequential one at decode
        n_scan = expect["selective_scan"]
        assert scan_by_kernel == {"prefill": n_scan * steps["prefill"],
                                  "sequential": n_scan * steps["decode"], "slots": 0}, (
            scan_by_kernel, steps)
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
        _, serve_s, *_ = counted(engine.run_batch)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(BATCH, PROMPT))).to(dev)
        serve = {"arch": cfg.name, "n_layers": cfg.n_layers,
                 **steady_steps(cfg, params, {"tokens": tokens}, PROMPT, MAX_SEQ),
                 "tokens_per_s": N_REQ * NEW / serve_s, "serve_s": serve_s,
                 "first_run_s": first_s, "batch": BATCH, "prompt_len": PROMPT,
                 "max_new": NEW, "requests": N_REQ,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log("[serve] " + json.dumps(serve))
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

    def probe(cfg, params, enc_embeds=None, prompt=PROMPT, max_seq=MAX_SEQ):
        """One prefill of the first batch of prompts and the decode step after
        it, run after the counted serve: the largest |attention output| of
        each (the flash kernels' outputs, as each attention layer multiplies
        them by its ``wo``, each cross attention by its ``c_wo``; from |ref|
        >= 4 one bf16 ulp, 3.1e-2, exceeds phase 2's 2e-2 limit, and
        ``flash_large_out_case`` holds the kernel there against the f32 plain
        version) and, for a model with MoE layers, the group sizes each
        routes (its router's top-k experts, counted as ``moe_local`` counts
        them), the traffic phase 4 times gmm at, and how many experts get no
        row. With ``enc_embeds`` (an encoder-decoder) the prefill runs the
        encoder, and the largest output of each kind of attention (encoder,
        self, cross) is printed too. A ``TorchFunctionMode`` sees both calls;
        no module is patched."""
        from torch.overrides import TorchFunctionMode
        kinds = {}      # the storage of each output projection: the attention it ends
        for n, t in params.named_parameters():
            if n.endswith((".wo", ".c_wo")):
                kinds[t.untyped_storage().data_ptr()] = (
                    "cross" if n.endswith(".c_wo") else "encoder" if n.startswith("enc.")
                    else "self")
        routed, amax = [], []

        class Watch(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if (func is torch.Tensor.matmul      # ``a @ b`` reaches the mode so
                        and args[1].untyped_storage().data_ptr() in kinds):
                    amax.append((kinds[args[1].untyped_storage().data_ptr()],
                                 args[0].abs().amax()))
                elif func is torch.topk:
                    routed.append(torch.bincount(out.indices.reshape(-1),
                                                 minlength=cfg.n_experts))
                return out

        prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)
        r = np.random.default_rng(0)
        tokens = torch.from_numpy(np.stack([r.integers(0, cfg.vocab_size, size=prompt)
                                            for _ in range(BATCH)])).to(dev)
        batch = {"tokens": tokens}
        if enc_embeds is not None:
            batch["enc_embeds"] = enc_embeds
        cache = init_cache(cfg, BATCH, max_seq, device=dev)
        with Watch():
            logits, cache = prefill(params, batch, cache)
            n_moe, n_attn = len(routed), len(amax)
            decode(params, cache, logits.argmax(-1)[:, None], prompt)
        want = per_forward(cfg, encoder=enc_embeds is not None)["flash_attention"]
        assert n_attn == want, (n_attn, want)
        assert len(amax) - n_attn == per_forward(cfg)["flash_attention"], (len(amax), n_attn)
        assert 3 * n_moe == per_forward(cfg)["gmm"], (n_moe, per_forward(cfg))
        attn = {"prefill": max(a.item() for _, a in amax[:n_attn]),
                "decode": max(a.item() for _, a in amax[n_attn:])}
        over = max(attn.values()) >= 4.0
        log(f"[attn] {cfg.name}: largest |attention output| {json.dumps(attn)}"
            + (": reaches 4, where phase 2 holds the kernel to the f32 plain version"
               if over else ": below 4"))
        found = {"attn_abs_max": attn}
        if cfg.is_encdec:
            by_kind = {}
            for i, (kind, a) in enumerate(amax):
                key = f"{'prefill' if i < n_attn else 'decode'} {kind}"
                by_kind[key] = max(by_kind.get(key, 0.0), a.item())
            found["attn_abs_max_by_kind"] = by_kind
            log(f"[attn] {cfg.name}: largest |attention output| by kind {json.dumps(by_kind)}")
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
    phase_done("3g serve kimi-1")

    # -- 3h. serve whisper-large-v3 whole, the encoder over 1,500 frames -------
    def serve_whisper(cfg):
        """Serve whisper-large-v3 whole from seed-0 weights drawn on the card:
        N_REQ prompts of WHISPER_PROMPT tokens in groups of BATCH, each group
        its encoder frames (BATCH, enc_seq, d_model) bf16 drawn from seed 0,
        one prefill step of {"tokens", "enc_embeds"} and NEW decode steps,
        greedy; launches held exactly. Then timings, profiles and the sync
        check; the serve CLI as the reference's engine runs it (no encoder
        input), its tokens against the same steps with zero ck / cv; the
        reduced config at enc_seq 1,500 in f32 on the card against the CPU.
        Returns the path's record (as ``serve_model``'s), the CLI's and the
        probe's findings."""
        params = init_on_card(cfg, f"; {cfg.n_enc_layers} encoder layers over "
                                   f"{cfg.enc_seq} frames; nothing cut")
        P, L = WHISPER_PROMPT, WHISPER_MAX_SEQ
        prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)
        r = np.random.default_rng(0)
        prompts = np.stack([r.integers(0, cfg.vocab_size, size=P) for _ in range(N_REQ)])
        wgen = torch.Generator(device=dev).manual_seed(0)
        groups = [(torch.from_numpy(prompts[i:i + BATCH]).to(dev),
                   torch.randn((BATCH, cfg.enc_seq, cfg.d_model), generator=wgen,
                               device=dev).to(torch.bfloat16))
                  for i in range(0, N_REQ, BATCH)]

        def greedy(tokens, frames):
            """One prefill (the encoder's too where ``frames`` is given) and
            NEW decode steps on a fresh cache, as the engine's ``_generate``:
            the tokens (BATCH, NEW) on the card, and whether every logit of
            the steps was finite (a tensor: no host sync)."""
            cache = init_cache(cfg, BATCH, L, device=dev)
            batch = {"tokens": tokens} if frames is None else {"tokens": tokens,
                                                               "enc_embeds": frames}
            logits, cache = prefill(params, batch, cache)
            finite = torch.isfinite(logits).all()
            tok, out = logits.argmax(-1, keepdim=True), []
            for i in range(NEW):
                out.append(tok)
                logits, cache = decode(params, cache, tok, P + i)
                finite = finite & torch.isfinite(logits).all()
                tok = logits.argmax(-1, keepdim=True)
            return torch.cat(out, 1), finite

        n_groups = N_REQ // BATCH
        with_enc, zero_ck = per_forward(cfg, encoder=True), per_forward(cfg)
        runs, first_s, launches, by_kernel, gmm_by, rms_by, scan_by = counted(
            lambda: [greedy(tk, fr) for tk, fr in groups])
        tokens = [row for out, _ in runs for row in out.tolist()]
        log(f"[whisper] {N_REQ} requests, {n_groups * (1 + NEW)} forwards, launches {launches}, "
            f"flash by kernel {by_kernel}")
        assert all(bool(f) for _, f in runs), "non-finite logits"
        assert all(len(t) == NEW and all(0 <= x < cfg.vocab_size for x in t) for t in tokens)
        # a prefill: 32 encoder, 32 self and 32 cross calls on the tensor-core
        # kernel; a decode step: 32 self and 32 cross calls on split-KV
        n_pre, n_dec = with_enc["flash_attention"], zero_ck["flash_attention"]
        assert (n_pre, n_dec) == (cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers)
        assert by_kernel == {"split_kv": n_groups * NEW * n_dec, "tensor_core": n_groups * n_pre,
                             "fma": 0}, by_kernel
        assert launches == {"rmsnorm": 0, "flash_attention": n_groups * (n_pre + NEW * n_dec),
                            "selective_scan": 0, "gmm": 0}, launches
        log(f"[whisper] flash per forward: {n_pre} tensor-core calls a prefill ("
            f"{cfg.n_enc_layers} encoder, {cfg.n_layers} self, {cfg.n_layers} cross), {n_dec} "
            f"split-KV calls a decode step; 0 RMSNorm (LayerNorm is plain PyTorch)")
        log(f"[whisper] tokens of the greedy run: {json.dumps(tokens)}")
        hd64 = {k: flash_res[k] for k in ("flash_prefill_kernel<64>", "flash_split_kernel<64>")}
        log(f"[whisper] the hd-64 flash kernels (phase 1): {json.dumps(hd64)}")

        # steady state: a second, uncounted run of the same requests
        _, serve_s, *_ = counted(lambda: [greedy(tk, fr) for tk, fr in groups])
        tk0, fr0 = groups[0]
        out = {"arch": cfg.name, "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
               "enc_seq": cfg.enc_seq, "params": count_params(cfg),
               **steady_steps(cfg, params, {"tokens": tk0, "enc_embeds": fr0}, P, L,
                              "prefill with the encoder")}
        with torch.inference_mode():
            out["encoder_ms"] = cuda_ms(lambda: encode(cfg, params, fr0), iters=5, warmup=1)
            out["encoder_busy_ms"] = profiled(f"{cfg.name} encoder",
                                              lambda: encode(cfg, params, fr0))
        out.update(decoder_prefill_ms=out["prefill_ms"] - out["encoder_ms"],
                   tokens_per_s=N_REQ * NEW / serve_s, serve_s=serve_s, first_run_s=first_s,
                   batch=BATCH, prompt_len=P, max_seq=L, max_new=NEW, requests=N_REQ,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        log("[whisper] " + json.dumps(out))
        found = probe(cfg, params, enc_embeds=fr0, prompt=P, max_seq=L)
        record = (launches, with_enc, n_groups * (1 + NEW), by_kernel, gmm_by, rms_by, scan_by,
                  out)

        # the serve CLI, as the reference's engine serves whisper: prompts
        # only, so no encoder runs and cross attention reads the cache's zeros
        argv = ["--arch", cfg.name, "--requests", str(N_REQ), "--batch", str(BATCH),
                "--prompt-len", str(P), "--max-new", str(NEW), "--max-seq", str(L)]
        done, cli_s, cli_launches, cli_by, cli_gmm, cli_rms, cli_scan = counted(
            lambda: serve_cli.main(argv))
        cli_tokens = [req.output for req in sorted(done, key=lambda req: req.request_id)]
        assert cli_by == {"split_kv": n_groups * NEW * n_dec, "tensor_core": n_groups * n_dec,
                          "fma": 0}, cli_by
        zero_tokens = [row for tk, _ in groups for row in greedy(tk, None)[0].tolist()]
        same = "equal" if cli_tokens == zero_tokens else "DIFFER from"
        log(f"[whisper] serve CLI ({' '.join(argv)}): {cli_s:.2f} s with its weights' draw, "
            f"launches {cli_launches}, flash by kernel {cli_by} ({n_dec} tensor-core calls a "
            f"prefill: no encoder); its tokens {same} the steps' with zero ck / cv; "
            f"{sum(a != b for a, b in zip(cli_tokens, tokens))} of {N_REQ} requests differ "
            "from the run with the encoder")
        assert cli_tokens == zero_tokens, (cli_tokens, zero_tokens)
        cli_record = (cli_launches, zero_ck, n_groups * (1 + NEW), cli_by, cli_gmm, cli_rms,
                      cli_scan, {"arch": cfg.name, "serve_cli_s": cli_s, "tokens": cli_tokens})
        del params, groups
        gc.collect()
        torch.cuda.empty_cache()

        def card_against_cpu(label, c, batch, prompt, max_seq, steps, seed):
            """``c`` in f32 on the card (the FMA flash kernel) against the CPU
            from one CPU draw of the weights, frames and prompts: a prefill
            of {"tokens", "enc_embeds"} and ``steps`` greedy decode steps.
            Logits within 1e-4 and the greedy tokens equal, or the run
            fails. Returns the largest |card - cpu| of the logits."""
            cparams = init_params(c, torch.Generator().manual_seed(0), device="cpu")
            rs = np.random.default_rng(seed)
            ctk = torch.from_numpy(rs.integers(0, c.vocab_size, size=(batch, prompt)))
            cfr = torch.from_numpy(rs.standard_normal((batch, c.enc_seq, c.d_model))
                                   .astype(np.float32))
            got = {}
            for d in ("cpu", "cuda"):
                p_d = cparams.to(d)
                cache = init_cache(c, batch, max_seq, device=d)
                lg, cache = make_prefill_step(c)(p_d, {"tokens": ctk.to(d),
                                                       "enc_embeds": cfr.to(d)}, cache)
                logits_d, toks = [lg.cpu()], []
                for i in range(steps):
                    tok_d = lg.argmax(-1, keepdim=True)
                    toks.append(tok_d.cpu())
                    lg, cache = make_serve_step(c)(p_d, cache, tok_d, prompt + i)
                    logits_d.append(lg.cpu())
                got[d] = (logits_d, torch.cat(toks, 1))
                del p_d, cache
            diff = max((a - b).abs().max().item() for a, b in zip(got["cpu"][0], got["cuda"][0]))
            same = torch.equal(got["cpu"][1], got["cuda"][1])
            log(f"[whisper] {label}, f32, card against CPU: prefill and {steps} decode steps' "
                f"logits within {diff:.3e} (limit 1e-4; largest |logit| "
                f"{max(x.abs().max().item() for x in got['cpu'][0]):.3f}), greedy tokens "
                f"{'equal' if same else 'DIFFER'}: {got['cuda'][1].tolist()}")
            assert diff <= 1e-4 and same, (label, diff, got["cpu"][1].tolist(),
                                           got["cuda"][1].tolist())
            return diff

        # the reduced config at the encoder's 1,500 frames: the FMA flash
        # kernel at encoder 1500 x 1500, cross 12 x 1500 and 1 x 1500
        rc = dataclasses.replace(cfg.reduced(), enc_seq=cfg.enc_seq)
        out["reduced_card_vs_cpu_max_abs_diff"] = card_against_cpu(
            f"reduced at enc_seq {rc.enc_seq}", rc, 2, 12, 32, 6, 1)
        # every width as published (d_model 1280, 20 heads at hd 64, d_ff
        # 5120, the 51,866-token vocabulary, 1,500 frames), the depth cut to
        # WHISPER_FULL_LAYERS encoder and decoder layers so that the CPU
        # side takes seconds; a prompt of 224 into the cache of 448
        fc = dataclasses.replace(cfg, n_layers=WHISPER_FULL_LAYERS,
                                 n_enc_layers=WHISPER_FULL_LAYERS, dtype="float32")
        out["full_width_card_vs_cpu_max_abs_diff"] = card_against_cpu(
            f"full width cut to {WHISPER_FULL_LAYERS} + {WHISPER_FULL_LAYERS} layers, batch 1",
            fc, 1, P, L, WHISPER_FULL_DECODE, 2)
        gc.collect()
        return record, cli_record, found

    wcfg = get_config(WHISPER)
    paths[WHISPER], paths[f"{WHISPER} serve CLI"], probes[WHISPER] = serve_whisper(wcfg)
    log(f"[profile] phase 3's profiler sessions: {SESSIONS}")
    SESSIONS.update(taken=0, retaken=0)
    phase_done("3h serve whisper-large-v3")

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

    def flash_times(acfg, Sq, Skv, q_offset, kv_pos, window, dtype=torch.bfloat16, B=BATCH,
                    causal=True):
        Hq, Hkv, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
        q = t(B, Sq, Hq, hd, dtype=dtype)
        k, v = t(B, Skv, Hkv, hd, dtype=dtype), t(B, Skv, Hkv, hd, dtype=dtype)
        kp = None if kv_pos is None else torch.as_tensor(kv_pos, dtype=torch.int32, device=dev)
        kpos = np.arange(Skv) if kv_pos is None else np.asarray(kv_pos)
        qpos = q_offset + np.arange(Sq)
        valid = (kpos[None, :] <= qpos[:, None] if causal
                 else np.broadcast_to(kpos[None, :] < INVALID, (Sq, Skv)).copy())
        if window:
            valid &= kpos[None, :] > qpos[:, None] - window
        # per visible score: QK^T and PV (4 hd FLOPs) and one exponential
        n_scores = int(valid.sum()) * B * Hq
        flops = 4 * hd * n_scores
        # K/V of a slot no query attends to (unwritten, or masked for all) is
        # never read: the kernel skips such tiles before loading them
        read = int(valid.any(axis=0).sum())
        nbytes = q.element_size() * (2 * q.numel() + 2 * B * Hkv * hd * read) + (
            4 * Skv if kp is not None else 0)
        b_ms, b_by, b_unit = bound(nbytes, flops, str(dtype).split(".")[-1], exps=n_scores)
        cap = acfg.attn_softcap
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
        # a split-KV call is its split kernel and its combine kernel
        by_kernel = device_ms_by_kernel(lambda: flash_attention(q, k, v, kv_pos=kp, **kw),
                                        flush)
        res = {"shape": f"B{B} Sq{Sq} Skv{Skv} Hq{Hq} Hkv{Hkv} hd{hd} {dtype_name[dtype]} "
                        f"w{window} cap{cap}" + ("" if causal else " not causal"),
               "kernel": kernel_for(q.dtype, Sq, Hq, Hkv),
               "ms": sum(by_kernel.values()), "by_kernel_ms": by_kernel,
               "event_ms": cuda_ms(lambda: flash_attention(q, k, v, kv_pos=kp, **kw)),
               "plain_ms": device_ms(lambda: chunked_attention(q, k, v, kv_positions=kp, **kw),
                                     flush),
               "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit,
               "library_note": "SDPA without the softcap: not the same function" if cap
               else "SDPA: the same function"}
        # SDPA, a yardstick only, without the softcap: is_causal as the call
        # where no kv_pos is given; else a boolean mask from kv_pos (causal
        # and window)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        if kp is None:
            res["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), flush)
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
    # whisper's five calls at 3h's shapes: the encoder's self attention and
    # cross attention (prefill and decode) not causal, the decoder's self
    # attention at prefill and against its half-written ring of 448 slots
    w_written = WHISPER_PROMPT + NEW // 2
    wS = wcfg.enc_seq
    fa_whisper = {
        "encoder_self": flash_times(wcfg, wS, wS, 0, None, 0, causal=False),
        "cross_prefill": flash_times(wcfg, WHISPER_PROMPT, wS, 0, None, 0, causal=False),
        "self_prefill": flash_times(wcfg, WHISPER_PROMPT, WHISPER_PROMPT, 0, None, 0),
        "cross_decode": flash_times(wcfg, 1, wS, 0, None, 0, causal=False),
        "self_decode": flash_times(wcfg, 1, WHISPER_MAX_SEQ, w_written - 1,
                                   ring_pos(WHISPER_MAX_SEQ, w_written - 1, w_written), 0)}
    log(f"[times] whisper's flash calls: {json.dumps(fa_whisper)}")
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

    def rms_slots_times(S, rows, D, dtype=torch.float32):
        """The slot case's row (a scale row a slot), with the shared-scale
        block kernel timed on the same rows beside it."""
        x = t(S, rows, D, dtype=dtype)
        sc = (t(S, D) + 1.0).to(dtype)
        nbytes = 2 * x.numel() * x.element_size() + sc.numel() * sc.element_size()
        b_ms, b_by, _ = bound(nbytes, 4 * x.numel(), str(dtype).split(".")[-1])
        return {"shape": f"({S}, {rows}, {D}) {dtype_name[dtype]}, scale ({S}, {D})",
                "kernel": "block (a scale a slot)",
                "ms": device_ms(lambda: rmsnorm_slots(x, sc), flush),
                "event_ms": cuda_ms(lambda: rmsnorm_slots(x, sc)),
                "plain_ms": device_ms(lambda: rmsnorm_slots_ref(x, sc), flush),
                "library_ms": None,
                "library_note": "no single PyTorch call takes a scale a slot",
                "shared_scale_block_ms": device_ms(lambda: rmsnorm(x, sc[0]), flush),
                "bound_ms": b_ms, "bound_by": b_by}

    # the population engine's LM buckets: the CLI's trial (2 x 32) and the
    # thread backend's (8 x 64), 12 slots of yi-9b reduced
    rms_slots = {f"{rows} rows a slot": rms_slots_times(POP_SLOTS, rows, trial_cfg.d_model)
                 for rows in (POP_LM_BATCH * POP_LM_SEQ, SEARCH_BATCH * SEARCH_SEQ)}
    fa_slots = flash_times(trial_cfg, POP_LM_SEQ, POP_LM_SEQ, 0, None, 0, torch.float32,
                           POP_SLOTS * POP_LM_BATCH)
    assert fa_slots["kernel"] == "fma", fa_slots["kernel"]
    log(f"[times] the LM bucket's shapes: rmsnorm slots {json.dumps(rms_slots)}; flash "
        f"{json.dumps(fa_slots)}")

    def scan_slots_times():
        """The scan's slot case at the mamba bucket's call (phase 9e: 12
        slots x 2 x 32 steps of jamba reduced, f32, b and c sliced as the
        block slices them), the other kernel's slot case beside it."""
        S, B, T = POP_SLOTS, POP_LM_BATCH, POP_LM_SEQ
        args = scan_slots_inputs(S, B, T, jdi, jst, torch.float32)
        n = S * B * T * jdi
        # u, dt, y; the b, c slices; A and D a slot; h0, hT
        nbytes = 4 * (3 * n + 2 * S * B * T * jst + S * jdi * jst + S * jdi
                      + 2 * S * B * jdi * jst)
        b_ms, b_by, b_unit = bound(nbytes, n * (7 * jst + 3), "float32", exps=n * jst)
        kind = scan_kernel_for(args[0])
        other = "sequential" if kind == "prefill" else "prefill"
        y, hT = torch.empty_like(args[0]), torch.empty_like(args[-1])
        return {"shape": f"{S} slots x B{B} S{T} di{jdi} st{jst} f32, A ({S}, {jdi}, {jst}), "
                         f"D ({S}, {jdi})", "kernel": f"{kind} (an A and a D a slot)",
                "ms": device_ms(lambda: selective_scan_slots(*args), flush),
                "event_ms": cuda_ms(lambda: selective_scan_slots(*args)),
                f"{other}_kernel_ms": device_ms(
                    lambda: scan_launch(other, *args, y, hT, rows_per_a=B), flush),
                "plain_ms": device_ms(lambda: selective_scan_slots_ref(*args), flush,
                                      iters=5, warmup=1),
                "library_ms": None, "library_note": "no PyTorch call computes the scan",
                "bound_ms": b_ms, "bound_by": b_by, "bound_unit": b_unit}

    def gmm_slots_times():
        """The grouped matmul at the MoE bucket's call (phase 9e: 12 slots x
        64 tokens x top-2 of grok-1 reduced, f32, over the slots' 48 (slot,
        expert) groups), with ``torch._grouped_mm`` timed on the same
        inputs where it takes f32."""
        x = td(sum(gsizes), grc.d_model)
        w = td(len(gsizes), grc.d_model, grc.expert_d_ff, scale=grc.d_model ** -0.5)
        gs = torch.tensor(gsizes, dtype=torch.int32, device=dev)
        T, D, Fo = x.shape[0], grc.d_model, grc.expert_d_ff
        active = sum(1 for g in gsizes if g)
        nbytes = 4 * (T * D + active * D * Fo + T * Fo + len(gsizes))
        b_ms, b_by, _ = bound(nbytes, 2 * T * D * Fo, "float32")
        res = {"shape": f"T{T} D{D} F{Fo} E{len(gsizes)} ({POP_SLOTS} slots x "
                        f"{grc.n_experts} experts, {active} groups with rows) f32",
               "kernel": gmm_kernel_for(x, w),
               "ms": device_ms(lambda: gmm(x, w, gs), flush),
               "event_ms": cuda_ms(lambda: gmm(x, w, gs)),
               "plain_ms": device_ms(lambda: gmm_ref(x, w, gs), flush, iters=5, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by}
        # torch._grouped_mm, a yardstick only: it may refuse f32
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        try:
            torch._grouped_mm(x, w, offs=offs)
        except RuntimeError as exc:
            res.update(library_ms=None, library_note=f"none: f32 ({str(exc)[:160]})")
        else:
            res["library_ms"] = device_ms(lambda: torch._grouped_mm(x, w, offs=offs), flush)
        return res

    scan_slots = scan_slots_times()
    gmm_slots = gmm_slots_times()
    assert scan_slots["kernel"].startswith("prefill") and gmm_slots["kernel"] == "small", (
        scan_slots["kernel"], gmm_slots["kernel"])
    log(f"[times] the mamba and MoE buckets' shapes: scan slots {json.dumps(scan_slots)}; gmm "
        f"over slot x expert groups {json.dumps(gmm_slots)}")
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
                        (STARCODER, scfg.reduced()), (WHISPER, wcfg.reduced()),
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

    def layernorm_ms(tcfg, batch, seq):
        """The step's plain LayerNorms, forward and backward, timed apart at
        the step's shapes (CUDA events, the median of 5 calls of each
        shape): ms for all of them, and their count. The profiled step's
        split cannot tell their kernels from the other elementwise ones."""
        from repro_torch.models.layers import _layernorm
        dt = getattr(torch, tcfg.dtype)
        dec_n = tcfg.n_repeat * sum(1 + bool(ffn) + tcfg.is_encdec for _, ffn in tcfg.pattern) + 1
        enc_n = 2 * tcfg.n_enc_layers + 1 if tcfg.is_encdec else 0
        total = 0.0
        for rows, n in ((batch * seq, dec_n), (batch * tcfg.enc_seq, enc_n)):
            if not n:
                continue
            x = torch.randn(rows, tcfg.d_model, device=dev, dtype=dt, requires_grad=True)
            sc = torch.ones(tcfg.d_model, device=dev, dtype=dt, requires_grad=True)
            bi = torch.zeros(tcfg.d_model, device=dev, dtype=dt, requires_grad=True)
            g = torch.randn(rows, tcfg.d_model, device=dev, dtype=dt)
            times = []
            for _ in range(6):
                st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                st.record()
                torch.autograd.grad(_layernorm(x, sc, bi), (x, sc, bi), g)
                en.record()
                en.synchronize()
                times.append(st.elapsed_time(en))
            total += n * float(np.median(times[1:]))
        return total, dec_n + enc_n

    def train_model(tcfg, batch, note, lr, seq=TRAIN_SEQ):
        """TRAIN_STEPS AdamW steps of ``Trainer`` at full width, each one
        ``Trainer.run(1)`` between two CUDA events. An encoder-decoder's
        batches carry the pipeline's frames (batch, enc_seq, d_model), and
        its forward the encoder's flash calls."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(tcfg, TrainConfig(optimizer="adamw", learning_rate=lr),
                          batch, seq, seed=0, device=dev)
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
        expect = per_forward(tcfg, encoder=tcfg.is_encdec)
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
        assert by[2] == {"warp": expect["rmsnorm"] * TRAIN_STEPS, "block": 0, "slots": 0}
        assert by[3] == {"prefill": expect["selective_scan"] * TRAIN_STEPS, "sequential": 0,
                         "slots": 0}
        log(f"[train] {tcfg.name} per step: {expect} kernel launches, all in the forward")
        step_ms = [s.elapsed_time(e) for s, e in events]
        med = float(np.median(step_ms[2:]))
        frames = batch * tcfg.enc_seq if tcfg.is_encdec else 0
        bound_ms, active, flops = matmul_bound_ms(tcfg, batch * seq, frames)
        res = {"arch": tcfg.name, "n_layers": tcfg.n_layers, "params": n_params,
               "batch": batch, "seq": seq, "steps": TRAIN_STEPS, "lr": lr,
               "step_ms": step_ms, "step_ms_median_3_10": med,
               "matmul_bound_ms": bound_ms, "matmul_bound_weights": active,
               "matmul_bound_flops": flops,
               "tokens_per_s": batch * seq / (med / 1e3), "run_s": wall_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss_first": losses[0], "loss_last3_mean": sum(losses[-3:]) / 3}
        if frames:
            res.update(enc_frames=frames, enc_frames_per_s=frames / (med / 1e3))
        log("[train] " + json.dumps(res))
        res["profile"] = profiled_step(tcfg, trainer)
        draws = []
        for _ in range(3):
            # the pipeline's host work a step (numpy draws, the copy to the
            # card), which the step's CUDA events enclose and no kernel shows
            t0 = time.perf_counter()
            next(trainer.data)
            torch.cuda.synchronize()
            draws.append((time.perf_counter() - t0) * 1e3)
        res["profile"]["pipeline_draw_ms"] = float(np.median(draws))
        log(f"[train] {tcfg.name}: the pipeline's draw of a batch, host clock, median of 3: "
            f"{res['profile']['pipeline_draw_ms']:.2f} ms")
        if tcfg.norm == "layernorm":
            ln_ms, ln_n = layernorm_ms(tcfg, batch, seq)
            res["profile"].update(layernorm_fwd_bwd_ms_timed_apart=ln_ms, layernorms=ln_n)
            log(f"[train] {tcfg.name}: its {ln_n} LayerNorms, forward and backward timed apart "
                f"at the step's shapes, {ln_ms:.2f} ms a step (inside the split's other_ms)")
        del trainer
        return (launches, expect, TRAIN_STEPS, *by), res

    train_cfgs = [(cfg, "", TRAIN_LR),
                  (dataclasses.replace(hcfg, n_layers=2, pattern=hybrid_train_pattern),
                   f"; cut to 2 of {hcfg.n_layers} layers (two of its block; the "
                   f"{HYBRID_LAYERS}-layer serve cut with AdamW's moments is "
                   f"{12 * count_params(jcfg) / 1e9:.0f} GB, with RMSProp's "
                   f"{8 * count_params(jcfg) / 1e9:.0f} GB)", TRAIN_LR),
                  (scfg, "; nothing cut (LayerNorm and GELU are plain PyTorch)",
                   STARCODER_TRAIN_LR),
                  (wcfg, f"; nothing cut: {wcfg.n_enc_layers} encoder layers over "
                   f"{wcfg.enc_seq} frames, {wcfg.n_layers} decoder layers at "
                   f"{WHISPER_MAX_SEQ} tokens (LayerNorm and GELU are plain PyTorch)", TRAIN_LR)]
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
        seq = WHISPER_MAX_SEQ if tcfg.is_encdec else TRAIN_SEQ
        path, trained[tcfg.name] = train_model(tcfg, TRAIN_BATCH, note, lr, seq)
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
        counts = all_counts()
        launches, fa_by, gmm_by, rms_by, scan_by = counts
        summary, table = res.summary(), trial_table(res)
        assert summary["n_trials"] == w0, (label, summary)
        assert "crashed" not in summary["by_status"], (label, summary["by_status"])
        hold_trials(label, table, phases, w0)
        assert 0 < summary["alpha"] <= 1, (label, summary["alpha"])
        if bar:
            assert summary["best_metric"] > -math.log(rcfg.vocab_size), (label, summary)
        steps = steps_per_phase * sum(len(ms) for _, _, ms in table.values())
        expect = per_forward(rcfg, encoder=rcfg.is_encdec)
        log(f"[search] {label}: {steps} trial-steps, launches {launches}, flash by kernel "
            f"{fa_by}, gmm by kernel {gmm_by}, rmsnorm by kernel {rms_by}, selective_scan by "
            f"kernel {scan_by}; per step {expect}")
        path = hold_lm_counts(label, counts, steps, expect)
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
        return path, out, res

    searches = {}
    # 6a: the CLI's defaults, 4 node threads, without the profiler
    path, searches["6a"], res_4 = search(
        f"6a {YI}, {SEARCH_NODES} nodes", ["--objective", "lm"], YI, SEARCH_W0, SEARCH_PHASES,
        SEARCH_STEPS, bar=True)
    paths[f"search {YI} {SEARCH_NODES} nodes"] = path
    phase_done("6a search, 4 node threads")

    # 6b: the same search on one node thread, in one profiler session: the
    # same configurations by trial id (one numpy stream), and every (trial,
    # phase) both trained within SEARCH_NODES_ATOL
    path, searches["6b"], res_1 = search(
        f"6b {YI}, 1 node", ["--objective", "lm", "--nodes", "1", "--phases",
                             str(SEARCH_PROFILED_PHASES)], YI, SEARCH_W0,
        SEARCH_PROFILED_PHASES, SEARCH_STEPS, profiled=True, bar=True)
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

    # 6d: the scan (jamba), the grouped matmul (grok-1) and the
    # encoder-decoder (whisper: flash not causal) under concurrent trials
    tables_6d = {}
    for arch, kernel in ((HYBRID, "selective_scan"), (GROK, "gmm"), (WHISPER, "flash_attention")):
        assert per_forward(get_config(arch).reduced())[kernel] > 0, (arch, kernel)
        path, searches[f"6d {arch}"], res_6d = search(
            f"6d {arch}, 2 nodes", ["--arch", arch, *SEARCH_KERNEL_ARGV], arch, 4, 2, 4)
        paths[f"search {arch} 2 nodes"] = path
        tables_6d[arch] = trial_table(res_6d)
    phase_done("6d search, all four kernels and the encoder-decoder")
    log("[search] summary " + json.dumps(searches))

    # -- 7. the GA3C search ------------------------------------------------------
    rl_paths, rl, res_7a = rl_phase(dev, smi, zero_counts, all_counts, phase_done)
    # -- 8. the population engine -------------------------------------------------
    pop_paths, pop, table_8a = population_phase(dev, smi, zero_counts, all_counts, phase_done,
                                                rl, res_7a)
    for k, (launches, *by_kernel) in {**rl_paths, **pop_paths}.items():
        paths[k] = (launches, {name: 0 for name in launches}, 0, *by_kernel)
    # -- 9. LM trials on the population engine, and PBT --------------------------
    lm_paths, lm_out, table_9a = population_lm_phase(dev, smi, zero_counts, all_counts,
                                                     phase_done)
    paths.update(lm_paths)
    # -- 10. the control plane: worker processes against the TCP server --------
    # the journals phase 14 reads, kept until the script ends
    kept = {"dir": tempfile.mkdtemp(prefix="smoke-journals-"), "journals": {}}
    atexit.register(shutil.rmtree, kept["dir"], True)
    gc.collect()
    torch.cuda.empty_cache()
    control_paths, control, live = control_plane_phase(smi, phase_done, searches["6a"],
                                                       trial_table(res_4), rl, kept,
                                                       tables_6d[WHISPER])
    paths.update(control_paths)
    # -- 11. the population worker: a batch of trials a worker process -------
    gc.collect()
    torch.cuda.empty_cache()
    popw_paths, _ = population_worker_phase(
        smi, phase_done, {"9a": lm_out["9a"], "8a": pop["8a"], "10a": control["10a"],
                          "10d": control["10d"]}, table_9a, table_8a, kept)
    paths.update(popw_paths)
    # -- 12. the paper's baselines: Successive Halving and evolution ----------
    gc.collect()
    torch.cuda.empty_cache()
    base_paths, _ = baselines_phase(dev, smi, zero_counts, all_counts, phase_done,
                                    trial_table(res_4), searches["6a"], trial_table(res_7a),
                                    rl["7a"])
    paths.update(base_paths)
    # -- 13. the paper's simulator, the trace and the load generator -----------
    simulator_phase(smi, phase_done, zero_counts, all_counts, kept)
    # -- 14. the journal's readers over this run's journals --------------------
    readers_phase(smi, phase_done, zero_counts, all_counts, kept, live)

    kernels = []
    for name, src, replaces, main_t, dec_t, more in [
            ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/rmsnorm.py:22", rms_prefill, rms_decode,
             {"jamba": rms_jamba, "grok": rms_grok, "phi3": rms_phi3, "kimi": rms_kimi,
              "search": rms_search, "slots": rms_slots}),
            ("flash_attention", "src/repro_torch/kernels/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:75", fa_prefill, fa_decode,
             {"jamba": fa_jamba, "zoo": fa_zoo, "whisper": fa_whisper, "search": fa_search,
              "slots": fa_slots}),
            ("gmm", "src/repro_torch/kernels/csrc/gmm_prefill.cu",
             "src/repro/kernels/gmm/gmm.py:28", gmm_prefill, gmm_more["decode"],
             {**{k: v for k, v in gmm_more.items() if k != "decode"}, "grok": gmm_grok,
              "kimi": gmm_kimi, "slots": gmm_slots}),
            ("selective_scan", "src/repro_torch/kernels/csrc/scan_prefill.cu",
             "src/repro/kernels/selective_scan/selective_scan.py:51", scan_prefill,
             scan_decode, {"edge": scan_edge, "jax_draws": scan_jax_draws,
                           "slots": scan_slots})]:
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(p[0][name] for p in paths.values()),
            "launches_by_path": {k: p[0][name] for k, p in paths.items()},
            "launches_per_forward": {k: p[1][name] for k, p in paths.items()},
            "max_abs_err": err[name], **main_t, "kernel_ms": main_t["ms"],
            "decode": dec_t, **more, "device": smi})
        if name == "rmsnorm":
            kernels[-1]["sources"] = ["src/repro_torch/kernels/csrc/rmsnorm.cu"]
            for served in ("warp", "block", "slots"):
                kernels[-1][f"launches_{served}"] = sum(p[5][served] for p in paths.values())
                kernels[-1][f"launches_{served}_by_path"] = {k: p[5][served]
                                                             for k, p in paths.items()}
            kernels[-1]["resources"] = rms_res
            kernels[-1]["max_abs_err_by_kernel"] = rms_err_by_kernel
        if name == "selective_scan":
            kernels[-1]["sources"] = ["src/repro_torch/kernels/csrc/scan_prefill.cu",
                                      "src/repro_torch/kernels/csrc/selective_scan.cu"]
            for served in ("prefill", "sequential", "slots"):
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
    log(f"[phase] the smoke's total, phases 0-14 with the build: "
        f"{time.perf_counter() - clock['start']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != SMOKE_HASH_SEED:
        os.execve(sys.executable, [sys.executable, os.path.abspath(sys.argv[0]), *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED=SMOKE_HASH_SEED))
    sys.exit(main())
