"""Times variants of a bf16 grouped-matmul kernel on one CUDA card, at
jamba's expert shapes under its served routing: the tiled kernel
(``csrc/gmm_prefill.cu``) at prefill, or the decode kernel
(``csrc/gmm_decode.cu``) at a decode step.

  PYTHONPATH=src python -m repro_torch.kernels.gmm.sweep [--kernel tiled|decode]
      [--rounds 4] [--out FILE]

Each variant is the kernel's source built with other values of its tile
macros (tiled: K step, ring stages, a warp's piece, the blocks an SM must
hold; decode: column tile, K step, ring stages, blocks an SM), into a
library of its own under ``build/repro_torch/sweep/``; ``shipped`` is the
source built as the port builds it. Per variant it prints the registers,
local memory (spills) and shared memory ``cudaFuncGetAttributes`` reports,
the blocks an SM can hold by those, and its device time per call at
up/gate (4096 -> 14336) and down (14336 -> 4096). A timed call follows a
read of a 256 MB buffer, so no weight is left in the 50 MB L2, and is timed
alone with CUDA events. Rounds run the variants in turn, in reverse order
every other round, with ``torch._grouped_mm`` on the same inputs as a
yardstick. Every variant's output is held against ``gmm_ref`` at the
smoke's bf16 limit (1e-2 + 2**-7 |ref|) before it is timed. Needs nvcc and
one card; nothing in the port calls it.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gmm.ref import gmm_ref

# group sizes of jamba-8's first MoE layer in the prefill of 4 x 512 seeded
# prompts at top-2 (chip_smoke.py phase 3b's routing line, seed-0 weights)
SERVED_PREFILL_SIZES = [245, 223, 247, 239, 250, 321, 306, 261, 253, 253, 237, 263, 233,
                        244, 245, 276]
D_MODEL, D_FF = 4096, 14336     # jamba-v0.1-52b's d_model and expert d_ff
FLUSH_BYTES = 256 << 20

# group sizes of jamba-8's first MoE layer in the decode step after that
# prefill (chip_smoke.py phase 3b's routing line): 8 rows, 1 to each of 8
# experts
SERVED_DECODE_SIZES = [0, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 1, 0, 1, 0]

# name -> macro values; None builds the source's defaults
VARIANTS = {
    "shipped": None,                                                  # bk32 s4 64x32 2/SM
    "bk32_s3_w64x32": dict(BK=32, STAGES=3, WM=64, WN=32, MIN_BLOCKS=2),
    "bk64_s3_w64x32": dict(BK=64, STAGES=3, WM=64, WN=32, MIN_BLOCKS=2),
    "bk64_s3_w64x32_1blk": dict(BK=64, STAGES=3, WM=64, WN=32, MIN_BLOCKS=1),
    "bk64_s3_w64x64": dict(BK=64, STAGES=3, WM=64, WN=64, MIN_BLOCKS=2),
    "bk32_s4_w64x64": dict(BK=32, STAGES=4, WM=64, WN=64, MIN_BLOCKS=2),
}
DEFAULTS = dict(BK=32, STAGES=4, WM=64, WN=32, MIN_BLOCKS=2)
DECODE_VARIANTS = {
    "shipped": None,                                                  # bn128 bk64 s4 2/SM
    "bn64_bk64_s4": dict(BN=64, BK=64, STAGES=4, MIN_BLOCKS=4),
    "bn128_bk64_s3": dict(BN=128, BK=64, STAGES=3, MIN_BLOCKS=3),
    "bn128_bk32_s8": dict(BN=128, BK=32, STAGES=8, MIN_BLOCKS=2),
    "bn256_bk64_s3": dict(BN=256, BK=64, STAGES=3, MIN_BLOCKS=2),
}
DECODE_DEFAULTS = dict(BN=128, BK=64, STAGES=4, MIN_BLOCKS=2)
# per kernel: source, macro prefix, exports, variants, defaults, routing,
# and its threads a block from its macros
KERNELS = {
    "tiled": dict(src="gmm_prefill.cu", prefix="GMM_PREFILL_", launch="gmm_prefill_launch",
                  attrs="gmm_prefill_attrs", variants=VARIANTS, defaults=DEFAULTS,
                  sizes=SERVED_PREFILL_SIZES,
                  threads=lambda m: 32 * (128 // m["WM"]) * (128 // m["WN"])),
    "decode": dict(src="gmm_decode.cu", prefix="GMM_DECODE_", launch="gmm_decode_launch",
                   attrs="gmm_decode_attrs", variants=DECODE_VARIANTS,
                   defaults=DECODE_DEFAULTS, sizes=SERVED_DECODE_SIZES,
                   threads=lambda m: 128),
}
# H100 per SM: registers, shared memory, threads; 1 KB of shared memory is
# reserved per block, registers are given out 8 a thread at a time
SM_REGS, SM_SMEM, SM_THREADS, BLOCK_SMEM_RESERVED = 65536, 233472, 2048, 1024


def build(kernel: str) -> dict:
    """{name: CDLL} of every variant of ``kernel``, compiled in parallel, one
    nvcc each."""
    k = KERNELS[kernel]
    src = _build.CSRC / k["src"]
    digest = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in sorted(_build.CSRC.glob("*.cu*")):
        digest.update(f.read_bytes())
    out_dir = _build.BUILD_ROOT / "sweep" / digest.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, macros in k["variants"].items():
        lib = out_dir / f"{kernel}_{name}.so"
        if lib.exists():
            continue
        defs = [f"-D{k['prefix']}{m}={v}" for m, v in (macros or {}).items()]
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", str(src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
    libs = {}
    for name in k["variants"]:
        lib = ctypes.CDLL(str(out_dir / f"{kernel}_{name}.so"))
        for fn in (k["launch"], k["attrs"]):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def resources(kernel: str, lib, macros: dict) -> dict:
    k = KERNELS[kernel]
    out = (ctypes.c_int * 4)()
    if getattr(lib, k["attrs"])(out):
        raise RuntimeError(f"{k['attrs']} failed")
    m = {**k["defaults"], **(macros or {})}
    threads = k["threads"](m)
    regs = -(-out[0] // 8) * 8
    smem = out[2] + out[3] + BLOCK_SMEM_RESERVED
    blocks = min(SM_REGS // (regs * threads), SM_SMEM // smem, SM_THREADS // threads)
    return {**m, "threads": threads, "registers": out[0], "local_bytes": out[1],
            "static_smem_bytes": out[2], "dynamic_smem_bytes": out[3],
            "blocks_per_sm": blocks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=list(KERNELS), default="tiled")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20, help="timed calls a round")
    ap.add_argument("--out", help="write the readings here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    k = KERNELS[args.kernel]
    libs = build(args.kernel)
    res = {n: resources(args.kernel, lib, k["variants"][n]) for n, lib in libs.items()}
    for n, r in res.items():
        print(f"[resources] {n}: {json.dumps(r)}", flush=True)

    flush_buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes = k["sizes"]
    T, E = sum(sizes), len(sizes)
    active = sum(1 for g in sizes if g)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for shape, (D, F) in {"up": (D_MODEL, D_FF), "down": (D_FF, D_MODEL)}.items():
        x = torch.randn(T, D, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(E, D, F, generator=gen, device=dev) * D ** -0.5).to(torch.bfloat16)
        out = torch.empty(T, F, dtype=torch.bfloat16, device=dev)
        ref = gmm_ref(x, w, gs).float()
        limit = 1e-2 + 2 ** -7 * ref.abs()

        def launcher(lib):
            def call():
                err = getattr(lib, k["launch"])(x.data_ptr(), w.data_ptr(), gs.data_ptr(),
                                                out.data_ptr(), T, D, F, E, stream)
                if err:
                    raise RuntimeError(f"{k['launch']}: CUDA error {err}")
            return call

        calls = {n: launcher(lib) for n, lib in libs.items()}
        for n, call in calls.items():
            out.zero_()
            call()
            excess = ((out.float() - ref).abs() - limit).max().item()
            if excess > 0:
                raise AssertionError(f"{n} {shape}: error over the limit by {excess:.3e}")
        calls["torch._grouped_mm"] = lambda: torch._grouped_mm(x, w, offs=offs)
        order = list(calls)
        for rnd in range(args.rounds):
            for n in (order if rnd % 2 == 0 else order[::-1]):
                ms = timed(calls[n], flush_buf, args.iters)
                times.setdefault(shape, {}).setdefault(n, []).append(ms)
                tflops = 2 * T * D * F / ms / 1e9
                tbs = 2 * active * D * F / ms / 1e9      # the active panels' bytes
                print(f"round {rnd} {shape} T{T} {D}->{F} {n}: {ms * 1e3:.1f} us, "
                      f"{tflops:.0f} TFLOP/s, {tbs:.2f} TB/s of weights", flush=True)
        del x, w, out, ref, limit
    for shape, by_name in times.items():
        for n, ms in by_name.items():
            print(f"[sweep] {shape} {n}: {min(ms) * 1e3:.1f}-{max(ms) * 1e3:.1f} us over "
                  f"{len(ms)} rounds", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "kernel": args.kernel,
                       "sizes": sizes,
                       "resources": res, "ms": times}, f, indent=1)
    return 0


def timed(call, flush_buf, iters: int) -> float:
    """Device ms per call, each call after reading ``flush_buf``, which
    leaves the L2 holding clean lines of the buffer and none of the inputs."""
    call()
    total = 0.0
    for _ in range(iters):
        flush_buf.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


if __name__ == "__main__":
    sys.exit(main())
