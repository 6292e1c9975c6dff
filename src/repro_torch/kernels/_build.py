"""Builds the port's CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface. The library lands in ``build/repro_torch/<hash>/`` at the
repository root, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads the cached file. Beside it,
``build.log`` keeps what ``ptxas -v`` said of every kernel when it was
built (registers, spills), as a record. The build runs at the first launch
of any kernel, never at import. Several processes that reach it at once
(a search's worker processes) compile once: the check-and-build holds an
exclusive ``flock`` on ``BUILD_ROOT/<hash>.lock``, so one process runs
``nvcc`` and the others wait for the lock and load its library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "build.log"

# the launchers' dtype codes (ReproDtype in csrc/common.cuh)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of the exported launchers (see csrc/*.cu); every launcher
# returns a cudaError_t as int
SIGNATURES = {
    # x, scale, out, rows, D, x row stride, eps, x dtype, scale dtype,
    # rows a scale row (0: one scale for every row), stream
    "rmsnorm_launch": [_P, _P, _P, _LL, _I, _LL, _F, _I, _I, _LL, _P],
    # x, scale, out, rows, D, x row stride, eps, scale dtype, stream
    "rmsnorm_warp_launch": [_P, _P, _P, _LL, _I, _LL, _F, _I, _P],
    "rmsnorm_warp_attrs": [_I, _IP],        # D, int[4] as flash_prefill_attrs
    "flash_attention_launch": [
        _P, _P, _P, _P, _P,                 # q, k, v, kv_pos, out
        _I, _I, _I, _I, _I, _I,             # B, Sq, Skv, Hq, Hkv, hd
        _LL, _LL, _LL,                      # q strides (b, s, h)
        _LL, _LL, _LL,                      # k strides
        _LL, _LL, _LL,                      # v strides
        _I, _I, _I, _F, _I, _P],            # q_offset, causal, window, softcap, dtype, stream
    "flash_split_kv_launch": [
        _P, _P, _P, _P, _P,                 # q, k, v, kv_pos, out
        _P, _P, _P,                         # o, m, l partials
        _I, _I, _I, _I, _I, _I,             # B, Sq, Skv, Hq, Hkv, hd
        _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,   # q, k, v strides (b, s, h)
        _I, _I, _I, _F,                     # q_offset, causal, window, softcap
        _I, _I, _P],                        # n_split, tiles_per_split, stream
    "flash_prefill_launch": [
        _P, _P, _P, _P, _P,                 # q, k, v, kv_pos, out
        _I, _I, _I, _I, _I, _I,             # B, Sq, Skv, Hq, Hkv, hd
        _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,   # q, k, v strides (b, s, h)
        _I, _I, _I, _F, _P],                # q_offset, causal, window, softcap, stream
    # hd, int[4] or int[5]: registers, local bytes, static and dynamic
    # shared bytes of the kernel at hd (cudaFuncGetAttributes)
    "flash_prefill_attrs": [_I, _IP],
    "flash_split_kv_attrs": [_I, _IP],      # dynamic shared bytes with 1 and 2 stages
    "flash_attention_attrs": [_I, _IP],
    "flash_combine_attrs": [_IP],           # int[3]
    "selective_scan_launch": [
        _P, _P, _P, _P, _P, _P, _P,         # u, dt, A, b, c, d_skip, h0
        _P, _P,                             # y, hT
        _I, _I, _I, _I,                     # B, S, di, st
        _LL, _LL, _LL, _LL,                 # b strides (batch, seq), c strides
        _LL,                                # batch rows a row of A and d_skip (0: one)
        _I, _P],                            # dtype, stream
    "selective_scan_prefill_launch": [      # as selective_scan_launch
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _I, _P],
    "selective_scan_prefill_attrs": [_I, _IP],   # dtype, int[4] as flash_prefill_attrs
    "gmm_launch": [_P, _P, _P, _P,          # x, w, group_sizes, out
                   _I, _I, _I, _I, _I, _P],  # T, D, F, E, dtype, stream
    "gmm_prefill_launch": [_P, _P, _P, _P,  # x, w, group_sizes, out (bf16)
                           _I, _I, _I, _I, _P],   # T, D, F, E, stream
    "gmm_prefill_attrs": [_IP],             # int[4], as flash_prefill_attrs
    "gmm_decode_launch": [_P, _P, _P, _P,   # x, w, group_sizes, out (bf16)
                          _I, _I, _I, _I, _P],    # T, D, F, E, stream
    "gmm_decode_attrs": [_IP],              # int[4], as flash_prefill_attrs
}

_lock = threading.Lock()
_lib = None
build_seconds = None        # wall time of the last build; None if loaded from cache


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):     # .cu and .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: pathlib.Path) -> pathlib.Path:
    nvcc = _nvcc()
    sources = _sources()
    tmp = pathlib.Path(tempfile.mkdtemp(dir=out_dir.parent))
    try:
        objs = [tmp / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for s, o in zip(sources, objs)]
        errors, log = [], []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            log.append(f"== {s.name}\n{out.decode(errors='replace')}")
            if p.returncode:
                errors.append(log[-1])
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = tmp / LIB_NAME
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                        *map(str, objs)], check=True, capture_output=True)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / LOG_NAME).write_text("".join(log))
        os.replace(lib, out_dir / LIB_NAME)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / LIB_NAME


def build_library() -> pathlib.Path:
    """The kernel library's path, built first if the sources changed. The
    check and the build hold an exclusive lock on a file beside the build
    directory, which the system drops when its process ends, so a build
    cut short leaves no stale lock; ``os.replace`` puts the library in
    place whole."""
    global build_seconds
    out_dir = BUILD_ROOT / _digest()
    path = out_dir / LIB_NAME
    if path.exists():
        return path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / f"{out_dir.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():       # another process may have built it meanwhile
            t0 = time.perf_counter()
            path = _compile(out_dir)
            build_seconds = time.perf_counter() - t0
    return path


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
