"""Public selective-scan entry point: the CUDA kernels for CUDA tensors, the
plain sequential scan for CPU tensors.

Replaces ``repro/kernels/selective_scan/ops.py::selective_scan`` (whose
Pallas kernel is ``selective_scan.py::selective_scan_pallas``). A CUDA
tensor launches a kernel or raises; only a CPU tensor takes
``selective_scan_ref``. Which kernel serves a CUDA call is
``selective_scan.kernel_for``'s choice, from S alone, with no fallback
between them: the associative prefill kernel from 32 steps, the sequential
kernel below (every decode step).

Gradients: where autograd needs one, the CUDA call goes through
``kernels.autograd.PlainGrad``. Its forward is the same kernel launch; its
backward recomputes ``selective_scan_ref`` on the saved inputs and returns
that gradient (no backward kernel: the reference has none). A final state
``hT`` that takes no gradient (training never reads it) counts as zero. On
the card the plain version runs only inside a backward. A CPU tensor's
autograd differentiates ``selective_scan_ref`` as it stands.

Counters, plain ints on this function, moved by the kernel that
``selective_scan_cuda`` reports it launched: ``launches`` counts calls that
launched a kernel; ``launches_prefill`` and ``launches_sequential`` the
calls each kernel served. What bounds the kernels: see
``csrc/scan_prefill.cu`` and ``csrc/selective_scan.cu``.
"""
from __future__ import annotations

from repro_torch.kernels.autograd import kernel_op
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan.selective_scan import selective_scan_cuda


def _kernel(u, dt, a, b, c, d_skip, h0):
    y, hT, launched = selective_scan_cuda(u, dt, a, b, c, d_skip, h0)
    if launched is not None:
        selective_scan.launches += 1
    if launched == "prefill":
        selective_scan.launches_prefill += 1
    elif launched == "sequential":
        selective_scan.launches_sequential += 1
    return y, hT


def selective_scan(u, dt, a, b, c, d_skip, h0):
    """u, dt: (B, S, di); a: (di, st) f32; b, c: (B, S, st); d_skip: (di,);
    h0: (B, di, st) f32 -> (y (B, S, di) in u's dtype, hT (B, di, st) f32)."""
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d_skip, h0)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device {u.device}")
    return kernel_op(_kernel, selective_scan_ref, u, dt, a, b, c, d_skip, h0)


selective_scan.launches = 0
selective_scan.launches_prefill = 0
selective_scan.launches_sequential = 0
