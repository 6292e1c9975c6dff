"""Public selective-scan entry point: the CUDA kernel for CUDA tensors, the
plain sequential scan for CPU tensors.

Replaces ``repro/kernels/selective_scan/ops.py::selective_scan`` (whose
Pallas kernel is ``selective_scan.py::selective_scan_pallas``). A CUDA
tensor launches the kernel or raises; only a CPU tensor takes
``selective_scan_ref``. ``selective_scan.launches`` counts the kernel
launches. What bounds the kernel: see ``csrc/selective_scan.cu``.
"""
from __future__ import annotations

from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.kernels.selective_scan.selective_scan import selective_scan_cuda


def selective_scan(u, dt, a, b, c, d_skip, h0):
    """u, dt: (B, S, di); a: (di, st) f32; b, c: (B, S, st); d_skip: (di,);
    h0: (B, di, st) f32 -> (y (B, S, di) in u's dtype, hT (B, di, st) f32)."""
    if u.device.type == "cpu":
        return selective_scan_ref(u, dt, a, b, c, d_skip, h0)
    if u.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device {u.device}")
    out = selective_scan_cuda(u, dt, a, b, c, d_skip, h0)
    selective_scan.launches += 1
    return out


selective_scan.launches = 0
