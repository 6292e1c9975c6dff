"""Public RMSNorm entry point: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

Replaces ``repro/kernels/rmsnorm/ops.py::rmsnorm`` (whose Pallas kernel is
``rmsnorm.py::rmsnorm_pallas``). A CUDA tensor launches the kernel or
raises; only a CPU tensor takes ``rmsnorm_ref``. ``rmsnorm.launches`` counts
the kernel launches, so a run can show that its path went through the
kernel. What bounds the kernel: device memory bandwidth (see
``csrc/rmsnorm.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    out = rmsnorm_cuda(x, scale, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
