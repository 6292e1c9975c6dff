"""Public RMSNorm entry point: the CUDA kernels for CUDA tensors, the plain
version for CPU tensors.

Replaces ``repro/kernels/rmsnorm/ops.py::rmsnorm`` (whose Pallas kernel is
``rmsnorm.py::rmsnorm_pallas``). A CUDA tensor launches a kernel or raises;
only a CPU tensor takes ``rmsnorm_ref``. Which kernel serves a CUDA call is
``rmsnorm.kernel_for``'s choice, with no fallback between them: the
warp-per-row kernel for bf16 rows of the configs' widths, the block-per-row
kernel for everything else.

Gradients: where autograd needs one, the CUDA call goes through
``kernels.autograd.PlainGrad``. Its forward is the same kernel launch; its
backward recomputes ``rmsnorm_ref`` on the saved inputs and returns that
gradient (no backward kernel: the reference has none). So on the card the
plain version runs only inside a backward. A CPU tensor's autograd
differentiates ``rmsnorm_ref`` as it stands.

Counters, plain ints on this function, moved by the kernel that
``rmsnorm_cuda`` reports it launched: ``launches`` counts calls that
launched a kernel; ``launches_warp`` and ``launches_block`` the calls each
kernel served (through ``kernels.counters.count_launch``, exact when
several threads launch). What bounds the kernels: device memory bandwidth
(see ``csrc/rmsnorm.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import kernel_op
from repro_torch.kernels.counters import count_launch
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda


def _kernel(x: torch.Tensor, scale: torch.Tensor, eps: float):
    out, launched = rmsnorm_cuda(x, scale, eps)
    count_launch(rmsnorm, launched)
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    return kernel_op(_kernel, rmsnorm_ref, x, scale, eps)


rmsnorm.launches = 0
rmsnorm.launches_warp = 0
rmsnorm.launches_block = 0
