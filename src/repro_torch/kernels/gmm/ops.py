"""Public grouped-matmul entry point: the CUDA kernel for CUDA tensors, the
plain per-group version for CPU tensors.

Replaces ``repro/kernels/gmm/ops.py::gmm`` (whose Pallas kernel is
``gmm.py::gmm_pallas``). A CUDA tensor launches the kernel or raises; only a
CPU tensor takes ``gmm_ref``. ``gmm.launches`` counts the kernel launches.
What bounds the kernel: see ``csrc/gmm.cu``.
"""
from __future__ import annotations

from repro_torch.kernels.gmm.gmm import gmm_cuda
from repro_torch.kernels.gmm.ref import gmm_ref


def gmm(x, w, group_sizes):
    """x: (T, D) rows sorted by group; w: (E, D, F); group_sizes: (E,) int32
    on x's device -> (T, F) in x's dtype."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"gmm: no kernel for device {x.device}")
    out = gmm_cuda(x, w, group_sizes)
    gmm.launches += 1
    return out


gmm.launches = 0
