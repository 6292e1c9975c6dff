"""ctypes binding of the CUDA grouped-matmul kernel (``kernels/csrc/gmm.cu``).

Counterpart of ``repro/kernels/gmm/ops.py::gmm`` with its Pallas kernel
``gmm.py::gmm_pallas``: rows sorted by group, each row times its group's
(D, F) weight, f32 accumulation, ragged in and ragged out. The TPU version
pads every group to whole row tiles on the host (``pad_groups``); the CUDA
kernel reads ``group_sizes`` on the device and maps its blocks to (group,
rows) itself, so a call never waits on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def gmm_cuda(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (T, D); w: (E, D, F); group_sizes: (E,) int32 on x's device -> (T, F)."""
    if not (x.is_cuda and w.device == x.device and group_sizes.device == x.device):
        raise ValueError("gmm_cuda: x, w and group_sizes must be on one CUDA device")
    if x.dtype not in _build.DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gmm_cuda: dtypes {x.dtype}, {w.dtype}; need one of "
                        f"{list(_build.DTYPES)} for both")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"gmm_cuda: group_sizes must be int32, got {group_sizes.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm_cuda: need x (T, D) and w (E, D, F); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, D, F = w.shape
    if tuple(group_sizes.shape) != (E,):
        raise ValueError(f"gmm_cuda: group_sizes shape {tuple(group_sizes.shape)} != ({E},)")
    if not (x.is_contiguous() and w.is_contiguous() and group_sizes.is_contiguous()):
        raise ValueError("gmm_cuda: x, w and group_sizes must be contiguous")
    T = x.shape[0]
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    err = lib.gmm_launch(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                         out.data_ptr(), T, D, F, E, _build.DTYPES[x.dtype],
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "gmm_launch")
    return out
