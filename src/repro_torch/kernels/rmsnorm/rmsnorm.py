"""ctypes binding of the CUDA RMSNorm kernel (``kernels/csrc/rmsnorm.cu``).

Counterpart of ``repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_pallas``: the
same function, ``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim with
f32 compute and the output in x's dtype. The TPU kernel tiles 128 rows into
VMEM; the CUDA kernel gives each row one block, reads it once with 16-byte
loads, reduces with warp shuffles and writes it once: it is bound by device
memory bandwidth on the H100.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """Launch the kernel on ``x``'s current stream; x: (..., D), scale: (D,)."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError("rmsnorm_cuda: x and scale must be on the same CUDA device")
    if x.dtype not in _build.DTYPES or scale.dtype not in _build.DTYPES:
        raise TypeError(f"rmsnorm_cuda: unsupported dtypes {x.dtype}, {scale.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"rmsnorm_cuda: scale shape {tuple(scale.shape)} != ({D},)")
    if x.stride(-1) != 1 or not scale.is_contiguous():
        raise ValueError("rmsnorm_cuda: x's last dim and scale must be contiguous")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    try:    # rows must be evenly strided, e.g. h[:, -1:] of a (B, S, D) tensor
        row_stride = x.view(rows, D).stride(0)
    except RuntimeError:
        raise ValueError(f"rmsnorm_cuda: rows of strides {x.stride()} are not "
                         "evenly spaced") from None
    lib = _build.load_library()
    err = lib.rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, row_stride, eps,
        _build.DTYPES[x.dtype], _build.DTYPES[scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "rmsnorm_launch")
    return out
