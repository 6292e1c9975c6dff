"""ctypes bindings of the CUDA grouped-matmul kernels.

Counterpart of ``repro/kernels/gmm/ops.py::gmm`` with its Pallas kernel
``gmm.py::gmm_pallas``: rows sorted by group, each row times its group's
(D, F) weight, f32 accumulation, ragged in and ragged out. The TPU version
pads every group to whole row tiles on the host (``pad_groups``); the CUDA
kernels read ``group_sizes`` on the device and map their blocks to (group,
rows) themselves (``csrc/gmm.cuh``), so a call never waits on the host.

Two kernels serve it (``kernel_for``):
  * ``tiled`` (``csrc/gmm_prefill.cu``): bf16 prefill, 128 x 128 tiles on
    mma.sync tensor cores fed by a cp.async ring;
  * ``small`` (``csrc/gmm.cu``): every other call, which is every decode
    step and every f32 call; 64 x 64 tiles, WMMA for bf16 and FMAs for f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gmm.ref import TILE_M


def kernel_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel serves a call: ``tiled`` or ``small``, from dtypes,
    shapes and pointer alignment alone, never from ``group_sizes``, whose
    contents would cost a host sync.

    ``tiled`` takes bf16 calls with at least ``TILE_M`` = 128 rows,
    D and F multiples of 8 and 16-byte-aligned x and w: it copies and stores
    8 bf16 at a time. The threshold is one of its row tiles. A call with
    fewer rows fills no tile in any group (a decode step's 8 rows over 8
    groups fill 1/128 of each), so what it costs is its groups' weight
    panels, read once in either kernel; such calls stay on ``small``, whose
    64-row tiles waste half as many rows, until decode gets a kernel of its
    own. ``small`` takes everything else.

    Timed on an H100 (``chip_smoke.py`` phase 4, both kernels on the same
    inputs; PERF.md §6): at jamba's 4,096-row prefill and, just past the
    edge, at a batch-128 decode step's 256 rows (16 groups of about 16), the
    tiled kernel is the faster, the latter by about 2.6x; at a batch-4
    decode step's 8 rows the small one serves. Row counts from 9 to 127 and
    from 257 to 4,095 were not timed."""
    D, F = w.shape[-2], w.shape[-1]
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and x.shape[0] >= TILE_M and D % 8 == 0 and F % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tiled"
    return "small"


def gmm_cuda(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> tuple:
    """x: (T, D); w: (E, D, F); group_sizes: (E,) int32 on x's device ->
    (out (T, F), the kernel that was launched: ``kernel_for``'s name, or None
    for an empty output, which launches nothing)."""
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
        return out, None
    kind = kernel_for(x, w)
    lib = _build.load_library()
    args = (x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), T, D, F, E)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kind == "tiled":
        err = lib.gmm_prefill_launch(*args, stream)
    else:
        err = lib.gmm_launch(*args, _build.DTYPES[x.dtype], stream)
    _build.check(lib, err, f"gmm ({kind})")
    return out, kind
