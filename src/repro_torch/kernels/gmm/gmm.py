"""ctypes bindings of the CUDA grouped-matmul kernels.

Counterpart of ``repro/kernels/gmm/ops.py::gmm`` with its Pallas kernel
``gmm.py::gmm_pallas``: rows sorted by group, each row times its group's
(D, F) weight, f32 accumulation, ragged in and ragged out. The TPU version
pads every group to whole row tiles on the host (``pad_groups``); the CUDA
kernels read ``group_sizes`` on the device and map their blocks to (group,
rows) themselves (``csrc/gmm.cuh``), so a call never waits on the host.

Three kernels serve it (``kernel_for``):
  * ``tiled`` (``csrc/gmm_prefill.cu``): bf16 prefill, 128 x 128 tiles on
    mma.sync tensor cores fed by a cp.async ring;
  * ``decode`` (``csrc/gmm_decode.cu``): bf16 calls of fewer rows, which is
    every decode step; slots of 16 rows by 128 columns that stream each
    active group's weight panel once through a cp.async ring, on mma.sync;
  * ``small`` (``csrc/gmm.cu``): the f32 calls and the bf16 calls that
    neither of the other two can take (widths not a multiple of 8, or x or w
    not 16-byte aligned); 64 x 64 tiles, WMMA for bf16 and FMAs for f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gmm.ref import TILE_M


def kernel_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel serves a call: ``tiled``, ``decode`` or ``small``, from
    dtypes, shapes and pointer alignment alone, never from ``group_sizes``,
    whose contents would cost a host sync.

    A bf16 call with D and F multiples of 8 and 16-byte-aligned x and w (the
    two bf16 kernels copy and store 8 bf16 at a time) takes ``tiled`` from
    ``TILE_M`` = 128 rows, one of its row tiles, and ``decode`` below that.
    Below the edge no group fills a 128-row tile, and what a call costs is
    its groups' weight panels, which ``decode`` streams once for each
    16-row slot. ``small`` takes everything else: every f32 call, and bf16
    calls of other widths or alignments.

    The edge is a design rule, not a reading: one tiled row tile, below
    which no group fills a tile. Timed on an H100 (``chip_smoke.py`` phase
    4, the kernels on the same inputs, L2 flushed, up/gate 4096 -> 14336
    at decode-like top-2 routing over 16 experts; PERF.md §6), the decode
    kernel takes 4-5 % less time than the tiled one at T = 126 and 128,
    4-5 % less at T = 160 and 192, 1 % less at T = 224, and 4 % more at
    T = 256 (15 % more at down, 14336 -> 4096). So at up/gate the two
    cross between 224 and 256 rows, and calls of 128-224 rows go to the
    slower kernel here; down was timed only at 256, so the edge is not
    moved on these readings. Below it the decode kernel is 2.6-2.9x as
    fast as the small kernel at T = 8 (the served step, also at down), 32,
    64 and 126.
    """
    D, F = w.shape[-2], w.shape[-1]
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and D % 8 == 0 and F % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tiled" if x.shape[0] >= TILE_M else "decode"
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
    out = torch.empty((x.shape[0], F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, None
    kind = kernel_for(x, w)
    launch(kind, x, w, group_sizes, out)
    return out, kind


def launch(kind: str, x, w, group_sizes, out) -> None:
    """Launch the gmm kernel ``kind`` on tensors ``gmm_cuda`` has checked,
    into ``out``, or raise. ``gmm_cuda`` calls it with ``kernel_for``'s
    choice; ``chip_smoke.py`` also calls it past the dispatch, to hold and
    time one kernel beside another on the same inputs."""
    E, D, F = w.shape
    lib = _build.load_library()
    args = (x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), x.shape[0],
            D, F, E)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kind == "tiled":
        err = lib.gmm_prefill_launch(*args, stream)
    elif kind == "decode":
        err = lib.gmm_decode_launch(*args, stream)
    elif kind == "small":
        err = lib.gmm_launch(*args, _build.DTYPES[x.dtype], stream)
    else:
        raise ValueError(f"gmm: no kernel {kind!r}")
    _build.check(lib, err, f"gmm ({kind})")
