"""ctypes bindings of the CUDA RMSNorm kernels (``kernels/csrc/rmsnorm.cu``).

Counterpart of ``repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_pallas``: the
same function, ``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim with
f32 compute and the output in x's dtype. The TPU kernel tiles 128 rows into
VMEM. Both CUDA kernels read each row once and write it once, so device
memory bandwidth bounds them on the H100. Two kernels serve it
(``kernel_for``):
  * ``warp``: bf16 rows of the widths in ``WARP_WIDTHS``, one warp a row,
    the row held in registers as 16-byte vectors, no shared memory;
  * ``block``: every other call, one 256-thread block a row staged in
    shared memory.

``rmsnorm_slots_cuda`` is the slot case, the reference's kernel under
``jax.vmap`` over a population's slots: x is ``(S, ..., D)`` and scale
``(S, D)``, one scale row a slot. It takes the block kernel at every dtype
(no trial's width is a warp width), which reads row r's scale from row
``r / rows_per_scale``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the widths the warp kernel is built for (RMSNORM_WARP_WIDTHS in
# csrc/rmsnorm.cu): the configs' d_model, 2304 (gemma2-2b) and 4096 (jamba)
WARP_WIDTHS = (2304, 4096)


def row_stride(x: torch.Tensor):
    """The distance in elements between the rows of ``x`` seen as (rows, D),
    or None if its rows are not evenly spaced (e.g. ``h[:, ::2][:, :3]``).
    ``h[:, -1:]`` of a contiguous (B, S, D) tensor has rows S * D apart."""
    D = x.shape[-1]
    try:
        return x.view(x.numel() // D if D else 0, D).stride(0)
    except RuntimeError:
        return None


def kernel_for(x: torch.Tensor, scale: torch.Tensor) -> str:
    """Which kernel serves a call: ``warp`` or ``block``, from dtypes,
    shapes, strides and pointer alignment alone.

    ``warp`` takes bf16 x whose width is one it is built for
    (``WARP_WIDTHS``), with a bf16 or f32 scale, rows a multiple of 8
    elements apart and 16-byte-aligned x and scale: each lane moves the row
    8 elements at a time. ``block`` takes everything else: every f32 x, other
    widths, unaligned or oddly strided rows.

    There is no row-count edge: the warp kernel serves decode rows (a few
    rows, one block) as it serves prefill. The design rule is that one
    warp's 32 lanes hold a row in registers whatever the row count, and a
    call of R rows is R warps in flight against the block kernel's R blocks
    of 8 warps that each wait on two barriers. Timed beside each other on
    an H100 (``chip_smoke.py`` phase 4, PERF.md §6).
    """
    D = x.shape[-1]
    stride = row_stride(x)
    if (x.dtype == torch.bfloat16 and scale.dtype in (torch.bfloat16, torch.float32)
            and D in WARP_WIDTHS and stride is not None and stride % 8 == 0
            and x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0):
        return "warp"
    return "block"


def _checked(x: torch.Tensor, scale: torch.Tensor, scale_shape: tuple, what: str):
    """Check a call's tensors -> (out, rows, row stride); rows 0 launches
    nothing."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"{what}: x and scale must be on the same CUDA device")
    if x.dtype not in _build.DTYPES or scale.dtype not in _build.DTYPES:
        raise TypeError(f"{what}: unsupported dtypes {x.dtype}, {scale.dtype}")
    if scale.shape != scale_shape:
        raise ValueError(f"{what}: scale shape {tuple(scale.shape)} != {scale_shape} "
                         f"for x of {tuple(x.shape)}")
    if x.stride(-1) != 1 or not scale.is_contiguous():
        raise ValueError(f"{what}: x's last dim and scale must be contiguous")
    D = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // D if D else 0
    stride = row_stride(x) if rows else 0
    if stride is None:
        raise ValueError(f"{what}: rows of strides {x.stride()} are not evenly spaced")
    return out, rows, stride


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> tuple:
    """Launch ``kernel_for``'s kernel on ``x``'s current stream; x: (..., D),
    scale: (D,) -> (out in x's dtype, the kernel's name, or None for an empty
    output, which launches nothing)."""
    out, rows, stride = _checked(x, scale, (x.shape[-1],), "rmsnorm_cuda")
    if rows == 0:
        return out, None
    kind = kernel_for(x, scale)
    launch(kind, x, scale, out, rows, stride, eps)
    return out, kind


def rmsnorm_slots_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> tuple:
    """Launch the block kernel's slot case on ``x``'s current stream; x:
    (S, ..., D), scale: (S, D), every row of slot s scaled by ``scale[s]``
    -> (out in x's dtype, ``"block"``, or None for an empty output, which
    launches nothing)."""
    if x.dim() < 2:
        raise ValueError(f"rmsnorm_slots_cuda: x of {tuple(x.shape)} has no slot axis")
    out, rows, stride = _checked(x, scale, (x.shape[0], x.shape[-1]), "rmsnorm_slots_cuda")
    if rows == 0:
        return out, None
    launch("block", x, scale, out, rows, stride, eps, rows_per_scale=rows // x.shape[0])
    return out, "block"


def launch(kind: str, x, scale, out, rows: int, stride: int, eps: float,
           rows_per_scale: int = 0) -> None:
    """Launch the RMSNorm kernel ``kind`` on tensors ``rmsnorm_cuda`` has
    checked, into ``out``, or raise. ``chip_smoke.py`` also calls it past
    the dispatch, to hold and time one kernel beside the other.
    ``rows_per_scale`` (block kernel only): 0 for one ``(D,)`` scale, else
    the rows that share each row of a ``(rows / rows_per_scale, D)`` scale."""
    if kind not in ("warp", "block"):
        raise ValueError(f"rmsnorm: no kernel {kind!r}")
    if rows_per_scale and kind != "block":
        raise ValueError("rmsnorm: only the block kernel takes a scale a slot")
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    D = x.shape[-1]
    if kind == "warp":
        err = lib.rmsnorm_warp_launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                                      stride, eps, _build.DTYPES[scale.dtype], stream)
    else:
        err = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D,
                                 stride, eps, _build.DTYPES[x.dtype], _build.DTYPES[scale.dtype],
                                 rows_per_scale, stream)
    _build.check(lib, err, f"rmsnorm ({kind})")
