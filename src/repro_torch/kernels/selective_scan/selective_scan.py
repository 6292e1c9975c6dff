"""ctypes binding of the CUDA selective-scan kernel
(``kernels/csrc/selective_scan.cu``).

Counterpart of ``repro/kernels/selective_scan/selective_scan.py::
selective_scan_pallas``: the Mamba recurrence over S with f32 state, the
final state returned in f32 and ``D * u`` folded into y. The TPU kernel
carries a (bd x d_state) VMEM block across a sequential grid axis; the CUDA
kernel gives each (batch, channel) one thread that holds its d_state (<= 16)
states in registers and loops over S. b and c may be strided views (the
model slices them out of one projection), with the last dim contiguous.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_STATE = 16


def selective_scan_cuda(u, dt, a, b, c, d_skip, h0):
    """u, dt: (B, S, di); a: (di, st) f32; b, c: (B, S, st); d_skip: (di,);
    h0: (B, di, st) f32 -> (y (B, S, di) in u's dtype, hT (B, di, st) f32)."""
    tensors = (u, dt, a, b, c, d_skip, h0)
    if not (u.is_cuda and all(t.device == u.device for t in tensors)):
        raise ValueError("selective_scan_cuda: all inputs must be on one CUDA device")
    if u.dtype not in _build.DTYPES or any(t.dtype != u.dtype for t in (dt, b, c, d_skip)):
        raise TypeError(f"selective_scan_cuda: u, dt, b, c, d_skip must share one of "
                        f"{list(_build.DTYPES)}; got {[t.dtype for t in (u, dt, b, c, d_skip)]}")
    if a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError("selective_scan_cuda: a and h0 must be float32")
    if u.dim() != 3:
        raise ValueError(f"selective_scan_cuda: u must be (B, S, di), got {tuple(u.shape)}")
    B, S, di = u.shape
    st = a.shape[-1] if a.dim() == 2 else -1
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"selective_scan_cuda: d_state {st} not in [1, {MAX_STATE}]")
    for t, shape, name in ((dt, (B, S, di), "dt"), (a, (di, st), "a"), (b, (B, S, st), "b"),
                           (c, (B, S, st), "c"), (d_skip, (di,), "d_skip"),
                           (h0, (B, di, st), "h0")):
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan_cuda: {name} shape {tuple(t.shape)} != {shape}")
    for t, name in ((u, "u"), (dt, "dt"), (a, "a"), (d_skip, "d_skip"), (h0, "h0")):
        if not t.is_contiguous():
            raise ValueError(f"selective_scan_cuda: {name} must be contiguous")
    if b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError("selective_scan_cuda: b and c need a contiguous last dim")
    y = torch.empty_like(u)
    hT = torch.empty((B, di, st), dtype=torch.float32, device=u.device)
    if B == 0 or di == 0:
        return y, hT
    lib = _build.load_library()
    err = lib.selective_scan_launch(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        d_skip.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
        B, S, di, st, b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        _build.DTYPES[u.dtype], torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, err, "selective_scan_launch")
    return y, hT
