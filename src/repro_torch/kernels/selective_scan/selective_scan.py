"""ctypes bindings of the CUDA selective-scan kernels.

Counterpart of ``repro/kernels/selective_scan/selective_scan.py::
selective_scan_pallas``: the Mamba recurrence over S with f32 state, the
final state returned in f32 and ``D * u`` folded into y. The TPU kernel
carries a (bd x d_state) VMEM block across a sequential grid axis. Two CUDA
kernels serve it (``kernel_for``):
  * ``prefill`` (``csrc/scan_prefill.cu``): the associative form of
    ``repro/models/ssm.py::selective_scan_assoc`` across lanes: each lane a
    run of up to 16 consecutive steps of one channel, a channel's 4 runs'
    (A, B) aggregates joined by a scan of warp shuffles, 8 channels a warp
    (plain twin: ``ref.selective_scan_tiled``);
  * ``sequential`` (``csrc/selective_scan.cu``): one thread a (batch,
    channel) that holds its d_state (<= 16) states in registers and loops
    over S; it takes every call of fewer steps, so every decode step.
b and c may be strided views (the model slices them out of one
projection), with the last dim contiguous.

``selective_scan_slots_cuda`` is the slot case, the reference's kernel
under ``jax.vmap`` over a population's slots: each trial's own ``a`` and
``d_skip``, read by both kernels at row ``r / rows_per_a`` for batch row r.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ref import RUNS

MAX_STATE = 16
# the fewest steps the prefill kernel takes: runs of 8 steps or more
PREFILL_MIN_STEPS = 8 * RUNS


def kernel_for(u: torch.Tensor) -> str:
    """Which kernel serves a call: ``prefill`` or ``sequential``, from the
    sequence length S of u (B, S, di) alone.

    ``prefill`` takes S >= ``PREFILL_MIN_STEPS`` = 32, ``sequential`` the
    rest, which includes every S = 1 decode step. The edge is a design rule,
    not a reading: from 32 steps each of a channel's 4 runs holds 8 steps or
    more, and each state's scan over the runs (shuffles, its carry) is spread
    over that many; below it the sequential kernel, which has no such fixed
    cost a state, takes the call. ``chip_smoke.py`` phase 4 times both
    kernels at S = 32 (PERF.md §6). Both kernels take any dtype, width, state
    size (<= 16) and b/c strides the wrapper accepts, so nothing but S
    decides.
    """
    return "prefill" if u.shape[1] >= PREFILL_MIN_STEPS else "sequential"


def _checked(u, dt, a, b, c, d_skip, h0, slots: int, what: str):
    """Check a call's tensors: one (di, st) ``a`` and (di,) ``d_skip`` when
    ``slots`` is 0, else (slots, di, st) and (slots, di) with u's batch rows
    a multiple of ``slots``. -> (y, hT) to launch into."""
    tensors = (u, dt, a, b, c, d_skip, h0)
    if not (u.is_cuda and all(t.device == u.device for t in tensors)):
        raise ValueError(f"{what}: all inputs must be on one CUDA device")
    if u.dtype not in _build.DTYPES or any(t.dtype != u.dtype for t in (dt, b, c, d_skip)):
        raise TypeError(f"{what}: u, dt, b, c, d_skip must share one of "
                        f"{list(_build.DTYPES)}; got {[t.dtype for t in (u, dt, b, c, d_skip)]}")
    if a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"{what}: a and h0 must be float32")
    if u.dim() != 3:
        raise ValueError(f"{what}: u must be (B, S, di), got {tuple(u.shape)}")
    B, S, di = u.shape
    lead = (slots,) if slots else ()
    st = a.shape[-1] if a.dim() == 2 + len(lead) else -1
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"{what}: d_state {st} not in [1, {MAX_STATE}]")
    if slots and B % slots:
        raise ValueError(f"{what}: {B} batch rows are not a multiple of {slots} slots")
    for t, shape, name in ((dt, (B, S, di), "dt"), (a, (*lead, di, st), "a"),
                           (b, (B, S, st), "b"), (c, (B, S, st), "c"),
                           (d_skip, (*lead, di), "d_skip"), (h0, (B, di, st), "h0")):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {shape}")
    for t, name in ((u, "u"), (dt, "dt"), (a, "a"), (d_skip, "d_skip"), (h0, "h0")):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError(f"{what}: b and c need a contiguous last dim")
    return torch.empty_like(u), torch.empty((B, di, st), dtype=torch.float32, device=u.device)


def selective_scan_cuda(u, dt, a, b, c, d_skip, h0):
    """u, dt: (B, S, di); a: (di, st) f32; b, c: (B, S, st); d_skip: (di,);
    h0: (B, di, st) f32 -> (y (B, S, di) in u's dtype, hT (B, di, st) f32,
    the kernel that was launched: ``kernel_for``'s name, or None for an empty
    call, which launches nothing)."""
    y, hT = _checked(u, dt, a, b, c, d_skip, h0, 0, "selective_scan_cuda")
    if u.shape[0] == 0 or u.shape[2] == 0:
        return y, hT, None
    kind = kernel_for(u)
    launch(kind, u, dt, a, b, c, d_skip, h0, y, hT)
    return y, hT, kind


def selective_scan_slots_cuda(u, dt, a, b, c, d_skip, h0):
    """The slot case, the reference's kernel under ``jax.vmap`` over a
    population's slots: a (S, di, st) f32 and d_skip (S, di), one row a
    slot; u, dt, b, c, h0 as ``selective_scan_cuda``'s with S * B batch
    rows, each group of B consecutive rows reading its slot's ``a`` and
    ``d_skip``. The kernel is ``kernel_for``'s, as there -> (y, hT, the
    kernel launched or None)."""
    if a.dim() != 3:
        raise ValueError(f"selective_scan_slots_cuda: a must be (S, di, st), got "
                         f"{tuple(a.shape)}")
    y, hT = _checked(u, dt, a, b, c, d_skip, h0, a.shape[0], "selective_scan_slots_cuda")
    if u.shape[0] == 0 or u.shape[2] == 0:
        return y, hT, None
    kind = kernel_for(u)
    launch(kind, u, dt, a, b, c, d_skip, h0, y, hT, rows_per_a=u.shape[0] // a.shape[0])
    return y, hT, kind


def launch(kind: str, u, dt, a, b, c, d_skip, h0, y, hT, rows_per_a: int = 0) -> None:
    """Launch the scan kernel ``kind`` on tensors ``selective_scan_cuda`` has
    checked, into y and hT, or raise. ``selective_scan_cuda`` calls it with
    ``kernel_for``'s choice; ``chip_smoke.py`` also calls it past the
    dispatch, to hold and time one kernel beside the other on the same
    inputs. ``rows_per_a``: 0 for one ``(di, st)`` a and ``(di,)`` d_skip,
    else the batch rows that share each row of an ``(S, di, st)`` a and
    ``(S, di)`` d_skip."""
    if kind not in ("prefill", "sequential"):
        raise ValueError(f"selective_scan: no kernel {kind!r}")
    B, S, di = u.shape
    lib = _build.load_library()
    fn = lib.selective_scan_prefill_launch if kind == "prefill" else lib.selective_scan_launch
    err = fn(u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
             d_skip.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
             B, S, di, a.shape[-1], b.stride(0), b.stride(1), c.stride(0), c.stride(1),
             rows_per_a, _build.DTYPES[u.dtype],
             torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, err, f"selective_scan ({kind})")
