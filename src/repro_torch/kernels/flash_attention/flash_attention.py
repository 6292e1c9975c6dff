"""ctypes bindings of the CUDA flash-attention kernels.

Counterpart of ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas``: forward attention with an online softmax over KV
tiles, causal / sliding-window / tanh-softcap masking and GQA. It differs
from the Pallas signature in two ways the serving path needs: ``q_offset``
is a runtime int (the decode position changes every step), and masking reads
a ``kv_pos`` int32 vector of absolute positions (the ring cache's ``kpos``;
unwritten slots hold 2**30). ``kv_pos=None`` means ``arange(Skv)``. It takes
the model layout (B, S, H, hd) through strides: no transpose copies.

Three kernels serve it (``kernel_for``):
  * ``split_kv`` (``csrc/flash_decode.cu``): bf16, when the Sq x G query rows
    of one kv head fit one 16-row tile, which is every decode step. The keys
    are cut into ``split_kv_plan``'s contiguous ranges, one block each, and a
    second kernel combines the f32 partials;
  * ``tensor_core`` (``csrc/flash_prefill.cu``): every other bf16 call, on
    mma.sync tensor cores;
  * ``fma`` (``csrc/flash_attention.cu``): f32, on f32 FMAs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

# the head dims each kernel is built for (its switch in csrc/): 96 is
# phi3-mini-3.8b's, 112 kimi-k2's
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)
MAX_GROUP = 16          # query rows (Sq x G) of one kv head in one 16-row tile
SPLIT_TILE = 64         # keys per tile of the split-KV kernel
# blocks the split-KV grid aims for: two per SM of the H100's 132
SPLIT_TARGET_BLOCKS = 264


def kernel_for(dtype: torch.dtype, Sq: int, Hq: int, Hkv: int) -> str:
    """Which kernel serves a call: ``fma`` (f32), ``split_kv`` (bf16 with
    Sq x G <= 16) or ``tensor_core`` (bf16 otherwise)."""
    if dtype != torch.bfloat16:
        return "fma"
    return "split_kv" if Sq * (Hq // Hkv) <= MAX_GROUP else "tensor_core"


def split_kv_plan(B: int, Hkv: int, Skv: int) -> tuple:
    """(n_split, tiles_per_split) of the split-KV kernel, from the shapes
    alone: never from ``kv_pos``, whose contents would cost a host sync.

    Aims for ``SPLIT_TARGET_BLOCKS`` blocks (B x Hkv x n_split) and gives
    every split at least one tile; no split is empty."""
    n_tiles = max(1, -(-Skv // SPLIT_TILE))
    want = max(1, -(-SPLIT_TARGET_BLOCKS // max(1, B * Hkv)))
    per = -(-n_tiles // min(want, n_tiles))
    return -(-n_tiles // per), per


def _check_rows(t: torch.Tensor, name: str) -> None:
    es = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention_cuda: {name} last dim must be contiguous")
    if t.data_ptr() % 16 or any(s * es % 16 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention_cuda: {name} rows must be 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0,
                         kv_pos: Optional[torch.Tensor] = None) -> tuple:
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) -> (out (B, Sq, Hq, hd),
    the kernel that was launched: ``kernel_for``'s name, or None for an
    empty output, which launches nothing)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in _build.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; need one of {list(_build.DTYPES)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention_cuda: need q (B,Sq,Hq,hd) and k, v "
                         "(B,Skv,Hkv,hd) of one shape")
    B, Sq, Hq, hd = q.shape
    Bk, Skv, Hkv, hdk = k.shape
    if Bk != B or hdk != hd:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {hd} not in {HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_attention_cuda: Hq={Hq} over Hkv={Hkv} unsupported")
    kind = kernel_for(q.dtype, Sq, Hq, Hkv)
    if kind == "fma":
        if q.stride(-1) != 1:
            raise ValueError("flash_attention_cuda: q last dim must be contiguous")
    else:
        _check_rows(q, "q")         # the bf16 kernels copy q rows 16 bytes at a time
    _check_rows(k, "k")
    _check_rows(v, "v")
    if kv_pos is not None:
        if (kv_pos.dtype != torch.int32 or kv_pos.shape != (Skv,)
                or kv_pos.device != q.device or not kv_pos.is_contiguous()):
            raise ValueError("flash_attention_cuda: kv_pos must be a contiguous "
                             f"int32 ({Skv},) tensor on {q.device}")
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out, None
    lib = _build.load_library()
    kp = None if kv_pos is None else kv_pos.data_ptr()
    shapes = (B, Sq, Skv, Hq, Hkv, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    masks = (int(q_offset), int(causal), int(window), float(softcap))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kind == "split_kv":
        n_split, per = split_kv_plan(B, Hkv, Skv)
        # f32 partials (m, l, o) of each split, combined by the second kernel
        o_part = torch.empty((B, Sq * Hq, n_split, hd), dtype=torch.float32, device=q.device)
        ml = torch.empty((2, B, Sq * Hq, n_split), dtype=torch.float32, device=q.device)
        err = lib.flash_split_kv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kp, out.data_ptr(),
            o_part.data_ptr(), ml[0].data_ptr(), ml[1].data_ptr(), *shapes, *masks,
            n_split, per, stream)
    elif kind == "tensor_core":
        err = lib.flash_prefill_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), kp,
                                       out.data_ptr(), *shapes, *masks, stream)
    else:
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), kp,
                                         out.data_ptr(), *shapes, *masks,
                                         _build.DTYPES[q.dtype], stream)
    _build.check(lib, err, f"flash_attention ({kind})")
    return out, kind
