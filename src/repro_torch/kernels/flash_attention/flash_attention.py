"""ctypes binding of the CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention/flash_attention.py::
flash_attention_pallas``: forward attention with an online softmax over KV
tiles, causal / sliding-window / tanh-softcap masking and GQA. It differs
from the Pallas signature in two ways the serving path needs: ``q_offset``
is a runtime int (the decode position changes every step), and masking reads
a ``kv_pos`` int32 vector of absolute positions (the ring cache's ``kpos``;
unwritten slots hold 2**30). ``kv_pos=None`` means ``arange(Skv)``. It takes
the model layout (B, S, H, hd) through strides: no transpose copies.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16          # query heads per kv head that fit one 16-row q-tile


def _check_kv(t: torch.Tensor, name: str) -> None:
    es = t.element_size()
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention_cuda: {name} last dim must be contiguous")
    if t.data_ptr() % 16 or any(s * es % 16 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention_cuda: {name} rows must be 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0,
                         kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
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
    if q.stride(-1) != 1:
        raise ValueError("flash_attention_cuda: q last dim must be contiguous")
    _check_kv(k, "k")
    _check_kv(v, "v")
    if kv_pos is not None:
        if (kv_pos.dtype != torch.int32 or kv_pos.shape != (Skv,)
                or kv_pos.device != q.device or not kv_pos.is_contiguous()):
            raise ValueError("flash_attention_cuda: kv_pos must be a contiguous "
                             f"int32 ({Skv},) tensor on {q.device}")
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_pos is None else kv_pos.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, hd, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(q_offset), int(causal), int(window),
        float(softcap), _build.DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_launch")
    return out
