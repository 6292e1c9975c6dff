"""Public flash-attention entry point in model layout (B, S, H, hd): the
CUDA kernels for CUDA tensors, the plain chunked version for CPU tensors.

Replaces ``repro/kernels/flash_attention/ops.py::flash_attention`` (whose
Pallas kernel is ``flash_attention.py::flash_attention_pallas``). A CUDA
tensor launches a kernel or raises; only a CPU tensor takes
``chunked_attention``. Which kernel serves a CUDA call (split-KV decode and
tensor-core prefill for bf16, the FMA kernel for f32) is
``flash_attention.kernel_for``'s choice, with no fallback between them.

Gradients: where autograd needs one, the CUDA call goes through
``kernels.autograd.PlainGrad``. Its forward is the same kernel launch; its
backward recomputes ``chunked_attention`` on the saved q, k, v and returns
that gradient (no backward kernel: the reference has none). ``kv_pos`` and
``q_offset`` take no gradient. So on the card the plain version runs only
inside a backward. A CPU tensor's autograd differentiates
``chunked_attention`` as it stands.

Counters, plain ints on this function, moved by the kernel that
``flash_attention_cuda`` reports it launched: ``launches`` counts calls that
launched a kernel (a split-KV call launches the split kernel and its combine
and counts once); ``launches_split_kv``, ``launches_tensor_core`` and
``launches_fma`` count the calls each of the three kernels served, so a run
shows which one did. Each count goes through ``kernels.counters.count_launch``,
exact when several threads launch.
What bounds each kernel and what its design does about it: see
``csrc/flash_decode.cu``, ``csrc/flash_prefill.cu``, ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.autograd import kernel_op
from repro_torch.kernels.counters import count_launch
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import chunked_attention


def _kernel(q, k, v, kv_pos, causal, window, softcap, q_offset, chunk):
    out, launched = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                         softcap=softcap, q_offset=q_offset,
                                         kv_pos=kv_pos)
    count_launch(flash_attention, launched)
    return out


def flash_attention_plain(q, k, v, kv_pos, causal, window, softcap, q_offset, chunk):
    return chunked_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset,
                             kv_positions=kv_pos, chunk=chunk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, kv_pos: Optional[torch.Tensor] = None,
                    chunk: int = 512):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd); kv_pos: (Skv,) int32
    absolute key positions (default ``arange(Skv)``). ``chunk`` is the KV
    chunk of the plain version; the kernels tile KV their own way."""
    args = (q, k, v, kv_pos, causal, window, softcap, q_offset, chunk)
    if q.device.type == "cpu":
        return flash_attention_plain(*args)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return kernel_op(_kernel, flash_attention_plain, *args)


flash_attention.launches = 0
flash_attention.launches_split_kv = 0
flash_attention.launches_tensor_core = 0
flash_attention.launches_fma = 0
