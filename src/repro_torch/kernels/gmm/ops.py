"""Public grouped-matmul entry point: the CUDA kernels for CUDA tensors, the
plain per-group version for CPU tensors.

Replaces ``repro/kernels/gmm/ops.py::gmm`` (whose Pallas kernel is
``gmm.py::gmm_pallas``). A CUDA tensor launches a kernel or raises; only a
CPU tensor takes ``gmm_ref``. Which kernel serves a CUDA call is
``gmm.kernel_for``'s choice, with no fallback between them: the tiled
tensor-core kernel for bf16 calls of 128 rows or more (prefill), the
weight-streaming kernel for bf16 calls of fewer (decode), and the small
kernel for f32 calls and the bf16 calls that neither of the other two can
take (widths not a multiple of 8, unaligned pointers).

Gradients: where autograd needs one, the CUDA call goes through
``kernels.autograd.PlainGrad``. Its forward is the same kernel launch; its
backward recomputes ``gmm_ref`` on the saved x and w and returns that
gradient (no backward kernel: the reference has none). ``group_sizes``
takes no gradient. ``gmm_ref`` reads the group sizes on the host, so the
backward waits on the card once a call: a training step may, a serving
step never runs it. On the card the plain version runs only inside a
backward. A CPU tensor's autograd differentiates ``gmm_ref`` as it stands.

Counters, plain ints on this function, moved by the kernel that
``gmm_cuda`` reports it launched: ``launches`` counts calls that launched a
kernel; ``launches_tiled``, ``launches_decode`` and ``launches_small`` count
the calls each of the three kernels served (through
``kernels.counters.count_launch``, exact when several threads launch). What
bounds each kernel: see ``csrc/gmm_prefill.cu``, ``csrc/gmm_decode.cu`` and
``csrc/gmm.cu``.
"""
from __future__ import annotations

from repro_torch.kernels.autograd import kernel_op
from repro_torch.kernels.counters import count_launch
from repro_torch.kernels.gmm.gmm import gmm_cuda
from repro_torch.kernels.gmm.ref import gmm_ref


def _kernel(x, w, group_sizes):
    out, launched = gmm_cuda(x, w, group_sizes)
    count_launch(gmm, launched)
    return out


def gmm(x, w, group_sizes):
    """x: (T, D) rows sorted by group; w: (E, D, F); group_sizes: (E,) int32
    on x's device -> (T, F) in x's dtype."""
    if x.device.type == "cpu":
        return gmm_ref(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"gmm: no kernel for device {x.device}")
    return kernel_op(_kernel, gmm_ref, x, w, group_sizes)


gmm.launches = 0
gmm.launches_tiled = 0
gmm.launches_decode = 0
gmm.launches_small = 0
