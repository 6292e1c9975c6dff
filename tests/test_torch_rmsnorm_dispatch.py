"""The RMSNorm dispatch: which CUDA kernel ``kernel_for`` picks from dtypes,
shapes, strides and alignment alone, the counters ``ops.rmsnorm`` moves by
the kernel ``rmsnorm_cuda`` reports, and CPU tensors, which never reach the
dispatch. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.rmsnorm import ops  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rms_mod  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.rmsnorm import WARP_WIDTHS, kernel_for, row_stride  # noqa: E402

bf16, f32 = torch.bfloat16, torch.float32


def _counts():
    return (ops.rmsnorm.launches, ops.rmsnorm.launches_warp, ops.rmsnorm.launches_block)


@pytest.mark.parametrize("shape,dtype,s_dtype,kind", [
    ((2048, 2304), bf16, bf16, "warp"),         # gemma2-2b prefill rows
    ((4, 2304), bf16, bf16, "warp"),            # its decode rows: no row-count edge
    ((2048, 4096), bf16, bf16, "warp"),         # jamba
    ((1, 4096), bf16, f32, "warp"),             # an f32 scale
    ((3, 5, 256), bf16, bf16, "block"),         # the reduced models' width
    ((2048, 2304), f32, f32, "block"),          # f32 x
    ((4, 2304), f32, bf16, "block"),
    ((4, 1000), bf16, bf16, "block"),           # widths outside WARP_WIDTHS
    ((4, 257), bf16, bf16, "block"),
    ((4, 2048), bf16, bf16, "block"),
])
def test_kernel_for_chooses_from_shapes(shape, dtype, s_dtype, kind):
    x = torch.zeros(shape, dtype=dtype)
    assert kernel_for(x, torch.ones(shape[-1], dtype=s_dtype)) == kind


@pytest.mark.parametrize("D", WARP_WIDTHS)
def test_kernel_for_takes_evenly_strided_rows_of_its_widths(D):
    """The last position of a prefill (rows S * D apart) stays on the warp
    kernel; rows an odd number of elements apart, or not evenly spaced, or
    an x or scale off 16 bytes, go to the block kernel."""
    sc = torch.ones(D, dtype=bf16)
    last = torch.zeros((4, 9, D), dtype=bf16)[:, -1:]
    assert row_stride(last) == 9 * D and kernel_for(last, sc) == "warp"
    odd = torch.zeros((4, D + 1), dtype=bf16)[:, :D]
    assert row_stride(odd) == D + 1 and kernel_for(odd, sc) == "block"
    uneven = torch.zeros((4, 9, D), dtype=bf16)[:, ::2][:, :3]
    assert row_stride(uneven) is None and kernel_for(uneven, sc) == "block"
    shifted = torch.zeros(4 * D + 1, dtype=bf16)[1:].view(4, D)
    assert shifted.data_ptr() % 16 and kernel_for(shifted, sc) == "block"
    sc_shifted = torch.ones(D + 1, dtype=bf16)[1:]
    assert kernel_for(torch.zeros((4, D), dtype=bf16), sc_shifted) == "block"


def test_kernel_for_reads_no_values():
    """The choice is a function of metadata: two tensors that differ only in
    their values get the same kernel."""
    a, b = torch.zeros((8, 2304), dtype=bf16), torch.randn((8, 2304)).to(bf16)
    sc = torch.ones(2304, dtype=bf16)
    assert kernel_for(a, sc) == kernel_for(b, sc) == "warp"


@pytest.mark.parametrize("launched", ["warp", "block", None])
def test_ops_counts_the_kernel_rmsnorm_cuda_reports(monkeypatch, launched):
    """The counters move by the kernel ``rmsnorm_cuda`` says it launched (None:
    an empty output, nothing launched), and the dispatch runs once."""
    calls = []

    def fake_cuda(x, scale, eps):
        calls.append(eps)
        return "out", launched

    monkeypatch.setattr(ops, "rmsnorm_cuda", fake_cuda)
    x = types.SimpleNamespace(device=torch.device("cuda"))
    before = _counts()
    assert ops.rmsnorm(x, None, 1e-5) == "out"
    moved = tuple(a - b for a, b in zip(_counts(), before))
    assert moved == {"warp": (1, 1, 0), "block": (1, 0, 1), None: (0, 0, 0)}[launched]
    assert calls == [1e-5]


@pytest.mark.parametrize("dtype", [f32, bf16])
def test_cpu_tensors_never_reach_the_dispatch(monkeypatch, dtype):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA dispatch")

    monkeypatch.setattr(ops, "rmsnorm_cuda", refuse)
    monkeypatch.setattr(rms_mod, "kernel_for", refuse)
    x = torch.randn((5, 2304)).to(dtype)
    sc = torch.randn(2304).to(dtype) + 1.0
    before = _counts()
    out = ops.rmsnorm(x, sc)
    assert _counts() == before
    assert torch.equal(out, rmsnorm_ref(x, sc))


def test_rmsnorm_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rms_mod.rmsnorm_cuda(torch.zeros((2, 256), dtype=bf16), torch.ones(256, dtype=bf16))
    with pytest.raises(ValueError, match="no kernel 'tiled'"):
        rms_mod.launch("tiled", None, None, None, 0, 0, 1e-6)
