"""The port's CUDA kernels against their plain versions, on the card.

Skipped on hosts without a CUDA GPU; run them there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import chunked_attention  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

pytestmark = pytest.mark.cuda

# kernel vs plain on the card: f32 sum order; bf16 output rounding
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _t(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)


@pytest.mark.parametrize("shape", [(4, 128), (3, 77, 256), (1, 1, 64), (260, 512),
                                   (2048, 2304), (5, 2303)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(0)
    x = _t(rng, shape, dtype, cuda)
    sc = _t(rng, shape[-1], torch.float32, cuda) + 1.0
    before = rmsnorm.launches
    out = rmsnorm(x, sc)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1 and out.dtype == dtype
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               rmsnorm_ref(x, sc).float().cpu().numpy(),
                               atol=RMS_TOL[dtype])


def test_rmsnorm_kernel_takes_evenly_strided_rows(cuda):
    rng = np.random.default_rng(2)
    x = _t(rng, (4, 9, 256), torch.bfloat16, cuda)[:, -1:]    # rows 9*256 apart
    sc = _t(rng, 256, torch.bfloat16, cuda)
    np.testing.assert_allclose(rmsnorm(x, sc).float().cpu().numpy(),
                               rmsnorm_ref(x, sc).float().cpu().numpy(), atol=5e-2)
    with pytest.raises(ValueError, match="evenly"):
        rmsnorm(_t(rng, (4, 9, 256), torch.bfloat16, cuda)[:, ::2][:, :3], sc)


@pytest.mark.parametrize("case", [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap, q_offset, ring
    (2, 4, 2, 64, 64, 32, True, 0, 0.0, 0, False),
    (1, 8, 8, 128, 128, 64, True, 0, 0.0, 0, False),
    (2, 4, 1, 96, 96, 32, True, 32, 0.0, 0, False),
    (1, 2, 2, 80, 208, 16, False, 0, 0.0, 0, False),
    (1, 2, 1, 33, 65, 32, True, 0, 0.0, 32, False),
    (2, 8, 4, 100, 100, 256, True, 40, 50.0, 0, False),
    (2, 8, 4, 1, 64, 256, True, 0, 50.0, 40, True),
    (2, 8, 4, 1, 64, 128, True, 16, 50.0, 300, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, Hq, Hkv, Sq, Skv, hd, causal, window, cap, off, ring = case
    rng = np.random.default_rng(1)
    q = _t(rng, (B, Sq, Hq, hd), dtype, cuda)
    k, v = _t(rng, (B, Skv, Hkv, hd), dtype, cuda), _t(rng, (B, Skv, Hkv, hd), dtype, cuda)
    kpos = None
    if ring:    # position p at slot p % Skv; unwritten slots hold 2**30
        host = np.full(Skv, 2 ** 30, np.int32)
        for p in range(max(0, off - Skv + 1), off + 1):
            host[p % Skv] = p
        kpos = torch.from_numpy(host).to(cuda)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_pos=kpos, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = chunked_attention(q, k, v, kv_positions=kpos, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=FLASH_TOL[dtype])
