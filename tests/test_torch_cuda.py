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
from repro_torch.kernels.gmm.gmm import kernel_for  # noqa: E402
from repro_torch.kernels.gmm.ops import gmm  # noqa: E402
from repro_torch.kernels.gmm.ref import TILE_M, gmm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.selective_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402

pytestmark = pytest.mark.cuda

# kernel vs plain on the card: f32 sum order; bf16 output rounding
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 flash where |ref| < 1: two bf16 ulps of [0.5, 1), the kernel's output
# rounding and the plain version's (2e-2 admits one ulp of outputs in [2, 4))
FLASH_BF16_BULK = (8e-3, 1.0)
# gmm: f32 sum order over D; bf16: the output is rounded once on both sides,
# so they may differ by one bf16 ulp of the value (2**-7 relative)
GMM_TOL = {torch.float32: (2e-4, 0.0), torch.bfloat16: (1e-2, 2 ** -7)}
# selective scan: f32 sum order over d_state and expf; bf16 as gmm
SCAN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-2, 2 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _t(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)


def _assert_flash_close(out, ref, dtype, bulk=FLASH_BF16_BULK):
    o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(o, r, atol=FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        limit, below = bulk
        bulk = np.abs(r) < below
        np.testing.assert_allclose(o[bulk], r[bulk], atol=limit)


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


def _rms_counts():
    return (rmsnorm.launches, rmsnorm.launches_warp, rmsnorm.launches_block)


# D, the rows' layout, x's dtype, the kernel that serves it
RMS_DISPATCH_CASES = [
    *[(D, layout, torch.bfloat16, "warp" if D in (2304, 4096) and layout != "odd" else "block")
      for D in (2304, 4096, 1000, 257, 6144)
      for layout in ("prefill", "decode", "last", "odd")],
    (2304, "prefill", torch.float32, "block"), (4096, "decode", torch.float32, "block"),
]


@pytest.mark.parametrize("D,layout,dtype,kind", RMS_DISPATCH_CASES)
def test_rmsnorm_kernels_match_plain_by_kernel(cuda, D, layout, dtype, kind):
    """Prefill rows, decode rows, the last position of a prefill (rows 9 * D
    apart) and rows D + 3 apart: each call moves the counter of the kernel
    ``kernel_for`` names; at the warp kernel's rows the block kernel, called
    past the dispatch, gives the same output."""
    from repro_torch.kernels.rmsnorm.rmsnorm import kernel_for as rms_kernel_for
    from repro_torch.kernels.rmsnorm.rmsnorm import launch, row_stride
    rng = np.random.default_rng(13)
    x = {"prefill": lambda: _t(rng, (512, D), dtype, cuda),
         "decode": lambda: _t(rng, (4, D), dtype, cuda),
         "last": lambda: _t(rng, (4, 9, D), dtype, cuda)[:, -1:],
         "odd": lambda: _t(rng, (6, D + 3), dtype, cuda)[:, :D]}[layout]()
    sc = (_t(rng, D, torch.float32, cuda) + 1.0).to(dtype)
    assert rms_kernel_for(x, sc) == kind
    before = _rms_counts()
    out = rmsnorm(x, sc)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_rms_counts(), before))
    assert moved == {"warp": (1, 1, 0), "block": (1, 0, 1)}[kind], moved
    ref = rmsnorm_ref(x, sc).float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref, atol=RMS_TOL[dtype])
    if kind == "warp":
        o = torch.full_like(out, float("nan"))
        launch("block", x, sc, o, x.numel() // D, row_stride(x), 1e-6)
        torch.cuda.synchronize()
        np.testing.assert_allclose(o.float().cpu().numpy(), ref, atol=RMS_TOL[dtype])


def test_rmsnorm_warp_kernel_makes_no_host_sync(cuda):
    rng = np.random.default_rng(14)
    x = _t(rng, (4, 1, 2304), torch.bfloat16, cuda)
    sc = _t(rng, 2304, torch.bfloat16, cuda)
    rmsnorm(x, sc)                              # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rmsnorm(x, sc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               rmsnorm_ref(x, sc).float().cpu().numpy(), atol=5e-2)


@pytest.mark.parametrize("shape", [(12, 64, 256), (12, 512, 256), (3, 7, 9, 1000), (2, 5, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_slots_kernel_matches_plain(cuda, shape, dtype):
    """The block kernel's slot case (a scale row a slot) against
    ``rmsnorm_slots_ref``: one block launch, counted in ``launches_slots``
    too; rows_per_scale 0 keeps the shared scale."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_slots
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_slots_ref
    from repro_torch.kernels.rmsnorm.rmsnorm import launch, row_stride
    rng = np.random.default_rng(15)
    x = _t(rng, shape, dtype, cuda)
    sc = (_t(rng, (shape[0], shape[-1]), torch.float32, cuda) + 1.0).to(dtype)
    before = (rmsnorm.launches_block, rmsnorm.launches_slots, rmsnorm.launches_warp)
    out = rmsnorm_slots(x, sc)
    torch.cuda.synchronize()
    assert (rmsnorm.launches_block, rmsnorm.launches_slots, rmsnorm.launches_warp) == (
        before[0] + 1, before[1] + 1, before[2])
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               rmsnorm_slots_ref(x, sc).float().cpu().numpy(),
                               atol=RMS_TOL[dtype])
    shared = torch.full_like(x, float("nan"))
    D = shape[-1]
    launch("block", x, sc[1], shared, x.numel() // D, row_stride(x), 1e-6)
    torch.cuda.synchronize()
    np.testing.assert_allclose(shared.float().cpu().numpy(),
                               rmsnorm_ref(x, sc[1]).float().cpu().numpy(), atol=RMS_TOL[dtype])
    with pytest.raises(ValueError, match="scale shape"):
        rmsnorm_slots(x, sc[:1])


def test_rmsnorm_slots_kernel_makes_no_host_sync(cuda):
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_slots
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_slots_ref
    rng = np.random.default_rng(16)
    x = _t(rng, (12, 64, 256), torch.float32, cuda)
    sc = _t(rng, (12, 256), torch.float32, cuda)
    rmsnorm_slots(x, sc)                        # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rmsnorm_slots(x, sc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_allclose(out.cpu().numpy(), rmsnorm_slots_ref(x, sc).cpu().numpy(),
                               atol=RMS_TOL[torch.float32])


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
    # phi3's and kimi's head dims, 96 and 112: prefill, ragged, decode on a ring
    (2, 4, 4, 100, 100, 96, True, 40, 50.0, 0, False),
    (1, 8, 1, 33, 65, 112, True, 0, 0.0, 32, False),
    (2, 8, 8, 1, 64, 96, True, 0, 0.0, 300, True),
    (2, 16, 2, 1, 64, 112, True, 16, 30.0, 40, True),
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
    _assert_flash_close(out, ref, dtype)


def _ring(L, pos, written=None):
    """kpos of a ring cache of L slots holding positions <= pos (p at p % L),
    or only the first ``written`` positions; unwritten slots hold 2**30."""
    host = np.full(L, 2 ** 30, np.int32)
    first = 0 if written is not None else max(0, pos - L + 1)
    last = written - 1 if written is not None else pos
    for p in range(first, last + 1):
        host[p % L] = p
    return host


# bf16 cases of the two bf16 kernels: B, Hq, Hkv, Sq, Skv, hd, window, softcap,
# q_offset, ring (None: kv_pos = None; else (pos, written)), kernel
BF16_CASES = [
    *[(2, 4, 2, 96, 96, hd, 0, 50.0, 0, None, "tensor_core") for hd in (16, 32, 64, 128, 256)],
    *[(2, 8, 4, 1, 300, hd, 0, 50.0, 250, (250, 251), "split_kv") for hd in (16, 32, 64, 128, 256)],
    (1, 2, 1, 33, 65, 32, 0, 0.0, 32, None, "tensor_core"),         # ragged tiles
    (2, 8, 4, 100, 100, 256, 40, 50.0, 0, None, "tensor_core"),
    (4, 8, 4, 1, 1024, 256, 0, 50.0, 7, (7, 8), "split_kv"),       # 8 of 1024 written
    (4, 32, 8, 1, 1024, 128, 0, 0.0, 519, (519, 520), "split_kv"),  # jamba's decode
    (2, 8, 4, 1, 1024, 256, 256, 50.0, 1500, (1500, None), "split_kv"),   # wrapped, window
    (1, 8, 4, 8, 256, 64, 32, 30.0, 120, (127, None), "split_kv"),      # Sq x G = 16
    (1, 1, 1, 17, 256, 64, 32, 30.0, 120, (136, None), "tensor_core"),  # Sq x G = 17
    (1, 4, 2, 40, 200, 128, 0, 0.0, 300, (339, None), "tensor_core"),   # prefill onto a ring
    # the zoo's groups at hd 128: yi 32 over 4, grok 48 over 8 with softcap
    # 30, starcoder2 24 over 2 (groups of 8, 6, 12), prefill and decode
    *[case for Hq, Hkv, cap in ((32, 4, 0.0), (48, 8, 30.0), (24, 2, 0.0)) for case in (
        (2, Hq, Hkv, 128, 128, 128, 0, cap, 0, None, "tensor_core"),
        (4, Hq, Hkv, 1, 1024, 128, 0, cap, 519, (519, 520), "split_kv"),
        (4, Hq, Hkv, 1, 1024, 128, 0, cap, 1500, (1500, None), "split_kv"))],
    # phi3's and kimi's head dims on both bf16 kernels, then their groups as
    # served: phi3 32 over 32 (MHA) at hd 96, kimi 64 over 8 at hd 112
    *[(2, 4, 2, 96, 96, hd, 0, 50.0, 0, None, "tensor_core") for hd in (96, 112)],
    *[(2, 8, 4, 1, 300, hd, 0, 50.0, 250, (250, 251), "split_kv") for hd in (96, 112)],
    *[case for Hq, Hkv, hd in ((32, 32, 96), (64, 8, 112)) for case in (
        (2, Hq, Hkv, 128, 128, hd, 0, 0.0, 0, None, "tensor_core"),
        (4, Hq, Hkv, 1, 1024, hd, 0, 0.0, 519, (519, 520), "split_kv"),
        (4, Hq, Hkv, 1, 1024, hd, 0, 0.0, 1500, (1500, None), "split_kv"))],
]


@pytest.mark.parametrize("case", BF16_CASES)
def test_flash_bf16_kernels_match_plain(cuda, case):
    B, Hq, Hkv, Sq, Skv, hd, window, cap, off, ring, kind = case
    rng = np.random.default_rng(5)
    q = _t(rng, (B, Sq, Hq, hd), torch.bfloat16, cuda)
    k = _t(rng, (B, Skv, Hkv, hd), torch.bfloat16, cuda)
    v = _t(rng, (B, Skv, Hkv, hd), torch.bfloat16, cuda)
    kpos = None if ring is None else torch.from_numpy(_ring(Skv, *ring)).to(cuda)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    counts = (flash_attention.launches_split_kv, flash_attention.launches_tensor_core)
    out = flash_attention(q, k, v, kv_pos=kpos, **kw)
    torch.cuda.synchronize()
    moved = (flash_attention.launches_split_kv - counts[0],
             flash_attention.launches_tensor_core - counts[1])
    assert moved == ((1, 0) if kind == "split_kv" else (0, 1)), moved
    ref = chunked_attention(q, k, v, kv_positions=kpos, **kw)
    _assert_flash_close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("Sq,Hq,Hkv,kind", [(1, 8, 4, "split_kv"), (512, 8, 4, "tensor_core"),
                                            (1, 32, 8, "split_kv"), (64, 32, 8, "tensor_core")])
def test_flash_bf16_call_moves_exactly_one_counter(cuda, Sq, Hq, Hkv, kind):
    rng = np.random.default_rng(6)
    q = _t(rng, (2, Sq, Hq, 128), torch.bfloat16, cuda)
    k, v = (_t(rng, (2, 512, Hkv, 128), torch.bfloat16, cuda) for _ in range(2))
    before = (flash_attention.launches, flash_attention.launches_split_kv,
              flash_attention.launches_tensor_core)
    flash_attention(q, k, v, q_offset=512 - Sq)
    after = (flash_attention.launches, flash_attention.launches_split_kv,
             flash_attention.launches_tensor_core)
    assert after[0] == before[0] + 1
    assert (after[1] - before[1], after[2] - before[2]) == \
        ((1, 0) if kind == "split_kv" else (0, 1))


# served prefill shapes (batch 4, prompt 512): gemma2-2b's local layer (hd
# 256, window 4096, softcap 50), phi3-mini-3.8b's (hd 96, 32 over 32) and
# kimi-k2's (hd 112, 64 over 8): B, Hq, Hkv, hd, window, softcap
LARGE_OUT_CASES = [(4, 8, 4, 256, 4096, 50.0), (4, 32, 32, 96, 0, 0.0), (4, 64, 8, 112, 0, 0.0)]
# against the f32 plain version the bulk's error is the kernel's own output
# rounding, half an ulp of [0.5, 1) (1.95e-3) when P reaches the PV product
# whole; with P rounded to bf16 once it read 6.8e-3 to 7.1e-3 on an H100
LARGE_OUT_BULK = (4e-3, 1.0)


@pytest.mark.parametrize("B,Hq,Hkv,hd,window,cap", LARGE_OUT_CASES)
def test_flash_prefill_holds_where_out_reaches_4(cuda, B, Hq, Hkv, hd, window, cap):
    """v ~ N(0, 2^2), clipped to |v| <= 7.9, puts hundreds of outputs in [4,
    8) (rows that see few keys; none reaches 8). The tensor-core kernel's
    bf16 output is held to the plain version run on f32 copies of the same
    bf16 inputs, the reference's arithmetic (an f32 p times an f32 v): its
    own rounding costs up to half an ulp there, 1.5625e-2, within the 2e-2
    limit, and the bulk (|ref| < 1) is held to 4e-3 (LARGE_OUT_BULK)."""
    S = 512
    gen = torch.Generator(device=cuda).manual_seed(29)
    q = torch.randn((B, S, Hq, hd), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=cuda).to(torch.bfloat16)
    v = (torch.randn((B, S, Hkv, hd), generator=gen, device=cuda) * 2.0).clamp_(-7.9, 7.9)
    v = v.to(torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=cap)
    before = flash_attention.launches_tensor_core
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches_tensor_core == before + 1
    ref = chunked_attention(q.float(), k.float(), v.float(), **kw)
    mag = ref.abs()
    assert ((mag >= 4) & (mag < 8)).sum().item() >= 100 and mag.max().item() < 8
    _assert_flash_close(out, ref, torch.bfloat16, bulk=LARGE_OUT_BULK)


def test_flash_decode_makes_no_host_sync(cuda):
    rng = np.random.default_rng(7)
    q = _t(rng, (4, 1, 8, 256), torch.bfloat16, cuda)
    k, v = (_t(rng, (4, 1024, 4, 256), torch.bfloat16, cuda) for _ in range(2))
    kpos = torch.from_numpy(_ring(1024, 519, 520)).to(cuda)
    flash_attention(q, k, v, kv_pos=kpos, q_offset=519, softcap=50.0)   # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = flash_attention(q, k, v, kv_pos=kpos, q_offset=519, softcap=50.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = chunked_attention(q, k, v, kv_positions=kpos, q_offset=519, softcap=50.0)
    _assert_flash_close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("sizes,D,F", [
    ([30, 0, 17, 40, 13], 32, 48), ([4, 4, 4, 4], 16, 16), ([128], 64, 32),
    ([0, 0, 50], 32, 64),                       # tests/test_kernels.py's cases
    ([0, 3, 0, 5], 4096, 200),                  # decode-like: few rows, long K
    ([70, 0, 129, 1], 100, 130),                # D, F off the tile and the vector width
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain(cuda, sizes, D, F, dtype):
    rng = np.random.default_rng(3)
    x = _t(rng, (sum(sizes) + 5, D), dtype, cuda)        # 5 rows past the groups
    w = (_t(rng, (len(sizes), D, F), torch.float32, cuda) / D ** 0.5).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    before = gmm.launches
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert gmm.launches == before + 1 and out.dtype == dtype
    ref = gmm_ref(x, w, gs)
    atol, rtol = GMM_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=atol, rtol=rtol)
    assert not out[sum(sizes):].any()


def _gmm_counts():
    return (gmm.launches, gmm.launches_tiled, gmm.launches_decode, gmm.launches_small)


# the tiled kernel's cases: sizes, rows past the groups, D, F
GMM_TILED_CASES = [
    ([0, 1, 200, 77, 0, 300], 0, 136, 264),     # empty and 1-row groups, off 128
    ([130, 1, 0, 5], 50, 64, 128),              # rows past the last group
    ([100, 28, 0, 0], 0, 200, 328),             # D, F multiples of 8, not of 32
    ([TILE_M], 0, 72, 40),              # the threshold: one tile of rows
    ([203, 321, 0, 1, 255, 257, 130, 3], 3, 1024, 520),
]


@pytest.mark.parametrize("sizes,tail,D,F", GMM_TILED_CASES)
def test_gmm_tiled_kernel_matches_plain(cuda, sizes, tail, D, F):
    rng = np.random.default_rng(8)
    x = _t(rng, (sum(sizes) + tail, D), torch.bfloat16, cuda)
    w = (_t(rng, (len(sizes), D, F), torch.float32, cuda) / D ** 0.5).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    assert kernel_for(x, w) == "tiled"
    before = _gmm_counts()
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_gmm_counts(), before)) == (1, 1, 0, 0)
    atol, rtol = GMM_TOL[torch.bfloat16]
    np.testing.assert_allclose(out.float().cpu().numpy(), gmm_ref(x, w, gs).float().cpu().numpy(),
                               atol=atol, rtol=rtol)
    assert not out[sum(sizes):].any()


@pytest.mark.parametrize("T,dtype,kind", [(8, torch.bfloat16, "decode"),
                                          (8, torch.float32, "small"),
                                          (TILE_M - 1, torch.bfloat16, "decode"),
                                          (TILE_M, torch.bfloat16, "tiled"),
                                          (512, torch.bfloat16, "tiled"),
                                          (512, torch.float32, "small")])
def test_gmm_call_moves_exactly_one_counter(cuda, T, dtype, kind):
    rng = np.random.default_rng(9)
    x = _t(rng, (T, 256), dtype, cuda)
    w = (_t(rng, (4, 256, 384), torch.float32, cuda) / 16).to(dtype)
    gs = torch.tensor([T // 2, 0, T - T // 2 - 1, 1], dtype=torch.int32, device=cuda)
    before = _gmm_counts()
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_gmm_counts(), before))
    assert moved == {"tiled": (1, 1, 0, 0), "decode": (1, 0, 1, 0),
                     "small": (1, 0, 0, 1)}[kind], moved
    atol, rtol = GMM_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), gmm_ref(x, w, gs).float().cpu().numpy(),
                               atol=atol, rtol=rtol)


def test_gmm_tiled_kernel_makes_no_host_sync(cuda):
    rng = np.random.default_rng(10)
    x = _t(rng, (512, 128), torch.bfloat16, cuda)
    w = (_t(rng, (4, 128, 256), torch.float32, cuda) / 12).to(torch.bfloat16)
    gs = torch.tensor([100, 0, 300, 112], dtype=torch.int32, device=cuda)
    gmm(x, w, gs)                               # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gmm(x, w, gs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    atol, rtol = GMM_TOL[torch.bfloat16]
    np.testing.assert_allclose(out.float().cpu().numpy(), gmm_ref(x, w, gs).float().cpu().numpy(),
                               atol=atol, rtol=rtol)


# the decode kernel's cases (chip_smoke.py phase 2): sizes, rows past the
# groups, D, F
GMM_DECODE_CASES = [
    ([0, 1, 0, 0], 0, 256, 384),                # T = 1
    ([16, 0, 1], 0, 128, 192),                  # a group of exactly one slot
    ([17, 2, 0], 0, 128, 192),                  # a group of two slots
    ([33, 0, 0, 5], 0, 264, 128),               # three slots
    ([3, 0, 0, 0, 4, 0, 0, 1], 0, 512, 256),    # empty groups between full ones
    ([5, 0, 9], 20, 256, 320),                  # rows past the last group, T < 128
    ([40, 28, 0, 30], 0, 200, 328),             # D, F multiples of 8, not of 64
    ([60, 0, 67], 0, 256, 256),                 # T = 127, the last row count below the edge
    ([2, 0, 1, 0, 0, 1, 0, 0, 2, 0, 0, 0, 1, 0, 0, 1], 0, 4096, 1024),   # jamba's routing
]


@pytest.mark.parametrize("sizes,tail,D,F", GMM_DECODE_CASES)
def test_gmm_decode_kernel_matches_plain(cuda, sizes, tail, D, F):
    rng = np.random.default_rng(11)
    x = _t(rng, (sum(sizes) + tail, D), torch.bfloat16, cuda)
    w = (_t(rng, (len(sizes), D, F), torch.float32, cuda) / D ** 0.5).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    assert kernel_for(x, w) == "decode"
    before = _gmm_counts()
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_gmm_counts(), before)) == (1, 0, 1, 0)
    atol, rtol = GMM_TOL[torch.bfloat16]
    np.testing.assert_allclose(out.float().cpu().numpy(), gmm_ref(x, w, gs).float().cpu().numpy(),
                               atol=atol, rtol=rtol)
    assert not out[sum(sizes):].any()


@pytest.mark.parametrize("step,proj", [("prefill", "up"), ("prefill", "down"),
                                       ("decode", "up"), ("decode", "down")])
def test_gmm_at_grok_widths_matches_plain(cuda, step, proj):
    """grok-1's expert FFN: 8 experts of 6144 -> 32768 (1.61e9 weights, 3.2
    GB: byte offsets past 2^31) and back (K = 32768), at the tiled kernel's
    prefill rows (4096) and the decode kernel's 8. Inputs are drawn on the
    card."""
    D, F = (6144, 32768) if proj == "up" else (32768, 6144)
    sizes = [700, 300, 0, 1200, 500, 600, 400, 396] if step == "prefill" else [2, 1, 0, 1, 2, 0, 1, 1]
    gen = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((sum(sizes), D), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((len(sizes), D, F), generator=gen, device=cuda) * D ** -0.5).to(torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    kind = {"prefill": "tiled", "decode": "decode"}[step]
    assert kernel_for(x, w) == kind
    before = _gmm_counts()
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_gmm_counts(), before)) == \
        {"tiled": (1, 1, 0, 0), "decode": (1, 0, 1, 0)}[kind]
    ref = gmm_ref(x, w, gs)
    atol, rtol = GMM_TOL[torch.bfloat16]
    excess = ((out.float() - ref.float()).abs() - rtol * ref.float().abs()).max().item()
    assert excess <= atol, excess


@pytest.mark.parametrize("kind,proj", [("tiled", "up"), ("tiled", "down"),
                                       ("decode", "up"), ("decode", "down")])
def test_gmm_at_kimi_experts_matches_plain(cuda, kind, proj):
    """kimi-k2's expert FFN: 384 experts of 7168 -> 2048 (5.6e9 weights, 11.3
    GB) and back, most groups empty: 2048 rows over 48 experts on the tiled
    kernel, a decode step's 32 rows (batch 4, top-8) over 32 experts on the
    decode kernel. Every block walks all 384 group sizes. Inputs are drawn on
    the card."""
    E = 384
    D, F = (7168, 2048) if proj == "up" else (2048, 7168)
    rng = np.random.default_rng(30)
    sizes = np.zeros(E, np.int64)
    if kind == "tiled":
        sizes[rng.choice(E, 48, replace=False)] = rng.multinomial(2048, np.full(48, 1 / 48))
    else:
        for _ in range(4):
            sizes[rng.choice(E, 8, replace=False)] += 1
    sizes = sizes.tolist()
    gen = torch.Generator(device=cuda).manual_seed(30)
    x = torch.randn((sum(sizes), D), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.empty((E, D, F), dtype=torch.bfloat16, device=cuda)
    for e in range(E):
        w[e] = torch.randn((D, F), generator=gen, device=cuda) * D ** -0.5
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    assert kernel_for(x, w) == kind
    before = _gmm_counts()
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_gmm_counts(), before)) == \
        {"tiled": (1, 1, 0, 0), "decode": (1, 0, 1, 0)}[kind]
    ref = gmm_ref(x, w, gs)
    atol, rtol = GMM_TOL[torch.bfloat16]
    excess = ((out.float() - ref.float()).abs() - rtol * ref.float().abs()).max().item()
    assert excess <= atol, excess


def test_gmm_decode_kernel_makes_no_host_sync(cuda):
    rng = np.random.default_rng(12)
    x = _t(rng, (8, 512), torch.bfloat16, cuda)
    w = (_t(rng, (16, 512, 256), torch.float32, cuda) / 22).to(torch.bfloat16)
    gs = torch.tensor([2, 0, 1, 0, 0, 1, 0, 0, 2, 0, 0, 0, 1, 0, 0, 1], dtype=torch.int32,
                      device=cuda)
    assert kernel_for(x, w) == "decode"
    gmm(x, w, gs)                               # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gmm(x, w, gs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    atol, rtol = GMM_TOL[torch.bfloat16]
    np.testing.assert_allclose(out.float().cpu().numpy(), gmm_ref(x, w, gs).float().cpu().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,S,di,st", [(1, 64, 32, 4), (2, 128, 64, 8), (1, 32, 16, 16),
                                       (2, 1, 300, 16), (3, 77, 130, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(cuda, B, S, di, st, dtype):
    rng = np.random.default_rng(4)
    u = _t(rng, (B, S, di), dtype, cuda)
    dt = (_t(rng, (B, S, di), torch.float32, cuda).abs() * 0.1 + 0.01).to(dtype)
    a = -_t(rng, (di, st), torch.float32, cuda).abs()
    bc = _t(rng, (B, S, 2 * st + 3), dtype, cuda)       # b, c strided, as the model slices them
    b, c = bc[..., :st], bc[..., st + 3:]
    d = _t(rng, (di,), dtype, cuda)
    h0 = _t(rng, (B, di, st), torch.float32, cuda) * 0.2
    before = selective_scan.launches
    y, hT = selective_scan(u, dt, a, b, c, d, h0)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    assert y.dtype == dtype and hT.dtype == torch.float32
    ry, rh = selective_scan_ref(u, dt, a, b, c, d, h0)
    atol, rtol = SCAN_TOL[dtype]
    np.testing.assert_allclose(y.float().cpu().numpy(), ry.float().cpu().numpy(),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(hT.cpu().numpy(), rh.cpu().numpy(), atol=2e-5)


def _scan_counts():
    return (selective_scan.launches, selective_scan.launches_prefill,
            selective_scan.launches_sequential)


# B, S, di, st, b/c strided, the draws: S = 77 (two tiles, runs cut short),
# S = 600 (ten tiles, a carry from each to the next), di = 130 (an item of
# 2 channels past 128), strided b and c, S = 31 and 32 (both sides of the
# edge) with the JAX tests' draws (A = -|N(0, 1)|: states that barely decay);
# jamba's prefill and decode with the mamba block's (A = -(1..16), dt =
# softplus near its init)
SCAN_DISPATCH_CASES = [(2, 77, 40, 5, False, "jax"), (2, 600, 24, 16, False, "jax"),
                       (1, 96, 130, 16, False, "jax"), (2, 300, 64, 16, True, "jax"),
                       (2, 31, 64, 16, True, "jax"), (2, 32, 64, 16, True, "jax"),
                       (4, 512, 8192, 16, True, "model"), (4, 1, 8192, 16, True, "model")]


def _scan_inputs(rng, B, S, di, st, strided, draw, dtype, dev):
    u = _t(rng, (B, S, di), dtype, dev)
    if draw == "model":
        dt = torch.nn.functional.softplus(
            _t(rng, (B, S, di), torch.float32, dev) * 0.5 + np.log(np.e - 1)).to(dtype)
        a = -torch.arange(1, st + 1, dtype=torch.float32, device=dev).expand(di, st).contiguous()
    else:
        dt = (_t(rng, (B, S, di), torch.float32, dev).abs() * 0.1 + 0.01).to(dtype)
        a = -_t(rng, (di, st), torch.float32, dev).abs()
    if strided:     # as the model slices them out of one projection
        bc = _t(rng, (B, S, 2 * st + 3), dtype, dev)
        b, c = bc[..., :st], bc[..., st + 3:]
    else:
        b, c = _t(rng, (B, S, st), dtype, dev), _t(rng, (B, S, st), dtype, dev)
    d = _t(rng, (di,), dtype, dev)
    h0 = _t(rng, (B, di, st), torch.float32, dev) * 0.2
    return u, dt, a, b, c, d, h0


@pytest.mark.parametrize("B,S,di,st,strided,draw", SCAN_DISPATCH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_match_plain_by_kernel(cuda, B, S, di, st, strided, draw, dtype):
    """Each call moves the counter of the kernel ``kernel_for`` names (the
    prefill kernel from 32 steps). The sequential kernel sums in the plain
    version's order and is held to it; the prefill kernel sums in another
    (the associative form), and is held to the plain version carried out in
    f64: over hundreds of steps that barely decay, the f32 plain version's
    own rounding reaches the f32 limit (see
    ``test_scan_prefill_kernel_is_nearer_f64_than_the_f32_plain_version``).
    The prefill kernel is also held past the dispatch where the sequential one serves, and the
    sequential one past the dispatch at jamba's prefill; with the JAX tests'
    draws at S >= 32 its f32 sums stray up to the limit from the plain
    version's, so it is not held there."""
    from repro_torch.kernels.selective_scan.selective_scan import kernel_for as scan_kernel_for
    from repro_torch.kernels.selective_scan.selective_scan import launch
    args = _scan_inputs(np.random.default_rng(15), B, S, di, st, strided, draw, dtype, cuda)
    kind = scan_kernel_for(args[0])
    assert kind == ("prefill" if S >= 32 else "sequential")
    before = _scan_counts()
    y, hT = selective_scan(*args)
    torch.cuda.synchronize()
    moved = tuple(x - z for x, z in zip(_scan_counts(), before))
    assert moved == {"prefill": (1, 1, 0), "sequential": (1, 0, 1)}[kind], moved
    yardstick = {"sequential": selective_scan_ref(*args),
                 "prefill": selective_scan_ref(*(x.double() for x in args))}
    atol, rtol = SCAN_TOL[dtype]
    other = "sequential" if kind == "prefill" else "prefill"
    checked = [(kind, y, hT)]
    if other == "prefill" or draw == "model":
        yo, ho = torch.full_like(y, float("nan")), torch.full_like(hT, float("nan"))
        launch(other, *args, yo, ho)
        torch.cuda.synchronize()
        checked.append((other, yo, ho))
    for k, yk, hk in checked:
        ry, rh = yardstick[k]
        np.testing.assert_allclose(yk.float().cpu().numpy(), ry.double().cpu().numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)
        np.testing.assert_allclose(hk.cpu().numpy(), rh.cpu().numpy(), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("B,S,di,st", [(2, 600, 24, 16), (4, 600, 130, 16), (2, 1024, 64, 16)])
def test_scan_prefill_kernel_is_nearer_f64_than_the_f32_plain_version(cuda, B, S, di, st):
    """Why the prefill kernel is held to the plain version carried out in f64:
    with states that barely decay (the JAX tests' draws), the f32 plain
    version's step-by-step rounding strays past the f32 limit over hundreds
    of steps, while the kernel (da on the SFU, each run's A and the carry
    from tile to tile in one accurate exponential a run) stays within it and
    nearer the f64 scan than the f32 plain version is."""
    from repro_torch.kernels.selective_scan.selective_scan import launch
    args = _scan_inputs(np.random.default_rng(17), B, S, di, st, False, "jax", torch.float32,
                        cuda)
    ry, rh = selective_scan_ref(*(x.double() for x in args))
    y, hT = torch.full_like(args[0], float("nan")), torch.full_like(args[-1], float("nan"))
    launch("prefill", *args, y, hT)
    py, ph = selective_scan_ref(*args)
    err = {name: max((yk.double() - ry).abs().max().item(), (hk.double() - rh).abs().max().item())
           for name, (yk, hk) in {"prefill": (y, hT), "f32 plain": (py, ph)}.items()}
    assert err["prefill"] <= err["f32 plain"], err
    assert err["prefill"] <= SCAN_TOL[torch.float32][0], err


def test_scan_prefill_kernel_makes_no_host_sync(cuda):
    rng = np.random.default_rng(16)
    u = _t(rng, (2, 256, 64), torch.bfloat16, cuda)
    dt = (_t(rng, (2, 256, 64), torch.float32, cuda).abs() * 0.1 + 0.01).to(torch.bfloat16)
    a = -_t(rng, (64, 16), torch.float32, cuda).abs()
    b, c = (_t(rng, (2, 256, 16), torch.bfloat16, cuda) for _ in range(2))
    d = _t(rng, (64,), torch.bfloat16, cuda)
    h0 = _t(rng, (2, 64, 16), torch.float32, cuda) * 0.2
    selective_scan(u, dt, a, b, c, d, h0)           # build, warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, hT = selective_scan(u, dt, a, b, c, d, h0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ry, rh = selective_scan_ref(u, dt, a, b, c, d, h0)
    atol, rtol = SCAN_TOL[torch.bfloat16]
    np.testing.assert_allclose(y.float().cpu().numpy(), ry.float().cpu().numpy(),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(hT.cpu().numpy(), rh.cpu().numpy(), atol=2e-5)


def test_selective_scan_kernel_refuses_a_large_state(cuda):
    u = torch.zeros((1, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        selective_scan(u, u, torch.zeros((8, 17), device=cuda), torch.zeros((1, 2, 17), device=cuda),
                       torch.zeros((1, 2, 17), device=cuda), torch.zeros(8, device=cuda),
                       torch.zeros((1, 8, 17), device=cuda))


# ---------------------------------------------------------------------------
# gradients: each op's kernel Function against the plain version, on the card
# ---------------------------------------------------------------------------
def _grads_of(fn, args, cts):
    """Gradients of sum(out * ct) over ``fn``'s outputs with respect to the
    arguments that require one, and the outputs."""
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * ct).sum() for o, ct in zip(outs, cts))
    wrt = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
    return outs, torch.autograd.grad(loss, wrt)


def _check_function_grads(op, plain, args, cts, tol, counted=None):
    """The op on CUDA tensors that require a gradient: one forward launch
    (the kernel, on ``counted``'s counter: ``op``'s own by default), a
    ``PlainGrad`` node, and the plain version's gradients."""
    counted = counted or op
    before = counted.launches
    outs, grads = _grads_of(op, args, cts)
    torch.cuda.synchronize()
    assert counted.launches == before + 1, "one kernel launch, in the forward only"
    assert all(type(o.grad_fn).__name__ == "PlainGradBackward" for o in outs)
    ref_outs, ref_grads = _grads_of(plain, args, cts)
    for o, r in zip(outs, ref_outs):
        np.testing.assert_allclose(o.detach().float().cpu().numpy(),
                                   r.detach().float().cpu().numpy(),
                                   atol=tol[0], rtol=tol[1])
    for g, r in zip(grads, ref_grads):
        assert g.dtype == r.dtype
        np.testing.assert_allclose(g.float().cpu().numpy(), r.float().cpu().numpy(),
                                   atol=tol[0], rtol=tol[1])


def _leaf(rng, shape, dtype, dev, scale=1.0):
    return (_t(rng, shape, torch.float32, dev) * scale).to(dtype).requires_grad_(True)


@pytest.mark.parametrize("rows,D", [(256, 2304), (64, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_grads_match_plain(cuda, rows, D, dtype):
    rng = np.random.default_rng(20)
    x = _leaf(rng, (rows, D), dtype, cuda)
    sc = (_t(rng, D, torch.float32, cuda) + 1.0).to(dtype).requires_grad_(True)
    ct = _t(rng, (rows, D), torch.float32, cuda)
    _check_function_grads(rmsnorm, rmsnorm_ref, (x, sc), (ct,), (RMS_TOL[dtype], 0.0))


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window,softcap", [(2, 128, 8, 4, 256, 64, 50.0),
                                                          (1, 96, 8, 2, 128, 0, 0.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_grads_match_plain(cuda, B, S, Hq, Hkv, hd, window, softcap, dtype):
    """Sq = Skv as in training: the tensor-core kernel in bf16, the FMA
    kernel in f32."""
    rng = np.random.default_rng(21)
    q = _leaf(rng, (B, S, Hq, hd), dtype, cuda)
    k, v = _leaf(rng, (B, S, Hkv, hd), dtype, cuda), _leaf(rng, (B, S, Hkv, hd), dtype, cuda)
    ct = _t(rng, (B, S, Hq, hd), torch.float32, cuda)
    kw = dict(causal=True, window=window, softcap=softcap)
    _check_function_grads(lambda *a: flash_attention(*a, **kw),
                          lambda *a: chunked_attention(*a, **kw),
                          (q, k, v), (ct,), (FLASH_TOL[dtype], 0.0), counted=flash_attention)


@pytest.mark.parametrize("sizes,D,F", [([100, 0, 60, 96], 64, 96), ([3, 5], 32, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_function_grads_match_plain(cuda, sizes, D, F, dtype):
    """The tiled kernel (bf16, 256 rows), the decode kernel (bf16, 8 rows),
    the small one (f32); group_sizes takes no gradient."""
    rng = np.random.default_rng(22)
    x = _leaf(rng, (sum(sizes), D), dtype, cuda)
    w = _leaf(rng, (len(sizes), D, F), dtype, cuda, scale=D ** -0.5)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    ct = _t(rng, (sum(sizes), F), torch.float32, cuda)
    _check_function_grads(gmm, gmm_ref, (x, w, gs), (ct,), GMM_TOL[dtype])


@pytest.mark.parametrize("S", [64, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_function_grads_match_plain(cuda, S, dtype):
    """The prefill kernel (S = 64) and the sequential one (S = 8); the
    final state's gradient missing, as in training."""
    rng = np.random.default_rng(23)
    args = [t.detach().clone().requires_grad_(True)
            for t in _scan_inputs(rng, 2, S, 40, 16, False, "model", dtype, cuda)]
    ct = _t(rng, (2, S, 40), torch.float32, cuda)
    _check_function_grads(selective_scan, selective_scan_ref, args, (ct,), SCAN_TOL[dtype])


@pytest.mark.parametrize("pattern", [None, (("mamba", "moe"), ("attn", "mlp"))])
def test_reduced_train_step_on_card_matches_cpu(cuda, pattern):
    """One RMSProp and one AdamW step of the reduced gemma2 / hybrid (f32,
    seq 40: the f32 kernels, the scan's prefill kernel) on the card and on
    the CPU from the same weights: loss, aux, grad norm; and RMSProp's
    weights (AdamW's first step is lr * sign(g), which a gradient at the
    rounding level may flip)."""
    import dataclasses
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.schema import init_params
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train.steps import make_train_step
    arch = "gemma2-2b" if pattern is None else "jamba-v0.1-52b"
    cfg = get_config(arch).reduced()
    if pattern is not None:
        cfg = dataclasses.replace(cfg, pattern=pattern, n_layers=2)
    chain = torch.from_numpy(np.random.default_rng(24).integers(0, cfg.vocab_size, (2, 41)))
    batch = {"tokens": chain[:, :-1], "labels": chain[:, 1:]}
    for opt in ("rmsprop", "adamw"):
        tc = TrainConfig(optimizer=opt, learning_rate=1e-3)
        out = {}
        for dev in ("cpu", "cuda"):
            params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(dev)
            step = make_train_step(cfg, tc)
            params, _, m = step(params, init_opt_state(tc, params),
                                {k: v.to(dev) for k, v in batch.items()})
            out[dev] = params, {k: v.item() for k, v in m.items()}
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(out["cuda"][1][key], out["cpu"][1][key],
                                       rtol=1e-4, atol=1e-5, err_msg=f"{opt} {key}")
        if opt == "rmsprop":
            cpu = dict(out["cpu"][0].named_parameters())
            for n, t in out["cuda"][0].named_parameters():
                np.testing.assert_allclose(t.detach().cpu().numpy(), cpu[n].detach().numpy(),
                                           atol=1e-6, err_msg=n)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_launches_the_kernels_again_and_keeps_the_grads(cuda, remat):
    """Under remat each repetition's forward runs again in the backward, so
    its kernels launch twice (the final norm in ``lm_loss`` is outside the
    checkpoint: once); the gradients are those without remat."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import forward
    from repro_torch.models.schema import init_params
    from repro_torch.train.steps import lm_loss
    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(cuda)
    params.requires_grad_(True)
    chain = torch.from_numpy(np.random.default_rng(25).integers(0, cfg.vocab_size, (2, 41)))
    chain = chain.to(cuda)

    def grads(mode):
        rms0, fa0 = rmsnorm.launches, flash_attention.launches
        h, _, aux = forward(cfg, params, {"tokens": chain[:, :-1]}, mode="train", remat=mode)
        g = torch.autograd.grad(lm_loss(cfg, params, h, chain[:, 1:]) + aux,
                                list(params.parameters()))
        torch.cuda.synchronize()
        return g, rmsnorm.launches - rms0, flash_attention.launches - fa0

    base, rms_none, fa_none = grads("none")
    got, rms, fa = grads(remat)
    assert (rms_none, fa_none) == (2 * cfg.n_layers + 1, cfg.n_layers)
    assert (rms, fa) == (2 * (rms_none - 1) + 1, 2 * fa_none), (rms, fa)
    for g, b in zip(got, base):
        np.testing.assert_allclose(g.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["yi-9b", "grok-1-314b", "starcoder2-3b", "phi3-mini-3.8b",
                                  "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_reduced_zoo_served_on_card_matches_cpu(cuda, arch, n_layers):
    """The reduced yi-9b, grok-1, starcoder2, phi3 and kimi (one layer, and a
    2-layer stack) serve the same greedy tokens on the card (the kernels;
    LayerNorm and GELU plain) and on the CPU (the plain path)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models.schema import init_params
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(26)
    prompts = [rng.integers(0, cfg.vocab_size, size=12) for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params.to(dev), batch_size=3, max_seq=64, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=6))
        outs[dev] = [r.output for r in eng.run_batch()]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("arch,dims", [
    ("phi3-mini-3.8b", dict(head_dim=96, d_model=384, n_kv_heads=4)),
    ("kimi-k2-1t-a32b", dict(head_dim=112, d_model=448))])
def test_reduced_zoo_at_real_head_dim_served_on_card_matches_cpu(cuda, arch, dims):
    """phi3 and kimi reduced at their own head dims, 96 and 112 (f32: the FMA
    flash kernel at those head dims), serve the same greedy tokens on the
    card and on the CPU."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models.schema import init_params
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = dataclasses.replace(get_config(arch).reduced(), **dims)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, size=12) for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params.to(dev), batch_size=3, max_seq=64, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=6))
        outs[dev] = [r.output for r in eng.run_batch()]
    assert outs["cuda"] == outs["cpu"]


def test_reduced_starcoder2_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of the reduced starcoder2 (LayerNorm, GELU, f32 flash
    kernel) on the card and on the CPU from the same weights."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.schema import init_params
    from repro_torch.optim.optimizers import init_opt_state
    from repro_torch.train.steps import make_train_step
    cfg = get_config("starcoder2-3b").reduced()
    chain = torch.from_numpy(np.random.default_rng(27).integers(0, cfg.vocab_size, (2, 41)))
    batch = {"tokens": chain[:, :-1], "labels": chain[:, 1:]}
    tc = TrainConfig(optimizer="adamw", learning_rate=1e-3)
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(dev)
        before = flash_attention.launches
        _, _, m = make_train_step(cfg, tc)(params, init_opt_state(tc, params),
                                           {k: v.to(dev) for k, v in batch.items()})
        out[dev] = {k: v.item() for k, v in m.items()}
        if dev == "cuda":
            assert flash_attention.launches == before + cfg.n_layers
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(out["cuda"][key], out["cpu"][key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_lm_bucket_step_on_card_matches_cpu(cuda):
    """Two steps of a 3-slot LM bucket (yi-9b reduced, f32, batch 2 x 32)
    on the card and on the CPU, every trial's weights and draws from one
    CPU generator: each slot's summed -loss within 1e-5 + 1e-5 |cpu| (the
    f32 kernels and cuBLAS sum in other orders); on the card 3 RMSNorm slot
    launches (block kernel) and 1 FMA flash launch a step."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm as rms_op
    from repro_torch.population.engine import PopulationEngine, TrialLease
    from repro_torch.population.objectives.lm import LMObjective
    hps = [dict(learning_rate=lr, loss_chunk=1024, grad_clip=c, warmup_steps=w)
           for lr, c, w in ((1e-3, 1.0, 1), (3e-4, 0.5, 4), (2e-3, 2.0, 2))]
    sums = {}
    for dev in ("cpu", "cuda"):
        engine = PopulationEngine(LMObjective("yi-9b", device=dev, init_device="cpu"),
                                  max_slots=3, episodes_per_phase=10 ** 9, max_updates=10 ** 9,
                                  seed=0, device=dev)
        engine._admit_grouped([TrialLease(i, dict(hp)) for i, hp in enumerate(hps)], now=0.0)
        bucket = engine.buckets[32]
        counts = (rms_op.launches_slots, rms_op.launches_block, flash_attention.launches_fma)
        for _ in range(2):
            bucket.step()
        moved = (rms_op.launches_slots - counts[0], rms_op.launches_block - counts[1],
                 flash_attention.launches_fma - counts[2])
        assert moved == ((0, 0, 0) if dev == "cpu" else (6, 6, 2)), (dev, moved)
        sums[dev] = bucket.carry[1].cpu().numpy()
    np.testing.assert_allclose(sums["cuda"], sums["cpu"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [16, 64])
@pytest.mark.parametrize("dtype,di", [(torch.float32, 512), (torch.bfloat16, 130)])
def test_selective_scan_slots_kernels_match_plain(cuda, T, dtype, di):
    """The scan's slot case (an A and a D a slot, ``rows_per_a``) through
    the dispatch (the sequential kernel below 32 steps, the prefill kernel
    from them) and the other kernel past it, against
    ``selective_scan_slots_ref`` (in f64 for the prefill kernel, whose sums
    run in the associative form's order); d_inner 130 in bf16 puts a slot's
    D rows off 16 bytes."""
    from repro_torch.kernels.selective_scan.ops import selective_scan_slots
    from repro_torch.kernels.selective_scan.ref import selective_scan_slots_ref
    from repro_torch.kernels.selective_scan.selective_scan import kernel_for, launch
    rng = np.random.default_rng(16)
    S, B, st = 3, 2, 8
    a = -_t(rng, (S, di, st), torch.float32, cuda).abs() - 0.05
    dt = (_t(rng, (S * B, T, di), torch.float32, cuda).abs() * 0.1 + 0.01).to(dtype)
    bc = _t(rng, (S * B, T, 2 * st + 8), dtype, cuda)
    args = (_t(rng, (S * B, T, di), dtype, cuda), dt, a, bc[..., 8:8 + st], bc[..., 8 + st:],
            (_t(rng, (S, di), torch.float32, cuda) + 1.0).to(dtype),
            _t(rng, (S * B, di, st), torch.float32, cuda) * 0.2)
    kind = kernel_for(args[0])
    before = (selective_scan.launches_slots, getattr(selective_scan, f"launches_{kind}"))
    y, hT = selective_scan_slots(*args)
    torch.cuda.synchronize()
    assert (selective_scan.launches_slots, getattr(selective_scan, f"launches_{kind}")) == (
        before[0] + 1, before[1] + 1)
    want = {"sequential": selective_scan_slots_ref(*args),
            "prefill": selective_scan_slots_ref(*(x.double() for x in args))}
    other = "sequential" if kind == "prefill" else "prefill"
    yo, ho = torch.full_like(y, float("nan")), torch.full_like(hT, float("nan"))
    launch(other, *args, yo, ho, rows_per_a=B)
    torch.cuda.synchronize()
    for name, (yk, hk) in ((kind, (y, hT)), (other, (yo, ho))):
        ry, rh = want[name]
        atol, rtol = SCAN_TOL[dtype]
        np.testing.assert_allclose(yk.double().cpu().numpy(), ry.double().cpu().numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)
        np.testing.assert_allclose(hk.double().cpu().numpy(), rh.double().cpu().numpy(),
                                   atol=SCAN_TOL[torch.float32][0], err_msg=name)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "grok-1-314b"])
def test_mamba_and_moe_bucket_step_on_card_matches_cpu(cuda, arch):
    """``test_lm_bucket_step_on_card_matches_cpu`` over jamba's reduced
    config (a mamba block: one call of the scan's slot case a step) and
    grok-1's (a MoE block: three small gmm calls over the slots' (slot,
    expert) groups a step)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.population.engine import PopulationEngine, TrialLease
    from repro_torch.population.objectives.lm import LMObjective
    hps = [dict(learning_rate=lr, loss_chunk=1024, grad_clip=c, warmup_steps=w)
           for lr, c, w in ((1e-3, 1.0, 1), (3e-4, 0.5, 4), (2e-3, 2.0, 2))]
    rc = get_config(arch).reduced()
    n_scan = sum(m == "mamba" for m, _ in rc.pattern)
    n_gmm = 3 * sum(f == "moe" for _, f in rc.pattern)
    sums = {}
    for dev in ("cpu", "cuda"):
        engine = PopulationEngine(LMObjective(arch, device=dev, init_device="cpu"),
                                  max_slots=3, episodes_per_phase=10 ** 9, max_updates=10 ** 9,
                                  seed=0, device=dev)
        engine._admit_grouped([TrialLease(i, dict(hp)) for i, hp in enumerate(hps)], now=0.0)
        bucket = engine.buckets[32]
        counts = (selective_scan.launches_slots, selective_scan.launches_prefill,
                  gmm.launches_small)
        for _ in range(2):
            bucket.step()
        moved = (selective_scan.launches_slots - counts[0],
                 selective_scan.launches_prefill - counts[1], gmm.launches_small - counts[2])
        assert moved == ((0, 0, 0) if dev == "cpu" else (2 * n_scan, 2 * n_scan, 2 * n_gmm)), (
            dev, moved)
        sums[dev] = bucket.carry[1].cpu().numpy()
    np.testing.assert_allclose(sums["cuda"], sums["cpu"], rtol=1e-5, atol=1e-5)
