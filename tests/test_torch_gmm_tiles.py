"""The tiled grouped-matmul kernel's block schedule, walked by its plain twin
(``gmm_tiled_ref``), against the plain version, the JAX package's Pallas
kernel (interpret mode, 128-row tiles) and its oracle ``lax.ragged_dot``;
its tile count against ``pad_groups``'; the dispatch between the tiled,
the decode and the small kernel, on shapes; and the sweep's variants of
the tiled kernel against its compile-time checks."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gmm.gmm import pad_groups  # noqa: E402
from repro.kernels.gmm.ops import gmm as jax_gmm  # noqa: E402
from repro.kernels.gmm.ref import gmm_ref as jax_gmm_ref  # noqa: E402
from repro_torch.kernels.gmm import ops, sweep  # noqa: E402
from repro_torch.kernels.gmm.gmm import kernel_for  # noqa: E402
from repro_torch.kernels.gmm.ref import (TILE_M, gmm_ref, gmm_tiled_ref,  # noqa: E402
                                         grid_rows, tile_map)

BM = TILE_M
# f32: sums over D in another order (tests/test_kernels.py's tolerance)
ATOL = 2e-4
# bf16: each side rounds its f32 sum once, so they may differ by one bf16
# ulp of the value (2**-7 relative), as on the card
BF16_TOL = (1e-2, 2 ** -7)

# tests/test_kernels.py::test_gmm_vs_ragged_dot's sizes, D and F; then
# groups of 1 row, empty groups and groups of more than one 128-row tile,
# with D a multiple of 8 but not of 32
PALLAS_CASES = [([30, 0, 17, 40, 13], 32, 48), ([4, 4, 4, 4], 16, 16),
                ([128], 64, 32), ([0, 0, 50], 32, 64),
                ([1, 0, 129, 300, 0, 2], 40, 64), ([0, 1, 0, 127, 128], 24, 128)]
# rows past the last group (T > sum of sizes), and F a multiple of 8 but of
# neither 32 nor 128, which the Pallas kernel does not take
TAIL_CASES = [([5, 0, 11], 24, 32, 24), ([130, 1], 300, 16, 136), ([0, 0], 200, 8, 8)]


def _inputs(sizes, D, F, T=None, seed=0):
    rng = np.random.default_rng(seed)
    T = sum(sizes) if T is None else T
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((len(sizes), D, F)).astype(np.float32),
            np.asarray(sizes, np.int32))


@pytest.mark.parametrize("sizes,D,F", PALLAS_CASES)
def test_tiled_twin_matches_plain_pallas_and_ragged_dot(sizes, D, F):
    x, w, gs = _inputs(sizes, D, F)
    out = gmm_tiled_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], F)
    np.testing.assert_allclose(out.numpy(), gmm_ref(torch.from_numpy(x), torch.from_numpy(w),
                                                    torch.from_numpy(gs)).numpy(), atol=ATOL)
    xj, wj, gj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)
    pallas = np.asarray(jax_gmm(xj, wj, gj, use_pallas=True, interpret=True, bt=BM))
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_gmm_ref(xj, wj, gj)), atol=ATOL)


@pytest.mark.parametrize("sizes,T,D,F", TAIL_CASES)
def test_tiled_twin_zeroes_rows_past_the_groups(sizes, T, D, F):
    x, w, gs = _inputs(sizes, D, F, T=T, seed=1)
    out = gmm_tiled_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    ref = np.asarray(jax_gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert not out[sum(sizes):].any()


def test_tiled_twin_bf16_rounds_once():
    x, w, gs = _inputs([1, 0, 200, 77], 48, 136, T=290, seed=2)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    out = gmm_tiled_ref(xb, wb, torch.from_numpy(gs))
    ref = gmm_ref(xb, wb, torch.from_numpy(gs))
    assert out.dtype == torch.bfloat16
    atol, rtol = BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=atol, rtol=rtol)
    assert not out[278:].any()


@pytest.mark.parametrize("sizes,T", [([30, 0, 17, 40, 13], 100), ([1, 0, 129, 300, 0, 2], 432),
                                     ([0, 1, 0, 127, 128], 256), ([256, 256], 512),
                                     ([203, 321, 0, 1, 255, 257], 1037),
                                     ([130, 1], 300), ([0, 0], 200), ([5], 4)])
def test_tile_map_matches_pad_groups(sizes, T):
    """The kernel's group tiles are ``pad_groups``' tiles, in order; rows
    past the groups get tail tiles; every row lies in exactly one tile; the
    grid's shape-only bound covers the real count."""
    tiles = tile_map(sizes, T)
    assert len(tiles) == grid_rows(T, len(sizes))
    real = [t for t in tiles if t is not None]
    assert tiles[:len(real)] == real            # the blocks past the count exit
    n = min(sum(sizes), T)
    x = jnp.zeros((sum(sizes), 4), jnp.float32)
    _, tile_expert, _ = pad_groups(x, jnp.asarray(sizes, jnp.int32), bt=BM)
    group_tiles = [t for t in real if t[0] >= 0]
    if sum(sizes) <= T:
        assert [t[0] for t in group_tiles] == np.asarray(tile_expert).tolist()
    covered = np.zeros(T, int)
    for e, r0, rows in real:
        assert 0 < rows <= BM
        covered[r0:r0 + rows] += 1
        assert (e == -1) == (r0 >= n)           # tail tiles hold only rows past the groups
    assert (covered == 1).all()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("T,D,F,dtype,kind", [
    (4096, 4096, 14336, torch.bfloat16, "tiled"),    # jamba prefill, up/gate
    (4096, 14336, 4096, torch.bfloat16, "tiled"),    # jamba prefill, down
    (8, 4096, 14336, torch.bfloat16, "decode"),      # jamba decode, up/gate
    (8, 14336, 4096, torch.bfloat16, "decode"),      # jamba decode, down
    (4096, 4096, 14336, torch.float32, "small"),     # f32 stays on the small kernel
    (8, 4096, 14336, torch.float32, "small"),        # also at decode
    (BM - 1, 64, 64, torch.bfloat16, "decode"),
    (BM, 64, 64, torch.bfloat16, "tiled"),
    (1024, 100, 64, torch.bfloat16, "small"),        # D not a multiple of 8
    (8, 100, 64, torch.bfloat16, "small"),           # also at decode
    (1024, 64, 130, torch.bfloat16, "small"),        # F not a multiple of 8
    (1024, 200, 328, torch.bfloat16, "tiled"),       # multiples of 8, not of 32
])
def test_kernel_for_chooses_from_shapes(T, D, F, dtype, kind):
    assert kernel_for(_meta(T, D, dtype=dtype), _meta(16, D, F, dtype=dtype)) == kind


def test_kernel_for_sends_unaligned_rows_to_the_small_kernel():
    w = torch.zeros((2, 16, 16), dtype=torch.bfloat16)
    base = torch.zeros(200 * 16 + 1, dtype=torch.bfloat16)
    assert kernel_for(base[:-1].view(200, 16), w) == "tiled"
    assert kernel_for(base[1:].view(200, 16), w) == "small"     # 2 bytes off
    wb = torch.zeros(2 * 16 * 16 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 16)
    assert kernel_for(base[:-1].view(200, 16), wb) == "small"


def test_kernel_for_sends_unaligned_decode_rows_to_the_small_kernel():
    w = torch.zeros((2, 16, 16), dtype=torch.bfloat16)
    base = torch.zeros(8 * 16 + 1, dtype=torch.bfloat16)
    assert kernel_for(base[:-1].view(8, 16), w) == "decode"
    assert kernel_for(base[1:].view(8, 16), w) == "small"       # 2 bytes off
    wb = torch.zeros(2 * 16 * 16 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 16)
    assert kernel_for(base[:-1].view(8, 16), wb) == "small"


def _counts():
    g = ops.gmm
    return (g.launches, g.launches_tiled, g.launches_decode, g.launches_small)


@pytest.mark.parametrize("launched", ["tiled", "decode", "small", None])
def test_ops_counts_the_kernel_gmm_cuda_reports(monkeypatch, launched):
    """The counters move by the kernel ``gmm_cuda`` says it launched, and
    the dispatch runs once: ``ops.gmm`` asks no second time."""
    calls = []

    def fake_cuda(x, w, gs):
        calls.append(1)
        return "out", launched

    monkeypatch.setattr(ops, "gmm_cuda", fake_cuda)
    x = types.SimpleNamespace(device=torch.device("cuda"))
    before = _counts()
    assert ops.gmm(x, None, None) == "out"
    moved = tuple(a - b for a, b in zip(_counts(), before))
    assert moved == {"tiled": (1, 1, 0, 0), "decode": (1, 0, 1, 0), "small": (1, 0, 0, 1),
                     None: (0, 0, 0, 0)}[launched]
    assert len(calls) == 1
    assert not hasattr(ops, "kernel_for")


def test_cpu_tensors_move_no_counter():
    x, w, gs = (torch.from_numpy(a) for a in _inputs([200, 0, 56], 16, 8, seed=3))
    before = _counts()
    out = ops.gmm(x.to(torch.bfloat16), w.to(torch.bfloat16), gs)
    assert _counts() == before
    assert torch.equal(out, gmm_ref(x.to(torch.bfloat16), w.to(torch.bfloat16), gs))


@pytest.mark.parametrize("name", list(sweep.VARIANTS))
def test_sweep_variants_meet_the_kernels_static_asserts(name):
    m = {**sweep.DEFAULTS, **(sweep.VARIANTS[name] or {})}
    threads = 32 * (128 // m["WM"]) * (128 // m["WN"])
    a_step, b_step = threads // (m["BK"] // 8), threads // (128 // 8)
    assert 128 % a_step == 0 and m["BK"] % b_step == 0
    assert m["STAGES"] >= 2 and m["BK"] % 16 == 0 and m["WM"] % 16 == 0 and m["WN"] % 16 == 0


def test_sweep_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
