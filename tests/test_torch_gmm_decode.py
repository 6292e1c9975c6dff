"""The decode grouped-matmul kernel's block schedule, walked by its plain twin
(``gmm_decode_ref``: 16-row slots by 128-column tiles, K steps of 64),
against the plain version, the JAX package's Pallas kernel (interpret mode,
16-row tiles) and its oracle ``lax.ragged_dot``, at decode-like sizes; its
slot count against ``pad_groups(..., bt=16)``; its bf16 output, rounded
once; and the sweep's variants of the decode kernel against its
compile-time checks and the shared memory of an SM."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gmm.gmm import pad_groups  # noqa: E402
from repro.kernels.gmm.ops import gmm as jax_gmm  # noqa: E402
from repro.kernels.gmm.ref import gmm_ref as jax_gmm_ref  # noqa: E402
from repro_torch.kernels.gmm import sweep  # noqa: E402
from repro_torch.kernels.gmm.ref import (DECODE_ROWS, gmm_decode_ref, gmm_ref,  # noqa: E402
                                         grid_rows, tile_map)

# f32: sums over D in another order (tests/test_kernels.py's tolerance)
ATOL = 2e-4
# bf16: each side rounds its f32 sum once, so they may differ by one bf16
# ulp of the value (2**-7 relative), as on the card
BF16_TOL = (1e-2, 2 ** -7)

JAMBA_DECODE = [2, 0, 1, 0, 0, 1, 0, 0, 2, 0, 0, 0, 1, 0, 0, 1]    # 8 rows over 16
# decode-like sizes the Pallas kernel takes (F <= 128 or a multiple of 128,
# no rows past the groups): T = 1, T = 8 in 1-row groups, jamba's routing,
# T = 126 with empty groups and groups of 16, 17 and 33 rows (one slot,
# two, three), D off the K step of 64
PALLAS_CASES = [([0, 1, 0, 0], 32, 48), ([1] * 8, 40, 24), (JAMBA_DECODE, 64, 128),
                ([16, 17, 0, 1], 24, 256), ([17, 0, 1, 33, 16, 0, 59], 72, 64),
                ([0, 0, 126], 136, 128)]
# rows past the last group (T > sum of sizes), and F a multiple of 8 but of
# neither 64 nor 128, which the Pallas kernel does not take
TAIL_CASES = [([1, 0, 3], 9, 24, 40), ([17], 20, 200, 328), ([0, 0], 5, 16, 8),
              ([2, 0, 1, 0, 0, 1, 0, 0, 2, 0, 0, 0, 1, 0, 0, 1], 127, 64, 72)]


def _inputs(sizes, D, F, T=None, seed=0):
    rng = np.random.default_rng(seed)
    T = sum(sizes) if T is None else T
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((len(sizes), D, F)).astype(np.float32),
            np.asarray(sizes, np.int32))


@pytest.mark.parametrize("sizes,D,F", PALLAS_CASES)
def test_decode_twin_matches_plain_pallas_and_ragged_dot(sizes, D, F):
    x, w, gs = _inputs(sizes, D, F)
    out = gmm_decode_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], F)
    np.testing.assert_allclose(out.numpy(), gmm_ref(torch.from_numpy(x), torch.from_numpy(w),
                                                    torch.from_numpy(gs)).numpy(), atol=ATOL)
    xj, wj, gj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)
    pallas = np.asarray(jax_gmm(xj, wj, gj, use_pallas=True, interpret=True, bt=DECODE_ROWS))
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_gmm_ref(xj, wj, gj)), atol=ATOL)


@pytest.mark.parametrize("sizes,T,D,F", TAIL_CASES)
def test_decode_twin_zeroes_rows_past_the_groups(sizes, T, D, F):
    x, w, gs = _inputs(sizes, D, F, T=T, seed=1)
    out = gmm_decode_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    ref = np.asarray(jax_gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert not out[sum(sizes):].any()


@pytest.mark.parametrize("sizes,T", [([1], 1), ([0, 1, 0, 0], 1), ([1] * 8, 8),
                                     (JAMBA_DECODE, 8), ([16, 17, 0, 1], 34),
                                     ([17, 0, 1, 33, 16, 0, 59], 126), ([0, 0, 126], 127),
                                     ([1, 0, 3], 9), ([17], 20), ([0, 0], 5), ([5], 4)])
def test_slot_map_matches_pad_groups(sizes, T):
    """The decode kernel's slots are ``pad_groups``' 16-row tiles, in order;
    rows past the groups get tail slots; every row lies in exactly one
    slot; the grid's shape-only bound covers the real count."""
    tiles = tile_map(sizes, T, bm=DECODE_ROWS)
    assert len(tiles) == grid_rows(T, len(sizes), DECODE_ROWS)
    real = [t for t in tiles if t is not None]
    assert tiles[:len(real)] == real            # the blocks past the count exit
    n = min(sum(sizes), T)
    x = jnp.zeros((sum(sizes), 4), jnp.float32)
    _, tile_expert, _ = pad_groups(x, jnp.asarray(sizes, jnp.int32), bt=DECODE_ROWS)
    group_tiles = [t for t in real if t[0] >= 0]
    if sum(sizes) <= T:
        assert [t[0] for t in group_tiles] == np.asarray(tile_expert).tolist()
    covered = np.zeros(T, int)
    for e, r0, rows in real:
        assert 0 < rows <= DECODE_ROWS
        covered[r0:r0 + rows] += 1
        assert (e == -1) == (r0 >= n)           # tail slots hold only rows past the groups
    assert (covered == 1).all()


def test_jamba_decode_has_one_slot_per_routed_group():
    """8 rows routed 1-2 to each of 6 experts: 6 working slots of the 18
    the grid bounds (ceil(8 / 16) + 16 + 1), no tail."""
    tiles = tile_map(JAMBA_DECODE, 8, bm=DECODE_ROWS)
    assert len(tiles) == 18
    real = [t for t in tiles if t is not None]
    assert [t[0] for t in real] == [e for e, g in enumerate(JAMBA_DECODE) if g]
    assert [t[2] for t in real] == [g for g in JAMBA_DECODE if g]


@pytest.mark.parametrize("sizes,T,D,F", [([1, 0, 17, 33], 60, 136, 200),
                                         (JAMBA_DECODE, 8, 200, 328)])
def test_decode_twin_bf16_rounds_once(sizes, T, D, F):
    x, w, gs = _inputs(sizes, D, F, T=T, seed=2)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    gs = torch.from_numpy(gs)
    out = gmm_decode_ref(xb, wb, gs)
    assert out.dtype == torch.bfloat16
    # the same f32 sums, rounded to bf16 once at the end
    assert torch.equal(out, gmm_decode_ref(xb.float(), wb.float(), gs).to(torch.bfloat16))
    atol, rtol = BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), gmm_ref(xb, wb, gs).float().numpy(),
                               atol=atol, rtol=rtol)
    assert not out[sum(sizes):].any()


@pytest.mark.parametrize("name", list(sweep.DECODE_VARIANTS))
def test_sweep_decode_variants_meet_the_kernels_static_asserts(name):
    """csrc/gmm_decode.cu's static_asserts, and the shared memory its launch
    bound asks for: MIN_BLOCKS rings of STAGES stages fit an SM."""
    m = {**sweep.DECODE_DEFAULTS, **(sweep.DECODE_VARIANTS[name] or {})}
    assert m["BN"] % 64 == 0 and m["BK"] % 16 == 0 and m["STAGES"] >= 2
    assert (m["BK"] * m["BN"] // 8) % 128 == 0
    ring = m["STAGES"] * (m["BK"] * (m["BN"] + 8) + DECODE_ROWS * (m["BK"] + 8)) * 2
    assert m["MIN_BLOCKS"] * (ring + sweep.BLOCK_SMEM_RESERVED) <= sweep.SM_SMEM


def test_sweep_of_the_decode_kernel_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main(["--kernel", "decode"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
