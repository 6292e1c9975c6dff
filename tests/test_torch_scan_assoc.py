"""The prefill scan kernel's structure, walked by its plain twin
(``selective_scan_tiled``: tiles of 4 runs of steps, a scan of the runs'
(A, B) aggregates, a carry from tile to tile), against the
port's sequential plain version and the JAX package's sequential oracle,
associative form and Pallas kernel (interpret mode), on the same numpy
inputs; and the scan's dispatch between its two CUDA kernels."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ops import selective_scan as jax_scan  # noqa: E402
from repro.models.ssm import selective_scan_assoc as jax_assoc  # noqa: E402
from repro.models.ssm import selective_scan_ref as jax_ref  # noqa: E402
from repro_torch.kernels.selective_scan import ops  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan as scan_mod  # noqa: E402
from repro_torch.kernels.selective_scan.ref import (LANE_STEPS, RUNS, lane_steps,  # noqa: E402
                                                    selective_scan_ref, selective_scan_tiled)
from repro_torch.kernels.selective_scan.selective_scan import kernel_for  # noqa: E402

# f32: the same recurrence with its sums in another order (the JAX tests'
# tolerance, as tests/test_torch_selective_scan.py)
ATOL = 2e-5
# B, S, di, d_state, and the Pallas kernel's channel and sequence blocks:
# tests/test_kernels.py's cases; S = 77, a tile of 64 steps and one of 13
# (runs cut short and empty); S = 600, ten tiles, a carry from each to the
# next; di = 130, channels past an item's 64 on the card
CASES = [(1, 64, 32, 4, 16, 16), (2, 128, 64, 8, 32, 64), (1, 32, 16, 16, 16, 32),
         (2, 77, 40, 5, 40, 77), (2, 600, 24, 16, 24, 120), (1, 96, 130, 16, 130, 32)]


def _inputs(B, S, di, st, seed=0):
    """The JAX test's distributions: dt > 0, A < 0, a nonzero h0."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (f(B, S, di), np.abs(f(B, S, di, scale=0.1)) + 0.01, -np.abs(f(di, st)),
            f(B, S, st), f(B, S, st), np.ones(di, np.float32), f(B, di, st, scale=0.2))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,di,st,bd,bs", CASES)
def test_tiled_twin_matches_plain_jax_oracle_assoc_and_pallas(B, S, di, st, bd, bs):
    arrays = _inputs(B, S, di, st)
    y, hT = selective_scan_tiled(*_torch(arrays))
    assert y.dtype == torch.float32 and y.shape == (B, S, di)
    assert hT.dtype == torch.float32 and hT.shape == (B, di, st)
    j = [jnp.asarray(a) for a in arrays]
    for name, (ry, rh) in {
            "plain": selective_scan_ref(*_torch(arrays)),
            "oracle": jax_ref(*j),
            "assoc": jax_assoc(*j),
            "pallas": jax_scan(*j, use_pallas=True, interpret=True, bd=bd, bs=bs)}.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL, err_msg=name)
        np.testing.assert_allclose(hT.numpy(), np.asarray(rh), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("S", [1, 3, 31, 33, 63, 64, 65, 127, 128, 129, 192, 193, 1000])
def test_tiled_twin_at_the_edges_of_runs_and_tiles(S):
    """One step; fewer steps than runs; runs of 8 and 9 steps, the last cut
    short; a tile less one step, a whole tile, and one step into a second
    tile; then the same about the second and third tiles' edges, where the
    carry-in is a tile's composed (A, B)."""
    arrays = _inputs(1, S, 8, 16, seed=S)
    y, hT = selective_scan_tiled(*_torch(arrays))
    jy, jh = jax_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), atol=ATOL)


def test_tiled_twin_takes_strided_b_c_and_a_zero_state():
    """b and c as slices of one projection (as the mamba block passes them,
    rows of the projection apart), from h0 = 0 as at a prompt's start."""
    u, dt, a, b, c, d, h0 = _inputs(2, 300, 16, 16, seed=1)
    h0 = np.zeros_like(h0)
    bc = np.concatenate([np.ones_like(b[..., :5]), b, c], -1)
    bt = torch.from_numpy(bc)
    y, hT = selective_scan_tiled(*_torch((u, dt, a)), bt[..., 5:21], bt[..., 21:],
                                 *_torch((d, h0)))
    jy, jh = jax_assoc(*map(jnp.asarray, (u, dt, a, b, c, d, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), atol=ATOL)


def test_tiled_twin_rounds_y_once_to_bf16():
    u, dt, a, b, c, d, h0 = _inputs(1, 300, 32, 16, seed=2)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    y, hT = selective_scan_tiled(bf(u), bf(dt), torch.from_numpy(a), bf(b), bf(c), bf(d),
                                 torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    # the same scan in f32 on the bf16-rounded inputs, rounded once at the end
    f = lambda x: bf(x).float()  # noqa: E731
    yf, hf = selective_scan_tiled(f(u), f(dt), torch.from_numpy(a), f(b), f(c), f(d),
                                  torch.from_numpy(h0))
    assert torch.equal(y, yf.to(torch.bfloat16)) and torch.equal(hT, hf)
    # and against the plain version in bf16: both round an f32 y once, so
    # they may differ by one bf16 ulp of the value
    ry, rh = selective_scan_ref(bf(u), bf(dt), torch.from_numpy(a), bf(b), bf(c), bf(d),
                                torch.from_numpy(h0))
    np.testing.assert_allclose(y.float().numpy(), ry.float().numpy(), atol=1e-2, rtol=2 ** -7)
    np.testing.assert_allclose(hT.numpy(), rh.numpy(), atol=ATOL)


@pytest.mark.parametrize("B,S,di,st", [(2, 600, 24, 16), (4, 600, 130, 16), (2, 1024, 64, 16),
                                      (1, 2048, 32, 16), (2, 300, 64, 4)])
def test_tiled_twin_is_nearer_an_f64_scan_than_the_sequential_f32_one(B, S, di, st):
    """Where states barely decay over hundreds of steps (the JAX tests'
    draws), the sequential f32 scan's rounding accumulates step by step; the
    associative form carries a state across a tile through one product of
    RUNS exponentials, so its f32 error against the same scan in f64 is no
    larger (the kernel's tests on the card hold it to that scan)."""
    t = _torch(_inputs(B, S, di, st))
    ry, rh = selective_scan_ref(*(x.double() for x in t))
    assert ry.dtype == rh.dtype == torch.float64
    errors = {}
    for name, fn in (("twin", selective_scan_tiled), ("plain", selective_scan_ref)):
        y, hT = fn(*t)
        errors[name] = max((y.double() - ry).abs().max().item(),
                           (hT.double() - rh).abs().max().item())
    assert errors["twin"] <= errors["plain"], errors
    assert errors["twin"] < ATOL, errors


@pytest.mark.parametrize("S,lr,tiles", [(1, 1, 1), (32, 8, 1), (33, 9, 1), (63, 16, 1),
                                        (64, 16, 1), (77, 16, 2), (512, 16, 8),
                                        (600, 16, 10)])
def test_runs_and_tiles(S, lr, tiles):
    assert lane_steps(S) == lr and -(-S // (RUNS * lr)) == tiles
    assert lane_steps(S) <= LANE_STEPS


# -- the dispatch ------------------------------------------------------------

def _counts():
    s = ops.selective_scan
    return (s.launches, s.launches_prefill, s.launches_sequential)


@pytest.mark.parametrize("shape,dtype,kind", [
    ((4, 512, 8192), torch.bfloat16, "prefill"),     # jamba's prefill
    ((4, 1, 8192), torch.bfloat16, "sequential"),    # its decode step
    ((2, 32, 130), torch.float32, "prefill"),        # runs of 8 steps
    ((2, 31, 64), torch.bfloat16, "sequential"),
    ((1, 600, 16), torch.float32, "prefill"),
    ((3, 12, 512), torch.float32, "sequential"),     # the reduced models' prompts
])
def test_kernel_for_chooses_from_s_alone(shape, dtype, kind):
    assert kernel_for(torch.empty(shape, dtype=dtype, device="meta")) == kind


@pytest.mark.parametrize("launched", ["prefill", "sequential", None])
def test_ops_counts_the_kernel_selective_scan_cuda_reports(monkeypatch, launched):
    """The counters move by the kernel ``selective_scan_cuda`` says it launched
    (None: an empty call, nothing launched), and the dispatch runs once."""
    calls = []

    def fake_cuda(*args):
        calls.append(1)
        return "y", "hT", launched

    monkeypatch.setattr(ops, "selective_scan_cuda", fake_cuda)
    u = types.SimpleNamespace(device=torch.device("cuda"))
    before = _counts()
    assert ops.selective_scan(u, None, None, None, None, None, None) == ("y", "hT")
    moved = tuple(a - b for a, b in zip(_counts(), before))
    assert moved == {"prefill": (1, 1, 0), "sequential": (1, 0, 1), None: (0, 0, 0)}[launched]
    assert len(calls) == 1


@pytest.mark.parametrize("S", [1, 64])
def test_cpu_tensors_never_reach_the_dispatch(monkeypatch, S):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA dispatch")

    monkeypatch.setattr(ops, "selective_scan_cuda", refuse)
    monkeypatch.setattr(scan_mod, "kernel_for", refuse)
    arrays = _torch(_inputs(1, S, 16, 4, seed=3))
    before = _counts()
    y, hT = ops.selective_scan(*arrays)
    assert _counts() == before
    ry, rh = selective_scan_ref(*arrays)
    assert torch.equal(y, ry) and torch.equal(hT, rh)


def test_launch_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="no kernel 'tiled'"):
        scan_mod.launch("tiled", *([None] * 9))
