"""The port's plain selective scan against the JAX package's Pallas kernel
(interpret mode), its sequential oracle and its associative form, on the same
numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ops import selective_scan as jax_scan  # noqa: E402
from repro.models.ssm import selective_scan_assoc as jax_assoc  # noqa: E402
from repro.models.ssm import selective_scan_ref as jax_ref  # noqa: E402
from repro_torch.kernels.selective_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.kernels.selective_scan.selective_scan import selective_scan_cuda  # noqa: E402

# tests/test_kernels.py::test_selective_scan_vs_ref: B, S, di, d_state, and
# the Pallas kernel's channel and sequence blocks
CASES = [(1, 64, 32, 4, 16, 16), (2, 128, 64, 8, 32, 64), (1, 32, 16, 16, 16, 32)]
# f32 throughout: the same recurrence in another order of sums (the JAX
# tests' tolerance)
ATOL = 2e-5


def _inputs(B, S, di, st, seed=0):
    """The JAX test's distributions: dt > 0, A < 0, a nonzero h0."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (f(B, S, di), np.abs(f(B, S, di, scale=0.1)) + 0.01, -np.abs(f(di, st)),
            f(B, S, st), f(B, S, st), np.ones(di, np.float32), f(B, di, st, scale=0.2))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,di,st,bd,bs", CASES)
def test_scan_ref_matches_pallas_oracle_and_assoc(B, S, di, st, bd, bs):
    arrays = _inputs(B, S, di, st)
    j = [jnp.asarray(a) for a in arrays]
    y, hT = selective_scan_ref(*_torch(arrays))
    assert y.dtype == torch.float32 and y.shape == (B, S, di)
    assert hT.dtype == torch.float32 and hT.shape == (B, di, st)
    for name, (jy, jh) in {
            "pallas": jax_scan(*j, use_pallas=True, interpret=True, bd=bd, bs=bs),
            "oracle": jax_ref(*j),
            "assoc": jax_assoc(*j)}.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, err_msg=name)
        np.testing.assert_allclose(hT.numpy(), np.asarray(jh), atol=ATOL, err_msg=name)


def test_scan_ref_takes_strided_b_c_and_one_step():
    """b and c as slices of one projection (as the mamba block passes them),
    and a decode step (S = 1) from a nonzero state."""
    u, dt, a, b, c, d, h0 = _inputs(2, 9, 16, 8, seed=1)
    bc = np.concatenate([b, np.zeros_like(b[..., :3]), c], -1)
    bt = torch.from_numpy(bc)
    y, hT = selective_scan_ref(*_torch((u, dt, a)), bt[..., :8], bt[..., 11:],
                               *_torch((d, h0)))
    jy, jh = jax_ref(*map(jnp.asarray, (u, dt, a, b, c, d, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), atol=ATOL)
    y1, h1 = selective_scan_ref(*_torch((u[:, :1], dt[:, :1], a, b[:, :1], c[:, :1], d, h0)))
    jy1, jh1 = jax_ref(*map(jnp.asarray, (u[:, :1], dt[:, :1], a, b[:, :1], c[:, :1], d, h0)))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), atol=ATOL)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), atol=ATOL)


def test_scan_ref_rounds_y_once_to_bf16():
    u, dt, a, b, c, d, h0 = _inputs(1, 16, 32, 16, seed=2)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    y, hT = selective_scan_ref(bf(u), bf(dt), torch.from_numpy(a), bf(b), bf(c), bf(d),
                               torch.from_numpy(h0))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    # the same scan in f32 on the bf16-rounded inputs, rounded once at the end
    f = lambda x: bf(x).float()  # noqa: E731
    yf, hf = selective_scan_ref(f(u), f(dt), torch.from_numpy(a), f(b), f(c), f(d),
                                torch.from_numpy(h0))
    assert torch.equal(y, yf.to(torch.bfloat16)) and torch.equal(hT, hf)


def test_scan_dispatch_sends_cpu_tensors_to_plain_version():
    arrays = _torch(_inputs(1, 8, 16, 4, seed=3))
    before = selective_scan.launches
    y, hT = selective_scan(*arrays)
    assert selective_scan.launches == before
    ry, rh = selective_scan_ref(*arrays)
    assert torch.equal(y, ry) and torch.equal(hT, rh)


def test_scan_dispatch_refuses_devices_without_a_kernel():
    meta = [torch.from_numpy(a).to("meta") for a in _inputs(1, 4, 8, 4)]
    with pytest.raises(ValueError, match="no kernel"):
        selective_scan(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(*_torch(_inputs(1, 4, 8, 4)))
