"""The port's RMSNorm against the JAX package's Pallas kernel (interpret mode)
and its oracle, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

# the cases of tests/test_kernels.py::test_rmsnorm_vs_ref
CASES = [((4, 128), "float32"), ((3, 77, 256), "bfloat16"),
         ((1, 1, 64), "float32"), ((260, 512), "bfloat16")]
# the JAX tests' tolerances: f32 sum order, bf16 output rounding
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    sc = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    return x, sc


@pytest.mark.parametrize("shape,dtype", CASES)
def test_rmsnorm_ref_matches_pallas_and_oracle(shape, dtype):
    x, sc = _inputs(shape, dtype)
    xj, scj = jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(sc)
    pallas = np.asarray(jax_rmsnorm(xj, scj, use_pallas=True, interpret=True),
                        np.float32)
    oracle = np.asarray(jax_rmsnorm_ref(xj, scj), np.float32)
    out = rmsnorm_ref(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(sc))
    assert out.dtype == getattr(torch, dtype) and out.shape == shape
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=TOL[dtype])
    np.testing.assert_allclose(out.float().numpy(), oracle, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_dispatch_sends_cpu_tensors_to_plain_version(dtype):
    x, sc = _inputs((5, 64), dtype, seed=1)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    sct = torch.from_numpy(sc).to(getattr(torch, dtype))
    before = rmsnorm.launches
    out = rmsnorm(xt, sct)
    assert rmsnorm.launches == before
    assert torch.equal(out, rmsnorm_ref(xt, sct))


def test_rmsnorm_dispatch_refuses_devices_without_a_kernel():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        rmsnorm(x, torch.empty((8,), device="meta"))
