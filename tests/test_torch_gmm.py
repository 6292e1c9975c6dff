"""The port's plain grouped matmul against the JAX package's Pallas kernel
(interpret mode) and its oracle, ``lax.ragged_dot``, on the same numpy
inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gmm.ops import gmm as jax_gmm  # noqa: E402
from repro.kernels.gmm.ref import gmm_ref as jax_gmm_ref  # noqa: E402
from repro_torch.kernels.gmm.gmm import gmm_cuda  # noqa: E402
from repro_torch.kernels.gmm.ops import gmm  # noqa: E402
from repro_torch.kernels.gmm.ref import gmm_ref  # noqa: E402

# tests/test_kernels.py::test_gmm_vs_ragged_dot: group sizes (empty groups
# included), D, F and the Pallas kernel's row tile
CASES = [([30, 0, 17, 40, 13], 32, 48, 16), ([4, 4, 4, 4], 16, 16, 4),
         ([128], 64, 32, 32), ([0, 0, 50], 32, 64, 8)]
# f32: sums in another order (the JAX test's tolerance); bf16: one rounding
# of the output, as the JAX test of RMSNorm allows
ATOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _inputs(sizes, D, F, T=None, seed=0):
    rng = np.random.default_rng(seed)
    T = sum(sizes) if T is None else T
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((len(sizes), D, F)).astype(np.float32),
            np.asarray(sizes, np.int32))


@pytest.mark.parametrize("sizes,D,F,bt", CASES)
def test_gmm_ref_matches_pallas_and_ragged_dot(sizes, D, F, bt):
    x, w, gs = _inputs(sizes, D, F)
    out = gmm_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    assert out.dtype == torch.float32 and out.shape == (x.shape[0], F)
    xj, wj, gj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)
    pallas = np.asarray(jax_gmm(xj, wj, gj, use_pallas=True, interpret=True, bt=bt))
    np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL["float32"])
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_gmm_ref(xj, wj, gj)),
                               atol=ATOL["float32"])


def test_gmm_ref_bf16_and_rows_past_the_groups():
    """bf16 in and out; 8 rows past the last group come out zero, as
    ``ragged_dot`` gives them."""
    x, w, gs = _inputs([5, 0, 11], 32, 24, T=24, seed=1)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    out = gmm_ref(xb, wb, torch.from_numpy(gs))
    assert out.dtype == torch.bfloat16
    ref = jax_gmm_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                      jnp.asarray(gs))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=ATOL["bfloat16"])
    assert not out[16:].any()


def test_gmm_dispatch_sends_cpu_tensors_to_plain_version():
    x, w, gs = (torch.from_numpy(a) for a in _inputs([3, 0, 5], 16, 8, seed=2))
    before = gmm.launches
    out = gmm(x, w, gs)
    assert gmm.launches == before
    assert torch.equal(out, gmm_ref(x, w, gs))


def test_gmm_dispatch_refuses_devices_without_a_kernel():
    x, w, gs = (torch.from_numpy(a) for a in _inputs([2, 2], 8, 8))
    with pytest.raises(ValueError, match="no kernel"):
        gmm(x.to("meta"), w.to("meta"), gs.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        gmm_cuda(x, w, gs)
