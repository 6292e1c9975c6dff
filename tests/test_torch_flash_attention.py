"""The port's plain attention against the JAX package's Pallas flash kernel
(interpret mode) and its chunked oracle, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (chunked_attention,  # noqa: E402
                                                     reference_attention)

# tests/test_kernels.py::FLASH_CASES, plus gemma2's head_dim 256 with GQA,
# a window and a softcap
FLASH_CASES = [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap, dtype
    (2, 4, 2, 64, 64, 32, True, 0, 0.0, "float32"),
    (1, 8, 8, 128, 128, 64, True, 0, 0.0, "float32"),
    (2, 4, 1, 96, 96, 32, True, 32, 0.0, "float32"),
    (1, 4, 2, 64, 64, 32, True, 0, 50.0, "float32"),
    (1, 2, 2, 80, 208, 16, False, 0, 0.0, "float32"),
    (2, 4, 2, 64, 64, 32, True, 0, 0.0, "bfloat16"),
    (1, 2, 1, 33, 65, 32, True, 0, 0.0, "float32"),   # ragged sizes
    (1, 4, 2, 40, 40, 256, True, 16, 50.0, "float32"),
    # whisper's non-causal forms, MHA at head dim 64: the encoder's self
    # attention (Sq = Skv), cross attention at prefill (Sq != Skv) and at a
    # decode step (Sq 1), with Skv 100 not a multiple of the 32-key block
    (2, 4, 4, 100, 100, 64, False, 0, 0.0, "float32"),
    (2, 4, 4, 24, 100, 64, False, 0, 0.0, "float32"),
    (2, 4, 4, 1, 100, 64, False, 0, 0.0, "float32"),
    (2, 4, 4, 24, 100, 64, False, 0, 0.0, "bfloat16"),
]
# f32: sum order only; bf16: output rounding (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
INVALID = 2 ** 30


def _qkv(B, Hq, Hkv, Sq, Skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_attention_matches_pallas_flash(case):
    B, Hq, Hkv, Sq, Skv, hd, causal, window, cap, dt = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, hd)
    off = Skv - Sq if causal else 0
    jd = jnp.dtype(dt)
    pallas = np.asarray(jax_flash(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        causal=causal, window=window, softcap=cap, q_offset=off, bq=32, bk=32,
        interpret=True), np.float32)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    chunked = chunked_attention(_t(q, dt), _t(k, dt), _t(v, dt), chunk=32, **kw)
    quadratic = reference_attention(_t(q, dt), _t(k, dt), _t(v, dt), **kw)
    assert chunked.dtype == getattr(torch, dt)
    np.testing.assert_allclose(chunked.float().numpy(), pallas, atol=TOL[dt])
    np.testing.assert_allclose(quadratic.float().numpy(), pallas, atol=TOL[dt])


def _ring(L, pos):
    """kpos of a ring cache of L slots holding positions <= pos (p at p % L)."""
    kpos = np.full(L, INVALID, np.int32)
    for p in range(max(0, pos - L + 1), pos + 1):
        kpos[p % L] = p
    return kpos


# decode: Sq = 1 against a ring cache
DECODE_CASES = [
    # L, pos, window, softcap
    (16, 40, 0, 0.0),      # wrapped
    (16, 9, 0, 50.0),      # half the slots unwritten (kpos 2**30)
    (16, 40, 6, 50.0),     # wrapped, with a window
    (64, 21, 8, 0.0),      # unwritten slots and a window
]


@pytest.mark.parametrize("L,pos,window,cap", DECODE_CASES)
def test_plain_decode_matches_chunked_oracle_on_ring_cache(L, pos, window, cap):
    q, k, v = _qkv(2, 4, 2, 1, L, 32, seed=3)
    kpos = _ring(L, pos)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=pos)
    ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 kv_positions=jnp.asarray(kpos), chunk=8, **kw))
    out = flash_attention(_t(q), _t(k), _t(v), kv_pos=torch.from_numpy(kpos), **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_dispatch_sends_cpu_tensors_to_plain_version():
    q, k, v = _qkv(1, 4, 2, 24, 24, 16, seed=5)
    before = flash_attention.launches
    out = flash_attention(_t(q), _t(k), _t(v), window=8, softcap=30.0)
    assert flash_attention.launches == before
    ref = chunked_attention(_t(q), _t(k), _t(v), window=8, softcap=30.0)
    assert torch.equal(out, ref)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (_t(a) for a in _qkv(1, 2, 1, 4, 4, 16))
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, v)
