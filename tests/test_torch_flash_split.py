"""The split-KV form of attention (the plain twin of the decode kernel)
against the chunked oracle and the JAX package, and the host-side choices of
the flash dispatch: which kernel serves a call, and how many splits."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    SPLIT_TARGET_BLOCKS, SPLIT_TILE, kernel_for, split_kv_plan)
from repro_torch.kernels.flash_attention.ref import (chunked_attention,  # noqa: E402
                                                     split_kv_attention)

INVALID = 2 ** 30
TOL = 1e-5      # f32: the two forms sum in another order


def _qkv(B, Hq, Hkv, Sq, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32))


def _ring(L, pos, written=None):
    """kpos of a ring cache of L slots holding positions <= pos (p at p % L),
    or only the first ``written`` positions when that is given."""
    kpos = np.full(L, INVALID, np.int32)
    first = 0 if written is not None else max(0, pos - L + 1)
    last = written - 1 if written is not None else pos
    for p in range(first, last + 1):
        kpos[p % L] = p
    return kpos


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# decode against ring caches: B, Hq, Hkv, Sq, L, hd, q_offset, written, window, cap, n_splits
RING_CASES = [
    # 70 of 256 slots written: the last two of four tiles hold no key
    (2, 4, 2, 1, 256, 32, 69, 70, 0, 0.0, (1, 2, 4)),
    # 8 of 1024 slots written: fifteen of sixteen tiles are empty
    (1, 8, 4, 1, 1024, 16, 7, 8, 0, 50.0, (1, 3, 16)),
    # a wrapped ring with a window that reaches back past the wrap
    (2, 8, 4, 1, 192, 64, 500, None, 100, 50.0, (1, 2, 3)),
    # jamba's group (G = 4) with a partial last tile (Skv 200 = 3 x 64 + 8)
    (2, 16, 4, 1, 200, 32, 150, 151, 0, 0.0, (2, 4)),
    # Sq x G = 16 rows, the most one split-KV block takes
    (1, 8, 1, 2, 128, 16, 90, 92, 30, 30.0, (1, 2)),
]


@pytest.mark.parametrize("case", RING_CASES)
def test_split_kv_matches_chunked_and_jax_on_ring_caches(case):
    B, Hq, Hkv, Sq, L, hd, off, written, window, cap, n_splits = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, L, hd, seed=L + hd)
    kpos = _ring(L, off + Sq - 1, written)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    ref = chunked_attention(_t(q), _t(k), _t(v), kv_positions=_t(kpos), chunk=64, **kw)
    jax_ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     kv_positions=jnp.asarray(kpos), chunk=64, **kw))
    for n_split in n_splits:
        out = split_kv_attention(_t(q), _t(k), _t(v), n_split=n_split,
                                 kv_positions=_t(kpos), **kw)
        assert out.shape == (B, Sq, Hq, hd) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL)
        np.testing.assert_allclose(out.numpy(), jax_ref, atol=TOL)


# contiguous keys (kv_pos = None) against the Pallas kernel in interpret mode:
# B, Hq, Hkv, Sq, Skv, hd, causal, window, cap, n_splits
IOTA_CASES = [
    (2, 4, 2, 8, 130, 32, True, 0, 0.0, (1, 2, 3)),
    (1, 4, 1, 4, 192, 16, True, 40, 50.0, (1, 3)),
    (1, 2, 2, 1, 100, 32, False, 0, 30.0, (1, 2)),
]


@pytest.mark.parametrize("case", IOTA_CASES)
def test_split_kv_matches_pallas_flash(case):
    B, Hq, Hkv, Sq, Skv, hd, causal, window, cap, n_splits = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Skv, hd, seed=Skv)
    off = Skv - Sq if causal else 0
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  bq=32, bk=32, interpret=True, **kw))
    ref = chunked_attention(_t(q), _t(k), _t(v), chunk=64, **kw)
    for n_split in n_splits:
        out = split_kv_attention(_t(q), _t(k), _t(v), n_split=n_split, **kw)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL)
        np.testing.assert_allclose(out.numpy(), pallas, atol=TOL)


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_split_kv_row_with_no_visible_key_is_zero(n_split):
    # keys hold positions 5..260; queries sit at 3..6, so rows 0 and 1 see
    # nothing (causal) and rows 2 and 3 see a few keys of the first tile
    q, k, v = _qkv(1, 4, 2, 4, 256, 32, seed=9)
    kpos = (np.arange(256) + 5).astype(np.int32)
    kw = dict(causal=True, window=0, softcap=0.0, q_offset=3)
    out = split_kv_attention(_t(q), _t(k), _t(v), n_split=n_split,
                             kv_positions=_t(kpos), **kw)
    ref = chunked_attention(_t(q), _t(k), _t(v), kv_positions=_t(kpos), chunk=64, **kw)
    jax_ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     kv_positions=jnp.asarray(kpos), chunk=64, **kw))
    assert not out[:, :2].any()
    assert out[:, 2:].abs().amax() > 0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL)
    np.testing.assert_allclose(out.numpy(), jax_ref, atol=TOL)


def test_split_kv_keeps_bf16_inputs_in_their_type():
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(2, 8, 4, 1, 128, 32, seed=4))
    kpos = _t(_ring(128, 70, 71))
    kw = dict(causal=True, window=16, softcap=50.0, q_offset=70, kv_positions=kpos)
    out = split_kv_attention(q, k, v, n_split=2, **kw)
    assert out.dtype == torch.bfloat16
    # one rounding of the same f32 value on both sides
    np.testing.assert_allclose(out.float().numpy(),
                               chunked_attention(q, k, v, **kw).float().numpy(), atol=2e-2)


def test_split_plan_is_a_function_of_shapes_alone():
    params = list(inspect.signature(split_kv_plan).parameters)
    assert params == ["B", "Hkv", "Skv"]
    # the served shapes: gemma2-2b (B4 x Hkv 4) and jamba (B4 x Hkv 8), 1024 slots
    assert split_kv_plan(4, 4, 1024) == (16, 1)
    assert split_kv_plan(4, 8, 1024) == (8, 2)
    for B in (1, 2, 4, 7, 64):
        for Hkv in (1, 2, 4, 8, 16):
            for Skv in (1, 63, 64, 65, 200, 1024, 4097, 32768):
                n_split, per = split_kv_plan(B, Hkv, Skv)
                n_tiles = -(-Skv // SPLIT_TILE)
                assert isinstance(n_split, int) and isinstance(per, int)
                assert per >= 1 and 1 <= n_split <= n_tiles
                # every tile is covered, and every split has at least one tile
                assert n_split * per >= n_tiles and (n_split - 1) * per < n_tiles
                # as many blocks as the target asks for, where the tiles allow
                if n_tiles * B * Hkv >= SPLIT_TARGET_BLOCKS:
                    assert n_split * B * Hkv >= SPLIT_TARGET_BLOCKS // 2


@pytest.mark.parametrize("dtype,Sq,Hq,Hkv,kind", [
    (torch.bfloat16, 1, 8, 4, "split_kv"),          # gemma2-2b decode
    (torch.bfloat16, 1, 32, 8, "split_kv"),         # jamba decode
    (torch.bfloat16, 512, 8, 4, "tensor_core"),     # gemma2-2b prefill
    (torch.bfloat16, 8, 4, 2, "split_kv"),          # Sq x G = 16: the last split-KV shape
    (torch.bfloat16, 17, 2, 2, "tensor_core"),      # Sq x G = 17
    (torch.bfloat16, 1, 16, 1, "split_kv"),         # G = 16, the most a kv head takes
    (torch.float32, 1, 8, 4, "fma"),
    (torch.float32, 512, 8, 4, "fma"),
])
def test_kernel_choice(dtype, Sq, Hq, Hkv, kind):
    assert kernel_for(dtype, Sq, Hq, Hkv) == kind
