"""Reduced gemma2-2b in the port against the JAX package on the same weights:
the JAX ``init_params`` pytree is carried across with ``params_from_numpy``.
The reduced config has window 8, so the local layer's ring cache wraps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models.attention import rope as jax_rope  # noqa: E402
from repro.models.model import embed_tokens as jax_embed  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import init_cache as jax_init_cache  # noqa: E402
from repro.train.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.train.steps import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.attention import rope  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import embed_tokens, forward, init_cache  # noqa: E402
from repro_torch.models.schema import count_params  # noqa: E402
from repro_torch.train.steps import make_prefill_step, make_serve_step  # noqa: E402

ARCH = "gemma2-2b"
B, PROMPT, MAX_SEQ, DECODE_STEPS = 2, 12, 32, 6
# f32 on the CPU; the two frameworks differ only in matmul/transcendental
# rounding, which grows through 2 layers, 48x embedding and the softcaps
LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5
HIDDEN_ATOL = 1e-4     # pre-norm hidden states: 48x embedding, 2 layers


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _check_cache(cache, jcache):
    assert set(cache) == set(jcache)
    for key, ent in cache.items():
        np.testing.assert_array_equal(ent["kpos"].numpy(), np.asarray(jcache[key]["kpos"]))
        for n in ("k", "v"):
            np.testing.assert_allclose(ent[n].numpy(), np.asarray(jcache[key][n]),
                                       atol=CACHE_ATOL, err_msg=f"{key}/{n}")


def test_config_copy_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                 "vocab_size", "pattern", "window", "attn_softcap", "final_softcap",
                 "scale_embed", "act", "norm", "dtype", "n_repeat", "n_experts",
                 "top_k", "expert_d_ff", "router_aux_coef", "ssm_d_state", "ssm_conv",
                 "ssm_expand", "ssm_d_inner", "dt_rank"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
        assert getattr(cfg.reduced(), name) == getattr(jcfg.reduced(), name), name
    assert count_params(cfg) == jax_schema.count_params(jcfg)
    with pytest.raises(KeyError, match="known"):
        get_config("no-such-arch")


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(5, 12, dtype=np.int32)
    ref = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    out = rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_embed_tokens_matches_reference(models):
    jcfg, jparams, cfg, params = models
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 9))
    ref = np.asarray(jax_embed(jcfg, jparams, jnp.asarray(tok, jnp.int32)))
    out = embed_tokens(cfg, params, torch.from_numpy(tok))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_prefill_and_decode_match_reference(models):
    jcfg, jparams, cfg, params = models
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, PROMPT))

    jlogits, jcache = jax.jit(jax_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        jax_init_cache(jcfg, B, MAX_SEQ))
    cache = init_cache(cfg, B, MAX_SEQ, device="cpu")
    logits, cache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(tokens)}, cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    _check_cache(cache, jcache)
    # the local layer's ring (L = window = 8) wrapped during the 12-token prompt
    assert sorted(cache["b0_attn_local"]["kpos"][0].tolist()) == list(range(4, 12))

    jstep, step = jax.jit(jax_serve_step(jcfg)), make_serve_step(cfg)
    pos = PROMPT
    for _ in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None]
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos))
        logits, cache = step(params, cache, torch.from_numpy(tok.astype(np.int64)), pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=LOGITS_ATOL, err_msg=f"decode pos {pos}")
        pos += 1
    _check_cache(cache, jcache)


def test_train_forward_matches_reference(models):
    """Cacheless full-sequence forward; 12 keys cross the reduced config's
    8-key attention chunk."""
    jcfg, jparams, cfg, params = models
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, PROMPT))
    jh, _, _ = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, mode="train"))(
        jparams, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        h, cache, _ = forward(cfg, params, {"tokens": torch.from_numpy(tokens)}, mode="train")
    assert cache is None
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=HIDDEN_ATOL)
