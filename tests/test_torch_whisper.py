"""whisper-large-v3, the encoder-decoder family, in the port against the JAX
package, on the CPU, on the same weights: the JAX ``init_params`` pytree is
carried across with ``params_from_numpy``, and inputs (tokens and the
encoder's frame embeddings) are drawn with numpy from a seed.

Layouts (``LAYOUTS``): ``reduced()`` (one decoder and one encoder layer, 4
query heads over 2 kv heads, 16 encoder frames); a stack of 2 decoder and 2
encoder layers; MHA, 4 over 4 heads at head dim 64, as whisper's 20 over 20;
and 20 encoder frames, not a multiple of the plain attention's 8-key chunk.

Two prefill paths: the reference's prefill step fed ``{"tokens",
"enc_embeds"}`` (the batch ``src/repro/launch/specs.py`` gives it), which
runs the encoder and fills the cross-attention cache ``ck`` / ``cv``; and
the reference's serving engine, which passes ``{"tokens"}`` alone, so cross
attention reads the cache's zeros. The port carries both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro.models.layers import sinusoidal_positions as jax_sinusoid  # noqa: E402
from repro.models.model import encode as jax_encode  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import init_cache as jax_init_cache  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.train.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.train.steps import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    kernel_for, split_kv_plan)
from repro_torch.kernels.flash_attention.ref import split_kv_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import sinusoidal_positions  # noqa: E402
from repro_torch.models.model import encode, forward, init_cache  # noqa: E402
from repro_torch.models.schema import count_params, init_params  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.train.steps import make_prefill_step, make_serve_step  # noqa: E402

ARCH = "whisper-large-v3"
# the reference's count_params at full size
FULL_PARAMS = 1_601_198_080
LAYOUTS = {"reduced": {},
           "stacked": dict(n_layers=2, n_enc_layers=2),
           "mha_hd64": dict(n_kv_heads=4),
           "enc_seq_20": dict(enc_seq=20)}
B, PROMPT, MAX_SEQ, DECODE_STEPS = 2, 12, 32, 6
# f32 on the CPU, the zoo's limits (tests/test_torch_zoo.py): the two
# frameworks differ only in matmul and transcendental rounding
LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5
HIDDEN_ATOL = 1e-4

_MODELS = {}


def _models(layout):
    """(jcfg, jax params, cfg, port params), built once per module."""
    if layout not in _MODELS:
        jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **LAYOUTS[layout])
        cfg = dataclasses.replace(get_config(ARCH).reduced(), **LAYOUTS[layout])
        jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _MODELS[layout] = jcfg, jparams, cfg, params
    return _MODELS[layout]


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, PROMPT))
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return tokens, frames


def _check_cache(cache, jcache):
    assert set(cache) == set(jcache)
    for key, ent in cache.items():
        assert set(ent) == set(jcache[key]) == {"k", "v", "kpos", "ck", "cv"}
        np.testing.assert_array_equal(ent["kpos"].numpy(), np.asarray(jcache[key]["kpos"]))
        for n in ("k", "v", "ck", "cv"):
            np.testing.assert_allclose(ent[n].numpy(), np.asarray(jcache[key][n]),
                                       atol=CACHE_ATOL, err_msg=f"{key}/{n}")


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the config, the schema, the weights
# ---------------------------------------------------------------------------
def test_config_copy_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert cfg.source == jcfg.source and cfg.family == jcfg.family == "encdec"
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for name in ("n_layers", "n_enc_layers", "enc_seq", "d_model", "n_heads",
                     "n_kv_heads", "head_dim", "d_ff", "vocab_size", "pattern", "use_rope",
                     "abs_pos", "window", "attn_softcap", "final_softcap", "act", "norm",
                     "norm_f32", "dtype", "n_repeat", "attn_chunk", "long_context_window",
                     "is_encdec"):
            assert getattr(c, name) == getattr(jc, name), name
    assert (cfg.n_enc_layers, cfg.enc_seq, cfg.head_dim) == (32, 1500, 64)
    assert (cfg.reduced().n_enc_layers, cfg.reduced().enc_seq) == (1, 16)
    assert count_params(cfg) == jax_schema.count_params(jcfg) == FULL_PARAMS


@pytest.mark.parametrize("layout", LAYOUTS)
def test_weights_carry_across_unchanged(layout):
    """``params_from_numpy`` takes the reference's tree whole (the decoder's
    ``c_*`` cross-attention weights, the ``enc`` stack, ``enc_final_norm_*``)
    and copies every weight bit for bit; the port's own ``init_params`` has
    the same tree, shapes and fixed inits."""
    jcfg, jparams, cfg, params = _models(layout)
    ref = _flat(jparams)
    ours = {n.replace(".", "/"): t for n, t in params.named_parameters()}
    assert set(ours) == set(ref)
    assert {"dec/b0_attn/c_wq", "dec/b0_attn/c_norm_bias", "enc/b0_attn/wq",
            "enc/b0_mlp/w_up", "enc_final_norm_scale"} <= set(ours)
    assert ours["enc/b0_attn/wq"].shape[0] == cfg.n_enc_layers
    for name, jt in ref.items():
        np.testing.assert_array_equal(ours[name].numpy(), jt, err_msg=name)
    drawn = {n.replace(".", "/"): t for n, t in init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu").named_parameters()}
    assert {n: tuple(t.shape) for n, t in drawn.items()} == {n: a.shape for n, a in ref.items()}
    for name in ("enc_final_norm_scale", "dec/b0_attn/c_norm_scale", "dec/b0_attn/c_norm_bias"):
        np.testing.assert_array_equal(drawn[name].numpy(), ref[name], err_msg=name)


def test_sinusoidal_positions_match_reference():
    """The encoder's 1,500 frames at d_model 1280, and decode offsets."""
    for seq, d, offset in ((1500, 1280, 0), (16, 256, 0), (8, 1280, 440), (1, 256, 447)):
        ref = np.asarray(jax_sinusoid(seq, d, offset=offset))
        out = sinusoidal_positions(seq, d, offset=offset)
        assert out.dtype == torch.float32 and out.shape == (seq, d)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, err_msg=f"{seq} {d} {offset}")
    bf = sinusoidal_positions(20, 256, offset=3, dtype=torch.bfloat16)
    assert torch.equal(bf, sinusoidal_positions(20, 256, offset=3).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the encoder, prefill with and without the encoder's input, decode, train
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", LAYOUTS)
def test_encoder_matches_reference(layout):
    jcfg, jparams, cfg, params = _models(layout)
    _, frames = _inputs(cfg, 1)
    ref = np.asarray(jax.jit(lambda p, f: jax_encode(jcfg, p, f))(jparams, jnp.asarray(frames)))
    with torch.inference_mode():
        out = encode(cfg, params, torch.from_numpy(frames))
    assert out.shape == (B, cfg.enc_seq, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), ref, atol=HIDDEN_ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_with_encoder_and_decode_match_reference(layout):
    """The reference's prefill step fed ``{"tokens", "enc_embeds"}``: logits
    and every cache entry (the ring's ``k``, ``v``, ``kpos`` and the
    encoder's ``ck``, ``cv``); then 6 decode steps, each token at its own
    absolute position, cross attention reading the cached ``ck`` / ``cv``."""
    jcfg, jparams, cfg, params = _models(layout)
    tokens, frames = _inputs(cfg, 2)
    jlogits, jcache = jax.jit(jax_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32), "enc_embeds": jnp.asarray(frames)},
        jax_init_cache(jcfg, B, MAX_SEQ))
    cache = init_cache(cfg, B, MAX_SEQ, device="cpu")
    assert cache["b0_attn"]["ck"].shape == (cfg.n_repeat, B, cfg.enc_seq, cfg.n_kv_heads,
                                            cfg.head_dim)
    logits, cache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(tokens), "enc_embeds": torch.from_numpy(frames)},
        cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    _check_cache(cache, jcache)
    assert cache["b0_attn"]["ck"].abs().max() > 0

    jstep, step = jax.jit(jax_serve_step(jcfg)), make_serve_step(cfg)
    pos = PROMPT
    for _ in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None]
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        logits, cache = step(params, cache, torch.from_numpy(tok.astype(np.int64)), pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL,
                                   err_msg=f"decode pos {pos}")
        pos += 1
    _check_cache(cache, jcache)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_without_encoder_input_reads_zeros(layout):
    """The reference's serving path: a prefill of ``{"tokens"}`` alone runs
    no encoder, so ``ck`` / ``cv`` stay 0 and cross attention adds 0."""
    jcfg, jparams, cfg, params = _models(layout)
    tokens, frames = _inputs(cfg, 3)
    jlogits, jcache = jax.jit(jax_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jax_init_cache(jcfg, B, MAX_SEQ))
    prefill = make_prefill_step(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)},
                            init_cache(cfg, B, MAX_SEQ, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    _check_cache(cache, jcache)
    assert not cache["b0_attn"]["ck"].any() and not cache["b0_attn"]["cv"].any()
    with_enc, _ = prefill(params, {"tokens": torch.from_numpy(tokens),
                                   "enc_embeds": torch.from_numpy(frames)},
                          init_cache(cfg, B, MAX_SEQ, device="cpu"))
    assert (with_enc - logits).abs().max() > 1e-3      # the encoder matters


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_forward_matches_reference(layout):
    """The cacheless forward with the encoder's input: 12 decoder keys cross
    the reduced config's 8-key chunk, as do 16 and 20 encoder frames."""
    jcfg, jparams, cfg, params = _models(layout)
    tokens, frames = _inputs(cfg, 4)
    jh, _, jaux = jax.jit(lambda p, t, f: jax_forward(
        jcfg, p, {"tokens": t, "enc_embeds": f}, mode="train"))(
        jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(frames))
    with torch.inference_mode():
        h, cache, aux = forward(cfg, params, {"tokens": torch.from_numpy(tokens),
                                              "enc_embeds": torch.from_numpy(frames)},
                                mode="train")
    assert cache is None
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=HIDDEN_ATOL)
    assert aux.item() == float(jaux) == 0.0


def test_train_mode_without_encoder_input_is_refused():
    """The reference fails inside cross attention on a None cache; the
    port says what is missing."""
    _, _, cfg, params = _models("reduced")
    tokens, _ = _inputs(cfg, 5)
    with pytest.raises(ValueError, match="enc_embeds"):
        forward(cfg, params, {"tokens": torch.from_numpy(tokens)}, mode="train")
    with pytest.raises(ValueError, match="enc_embeds"):
        forward(cfg, params, {"tokens": torch.from_numpy(tokens)}, mode="prefill")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_greedy_tokens_match_reference_engine(layout):
    """The serving engines, each fed prompts only, as the reference's is."""
    jcfg, jparams, cfg, params = _models(layout)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=12).astype(np.int32) for _ in range(3)]

    def serve_all(engine, req):
        for i, pr in enumerate(prompts):
            engine.submit(req(i, pr, max_new_tokens=6))
        return {r.request_id: r.output for r in engine.run_batch()}

    ref = serve_all(JaxServingEngine(jcfg, jparams, batch_size=3, max_seq=64), JaxRequest)
    out = serve_all(ServingEngine(cfg, params, batch_size=3, max_seq=64, device="cpu"),
                    Request)
    assert out == ref


def test_serve_cli_runs_reduced_on_cpu(capsys):
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "8", "--max-new", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu: served 3 requests, 9 tokens" in out
    assert [len(r.output) for r in done] == [3, 3, 3]


# ---------------------------------------------------------------------------
# the flash calls whisper makes
# ---------------------------------------------------------------------------
def test_whisper_flash_calls_go_to_the_tensor_core_and_split_kv_kernels():
    """MHA (G 1) at head dim 64: every bf16 call with more than 16 query
    rows is the tensor-core kernel's (the encoder's 1,500 frames, the
    decoder's prefill and its cross attention), every decode step the
    split-KV kernel's; the cross decode's 1,500 keys are 24 tiles in 4
    splits at batch 4."""
    cfg = get_config(ARCH)
    H = cfg.n_heads
    assert (cfg.n_kv_heads, cfg.head_dim) == (H, 64)
    for Sq in (1500, 224, 100, 17):
        assert kernel_for(torch.bfloat16, Sq, H, H) == "tensor_core"
    assert kernel_for(torch.bfloat16, 1, H, H) == "split_kv"
    assert kernel_for(torch.float32, 1500, 4, 2) == "fma"
    assert split_kv_plan(4, H, cfg.enc_seq) == (4, 6)


@pytest.mark.parametrize("n_split", [1, 4, 24])
def test_split_kv_twin_on_cross_decode_matches_reference(n_split):
    """The split-KV kernel's plain twin on cross attention's decode step:
    one query row a head against 1,500 keys, not causal, no ``kv_pos``
    (the kernel's null pointer), at 1, 4 (the card's plan at batch 4) and 24
    splits of one tile each, against the reference's chunked attention."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 1, 4, 64), (2, 1500, 4, 64), (2, 1500, 4, 64)))
    ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=False, chunk=64))
    out = split_kv_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             n_split=n_split, causal=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
