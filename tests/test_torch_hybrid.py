"""jamba's hybrid block (mamba + attention + MoE) in the port against the JAX
package on the same weights: the mamba and MoE blocks alone, then the whole
reduced model (prefill and decode logits, caches, greedy serving).

The reduced jamba config keeps one block per distinct mixer, so it has no
MoE layer. These tests build both sides from ``reduced()`` with jamba's full
8-block pattern (``JAMBA8``: 7 mamba, 1 attention, 4 MoE, 4 MLP layers), and
with a 2-block pattern over 4 layers (``STACKED``), whose caches and weights
are stacked with ``n_repeat`` 2."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import init_cache as jax_init_cache  # noqa: E402
from repro.models.moe import _router as jax_router  # noqa: E402
from repro.models.moe import moe_local as jax_moe_local  # noqa: E402
from repro.models.ssm import mamba_block as jax_mamba_block  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.train.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.train.steps import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward, init_cache  # noqa: E402
from repro_torch.models.moe import _router, moe_local  # noqa: E402
from repro_torch.models.schema import count_params, init_params  # noqa: E402
from repro_torch.models.ssm import mamba_block  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.train.steps import make_prefill_step, make_serve_step  # noqa: E402

ARCH = "jamba-v0.1-52b"
JAMBA8 = (get_config(ARCH).pattern, 8)
STACKED = ((("mamba", "moe"), ("attn", "mlp")), 4)
B, PROMPT, MAX_SEQ, DECODE_STEPS = 2, 12, 32, 4
# f32 on the CPU, as slice 1's tests: the two frameworks differ only in
# matmul and transcendental rounding, which grows through the layers
LOGITS_ATOL = 1e-4
HIDDEN_ATOL = 1e-4
# one block's output: a few f32 roundings of O(1) values
BLOCK_ATOL = 1e-5
# caches: K/V as slice 1's; the f32 SSM state is carried through the
# recurrence over the whole prompt, after up to 8 layers, so it also gets a
# relative term of ~80 f32 ulps
CACHE_ATOL = 1e-5
CACHE_RTOL = 1e-5


def _build(pattern, n_layers, seed=0):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), pattern=pattern,
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), pattern=pattern,
                              n_layers=n_layers)
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jamba8():
    return _build(*JAMBA8)


@pytest.fixture(scope="module")
def stacked():
    return _build(*STACKED)


def _layer(jparams, params, key, r=0):
    return (jax.tree.map(lambda t: t[r], jparams["dec"][key]),
            {n: t[r] for n, t in params["dec"][key].items()})


def _x(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _check_cache(cache, jcache):
    assert set(cache) == set(jcache)
    for key, ent in cache.items():
        assert set(ent) == set(jcache[key]), key
        for n, t in ent.items():
            ref = np.asarray(jcache[key][n])
            assert t.dtype == getattr(torch, str(ref.dtype)), (key, n)
            if n == "kpos":
                np.testing.assert_array_equal(t.numpy(), ref)
            else:
                np.testing.assert_allclose(t.numpy(), ref, atol=CACHE_ATOL,
                                           rtol=CACHE_RTOL, err_msg=f"{key}/{n}")


def test_jamba_config_copy_matches_reference():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                     "vocab_size", "pattern", "use_rope", "window", "n_experts", "top_k",
                     "expert_d_ff", "router_aux_coef", "ssm_d_state", "ssm_conv",
                     "ssm_expand", "ssm_d_inner", "dt_rank", "act", "norm", "dtype",
                     "n_repeat"):
            assert getattr(c, name) == getattr(jc, name), name
    assert count_params(cfg) == jax_schema.count_params(jcfg)
    # the depth chip_smoke.py serves on one card: one period of the block
    cut, jcut = (dataclasses.replace(c, n_layers=8) for c in (cfg, jcfg))
    assert count_params(cut) == jax_schema.count_params(jcut) == 13_295_235_072


def test_init_params_matches_reference_layout_and_fixed_inits(jamba8):
    """The port's own init: the reference's tree, shapes and dtypes; the
    leaves that are not random (norm scales, conv bias, mamba's a_log,
    dt_bias and D) equal the reference's."""
    jcfg, jparams, cfg, _ = jamba8
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    ours = {n: t for n, t in params.named_parameters()}
    assert len(ours) == len(ref)
    for path, jt in ref.items():
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        t = ours[name]
        assert tuple(t.shape) == jt.shape and t.dtype == torch.float32, name
        if name.rsplit(".", 1)[-1] in ("a_log", "dt_bias", "d_skip", "conv_b") \
                or name.endswith("norm_scale"):
            np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, err_msg=name)


def test_mamba_block_matches_reference(jamba8):
    """Prefill from zero caches, two decode steps, and the cacheless form."""
    jcfg, jparams, cfg, params = jamba8
    jp, p = _layer(jparams, params, "b0_mamba")
    jc = jax.tree.map(lambda t: t[0], jax_init_cache(jcfg, B, MAX_SEQ)["b0_mamba"])
    c = {n: t[0] for n, t in init_cache(cfg, B, MAX_SEQ, device="cpu")["b0_mamba"].items()}
    jblock = jax.jit(jax_mamba_block, static_argnums=0, static_argnames="mode")
    with torch.inference_mode():
        for step, (mode, S) in enumerate([("prefill", 7), ("decode", 1), ("decode", 1)]):
            x = _x(cfg, S, seed=step)
            jy, jc = jblock(jcfg, jp, jnp.asarray(x), mode=mode, cache=jc)
            y = mamba_block(cfg, p, torch.from_numpy(x), mode=mode, cache=c)
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=BLOCK_ATOL,
                                       err_msg=f"{mode} {step}")
            _check_cache({"m": c}, {"m": jc})
        x = _x(cfg, 9, seed=5)
        jy, _ = jblock(jcfg, jp, jnp.asarray(x), mode="train")
        y = mamba_block(cfg, p, torch.from_numpy(x), mode="train")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=BLOCK_ATOL)


def test_moe_local_matches_reference(jamba8):
    jcfg, jparams, cfg, params = jamba8
    jp, p = _layer(jparams, params, "b1_moe")
    x = _x(cfg, 10, seed=6)
    hf = x.reshape(-1, cfg.d_model)
    jtop_p, jtop_i, jaux = jax_router(jcfg, jp, jnp.asarray(hf))
    top_p, top_i, aux = _router(cfg, p, torch.from_numpy(hf))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    # every expert gets rows, and top-k is 2 of 4: the dispatch is ragged
    assert len(np.unique(top_i.numpy())) == cfg.n_experts
    jy, jaux = jax_moe_local(jcfg, jp, jnp.asarray(x))
    with torch.inference_mode():
        y, aux = moe_local(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=BLOCK_ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("layout", ["jamba8", "stacked"])
def test_prefill_and_decode_match_reference(layout, request):
    jcfg, jparams, cfg, params = request.getfixturevalue(layout)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, PROMPT))
    jlogits, jcache = jax.jit(jax_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        jax_init_cache(jcfg, B, MAX_SEQ))
    cache = init_cache(cfg, B, MAX_SEQ, device="cpu")
    logits, cache = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens)}, cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL)
    _check_cache(cache, jcache)

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


def test_train_forward_matches_reference(jamba8):
    jcfg, jparams, cfg, params = jamba8
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, PROMPT))
    jh, _, _ = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, mode="train"))(
        jparams, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        h, cache, _ = forward(cfg, params, {"tokens": torch.from_numpy(tokens)}, mode="train")
    assert cache is None
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=HIDDEN_ATOL)


@pytest.mark.parametrize("layout", ["jamba8", "stacked"])
def test_greedy_tokens_match_reference_engine(layout, request):
    jcfg, jparams, cfg, params = request.getfixturevalue(layout)
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


def test_serve_cli_runs_reduced_jamba_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                "--prompt-len", "8", "--max-new", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} device=cpu: served 3 requests, 9 tokens" in out
