"""yi-9b, grok-1-314b, starcoder2-3b, phi3-mini-3.8b and kimi-k2-1t-a32b in
the port against the JAX package, on the CPU, on the same weights: the JAX
``init_params`` pytree is carried across with ``params_from_numpy``, and
inputs are drawn with numpy from a seed.

Each arch runs at its ``reduced()`` config (one layer of its one-block
pattern) and at a 2-layer stack of it (``n_repeat`` 2, so weights and caches
are stacked). The reduced configs keep each family's mechanism: grok's MoE
in every layer and its softcaps of 30, starcoder2's LayerNorm, plain GELU
MLP and ``rope_theta`` of 999,999.44, kimi's MoE in every layer. They keep 4
query heads over 2 kv heads at head dim 64, so the served group sizes (yi
8, grok 6, starcoder2 12, phi3 1, kimi 8) are held by the attention tests at
the bottom of this file, and phi3 and kimi run a third layout at their real
head dims, 96 and 112 (``REAL_HEAD_DIM``); kimi's 384 experts with top-8
routing are held on one MoE layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import DataPipeline as JaxDataPipeline  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro.models.layers import mlp_block as jax_mlp_block  # noqa: E402
from repro.models.layers import norm as jax_norm  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import init_cache as jax_init_cache  # noqa: E402
from repro.optim import optimizers as jax_optim  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.train.steps import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.train.steps import make_serve_step as jax_serve_step  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    kernel_for, split_kv_plan)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import split_kv_attention  # noqa: E402
from repro_torch.launch import serve, train_devices  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import mlp_block, norm  # noqa: E402
from repro_torch.models.model import forward, init_cache  # noqa: E402
from repro_torch.models.schema import count_params, init_params  # noqa: E402
from repro_torch.optim.optimizers import init_opt_state  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.train.steps import (make_prefill_step, make_serve_step,  # noqa: E402
                                     make_train_step)

ARCHS = ("yi-9b", "grok-1-314b", "starcoder2-3b", "phi3-mini-3.8b", "kimi-k2-1t-a32b")
# the reference's count_params at full size
FULL_PARAMS = {"yi-9b": 8_829_407_232, "grok-1-314b": 316_489_340_928,
               "starcoder2-3b": 3_180_705_792, "phi3-mini-3.8b": 3_821_079_552,
               "kimi-k2-1t-a32b": 1_041_166_988_288}
LAYOUTS = ("reduced", "stacked")
# a third layout of the reduced config at the arch's own head dim, which
# ``reduced()`` (d_model 256 over 4 heads) sets to 64: phi3's 96 with its 4
# query heads over 4 kv heads (MHA, as phi3's 32 over 32), kimi's 112
REAL_HEAD_DIM = {"phi3-mini-3.8b": dict(head_dim=96, d_model=384, n_kv_heads=4),
                 "kimi-k2-1t-a32b": dict(head_dim=112, d_model=448)}
MODEL_CASES = ([(arch, layout) for arch in ARCHS for layout in LAYOUTS]
               + [(arch, "real_head_dim") for arch in REAL_HEAD_DIM])
B, PROMPT, MAX_SEQ, DECODE_STEPS = 2, 12, 32, 6
# f32 on the CPU, as tests/test_torch_model.py: the two frameworks differ
# only in matmul and transcendental rounding, which grows through the layers
LOGITS_ATOL = 1e-4
CACHE_ATOL = 1e-5
HIDDEN_ATOL = 1e-4
# three AdamW steps at lr 1e-3, as tests/test_torch_train.py holds them,
# each limit about 3-4x what the CPU measured (the 2-layer stacks of yi and
# starcoder2 at 2.3x: no limit here exceeds the first one, 3e-4). Loss, aux
# loss and grad norm measured within 1.9e-6 everywhere: 6e-6.
# The gradients (test_gradients_match_reference_each_step, on the
# reference's weights at each step) agree within 1.8e-6 of each tensor's
# largest |g| in every case (worst: yi and phi3 stacks, w_up, step 1): f32
# rounding, held at GRAD_RTOL 1e-5. The weights: AdamW moves a weight by
# lr m / (sqrt(v) + 1e-8) whatever its gradient's size, so a gradient that
# cancels to within a few 1e-8 of 0 carries its rounding into a step of up
# to ~lr. Every weight measured beyond a third of its limit had such a
# gradient at step 0 (yi w_gate: -8.9e-9 in the port, +9.9e-10 in the
# reference, against an rms of 4.1e-3 over the tensor; kimi's real-head-dim
# wq 6.2e-9 against 1.3e-8) and gradients equal to 5 digits at steps 1-2.
# Where such a weight lands depends on the host's BLAS and XLA's threading:
# on an 8-core Xeon (AVX-512) at torch threads 1 and 4, against XLA's
# default and single-threaded Eigen, the worst weight of every tensor lay
# within 1.32e-4 (0.13 lr; starcoder2 stack wq, yi and phi3 stack w_gate;
# kimi 8.3e-5, its real-head-dim wq) and the second worst within 4.2e-5
# (99.99th percentile under 1.8e-6), while an 8-core EPYC put one of kimi's
# wq weights 1.91e-4 away. So the bulk of each tensor is held at
# STEP_PARAM_ATOL, at most STEP_PARAM_OUTLIERS weights of a tensor may lie
# outside it (measured: at most 1 a tensor beyond a third of it on the Xeon,
# 1 beyond it on the EPYC), and none farther than STEP_PARAM_MAX_OVER_LR x lr
# (0.13-0.19 lr measured). What the restated check still catches, from
# mutations of the port's AdamW in a copy of the tree (the Xeon, torch
# threads 1-2): eps 1e-7, or the bias correction a step late, fails it in
# all 12 cases (167-461,952 weights of a tensor outside, 0.8-3.3 lr);
# eps 2e-8 in 10 of 12 (grok reduced by the weights alone, its metrics
# within 5.3e-6), the other 2 on the metrics; eps 1.25e-8 in 1, and the test
# as a whole in 4, among them the 3 that holding every weight caught
STEP_METRIC_ATOL = 6e-6
GRAD_RTOL = 1e-5
STEP_LR = 1e-3
STEP_PARAM_OUTLIERS, STEP_PARAM_MAX_OVER_LR = 2, 0.5
STEP_PARAM_ATOL = {("yi-9b", "reduced"): 1.5e-4, ("yi-9b", "stacked"): 3e-4,
                   ("grok-1-314b", "reduced"): 1.5e-4, ("grok-1-314b", "stacked"): 1.5e-4,
                   ("starcoder2-3b", "reduced"): 1.5e-4, ("starcoder2-3b", "stacked"): 3e-4,
                   ("phi3-mini-3.8b", "reduced"): 1.5e-4, ("phi3-mini-3.8b", "stacked"): 3e-4,
                   ("phi3-mini-3.8b", "real_head_dim"): 2.5e-4,
                   ("kimi-k2-1t-a32b", "reduced"): 1.5e-4, ("kimi-k2-1t-a32b", "stacked"): 1.5e-4,
                   ("kimi-k2-1t-a32b", "real_head_dim"): 3e-4}


def _cfgs(arch, layout):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if layout == "stacked":
        jcfg = dataclasses.replace(jcfg, n_layers=2 * len(jcfg.pattern))
        cfg = dataclasses.replace(cfg, n_layers=2 * len(cfg.pattern))
    elif layout == "real_head_dim":
        jcfg = dataclasses.replace(jcfg, **REAL_HEAD_DIM[arch])
        cfg = dataclasses.replace(cfg, **REAL_HEAD_DIM[arch])
    return jcfg, cfg


_MODELS = {}


def _models(arch, layout):
    """(jcfg, jax params, cfg, port params), built once per module."""
    if (arch, layout) not in _MODELS:
        jcfg, cfg = _cfgs(arch, layout)
        jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _MODELS[arch, layout] = jcfg, jparams, cfg, params
    return _MODELS[arch, layout]


def _check_cache(cache, jcache):
    assert set(cache) == set(jcache)
    for key, ent in cache.items():
        np.testing.assert_array_equal(ent["kpos"].numpy(), np.asarray(jcache[key]["kpos"]))
        for n in ("k", "v"):
            np.testing.assert_allclose(ent[n].numpy(), np.asarray(jcache[key][n]),
                                       atol=CACHE_ATOL, err_msg=f"{key}/{n}")


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert cfg.source == jcfg.source and cfg.family == jcfg.family
    for c, jc in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                     "vocab_size", "pattern", "rope_theta", "use_rope", "window",
                     "attn_softcap", "final_softcap", "scale_embed", "act", "norm",
                     "norm_f32", "dtype", "n_repeat", "n_experts", "top_k", "expert_d_ff",
                     "router_aux_coef", "long_context_window", "abs_pos"):
            assert getattr(c, name) == getattr(jc, name), name
    assert count_params(cfg) == jax_schema.count_params(jcfg) == FULL_PARAMS[arch]


def test_kimi_cut_served_on_one_card():
    """The depth chip_smoke.py serves: one of kimi-k2's 61 layers (one period
    of its pattern) is 19.38B weights, 38.8 GB in bf16; two would be 72.8 GB,
    more than grok's 7 layers (72.1 GB), which leave too little of an 80 GB
    card to serve in."""
    cfg, jcfg = get_config("kimi-k2-1t-a32b"), jax_get_config("kimi-k2-1t-a32b")
    assert cfg.pattern == (("attn", "moe"),)
    for n, want in ((1, 19_378_623_488), (2, 36_408_429_568)):
        cut, jcut = (dataclasses.replace(c, n_layers=n) for c in (cfg, jcfg))
        assert count_params(cut) == jax_schema.count_params(jcut) == want


def test_grok_cut_served_on_one_card():
    """The depth chip_smoke.py serves: 6 of grok's 64 layers fit one 80 GB
    card in bf16 (62.3 GB), 7 do not leave room to serve (72.1 GB)."""
    cfg, jcfg = get_config("grok-1-314b"), jax_get_config("grok-1-314b")
    for n, want in ((6, 31_130_499_072), (7, 36_050_479_104)):
        cut, jcut = (dataclasses.replace(c, n_layers=n) for c in (cfg, jcfg))
        assert count_params(cut) == jax_schema.count_params(jcut) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout_and_fixed_inits(arch):
    """The port's own init: the reference's tree, shapes and dtypes, with
    LayerNorm's bias (zeros) beside its scale (ones) for starcoder2."""
    jcfg, jparams, cfg, _ = _models(arch, "reduced")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = _flat(jparams)
    ours = {n.replace(".", "/"): t for n, t in params.named_parameters()}
    assert set(ours) == set(ref)
    for name, jt in ref.items():
        t = ours[name]
        assert tuple(t.shape) == jt.shape and t.dtype == torch.float32, name
        if name.endswith(("norm_scale", "norm_bias")):
            np.testing.assert_array_equal(t.numpy(), jt, err_msg=name)
    assert any(n.endswith("norm_bias") for n in ours) == (cfg.norm == "layernorm")


def test_large_leaf_drawn_a_slice_at_a_time():
    """A leaf over ``_DRAW_WHOLE`` elements is drawn one leading slice at a
    time: the same scale, each slice its own draw from the generator."""
    from repro_torch.models import schema
    d = schema.ParamDef((3, 40, 50))
    whole = schema._init_leaf(d, torch.Generator().manual_seed(1), "cpu", torch.float32)
    old = schema._DRAW_WHOLE
    schema._DRAW_WHOLE = 100
    try:
        sliced = schema._init_leaf(d, torch.Generator().manual_seed(1), "cpu", torch.bfloat16)
    finally:
        schema._DRAW_WHOLE = old
    g = torch.Generator().manual_seed(1)
    want = torch.stack([torch.randn((40, 50), generator=g) * 40 ** -0.5 for _ in range(3)])
    assert sliced.dtype == torch.bfloat16 and sliced.shape == whole.shape
    assert torch.equal(sliced, want.to(torch.bfloat16))
    assert abs(whole.std().item() - 40 ** -0.5) < 0.02


def test_large_leaf_of_one_layer_drawn_a_slice_at_a_time():
    """With one layer the leading (layer) axis has one slice: the draw goes
    along the next axis, the experts, as kimi-k2's (1, 384, 7168, 2048)."""
    from repro_torch.models import schema
    d = schema.ParamDef((1, 3, 40, 50))
    old = schema._DRAW_WHOLE
    schema._DRAW_WHOLE = 2500
    try:
        sliced = schema._init_leaf(d, torch.Generator().manual_seed(2), "cpu", torch.bfloat16)
    finally:
        schema._DRAW_WHOLE = old
    g = torch.Generator().manual_seed(2)
    want = torch.stack([torch.randn((40, 50), generator=g) * 40 ** -0.5 for _ in range(3)])
    assert sliced.shape == (1, 3, 40, 50)
    assert torch.equal(sliced[0], want.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# LayerNorm and the GELU MLP
# ---------------------------------------------------------------------------
# f32: one f32 rounding of O(1) values. bf16: both round one f32 value to
# bf16, and the f32 statistics differ by a few f32 ulps, so a value may land
# one bf16 ulp apart (2**-8 relative at most)
NORM_TOL = {"float32": (2e-6, 0.0), "bfloat16": (0.0, 2 ** -8)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    cfg, jcfg = get_config("starcoder2-3b").reduced(), jax_get_config("starcoder2-3b").reduced()
    rng = np.random.default_rng(0)
    D = cfg.d_model
    x = (rng.standard_normal((2, 5, D)) * 3 + 1.5).astype(np.float32)
    p = {"norm_scale": (rng.standard_normal(D) * 0.2 + 1).astype(np.float32),
         "norm_bias": (rng.standard_normal(D) * 0.3).astype(np.float32)}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jax_norm(jcfg, {k: jnp.asarray(v, jd) for k, v in p.items()},
                              jnp.asarray(x, jd)), np.float32)
    out = norm(cfg, {k: torch.from_numpy(v).to(td) for k, v in p.items()},
               torch.from_numpy(x).to(td))
    assert out.dtype == td
    atol, rtol = NORM_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=rtol)
    # the row's mean is taken out: a shifted row normalises to the same values
    shifted = norm(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(x + 100.0))
    np.testing.assert_allclose(shifted.numpy(), norm(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)).numpy(),
        atol=1e-4)
    with pytest.raises(NotImplementedError, match="f32"):
        norm(dataclasses.replace(cfg, norm_f32=False), p, torch.from_numpy(x))


# (atol, rtol). f32: a few f32 roundings of O(1) values through two matmuls.
# bf16: each side rounds the hidden layer to bf16 its own way (the reference
# each of gelu's elementwise steps, the port once after an f32 gelu), which
# through w_down puts each 1.8e-2 from the f32 result; the output's own
# rounding adds one bf16 ulp of the value (2**-7 relative)
MLP_TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2 ** -7)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_block_matches_reference(dtype):
    cfg, jcfg = get_config("starcoder2-3b").reduced(), jax_get_config("starcoder2-3b").reduced()
    assert cfg.act == "gelu"
    rng = np.random.default_rng(1)
    D, Fh = cfg.d_model, cfg.d_ff
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    p = {"w_up": (rng.standard_normal((D, Fh)) * D ** -0.5).astype(np.float32),
         "w_down": (rng.standard_normal((Fh, D)) * Fh ** -0.5).astype(np.float32),
         "norm_scale": (rng.standard_normal(D) * 0.1 + 1).astype(np.float32),
         "norm_bias": (rng.standard_normal(D) * 0.1).astype(np.float32)}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jax_mlp_block(jcfg, {k: jnp.asarray(v, jd) for k, v in p.items()},
                                   jnp.asarray(x, jd)), np.float32)
    out = mlp_block(cfg, {k: torch.from_numpy(v).to(td) for k, v in p.items()},
                    torch.from_numpy(x).to(td))
    assert out.dtype == td
    atol, rtol = MLP_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=rtol)
    if dtype == "float32":
        # jax.nn.gelu is the tanh form by default; the erf form (F.gelu's
        # default) would miss the f32 limit by over an order of magnitude
        pt = {k: torch.from_numpy(v) for k, v in p.items()}
        h = norm(cfg, pt, torch.from_numpy(x))
        erf = torch.from_numpy(x) + torch.nn.functional.gelu(h @ pt["w_up"]) @ pt["w_down"]
        assert np.abs(erf.numpy() - ref).max() > 10 * atol


# ---------------------------------------------------------------------------
# the whole model: serving, the train forward, three AdamW steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,layout", MODEL_CASES)
def test_prefill_and_decode_match_reference(arch, layout):
    jcfg, jparams, cfg, params = _models(arch, layout)
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


@pytest.mark.parametrize("arch,layout", MODEL_CASES)
def test_train_forward_matches_reference(arch, layout):
    """Cacheless full-sequence forward; 12 keys cross the reduced config's
    8-key attention chunk. grok's aux loss (its MoE layers') is held too."""
    jcfg, jparams, cfg, params = _models(arch, layout)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, PROMPT))
    jh, _, jaux = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}, mode="train"))(
        jparams, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        h, cache, aux = forward(cfg, params, {"tokens": torch.from_numpy(tokens)}, mode="train")
    assert cache is None
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=HIDDEN_ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6, atol=1e-9)
    assert (aux.item() > 0) == (cfg.n_experts > 0)


def _loss_fn(train_step):
    """The ``loss_fn`` that a ``make_train_step`` closes over."""
    return train_step.__closure__[train_step.__code__.co_freevars.index("loss_fn")].cell_contents


@pytest.mark.parametrize("arch,layout", MODEL_CASES)
def test_gradients_match_reference_each_step(arch, layout):
    """Each of the three steps' gradients, on the same weights (the
    reference's after each of its steps) and the same batch: the port's from
    ``backward()`` of its train step's loss, the reference's from
    ``jax.grad`` of its train step's loss."""
    jcfg, jparams, cfg, _ = _models(arch, layout)
    kw = dict(learning_rate=STEP_LR, optimizer="adamw", loss_chunk=5)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jraw = jax_make_train_step(jcfg, jtc)
    jgrad, jstep = jax.jit(jax.grad(_loss_fn(jraw), has_aux=True)), jax.jit(jraw)
    loss_fn = _loss_fn(make_train_step(cfg, tc))
    jstate = jax_optim.init_opt_state(jtc, jparams)
    data = JaxDataPipeline(jcfg, 2, 12, seed=0)
    for i in range(3):
        batch = next(data)
        ref = _flat(jgrad(jparams, batch)[0])
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        params.requires_grad_(True)
        loss_fn(params, {k: torch.from_numpy(np.asarray(v, np.int64))
                         for k, v in batch.items()})[0].backward()
        for n, t in params.named_parameters():
            r = ref[n.replace(".", "/")]
            np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                       atol=GRAD_RTOL * np.abs(r).max(),
                                       err_msg=f"step {i} {n}")
        jparams, jstate, _ = jstep(jparams, jstate, batch)


@pytest.mark.parametrize("arch,layout", MODEL_CASES)
def test_three_adamw_steps_match_reference(arch, layout):
    jcfg, jparams, cfg, params = _models(arch, layout)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    kw = dict(learning_rate=STEP_LR, optimizer="adamw", loss_chunk=5)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = jax_optim.init_opt_state(jtc, jparams), init_opt_state(tc, params)
    jstep, step = jax.jit(jax_make_train_step(jcfg, jtc)), make_train_step(cfg, tc)
    data = JaxDataPipeline(jcfg, 2, 12, seed=0)
    for i in range(3):
        batch = next(data)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        params, state, m = step(params, state, {k: torch.from_numpy(np.asarray(v, np.int64))
                                                for k, v in batch.items()})
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=STEP_METRIC_ATOL,
                                       err_msg=f"step {i} {key}")
    ref = _flat(jparams)
    atol = STEP_PARAM_ATOL[arch, layout]
    for n, t in params.named_parameters():
        diff = np.abs(t.detach().numpy() - ref[n.replace(".", "/")])
        outside = int((diff > atol).sum())
        assert outside <= STEP_PARAM_OUTLIERS, (n, outside, float(diff.max()))
        assert diff.max() <= STEP_PARAM_MAX_OVER_LR * STEP_LR, (n, float(diff.max()))


@pytest.mark.parametrize("arch,layout", MODEL_CASES)
def test_greedy_tokens_match_reference_engine(arch, layout):
    jcfg, jparams, cfg, params = _models(arch, layout)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_reduced_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                "--prompt-len", "8", "--max-new", "3", "--max-seq", "32"])
    out = capsys.readouterr().out
    assert f"arch={arch} device=cpu: served 3 requests, 9 tokens" in out


def test_train_devices_copies_one_draw_to_each_device():
    # two CPU runs from the copied CPU draw: one curve, and the curve of a
    # Trainer drawing its own weights on the CPU from the same seed
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(), n_layers=2,
                              dtype="float32")
    out = train_devices.main(["--arch", "starcoder2-3b", "--reduced", "--layers", "2",
                              "--dtype", "float32", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--lr", "3e-4", "--devices", "cpu,cpu"])
    first, second = out["runs"]
    assert first["losses"] == second["losses"] and out["max_abs_diff_by_step"] == [0.0] * 3
    alone = Trainer(cfg, TrainConfig(optimizer="adamw", learning_rate=3e-4), 2, 16,
                    seed=0, device="cpu")
    alone.run(3)
    assert first["losses"] == alone.losses


# ---------------------------------------------------------------------------
# attention at the served group sizes
# ---------------------------------------------------------------------------
def _qkv(B, Hq, Hkv, Sq, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32))


def _ring(L, written):
    """kpos of a ring of L slots with positions 0..written-1 written."""
    kpos = np.full(L, 2 ** 30, np.int32)
    kpos[:written] = np.arange(written)
    return kpos


# Hq over Hkv as served: yi 32/4, grok 48/8 with its softcap, starcoder2
# 24/2, at head dim 32 (the kernels take the head dim as a template case; the
# grouping is what is new); phi3 32/32 (MHA) and kimi 64/8 at their own head
# dims, 96 and 112, which are new cases of the kernels. Groups of 6 and 12
# are not powers of two.
GROUPS = [("yi-9b", 32, 4, 0.0), ("grok-1-314b", 48, 8, 30.0), ("starcoder2-3b", 24, 2, 0.0),
          ("phi3-mini-3.8b", 32, 32, 0.0), ("kimi-k2-1t-a32b", 64, 8, 0.0)]
GROUP_HEAD_DIM = {"phi3-mini-3.8b": 96, "kimi-k2-1t-a32b": 112}


@pytest.mark.parametrize("arch,Hq,Hkv,cap", GROUPS)
def test_plain_attention_at_served_groups_matches_pallas_flash(arch, Hq, Hkv, cap):
    """Prefill: the plain path against the Pallas kernel in interpret mode."""
    cfg = get_config(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.attn_softcap) == (Hq, Hkv, cap)
    hd = GROUP_HEAD_DIM.get(arch, 32)
    assert hd in (32, cfg.head_dim)
    q, k, v = _qkv(1, Hq, Hkv, 40, 40, hd, seed=Hq)
    kw = dict(causal=True, window=0, softcap=cap, q_offset=0)
    pallas = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  bq=32, bk=32, interpret=True, **kw))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          chunk=16, **kw)
    np.testing.assert_allclose(out.numpy(), pallas, atol=2e-5)
    # on the card: the tensor-core kernel at prefill, split-KV at decode
    assert kernel_for(torch.bfloat16, 512, Hq, Hkv) == "tensor_core"
    assert kernel_for(torch.bfloat16, 1, Hq, Hkv) == "split_kv"


@pytest.mark.parametrize("arch,Hq,Hkv,cap", GROUPS)
def test_split_kv_at_served_groups_matches_jax_on_a_ring(arch, Hq, Hkv, cap):
    """Decode against a half-written ring: the plain path and the split-KV
    kernel's plain twin, at the split count the card uses for batch 4 and
    1024 slots, against the reference's chunked attention."""
    L, written = 256, 140
    q, k, v = _qkv(2, Hq, Hkv, 1, L, GROUP_HEAD_DIM.get(arch, 32), seed=Hkv)
    kpos = _ring(L, written)
    kw = dict(causal=True, window=0, softcap=cap, q_offset=written - 1)
    ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 kv_positions=jnp.asarray(kpos), chunk=64, **kw))
    t = torch.from_numpy
    out = flash_attention(t(q), t(k), t(v), kv_pos=t(kpos), **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    n_split, _ = split_kv_plan(4, Hkv, 1024)
    for n in sorted({1, 2, min(n_split, 4)}):
        twin = split_kv_attention(t(q), t(k), t(v), n_split=n, kv_positions=t(kpos), **kw)
        np.testing.assert_allclose(twin.numpy(), ref, atol=2e-5, err_msg=f"{n} splits")


# ---------------------------------------------------------------------------
# kimi-k2's routing: 384 experts, top-8
# ---------------------------------------------------------------------------
def test_moe_at_kimi_experts_matches_reference():
    """One MoE layer at kimi's 384 experts and top-8 over narrow widths and
    10 tokens: 80 assignments, so most experts get no row and the grouped
    matmul's groups are mostly empty. Weights and inputs are made as the
    reference's own MoE tests make them (``tests/test_moe.py``: each leaf of
    the layer's schema from ``_init_leaf`` with a folded key)."""
    from repro.models.moe import _router as jax_router
    from repro.models.moe import moe_local as jax_moe_local
    from repro_torch.models.moe import _router, moe_local
    full = get_config("kimi-k2-1t-a32b")
    kw = dict(n_experts=full.n_experts, top_k=full.top_k)
    jcfg = dataclasses.replace(jax_get_config("kimi-k2-1t-a32b").reduced(), **kw)
    cfg = dataclasses.replace(full.reduced(), **kw)
    assert (cfg.n_experts, cfg.top_k) == (384, 8)
    sch = jax_schema.model_schema(jcfg)["dec"]["b0_moe"]
    jp = {name: jax_schema._init_leaf(dataclasses.replace(d, shape=d.shape[1:]),
                                      jax.random.fold_in(jax.random.PRNGKey(0), i), jnp.float32)
          for i, (name, d) in enumerate(sch.items())}
    p = {name: torch.from_numpy(np.array(v)) for name, v in jp.items()}
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 5, cfg.d_model)))
    hf = x.reshape(-1, cfg.d_model)
    jtop_p, jtop_i, jaux = jax_router(jcfg, jp, jnp.asarray(hf))
    top_p, top_i, aux = _router(cfg, p, torch.from_numpy(hf))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), atol=1e-6)
    used = len(np.unique(top_i.numpy()))
    assert used <= 80 < cfg.n_experts - used     # most of the 384 groups are empty
    jy, jaux = jax_moe_local(jcfg, jp, jnp.asarray(x))
    with torch.inference_mode():
        y, aux = moe_local(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
