"""Gradients of the port against ``jax.grad`` of the JAX package, on the CPU.

Op gradients: each kernel op's ``torch.autograd.Function``
(``kernels.autograd.PlainGrad``), with the plain version standing in for
the kernel forward as it does nowhere on the card, against ``jax.grad`` of
the reference op's plain path. Model gradients: ``lm_loss + aux`` of the
reduced gemma2-2b and of a reduced hybrid with a MoE layer, carried across
with ``params_from_numpy``, against ``jax.grad`` of the reference's loss,
under every ``remat``. All in f32, inputs drawn with numpy from a seed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.kernels.gmm.ref import gmm_ref as jax_gmm_ref  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.ssm import selective_scan_ref as jax_scan_ref  # noqa: E402
from repro.train.steps import lm_loss as jax_lm_loss  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.autograd import PlainGrad, kernel_op  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.selective_scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.train.steps import lm_loss  # noqa: E402

# one op's input gradients in f32: a few roundings of O(1) sums apart
OP_ATOL = 2e-5
# the scan's: its state runs over 9 steps of f32 products and sums
SCAN_ATOL = 5e-5
# a weight's gradient of the reduced models' loss, relative to the largest
# entry of that weight's reference gradient: the frameworks' f32 matmul and
# transcendental roundings, grown through the layers and the backward (2.3e-6
# at most in these cases)
MODEL_GRAD_RTOL = 2e-5
# loss and aux of one forward
LOSS_ATOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _through_function(plain, *args):
    """The op as its CUDA path runs it, with ``plain`` standing in for the
    kernel: ``PlainGrad``'s forward, the plain version's gradient backward."""
    def stand_in(*a):
        with torch.no_grad():
            return plain(*a)
    out = kernel_op(stand_in, plain, *args)
    for o in out if isinstance(out, tuple) else (out,):
        assert type(o.grad_fn).__name__ == "PlainGradBackward", o.grad_fn
    return out


def _leaves(arrays):
    return [torch.from_numpy(a.copy()).requires_grad_(a.dtype == np.float32)
            for a in arrays]


def test_rmsnorm_function_grads_match_jax():
    rng = np.random.default_rng(0)
    x, sc, ct = _np(rng, 3, 7, 32), _np(rng, 32) + 1.0, _np(rng, 3, 7, 32)
    jg = jax.grad(lambda x_, s_: jnp.sum(jax_rmsnorm_ref(x_, s_, 1e-6) * ct),
                  argnums=(0, 1))(x, sc)
    xt, st = _leaves([x, sc])
    out = _through_function(rmsnorm_ref, xt, st, 1e-6)
    (out * torch.from_numpy(ct)).sum().backward()
    for got, ref in zip((xt.grad, st.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OP_ATOL)


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, hd, window, softcap, q_offset, ring kv_pos
    (2, 12, 12, 4, 2, 16, 0, 0.0, 0, False),
    (1, 12, 12, 4, 1, 16, 4, 5.0, 0, False),
    (2, 3, 16, 4, 2, 8, 6, 0.0, 20, True),
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,hd,window,softcap,q_offset,ring", FLASH_CASES)
def test_flash_function_grads_match_jax(B, Sq, Skv, Hq, Hkv, hd, window, softcap,
                                        q_offset, ring):
    """q, k and v take gradients; kv_pos and q_offset take none. The chunk
    (8) is below Skv, so the online-softmax form runs."""
    rng = np.random.default_rng(1)
    q, k, v = _np(rng, B, Sq, Hq, hd), _np(rng, B, Skv, Hkv, hd), _np(rng, B, Skv, Hkv, hd)
    ct = _np(rng, B, Sq, Hq, hd)
    # a wrapped ring of Skv slots: slot s holds the last position p = s mod Skv
    last = q_offset + Sq - 1
    kpos = (np.array([last - (last - s) % Skv for s in range(Skv)], np.int32)
            if ring else None)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset, chunk=8)
    jkp = None if kpos is None else jnp.asarray(kpos)
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(
        jax_chunked(q_, k_, v_, kv_positions=jkp, **kw) * ct), argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = _leaves([q, k, v])
    kp = None if kpos is None else torch.from_numpy(kpos)
    out = _through_function(flash_ops.flash_attention_plain, qt, kt, vt, kp, True, window, softcap,
                            q_offset, 8)
    (out * torch.from_numpy(ct)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OP_ATOL)


def test_gmm_function_grads_match_jax():
    """An empty group and rows past the last group (their output is 0, so
    their gradient is 0); group_sizes takes no gradient."""
    rng = np.random.default_rng(2)
    sizes = np.array([5, 0, 9, 4], np.int32)
    x, w, ct = _np(rng, 20, 8), _np(rng, 4, 8, 6), _np(rng, 20, 6)
    jg = jax.grad(lambda x_, w_: jnp.sum(jax_gmm_ref(x_, w_, jnp.asarray(sizes)) * ct),
                  argnums=(0, 1))(x, w)
    xt, wt = _leaves([x, w])
    out = _through_function(gmm_ref, xt, wt, torch.from_numpy(sizes))
    (out * torch.from_numpy(ct)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OP_ATOL)
    assert not xt.grad[18:].any()


@pytest.mark.parametrize("use_final_state", [True, False])
def test_scan_function_grads_match_jax(use_final_state):
    """Every input takes a gradient; without a use of the final state (as in
    training) its missing gradient counts as zero."""
    rng = np.random.default_rng(3)
    B, S, di, st = 2, 9, 6, 4
    u, b, c = _np(rng, B, S, di), _np(rng, B, S, st), _np(rng, B, S, st)
    dt = np.abs(_np(rng, B, S, di, scale=0.3)) + 0.01
    a = -np.abs(_np(rng, di, st)) - 0.1
    d_skip, h0 = _np(rng, di), _np(rng, B, di, st)
    cy, ch = _np(rng, B, S, di), _np(rng, B, di, st)

    def jloss(*args):
        y, hT = jax_scan_ref(*args)
        return jnp.sum(y * cy) + (jnp.sum(hT * ch) if use_final_state else 0.0)

    args = (u, dt, a, b, c, d_skip, h0)
    jg = jax.grad(jloss, argnums=tuple(range(7)))(*args)
    leaves = _leaves(args)
    y, hT = _through_function(selective_scan_ref, *leaves)
    loss = (y * torch.from_numpy(cy)).sum()
    if use_final_state:
        loss = loss + (hT * torch.from_numpy(ch)).sum()
    loss.backward()
    for t, ref in zip(leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=SCAN_ATOL)


def test_plain_grad_passes_integer_and_missing_inputs_through():
    """No gradient for an int tensor, None or a float; none asked, none made."""
    x = torch.randn(5, 3, requires_grad=True)
    idx = torch.tensor([2, 0, 1])

    def plain(x_, i_, missing, scale):
        assert missing is None and scale == 2.0
        return x_[:, i_] * scale

    out = PlainGrad.apply(plain, plain, x, idx, None, 2.0)
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full((5, 3), 2.0, np.float32))


# ---------------------------------------------------------------------------
# model gradients
# ---------------------------------------------------------------------------
HYBRID = (("mamba", "moe"), ("attn", "mlp"))
MODELS = {"gemma2": ("gemma2-2b", None, None),
          "hybrid": ("jamba-v0.1-52b", HYBRID, 4)}       # n_repeat 2
B, S = 2, 12


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    arch, pattern, n_layers = MODELS[request.param]
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if pattern is not None:
        jcfg = dataclasses.replace(jcfg, pattern=pattern, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, pattern=pattern, n_layers=n_layers)
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(4)
    chain = rng.integers(0, cfg.vocab_size, size=(B, S + 1))

    def jloss(p):
        h, _, aux = jax_forward(jcfg, p, {"tokens": jnp.asarray(chain[:, :-1], jnp.int32)},
                                mode="train")
        loss = jax_lm_loss(jcfg, p, h, jnp.asarray(chain[:, 1:], jnp.int32), 5)
        return loss + aux, (loss, aux)

    jgrads, (jl, jaux) = jax.jit(jax.grad(jloss, has_aux=True))(jparams)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    return cfg, params, torch.from_numpy(chain), flat, float(jl), float(jaux)


def _grads(cfg, params, chain, remat):
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    h, _, aux = forward(cfg, params, {"tokens": chain[:, :-1]}, mode="train", remat=remat)
    loss = lm_loss(cfg, params, h, chain[:, 1:], 5)
    grads = torch.autograd.grad(loss + aux, list(named.values()))
    return ({n.replace(".", "/"): g for n, g in zip(named, grads)}, loss.item(), aux.item())


def test_model_grads_match_jax(model):
    cfg, params, chain, jgrads, jl, jaux = model
    grads, loss, aux = _grads(cfg, params, chain, "none")
    assert set(grads) == set(jgrads)
    np.testing.assert_allclose(loss, jl, atol=LOSS_ATOL)
    np.testing.assert_allclose(aux, jaux, atol=LOSS_ATOL)
    if any(ffn == "moe" for _, ffn in cfg.pattern):
        assert aux > 0.0
    for name, g in grads.items():
        ref = jgrads[name]
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=MODEL_GRAD_RTOL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_grads(model, remat):
    """A checkpointed repetition recomputes its forward in the backward from
    the same inputs, so the gradients are those without remat."""
    cfg, params, chain = model[:3]
    base, loss0, aux0 = _grads(cfg, params, chain, "none")
    grads, loss, aux = _grads(cfg, params, chain, remat)
    assert (loss, aux) == (loss0, aux0)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), base[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
