"""MoE and mamba blocks on the population engine's slot axis, port against
reference: the scan's slot plain version against the Pallas kernel under
``jax.vmap``, the grouped matmul over (slot, expert) groups against the
Pallas kernel and ``jax.vmap(lax.ragged_dot)``, and the slot forms of the
mamba and MoE blocks (outputs, each slot's aux loss and routing, and their
gradients) against the reference's blocks under ``jax.vmap``, on the same
numpy inputs.

The reference's Pallas ``gmm`` wrapper does not trace under ``jax.vmap``
(``pad_groups`` needs concrete group sizes), so the flattened call is held
against the Pallas kernel directly and against the vmapped oracle."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.kernels.gmm.ops import gmm as jax_gmm  # noqa: E402
from repro.kernels.selective_scan.selective_scan import selective_scan_pallas  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models.layers import norm as jax_norm  # noqa: E402
from repro.models.moe import _router as jax_router  # noqa: E402
from repro.models.moe import moe_local as jax_moe_local  # noqa: E402
from repro.models.ssm import mamba_block as jax_mamba_block  # noqa: E402
from repro.models.ssm import selective_scan_ref as jax_scan_ref  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.selective_scan import ref as scan_ref  # noqa: E402
from repro_torch.kernels.selective_scan.ops import selective_scan, selective_scan_slots  # noqa: E402
from repro_torch.kernels.selective_scan.selective_scan import (  # noqa: E402
    selective_scan_slots_cuda)
from repro_torch.models.layers import norm_slots  # noqa: E402
from repro_torch.models.model import forward_slots  # noqa: E402
from repro_torch.models.moe import _router, moe_block_slots, moe_local  # noqa: E402
from repro_torch.models.ssm import mamba_block, mamba_block_slots  # noqa: E402

# the scan in f32: the same recurrence in another order of sums (the JAX
# tests' tolerance, tests/test_torch_selective_scan.py's); also the limit
# of the kernels' gradients (RMSNorm's f32 limit, tests/test_kernels.py)
SCAN_ATOL = 2e-5
# the grouped matmul in f32: sums in another order (tests/test_torch_gmm.py)
GMM_ATOL = 2e-4
# one block's output: a few f32 roundings of O(1) values
# (tests/test_torch_hybrid.py's BLOCK_ATOL)
BLOCK_ATOL = 1e-5
# a block's weight gradients: sums over a slot's rows, in another order
# (and through the reference's associative scan): each gradient within
# GRAD_TOL of its tensor's largest |gradient| (measured on the CPU: at most
# 9.8e-7 of it, a mamba norm_scale; 1.0e-4 absolute at x_proj, largest 145)
GRAD_TOL = 4e-6
# the scan's input gradients: the f32 limit with a relative term for the
# larger ones
GRAD_RTOL = 1e-4
B, T = 2, 16
MOE_ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")


def _scan_inputs(S, Bs, T, di, st, seed=0):
    """tests/test_torch_selective_scan.py's distributions, one a, d_skip and
    set of rows a slot: u, dt, b, c (S, Bs, T, .), a (S, di, st), d_skip
    (S, di), h0 (S, Bs, di, st)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (f(S, Bs, T, di), np.abs(f(S, Bs, T, di, scale=0.1)) + 0.01,
            -np.abs(f(S, di, st)) - 0.05, f(S, Bs, T, st), f(S, Bs, T, st),
            f(S, di) + 1.0, f(S, Bs, di, st, scale=0.2))


def _flat_rows(arrays):
    """The per-slot arrays as the slot case's torch arguments: the rows of
    u, dt, b, c and h0 flattened to S * Bs."""
    u, dt, a, b, c, d, h0 = (torch.from_numpy(x) for x in arrays)
    rows = lambda t: t.reshape(-1, *t.shape[2:])  # noqa: E731
    return rows(u), rows(dt), a, rows(b), rows(c), d, rows(h0)


# ---------------------------------------------------------------------------
# the scan's slot case
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,Bs,T,di,st", [(3, 2, 32, 64, 8), (2, 3, 16, 32, 4),
                                          (4, 1, 8, 16, 16)])
def test_selective_scan_slots_plain_matches_vmapped_pallas(S, Bs, T, di, st):
    """``selective_scan_slots_ref`` against ``jax.vmap(selective_scan_pallas)``
    in interpret mode and against each slot's ``selective_scan_ref`` alone."""
    arrays = _scan_inputs(S, Bs, T, di, st)
    jy, jh = jax.vmap(lambda *a: selective_scan_pallas(*a, interpret=True))(
        *map(jnp.asarray, arrays))
    y, hT = scan_ref.selective_scan_slots_ref(*_flat_rows(arrays))
    assert y.shape == (S * Bs, T, di) and hT.shape == (S * Bs, di, st)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy).reshape(y.shape), atol=SCAN_ATOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh).reshape(hT.shape), atol=SCAN_ATOL)
    for s in range(S):
        ys, hs = scan_ref.selective_scan_ref(*(torch.from_numpy(x[s]) for x in arrays))
        assert torch.equal(y[s * Bs:(s + 1) * Bs], ys) and torch.equal(hT[s * Bs:(s + 1) * Bs], hs)


def test_selective_scan_slots_grads_match_vmapped_reference():
    """The gradient of a sum over slots of the plain version against
    ``jax.grad`` of the reference's sequential scan under ``jax.vmap``:
    every input's, each slot's a and d_skip from its own rows only."""
    S, Bs, T_, di, st = 3, 2, 12, 16, 8
    arrays = _scan_inputs(S, Bs, T_, di, st, seed=3)
    weight = np.random.default_rng(4).standard_normal((S, Bs, T_, di)).astype(np.float32)

    def ref_loss(u, dt, a, b, c, d, h0):
        y, hT = jax.vmap(jax_scan_ref)(u, dt, a, b, c, d, h0)
        return jnp.sum(y * weight) + jnp.sum(hT ** 2)
    want = jax.grad(ref_loss, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    args = [t.requires_grad_(i < 6) for i, t in enumerate(_flat_rows(arrays))]
    y, hT = selective_scan_slots(*args)
    (torch.sum(y * torch.from_numpy(weight).reshape(y.shape)) + torch.sum(hT ** 2)).backward()
    for name, t, w in zip(("u", "dt", "a", "b", "c", "d_skip"), args, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w).reshape(t.shape),
                                   atol=SCAN_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_selective_scan_slots_dispatch():
    """A CPU tensor takes the plain version and launches nothing; a device
    without a kernel raises; the CUDA wrapper refuses CPU tensors."""
    args = _flat_rows(_scan_inputs(2, 2, 8, 16, 4, seed=5))
    counts = (selective_scan.launches, selective_scan.launches_slots)
    y, hT = selective_scan_slots(*args)
    assert (selective_scan.launches, selective_scan.launches_slots) == counts
    want = scan_ref.selective_scan_slots_ref(*args)
    assert torch.equal(y, want[0]) and torch.equal(hT, want[1])
    with pytest.raises(ValueError, match="no kernel"):
        selective_scan_slots(*(t.to("meta") for t in args))
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_slots_cuda(*args)


# ---------------------------------------------------------------------------
# the grouped matmul over slot x expert groups
# ---------------------------------------------------------------------------
def _slot_groups(S, E, T, D, F, seed):
    """Each slot's T rows sorted by expert into E groups (one empty group a
    slot from the second on), each slot's (E, D, F) weights."""
    rng = np.random.default_rng(seed)
    sizes = np.zeros((S, E), np.int32)
    for s in range(S):
        cuts = np.sort(rng.integers(0, T + 1, E - 1))
        sizes[s] = np.diff(np.concatenate([[0], cuts, [T]]))
        if s:
            sizes[s, s % E] = 0
            sizes[s, (s + 1) % E] = T - sizes[s].sum() + sizes[s, (s + 1) % E]
    assert (sizes.sum(1) == T).all() and (sizes >= 0).all()
    return (rng.standard_normal((S, T, D)).astype(np.float32),
            rng.standard_normal((S, E, D, F)).astype(np.float32), sizes)


@pytest.mark.parametrize("S,E,T,D,F,bt", [(12, 4, 32, 32, 16, 8), (3, 4, 128, 64, 32, 32)])
def test_gmm_over_slot_expert_groups_matches_pallas_and_vmapped_ragged_dot(S, E, T, D, F, bt):
    """``gmm_ref`` over the S * E groups of the flattened rows, weights seen
    as (S * E, D, F): the MoE slot block's call. Against the Pallas kernel
    in interpret mode on the same flattened call and against
    ``jax.vmap(lax.ragged_dot)`` over the slots."""
    x, w, sizes = _slot_groups(S, E, T, D, F, seed=S)
    flat = (x.reshape(S * T, D), w.reshape(S * E, D, F), sizes.reshape(S * E))
    got = gmm_ref(*map(torch.from_numpy, flat))
    pallas = jax_gmm(*map(jnp.asarray, flat), use_pallas=True, interpret=True, bt=bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=GMM_ATOL)
    vm = jax.vmap(jax.lax.ragged_dot)(*map(jnp.asarray, (x, w, sizes)))
    np.testing.assert_allclose(got.numpy(), np.asarray(vm).reshape(S * T, F), atol=GMM_ATOL)


def test_gmm_over_slot_expert_groups_grads_match_vmapped_ragged_dot():
    S, E, T_, D, F = 3, 4, 24, 16, 8
    x, w, sizes = _slot_groups(S, E, T_, D, F, seed=7)
    weight = np.random.default_rng(8).standard_normal((S, T_, F)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jax.vmap(jax.lax.ragged_dot)(a, b, sizes) * weight),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x.reshape(S * T_, D)).requires_grad_()
    wt = torch.from_numpy(w.reshape(S * E, D, F)).requires_grad_()
    out = gmm_ref(xt, wt, torch.from_numpy(sizes.reshape(-1)))
    torch.sum(out * torch.from_numpy(weight).reshape(out.shape)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]).reshape(xt.shape),
                               atol=GMM_ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]).reshape(wt.shape),
                               atol=GMM_ATOL)


# ---------------------------------------------------------------------------
# the slot blocks
# ---------------------------------------------------------------------------
def _slot_params(arch, key, S, seed=0, perturb=()):
    """S slots' weights of block ``key`` of ``arch``'s reduced config, drawn
    by the reference's init from S keys: the reference's (S, ...) tree and
    the port's dict of (S, ...) tensors. ``perturb``: leaves given noise a
    slot, so that their fixed inits differ between slots."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    trees = [jax.tree.map(lambda t: np.asarray(t[0]),
                          jax_schema.init_params(jcfg, jax.random.PRNGKey(seed + s))["dec"][key])
             for s in range(S)]
    rng = np.random.default_rng(seed)
    for tree in trees:
        for name in perturb:
            tree[name] = (tree[name] + 0.3 * rng.standard_normal(tree[name].shape)
                          ).astype(np.float32)
    stacked = {n: np.stack([t[n] for t in trees]) for n in trees[0]}
    return (jcfg, {n: jnp.asarray(v) for n, v in stacked.items()}, cfg,
            {n: torch.from_numpy(v.copy()) for n, v in stacked.items()})


def _x(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal((S, B, T, cfg.d_model)).astype(np.float32)


def _grads(loss, params):
    leaves = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    loss(leaves).backward()
    return {n: t.grad for n, t in leaves.items()}


def _check_grads(got, want, what):
    assert set(got) == set(want), what
    for n, g in got.items():
        ref = np.asarray(want[n])
        np.testing.assert_allclose(g.numpy(), ref, atol=GRAD_TOL * np.abs(ref).max(), rtol=0,
                                   err_msg=f"{what}: {n}")


@pytest.mark.parametrize("S", [1, 3])
def test_mamba_block_slots_matches_vmapped_reference(S):
    """``mamba_block_slots`` against the reference's ``mamba_block`` (train
    mode, its associative scan) under ``jax.vmap``, each slot's a_log and
    D its own; and each slot against the port's one-trial block."""
    jcfg, jp, cfg, tp = _slot_params("jamba-v0.1-52b", "b0_mamba", S,
                                     perturb=("a_log", "d_skip", "conv_b"))
    x = _x(cfg, S, seed=S)
    want = jax.vmap(lambda p, v: jax_mamba_block(jcfg, p, v, mode="train")[0])(jp, x)
    xt = torch.from_numpy(x).reshape(S, B * T, -1)
    got = mamba_block_slots(cfg, tp, xt, batch=B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), atol=BLOCK_ATOL)
    for s in range(S):
        one = mamba_block(cfg, {n: t[s] for n, t in tp.items()}, torch.from_numpy(x[s]),
                          mode="train")
        np.testing.assert_allclose(got[s].numpy(), one.reshape(B * T, -1).numpy(),
                                   atol=BLOCK_ATOL)


def test_mamba_block_slots_grads_match_vmapped_reference():
    """Every weight's gradient of a sum over slots against ``jax.grad`` of
    the vmapped reference block: each slot's from its own rows."""
    S = 3
    jcfg, jp, cfg, tp = _slot_params("jamba-v0.1-52b", "b0_mamba", S, seed=1,
                                     perturb=("a_log", "d_skip"))
    x = _x(cfg, S, seed=9)
    weight = np.random.default_rng(10).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jax.vmap(
        lambda q, v: jax_mamba_block(jcfg, q, v, mode="train")[0])(p, x) * weight))(jp)
    xt, wt = (torch.from_numpy(a).reshape(S, B * T, -1) for a in (x, weight))
    got = _grads(lambda p: torch.sum(mamba_block_slots(cfg, p, xt, batch=B) * wt), tp)
    _check_grads(got, want, "mamba")


def _ref_routing(jcfg, jp, x):
    """The reference's routing of each slot's tokens: ``_router`` on the
    block's norm, under ``jax.vmap``: (probs of the top k, top_i, aux)."""
    def one(p, v):
        h = jax_norm(jcfg, p, v).reshape(-1, v.shape[-1])
        return jax_router(jcfg, p, h)
    return jax.vmap(one)(jp, x)


def _margins(cfg, params, x):
    """Each token's gap between its k-th and (k+1)-th router probability,
    (S, N): where two nearly tie, sums in another order may flip them."""
    probs = torch.softmax(torch.bmm(norm_slots(cfg, params, x).float(),
                                    params["router"].float()), -1)
    top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
    return top[..., -2] - top[..., -1]


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_slots_matches_vmapped_reference(arch, S):
    """``moe_block_slots`` against the reference's ``moe_local`` under
    ``jax.vmap``: the output, each slot's aux loss and each token's experts
    (``top_i``); and each slot against the port's one-trial ``moe_local``."""
    jcfg, jp, cfg, tp = _slot_params(arch, "b0_moe", S, seed=2)
    x = _x(cfg, S, seed=11 + S)
    want, want_aux = jax.vmap(lambda p, v: jax_moe_local(jcfg, p, v))(jp, x)
    _, want_i, _ = _ref_routing(jcfg, jp, x)
    xt = torch.from_numpy(x).reshape(S, B * T, -1)
    _, top_i, _ = _router(cfg, tp, norm_slots(cfg, tp, xt))
    flips = top_i.numpy() != np.asarray(want_i)
    assert not flips.any(), (
        f"{int(flips.any(-1).sum())} tokens routed apart; their k-th / (k+1)-th margins: "
        f"{_margins(cfg, tp, xt)[torch.from_numpy(flips.any(-1))].tolist()}")
    got, aux = moe_block_slots(cfg, tp, xt)
    assert aux.shape == (S,) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(got.shape), atol=BLOCK_ATOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-6)
    for s in range(S):
        one, one_aux = moe_local(cfg, {n: t[s] for n, t in tp.items()}, torch.from_numpy(x[s]))
        np.testing.assert_allclose(got[s].numpy(), one.reshape(B * T, -1).numpy(),
                                   atol=BLOCK_ATOL)
        np.testing.assert_allclose(float(aux[s]), float(one_aux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_slots_grads_match_vmapped_reference(arch):
    """Every weight's gradient of a sum over slots of output and aux loss
    against ``jax.grad`` of the vmapped reference block."""
    S = 3
    jcfg, jp, cfg, tp = _slot_params(arch, "b0_moe", S, seed=3)
    x = _x(cfg, S, seed=12)
    weight = np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p):
        y, aux = jax.vmap(lambda q, v: jax_moe_local(jcfg, q, v))(p, x)
        return jnp.sum(y * weight) + jnp.sum(aux)
    want = jax.grad(ref_loss)(jp)
    xt, wt = (torch.from_numpy(a).reshape(S, B * T, -1) for a in (x, weight))

    def loss(p):
        y, aux = moe_block_slots(cfg, p, xt)
        return torch.sum(y * wt) + aux.sum()
    _check_grads(_grads(loss, tp), want, arch)


def test_moe_slots_sort_equals_each_slots_own_sort():
    """The slot-major key ``slot * E + expert``, sorted stably, lists each
    slot's assignments in the order of that slot's own stable sort (the
    reference's ``jnp.argsort``), offset by the slot's rows."""
    rng = np.random.default_rng(14)
    S, N, E, k = 4, 9, 4, 2
    top_i = torch.from_numpy(rng.integers(0, E, (S, N, k)))
    key = (top_i + (torch.arange(S) * E)[:, None, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    for s in range(S):
        own = np.asarray(jnp.argsort(jnp.asarray(top_i[s].reshape(-1).numpy())))
        np.testing.assert_array_equal(order[s * N * k:(s + 1) * N * k].numpy(),
                                      own + s * N * k)


def test_forward_slots_sums_each_slots_aux_in_the_reference_order():
    """A stacked MoE pattern (2 MoE layers a repetition, 2 repetitions):
    ``forward_slots``' aux against the reference ``forward``'s of each slot
    alone, and zeros without MoE layers."""
    from repro.models.model import forward as jax_forward
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import nest_params
    arch, S = "grok-1-314b", 2
    pattern = (("attn", "moe"), ("attn", "moe"))
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), pattern=pattern, n_layers=4)
    cfg = dataclasses.replace(get_config(arch).reduced(), pattern=pattern, n_layers=4)
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (S, B, T))
    named, want = [], []
    for s in range(S):
        jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(20 + s))
        _, _, aux = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(tokens[s])}, mode="train")
        want.append(float(aux))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        named.append({n: p.detach() for n, p in params.named_parameters()})
    tree = nest_params({n: torch.stack([m[n] for m in named]) for n in named[0]})
    hidden, aux = forward_slots(cfg, tree, torch.from_numpy(tokens))
    assert hidden.shape == (S, B * T, cfg.d_model)
    np.testing.assert_allclose(aux.numpy(), want, rtol=1e-5)
    dense = get_config("yi-9b").reduced()
    jparams = jax_schema.init_params(jax_get_config("yi-9b").reduced(), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), dense, device="cpu")
    one = nest_params({n: p.detach()[None] for n, p in params.named_parameters()})
    _, aux = forward_slots(dense, one, torch.from_numpy(tokens[:1] % dense.vocab_size))
    assert torch.equal(aux, torch.zeros(1))
