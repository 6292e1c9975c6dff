"""LM trials on the population engine, port against reference: the RMSNorm
slot case against the Pallas kernel under ``jax.vmap``, AdamW over slots
against the reference's ``apply_updates`` under ``jax.vmap``, the bigram
data, a bucket's step against the reference's ``_bucket_step`` on the
reference's draws (plain, clipped, with a masked slot), a slot against the
same trial trained alone, the reference's LM engine tests
(tests/test_population.py) and the CLI.

The port's step takes the draws the reference's keys give: each slot's
``lm_draws`` is replaced by the starts and choices that the reference's
``LMObjective`` step splits from that slot's carry key."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.optim import optimizers as jax_optim  # noqa: E402
from repro.population import engine as ref_engine  # noqa: E402
from repro.population.objectives import lm as ref_lm  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.executor import PopulationCluster  # noqa: E402
from repro_torch.core.hypertrick import HyperTrick  # noqa: E402
from repro_torch.core.search_space import lm_space  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm_slots  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_slots_ref  # noqa: E402
from repro_torch.launch import tune  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import nest_params  # noqa: E402
from repro_torch.optim.optimizers import apply_updates_slots, init_opt_state  # noqa: E402
from repro_torch.population import objectives  # noqa: E402
from repro_torch.population.engine import PopulationEngine, TrialLease  # noqa: E402
from repro_torch.population.objectives import LM_SPEC  # noqa: E402
from repro_torch.population.objectives import lm as lm_objective  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from test_torch_search import _reference_summary_keys  # noqa: E402
from test_torch_train import STEP_ATOL  # noqa: E402
from test_torch_zoo import STEP_METRIC_ATOL, STEP_PARAM_ATOL  # noqa: E402

# the RMSNorm plain versions in f32 (tests/test_kernels.py's limit)
RMS_ATOL = 2e-5
# one optimizer update of O(1) values in f32 (tests/test_torch_train.py)
OPT_ATOL = 1e-6
BATCH, SEQ = 2, 16
# the dense models, jamba's mamba block (pattern (mamba, mlp), (attn, mlp))
# and the MoE blocks of grok-1 and kimi-k2 (attn, moe: 4 experts, top-2)
ARCHS = ("yi-9b", "gemma2-2b", "starcoder2-3b", "jamba-v0.1-52b", "grok-1-314b",
         "kimi-k2-1t-a32b")
MOE_ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
# three AdamW steps of the reduced models: the zoo's limits for yi-9b,
# starcoder2-3b, grok-1 and kimi-k2 (tests/test_torch_zoo.py),
# tests/test_torch_train.py's for gemma2-2b and jamba; (metrics, weights)
BUCKET_ATOL = {arch: (STEP_METRIC_ATOL, STEP_PARAM_ATOL[arch, "reduced"])
               for arch in ("yi-9b", "starcoder2-3b", "grok-1-314b", "kimi-k2-1t-a32b")}
BUCKET_ATOL.update({arch: STEP_ATOL[arch, "adamw"] for arch in ("gemma2-2b", "jamba-v0.1-52b")})
# two trials of one bucket, every traced value its own
SLOT_HP = [dict(learning_rate=1e-3, loss_chunk=1024, grad_clip=1.0, warmup_steps=1),
           dict(learning_rate=3e-3, loss_chunk=512, grad_clip=2.0, warmup_steps=3)]
# below either slot's gradient norm (both above 0.1 at these weights): each
# slot clips by its own norm
CLIP = [1e-2, 3e-2]


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the RMSNorm slot case
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 4, 3, 64), (12, 64, 256), (1, 130, 32)])
def test_rmsnorm_slots_plain_matches_vmapped_pallas(shape):
    """``rmsnorm_slots_ref`` against ``jax.vmap(rmsnorm_pallas)`` in
    interpret mode (the batching rule adds a grid axis) and against each
    slot's ``rmsnorm_ref`` alone."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal((shape[0], shape[-1])) + 1.0).astype(np.float32)
    want = jax.vmap(lambda a, s: rmsnorm_pallas(a, s, interpret=True))(x, scale)
    got = rmsnorm_slots(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RMS_ATOL)
    for s in range(shape[0]):
        np.testing.assert_allclose(
            got[s].numpy(), rmsnorm_ref(torch.from_numpy(x[s]), torch.from_numpy(scale[s])).numpy(),
            atol=RMS_ATOL)
    assert torch.equal(got, rmsnorm_slots_ref(torch.from_numpy(x), torch.from_numpy(scale)))


def test_rmsnorm_slots_grads_are_each_slots_own():
    """The gradient of a sum over slots reaches each slot's scale from its
    own rows only."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 7, 32)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32)).requires_grad_()
    (rmsnorm_slots(x, scale) ** 2).sum().backward()
    for s in range(3):
        one = scale[s].detach().clone().requires_grad_()
        (rmsnorm_ref(x[s], one) ** 2).sum().backward()
        np.testing.assert_allclose(scale.grad[s].numpy(), one.grad.numpy(), rtol=1e-6,
                                   atol=RMS_ATOL)


# ---------------------------------------------------------------------------
# AdamW over slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer,wd", [("adamw", 0.0), ("adamw", 0.1), ("rmsprop", 0.0)])
def test_apply_updates_slots_matches_vmapped_reference(optimizer, wd):
    """Three updates of three slots, each with its own lr, clip and warmup,
    against the reference's ``apply_updates`` under ``jax.vmap``: the clip
    engages in slot 1 only (gradient norms about 7), slot 2's warmup is
    below 1 (none)."""
    kw = dict(learning_rate=0.01, optimizer=optimizer, weight_decay=wd)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(3)
    S = 3
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {n: rng.standard_normal((S,) + s).astype(np.float32) for n, s in shapes.items()}
    lr = np.asarray([0.01, 0.02, 0.005], np.float32)
    clip = np.asarray([100.0, 0.5, 50.0], np.float32)
    warmup = np.asarray([1.0, 4.0, 0.5], np.float32)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    jstate = jax.vmap(lambda p: jax_optim.init_opt_state(jtc, p))(jp)
    state = init_opt_state(tc, tp)
    state = state._replace(step=torch.zeros(S, dtype=torch.int32))
    jupdate = jax.vmap(lambda p, g, st, a, b, c: jax_optim.apply_updates(
        jtc, p, g, st, lr=a, grad_clip=b, warmup_steps=c))
    for step in range(3):
        grads = {n: rng.standard_normal((S,) + s).astype(np.float32) * 2
                 for n, s in shapes.items()}
        jp, jstate, jgn = jupdate(jp, {n: jnp.asarray(g) for n, g in grads.items()}, jstate,
                                  lr, clip, warmup)
        tp, state, gn = apply_updates_slots(
            tc, tp, {n: torch.from_numpy(g) for n, g in grads.items()}, state,
            torch.from_numpy(lr), grad_clip=torch.from_numpy(clip),
            warmup_steps=torch.from_numpy(warmup))
        np.testing.assert_allclose(gn.numpy(), np.asarray(jgn), rtol=1e-6)
        assert gn[1] > clip[1] and (gn[[0, 2]] < torch.from_numpy(clip[[0, 2]])).all()
        np.testing.assert_array_equal(state.step.numpy(), np.asarray(jstate.step))
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), atol=OPT_ATOL,
                                       err_msg=f"step {step} {n}")
            np.testing.assert_allclose(state.acc1[n].numpy(), np.asarray(jstate.acc1[n]),
                                       atol=OPT_ATOL, rtol=1e-6)
            if optimizer == "adamw":
                np.testing.assert_allclose(state.acc2[n].numpy(), np.asarray(jstate.acc2[n]),
                                           atol=OPT_ATOL, rtol=1e-6)


# ---------------------------------------------------------------------------
# the bigram data
# ---------------------------------------------------------------------------
def _ref_draws(key, batch, seq, vocab):
    """The starts and choices the reference's step draws from a slot's
    carry key, and the key it carries on."""
    key, k_start, k_choice = jax.random.split(key, 3)
    start = jax.random.randint(k_start, (batch,), 0, vocab)
    choice = jax.random.randint(k_choice, (seq, batch), 0, lm_objective.BRANCH)
    return key, np.asarray(start), np.asarray(choice), (k_start, k_choice)


@pytest.mark.parametrize("data_seed", [0, 5])
def test_bigram_table_and_walk_match_reference(data_seed):
    ref = ref_lm.LMObjective("yi-9b", batch=3, seq=11, data_seed=data_seed)
    ours = lm_objective.LMObjective("yi-9b", batch=3, seq=11, data_seed=data_seed, device="cpu")
    np.testing.assert_array_equal(ours.table.numpy(), np.asarray(ref.table))
    starts, choices, want = [], [], []
    for s in range(2):
        _, start, choice, (k_start, k_choice) = _ref_draws(
            jax.random.PRNGKey(10 + s), 3, 11, ours.cfg.vocab_size)
        starts.append(torch.from_numpy(start.astype(np.int64)))
        choices.append(torch.from_numpy(choice.astype(np.int64)))
        want.append(np.asarray(ref_lm._bigram_chain(ref.table, k_start, k_choice, 3, 11)))
    got = lm_objective.bigram_chain(ours.table, torch.stack(starts), torch.stack(choices))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_lm_draws_come_from_the_slots_generator():
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    a, b = lm_objective.lm_draws(g1, 3, 5, 512), lm_objective.lm_draws(g2, 3, 5, 512)
    assert a[0].shape == (3,) and a[1].shape == (5, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[1].max()) < lm_objective.BRANCH and int(a[0].max()) < 512
    assert not torch.equal(lm_objective.lm_draws(g1, 3, 5, 512)[1], a[1])


# ---------------------------------------------------------------------------
# a bucket's step against the reference's
# ---------------------------------------------------------------------------
def _ref_side(arch, clip, masked):
    """The reference's two-slot bucket: its objective, stacked state and
    step; with ``clip`` each slot's grad_clip is CLIP's."""
    obj = ref_lm.LMObjective(arch, batch=BATCH, seq=SEQ)
    hps = [dict(hp, grad_clip=c) if clip else hp for hp, c in zip(SLOT_HP, CLIP)]
    states = [obj.init_slot_state(jax.random.PRNGKey(7 + s), hp) for s, hp in enumerate(hps)]
    learner, carry = (jax.tree.map(lambda *x: jnp.stack(x), *parts) for parts in zip(*states))
    hyper = tuple(jnp.asarray([obj.traced_values(hp)[k] for hp in hps], jnp.float32)
                  for k in range(3))
    bstep = ref_engine._bucket_step(obj, SEQ, 2)
    active = jnp.asarray([not masked, True])
    return obj, hps, learner, carry, lambda lrn, car: bstep(lrn, car, *hyper, active)


def _port_bucket(arch, hps, learner):
    """The port's two-slot bucket of ``hps`` on the CPU, each slot's weights
    the reference's ``learner``'s and a fresh AdamW state."""
    obj = lm_objective.LMObjective(arch, batch=BATCH, seq=SEQ, device="cpu")
    engine = PopulationEngine(obj, max_slots=2, episodes_per_phase=10 ** 9,
                              max_updates=10 ** 9, seed=0, device="cpu")
    engine._admit_grouped([TrialLease(s, dict(hp)) for s, hp in enumerate(hps)], now=0.0)
    bucket = engine.buckets[SEQ]
    assert bucket.capacity == 2
    gens = bucket.carry[2]
    for s, hp in enumerate(hps):
        named = dict(params_from_numpy(jax.tree.map(lambda x: np.asarray(x[s]), learner[0]),
                                       obj.cfg, device="cpu").named_parameters())
        named = {n: p.detach() for n, p in named.items()}
        zero = torch.zeros(())
        bucket.write_slot(s, bucket.meta[s], (named, init_opt_state(obj.tc, named)),
                          (zero, zero.clone(), gens[s]), obj.traced_values(hp))
    return obj, bucket


@pytest.mark.parametrize("case", ["plain", "clipped", "masked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bucket_step_matches_reference(arch, case, monkeypatch):
    """Three updates of a two-slot bucket (each slot its own lr, clip and
    warmup) on both sides from the same weights, on the reference's draws:
    weights, each slot's AdamW moments summed, ``(n, loss_sum)``. Clipped:
    each slot's clip engages, so its moments carry its own clip scale (a
    clip by the stack's norm gives others)."""
    clip, masked = case == "clipped", case == "masked"
    metric_atol, param_atol = BUCKET_ATOL[arch]
    ref_obj, hps, learner, carry, ref_step = _ref_side(arch, clip, masked)

    obj, bucket = _port_bucket(arch, hps, learner)
    gens = bucket.carry[2]
    if masked:
        bucket.park(0)
    frozen = [t[0].clone() if isinstance(t, torch.Tensor) else None for t in bucket.leaves]
    frozen_gen = gens[0].get_state()

    queue = {id(g): [] for g in gens}
    real_draws = lm_objective.lm_draws

    def ref_draws(gen, batch, seq, vocab):
        real_draws(gen, batch, seq, vocab)           # the slot's own generator moves
        return queue[id(gen)].pop(0)
    monkeypatch.setattr(lm_objective, "lm_draws", ref_draws)
    live = [s for s in range(2) if not (masked and s == 0)]

    for u in range(3):
        for s in live:
            _, start, choice, _ = _ref_draws(carry["rng"][s], BATCH, SEQ, obj.cfg.vocab_size)
            queue[id(gens[s])].append((torch.from_numpy(start.astype(np.int64)),
                                       torch.from_numpy(choice.astype(np.int64))))
        learner, carry = ref_step(learner, carry)
        bucket.step()
        what = f"{arch} {case}, update {u}"
        assert all(not q for q in queue.values()), what
        params, opt = bucket.learner
        n, loss_sum, _ = bucket.carry
        np.testing.assert_allclose(n.numpy(), np.asarray(carry["n"]), err_msg=what)
        np.testing.assert_allclose(loss_sum.numpy(), np.asarray(carry["loss_sum"]),
                                   atol=metric_atol, err_msg=what)
        ref_params, ref_v = _flat(learner[0]), _flat(learner[1].acc2)
        np.testing.assert_array_equal(opt.step.numpy(), np.asarray(learner[1].step))
        for s in range(2):
            for name in params:
                np.testing.assert_allclose(params[name][s].numpy(), ref_params[name][s],
                                           atol=param_atol, rtol=0,
                                           err_msg=f"{what}: slot {s} {name}")
            # the slot's second moments summed over every weight: its own
            # clip scale squared times its squared gradients
            ours = sum(float(opt.acc2[m][s].double().sum()) for m in params)
            want = sum(float(np.asarray(ref_v[m][s], np.float64).sum()) for m in params)
            assert ours == pytest.approx(want, rel=1e-4), (what, s, ours, want)
    if masked:
        for before, after in zip(frozen, bucket.leaves):
            if before is not None:
                assert torch.equal(after[0], before)
        assert torch.equal(gens[0].get_state(), frozen_gen)
        assert bucket.carry[2][0] is gens[0]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bucket_routes_as_the_reference_on_the_first_step(arch, monkeypatch):
    """Every slot's experts (``top_i``) in the first update of a two-slot
    bucket against the reference's ``forward`` of that slot alone on the same
    weights and tokens, run eagerly with its router's choices recorded. A
    token whose choice differs is reported with its margin between the k-th
    and (k+1)-th probability."""
    from repro.models import moe as ref_moe
    from repro.models.model import forward as ref_forward
    from repro_torch.models import moe
    _, hps, learner, carry, _ = _ref_side(arch, False, False)
    obj, bucket = _port_bucket(arch, hps, learner)
    routed, chains = [], []
    real_router, real_chain = moe._router, lm_objective.bigram_chain

    def router(cfg, p, x):
        out = real_router(cfg, p, x)
        probs = torch.softmax(x.float() @ p["router"].float(), -1)
        routed.append((out[1], torch.topk(probs, cfg.top_k + 1, dim=-1).values))
        return out

    def chain(*a):
        chains.append(real_chain(*a))
        return chains[-1]
    draws = [_ref_draws(carry["rng"][s], BATCH, SEQ, obj.cfg.vocab_size)[1:3] for s in range(2)]
    monkeypatch.setattr(moe, "_router", router)
    monkeypatch.setattr(lm_objective, "bigram_chain", chain)
    monkeypatch.setattr(lm_objective, "lm_draws", lambda gen, *a: tuple(
        torch.from_numpy(x.astype(np.int64)) for x in draws[
            [id(g) for g in bucket.carry[2]].index(id(gen))]))
    bucket.step()
    (top_i, top), = routed
    ref_routed = []
    real_ref_router = ref_moe._router

    def ref_router(cfg, p, x):
        out = real_ref_router(cfg, p, x)
        ref_routed.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(ref_moe, "_router", ref_router)
    for s in range(2):
        params = jax.tree.map(lambda x: x[s], learner[0])
        with jax.disable_jit():
            ref_forward(ref_lm.LMObjective(arch).cfg, params,
                        {"tokens": jnp.asarray(chains[0][s, :, :-1].numpy())}, mode="train")
        flips = top_i[s].numpy() != ref_routed[-1]
        margin = (top[s, :, -2] - top[s, :, -1])[torch.from_numpy(flips.any(-1))]
        assert not flips.any(), (arch, s, margin.tolist())


def test_slot_matches_the_same_trial_trained_alone(monkeypatch):
    """Slot s of a capacity-3 bucket against the one-trial train step
    (``make_train_step``, the thread backend's) on the same weights and
    tokens, 3 updates, each trial with integer warmups (the config's)."""
    hps = [dict(learning_rate=2e-3, loss_chunk=1024, grad_clip=1.0, warmup_steps=1),
           dict(learning_rate=5e-4, loss_chunk=1024, grad_clip=0.05, warmup_steps=3),
           dict(learning_rate=1e-3, loss_chunk=1024, grad_clip=2.0, warmup_steps=2)]
    obj = lm_objective.LMObjective("yi-9b", batch=BATCH, seq=SEQ, device="cpu")
    engine = PopulationEngine(obj, max_slots=3, episodes_per_phase=10 ** 9,
                              max_updates=10 ** 9, seed=0, device="cpu")
    engine._admit_grouped([TrialLease(i, hp) for i, hp in enumerate(hps)], now=0.0)
    bucket = engine.buckets[SEQ]
    assert bucket.capacity == 3
    alone = []
    for s, hp in enumerate(hps):
        tc = TrainConfig(optimizer="adamw", learning_rate=hp["learning_rate"],
                         grad_clip=hp["grad_clip"], warmup_steps=hp["warmup_steps"],
                         loss_chunk=hp["loss_chunk"])
        tree = nest_params({n: t[s].numpy().copy() for n, t in bucket.learner[0].items()})
        params = params_from_numpy(tree, obj.cfg, device="cpu")
        alone.append([params, init_opt_state(tc, params), make_train_step(obj.cfg, tc)])
    chains = []
    real_chain = lm_objective.bigram_chain

    def recorded(*a):
        chains.append(real_chain(*a))
        return chains[-1]
    monkeypatch.setattr(lm_objective, "bigram_chain", recorded)
    for u in range(3):
        before = bucket.carry[1].clone()
        bucket.step()
        for s, trial in enumerate(alone):
            batch = {"tokens": chains[-1][s, :, :-1], "labels": chains[-1][s, :, 1:]}
            trial[0], trial[1], m = trial[2](trial[0], trial[1], batch)
            np.testing.assert_allclose(float(before[s] - bucket.carry[1][s]), m["loss"].item(),
                                       atol=STEP_METRIC_ATOL, err_msg=f"update {u} slot {s}")
    params = bucket.learner[0]
    for s, (p, state, _) in enumerate(alone):
        for name, t in p.named_parameters():
            np.testing.assert_allclose(params[name][s].numpy(), t.detach().numpy(),
                                       atol=STEP_PARAM_ATOL["yi-9b", "reduced"], rtol=0,
                                       err_msg=f"slot {s} {name}")
        assert int(bucket.learner[1].step[s]) == int(state.step) == 3


# ---------------------------------------------------------------------------
# the reference's LM engine tests (tests/test_population.py)
# ---------------------------------------------------------------------------
def test_lm_loss_chunk_buckets_by_effective_chunk():
    obj = lm_objective.LMObjective(seq=64, device="cpu")
    ref = ref_lm.LMObjective(seq=64)
    for chunk in (32, 64, 1024):
        assert obj.bucket_key({"loss_chunk": chunk}) == ref.bucket_key({"loss_chunk": chunk})
    assert obj.bucket_key({"loss_chunk": 32}) == 32
    assert obj.bucket_key({"loss_chunk": 64}) == 64
    assert obj.bucket_key({"loss_chunk": 1024}) == 64   # truncates to seq
    assert obj.cache_key() == ref.cache_key()
    assert obj.update_cost(64) == ref.update_cost(64) == 2 * 64
    hp = {"learning_rate": 1e-3, "loss_chunk": 64}
    assert obj.traced_values(hp) == ref.traced_values(hp)


def test_lm_objective_per_trial_hparams_on_slot_axis():
    """Two LM trials share one bucket with their lr / clip / warmup stacked
    on the slot axis, and one step trains both."""
    hp0 = {"learning_rate": 1e-3, "loss_chunk": 32, "grad_clip": 1.0, "warmup_steps": 1}
    hp1 = {"learning_rate": 3e-4, "loss_chunk": 1024, "grad_clip": 0.5, "warmup_steps": 4}
    engine = PopulationEngine(lm_objective.LMObjective(batch=2, seq=16, device="cpu"),
                              max_slots=2, episodes_per_phase=10 ** 9, max_updates=10 ** 9,
                              seed=0, device="cpu")
    engine.admit(TrialLease(0, hp0))
    engine.admit(TrialLease(1, hp1))
    assert sorted(engine.buckets) == [16]  # both chunks truncate to seq
    bucket = engine.buckets[16]
    assert bucket.traced_names == LM_SPEC.traced
    np.testing.assert_allclose(bucket.hyper["learning_rate"], [1e-3, 3e-4])
    np.testing.assert_allclose(bucket.hyper["grad_clip"], [1.0, 0.5])
    np.testing.assert_allclose(bucket.hyper["warmup_steps"], [1.0, 4.0])
    before = {n: t.clone() for n, t in bucket.learner[0].items()}
    bucket.step()
    after = bucket.learner[0]
    for slot in (0, 1):                    # both slots actually trained
        assert max(float((after[n][slot] - before[n][slot]).abs().max()) for n in after) > 0
    n, loss_sum = engine.objective.progress(bucket.carry)
    np.testing.assert_allclose(n.numpy(), [1.0, 1.0])
    assert torch.isfinite(loss_sum).all()


def test_get_objective_builds_the_lm_objective():
    obj = objectives.get_objective("lm", arch="starcoder2-3b", batch=3, seq=8, device="cpu")
    assert isinstance(obj, lm_objective.LMObjective)
    assert (obj.cfg.name, obj.batch, obj.seq) == ("starcoder2-3b", 3, 8)
    spec = objectives.objective_from_spec({"kind": "lm", "arch": "yi-9b", "data_seed": 2,
                                           "device": "cpu", "steps_per_phase": 4})
    assert spec.cache_key() == ref_lm.LMObjective("yi-9b", data_seed=2).cache_key()


# ---------------------------------------------------------------------------
# the engine end to end, and the CLI
# ---------------------------------------------------------------------------
def test_vectorized_lm_hypertrick_end_to_end():
    """HyperTrick over the LM space: every trial in one bucket, phases of
    ``episodes_per_phase`` updates, finite -loss metrics."""
    policy = HyperTrick(lm_space(), 4, 2, 0.25, seed=0)
    res = PopulationCluster(4, objective=lm_objective.LMObjective(batch=2, seq=8, device="cpu"),
                            episodes_per_phase=2, seed=0, device="cpu").run(policy)
    s = res.summary()
    assert s["n_trials"] == 4 and "crashed" not in s["by_status"]
    assert res.updates == 2 * len(res.records)
    assert res.env_steps == res.updates * 2 * 8
    assert all(np.isfinite(r.metric) and r.metric < 0 for r in res.records)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "grok-1-314b"])
def test_tune_cli_vectorized_lm_runs_mamba_and_moe_archs_on_the_cpu(arch, monkeypatch, capsys):
    """The vectorized LM search over a mamba and a MoE model's reduced
    config: the reference CLI's summary schema, no trial crashed, every
    metric a finite -loss. (HyperTrick may kill one of the 3: each trial's
    draws follow the interpreter's salted ``hash``.)"""
    keys = _reference_summary_keys(monkeypatch, capsys) | {"devices"}
    res = tune.main(["--backend", "vectorized", "--objective", "lm", "--arch", arch,
                     "--device", "cpu", "--workers", "3", "--phases", "2",
                     "--steps-per-phase", "2"])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == keys
    assert printed["n_trials"] == 3 and "crashed" not in printed["by_status"]
    assert sum(printed["by_status"].values()) == 3
    assert all(np.isfinite(r.metric) and r.metric < 0 for r in res.records)
    assert res.updates >= 2 * 3 and res.env_steps == res.updates * 2 * 32


def test_tune_cli_vectorized_lm_runs_on_the_cpu(monkeypatch, capsys):
    keys = _reference_summary_keys(monkeypatch, capsys) | {"devices"}
    res = tune.main(["--backend", "vectorized", "--objective", "lm", "--device", "cpu",
                     "--workers", "3", "--phases", "2", "--steps-per-phase", "2"])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == keys
    assert printed["n_trials"] == 3 and "crashed" not in printed["by_status"]
    assert printed["devices"] == 1
    assert res.updates >= 2 * 3 and res.env_steps == res.updates * 2 * 32
