"""The port's LM training path against the JAX package, on the CPU: the
chunked loss, both optimizers, the data pipeline, the checkpointer, three
train steps, the Trainer, the LM objective and the train CLI. Weights carry
across with ``params_from_numpy``; inputs are drawn with numpy from a seed;
everything runs in f32."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as jax_checkpointer  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import DataPipeline as JaxDataPipeline  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.optim import optimizers as jax_optim  # noqa: E402
from repro.train.steps import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.synthetic import BigramStream, DataPipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.schema import init_params  # noqa: E402
from repro_torch.optim.optimizers import apply_updates, init_opt_state  # noqa: E402
from repro_torch.train.steps import lm_loss, make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, make_lm_objective  # noqa: E402

ARCH = "gemma2-2b"
HYBRID = (("mamba", "moe"), ("attn", "mlp"))
# the chunked loss: logsumexp over 512-576 f32 logits of O(10) after the softcap
LOSS_ATOL = 2e-6
# one optimizer update of O(1) values in f32: an ulp or two
OPT_ATOL = 1e-6
# three train steps of the reduced models at lr 1e-3, (metrics, weights),
# each about 4x what the CPU measured. RMSProp moves a weight by
# lr g / sqrt(g2 + 0.1), so the gradients' rounding (~2e-6 of their scale)
# barely shows (measured 9.5e-7 and 1.5e-8 in both models). AdamW's first
# step moves a weight by lr g / (|g| + 1e-8), about lr whatever the size of
# g, so a small gradient's rounding moves its weight by up to ~1e-5 (gemma2:
# 4.8e-7, 1.24e-5). In the hybrid one weight of ``b0_mamba.in_proj`` has a
# first gradient below that 1e-8 (3.2e-9 here, 6.1e-9 in the reference: a
# sum that cancels to rounding noise), so its first update is the ratio of
# two rounding-sized numbers: 1.39e-4 apart, every other weight within
# 3.1e-5, metrics 2.7e-5. The router picks the same experts for every token
# at every step in both (the nearest second/third logits 2.3e-3 apart).
STEP_ATOL = {(ARCH, "rmsprop"): (4e-6, 1e-7), (ARCH, "adamw"): (2e-6, 5e-5),
             ("jamba-v0.1-52b", "rmsprop"): (4e-6, 1e-7),
             ("jamba-v0.1-52b", "adamw"): (1e-4, 3e-4)}
# the Trainer's losses (AdamW, lr 2e-3, reduced gemma2)
TRAINER_LOSS_ATOL = 1e-4


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# loss and optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad,chunk,S", [(0, 1024, 13), (64, 4, 13), (0, 5, 15), (64, 13, 13)])
def test_lm_loss_matches_reference(pad, chunk, S):
    """gemma2's final softcap (30); an unembed ``pad`` columns wider than the
    vocab (masked); S a multiple of ``chunk`` or not."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    assert cfg.final_softcap
    rng = np.random.default_rng(0)
    D, V = cfg.d_model, cfg.vocab_size
    params = {"final_norm_scale": (rng.standard_normal(D) * 0.1 + 1).astype(np.float32),
              "unembed": (rng.standard_normal((D, V + pad)) * 0.2).astype(np.float32)}
    hidden = rng.standard_normal((2, S, D)).astype(np.float32) * 3
    labels = rng.integers(0, V, size=(2, S))
    ref = float(jax_lm_loss(jcfg, {k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(hidden), jnp.asarray(labels, jnp.int32), chunk))
    out = lm_loss(cfg, {k: torch.from_numpy(v) for k, v in params.items()},
                  torch.from_numpy(hidden), torch.from_numpy(labels), chunk)
    assert out.dtype == torch.float32 and out.shape == ()
    np.testing.assert_allclose(out.item(), ref, atol=LOSS_ATOL)


OPT_CASES = [
    # optimizer, warmup_steps, grad_clip, weight_decay, overrides
    ("rmsprop", 0, 0.0, 0.0, {}),
    ("rmsprop", 3, 1.0, 0.0, {}),
    ("adamw", 0, 0.0, 0.0, {}),
    ("adamw", 3, 1.0, 0.1, {}),
    ("adamw", 0, 100.0, 0.0, {}),
    ("rmsprop", 0, 1.0, 0.0, {"lr": 0.05, "grad_clip": 0.5, "warmup_steps": 4.0}),
    ("adamw", 2, 1.0, 0.0, {"lr": 0.02, "grad_clip": 2.0, "warmup_steps": 0.5}),
]


@pytest.mark.parametrize("optimizer,warmup,clip,wd,overrides", OPT_CASES)
def test_apply_updates_matches_reference(optimizer, warmup, clip, wd, overrides):
    """Three updates of a small tree: weights, accumulators, step count and
    grad norm (clipping at 1 and 0.5 scales these gradients, of norm ~7)."""
    kw = dict(learning_rate=0.01, optimizer=optimizer, warmup_steps=warmup,
              grad_clip=clip, weight_decay=wd)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    jstate, state = jax_optim.init_opt_state(jtc, jp), init_opt_state(tc, tp)
    jover = {k: jnp.float32(v) for k, v in overrides.items()}
    tover = {k: torch.tensor(v) for k, v in overrides.items()}
    for step in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32) * 2 for n, s in shapes.items()}
        jp, jstate, jgn = jax_optim.apply_updates(
            jtc, jp, {n: jnp.asarray(g) for n, g in grads.items()}, jstate, **jover)
        tp, state, gn = apply_updates(tc, tp, {n: torch.from_numpy(g) for n, g in grads.items()},
                                      state, **tover)
        np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-6)
        assert int(state.step) == int(jstate.step) == step + 1
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), atol=OPT_ATOL,
                                       err_msg=f"step {step} {n}")
            np.testing.assert_allclose(state.acc1[n].numpy(), np.asarray(jstate.acc1[n]),
                                       atol=OPT_ATOL, rtol=1e-6)
            if optimizer == "adamw":
                np.testing.assert_allclose(state.acc2[n].numpy(), np.asarray(jstate.acc2[n]),
                                           atol=OPT_ATOL, rtol=1e-6)
    assert (state.acc2 is None) == (jstate.acc2 is None) == (optimizer == "rmsprop")


def test_rmsprop_eps_sits_inside_the_root():
    """The reference's p -= lr g / sqrt(g2 + eps), with eps 0.1: not
    ``torch.optim.RMSprop``'s sqrt(g2) + eps."""
    tc = TrainConfig(learning_rate=0.1, optimizer="rmsprop", rmsprop_decay=0.9,
                     rmsprop_eps=0.01, grad_clip=0.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -1.0])}
    p2, st2, _ = apply_updates(tc, p, g, init_opt_state(tc, p))
    acc = 0.1 * np.array([0.25, 1.0])
    expect = np.array([1.0, 2.0]) - 0.1 * np.array([0.5, -1.0]) / np.sqrt(acc + 0.01)
    np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-6)
    assert st2.acc2 is None


def test_updates_keep_the_weight_dtype():
    """bf16 weights: f32 accumulators, an f32 update cast back to bf16."""
    tc = TrainConfig(optimizer="adamw", learning_rate=0.5)
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = init_opt_state(tc, p)
    p2, st2, gn = apply_updates(tc, p, {"w": torch.full((4,), 3.0, dtype=torch.bfloat16)}, st)
    assert p2["w"].dtype == torch.bfloat16 and st2.acc1["w"].dtype == torch.float32
    assert gn.dtype == torch.float32 and gn.item() == pytest.approx(6.0)
    np.testing.assert_allclose(p2["w"].float().numpy(), 0.5, atol=4e-3)


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------
def test_data_pipeline_gives_the_reference_tokens():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    ref, out = iter(JaxDataPipeline(jcfg, 3, 17, seed=5)), iter(
        DataPipeline(cfg, 3, 17, seed=5, device="cpu"))
    for _ in range(3):
        r, o = next(ref), next(out)
        for key in ("tokens", "labels"):
            assert o[key].dtype == torch.int64 and o[key].shape == (3, 17)
            np.testing.assert_array_equal(o[key].numpy(), np.asarray(r[key]))
    np.testing.assert_array_equal(BigramStream(64, seed=3).sample(4, 50),
                                  BigramStream(64, seed=3).sample(4, 50))


def test_data_pipeline_refuses_what_is_not_ported():
    """The vlm family and a mesh are refused; an encoder-decoder is ported:
    its batches add the reference's ``enc_embeds``, bit for bit."""
    cfg = get_config(ARCH).reduced()
    with pytest.raises(NotImplementedError, match="not ported"):
        DataPipeline(dataclasses.replace(cfg, family="vlm"), 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        DataPipeline(cfg, 2, 8, mesh=object(), device="cpu")
    kw = dict(family="encdec", n_enc_layers=1, enc_seq=6)
    ref = next(iter(JaxDataPipeline(dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
                                    2, 8, seed=1)))
    out = next(iter(DataPipeline(dataclasses.replace(cfg, **kw), 2, 8, seed=1, device="cpu")))
    assert set(out) == set(ref) == {"tokens", "labels", "enc_embeds"}
    for key in out:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    """Every weight comes back bit for bit, under the reference's keys."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(), dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    path = os.path.join(tmp_path, "ckpt.pt")
    checkpointer.save(path, params, {"arch": cfg.name, "steps": 3})
    like = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    restored = checkpointer.restore(path, like)
    got, want = dict(restored.named_parameters()), dict(params.named_parameters())
    assert set(got) == set(want)
    for n, t in want.items():
        assert got[n].dtype == getattr(torch, dtype)
        assert torch.equal(got[n], t), n
    assert checkpointer.load_metadata(path) == {"arch": cfg.name, "steps": 3}
    jparams = jax_schema.init_params(
        dataclasses.replace(jax_get_config("jamba-v0.1-52b").reduced(), dtype=dtype),
        jax.random.PRNGKey(0))
    assert set(torch.load(path, weights_only=True)) == set(jax_checkpointer._flatten(jparams))
    nested = checkpointer.restore(path, {"dec": {"b0_mamba": {
        "a_log": torch.zeros(params["dec"]["b0_mamba"]["a_log"].shape)}}})
    assert torch.equal(nested["dec"]["b0_mamba"]["a_log"],
                       params["dec"]["b0_mamba"]["a_log"].float())
    with pytest.raises(ValueError, match="embed"):
        checkpointer.restore(path, {"embed": torch.zeros(3, 3)})


# ---------------------------------------------------------------------------
# train steps, Trainer, objective, CLI
# ---------------------------------------------------------------------------
def _models(arch, pattern=None, n_layers=None):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if pattern is not None:
        jcfg = dataclasses.replace(jcfg, pattern=pattern, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, pattern=pattern, n_layers=n_layers)
    return jcfg, cfg


@pytest.mark.parametrize("optimizer", ["adamw", "rmsprop"])
@pytest.mark.parametrize("arch,pattern,n_layers", [(ARCH, None, None),
                                                   ("jamba-v0.1-52b", HYBRID, 2)])
def test_three_train_steps_match_reference(arch, pattern, n_layers, optimizer):
    jcfg, cfg = _models(arch, pattern, n_layers)
    metric_atol, param_atol = STEP_ATOL[arch, optimizer]
    kw = dict(learning_rate=1e-3, optimizer=optimizer, loss_chunk=5)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    jstate, state = jax_optim.init_opt_state(jtc, jparams), init_opt_state(tc, params)
    jstep, step = jax.jit(jax_make_train_step(jcfg, jtc)), make_train_step(cfg, tc)
    data = JaxDataPipeline(jcfg, 2, 12, seed=0)
    for i in range(3):
        batch = next(data)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        params, state, m = step(params, state, {k: torch.from_numpy(np.asarray(v, np.int64))
                                                for k, v in batch.items()})
        for key in ("loss", "aux_loss", "grad_norm"):
            assert m[key].shape == () and not m[key].requires_grad
            np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=metric_atol,
                                       err_msg=f"step {i} {key}")
    if pattern is not None:
        assert m["aux_loss"].item() > 0
    ref = _flat(jparams)
    for n, t in params.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), ref[n.replace(".", "/")],
                                   atol=param_atol, err_msg=n)


def test_trainer_losses_match_reference_and_fall():
    """Both Trainers from the reference's seed-0 weights (the test swaps them
    into the port's) and a fresh optimizer state, on the same bigram data."""
    jcfg, cfg = _models(ARCH)
    kw = dict(learning_rate=2e-3, optimizer="adamw", loss_chunk=16)
    ref = JaxTrainer(jcfg, JaxTrainConfig(**kw), batch=4, seq=32, seed=0)
    tr = Trainer(cfg, TrainConfig(**kw), batch=4, seq=32, seed=0, device="cpu")
    tr.params = params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg, device="cpu")
    tr.opt_state = init_opt_state(tr.tc, tr.params)
    ref_tail, tail = ref.run(12), tr.run(12)
    np.testing.assert_allclose(tr.losses, ref.losses, atol=TRAINER_LOSS_ATOL)
    np.testing.assert_allclose(tail, ref_tail, atol=TRAINER_LOSS_ATOL)
    assert np.mean(tr.losses[-3:]) < np.mean(tr.losses[:3]) - 0.2, tr.losses
    assert tr.step_count == 12


def test_lm_objective_trains_a_reduced_model():
    objective = make_lm_objective(ARCH, steps_per_phase=3, batch=2, seq=16, device="cpu")
    metric, state = objective({"learning_rate": 1e-3, "loss_chunk": 8}, 0, None)
    assert isinstance(state, Trainer) and state.tc.loss_chunk == 8
    assert metric == pytest.approx(-state.losses[-1])
    metric2, state2 = objective({}, 1, state)
    assert state2 is state and state.step_count == 6 and np.isfinite(metric2)


def test_train_cli_runs_reduced_on_cpu(capsys, tmp_path):
    path = str(tmp_path / "ckpt.pt")
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
                    "--batch", "2", "--seq", "16", "--checkpoint", path])
    out = capsys.readouterr().out
    assert "arch=gemma2-2b params=" in out and "batch=2 seq=16" in out
    assert "done: 4 steps in" in out and f"checkpoint written to {path}" in out
    assert checkpointer.load_metadata(path) == {"arch": "gemma2-2b", "steps": 4}
    with pytest.raises(NotImplementedError, match="one card"):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--data-parallel", "2"])


def test_train_step_runs_its_optimizer_in_a_named_range():
    """A profiler reads the optimizer's time from the step's own
    ``optimizer`` range: the AdamW moments' in-place updates run inside
    it."""
    from torch.profiler import ProfilerActivity, profile
    _, cfg = _models(ARCH)
    tc = TrainConfig(optimizer="adamw", learning_rate=1e-3)
    tr = Trainer(cfg, tc, batch=1, seq=8, seed=0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(1)
    ranges = [ev for ev in prof.events() if ev.name == "optimizer"]
    assert len(ranges) == 1
    inside = set()
    stack = list(ranges[0].cpu_children)
    while stack:
        ev = stack.pop()
        inside.add(ev.name)
        stack.extend(ev.cpu_children)
    assert {"aten::mul_", "aten::add_", "aten::sqrt"} <= inside, inside
