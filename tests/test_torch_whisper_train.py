"""whisper-large-v3's training path in the port against the JAX package, on
the CPU, at the reduced size (one encoder and one decoder layer, 16 encoder
frames, d_model 256, f32): the data pipeline's batches, the non-causal
attention's gradient through ``PlainGrad``, the model's gradients under every
``remat``, AdamW steps, the train CLIs, the tune CLI's process backend, and the
population engine, where both packages fail.

Weights carry across with ``params_from_numpy``; tokens and the encoder's
frame embeddings come from the pipelines, which draw the same numbers from
the same seed.
"""
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import DataPipeline as JaxDataPipeline  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.optim import optimizers as jax_optim  # noqa: E402
from repro.train.steps import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.synthetic import DataPipeline  # noqa: E402
from repro_torch.distributed.journal import read_events  # noqa: E402
from repro_torch.kernels.autograd import kernel_op  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import train_devices  # noqa: E402
from repro_torch.launch import tune  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.optim.optimizers import init_opt_state  # noqa: E402
from repro_torch.train.steps import lm_loss, make_train_step  # noqa: E402

ARCH = "whisper-large-v3"
# one op's input gradients in f32 (tests/test_torch_train_grad.py)
OP_ATOL = 2e-5
# a weight's gradient, relative to the largest entry of the reference's
# gradient of that weight (tests/test_torch_train_grad.py)
MODEL_GRAD_RTOL = 2e-5
LOSS_ATOL = 1e-5
# the Trainer's limit on losses, aux losses and grad norms
# (tests/test_torch_train.py)
TRAINER_LOSS_ATOL = 1e-4
# every weight after three AdamW steps at lr 1e-3, about 4x what the CPU
# measured (4.55e-5, at ``dec.b0_attn.c_wk``; the metrics 9.5e-7): AdamW's
# first step moves a weight by about lr g / (|g| + 1e-8) whatever the size of
# g, so a small gradient's rounding moves its weight by a share of lr. The
# cross attention's key weights take small gradients: a softmax does not
# change when one query's scores all move alike
WEIGHT_ATOL = 2e-4
B, S = 2, 12

_MODELS = {}


def _models():
    """(jcfg, jax params, cfg, port params) of the reduced config."""
    if not _MODELS:
        jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
        jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _MODELS.update(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params)
    return _MODELS["jcfg"], _MODELS["jparams"], _MODELS["cfg"], _MODELS["params"]


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_batch(batch):
    """A reference batch as the port's: int64 tokens and labels, f32 frames."""
    return {k: torch.from_numpy(np.array(v, np.float32 if k == "enc_embeds" else np.int64))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
def test_data_pipeline_gives_the_reference_whisper_batches(seed):
    """Tokens, labels and the encoder's frames, bit for bit, for 3 batches:
    the frames come after each batch's tokens from a second generator."""
    jcfg, _, cfg, _ = _models()
    ref = iter(JaxDataPipeline(jcfg, 3, 17, seed=seed))
    out = iter(DataPipeline(cfg, 3, 17, seed=seed, device="cpu"))
    for _ in range(3):
        r, o = next(ref), next(out)
        assert set(o) == set(r) == {"tokens", "labels", "enc_embeds"}
        for key in ("tokens", "labels"):
            assert o[key].dtype == torch.int64 and o[key].shape == (3, 17)
            np.testing.assert_array_equal(o[key].numpy(), np.asarray(r[key]))
        enc = o["enc_embeds"]
        assert enc.dtype == torch.float32 and enc.shape == (3, cfg.enc_seq, cfg.d_model)
        np.testing.assert_array_equal(enc.numpy(), np.asarray(r["enc_embeds"]))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


NON_CAUSAL_CASES = {
    # B, Sq, Skv, Hq, Hkv, hd: the encoder's self attention, cross attention
    # (decoder queries onto encoder keys), and MHA at whisper's head dim
    "encoder_self": (2, 20, 20, 4, 2, 16),
    "cross": (2, 12, 20, 4, 2, 16),
    "cross_mha_hd64": (1, 12, 20, 4, 4, 64),
}


@pytest.mark.parametrize("case", sorted(NON_CAUSAL_CASES))
def test_non_causal_flash_grads_match_jax(case):
    """The CUDA path's ``PlainGrad`` (the plain version standing in for the
    kernel forward) with ``causal=False``: q, k and v take the gradient of
    ``jax.grad`` of the reference's chunked attention. The chunk (8) is below
    Skv, so the online-softmax form runs."""
    B_, Sq, Skv, Hq, Hkv, hd = NON_CAUSAL_CASES[case]
    rng = np.random.default_rng(2)
    q, k, v = _np(rng, B_, Sq, Hq, hd), _np(rng, B_, Skv, Hkv, hd), _np(rng, B_, Skv, Hkv, hd)
    ct = _np(rng, B_, Sq, Hq, hd)
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(jax_chunked(q_, k_, v_, causal=False, chunk=8) * ct),
                  argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v))
    plain = flash_ops.flash_attention_plain

    def stand_in(*a):
        with torch.no_grad():
            return plain(*a)

    out = kernel_op(stand_in, plain, qt, kt, vt, None, False, 0, 0.0, 0, 8)
    assert type(out.grad_fn).__name__ == "PlainGradBackward", out.grad_fn
    (out * torch.from_numpy(ct)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OP_ATOL)


@pytest.fixture(scope="module")
def whisper_grads():
    """The reference's gradient of ``lm_loss + aux`` of the reduced model,
    the encoder fed the pipeline's frames."""
    jcfg, jparams, cfg, params = _models()
    batch = next(iter(JaxDataPipeline(jcfg, B, S, seed=3)))

    def jloss(p):
        h, _, aux = jax_forward(jcfg, p, batch, mode="train")
        loss = jax_lm_loss(jcfg, p, h, batch["labels"], 5)
        return loss + aux, (loss, aux)

    jgrads, (jl, jaux) = jax.jit(jax.grad(jloss, has_aux=True))(jparams)
    return cfg, params, _torch_batch(batch), _flat(jgrads), float(jl), float(jaux)


def _grads(cfg, params, batch, remat):
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    h, _, aux = forward(cfg, params, batch, mode="train", remat=remat)
    loss = lm_loss(cfg, params, h, batch["labels"], 5)
    grads = torch.autograd.grad(loss + aux, list(named.values()))
    return ({n.replace(".", "/"): g for n, g in zip(named, grads)}, loss.item(), aux.item())


def test_model_grads_match_jax(whisper_grads):
    """Every weight's gradient, the encoder's and the cross attention's
    included."""
    cfg, params, batch, jgrads, jl, jaux = whisper_grads
    grads, loss, aux = _grads(cfg, params, batch, "none")
    assert set(grads) == set(jgrads)
    assert any(n.startswith("enc/") for n in grads) and any("c_wq" in n for n in grads)
    np.testing.assert_allclose(loss, jl, atol=LOSS_ATOL)
    assert aux == jaux == 0.0
    for name, g in grads.items():
        ref = jgrads[name]
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=MODEL_GRAD_RTOL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recomputes_the_decoder_not_the_encoder(whisper_grads, remat, monkeypatch):
    """As the reference's ``encode`` runs outside the checkpointed scan body,
    the port's encoder runs once: only the decoder's attention blocks (self
    and cross) run again in the backward. The gradients are those without
    remat."""
    cfg, params, batch = whisper_grads[:3]
    base, loss0, aux0 = _grads(cfg, params, batch, "none")
    calls = {"encoder": 0, "self": 0, "cross": 0}
    attn_block, cross_attn_block = model_mod.attn_block, model_mod.cross_attn_block

    def counted_attn(*a, causal=True, **k):
        calls["self" if causal else "encoder"] += 1
        return attn_block(*a, causal=causal, **k)

    def counted_cross(*a, **k):
        calls["cross"] += 1
        return cross_attn_block(*a, **k)

    monkeypatch.setattr(model_mod, "attn_block", counted_attn)
    monkeypatch.setattr(model_mod, "cross_attn_block", counted_cross)
    grads, loss, aux = _grads(cfg, params, batch, remat)
    assert calls == {"encoder": cfg.n_enc_layers, "self": 2 * cfg.n_layers,
                     "cross": 2 * cfg.n_layers}, calls
    assert (loss, aux) == (loss0, aux0)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), base[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# AdamW steps and the CLIs
# ---------------------------------------------------------------------------
def test_three_adamw_steps_match_reference():
    """Three AdamW steps from the reference's weights, each package fed by
    its own pipeline from seed 0 (the same batches): loss, aux and grad norm
    within the Trainer's limit, then every weight."""
    jcfg, jparams, cfg, _ = _models()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    kw = dict(learning_rate=1e-3, optimizer="adamw", loss_chunk=5)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = jax_optim.init_opt_state(jtc, jparams), init_opt_state(tc, params)
    jstep, step = jax.jit(jax_make_train_step(jcfg, jtc)), make_train_step(cfg, tc)
    jdata, data = JaxDataPipeline(jcfg, B, S, seed=0), DataPipeline(cfg, B, S, seed=0,
                                                                    device="cpu")
    losses = []
    for i in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, next(jdata))
        params, state, m = step(params, state, next(data))
        for key in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), atol=TRAINER_LOSS_ATOL,
                                       err_msg=f"step {i} {key}")
        losses.append(m["loss"].item())
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    ref = _flat(jparams)
    for n, t in params.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), ref[n.replace(".", "/")],
                                   atol=WEIGHT_ATOL, err_msg=n)


def test_train_clis_run_whisper_reduced_on_the_cpu(capsys):
    """``launch/train.py`` and ``launch/train_devices.py`` take the arch as
    the other archs, with ``--reduced`` and ``--layers``."""
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} params=" in out and "done: 2 steps in" in out
    got = train_devices.main(["--arch", ARCH, "--reduced", "--layers", "2", "--devices",
                              "cpu,cpu", "--steps", "2", "--batch", "2", "--seq", "8"])
    assert got["n_layers"] == 2 and got["max_abs_diff_by_step"] == [0.0, 0.0]
    assert all(math.isfinite(x) for run in got["runs"] for x in run["losses"])


def _trials(path):
    """{trial id: (hparams, status, reports)} from a search's journal."""
    table = {}
    for ev in read_events(path):
        tid = ev.get("trial_id")
        if ev["ev"] == "acquire":
            table[tid] = [ev["hparams"], "running", []]
        elif ev["ev"] == "report":
            table[tid][2].append(ev["metric"])
        elif ev["ev"] == "status":
            table[tid][1] = ev["status"]
    return table


@pytest.mark.timeout(300)
def test_tune_cli_process_backend_runs_whisper_on_the_cpu(monkeypatch, capsys, tmp_path):
    """``tune --backend process --objective lm --arch whisper-large-v3`` in
    worker processes, against the reference's CLI on the same arguments.
    Each package draws its own weights, so what is held is what neither
    the weights nor the timing moves: the summary's keys, the trials'
    configurations by trial id, no crashed trial, 1 to ``--phases`` finite
    reports a trial (all of them when it completed)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--backend", "process", "--objective", "lm", "--arch", ARCH, "--workers", "3",
            "--nodes", "2", "--phases", "2", "--steps-per-phase", "2", "--lease-ttl", "30"]
    tune.main(["--device", "cpu", *argv, "--journal", str(tmp_path / "j.jsonl"),
               "--out", str(tmp_path / "s.json")])
    printed = json.loads((tmp_path / "s.json").read_text())
    from repro.launch import tune as ref_tune
    monkeypatch.setattr(sys, "argv", ["tune", *argv, "--journal", str(tmp_path / "ref.jsonl")])
    ref = ref_tune.main().summary()
    assert set(printed) == set(ref) | {"expected_alpha", "min_alpha"}
    assert printed["n_trials"] == ref["n_trials"] == 3
    ours, theirs = _trials(str(tmp_path / "j.jsonl")), _trials(str(tmp_path / "ref.jsonl"))
    assert {t: hp for t, (hp, _, _) in ours.items()} == {t: hp for t, (hp, _, _) in theirs.items()}
    for table in (ours, theirs):
        for tid, (_, status, ms) in table.items():
            assert status in ("completed", "killed"), (tid, status)
            assert 1 <= len(ms) <= 2 and (status != "completed" or len(ms) == 2), (tid, ms)
            assert all(math.isfinite(m) for m in ms), (tid, ms)
    capsys.readouterr()


def test_population_engine_refuses_whisper_where_the_reference_fails(monkeypatch):
    """The reference's population LM step feeds tokens and labels alone, so
    its cross attention reads a cache that is not there and raises
    ``TypeError``; the port's slot path refuses, naming absolute positions."""
    argv = ["--backend", "vectorized", "--objective", "lm", "--arch", ARCH, "--workers", "2",
            "--phases", "1", "--steps-per-phase", "1"]
    with pytest.raises(NotImplementedError, match="absolute positions"):
        tune.main(["--device", "cpu", *argv])
    from repro.launch import tune as ref_tune
    monkeypatch.setattr(sys, "argv", ["tune", *argv])
    with pytest.raises(TypeError):
        ref_tune.main()

