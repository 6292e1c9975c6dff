"""The port's ServingEngine against the JAX package's on the same weights,
and its own batched-vs-single and output-length invariants."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.schema import init_params  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

ARCH = "gemma2-2b"


def _prompts(cfg, n=3, size=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=size).astype(np.int32)
            for _ in range(n)]


def _serve(engine, prompts, max_new=6, request=Request):
    for i, p in enumerate(prompts):
        engine.submit(request(i, p, max_new_tokens=max_new))
    return {r.request_id: r.output for r in engine.run_batch()}


def test_greedy_tokens_match_reference_engine():
    # the setup of tests/test_serving.py::test_engine_batch_matches_single
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = _prompts(cfg)
    ref = _serve(JaxServingEngine(jcfg, jparams, batch_size=3, max_seq=64),
                 prompts, request=JaxRequest)
    out = _serve(ServingEngine(cfg, params, batch_size=3, max_seq=64, device="cpu"),
                 prompts)
    assert out == ref


def test_batched_matches_single():
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = _prompts(cfg, seed=1)
    batched = _serve(ServingEngine(cfg, params, 3, 64, device="cpu"), prompts)
    for i, p in enumerate(prompts):
        single = _serve(ServingEngine(cfg, params, 1, 64, device="cpu"), [p])[0]
        assert single == batched[i], (i, single, batched[i])


def test_output_lengths():
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=48, device="cpu")
    rng = np.random.default_rng(1)
    for i in range(5):      # the last group is one request in a padded batch
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, size=8),
                           max_new_tokens=4))
    done = eng.run_batch()
    assert sorted(r.request_id for r in done) == list(range(5))
    assert all(len(r.output) == 4 and r.done for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.output)


def test_run_one_matches_reference_engine():
    """The single-request path, against the reference engine's ``_run_one``."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jax_schema.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    ref_engine = JaxServingEngine(jcfg, jparams, batch_size=1, max_seq=64)
    engine = ServingEngine(cfg, params, batch_size=1, max_seq=64, device="cpu")
    for i, p in enumerate(_prompts(cfg, n=2, size=10, seed=2)):
        ref = ref_engine._run_one(JaxRequest(i, p, max_new_tokens=5))
        out = engine._run_one(Request(i, p, max_new_tokens=5))
        assert out.done and len(out.output) == 5
        assert out.output == ref.output, (i, out.output, ref.output)
    assert engine._run_one(Request(9, p, max_new_tokens=0)).output == []
