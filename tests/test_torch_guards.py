"""Rules of the port: it imports nothing of JAX or of the JAX package, and
its entry points never fall back to the CPU when the GPU is missing."""
import ast
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.synthetic import DataPipeline  # noqa: E402
from repro_torch.core import service as search_service  # noqa: E402
from repro_torch.core.executor import PopulationCluster  # noqa: E402
from repro_torch.population.engine import PopulationEngine  # noqa: E402
from repro_torch.launch import serve, step_times, train, train_devices, tune  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from repro_torch.models.schema import init_params  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.train.trainer import Trainer, make_lm_objective  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files, "no port sources found"
    return files + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [m for m in _imports(path) if FORBIDDEN.match(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_pattern():
    for name in ("jax", "jax.numpy", "jaxlib", "repro", "repro.models.layers"):
        assert FORBIDDEN.match(name), name
    for name in ("repro_torch", "repro_torch.models", "jaxtyping", "torch"):
        assert not FORBIDDEN.match(name), name


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    cfg = get_config("gemma2-2b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 1, 16)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params, batch_size=1, max_seq=16)
    tree = {"embed": np.zeros((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "gemma2-2b", "--reduced"])


def test_train_entry_points_raise_without_gpu(no_gpu):
    cfg = get_config("gemma2-2b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainConfig(), batch=2, seq=8)
    with pytest.raises(RuntimeError, match="cuda"):
        DataPipeline(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        make_lm_objective("gemma2-2b", steps_per_phase=1)({}, 0, None)
    # weights drawn on the card for a CPU trainer need the card too
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainConfig(), batch=2, seq=8, device="cpu", init_device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "gemma2-2b", "--reduced", "--steps", "1"])


def test_step_times_needs_a_card(no_gpu):
    # a timing of the card has no CPU path to fall back to
    with pytest.raises(RuntimeError, match="cuda"):
        step_times.main(["--arch", "gemma2-2b", "--layers", "1", "--repeats", "1"])


def test_train_devices_needs_a_card_unless_told_otherwise(no_gpu):
    # its default devices are the card and the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        train_devices.main(["--arch", "gemma2-2b", "--reduced", "--steps", "1"])


def test_tune_needs_a_card_before_any_trial(no_gpu, monkeypatch):
    """The search raises for the missing card itself: a trial's error would
    only mark that trial crashed, and the search would end with exit 0."""
    acquired = []
    real = search_service.OptimizationService.acquire_trial
    monkeypatch.setattr(search_service.OptimizationService, "acquire_trial",
                        lambda self, *a, **k: acquired.append(a) or real(self, *a, **k))
    with pytest.raises(RuntimeError, match="cuda"):
        tune.main(["--objective", "lm", "--workers", "2", "--nodes", "1", "--phases", "1",
                   "--steps-per-phase", "1"])
    assert acquired == []


def test_vectorized_tune_needs_a_card_before_any_trial(no_gpu, monkeypatch):
    """The population backend checks the card before it builds anything:
    ``tune --backend vectorized`` and ``PopulationCluster`` raise unless
    given the CPU."""
    acquired = []
    real = search_service.OptimizationService.acquire_trial
    monkeypatch.setattr(search_service.OptimizationService, "acquire_trial",
                        lambda self, *a, **k: acquired.append(a) or real(self, *a, **k))
    with pytest.raises(RuntimeError, match="cuda"):
        tune.main(["--backend", "vectorized", "--workers", "2", "--phases", "1",
                   "--episodes-per-phase", "1", "--n-envs", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        PopulationCluster(2)
    with pytest.raises(RuntimeError, match="cuda"):
        PopulationEngine("pong", max_slots=2)
    assert acquired == []
    PopulationCluster(2, device="cpu")


def test_engine_refuses_params_on_another_device():
    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(cfg, params, batch_size=1, max_seq=16, device="cpu")
