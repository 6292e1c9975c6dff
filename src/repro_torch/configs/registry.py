"""Architecture registry: ``--arch <id>`` lookup for the ported configs."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # import every config module for its register() side effect; a module
    # registers once, however often this runs
    from repro_torch.configs import (a3c_atari, gemma2_2b, grok_1_314b,  # noqa: F401
                                     jamba_v0_1_52b, kimi_k2_1t_a32b, phi3_mini_3_8b,
                                     starcoder2_3b, whisper_large_v3, yi_9b)
