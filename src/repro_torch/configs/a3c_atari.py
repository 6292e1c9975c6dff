"""The paper's own architecture: the A3C/GA3C Atari DNN (Mnih et al. 2016;
a copy of ``repro/configs/a3c_atari.py``).

Two conv layers + one fully-connected layer + policy softmax & value heads.
Registered so the RL objective is selectable via --arch like every other
config; dims are carried by ``repro_torch.rl.network.A3CNetConfig``.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

# Registered as a ModelConfig shell for registry uniformity; the RL stack
# (repro_torch.rl) holds the real conv-net definition. Nothing serves or
# trains it as a language model: a walk over list_archs() leaves it out.
CONFIG = register(ModelConfig(
    name="a3c-atari",
    family="rl",
    source="arXiv:1602.01783 (A3C), ICLR'17 GA3C",
    n_layers=1,
    d_model=256,
    n_heads=1,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=18,               # max Atari action-set size
    pattern=(("attn", "mlp"),),
))
