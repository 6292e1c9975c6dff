"""yi-9b [dense] — arXiv:2403.04652. Llama-arch GQA.

48L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    pattern=(("attn", "mlp"),),
    rope_theta=10000.0,
    long_context_window=8192,
))
