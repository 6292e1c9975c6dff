"""phi3-mini-3.8b [dense] — arXiv:2404.14219.

32L, d_model=3072, 32 heads (GQA kv=32 -> MHA), d_ff=8192, vocab=32064,
RoPE + SwiGLU.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    pattern=(("attn", "mlp"),),
    rope_theta=10000.0,
    long_context_window=8192,
))
