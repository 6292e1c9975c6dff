"""starcoder2-3b [dense] — arXiv:2402.19173.

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288, vocab=49152, RoPE.
StarCoder2-3B uses LayerNorm + GELU (gpt-bigcode lineage).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    pattern=(("attn", "mlp"),),
    rope_theta=999999.4420358813,
    norm="layernorm",
    act="gelu",
    long_context_window=8192,
))
