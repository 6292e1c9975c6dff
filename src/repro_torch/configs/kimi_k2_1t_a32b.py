"""kimi-k2-1t-a32b [moe] — arXiv:2501.kimi2 (paper-table trillion-param MoE).

61L, d_model=7168, 64 heads (GQA kv=8), per-expert d_ff=2048, vocab=163840,
MoE 384 experts top-8. E=384 >> model-axis 16 -> sort-based expert-parallel
shard_map path with all_to_all token exchange.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,                   # assigned: per-expert hidden size
    moe_d_ff=2048,
    vocab_size=163840,
    pattern=(("attn", "moe"),),
    n_experts=384,
    top_k=8,
    rope_theta=50000.0,
    long_context_window=8192,
))
