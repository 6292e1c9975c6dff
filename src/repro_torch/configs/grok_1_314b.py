"""grok-1-314b [moe] — hf:xai-org/grok-1.

64L, d_model=6144, 48 heads (GQA kv=8), d_ff=32768, vocab=131072,
MoE 8 experts top-2 in every layer. E=8 < model-axis 16 -> experts use the
tensor-parallel MoE path (d_ff sharded, experts replicated).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    source="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    pattern=(("attn", "moe"),),
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    attn_softcap=30.0,           # grok caps attention logits
    final_softcap=30.0,
    long_context_window=8192,
))
