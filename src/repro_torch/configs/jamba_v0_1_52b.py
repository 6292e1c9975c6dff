"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536,
MoE 16 experts top-2. Jamba block: 8 layers with attention at index 4
(1:7 attn:mamba) and MoE replacing the MLP every other layer (e=2).
Native long-context support (SSM + single attn layer per block).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

_PATTERN = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp")
    for i in range(8)
)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PATTERN,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    use_rope=False,              # Jamba uses no positional encoding
    ssm_d_state=16,
    ssm_expand=2,
    long_context_window=8192,    # bounds the single attn layer's cache at 500k
))
