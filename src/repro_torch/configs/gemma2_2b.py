"""gemma2-2b [dense] — arXiv:2408.00118.

26L, d_model=2304, 8 heads (GQA kv=4), d_ff=9216, vocab=256000.
Alternating local(window=4096)/global attention, attn softcap 50,
final-logit softcap 30, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=(("attn_local", "mlp"), ("attn_global", "mlp")),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    scale_embed=True,
    long_context_window=8192,
))
