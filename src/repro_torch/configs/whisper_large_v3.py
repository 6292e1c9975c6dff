"""whisper-large-v3 [audio, enc-dec] — arXiv:2212.04356 (+ v3 model card).

32 encoder + 32 decoder layers, d_model=1280, 20 heads (kv=20 -> MHA),
d_ff=5120, vocab=51866. The conv/mel frontend is a stub, as in the
reference: frames come in as embeddings (B, 1500, d_model) for the encoder.
Whisper uses LayerNorm + GELU MLPs and absolute (sinusoidal) positions.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    source="arXiv:2212.04356",
    n_layers=32,                 # decoder layers
    n_enc_layers=32,
    enc_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    pattern=(("attn", "mlp"),),
    use_rope=False,
    abs_pos=True,
    norm="layernorm",
    act="gelu",
    long_context_window=8192,    # documented variant for long_500k decode
))
