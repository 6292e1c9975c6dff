"""Model and training configuration for the PyTorch port.

Copies of ``repro.configs.base.ModelConfig`` and ``TrainConfig`` (the port
imports nothing of the JAX package), without the fields only the JAX
package reads. Every assigned architecture gets a ``ModelConfig`` in
``repro_torch/configs/<id>.py`` citing its source; ``reduced()`` returns the
CPU smoke-test variant of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# A model is a repeated *pattern* of (mixer, ffn) blocks, applied ``n_repeat``
# times over stacked parameters.
#   mixer: 'attn' | 'attn_local' | 'attn_global' | 'mamba' | 'mlstm' | 'slstm'
#   ffn:   'mlp' | 'moe' | None
BlockSpec = Tuple[str, Optional[str]]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    source: str                      # citation for the assigned config
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # decoder block pattern (repeated n_layers/len(pattern) times)
    pattern: Tuple[BlockSpec, ...] = (("attn", "mlp"),)

    # attention
    rope_theta: float = 10000.0
    use_rope: bool = True
    window: int = 0                  # sliding window size for 'attn_local' (0 = full)
    attn_softcap: float = 0.0        # gemma2-style logit soft capping
    final_softcap: float = 0.0
    attn_chunk: int = 512            # kv chunk of the plain attention (CPU tensors)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # expert hidden size (0 -> d_ff)
    router_aux_coef: float = 0.01

    # SSM (mamba)
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model / 16)

    # encoder (enc-dec families)
    n_enc_layers: int = 0
    enc_seq: int = 0

    # VLM frontend stub
    n_image_tokens: int = 0

    # norms / activations
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_f32: bool = True
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    scale_embed: bool = False        # gemma2: embeddings scaled by sqrt(d_model)
    abs_pos: bool = False

    long_context_window: int = 0

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")

    @property
    def n_repeat(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count."""
        from repro_torch.models.schema import count_params
        return count_params(self)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/pattern, tiny dims."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, 2))
        while n_heads % n_kv:
            n_kv -= 1
        pattern = self.pattern[: max(1, min(2, len(self.pattern)))]
        # keep one of each distinct mixer so smoke covers every block type
        mixers = []
        seen = set()
        for blk in self.pattern:
            if blk[0] not in seen:
                seen.add(blk[0])
                mixers.append(blk)
        pattern = tuple(mixers[:4]) or pattern
        return dataclasses.replace(
            self,
            n_layers=len(pattern),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            moe_d_ff=min(self.expert_d_ff, 256) if self.n_experts else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            pattern=pattern,
            n_enc_layers=min(self.n_enc_layers, 1),
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            n_image_tokens=min(self.n_image_tokens, 8),
            window=min(self.window, 8) if self.window else 0,
            long_context_window=min(self.long_context_window, 8)
            if self.long_context_window else 0,
            attn_chunk=8,
            ssm_d_state=min(self.ssm_d_state, 8),
            ssm_dt_rank=8,
            dtype="float32",
        )


@dataclass(frozen=True)
class TrainConfig:
    """The reference's ``TrainConfig`` without ``microbatch`` and
    ``zero_sharded_opt`` (gradient accumulation and ZeRO specs are not
    ported: the port trains on one card)."""
    learning_rate: float = 3e-4
    optimizer: str = "rmsprop"       # rmsprop (paper: non-centered) | adamw
    rmsprop_decay: float = 0.99
    rmsprop_eps: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 0
    seed: int = 0
    remat: str = "none"              # none | full | dots
    loss_chunk: int = 1024           # sequence chunking for vocab xent
