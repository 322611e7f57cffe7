"""Configuration schema of the port's LM stack.

A copy of the JAX package's ``repro.configs.base`` (plain dataclasses):
every architecture is a declarative :class:`ModelConfig` that
``repro_torch.models.transformer`` turns into a layer program.  Layer
kinds are those of the reference (``attn``, ``attn_local``, ``attn_enc``,
``attn_xdec``, ``rglru``, ``rwkv``); the port runs ``rwkv``, ``attn``,
``attn_local`` and ``rglru``, with the dense, channel-mix or MoE MLP, so
far (``attn_enc`` and ``attn_xdec``: ROADMAP A.5.7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden size
    shared_expert_ff: int = 0     # 0 = no shared expert
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MemoryPolicy:
    """The paper's unified-memory policy (C1/C4) applied to the LM stack.

    ``offload_optimizer``: place AdamW moments in pinned host memory.
    ``offload_kv_spill``: serve-time KV pages beyond ``kv_hot_window`` may be
    placed in host memory.  ``pool_min_elems``: pooling threshold (paper: 5K
    elements).  ``target_cutoff``: the paper's TARGET_CUT_OFF.
    """
    offload_optimizer: bool = False
    offload_kv_spill: bool = False
    kv_hot_window: int = 8192
    pool_min_elems: int = 5120
    target_cutoff: int = 16384


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default: d_model // n_heads
    # cycle of mixer kinds, tiled (and truncated) to n_layers
    layer_cycle: Tuple[str, ...] = ("attn",)
    window: int = 0                       # sliding window for attn_local
    moe: Optional[MoEConfig] = None
    moe_every: int = 1                    # MoE mlp where i % moe_every == moe_offset
    moe_offset: int = 0
    tie_embeddings: bool = True
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_enc_layers: int = 0                 # >0 => encoder-decoder
    enc_len: int = 1500
    rnn_width: int = 0                    # RG-LRU recurrence width (0 = d_model)
    conv_width: int = 4
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    memory: MemoryPolicy = dataclasses.field(default_factory=MemoryPolicy)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.layer_cycle))
        return tuple((self.layer_cycle * reps)[: self.n_layers])
