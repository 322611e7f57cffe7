"""Llama 4 Scout 17B-active / 16 experts — MoE top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    layer_cycle=("attn",), rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, shared_expert_ff=8192),
    moe_every=1, tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
