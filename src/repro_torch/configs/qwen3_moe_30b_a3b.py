"""Qwen3 MoE 30B-A3B — 128 experts, top-8, fine-grained d_ff=768 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    layer_cycle=("attn",), rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
    moe_every=1, tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
