"""RWKV6 "Finch" 7B — attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    layer_cycle=("rwkv",),
    tie_embeddings=False,
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b",
)
