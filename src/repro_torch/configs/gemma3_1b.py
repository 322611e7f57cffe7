"""Gemma 3 1B — 5:1 local:global attention, 262k vocab [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    layer_cycle=("attn_local",) * 5 + ("attn",), window=512,
    rope_theta=1e6, tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
