"""RecurrentGemma 9B — RG-LRU + local attention, pattern (rec, rec, attn) [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    layer_cycle=("rglru", "rglru", "attn_local"), window=2048,
    rnn_width=4096, conv_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427 (Griffin); hf:google/recurrentgemma-9b",
)
