"""Reduced configs: same family, pattern and structure at smoke-test scale
(a copy of ``repro.configs.reduced``): the layer cycle with its remainder,
GQA ratio, MoE routing, enc-dec structure, M-RoPE sections, tying and
biases are kept; widths, depth and vocabulary shrink."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig


def reduced(cfg: ModelConfig, *, d_model: int = 64, head_dim: int = 16,
            vocab: int = 512, d_ff: int = 128, max_cycles: int = 2) -> ModelConfig:
    cyc = len(cfg.layer_cycle)
    rem = cfg.n_layers % cyc
    n_layers = min(cfg.n_layers, max_cycles * cyc + rem)
    n_heads = max(2, min(4, cfg.n_heads))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // ratio)
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            n_experts=min(8, cfg.moe.n_experts),
            top_k=min(cfg.moe.top_k, min(8, cfg.moe.n_experts)),
            d_ff=min(64, cfg.moe.d_ff),
            shared_expert_ff=64 if cfg.moe.shared_expert_ff else 0,
            capacity_factor=2.0,
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_ff,
        vocab=vocab,
        window=min(cfg.window, 16) if cfg.window else 0,
        moe=moe,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_len=min(cfg.enc_len, 16) if cfg.n_enc_layers else cfg.enc_len,
        rnn_width=d_model if cfg.rnn_width else 0,
    )
