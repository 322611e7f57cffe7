"""Registry of the architectures the port runs.

Each ``repro_torch/configs/<id>.py`` exposes ``CONFIG``; ``--arch <id>``
resolves through :func:`get_config`.  Only archs whose mixers the port
runs are here (``rwkv6-7b``; ``tinyllama-1.1b``, ``llama3.2-3b`` and
``qwen2.5-32b``, global attention, the last with a QKV bias;
``gemma3-1b``, local and global attention; ``recurrentgemma-9b``, RG-LRU
and local attention; ``qwen3-moe-30b-a3b`` and ``llama4-scout-17b-a16e``,
attention with the MoE MLP).  The two other archs of the JAX package raise
``NotImplementedError`` naming the ROADMAP item that ports them
(:data:`WAITING`).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ("rwkv6_7b", "tinyllama_1_1b", "llama3_2_3b", "gemma3_1b",
            "qwen2_5_32b", "recurrentgemma_9b", "qwen3_moe_30b_a3b",
            "llama4_scout_17b_a16e")

#: archs of the JAX package not ported yet: the ROADMAP item and what waits
WAITING = {
    "qwen2_vl_72b": ("A.5.6", "M-RoPE"),
    "whisper_large_v3": ("A.5.7", "the encoder and cross-attention"),
}

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        item, what = WAITING.get(key, ("A.5", "its mixers"))
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP {item}: {what} "
            f"wait); the port runs: "
            f"{', '.join(a.replace('_', '-') for a in ARCH_IDS)}")
    if key not in _cache:
        _cache[key] = importlib.import_module(
            f"repro_torch.configs.{key}").CONFIG
    return _cache[key]
