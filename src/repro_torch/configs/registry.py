"""Registry of the architectures the port runs.

Each ``repro_torch/configs/<id>.py`` exposes ``CONFIG``; ``--arch <id>``
resolves through :func:`get_config`.  Only archs whose mixers the port
runs are here (``rwkv6-7b``; ``tinyllama-1.1b``, ``llama3.2-3b`` and
``qwen2.5-32b``, global attention, the last with a QKV bias;
``gemma3-1b``, local and global attention); every other arch of the JAX
package raises ``NotImplementedError`` until its mixers are ported
(ROADMAP A.5).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCH_IDS = ("rwkv6_7b", "tinyllama_1_1b", "llama3_2_3b", "gemma3_1b",
            "qwen2_5_32b")

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP A.5: its mixers wait); "
            f"the port runs: {', '.join(a.replace('_', '-') for a in ARCH_IDS)}")
    if key not in _cache:
        _cache[key] = importlib.import_module(
            f"repro_torch.configs.{key}").CONFIG
    return _cache[key]
