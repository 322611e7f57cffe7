"""Plain PyTorch versions of the RWKV6 scan (K5): the sequential
recurrence (the oracle, and what the wrapper runs on CPU tensors) and the
chunked closed form, both from a given or a zero state."""
from __future__ import annotations

import torch

from repro_torch.models.rwkv6 import rwkv_chunk, rwkv_ref_scan


def _zero_state(r):
    B, _, H, hd = r.shape
    return torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)


def rwkv6_scan(r, k, v, logw, u, S_in=None):
    """r,k,v,logw [B,T,H,hd]; u [H,hd]; S_in [B,H,hd,hd] or None (zero).
    Returns (out [B,T,H,hd] f32, S_final [B,H,hd,hd] f32)."""
    return rwkv_ref_scan(r, k, v, logw, u,
                         _zero_state(r) if S_in is None else S_in)


def rwkv6_chunked(r, k, v, logw, u, chunk: int = 64, S_in=None):
    return rwkv_chunk(r, k, v, logw, u,
                      _zero_state(r) if S_in is None else S_in, chunk)
