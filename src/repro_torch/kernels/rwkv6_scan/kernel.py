"""Wrapper of the hand-written CUDA RWKV6 scan (``csrc/rwkv6_scan.cu``, K5).

Replaces ``src/repro/kernels/rwkv6_scan/kernel.py:71`` of the JAX package.
Its products run on the tensor cores in 3xTF32 (``ref.rwkv6_subchunk`` is
the plain twin of that arithmetic); see the note in the CUDA source for
the design.  Unlike the TPU kernel it starts from
the caller's state ``S_in`` (zero when not given), so the ``hopper``
variant of ``RWKV6_SCAN`` needs no superposition pass afterwards.

The wrapper keeps the reference's ``[B,T,H,hd]`` layout (the kernel
strides through it; no copy is made), checks device, dtype, shape and
contiguity and raises on anything else.  Given CPU tensors it runs the
plain version (``ref.py``); given CUDA tensors it launches the kernel on
the current stream without synchronising, or raises.  ``LAUNCHES`` counts
kernel launches only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_scan import ref

#: largest head dim the kernel takes (its shared-memory tiles are 64 wide)
MAX_HD = 64

#: kernel launches (plain-version calls are not counted)
LAUNCHES = {"rwkv6_scan": 0}

_ENTRY = {torch.float32: "rwkv6_scan_f32", torch.bfloat16: "rwkv6_scan_bf16"}


def _check(r, k, v, logw, u, S_in):
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be [B,T,H,hd], got {tuple(r.shape)}")
    B, T, H, hd = r.shape
    if r.dtype not in _ENTRY:
        raise TypeError(f"rwkv6_scan: r/k/v must be float32 or bfloat16, "
                        f"got {r.dtype}")
    expect = {"k": (k, r.shape, r.dtype), "v": (v, r.shape, r.dtype),
              "logw": (logw, r.shape, torch.float32),
              "u": (u, (H, hd), torch.float32)}
    if S_in is not None:
        expect["S_in"] = (S_in, (B, H, hd, hd), torch.float32)
    for name, (t, shape, dtype) in expect.items():
        if t.shape != shape:
            raise ValueError(f"rwkv6_scan: {name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"rwkv6_scan: {name} must be {dtype}, got {t.dtype}")
    for t in (r, *(t for t, _, _ in expect.values())):
        if t.device != r.device:
            raise ValueError(f"rwkv6_scan: operands on {t.device} and {r.device}")
        if not t.is_contiguous():
            raise ValueError("rwkv6_scan: operands must be contiguous")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if r.device.type == "cuda" and not 1 <= hd <= MAX_HD:
        raise ValueError(f"rwkv6_scan: the kernel takes 1 <= hd <= {MAX_HD}, "
                         f"got {hd}")


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=(),
                         device_types="cuda")
def rwkv6_scan_op(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                  S_in: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    B, T, H, hd = r.shape
    if S_in is None:
        S_in = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=r.device)
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    S_out = torch.empty_like(S_in)
    build.launch(_ENTRY[r.dtype], (r, k, v, logw, u, S_in, out, S_out),
                 (B, T, H, hd))
    LAUNCHES["rwkv6_scan"] += 1
    return out, S_out


@rwkv6_scan_op.register_kernel("cpu")
def _rwkv6_scan_plain(r, k, v, logw, u, S_in):
    return ref.rwkv6_scan(r, k, v, logw, u, S_in)


@rwkv6_scan_op.register_fake
def _rwkv6_scan_fake(r, k, v, logw, u, S_in):
    B, T, H, hd = r.shape
    return (r.new_empty(r.shape, dtype=torch.float32),
            r.new_empty((B, H, hd, hd), dtype=torch.float32))


@rwkv6_scan_op.register_vmap
def _rwkv6_scan_vmap(info, in_dims, r, k, v, logw, u, S_in):
    """The vmap axis folds into B, which is exact (the batch rows of the
    scan are independent); a batched ``u`` takes one call per vmap row."""
    n = info.batch_size
    if in_dims[4] is not None:
        outs = [rwkv6_scan_op(*(t if d is None or t is None else t.select(d, i)
                                for t, d in zip((r, k, v, logw, u, S_in),
                                                in_dims)))
                for i in range(n)]
        return (torch.stack([o for o, _ in outs]),
                torch.stack([s for _, s in outs])), (0, 0)

    def fold(t, d):
        if t is None:
            return None
        t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
        return t.reshape(-1, *t.shape[2:]).contiguous()

    r_, k_, v_, lw_ = (fold(t, d) for t, d in zip((r, k, v, logw), in_dims))
    out, S = rwkv6_scan_op(r_, k_, v_, lw_, u, fold(S_in, in_dims[5]))
    return (out.reshape(n, -1, *out.shape[1:]),
            S.reshape(n, -1, *S.shape[1:])), (0, 0)


def rwkv6_scan(r, k, v, logw, u, S_in=None):
    """r,k,v [B,T,H,hd] (float32 or bfloat16); logw [B,T,H,hd] f32; u [H,hd]
    f32; S_in [B,H,hd,hd] f32 or None (zero state).  Returns (out [B,T,H,hd]
    f32, S_final [B,H,hd,hd] f32)."""
    _check(r, k, v, logw, u, S_in)
    return rwkv6_scan_op(r, k, v, logw, u, S_in)
