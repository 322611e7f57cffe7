"""Where the port's bf16 rounding parts from the reference's (ROADMAP C.2):
one reduced gemma3-1b layer in bf16, op by op.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/c2_bisect.py \\
        [--arch gemma3-1b] [--mixer attn|attn_local] [--flash]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/c2_bisect.py --model \\
        [--arch gemma3-1b]

The layer is cut into its ops: the first RMSNorm, the q/k/v projections,
RoPE, the attention, the out projection, the first residual, the second
RMSNorm, the gate and up projections, the SwiGLU epilogue (silu in f32,
rounded to bf16, times up), the down projection, the second residual.
For each op it prints three readings, each as the share of elements that
differ and the largest difference over the reference's largest
magnitude:

* ``op``: the op alone, the port's eager op against the reference's op
  under ``jax.jit``, both fed the reference's inputs to that op;
* ``fused``: the reference's layer jitted up to and including that op
  (XLA fuses across the op boundaries) against the reference's ops
  chained one jit at a time, from the same layer input;
* ``chain``: the port's eager ops chained from the same layer input
  against the reference's layer jitted up to that op (what the model
  tests compare, op by op).

The first op whose ``op`` reading is not 0 rounds differently on its own;
the first whose ``fused`` reading is not 0 is where XLA's fusion changes
the rounding.  Both packages run on the CPU, the reference's weights
carried over to the port.

``--model`` prints instead the whole reduced model's reading, as
``tests/test_torch_attention.py::test_prefill_and_decode_match_jax_bfloat16``
takes it (prefill and teacher-forced decode steps at the full reduced
depth, the flash and the chunked prefill): the largest difference of the
logits and of the cache leaves over max(1, max |reference|).
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.reduced import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax


def _ops(cfg, ctx, kind, lib):
    """The layer's ops for one package: (name, fn(state, p) -> state),
    ``state`` a dict of the named intermediates."""
    R = lib

    def norm1(s, p):
        return {**s, "h": R["rmsnorm"](s["x"], p["norm1"])}

    def proj(s, p):
        q, k, v = R["qkv"](p["mixer"], s["h"], cfg)
        return {**s, "q": q, "k": k, "v": v}

    def rope(s, p):
        B, Tn = s["x"].shape[:2]
        pos = R["positions"](B, Tn)
        return {**s, "q": R["rope"](s["q"], pos, cfg.rope_theta),
                "k": R["rope"](s["k"], pos, cfg.rope_theta)}

    def attend(s, p):
        return {**s, "o": R["attend"](s["q"], s["k"], s["v"], kind=kind,
                                      cfg=cfg, ctx=ctx)}

    def out(s, p):
        return {**s, "y": R["out_proj"](p["mixer"], s["o"])}

    def resid1(s, p):
        return {**s, "x1": s["x"] + s["y"]}

    def norm2(s, p):
        return {**s, "h2": R["rmsnorm"](s["x1"], p["norm2"])}

    def gate_up(s, p):
        return {**s, "g": R["mm"](s["h2"], p["mlp"]["wi_gate"]),
                "u": R["mm"](s["h2"], p["mlp"]["wi_up"])}

    def swiglu(s, p):
        return {**s, "a": R["swiglu"](s["g"], s["u"])}

    def down(s, p):
        return {**s, "m": R["mm"](s["a"], p["mlp"]["wo"])}

    def resid2(s, p):
        return {**s, "x2": s["x1"] + s["m"]}

    return [("norm1", norm1, ("h",)), ("qkv", proj, ("q", "k", "v")),
            ("rope", rope, ("q", "k")), ("attention", attend, ("o",)),
            ("out_proj", out, ("y",)), ("residual1", resid1, ("x1",)),
            ("norm2", norm2, ("h2",)), ("gate/up", gate_up, ("g", "u")),
            ("swiglu", swiglu, ("a",)), ("down", down, ("m",)),
            ("residual2", resid2, ("x2",))]


JAX_LIB = {
    "rmsnorm": JL.rmsnorm,
    "qkv": JA.qkv,
    "positions": lambda B, Tn: jnp.arange(Tn)[None, :].repeat(B, 0),
    "rope": JL.apply_rope,
    "attend": JA._mix_attend,
    "out_proj": JA.out_proj,
    "mm": lambda x, w: jnp.einsum("btd,df->btf", x, w),
    "swiglu": lambda g, u: jax.nn.silu(g.astype(jnp.float32)).astype(
        u.dtype) * u,
}

TORCH_LIB = {
    "rmsnorm": L.rmsnorm,
    "qkv": A.qkv,
    "positions": lambda B, Tn: torch.arange(Tn)[None, :].expand(B, Tn),
    "rope": L.apply_rope,
    "attend": A._mix_attend,
    "out_proj": A.out_proj,
    "mm": lambda x, w: x @ w,
    "swiglu": lambda g, u: torch.nn.functional.silu(g.float()).to(
        u.dtype) * u,
}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def reading(got, want) -> str:
    """'share differing, max |d| / max |want|' of two tensors."""
    g, w = _np(got), _np(want)
    diff = np.abs(g - w)
    return (f"{(diff > 0).mean():.3f} differ, max "
            f"{diff.max() / max(np.abs(w).max(), 1e-30):.2e}")


def model_readings(arch: str) -> None:
    """The reduced model's bf16 readings against the reference."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tests"))
    from test_torch_attention import _decode_both
    from repro_torch.core.regions import disable_compile

    def rel(g, w):
        g, w = _np(g), _np(w)
        return np.abs(g - w).max() / max(1.0, np.abs(w).max())
    with disable_compile():
        for kw in ({}, {"flash": False}):
            logits, _, jc, tc = _decode_both(arch, "bfloat16", kw,
                                             teacher_forced=True)
            lg = max(rel(g, w) for w, g in logits)
            leaves = max(rel(t[k], j[k]) for j, t in zip(jc, tc)
                         for k in j if k != "pos")
            print(f"[c2] {arch} bf16, flash {kw.get('flash', True)}: logits "
                  f"{lg:.4f}, cache leaves {leaves:.4f} of max(1, max|ref|)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", action="store_true")
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--mixer", default="attn", choices=("attn", "attn_local"))
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=24)
    args = ap.parse_args(argv)
    if args.model:
        model_readings(args.arch)
        return
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(j_reduced(j_get_config(args.arch)), **bf)
    cfg = dataclasses.replace(reduced(get_config(args.arch)), **bf)
    jp_all = JT.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp_all), cfg, "cpu")
    layer = [m for m, _ in T.layer_kinds(cfg)].index(args.mixer)
    tp = params["layers"][layer]
    jp = jax.tree.map(jnp.asarray, T.layers_of(cfg, jax.tree.map(
        np.asarray, jp_all))[layer])
    x = np.random.RandomState(0).randn(args.batch, args.seq,
                                       cfg.d_model).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    jctx = JT.Ctx(mode="prefill", flash=args.flash, q_chunk=8)
    tctx = T.Ctx(mode="prefill", flash=args.flash, q_chunk=8)
    jops = _ops(jcfg, jctx, args.mixer, JAX_LIB)
    tops = _ops(cfg, tctx, args.mixer, TORCH_LIB)

    def to_torch(state):
        return {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
            torch.bfloat16) if v.dtype == jnp.bfloat16 else
            torch.from_numpy(np.asarray(v)) for k, v in state.items()}

    print(f"[c2] {cfg.name} layer {layer} ({args.mixer}), bf16, "
          f"{args.batch}x{args.seq} tokens, flash {args.flash}: share of "
          f"elements that differ, max |d| / max |reference|")
    j_chain = {"x": jx}
    t_chain = {"x": tx}
    for n, ((name, jf, outs), (_, tf, _)) in enumerate(zip(jops, tops)):
        j_in = j_chain
        j_chain = jax.jit(lambda s, p, f=jf: f(s, p))(j_in, jp)
        t_alone = tf(to_torch(j_in), tp)

        def prefix(s, p, n=n):
            for _, f, _ in jops[:n + 1]:
                s = f(s, p)
            return s
        j_fused = jax.jit(prefix)({"x": jx}, jp)
        t_chain = tf(t_chain, tp)
        for o in outs:
            print(f"[c2] {name:10s} {o:3s} op: "
                  f"{reading(t_alone[o], j_chain[o])}; fused: "
                  f"{reading(j_fused[o], j_chain[o])}; chain: "
                  f"{reading(t_chain[o], j_fused[o])}")


if __name__ == "__main__":
    main()
