"""RecurrentGemma / Griffin recurrent block of the port: temporal conv +
RG-LRU (counterpart of ``repro.models.rglru``).

RG-LRU recurrence (Griffin, arXiv:2402.19427):

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(L) * r_t)      c = 8, L learned (per channel)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is: y = W_out( GeLU(W_gate u) * RGLRU(conv1d(W_in u)) ).
Training and prefill run the recurrence as a log-depth scan over the
sequence (:func:`linear_scan`: doubling steps of the associative
``(a, b) o (a', b') = (a a', a' b + b')``, ceil(log2(T + 1)) elementwise
steps that Inductor fuses, where a Python loop over ``T`` would launch
per token); the reference runs ``jax.lax.associative_scan``, whose
odd/even tree rounds differently in f32.  Decode is one step carrying
the (h, conv window) state.  The gates and the recurrence are in f32,
the conv state in the compute dtype.

Plain torch throughout: the reference has no Pallas kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec

RG_C = 8.0


def rglru_specs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.rnn_width or d
    pd = cfg.param_dtype
    return {
        "w_in": ParamSpec((d, w), ("embed", "rnn"), pd),
        "w_gate": ParamSpec((d, w), ("embed", "rnn"), pd),
        "conv_w": ParamSpec((cfg.conv_width, w), (None, "rnn"), "float32",
                            "normal", 0.3),
        "conv_b": ParamSpec((w,), ("rnn",), "float32", "zeros"),
        "wa": ParamSpec((w, w), ("rnn", "rnn2"), pd),
        "wx": ParamSpec((w, w), ("rnn", "rnn2"), pd),
        "ba": ParamSpec((w,), ("rnn",), "float32", "zeros"),
        "bx": ParamSpec((w,), ("rnn",), "float32", "zeros"),
        "lam": ParamSpec((w,), ("rnn",), "float32", "normal", 1.0),
        "w_out": ParamSpec((w, d), ("rnn", "embed"), pd),
    }


def rglru_state_specs(cfg, batch: int) -> dict:
    w = cfg.rnn_width or cfg.d_model
    return {
        "h": ParamSpec((batch, w), ("batch", "rnn"), "float32", "zeros"),
        "conv": ParamSpec((batch, cfg.conv_width - 1, w), ("batch", None, "rnn"),
                          cfg.compute_dtype, "zeros"),
    }


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gelu(x):
    """``jax.nn.gelu`` (its default: the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def _gates(p, xc):
    """xc [B,T,w] (post-conv) -> (log_a, beta*ix) in fp32."""
    xf = xc.float()
    r = torch.sigmoid((xc @ p["wa"]).float() + p["ba"])
    i = torch.sigmoid((xc @ p["wx"]).float() + p["bx"])
    log_a = -RG_C * _softplus(p["lam"]) * r                 # <= 0
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12))
    return log_a, beta * (i * xf)


def _conv1d(p, x, conv_state):
    """Causal depthwise temporal conv, width K. x [B,T,w]; f32 sums over
    the taps in the reference's order; the new conv state (the last K-1
    inputs) in ``x``'s dtype."""
    K = p["conv_w"].shape[0]
    xpad = torch.cat([conv_state.to(x.dtype), x], dim=1)    # [B,T+K-1,w]
    T = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(K):
        out = out + xpad[:, j:j + T].float() * p["conv_w"][j]
    out = out + p["conv_b"]
    # a tensor of its own, not a view of xpad (a layer op's outputs have
    # the strides of fresh tensors)
    new_state = xpad[:, -(K - 1):].contiguous() if K > 1 else conv_state
    return out.to(x.dtype), new_state


def linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 1 with
    ``h_{-1} = 0`` (fold an initial state in as a leading element ``a =
    1, b = h0``): doubling steps of ``(a, b) o (a', b') = (a a', a' b +
    b')``, each an elementwise op over the whole sequence.  The elements
    with no partner ``s`` back take the identity ``(1, 0)``, which leaves
    them exactly as they are."""
    L = a.shape[1]
    s = 1
    while s < L:
        a_prev = F.pad(a[:, :L - s], (0, 0, s, 0), value=1.0)
        b_prev = F.pad(b[:, :L - s], (0, 0, s, 0), value=0.0)
        b = a * b_prev + b
        a = a * a_prev
        s *= 2
    return a, b


def rglru_train(p, x, cfg, *, ctx, state=None):
    """x [B,T,d] -> (y [B,T,d], new_state)."""
    shd = ctx.shd
    B, T, d = x.shape
    w = cfg.rnn_width or d
    u = shd(x @ p["w_in"], "batch", None, "rnn")
    gate = x @ p["w_gate"]
    if state is None:
        conv_state = torch.zeros((B, cfg.conv_width - 1, w), dtype=x.dtype,
                                 device=x.device)
        h0 = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    else:
        conv_state, h0 = state["conv"], state["h"]
    xc, new_conv = _conv1d(p, u, conv_state)
    log_a, b = _gates(p, xc)
    # h_t = a_t h_{t-1} + b_t, with h_0 folded in as an extra leading element
    a_seq = torch.exp(log_a)
    a_all = torch.cat([torch.ones((B, 1, w), dtype=a_seq.dtype,
                                  device=x.device), a_seq], dim=1)
    b_all = torch.cat([h0[:, None].float(), b], dim=1)
    _, hh = linear_scan(a_all, b_all)
    h = hh[:, 1:]                                            # [B,T,w]
    y = h.to(x.dtype) * _gelu(gate.float()).to(x.dtype)
    y = shd(y @ p["w_out"], "batch", None, None)
    return y, {"h": hh[:, -1], "conv": new_conv}


def rglru_decode(p, x1, cfg, *, ctx, state):
    """Single token step. x1 [B,1,d]."""
    u = x1 @ p["w_in"]
    gate = x1 @ p["w_gate"]
    xc, new_conv = _conv1d(p, u, state["conv"])
    log_a, b = _gates(p, xc)
    h = torch.exp(log_a[:, 0]) * state["h"] + b[:, 0]
    y = h[:, None].to(x1.dtype) * _gelu(gate.float()).to(x1.dtype)
    y = y @ p["w_out"]
    return y, {"h": h, "conv": new_conv}


def rglru_ref(p, x, cfg, state=None):
    """Sequential oracle for tests."""
    B, T, d = x.shape
    w = cfg.rnn_width or d
    u = x @ p["w_in"]
    gate = x @ p["w_gate"]
    conv_state = (state["conv"] if state is not None
                  else torch.zeros((B, cfg.conv_width - 1, w), dtype=x.dtype,
                                   device=x.device))
    h = state["h"] if state is not None else \
        torch.zeros((B, w), dtype=torch.float32, device=x.device)
    xc, _ = _conv1d(p, u, conv_state)
    log_a, b = _gates(p, xc)
    outs = []
    for t in range(T):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        outs.append(h)
    hs = torch.stack(outs, dim=1)
    y = hs.to(x.dtype) * _gelu(gate.float()).to(x.dtype)
    return y @ p["w_out"]
