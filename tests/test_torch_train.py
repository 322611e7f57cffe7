"""Training in the port (``repro_torch.train``, ``optim``, ``data``,
``checkpoint``, ``runtime``, ``launch.train``) against the JAX package.

The same inputs, made from a seed with numpy (or the reference's own
initialiser, converted), go through the reference and the port.  The
reference runs under a plain ``repro.models.transformer.Ctx(mode="train")``
(its ``make_sharder`` fails on this jax, ROADMAP "Reference limits").
Everything runs on the CPU at reduced sizes in float32 unless stated,
regions and layers eagerly (``disable_compile``; the compiled train step
against the eager one is a card test in tests/test_torch_gpu.py).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs.reduced import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.data.pipeline import MemmapTokens as JMemmapTokens
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import transformer as JT
from repro.models.flash import get_flash as j_get_flash
from repro.optim import adamw as JO
from repro.train import step as JS
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.regions import Executor, disable_compile
from repro_torch.data.pipeline import MemmapTokens, SyntheticTokens
from repro_torch.launch import train as LT
from repro_torch.launch.policy import POLICY_CHOICES, lm_policy
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.flash import FlashAttention
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultInjector, TrainSupervisor
from repro_torch.train import step as S

ARCHS = ("tinyllama-1.1b", "gemma3-1b", "qwen2.5-32b", "rwkv6-7b")
F32 = dict(param_dtype="float32", compute_dtype="float32")
BATCH, SEQ = 2, 32


@pytest.fixture(autouse=True)
def _eager():
    with disable_compile():
        yield


def _configs(arch, **over):
    """Reduced configs of both packages in f32; gemma3-1b at one layer
    cycle (5 local layers and a global one)."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **F32, **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), **F32, **over)
    if arch == "gemma3-1b":
        n = len(cfg.layer_cycle)
        jcfg, cfg = (dataclasses.replace(c, n_layers=n) for c in (jcfg, cfg))
    return jcfg, cfg


def _params(jcfg, cfg, seed=0):
    jp = JT.init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _tokens(cfg, seed=0):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)


def _as_port(jtree, cfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), cfg, "cpu")


def _tree_err(got, want):
    """max |got - want| over all leaves, over the largest magnitude of
    ``want`` (the whole tree's)."""
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    scale = max(x.abs().max().item() for x in w)
    return max((a - b).abs().max().item() for a, b in zip(g, w)) / scale


def _leaf_errs(got, want):
    """Each leaf's max |got - want| over its own largest magnitude."""
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    return [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            for a, b in zip(g, w)]


def _leaf_rel(got, want):
    """The worst leaf's max |got - want| over its own largest magnitude."""
    return max(_leaf_errs(got, want))


# ---------------------------------------------------------------------------
# The flash VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,chunk,T,hq,hkv", [
    (True, 0, 8, 24, 4, 2),       # causal, GQA, chunks of 8
    (True, 0, 8, 20, 4, 4),       # ragged: T=20 runs in chunks of 5
    (True, 6, 8, 20, 4, 1),       # sliding window, one kv head
    (False, 0, 16, 16, 2, 2),     # bidirectional
])
def test_flash_vjp_matches_jax_custom_vjp(causal, window, chunk, T, hq, hkv):
    """Output and (dq, dk, dv) of ``FlashAttention`` against ``jax.vjp``
    of the reference's ``make_flash_attention``: within 1e-5 of the
    largest magnitude (f32)."""
    rng = np.random.RandomState(T + hq + window)
    q, k, v = (rng.randn(2, T, h, 16).astype(np.float32)
               for h in (hq, hkv, hkv))
    do = rng.randn(2, T, hq, 16).astype(np.float32)
    jo, pull = jax.vjp(j_get_flash(causal, window, chunk), *map(
        jnp.asarray, (q, k, v)))
    jgrads = pull(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FlashAttention.apply(tq, tk, tv, causal, window, chunk)[0]
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    want = [torch.from_numpy(np.asarray(a)) for a in (jo, *jgrads)]
    assert _tree_err([o.detach(), *grads], want) <= 1e-5
    for g, w in zip(grads, want[1:]):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


# ---------------------------------------------------------------------------
# loss_fn and its gradients; the train step
# ---------------------------------------------------------------------------

def _reference_grads_f64(jcfg, cfg, jp, toks):
    """The reference's gradient of the same loss in float64
    (``jax.enable_x64``), as a port tree of float64 leaves."""
    with jax.enable_x64(True):
        j64 = dataclasses.replace(jcfg, param_dtype="float64",
                                  compute_dtype="float64")
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a),
                                                  jnp.float64), jp)
        _, g = jax.value_and_grad(JS.loss_fn, has_aux=True)(
            jp64, {"tokens": jnp.asarray(toks)}, j64,
            JT.Ctx(mode="train"))
        g = jax.tree.map(lambda a: np.asarray(a, np.float64), g)
    return params_from_jax(g, dataclasses.replace(cfg, param_dtype="float64"),
                           "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """``value_and_grad`` (remat on: each layer a ``TrainLayer``) against
    ``jax.value_and_grad(repro.train.step.loss_fn)``: the loss within 1e-5
    relative, every gradient leaf within 1e-4 of its own largest
    magnitude.  The gradients are held to the reference's float64
    gradient (``jax.enable_x64``), the exact one up to its f32 RMSNorms:
    both f32 stacks round, and on some leaves of qwen2.5-32b the
    reference's f32 gradient is further from it than the port's.  The
    reference's rwkv6 scan carries f32 whatever the dtype, so rwkv6-7b is
    held to its f32 gradient.  For gemma3-1b (at these random f32 weights
    its loss is ~26 and the softmax steep) a leaf's bound is the larger of
    1e-4 and 4 times the reference's own f32 distance to its f64 gradient
    on that leaf: those distances reach 1.8e-4, and the port's 3.4e-4."""
    jcfg, cfg = _configs(arch)
    jp, params = _params(jcfg, cfg)
    toks = _tokens(cfg)
    (jl, (jce, _)), jg = jax.value_and_grad(JS.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, JT.Ctx(mode="train"))
    (loss, (ce, aux)), grads = S.value_and_grad(
        params, {"tokens": torch.from_numpy(toks)}, cfg, T.Ctx(mode="train"))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(ce) - float(jce)) <= 1e-5 * abs(float(jce))
    assert float(aux) == 0.0

    def f64(tree):
        return pytree.tree_map(lambda t: t.double(), tree)
    if arch == "rwkv6-7b":
        want = f64(_as_port(jg, cfg))
    else:
        want = _reference_grads_f64(jcfg, cfg, jp, toks)
    errs = _leaf_errs(f64(grads), want)
    bounds = [1e-4] * len(errs)
    if arch == "gemma3-1b":
        spread = _leaf_errs(f64(_as_port(jg, cfg)), want)
        assert max(spread) > 1e-4       # else this arch needs no exception
        bounds = [max(1e-4, 4 * s) for s in spread]
    names = [pytree.keystr(k) for k, _ in
             pytree.tree_flatten_with_path(grads)[0]]
    bad = [(n, e, b) for n, e, b in zip(names, errs, bounds) if e > b]
    assert not bad, bad


def test_remat_on_equals_remat_off():
    """The rematerialised layers (forward without activations, VJP that
    recomputes) give the gradients of plain autograd through the layers:
    within 1e-6 relative (bit for bit on the CPU)."""
    jcfg, cfg = _configs("gemma3-1b")
    _, params = _params(jcfg, cfg)
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    (l1, _), g1 = S.value_and_grad(params, batch, cfg, T.Ctx(remat=True))
    (l0, _), g0 = S.value_and_grad(params, batch, cfg, T.Ctx(remat=False))
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    assert _leaf_rel(g1, g0) <= 1e-6


def _synthetic_batches(cfg, n):
    src = JSyntheticTokens(cfg.vocab, seed=0)
    return [np.array(src.batch_at(s, BATCH, SEQ)) for s in range(n)]


def test_three_train_steps_match_jax():
    """Three steps of ``make_train_step`` (AdamW at its default lr, 3e-4)
    against the reference's, on the same synthetic batches: the losses
    within 1e-5 relative; every parameter within 1e-5 of its leaf's
    largest magnitude, but for at most 0.01 % of the elements, each
    within one step size (lr).  Those are Adam's, not the port's: an
    element whose gradient sits at the f32 noise of the two stacks moves
    by ``lr * sign(g)`` on the first step whatever its size, so a rounding
    that flips the sign moves it by up to 2 lr (3 of 135,488 elements
    here, the worst by 0.67 lr)."""
    jcfg, cfg = _configs("tinyllama-1.1b")
    jp, params = _params(jcfg, cfg)
    jopt_cfg, opt_cfg = JO.AdamWConfig(), adamw.AdamWConfig()
    jstep = jax.jit(JS.make_train_step(jcfg, jopt_cfg,
                                       lambda: JT.Ctx(mode="train")))
    step = S.make_train_step(cfg, opt_cfg)
    jopt, opt = JO.init_state(jp, jopt_cfg), adamw.init_state(params, opt_cfg)
    for toks in _synthetic_batches(cfg, 3):
        jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks)})
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks)})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
    assert int(opt["step"]) == int(jopt["step"]) == 3
    n = over = 0
    for a, b in zip(pytree.tree_leaves(params),
                    pytree.tree_leaves(_as_port(jp, cfg))):
        err = (a - b).abs()
        far = err > 1e-5 * b.abs().max()
        n, over = n + err.numel(), over + int(far.sum())
        assert not far.any() or err[far].max() <= opt_cfg.lr
    assert over <= 1e-4 * n, (over, n)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adam_case(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"a": (8, 4), "b": {"c": (16,), "d": (3, 5)}}
    mk = lambda f: jax.tree.map(                                # noqa: E731
        lambda s: f(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p, g = mk(lambda s: rng.randn(*s)), mk(lambda s: 3 * rng.randn(*s))
    m, v = mk(lambda s: 0.1 * rng.randn(*s)), mk(lambda s: rng.rand(*s))
    return p, g, {"m": m, "v": v, "step": np.int32(4)}


def test_apply_updates_matches_jax():
    p, g, st = _adam_case()
    cfg = adamw.AdamWConfig(lr=1e-2)
    jp, jst, jn = JO.apply_updates(*jax.tree.map(jnp.asarray, (p, g, st)),
                                   JO.AdamWConfig(lr=1e-2))
    tp, tst, tn = adamw.apply_updates(*pytree.tree_map(
        torch.from_numpy, (p, g, {**st, "step": np.asarray(st["step"])})),
        cfg)
    to_t = lambda t: pytree.tree_map(                           # noqa: E731
        lambda a: torch.from_numpy(np.asarray(a)), t)
    assert _leaf_rel(tp, to_t(jp)) <= 1e-6
    assert _leaf_rel([tst["m"], tst["v"]], to_t([jst["m"], jst["v"]])) <= 1e-6
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert int(tst["step"]) == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leafwise_update_is_bit_for_bit_apply_updates(dtype):
    """The ``host`` variant: the same leaves, moments and step, bit for
    bit, on one device."""
    p, g, st = _adam_case(1)

    def conv(t, dt=dtype):
        return pytree.tree_map(lambda a: torch.from_numpy(a).to(dt), t)
    args = (conv(p), conv(g), {"m": conv(st["m"], torch.float32),
                               "v": conv(st["v"], torch.float32),
                               "step": torch.tensor(4, dtype=torch.int32)})
    cfg = adamw.AdamWConfig()
    a = adamw.apply_updates(*args, cfg)
    b = adamw.apply_updates_leafwise(*args, cfg)
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 2)])
def test_synthetic_tokens_equal_the_reference(seed, step):
    got = SyntheticTokens(512, seed=seed).batch_at(step, 3, 17)
    want = JSyntheticTokens(512, seed=seed).batch_at(step, 3, 17)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_memmap_tokens_equal_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.RandomState(0).randint(0, 100, 1000).astype(np.int32).tofile(
        path)
    for step in (0, 5):
        np.testing.assert_array_equal(
            MemmapTokens(str(path), 100).batch_at(step, 2, 9).numpy(),
            np.asarray(JMemmapTokens(str(path), 100).batch_at(step, 2, 9)))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _state():
    g = torch.Generator().manual_seed(0)
    return ({"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
             "layers": [{"b": torch.randn(5, generator=g)}]},
            {"step": torch.tensor(7, dtype=torch.int32)})


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3, async_save=False)
    st = _state()
    ck.save(7, st, extra={"step": 7}, report={"mode": "unified"})
    like = pytree.tree_map(torch.zeros_like, st)
    got, man = ck.restore(like)
    assert man["extra"] == {"step": 7}
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rep = json.loads((tmp_path / "step_0000000007" / "coverage.json")
                     .read_text())
    assert rep == {"mode": "unified"}


def test_checkpoint_keeps_the_last_k_and_async_save_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    st = _state()
    for s in (1, 2, 3, 4):
        ck.save(s, st, extra={"step": s})
    ck.wait()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# The region spine: capture and replay, offload, the supervisor, the CLI
# ---------------------------------------------------------------------------

def _trainer(policy="unified", offload=False):
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), **F32)
    init_fn, capture_fn, ex = LT.build_trainer(
        cfg, lr=1e-3, offload_optimizer=offload, q_chunk=SEQ, seed=0,
        policy=policy, device="cpu")
    src = SyntheticTokens(cfg.vocab, seed=0)

    def batch_fn(step):
        return {"tokens": src.batch_at(step, BATCH, SEQ).clone()}
    return cfg, init_fn, capture_fn, ex, batch_fn


def _replayed(policy, offload=False, n=2):
    cfg, init_fn, capture_fn, ex, batch_fn = _trainer(policy, offload)
    state = init_fn()
    step_fn = capture_fn(state, batch_fn(0))
    losses = []
    for s in range(n):
        state, m = step_fn(state, batch_fn(s))
        losses.append(float(m["loss"]))
    return cfg, state, losses, ex


@pytest.fixture(scope="module")
def direct():
    """Two steps of ``make_train_step`` from the trainer's initial state:
    the oracle of every replay."""
    cfg, init_fn, _, _, batch_fn = _trainer()
    params, opt = init_fn()
    step = S.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3),
                             lambda: T.Ctx(mode="train", q_chunk=SEQ))
    losses = []
    with disable_compile():
        for s in range(2):
            params, opt, m = step(params, opt, batch_fn(s))
            losses.append(float(m["loss"]))
    return (params, opt), losses


@pytest.mark.parametrize("policy", POLICY_CHOICES)
def test_captured_train_program_replays_equal_make_train_step(policy,
                                                              direct):
    """``FWD_BWD`` + ``ADAMW_UPDATE`` captured once and replayed under each
    policy: the losses and the state of ``make_train_step``, bit for
    bit."""
    _, state, losses, ex = _replayed(policy)
    want_state, want_losses = direct
    assert losses == want_losses
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(want_state)):
        assert torch.equal(a.cpu(), b)
    rows = ex.ledger.regions
    # capture runs each region once outside the ledger; replays book
    assert rows["FWD_BWD"].calls == 2 and rows["ADAMW_UPDATE"].calls == 2
    if policy == "discrete":
        assert ex.report()["staging_fraction"] > 0


def test_offload_optimizer_equals_no_offload(direct):
    """The host hints on the AdamW moments change where they live, never
    the math: equal to the reference's non-offloaded step (the reference's
    own offloaded unified run fails on this jax, ROADMAP "Reference
    limits")."""
    cfg, state, losses, ex = _replayed("unified", offload=True)
    want_state, want_losses = direct
    assert losses == want_losses
    for a, b in zip(pytree.tree_leaves(state), pytree.tree_leaves(want_state)):
        assert torch.equal(a.cpu(), b)
    assert ex.ledger.regions["ADAMW_UPDATE"].calls == 2


def test_supervised_restart_equals_an_uninterrupted_run(tmp_path):
    """A fault at step 3 with a checkpoint every 2 steps: the restart
    re-captures against the restored state, and every step's loss equals
    the uninterrupted run's bit for bit; the ledger keeps one row per
    region across the restart."""
    def run(fail_at, d):
        cfg, init_fn, capture_fn, ex, batch_fn = _trainer()
        state = init_fn()
        sup = TrainSupervisor(
            capture_fn(state, batch_fn(0)), batch_fn,
            Checkpointer(str(d), keep=3), ckpt_every=2,
            fault=FaultInjector(fail_at),
            rebuild_step=lambda st, step: capture_fn(st, batch_fn(step)),
            report_fn=ex.report)
        state, rep = sup.run(state, 0, 5)
        return state, rep, ex
    s0, r0, _ = run((), tmp_path / "a")
    s1, r1, ex = run((3,), tmp_path / "b")
    assert r0.restarts == 0 and r1.restarts == 1 and r1.final_step == 5
    by_step = {step: m["loss"] for step, m in r1.history}
    assert by_step == {step: m["loss"] for step, m in r0.history}
    for a, b in zip(pytree.tree_leaves(s1), pytree.tree_leaves(s0)):
        assert torch.equal(a, b)
    names = sorted(ex.ledger.regions)
    assert names == ["ADAMW_UPDATE", "FWD_BWD"], names
    assert (tmp_path / "b" / "step_0000000004" / "coverage.json").exists()


def test_train_cli_runs_on_cpu(capsys):
    losses = LT.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                      "--report"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert '"mode": "unified"' in out and "tok/s" in out


@pytest.mark.parametrize("flag", [["--policy", "auto"], ["--verify"]])
def test_train_cli_flags_waiting_for_the_tuner_raise(flag):
    with pytest.raises(NotImplementedError, match="A.8"):
        LT.main(["--reduced", "--device", "cpu", "--steps", "1", *flag])


def test_k5_has_no_backward_and_says_so():
    """The ``hopper`` scan has no backward: asked for a gradient, the rwkv
    train path raises instead of running another scan."""
    jcfg, cfg = _configs("rwkv6-7b")
    _, params = _params(jcfg, cfg)
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.value_and_grad(params, batch, cfg,
                         T.Ctx(mode="train", rwkv_impl="hopper"))
