"""Compiled regions of the port (``torch.compile``, ``fullgraph=True``),
the kernels as ``torch.library`` custom ops, donation, and
``RegionProgram.as_fn``/``replay_batch``, on the CPU at small sizes and
held against the JAX package on the same numpy inputs.  The CFD slice's
compiled regions are tested in tests/test_torch_compile_cfd.py.

Tolerances:
* ``replay_batch`` of the ``mini`` program against JAX's and the port's
  solo replays: ``rtol=atol=1e-6`` (``tests/test_program.py``'s);
* decode tokens (float32): equal, as ``tests/test_serve_train_regions.py``
  asserts for the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.core.ledger import Ledger as JLedger
from repro.core.program import capture as j_capture
from repro.core.regions import (Executor as JExecutor,
                                UnifiedPolicy as JUnifiedPolicy,
                                region as j_region)
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch.configs.reduced import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.ledger import Ledger
from repro_torch.core.program import capture
from repro_torch.core.regions import (DiscretePolicy, Executor,
                                      UnifiedPolicy, disable_compile, region)
from repro_torch.kernels.fused_field import kernel as FK
from repro_torch.kernels.rwkv6_scan import kernel as RK
from repro_torch.kernels.stencil_spmv import kernel as SK
from repro_torch.launch import serve as SV
from repro_torch.models import transformer as T
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.train import step as S

def _rand(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*shape).astype(np.float32))


# ---------------------------------------------------------------------------
# The five custom ops
# ---------------------------------------------------------------------------

def _op_cases():
    x, y, z = (_rand(4, 3, 5, seed=s) for s in range(3))
    off = _rand(6, 4, 3, 5, seed=3) - 0.5
    red = _rand(4, 3, 5, seed=4) < 0.5
    r, k, v = (_rand(2, 9, 2, 4, seed=s) - 0.5 for s in range(5, 8))
    logw = -_rand(2, 9, 2, 4, seed=8)
    u = _rand(2, 4, seed=9)
    S0 = _rand(2, 2, 4, 4, seed=10)
    a, b = FK._scalar(1.5), FK._scalar(-0.25)
    return {
        "stencil_spmv": (SK.stencil_spmv_op, (x, off, y)),
        "rb_dilu_forward": (SK.rb_dilu_forward_op, (x + 0.5, red, off, y)),
        "rb_dilu_backward": (SK.rb_dilu_backward_op, (x + 0.5, red, off, y)),
        "fused_field": (FK.fused_field_op, (x, y, z, a, b, 3)),
        "rwkv6_scan": (RK.rwkv6_scan_op, (r, k, v, logw, u, S0)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_custom_op_passes_opcheck(name):
    """Schema, fake implementation (symbolic sizes included, in
    ``test_aot_dispatch_dynamic``) and the CPU implementation."""
    op, args = _op_cases()[name]
    assert op._qualname == f"repro_torch::{name}"
    torch.library.opcheck(op, args)


def test_rwkv6_scan_op_takes_no_state():
    op, (r, k, v, logw, u, _) = _op_cases()["rwkv6_scan"]
    torch.library.opcheck(op, (r, k, v, logw, u, None))


def _stacked(args, n, batched):
    """``args`` with a batch of ``n`` along axis 0 at the positions in
    ``batched`` (each row a distinct perturbation)."""
    out = []
    for i, a in enumerate(args):
        if i in batched:
            out.append(torch.stack([a * (1 + 0.1 * j) if a.is_floating_point()
                                    else a for j in range(n)]))
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("name,batched", [
    ("stencil_spmv", (2,)), ("stencil_spmv", (0, 1, 2)),
    ("rb_dilu_forward", (3,)), ("rb_dilu_backward", (0, 2, 3)),
    ("fused_field", (0, 1)), ("fused_field", (1,)), ("fused_field", (0, 3)),
    ("rwkv6_scan", (0, 1, 2, 3)), ("rwkv6_scan", (0, 1, 2, 3, 5)),
    ("rwkv6_scan", (0, 4))])
def test_custom_op_vmap_rule_equals_a_loop(name, batched):
    """The vmap rule (K1-K3 row by row, K4 on the batched operands, K5
    folded into B; a batched K4 scalar or K5 ``u`` row by row) equals one
    call per batch row."""
    op, args = _op_cases()[name]
    n = 3
    stacked = _stacked(args, n, batched)
    in_dims = tuple(0 if i in batched else None for i in range(len(args)))
    got = torch.func.vmap(op, in_dims=in_dims)(*stacked)
    want = [op(*(s[j] if i in batched else s for i, s in enumerate(stacked)))
            for j in range(n)]
    if name == "rwkv6_scan":
        for part in range(2):
            torch.testing.assert_close(
                got[part], torch.stack([w[part] for w in want]),
                rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(got, torch.stack(want), rtol=1e-6,
                                   atol=1e-6)


def test_kernel_wrappers_call_their_ops_in_a_compiled_graph():
    """In a compiled function each wrapper is one call of its op (an
    opaque node), a Python float scalar stays a graph input (no compile
    per value), and the result equals the eager call."""
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    def f(a, diag, off, x):
        y = SK.stencil_spmv(diag, off, x)
        return FK.fused_axpy(a, y, x)

    diag, x = _rand(4, 3, 5, seed=1), _rand(4, 3, 5, seed=2)
    off = _rand(6, 4, 3, 5, seed=3)
    cf = torch.compile(f, fullgraph=True, backend=backend)
    for a in (0.5, 1.25, -2.0, 3.5):
        torch.testing.assert_close(cf(a, diag, off, x), f(a, diag, off, x),
                                   rtol=0, atol=0)
    assert len(graphs) <= 2
    targets = {str(n.target) for n in graphs[-1].graph.nodes
               if n.op == "call_function"}
    assert "repro_torch.stencil_spmv.default" in targets
    assert "repro_torch.fused_field.default" in targets


# ---------------------------------------------------------------------------
# Layer ops: one compiled layer per kind, an opaque node in a compiled step
# ---------------------------------------------------------------------------

def _layer_case(mode, dtype="float32", n_layers=3):
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b")),
                              n_layers=n_layers, param_dtype=dtype,
                              compute_dtype=dtype)
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = T.init_cache(cfg, 2, "cpu")
    for i, layer in enumerate(cache):
        layer["S"].add_(_rand(*layer["S"].shape, seed=20 + i) - 0.5)
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab, (2, 9 if mode == "prefill" else 1)).astype(np.int64))
    return cfg, params, cache, tokens


@pytest.mark.parametrize("mode,impl", [("prefill", None),
                                       ("prefill", "hopper"),
                                       ("decode", None)])
def test_layer_op_passes_opcheck(mode, impl):
    """Schema, fake implementation (the inputs' shapes, dtypes and layout;
    symbolic sizes in ``test_aot_dispatch_dynamic``) and the layer run
    eagerly, for each mode (prefill with the plain scan and with K5's
    variant, which is its plain version on the CPU)."""
    cfg, params, cache, tokens = _layer_case(mode, "bfloat16")
    op = T.layer_fns(cfg, T.Ctx(mode=mode, rwkv_impl=impl))[("rwkv", "cm")]
    x = torch.from_numpy(np.random.RandomState(3).randn(
        *tokens.shape, cfg.d_model).astype(np.float32)).to(torch.bfloat16)
    pos = None if mode == "prefill" else torch.tensor(9, dtype=torch.int32)
    args = (T._leaves(params["layers"][1]), x,
            [cache[1][k] for k in op._cache_keys], pos)
    with disable_compile():
        torch.library.opcheck(op.op, args)


def test_layer_fns_are_made_once_per_config_and_context():
    cfg = _layer_case("decode")[0]
    a = T.layer_fns(cfg, T.Ctx(mode="decode"))
    assert T.layer_fns(cfg, T.Ctx(mode="decode", pos=5)) == a
    assert T.layer_fns(cfg, T.Ctx(mode="prefill")) != a


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_layer_ops_equal_the_inline_layers(mode):
    """Run eagerly, the step through its layer ops equals the inline layer
    loop bit for bit, caches included (in their keys' order)."""
    cfg, params, cache, tokens = _layer_case(mode, "bfloat16")
    step = S.make_prefill_step(cfg) if mode == "prefill" \
        else S.make_decode_step(cfg)
    with disable_compile():
        if mode == "prefill":
            want = T.prefill(params, {"tokens": tokens}, cfg, T.Ctx(), cache)
            got = step(params, {"tokens": tokens}, cache)
        else:
            want = T.decode_step(params, tokens[:, 0], cache, 9, cfg, T.Ctx())
            got = step(params, tokens[:, 0], cache, 9)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert list(g) == list(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_compiled_step_holds_one_op_per_layer_and_compiles_it_once(mode):
    """A compiled step's graph calls its kind's layer op once per layer and
    traces no layer inline; the layer compiles once for all of them; the
    step agrees with the eager step within the region envelope (f32)."""
    cfg, params, cache, tokens = _layer_case(mode)
    op = T.layer_fns(cfg, T.Ctx(mode=mode))[("rwkv", "cm")]
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    if mode == "prefill":
        step = S.make_prefill_step(cfg)
        args = (params, {"tokens": tokens}, cache)
    else:
        step = S.make_decode_step(cfg)
        args = (params, tokens[:, 0], cache, SV.position(9))
    got = torch.compile(step, fullgraph=True, backend=backend)(*args)
    with disable_compile():
        want = step(*args)
    targets = [str(n.target) for n in graphs[-1].graph.nodes
               if n.op == "call_function"]
    assert targets.count(f"repro_torch.{op.label}.default") == cfg.n_layers
    assert sum("matmul" in t or "linear" in t for t in targets) <= 1
    assert op.stats.compiles == 1
    torch.testing.assert_close(got[0], want[0], rtol=3e-4, atol=1e-4)
    for g, w in zip(got[1], want[1]):
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=3e-4, atol=1e-4)


@pytest.mark.parametrize("batched", ["cache", "all"])
def test_layer_op_vmap_rule_equals_a_loop(batched):
    """The vmap rule calls the op once per row, so it equals the loop bit
    for bit (``x`` and the cache batched, or the parameters too)."""
    cfg, params, cache, tokens = _layer_case("decode")
    op = T.layer_fns(cfg, T.Ctx(mode="decode"))[("rwkv", "cm")]
    n = 2
    p = T._leaves(params["layers"][0])
    xs = torch.from_numpy(np.random.RandomState(5).randn(
        n, 2, 1, cfg.d_model).astype(np.float32))
    cs = [torch.stack([cache[0][k] * (1 + j) for j in range(n)])
          for k in op._cache_keys]
    ps = [torch.stack([t * (1 + 0.1 * j) for j in range(n)]) for t in p] \
        if batched == "all" else p
    p_dims = [0] * len(p) if batched == "all" else [None] * len(p)
    with disable_compile():
        pos = torch.tensor(9, dtype=torch.int32)
        got = torch.func.vmap(op.op, in_dims=(p_dims, 0, [0] * len(cs),
                                              None))(ps, xs, cs, pos)
        want = [op.op([t[j] for t in ps] if batched == "all" else p, xs[j],
                      [c[j] for c in cs], pos) for j in range(n)]
    for i, g in enumerate(got):
        assert torch.equal(g, torch.stack([w[i] for w in want]))


# ---------------------------------------------------------------------------
# Region: donate_args and compiled executables
# ---------------------------------------------------------------------------

def _two(a, b):
    return a + b


@pytest.mark.parametrize("kw", [
    dict(donate_args=(-1,)),
    dict(donate_args=(2,)),
    dict(donate_args=(0,), halo_args=("a",), stencil=((0, 1),)),
], ids=["negative", "out_of_range", "halo_overlap"])
def test_donate_args_errors_match_jax(kw):
    with pytest.raises(Exception) as want:
        j_region("bad", ledger=JLedger("bad"), **kw)(_two)
    with pytest.raises(Exception) as got:
        region("bad", ledger=Ledger("bad"), **kw)(_two)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


def test_donate_args_accepts_what_jax_accepts():
    for kw in (dict(donate_args=(0, 1)),
               dict(donate_args=(1,), halo_args=("a",), stencil=((0, 1),))):
        j_region("ok", ledger=JLedger("ok"), **kw)(_two)
        r = region("ok", ledger=Ledger("ok"), **kw)(_two)
        assert tuple(r.donate_args) == kw["donate_args"]


def test_executable_is_compiled_once_and_cached():
    r = region("axpy2", ledger=Ledger("c"))(lambda a, x: a * x + 1.0)
    ex = r.executable("default")
    assert r.executable("default") is ex
    assert r.executable("device") is ex     # both run on the operands as
    assert r.executable("host") is not ex   # they are; host is compiled apart
    x = _rand(16)
    torch.testing.assert_close(ex(2.0, x), 2.0 * x + 1.0)
    for a in (0.5, 3.0, -1.0):
        ex(a, x)
        r.executable("device")(a, x)
    stats = r.compile_stats[("device", "ref", False)]
    assert 1 <= stats.compiles <= 2 and stats.calls == 7
    assert stats.first_call_s > 0


def test_a_graph_break_raises():
    def data_dependent(x):
        if x.sum() > 0:                   # Python branch on a tensor value
            return x + 1
        return x - 1

    r = region("branchy", ledger=Ledger("c"))(data_dependent)
    with pytest.raises(Exception, match="(?i)data-dependent|graph break|"
                                        "unsupported"):
        r.executable()(_rand(8))
    with disable_compile():
        torch.testing.assert_close(r.executable()(_rand(8)), _rand(8) + 1)


def test_disable_compile_returns_the_variant_itself():
    fn = lambda x: x * 2.0                  # noqa: E731
    r = region("eager", ledger=Ledger("c"))(fn)
    with disable_compile():
        assert r.executable("default") is fn
        assert r.executable("device") is fn
    assert r.executable("default") is not fn


def test_reregistering_a_variant_drops_its_executables():
    r = region("rereg", ledger=Ledger("c"))(lambda x: x + 1.0)
    r.variant("fast", lambda x: x + 2.0)
    x = _rand(8)
    old_ref, old_fast = r.executable(impl="ref"), r.executable(impl="fast")
    torch.testing.assert_close(old_fast(x), x + 2.0)
    r.variant("fast", lambda x: x + 3.0)
    assert r.executable(impl="ref") is old_ref
    new_fast = r.executable(impl="fast")
    assert new_fast is not old_fast
    torch.testing.assert_close(new_fast(x), x + 3.0)
    r.variant("ref", lambda x: x + 4.0)
    torch.testing.assert_close(r.executable(impl="ref")(x), x + 4.0)


def test_host_target_compiles_and_kernels_on_it_raise():
    r = region("hosted", ledger=Ledger("c"))(lambda x: x * 3.0)
    r.variant("hopper", lambda x: x * 3.0)
    x = _rand(8)
    torch.testing.assert_close(r.executable("host")(x), x * 3.0)
    assert ("host", "ref", False) in r.compile_stats
    with pytest.raises(ValueError, match="host target"):
        r.executable("host", "hopper")


def test_donated_results_take_the_argument_storage():
    """A result matching a donated argument is written into it; a result
    that is a non-donated argument comes back as a copy."""
    r = region("step", ledger=Ledger("c"), donate_args=(0,))(
        lambda s, x: (s * 0.5 + x, x))
    s, x = _rand(32, seed=1), _rand(32, seed=2)
    want = s * 0.5 + x
    s_ptr, x_ptr = s.data_ptr(), x.data_ptr()
    new_s, same_x = r.executable()(s, x)
    torch.testing.assert_close(new_s, want)
    assert new_s.data_ptr() == s_ptr
    assert same_x.data_ptr() != x_ptr
    torch.testing.assert_close(same_x, x)
    s2 = _rand(32, seed=1)
    new_s2, _ = r.executable(donate=False)(s2, x)
    assert new_s2.data_ptr() != s2.data_ptr()
    torch.testing.assert_close(s2, _rand(32, seed=1))      # not written


@pytest.fixture(scope="module")
def tiny_serve():
    cfg = reduced(get_config("rwkv6-7b"))
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, params


@pytest.mark.parametrize("policy", ["unified", "discrete"])
def test_kv_append_donates_under_unified_and_copies_under_discrete(
        tiny_serve, policy):
    cfg, params = tiny_serve
    pol = UnifiedPolicy() if policy == "unified" \
        else DiscretePolicy(device="cpu")
    ex = Executor(pol, Ledger("kv"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
    assert tuple(regions.kv_append.donate_args) == (0,)
    cache = T.init_cache(cfg, 2, "cpu")
    for layer in cache:
        layer["S"].add_(0.25)
    ptrs = [[t.data_ptr() for t in layer.values()] for layer in cache]
    out = ex.run(regions.kv_append, cache)
    got = [[t.data_ptr() for t in layer.values()] for layer in out]
    if policy == "unified":
        assert got == ptrs
    else:
        assert all(g != p for gl, pl in zip(got, ptrs)
                   for g, p in zip(gl, pl))
    for a, b in zip(out, cache):
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# RegionProgram.as_fn / replay_batch
# ---------------------------------------------------------------------------

N_MINI = 4096


def _mini(frame):
    """The reference's ``mini`` program (tests/test_program.py) in either
    framework: dataflow edges, a frozen host scalar, a two-output op."""
    if frame == "jax":
        reg, ledger, xp, total = j_region, JLedger("mini"), jnp, jnp.sum
    else:
        reg, ledger, xp, total = region, Ledger("mini"), torch, torch.sum
    kw = dict(ledger=ledger)

    @reg("scale", **kw)
    def scale(d, x):
        return d * x

    @reg("saxpy", **kw)
    def saxpy(a, x, y):
        return y - a * x

    @reg("split", **kw)
    def split(x):
        return x * 0.5, x * 2.0

    @reg("dot", **kw)
    def dot(x, y):
        return total(x * y)

    def step(run, d, x, b):
        r = run(saxpy, 1.0, run(scale, d, x), b)
        lo, hi = run(split, r)
        s = float(run(dot, lo, hi))
        return run(saxpy, s / (abs(s) + 1.0), lo, hi)

    d = np.linspace(1.0, 2.0, N_MINI, dtype=np.float32)
    x = np.full((N_MINI,), 0.3, np.float32)
    b = np.linspace(0.0, 1.0, N_MINI, dtype=np.float32)
    if frame == "jax":
        args = tuple(jnp.asarray(a) for a in (d, x, b))
        return j_capture(step, *args, name="mini"), args
    args = tuple(torch.from_numpy(a) for a in (d, x, b))
    return capture(step, *args, name="mini"), args


def test_replay_batch_of_mini_matches_jax_and_solo_replays():
    jprog, (jd, jx, jb) = _mini("jax")
    prog, (d, x, b) = _mini("torch")
    n = 3
    xs_np = np.stack([np.asarray(jx) + 0.01 * i for i in range(n)])
    want = np.asarray(jprog.replay_batch(
        jnp.stack([jd] * n), jnp.asarray(xs_np), jnp.stack([jb] * n),
        executor=JExecutor(JUnifiedPolicy())))
    ex = Executor(UnifiedPolicy())
    ds, xs, bs = torch.stack([d] * n), torch.from_numpy(xs_np), \
        torch.stack([b] * n)
    got = prog.replay_batch(ds, xs, bs, executor=ex)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    solo = torch.stack([prog.replay(ex, ds[i], xs[i], bs[i])
                        for i in range(n)])
    torch.testing.assert_close(got, solo, rtol=1e-6, atol=1e-6)
    assert [name for name in ex.ledger.regions
            if name.startswith("mini[batch]")] == ["mini[batch]"]
    assert ex.ledger.regions["mini[batch]"].calls == 1
    again = prog.replay_batch(ds, xs, bs, executor=ex)      # cached
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert len(prog._batched) == 1
    assert ex.ledger.regions["mini[batch]"].calls == 2


def test_as_fn_survives_the_replays_liveness_drop():
    """The sequential replay drops each output after its last reader; the
    composite of the same program still sees every leaf, call after
    call."""
    prog, (d, x, b) = _mini("torch")
    assert prog._dead_after                     # the replay drops leaves
    ex = Executor(UnifiedPolicy())
    with disable_compile():
        fn = prog.as_fn()
        first = fn(d, x, b)
        torch.testing.assert_close(prog.replay(ex, d, x, b), first,
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(fn(d, x, b), first, rtol=0, atol=0)
    assert prog._op_impls() == ("ref",) * len(prog)


B, PROMPT, GEN, GROUPS = 2, 8, 4, 2


def test_replay_batch_of_the_decode_program_matches_jax_and_solo_replays():
    """Reduced rwkv6-7b in float32: two request groups, prefilled by the
    reference, decoded by the reference's ``replay_batch`` of its decode
    program and by the port's, and by the port's solo replays."""
    over = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = dataclasses.replace(j_reduced(j_get_config("rwkv6-7b")), **over)
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b")), **over)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jprefill = jax.jit(JS.make_prefill_step(jcfg))
    rng = np.random.RandomState(3)
    jtoks, jcaches = [], []
    for _ in range(GROUPS):
        prompts = rng.randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
        logits, cache = jprefill(jp, {"tokens": jnp.asarray(prompts)},
                                 JT.init_cache(jcfg, B, PROMPT + GEN))
        jtoks.append(jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32))
        jcaches.append(cache)

    # the reference's decode program (plain Ctx(): its sharder fails here)
    jdec = JS.make_decode_step(jcfg)
    jl = JLedger("jdecode")

    @j_region("DECODE_STEP", ledger=jl)
    def j_decode(tok, cache, pos):
        logits, cache = jdec(jp, tok, cache, pos)
        return jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32), cache

    @j_region("KV_APPEND", ledger=jl, offloaded=False, donate_args=(0,))
    def j_kv(cache):
        return cache

    def j_loop(run, tok, cache):
        toks = [tok]
        for i in range(GEN - 1):
            tok, cache = run(j_decode, tok, cache, jnp.int32(PROMPT + i))
            cache = run(j_kv, cache)
            toks.append(tok)
        return tuple(toks)

    jprog = j_capture(j_loop, jtoks[0], jax.tree.map(jnp.copy, jcaches[0]))
    want = np.asarray(jnp.stack(jprog.replay_batch(
        jnp.stack(jtoks), jax.tree.map(lambda *xs: jnp.stack(xs), *jcaches),
        executor=JExecutor(JUnifiedPolicy())), axis=-1))

    toks = [torch.from_numpy(np.array(t)) for t in jtoks]
    caches = [cache_from_jax(jax.tree.map(np.asarray, c), cfg, "cpu")
              for c in jcaches]
    ex = Executor(UnifiedPolicy(), Ledger("decode"))
    regions = SV.make_serve_regions(cfg, params, ledger=ex.ledger)
    with disable_compile():
        prog = SV.capture_decode_program(
            regions, PROMPT, GEN, toks[0],
            [{k: v.clone() for k, v in c.items()} for c in caches[0]])
        solo = torch.stack([torch.stack(prog.replay(ex, toks[i], caches[i]),
                                        dim=-1) for i in range(GROUPS)])
    stacked = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs),
                                           *caches)
    got = torch.stack(prog.replay_batch(torch.stack(toks), stacked,
                                        executor=ex), dim=-1)
    assert got.shape == (GROUPS, B, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, solo)
    assert "decode_program[batch]" in ex.ledger.regions


@pytest.mark.parametrize("mode", ["compiled", "eager"])
def test_prefill_and_decode_bfloat16_against_jax(mode):
    """ROADMAP C.2 on the compiled path: reduced rwkv6-7b in bfloat16,
    prefill and teacher-forced decode through compiled step functions (and,
    for comparison, the same eagerly) against the reference's jitted ones.
    The envelope is ``test_prefill_and_decode_match_jax_bfloat16``'s (0.15
    of the largest magnitude); the figure is printed (``pytest -s``)."""
    from repro_torch.core.regions import compile_region_fn
    from repro_torch.train import step as S
    gen_n = 8
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(j_reduced(j_get_config("rwkv6-7b")), **over)
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b")), **over)
    rng = np.random.RandomState(1)

    def nonzero(path, a):       # u, mu_*, B_* nonzero (their inits are 0)
        name, a = path[-1].key, np.asarray(a)
        if name == "u":
            return (0.3 * rng.randn(*a.shape)).astype(a.dtype)
        if name.startswith("mu_"):
            return rng.rand(*a.shape).astype(a.dtype)
        if name.startswith("B_"):
            return (0.2 * rng.randn(*a.shape)).astype(np.float32).astype(
                a.dtype)
        return a

    jp = jax.tree.map(jnp.asarray, jax.tree_util.tree_map_with_path(
        nonzero, JT.init(jax.random.PRNGKey(0), jcfg)))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (B, 32)).astype(np.int32)
    jlog, jc = jax.jit(JS.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(prompts)}, JT.init_cache(jcfg, B, 32 + gen_n))
    prefill = S.make_prefill_step(
        cfg, lambda: T.Ctx(mode="prefill", rwkv_impl="hopper"))
    decode = S.make_decode_step(cfg)
    if mode == "compiled":
        prefill = compile_region_fn(prefill, "c2_prefill")
        decode = compile_region_fn(decode, "c2_decode")
    tlog, tc = prefill(params, {"tokens": torch.from_numpy(prompts)},
                       T.init_cache(cfg, B, "cpu"))
    jdec = jax.jit(JS.make_decode_step(jcfg))
    worst = {"logits": 0.0, "S": 0.0}

    def rel(got, want):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert np.isfinite(got).all()
        return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))

    for i in range(gen_n):
        worst["logits"] = max(worst["logits"],
                              rel(tlog.float().numpy(), jlog))
        if i == gen_n - 1:
            break
        jtok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1), np.int32)
        jlog, jc = jdec(jp, jnp.asarray(jtok), jc, jnp.int32(32 + i))
        tlog, tc = decode(params, torch.from_numpy(jtok.copy()), tc,
                          SV.position(32 + i))
    jcache = cache_from_jax(jax.tree.map(np.asarray, jc), cfg, "cpu")
    for jl, tl in zip(jcache, tc):
        worst["S"] = max(worst["S"], rel(tl["S"].float().numpy(),
                                         jl["S"].float().numpy()))
    print(f"\n[C.2] {mode} bf16 vs JAX, max |d| / max(1, max|ref|): "
          f"logits {worst['logits']:.4f}, S {worst['S']:.4f} (limit 0.15)")
    assert worst["logits"] <= 0.15 and worst["S"] <= 0.15, worst
