"""The port's xLSTM (``models/xlstm.py``) and xlstm-125m against the JAX
package on the CPU, in f32 at smoke size (2 layers: an mLSTM and an sLSTM
block, d 128, 4 heads): the config mirror, the model's key tree (every
mLSTM and sLSTM leaf); the chunkwise mLSTM against the
sequential step, its chunk-size invariance and extreme gates (mirroring
tests/test_xlstm_internals.py); ``mlstm_chunked``, ``mlstm_step``,
``_slstm_cell`` and both blocks in train, prefill and decode against the
reference's; ``forward`` in three modes, ``loss_fn`` and its gradient
against ``jax.grad``; prefill then decode against teacher forcing
(tests/test_serve.py's case) and the reference's ``decode_step``; the
short-prompt pin (a prompt shorter than the conv tail); the caches;
``generate``; and ``launch.train.run`` (the spatial round) against the
reference's loop.

Tolerances: PARITY x max(1, max|want|) for activations, states, caches
and logits (tests/test_torch_lm.py); gradients GRAD_TOL of each leaf's
largest magnitude (tests/test_torch_jamba.py); the chunked form against
the step and across chunk sizes at tests/test_xlstm_internals.py's atol
1e-4 + rtol 1e-3; decode against the train-mode forward at
tests/test_serve.py's atol 5e-4 + rtol 5e-3; the training run as
tests/test_torch_mla.py's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_train_round as round_tests  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.launch.serve import pad_caches as jax_pad_caches  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.serve import generate, pad_caches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten_like  # noqa: E402

ARCH = "xlstm_125m"
PARITY = 2e-5
GRAD_TOL = 1e-4
SERVE = dict(atol=5e-4, rtol=5e-3)
CHUNKED = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_lm.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params carried across), one
    reference init for the module."""
    jcfg = jax_get_smoke(ARCH).replace(remat=False)
    tcfg = get_smoke(ARCH)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=PARITY):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


def _layer(jp, tp, name, mixer):
    return (jax.tree.map(lambda a: a[0], jp["periods"][name][mixer]),
            tree_map(lambda a: a[0], tp["periods"][name][mixer]))


def _gate_inputs(B=2, S=32, H=2, hd=8, seed=0):
    """q, k, v, li, lf as tests/test_xlstm_internals.py draws them (normal
    draws, k scaled by hd^-1/2, lf a log-sigmoid around 1), from numpy."""
    rng = np.random.default_rng(seed)
    r = lambda shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    q, k, v = r((B, S, H, hd)), r((B, S, H, hd)) * hd ** -0.5, r((B, S, H, hd))
    li = r((B, S, H))
    lf = np.asarray(jax.nn.log_sigmoid(r((B, S, H)) + 1.0))
    return q, k, v, li, lf


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ------------------------------------------------------------------ config
def test_config_mirrors_the_reference():
    for j, t in ((jax_get_smoke(ARCH), get_smoke(ARCH)),
                 (jax_get_config(ARCH), get_config(ARCH))):
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.pdtype == getattr(torch, j.param_dtype)
        assert t.cdtype == getattr(torch, j.compute_dtype)
        assert t.n_periods == j.n_periods and t.layer_kinds() == j.layer_kinds()
    full = get_config("xlstm-125m")
    assert (full.pattern, full.d_ff, full.tie_embeddings) == ("xlstm", 0, True)
    assert [k["ffn"] for k in full.layer_kinds()] == ["none", "none"]


# -------------------------------------------------------------------- init
def test_init_blocks_and_the_model_key_tree(pair):
    """The whole model's tree, every mLSTM and sLSTM leaf among it, leaf
    for leaf within 4 ulp; no block has norm2 or an FFN (the kinds' ``ffn:
    "none"``); the gate weights are f32 under bf16 params."""
    jcfg, tcfg, jp, _ = pair
    mine = params_to_numpy(TT.init(prng.PRNGKey(0), tcfg, device="cpu"))
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _ulps(a, b).max() <= 4
    bf = get_smoke(ARCH).replace(param_dtype="bfloat16")
    tp = TT.init(prng.PRNGKey(0), bf, device="cpu")["periods"]
    assert set(tp["l0"]) == {"norm1", "mlstm"} and set(tp["l1"]) == {"norm1", "slstm"}
    for leaf in (tp["l0"]["mlstm"]["w_if"], tp["l0"]["mlstm"]["b_if"],
                 tp["l1"]["slstm"]["w_gates"], tp["l1"]["slstm"]["r_gates"]):
        assert leaf.dtype == torch.float32
    assert tp["l0"]["mlstm"]["wq"].dtype == torch.bfloat16


# ------------------------------------------------------- the mLSTM's core
def _sequential(q, k, v, li, lf):
    B, S, H, hd = q.shape
    C = torch.zeros((B, H, hd, hd))
    n = torch.zeros((B, H, hd))
    m = torch.full((B, H), -1e30)
    hs = []
    for t in range(S):
        h, (C, n, m) = TX.mlstm_step(q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t],
                                     (C, n, m))
        hs.append(h)
    return torch.stack(hs, dim=1), (C, n, m)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mlstm_chunked_matches_sequential(chunk):
    q, k, v, li, lf = _t(*_gate_inputs())
    want, (Cw, nw, mw) = _sequential(q, k, v, li, lf)
    got, (Cg, ng, mg) = TX.mlstm_chunked(q, k, v, li, lf, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CHUNKED)
    # stabilised states agree up to the (C, m) gauge: compare C exp(m)
    np.testing.assert_allclose((Cg * torch.exp(mg)[..., None, None]).numpy(),
                               (Cw * torch.exp(mw)[..., None, None]).numpy(),
                               **CHUNKED)


def test_mlstm_chunked_invariant_to_chunk_size():
    q, k, v, li, lf = _t(*_gate_inputs(S=48, seed=1))
    h1, _ = TX.mlstm_chunked(q, k, v, li, lf, chunk=6)
    h2, _ = TX.mlstm_chunked(q, k, v, li, lf, chunk=48)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), **CHUNKED)


def test_mlstm_extreme_gates_stable():
    """Exponential gating with the log-max stabiliser must not overflow."""
    q, k, v, li, lf = _t(*_gate_inputs(seed=2))
    h, _ = TX.mlstm_chunked(q, k, v, li + 40.0, lf, chunk=8)
    assert bool(torch.isfinite(h).all())


# -------------------------------------------- the internals vs the reference
def test_mlstm_chunked_and_step_match_reference():
    """``mlstm_chunked`` from zero and from a carried state, S = 27 over
    chunks of 8 (identity-padded to 32), then one ``mlstm_step`` on the
    final state: outputs and states against the reference's."""
    q, k, v, li, lf = _gate_inputs(S=27, seed=3)
    jh, jst = JX.mlstm_chunked(*_j(q, k, v, li, lf), chunk=8)
    th, tst = TX.mlstm_chunked(*_t(q, k, v, li, lf), chunk=8)
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)
    jh, jst = JX.mlstm_chunked(*_j(q, k, v, li, lf), state=jst, chunk=8)
    th, tst = TX.mlstm_chunked(*_t(q, k, v, li, lf), state=tst, chunk=8)
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)
    x = [a[:, 0] for a in _gate_inputs(S=1, seed=4)]
    jh, jst = JX.mlstm_step(*_j(*x), jst)
    th, tst = TX.mlstm_step(*_t(*x), tst)
    _close(th, jh)
    for a, b in zip(tst, jst):
        _close(a, b)


def test_slstm_cell_matches_reference(pair):
    """Six chained ``_slstm_cell`` steps from the zero state (m = -1e30),
    on the smoke sLSTM layer's f32 gate weights."""
    jcfg, tcfg, jp, tp = pair
    jl, tl = _layer(jp, tp, "l1", "slstm")
    H, d = tcfg.num_heads, tcfg.d_model
    gx = np.random.default_rng(5).normal(size=(6, 2, 4 * d)).astype(np.float32)
    z = np.zeros((2, d), np.float32)
    m0 = np.full((2, d), -1e30, np.float32)
    js, ts = tuple(_j(z, z, z, m0)), tuple(_t(z, z, z, m0))
    for g in gx:
        js = JX._slstm_cell(jl, jnp.asarray(g), js, H, d // H)
        ts = TX._slstm_cell(tl, torch.from_numpy(g), ts, H, d // H)
        for a, b in zip(ts, js):
            _close(a, b)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_block_three_modes(pair, mixer):
    """Train and prefill outputs and the prefill cache (S = 21: the mLSTM
    over chunks of 16, one identity-padded), then two decode steps: each
    output and cache against the reference's, the port's cache written in
    place."""
    jcfg, tcfg, jp, tp = pair
    name = "l0" if mixer == "mlstm" else "l1"
    jl, tl = _layer(jp, tp, name, mixer)
    jblock = getattr(JX, f"{mixer}_block")
    tblock = getattr(TX, f"{mixer}_block")
    jprefill = jax.jit(lambda p, x: jblock(p, x, jcfg, mode="prefill"))
    jdecode = jax.jit(lambda p, x, c: jblock(p, x, jcfg, mode="decode", cache=c))
    x = np.random.default_rng(6).normal(size=(2, 23, tcfg.d_model)).astype(np.float32)
    S = 21
    # the reference's train output is its prefill output (one code path)
    jy, jc = jprefill(jl, jnp.asarray(x[:, :S]))
    for mode in ("train", "prefill"):
        ty, tc = tblock(tl, torch.from_numpy(x[:, :S]), tcfg, mode=mode)
        _close(ty, jy)
    assert set(tc) == set(jc)
    for key in jc:
        _close(tc[key], jc[key])
    for t in (S, S + 1):
        jy, jc = jdecode(jl, jnp.asarray(x[:, t:t + 1]), jc)
        before = dict(tc)
        ty, tc = tblock(tl, torch.from_numpy(x[:, t:t + 1]), tcfg, mode="decode",
                        cache=tc)
        _close(ty, jy)
        for key in jc:
            _close(tc[key], jc[key])
            assert tc[key] is before[key]                 # written in place


# ------------------------------------------------------------------ model
def test_forward_three_modes(pair):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(tcfg, (2, 21), 2)
    # the reference's train and prefill forwards share one code path
    jh, jc, _ = JT.forward(jp, jnp.asarray(toks[:, :20]), jcfg, mode="prefill")
    th, tc, aux = TT.forward(tp, torch.from_numpy(toks[:, :20]), tcfg, mode="train")
    assert tc is None and aux == 0.0
    _close(th, jh)
    th, tc, _ = TT.forward(tp, torch.from_numpy(toks[:, :20]), tcfg, mode="prefill")
    _close(th, jh)
    assert tc["pre"] == []
    for a, b in zip(tree_leaves(tc["periods"]), jax.tree.leaves(jc["periods"])):
        _close(a, b)
    jh, jc2, _ = JT.forward(jp, jnp.asarray(toks[:, 20:]), jcfg, mode="decode",
                            positions=jnp.asarray([20]), caches=jc)
    th, tc2, _ = TT.forward(tp, torch.from_numpy(toks[:, 20:]), tcfg, mode="decode",
                            positions=torch.tensor([20]), caches=tc, pos=20)
    _close(th, jh)
    for a, b in zip(tree_leaves(tc2["periods"]), jax.tree.leaves(jc2["periods"])):
        _close(a, b)
    # the states survive forward's decode branch: the stacked caches it
    # returns are the ones the blocks wrote into
    for a, b in zip(tree_leaves(tc2["periods"]), tree_leaves(tc["periods"])):
        assert a is b


def test_loss_and_gradient_match_reference(pair):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(tcfg, (2, 19), 4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl, tm = TT.loss_fn(tree_unflatten_like(tp, leaves),
                        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    _close(tl.detach(), jl)
    assert float(tm["tokens"]) == float(jm["tokens"]) == toks.size
    grads = torch.autograd.grad(tl, leaves)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        _close(g, want, tol=GRAD_TOL)
    periods = tree_unflatten_like(tp, list(grads))["periods"]
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(periods)
               if g.numel() > 0)


# ----------------------------------------------------------------- serving
@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg))


def _teacher_forced(tcfg, tp, toks):
    hidden, _, _ = TT.forward(tp, torch.from_numpy(toks), tcfg, mode="train")
    return hidden.float() @ tp["embed"].T.float()


def test_prefill_then_decode_matches_teacher_forced_and_reference(pair):
    """tests/test_serve.py's case (B 2, prefill 12, decode to 18): every
    logit against the port's train-mode forward on all 18 tokens, and
    against the reference's prefill and jitted ``decode_step``."""
    jcfg, tcfg, jp, tp = pair
    model = get_model(tcfg)
    B, S, S2 = 2, 12, 18
    toks = _tokens(tcfg, (B, S2), 1)
    ref = _teacher_forced(tcfg, tp, toks)
    jcache, jl = JT.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg)
    tcache, tl = model.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(tl.numpy(), ref[:, S - 1].numpy(), **SERVE)
    _close(tl, jl)
    jcache = jax_pad_caches(jax_get_model(jcfg), jcache, B, S2)
    tcache = pad_caches(model, tcache, B, S2)
    step = _jax_decode(jcfg)
    for t in range(S, S2):
        tok = toks[:, t:t + 1].astype(np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok), t)
        tl, tcache = model.decode_step(tp, tcache, torch.from_numpy(tok), t)
        np.testing.assert_allclose(tl.numpy(), ref[:, t].numpy(), **SERVE)
        _close(tl, jl)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_short_prompt_prefill_then_decode(pair, S):
    """A prompt of S < K - 1 = 3 tokens leaves a conv tail of K - 1 rows
    (zeros first), and the decode steps that follow match the port's
    train-mode forward; at S = K - 1 the reference's too. The reference
    keeps only S rows (``x[:, S - (K - 1):]``) and its first decode step
    fails (ROADMAP Queue C)."""
    jcfg, tcfg, jp, tp = pair
    model = get_model(tcfg)
    K = tcfg.ssm_conv_dim
    B, S2 = 2, S + 4
    toks = _tokens(tcfg, (B, S2), 7)
    ref = _teacher_forced(tcfg, tp, toks)
    tcache, tl = model.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    assert tuple(tcache["periods"]["l0"]["conv"].shape[2:3]) == (K - 1,)
    np.testing.assert_allclose(tl.numpy(), ref[:, S - 1].numpy(), **SERVE)
    jcache, jl = JT.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg)
    _close(tl, jl)
    rows = jcache["periods"]["l0"]["conv"].shape[2]
    tcache = pad_caches(model, tcache, B, S2)
    for t in range(S, S2):
        tok = toks[:, t:t + 1].astype(np.int32)
        tl, tcache = model.decode_step(tp, tcache, torch.from_numpy(tok), t)
        np.testing.assert_allclose(tl.numpy(), ref[:, t].numpy(), **SERVE)
        if S >= K - 1:
            jl, jcache = _jax_decode(jcfg)(jp, jcache, jnp.asarray(tok), t)
            _close(tl, jl)
    if S >= K - 1:
        assert rows == K - 1
    else:
        assert rows < K - 1                        # the reference's fault
        with pytest.raises((TypeError, ValueError)):
            JT.decode_step(jp, jcache, jnp.asarray(toks[:, S:S + 1]), S, jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_shapes_dtypes_and_pad(pair, dtype):
    """The caches against the reference's ``jax.eval_shape`` (m filled
    with -1e30); ``pad_caches`` hands the recurrent states back unchanged,
    the same tensors."""
    jcfg, tcfg, jp, tp = pair
    jcfg, tcfg = (c.replace(compute_dtype=dtype) for c in (jcfg, tcfg))
    want = jax.eval_shape(lambda: JT.make_cache(jcfg, 3, 17))
    got = TT.make_cache(tcfg, 3, 17, device="cpu")
    assert jax.tree.structure(params_to_numpy(got)) == jax.tree.structure(
        jax.tree.map(lambda s: np.zeros(()), want))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape and a.dtype == getattr(torch, str(b.dtype))
    for name in ("l0", "l1"):
        assert bool(torch.all(got["periods"][name]["m"] == -1e30))
    model = get_model(tcfg)
    caches, _ = model.prefill(tp, {"tokens": torch.from_numpy(_tokens(tcfg, (3, 5), 8))})
    padded = pad_caches(model, caches, 3, 40)
    for a, b in zip(tree_leaves(padded), tree_leaves(caches)):
        assert a is b


def test_generate_matches_reference_and_serve_main(pair, capsys):
    """Greedy tokens equal the reference's ``generate`` after checking
    every decision's top-2 gap exceeds 5 x PARITY (the two runs' logits
    agree within PARITY); ``serve.main`` at the smoke xlstm."""
    jcfg, tcfg, jp, tp = pair
    model = get_model(tcfg)
    prompt = _tokens(tcfg, (2, 7), 9).astype(np.int32)
    want = np.asarray(jax_generate(jax_get_model(jcfg), jp, jnp.asarray(prompt), 6))
    got = generate(model, tp, torch.from_numpy(prompt), 6, device="cpu")
    hidden, _, _ = TT.forward(tp, got[:, :-1], tcfg, mode="train")
    logits = hidden[:, 6:].float() @ tp["embed"].T.float()
    top = torch.topk(logits, 2, dim=-1).values
    assert float(torch.min(top[..., 0] - top[..., 1])) > 5 * PARITY
    np.testing.assert_array_equal(got.numpy(), want)
    toks = serve.main(["--arch", "xlstm-125m", "--batch", "2", "--prompt-len", "5",
                       "--gen", "3", "--device", "cpu"])
    assert toks.shape == (2, 8)
    assert "xlstm-125m: generated 2x3 tokens" in capsys.readouterr().out


# ------------------------------------------------------- federated training
RUN = dict(rounds=2, clients=4, n_priority=2, per_client=2, seq=16,
           local_epochs=2, lr=0.05)
EPS = 0.05
GATE_MARGIN = 1e-3
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def reference_run():
    mp = pytest.MonkeyPatch()
    mp.setattr(round_tests, "RUN_KW", RUN)
    try:
        yield round_tests._jax_run(ARCH, {}, EPS)
    finally:
        mp.undo()


def test_train_run_matches_reference(reference_run):
    """xlstm through the spatial round (the reference's ``run``) and its
    gradients: gates exact, losses within 1e-5 relative, params within
    GRAD_TOL per leaf."""
    jp, jh = reference_run
    tp, th = train.run(arch=ARCH, epsilon=EPS, device="cpu", verbose=False, **RUN)
    npri = RUN["n_priority"]
    for j, t in zip(jh, th):
        gaps = np.abs(np.asarray(t["local_losses"]) - t["server_loss"])
        assert np.all(np.abs(gaps[npri:] - EPS) > GATE_MARGIN)
        np.testing.assert_array_equal(np.asarray(t["gates"]), j["gates"])
        np.testing.assert_allclose(t["server_loss"], j["server_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["local_losses"], j["local_losses"],
                                   rtol=LOSS_RTOL)
    included = [t["included"] for t in th]
    assert 0 < sum(included) < (RUN["clients"] - npri) * len(th)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, tol=GRAD_TOL)
