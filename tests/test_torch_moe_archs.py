"""The port's MoE archs against the JAX package on the CPU, in f32 at smoke
size: granite-moe-3b-a800m (GQA at G = 2 in the smoke config, 3 at full
width; tied embeddings) and deepseek-moe-16b (shared experts and a
leading dense block, ``pre_blocks[0]``, outside the periods). The config
mirror, the init's key tree, ``forward`` in train, prefill and decode,
prefill then decode against the reference's ``decode_step`` logits,
``loss_fn`` and its gradient against ``jax.grad``, ``make_cache`` against
the reference's ``jax.eval_shape``, the scheduler against ``generate``,
and deepseek through ``launch.train.run`` against the reference's loop.

Routing is discrete: every comparison runs on inputs whose router
probabilities separate each token's k-th and (k+1)-th expert by more
than ROUTE_MARGIN in every MoE layer (asserted), so expert choices and
capacity drops are compared exactly.

Tolerances: PARITY x max(1, max|want|) for activations and logits (as
tests/test_torch_lm.py); gradients 1e-4 of each leaf's largest magnitude
(tests/test_torch_jamba.py's bound for the MoE gradient); the training
run as tests/test_torch_jamba_train.py."""
import dataclasses
import functools
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_train_round as round_tests  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.launch.serve import pad_caches as jax_pad_caches  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import generate, pad_caches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import BatchScheduler, Request  # noqa: E402
from repro_torch.utils import tree_leaves, tree_unflatten_like  # noqa: E402

ARCHS = ["granite_moe_3b_a800m", "deepseek_moe_16b"]
PARITY = 2e-5
GRAD_TOL = 1e-4
ROUTE_MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_lm.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, port cfg, jax params, port params carried across), one
    reference init per arch for the module."""
    jcfg = jax_get_smoke(request.param).replace(remat=False)
    tcfg = get_smoke(request.param)
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


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


# ------------------------------------------------------------------ routing
@contextmanager
def port_routes():
    """Record each port MoE layer's routing: (top-k experts [T, k], the
    k-th minus (k+1)-th probability [T], the layer's dropped fraction)."""
    rec = []
    orig = TT.moe_apply

    def recorded(p, x, cfg, **kw):
        with torch.no_grad():
            logits = x.reshape(-1, x.shape[-1]).float() @ p["w_router"].float()
            srt, idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                                  stable=True)
        y, aux = orig(p, x, cfg, **kw)
        k = cfg.top_k
        rec.append((idx[:, :k].numpy(), (srt[:, k - 1] - srt[:, k]).numpy(),
                    float(aux["drop_frac"])))
        return y, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TT, "moe_apply", recorded)
        yield rec


def jax_routes(jp, toks, jcfg):
    """The reference's routing, layer by layer, on its train-mode forward:
    each MoE layer hands its choices out through an ordered callback."""
    rec = []
    orig = JT.moe_apply

    def recorded(p, x, cfg, **kw):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                               @ p["w_router"], axis=-1)
        _, tope = jax.lax.top_k(probs, cfg.top_k)
        y, aux = orig(p, x, cfg, **kw)
        jax.debug.callback(lambda e, d: rec.append((np.asarray(e), float(d))),
                           tope, aux["drop_frac"], ordered=True)
        return y, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "moe_apply", recorded)
        jax.block_until_ready(JT.forward(jp, jnp.asarray(toks), jcfg, mode="train"))
    jax.effects_barrier()
    return rec


def assert_routes_discrete(rec):
    for _, margin, _ in rec:
        assert float(margin.min()) > ROUTE_MARGIN, \
            f"router margin {float(margin.min())} <= {ROUTE_MARGIN}"


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["config", "dropping"])
def test_expert_choices_and_drops_match_reference(pair, capacity_factor):
    """The same experts for every token of every MoE layer and the same
    dropped fraction, exactly; at 0.5 the capacity drops tokens."""
    jcfg, tcfg, jp, tp = pair
    jcfg, tcfg = (c.replace(capacity_factor=capacity_factor) for c in (jcfg, tcfg))
    toks = _tokens(tcfg, (2, 11), 2)
    with port_routes() as mine:
        TT.forward(tp, torch.from_numpy(toks), tcfg, mode="train")
    want = jax_routes(jp, toks, jcfg)
    assert len(mine) == len(want) == tcfg.num_layers - tcfg.first_dense
    assert_routes_discrete(mine)
    for (e, _, drop), (je, jdrop) in zip(mine, want):
        np.testing.assert_array_equal(e, je)
        assert drop == jdrop
    if capacity_factor < 1:
        assert all(drop > 0 for _, _, drop in mine)


# ------------------------------------------------------------------ config
def test_configs_mirror_the_reference():
    for arch in ARCHS:
        for j, t in ((jax_get_smoke(arch), get_smoke(arch)),
                     (jax_get_config(arch), get_config(arch))):
            for f in dataclasses.fields(j):
                if f.name not in ("param_dtype", "compute_dtype"):
                    assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
            assert t.pdtype == getattr(torch, j.param_dtype)
            assert t.cdtype == getattr(torch, j.compute_dtype)
            assert t.n_periods == j.n_periods and t.layer_kinds() == j.layer_kinds()
    full = get_config("deepseek-moe-16b")
    assert (full.first_dense, full.n_periods, full.num_shared_experts) == (1, 27, 2)
    g = get_config("granite-moe-3b-a800m")
    assert g.num_heads // g.num_kv_heads == 3 and g.tie_embeddings


# -------------------------------------------------------------------- init
def test_init_matches_the_reference_key_tree(pair):
    """Leaf for leaf within 4 ulp (tests/test_torch_lm.py), the leading
    dense block ``pre_blocks[0]`` included."""
    jcfg, tcfg, jp, _ = pair
    mine = params_to_numpy(TT.init(prng.PRNGKey(0), tcfg, device="cpu"))
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4
    assert len(mine["pre_blocks"]) == tcfg.first_dense
    for block in mine["pre_blocks"]:
        assert "mlp" in block and "moe" not in block
        assert block["mlp"]["w_gate"].shape == (tcfg.d_model, tcfg.d_ff)
    assert "moe" in mine["periods"]["l0"]


# ------------------------------------------------------------------ forward
def test_forward_three_modes(pair):
    """Train: hidden and aux (the pre block adds 0.0). Prefill: hidden and
    every cache, the pre blocks' unstacked. Decode: one step into the
    padded caches, hidden and the written rows; the pre blocks' caches
    written in place."""
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(tcfg, (2, 11), 2)
    with port_routes() as rec:
        th, tc, taux = TT.forward(tp, torch.from_numpy(toks), tcfg, mode="train")
    assert_routes_discrete(rec)
    jh, jc, jaux = JT.forward(jp, jnp.asarray(toks), jcfg, mode="train")
    assert tc is None and jc is None
    _close(th, jh)
    _close(taux, jaux)
    with port_routes() as rec:
        th, tc, _ = TT.forward(tp, torch.from_numpy(toks[:, :10]), tcfg, mode="prefill")
    assert_routes_discrete(rec)
    jh, jc, _ = JT.forward(jp, jnp.asarray(toks[:, :10]), jcfg, mode="prefill")
    _close(th, jh)
    assert len(tc["pre"]) == len(jc["pre"]) == tcfg.first_dense
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        if isinstance(a, int):
            assert a == int(np.asarray(b).reshape(-1)[0]) == 10
        else:
            _close(a, b)
    model = get_model(tcfg)
    tcp = pad_caches(model, tc, 2, 11)
    jcp = jax_pad_caches(jax_get_model(jcfg), jc, 2, 11)
    pre_k = [c["k"] for c in tcp["pre"]]
    with port_routes() as rec:
        th, tc2, _ = TT.forward(tp, torch.from_numpy(toks[:, 10:]), tcfg,
                                mode="decode", positions=torch.tensor([10]),
                                caches=tcp, pos=10)
    assert_routes_discrete(rec)
    jh, jc2, _ = JT.forward(jp, jnp.asarray(toks[:, 10:]), jcfg, mode="decode",
                            positions=jnp.asarray([10]), caches=jcp)
    _close(th, jh)
    for a, b in zip(tree_leaves(tc2), jax.tree.leaves(jc2)):
        if isinstance(a, int):
            assert a == 11
        else:
            _close(a, b)
    assert all(c["k"] is k for c, k in zip(tc2["pre"], pre_k))


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg))


def test_prefill_then_decode_matches_reference_logits(pair):
    """Prefill a 9-token prompt, pad the caches, then 5 decode steps on
    the reference's greedy tokens: every step's logits against the
    reference's ``decode_step``."""
    jcfg, tcfg, jp, tp = pair
    model = get_model(tcfg)
    toks = _tokens(tcfg, (2, 9), 3)
    S, new = 9, 5
    jcache, jl = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with port_routes() as rec:
        tcache, tl = model.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jcache = jax_pad_caches(jax_get_model(jcfg), jcache, 2, S + new)
    tcache = pad_caches(model, tcache, 2, S + new)
    step = _jax_decode(jcfg)
    for i in range(new):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok), S + i)
        with port_routes() as more:
            tl, tcache = model.decode_step(tp, tcache, torch.from_numpy(tok), S + i)
        rec += more
        _close(tl, jl)
    assert_routes_discrete(rec)


# ------------------------------------------------------------------- train
def test_loss_and_gradient_match_reference(pair):
    """loss_fn and its gradient leaf for leaf against jax.grad of the
    reference's, the leading dense block's gradient included (non-zero)."""
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(tcfg, (2, 9), 4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp)]
    with port_routes() as rec:
        tl, tmet = TT.loss_fn(tree_unflatten_like(tp, leaves),
                              {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert_routes_discrete(rec)
    _close(tl.detach(), jl)
    _close(tmet["aux_loss"].detach(), jmet["aux_loss"])
    grads = torch.autograd.grad(tl, leaves)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        _close(g, want, tol=GRAD_TOL)
    pre = tree_leaves(tree_unflatten_like(tp, list(grads))["pre_blocks"])
    assert len(pre) == (9 if tcfg.first_dense else 0)
    assert all(float(g.abs().max()) > 0 for g in pre)


# ----------------------------------------------------------------- serving
def test_make_cache_matches_reference_shapes(pair):
    jcfg, tcfg, _, _ = pair
    want = jax.eval_shape(lambda: JT.make_cache(jcfg, 3, 17))
    got = TT.make_cache(tcfg, 3, 17, device="meta")
    assert len(got["pre"]) == len(want["pre"]) == tcfg.first_dense
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        if isinstance(a, int):
            assert a == 0 and b.dtype == jnp.int32
        else:
            assert tuple(a.shape) == b.shape and a.device.type == "meta"
            assert a.dtype == getattr(torch, str(b.dtype))


def test_scheduler_matches_generate(pair):
    """A BatchScheduler (2 slots, 3 prompts) against generate for each
    prompt alone, at capacity_factor 16: no token drops, so a slot's
    tokens do not depend on its neighbours'."""
    _, tcfg, _, tp = pair
    model = get_model(tcfg.replace(capacity_factor=16.0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 8, 6)]
    sched = BatchScheduler(model, tp, batch_slots=2, max_len=16, device="cpu")
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    done = {r.rid: r for r in sched.run()}
    for i, p in enumerate(prompts):
        want = generate(model, tp, torch.as_tensor(p)[None], 4, device="cpu")
        np.testing.assert_array_equal(done[i].out_tokens, want[0, len(p):].numpy())


# ------------------------------------------------------- federated training
RUN = dict(rounds=2, clients=4, n_priority=2, per_client=2, seq=16,
           local_epochs=2, lr=0.05)
TRAIN_ARCH = "deepseek_moe_16b"
EPS = 0.1               # gates a non-priority client in and one out
GATE_MARGIN = 1e-3
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def reference_run():
    mp = pytest.MonkeyPatch()
    mp.setattr(round_tests, "RUN_KW", RUN)
    try:
        yield round_tests._jax_run(TRAIN_ARCH, {}, EPS)
    finally:
        mp.undo()


def test_train_run_matches_reference(reference_run):
    """deepseek's ``pre_blocks`` list through the spatial round (the
    client stack, fedagg's flattening, the server step): gates exact,
    losses within 1e-5 relative, params within GRAD_TOL per leaf."""
    jp, jh = reference_run
    tp, th = train.run(arch=TRAIN_ARCH, epsilon=EPS, device="cpu",
                       verbose=False, **RUN)
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
    assert len(tp["pre_blocks"]) == 1
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, tol=GRAD_TOL)
