"""The port's MLA (multi-head latent attention) and minicpm3-4b against the
JAX package on the CPU, in f32 at smoke size: the config mirror,
``init_mla`` and the model's key tree, ``mla_attention_block`` in train,
prefill and decode (with and without a sliding window), the absorbed
decode over several steps with the ring cache past its window, ``forward``
in three modes, prefill then decode against the reference's
``decode_step`` logits, ``loss_fn`` and its gradient against
``jax.grad``, the cache's shapes, dtypes and bytes, the scheduler against
``generate``, and ``launch.train.run`` against the reference's loop.

Tolerances: PARITY x max(1, max|want|) for activations, caches and
logits (as tests/test_torch_lm.py); gradients 1e-4 of each leaf's largest
magnitude (tests/test_torch_jamba.py); the absorbed decode against the
port's own expanded path (train mode) at tests/test_serve.py's atol 5e-4
+ rtol 5e-3; the training run as tests/test_torch_jamba_train.py."""
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
from repro.launch.serve import pad_caches as jax_pad_caches  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.serve import generate, pad_caches  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import BatchScheduler, Request  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten_like  # noqa: E402

ARCH = "minicpm3_4b"
PARITY = 2e-5
GRAD_TOL = 1e-4
SERVE = dict(atol=5e-4, rtol=5e-3)


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


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["periods"]["l0"]["attn"]),
            tree_map(lambda a: a[0], tp["periods"]["l0"]["attn"]))


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
    full = get_config("minicpm3-4b")
    assert full.mla and full.qk_nope_head_dim + full.qk_rope_head_dim == 96


# -------------------------------------------------------------------- init
def test_init_mla_and_the_model_key_tree(pair):
    """``init_mla`` on its own key, and the whole model's tree, leaf for
    leaf within 4 ulp (tests/test_torch_lm.py)."""
    jcfg, tcfg, jp, _ = pair
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    tkey = prng.fold_in(prng.PRNGKey(3), 7)
    for mine, want in ((TA.init_mla(tkey, tcfg), JA.init_mla(jkey, jcfg)),
                       (TT.init(prng.PRNGKey(0), tcfg, device="cpu"), jp)):
        mine, want = params_to_numpy(mine), jax.tree.map(np.asarray, want)
        assert jax.tree.structure(mine) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert _ulps(a, b).max() <= 4
    p = params_to_numpy(TA.init_mla(tkey, tcfg))
    H, r = tcfg.num_heads, tcfg.kv_lora_rank
    assert p["wkv_b"].shape == (r, H * (tcfg.qk_nope_head_dim + tcfg.v_head_dim))
    assert np.all(p["q_norm"]["scale"] == 1) and np.all(p["kv_norm"]["scale"] == 1)


# --------------------------------------------------------------- the block
@pytest.mark.parametrize("window", [0, 4])
def test_mla_block_three_modes(pair, window):
    """Train and prefill outputs, the prefill cache (the ring layout under
    a window, S = 9 > 4), then one absorbed decode step into it: the
    output, the written latent and roped-key rows, and ``len``."""
    jcfg, tcfg, jp, tp = pair
    jcfg, tcfg = (c.replace(sliding_window=window) for c in (jcfg, tcfg))
    jl0, tl0 = _layer0(jp, tp)
    x = np.random.default_rng(1).normal(size=(2, 10, tcfg.d_model)).astype(np.float32)
    S = 9
    pos = np.arange(S)
    for mode in ("train", "prefill"):
        jy, jc = JA.mla_attention_block(jl0, jnp.asarray(x[:, :S]), jcfg,
                                        positions=jnp.asarray(pos), mode=mode)
        ty, tc = TA.mla_attention_block(tl0, torch.from_numpy(x[:, :S]), tcfg,
                                        positions=torch.from_numpy(pos), mode=mode)
        _close(ty, jy)
    for name in ("c_kv", "k_rope"):
        _close(tc[name], jc[name])
    assert tc["len"] == int(jc["len"]) == (window or S)
    if not window:                       # room for the step's row
        jc = {n: jnp.pad(jc[n], ((0, 0), (0, 1), (0, 0))) for n in ("c_kv", "k_rope")}
        tc = {n: torch.nn.functional.pad(tc[n], (0, 0, 0, 1)) for n in ("c_kv", "k_rope")}
    jy, jc2 = JA.mla_attention_block(jl0, jnp.asarray(x[:, S:]), jcfg,
                                     positions=jnp.asarray([S]), mode="decode", cache=jc)
    ty, tc2 = TA.mla_attention_block(tl0, torch.from_numpy(x[:, S:]), tcfg,
                                     positions=torch.tensor([S]), mode="decode",
                                     cache=tc, pos=S)
    _close(ty, jy)
    for name in ("c_kv", "k_rope"):
        _close(tc2[name], jc2[name])
        assert tc2[name] is tc[name]                 # written in place
    assert tc2["len"] == int(jc2["len"])


def test_absorbed_decode_steps_with_a_window(pair):
    """Prefill 7 positions into a ring of W = 4, then 6 absorbed decode
    steps (the ring wraps twice): every step's output and cache against the
    reference's; and each step's output against the port's own expanded
    (train-mode) attention over the same window at that position."""
    jcfg, tcfg, jp, tp = pair
    jcfg, tcfg = (c.replace(sliding_window=4) for c in (jcfg, tcfg))
    jl0, tl0 = _layer0(jp, tp)
    S, steps = 7, 6
    x = np.random.default_rng(5).normal(size=(2, S + steps, tcfg.d_model)).astype(np.float32)
    _, jc = JA.mla_attention_block(jl0, jnp.asarray(x[:, :S]), jcfg,
                                   positions=jnp.arange(S), mode="prefill")
    _, tc = TA.mla_attention_block(tl0, torch.from_numpy(x[:, :S]), tcfg,
                                   positions=torch.arange(S), mode="prefill")
    full, _ = TA.mla_attention_block(tl0, torch.from_numpy(x), tcfg,
                                     positions=torch.arange(S + steps), mode="train")
    for t in range(S, S + steps):
        jy, jc = JA.mla_attention_block(jl0, jnp.asarray(x[:, t:t + 1]), jcfg,
                                        positions=jnp.asarray([t]), mode="decode",
                                        cache=jc)
        ty, tc = TA.mla_attention_block(tl0, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                        positions=torch.tensor([t]), mode="decode",
                                        cache=tc, pos=t)
        _close(ty, jy)
        for name in ("c_kv", "k_rope"):
            _close(tc[name], jc[name])
        assert tc["len"] == int(jc["len"]) == 4
        np.testing.assert_allclose(ty[:, 0].numpy(), full[:, t].numpy(), **SERVE)


def test_latent_norm_gets_contiguous_rows(pair, monkeypatch):
    """On the card the RMSNorm kernel refuses strided rows; the latent
    slice of ``kv_a`` (row pitch kv_lora_rank + rope) is made contiguous
    before the norm, in every mode."""
    _, tcfg, _, tp = pair
    tl0 = tree_map(lambda a: a[0], tp["periods"]["l0"]["attn"])
    seen = []
    orig = TL.kops.rmsnorm

    def strict(x, scale, **kw):
        seen.append(x.shape[-1])
        assert x.is_contiguous()
        return orig(x, scale, **kw)
    monkeypatch.setattr(TL.kops, "rmsnorm", strict)
    x = torch.randn(2, 5, tcfg.d_model)
    _, c = TA.mla_attention_block(tl0, x, tcfg, positions=torch.arange(5), mode="prefill")
    TA.mla_attention_block(tl0, x, tcfg, positions=torch.arange(5), mode="train")
    c = {n: torch.nn.functional.pad(c[n], (0, 0, 0, 1)) for n in ("c_kv", "k_rope")}
    TA.mla_attention_block(tl0, x[:, :1], tcfg, positions=torch.tensor([5]),
                           mode="decode", cache=c, pos=5)
    assert seen == [tcfg.q_lora_rank, tcfg.kv_lora_rank] * 3


# ------------------------------------------------------------------ model
def test_forward_three_modes(pair):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(tcfg, (2, 11), 2)
    jh, _, _ = JT.forward(jp, jnp.asarray(toks), jcfg, mode="train")
    th, tc, aux = TT.forward(tp, torch.from_numpy(toks), tcfg, mode="train")
    assert tc is None and aux == 0.0
    _close(th, jh)
    jh, jc, _ = JT.forward(jp, jnp.asarray(toks[:, :10]), jcfg, mode="prefill")
    th, tc, _ = TT.forward(tp, torch.from_numpy(toks[:, :10]), tcfg, mode="prefill")
    _close(th, jh)
    assert tc["pre"] == [] and set(tc["periods"]["l0"]) == {"c_kv", "k_rope", "len"}
    for name in ("c_kv", "k_rope"):
        _close(tc["periods"]["l0"][name], jc["periods"]["l0"][name])
    jcp = jax_pad_caches(jax_get_model(jcfg), jc, 2, 11)
    tcp = pad_caches(get_model(tcfg), tc, 2, 11)
    jh, jc2, _ = JT.forward(jp, jnp.asarray(toks[:, 10:]), jcfg, mode="decode",
                            positions=jnp.asarray([10]), caches=jcp)
    th, tc2, _ = TT.forward(tp, torch.from_numpy(toks[:, 10:]), tcfg, mode="decode",
                            positions=torch.tensor([10]), caches=tcp, pos=10)
    _close(th, jh)
    for name in ("c_kv", "k_rope"):
        _close(tc2["periods"]["l0"][name], jc2["periods"]["l0"][name])
    assert tc2["periods"]["l0"]["len"] == 11


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg))


@pytest.mark.parametrize("window", [0, 6])
def test_prefill_then_decode_matches_reference_logits(pair, window):
    """Prefill a 9-token prompt, then 5 decode steps on the reference's
    greedy tokens (under a window of 6 the ring wraps): every step's
    logits against the reference's ``decode_step``."""
    jcfg, tcfg, jp, tp = pair
    jcfg, tcfg = (c.replace(sliding_window=window) for c in (jcfg, tcfg))
    model = get_model(tcfg)
    toks = _tokens(tcfg, (2, 9), 3)
    S, new = 9, 5
    jcache, jl = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tcache, tl = model.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jcache = jax_pad_caches(jax_get_model(jcfg), jcache, 2, S + new)
    tcache = pad_caches(model, tcache, 2, S + new)
    step = _jax_decode(jcfg)
    for i in range(new):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jcache = step(jp, jcache, jnp.asarray(tok), S + i)
        tl, tcache = model.decode_step(tp, tcache, torch.from_numpy(tok), S + i)
        _close(tl, jl)


def test_loss_and_gradient_match_reference(pair):
    jcfg, tcfg, jp, tp = pair
    toks = _tokens(tcfg, (2, 9), 4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jb, jcfg)[0]))(jp)
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl, _ = TT.loss_fn(tree_unflatten_like(tp, leaves),
                       {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    _close(tl.detach(), jl)
    grads = torch.autograd.grad(tl, leaves)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        _close(g, want, tol=GRAD_TOL)
    attn = tree_unflatten_like(tp, list(grads))["periods"]["l0"]["attn"]
    assert set(attn) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(attn))


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_shapes_dtypes_and_bytes(pair, dtype):
    """The latent cache against the reference's ``jax.eval_shape``, in the
    compute dtype; its bytes a token beside an expanded k / v cache's
    (full width: 35.7 KB a token at bf16 over 62 layers, against 794 KB
    for k at head dim 96 and v at 64)."""
    jcfg, tcfg, _, _ = pair
    jcfg, tcfg = (c.replace(compute_dtype=dtype) for c in (jcfg, tcfg))
    want = jax.eval_shape(lambda: JT.make_cache(jcfg, 3, 17))
    got = TT.make_cache(tcfg, 3, 17, device="meta")
    assert got["pre"] == [] and set(got["periods"]["l0"]) == {"c_kv", "k_rope", "len"}
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        if isinstance(a, int):
            assert a == 0
        else:
            assert tuple(a.shape) == b.shape and a.dtype == getattr(torch, dtype)
    full = get_config("minicpm3-4b").replace(compute_dtype=dtype)
    c = TT.make_cache(full, 1, 1, device="meta")["periods"]["l0"]
    size = c["c_kv"].element_size()
    # one row of one sequence in every layer's stacked [62, 1, 1, ...] cache
    per_token = sum(t.numel() * t.element_size() for t in (c["c_kv"], c["k_rope"]))
    # k at nope + rope, v at v_head_dim, for every head of every layer
    expanded = (full.num_layers * full.num_heads * size
                * (full.qk_nope_head_dim + full.qk_rope_head_dim + full.v_head_dim))
    assert per_token == 62 * (256 + 32) * size
    assert expanded == 62 * 40 * (96 + 64) * size
    if dtype == "bfloat16":
        assert (per_token, expanded) == (35_712, 793_600)


def test_scheduler_matches_generate_and_serve_main(pair, capsys):
    _, tcfg, _, tp = pair
    model = get_model(tcfg)
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
    toks = serve.main(["--arch", "minicpm3-4b", "--batch", "2", "--prompt-len", "5",
                       "--gen", "3", "--device", "cpu"])
    assert toks.shape == (2, 8)
    assert "minicpm3-4b: generated 2x3 tokens" in capsys.readouterr().out


# ------------------------------------------------------- federated training
RUN = dict(rounds=2, clients=4, n_priority=2, per_client=2, seq=16,
           local_epochs=2, lr=0.05)
EPS = 0.012             # gates a non-priority client in and one out
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
    """MLA through the spatial round and its gradients: gates exact,
    losses within 1e-5 relative, params within GRAD_TOL per leaf."""
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
