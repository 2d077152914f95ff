"""The port's dense LM against the JAX package on the CPU, in f32 at smoke
size: the truncated-normal draw, the init's key tree, trees that hold
lists, the layers, the GQA block and ``forward`` in train, prefill and
decode modes.

Tolerance for activations and logits: PARITY, about ten chained f32
products of K <= 512 terms, each off by ~sqrt(K) 2^-24 relative when the
sums run in another order (~1.3e-5 in all), times the largest magnitude
compared (at least 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten_like  # noqa: E402

PARITY = 2e-5
ARCHS = ["qwen1_5_0_5b", "qwen2_5_3b", "phi3_mini_3_8b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors, where torch's intra-op thread pool costs more
    than it saves, badly so with several test workers on the host's cores:
    one thread for the module, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, port cfg, jax params, port params carried across)."""
    jcfg = jax_get_smoke(request.param).replace(remat=False)
    tcfg = get_smoke(request.param)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------------------ prng
@pytest.mark.parametrize("seed,shape", [(0, (1000, 37)), (3, (5,)), (7, (200_000,)),
                                        (11, (64, 3, 8))])
def test_truncated_normal_within_three_ulp(seed, shape):
    """XLA's erf_inv polynomial and fused multiply-adds are reproduced, its
    log1p is not: at most 3 ulp on < 2% of draws (as prng.normal)."""
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2.0,
                                                  2.0, shape, jnp.float32))
    got = prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    u = _ulps(got, want)
    assert u.max() <= 3
    assert np.mean(u > 0) < 0.02
    assert np.all(np.abs(got) < 2.0)


@pytest.mark.parametrize("lo,hi", [(-2.0, 2.0), (-1.0, 0.5), (-3.0, 3.0)])
def test_truncated_normal_other_bounds(lo, hi):
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(5), lo, hi,
                                                  (20_000,), jnp.float32))
    got = prng.truncated_normal(prng.PRNGKey(5), lo, hi, (20_000,)).numpy()
    assert _ulps(got, want).max() <= 3
    assert got.min() > lo and got.max() < hi


def test_truncated_normal_chunks_give_one_pass(monkeypatch):
    key = prng.fold_in(prng.PRNGKey(1), 9)
    whole = prng.truncated_normal(key, -2.0, 2.0, (37, 29))
    monkeypatch.setattr(prng, "_TRUNC_CHUNK", 100)
    assert torch.equal(prng.truncated_normal(key, -2.0, 2.0, (37, 29)), whole)


# ------------------------------------------------------------------ trees
def test_trees_walk_lists_and_tuples_in_order():
    tree = {"b": [torch.tensor(1.0), (torch.tensor(2.0), torch.tensor(3.0))],
            "a": torch.tensor(0.0), "c": [], "d": ()}
    leaves = tree_leaves(tree)
    assert [float(x) for x in leaves] == [0.0, 1.0, 2.0, 3.0]
    doubled = tree_map(lambda x: 2 * x, tree)
    assert doubled["c"] == [] and doubled["d"] == ()
    assert isinstance(doubled["b"], list) and isinstance(doubled["b"][1], tuple)
    rebuilt = tree_unflatten_like(tree, [x + 1 for x in leaves])
    assert [float(x) for x in tree_leaves(rebuilt)] == [1.0, 2.0, 3.0, 4.0]
    assert rebuilt["c"] == [] and isinstance(rebuilt["b"][1], tuple)
    # the order jax uses
    jl = jax.tree.leaves({"b": [1.0, (2.0, 3.0)], "a": 0.0, "c": [], "d": ()})
    assert jl == [0.0, 1.0, 2.0, 3.0]


def test_lm_params_round_trip_through_numpy(pair):
    jcfg, _, jp, tp = pair
    assert tp["pre_blocks"] == []
    want = jax.tree.map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tp["periods"]["l0"]["attn"]["wq"].shape[0] == jcfg.n_periods


# ------------------------------------------------------------------ init
def test_init_matches_the_reference_key_tree(pair):
    """The port draws its own weights (the card's machine has no JAX): the
    same key tree, leaf for leaf, within 4 ulp (3 from the draw's erf_inv,
    one more from the scale's rounding)."""
    jcfg, tcfg, jp, _ = pair
    mine = TT.init(prng.PRNGKey(0), tcfg, device="cpu")
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(mine)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _ulps(a, b).max() <= 4


def test_model_config_mirror_gives_the_same_smoke_configs():
    for arch in ARCHS:
        j, t = jax_get_smoke(arch), get_smoke(arch)
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
        assert t.pdtype == getattr(torch, j.param_dtype)
        assert t.cdtype == getattr(torch, j.compute_dtype)
        assert t.n_periods == j.n_periods and t.layer_kinds() == j.layer_kinds()


# ------------------------------------------------------------------ layers
def test_rope_rmsnorm_swiglu_match(pair):
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    pos = np.arange(3, 10)
    xh = rng.normal(size=(2, 7, tcfg.num_heads, tcfg.head_dim)).astype(np.float32)
    _close(TL.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), tcfg.rope_theta),
           JL.apply_rope(jnp.asarray(xh), jnp.asarray(pos), jcfg.rope_theta))
    p1 = jax.tree.map(lambda a: a[0], jp["periods"]["l0"])
    t1 = tree_map(lambda a: a[0], tp["periods"]["l0"])
    _close(TL.rmsnorm(t1["norm1"], torch.from_numpy(x)),
           JL.rmsnorm(p1["norm1"], jnp.asarray(x)))
    _close(TL.swiglu_apply(t1["mlp"], torch.from_numpy(x), tcfg.cdtype),
           JL.swiglu_apply(p1["mlp"], jnp.asarray(x), jcfg.cdtype))


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("window", [0, 4])
def test_gqa_attention_block_three_modes(pair, window):
    jcfg, tcfg, jp, tp = pair
    jcfg, tcfg = (c.replace(sliding_window=window) for c in (jcfg, tcfg))
    p1 = jax.tree.map(lambda a: a[0], jp["periods"]["l0"]["attn"])
    t1 = tree_map(lambda a: a[0], tp["periods"]["l0"]["attn"])
    rng = np.random.default_rng(1)
    S = 9
    x = rng.normal(size=(2, S + 1, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    for mode in ("train", "prefill"):
        jy, jc = JA.gqa_attention_block(p1, jnp.asarray(x[:, :S]), jcfg,
                                        positions=jnp.asarray(pos), mode=mode)
        ty, tc = TA.gqa_attention_block(t1, torch.from_numpy(x[:, :S]), tcfg,
                                        positions=torch.from_numpy(pos), mode=mode)
        _close(ty, jy)
    # the prefill cache: the ring layout under a window
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    assert tc["len"] == int(jc["len"])
    # one decode step at position S into a cache padded by one row
    W = jc["k"].shape[1]
    if not window:
        jc = {n: jnp.pad(jc[n], ((0, 0), (0, 1), (0, 0), (0, 0))) for n in ("k", "v")}
        tc = {n: torch.nn.functional.pad(tc[n], (0, 0, 0, 0, 0, 1)) for n in ("k", "v")}
        W += 1
    jy, jc2 = JA.gqa_attention_block(p1, jnp.asarray(x[:, S:]), jcfg,
                                     positions=jnp.asarray([S]), mode="decode",
                                     cache=jc)
    ty, tc2 = TA.gqa_attention_block(t1, torch.from_numpy(x[:, S:]), tcfg,
                                     positions=torch.tensor([S]), mode="decode",
                                     cache=tc, pos=S)
    _close(ty, jy)
    for name in ("k", "v"):
        _close(tc2[name], jc2[name])
    assert tc2["len"] == int(jc2["len"]) == min(S + 1, W)


# ----------------------------------------------------------------- forward
def test_forward_three_modes(pair):
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, size=(2, 11))
    jh, jcache, _ = JT.forward(jp, jnp.asarray(toks), jcfg, mode="train")
    th, tcache, aux = TT.forward(tp, torch.from_numpy(toks), tcfg, mode="train")
    assert jcache is None and tcache is None and aux == 0.0
    _close(th, jh)
    jh, jcache, _ = JT.forward(jp, jnp.asarray(toks[:, :10]), jcfg, mode="prefill")
    th, tcache, _ = TT.forward(tp, torch.from_numpy(toks[:, :10]), tcfg, mode="prefill")
    _close(th, jh)
    assert jcache["pre"] == [] and tcache["pre"] == []
    for name in ("k", "v"):
        _close(tcache["periods"]["l0"][name], jcache["periods"]["l0"][name])
    assert tcache["periods"]["l0"]["len"] == int(jcache["periods"]["l0"]["len"][0])
    full_j = JT.make_cache(jcfg, 2, 11)
    full_t = TT.make_cache(tcfg, 2, 11, device="cpu")
    assert tuple(full_t["periods"]["l0"]["k"].shape) == full_j["periods"]["l0"]["k"].shape
    assert full_t["periods"]["l0"]["k"].dtype == tcfg.cdtype
    jc = jax.tree.map(lambda f, c: jnp.pad(c, [(0, a - b) for a, b in zip(f.shape, c.shape)]),
                      full_j, jcache)
    for name in ("k", "v"):
        full_t["periods"]["l0"][name][:, :, :10] = tcache["periods"]["l0"][name]
    full_t["periods"]["l0"]["len"] = tcache["periods"]["l0"]["len"]
    jh, jc, _ = JT.forward(jp, jnp.asarray(toks[:, 10:]), jcfg, mode="decode",
                           positions=jnp.asarray([10]), caches=jc)
    th, tc, _ = TT.forward(tp, torch.from_numpy(toks[:, 10:]), tcfg, mode="decode",
                           positions=torch.tensor([10]), caches=full_t, pos=10)
    _close(th, jh)
    for name in ("k", "v"):
        _close(tc["periods"]["l0"][name], jc["periods"]["l0"][name])
    assert tc["periods"]["l0"]["len"] == 11


def test_prefill_and_decode_step_logits(pair):
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, size=(2, 8))
    jc, jl = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tc, tl = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_size)
    _close(tl, jl)
