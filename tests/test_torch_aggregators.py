"""The robust and private reducers of the port against the JAX package:
``fedagg_plain`` (mean, dp, trimmed_mean, median) against the reference's
jnp lowering ``repro.kernels.ops.fedagg(use_pallas=False)``, with its
Pallas kernel in interpret mode as a third witness at tiny shapes (C <= 8,
M <= 256); the NaN placement of the bitonic network; the f32 trim count;
zero inclusion; C = 65; and the aggregator layer (``aggregate_clients``
under every aggregator, the dp key, noise and accountant, the inclusion
mass, the cosine filter's sketches and gate rewrites, config checks).

Tolerances, stated per test: f32 sums in another order within 1e-5 of the
largest term; the median picks two sorted values and is exact; bf16
results within one bf16 ulp (both sides round an f32 result)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.fedagg import sort_cols_jnp  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs.base import FedConfig, validate_config  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.kernels import fedagg as fk  # noqa: E402

REDUCERS = ["mean", "dp", "trimmed_mean", "median"]
TINY = [(1, 7), (3, 64), (5, 256), (8, 256)]          # the Pallas witness
LARGER = [(13, 300), (20, 610), (65, 300)]             # jnp lowering only
TRIM = 0.2
NOISE_SCALE = 0.3


def _case(C, M, seed=0, gates="mixed"):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(C, M)).astype(np.float32)
    w = (rng.random(C) + 0.1).astype(np.float32)
    if gates == "none":
        g = np.zeros(C, np.float32)
    else:
        g = (rng.random(C) > 0.3).astype(np.float32)
        g[0] = 1.0
    rs = rng.random(C).astype(np.float32)
    noise = rng.normal(size=M).astype(np.float32)
    return u, w, g, rs, noise


def _kwargs(reducer, rs, noise, framework):
    conv = (lambda a: torch.from_numpy(a)) if framework == "torch" else jnp.asarray
    if reducer == "dp":
        return dict(aggregator="dp", row_scale=conv(rs), noise=conv(noise),
                    noise_scale=NOISE_SCALE)
    if reducer == "trimmed_mean":
        return dict(aggregator="trimmed_mean", trim_frac=TRIM)
    return dict(aggregator=reducer)


def _port(u, w, g, kw, dtype="float32"):
    tu = torch.from_numpy(np.array(u)).to(getattr(torch, dtype))
    out = fk.fedagg_plain(tu, torch.from_numpy(w), torch.from_numpy(g), **kw)
    assert out.dtype == tu.dtype and out.shape == (u.shape[1],)
    return out.float().numpy()


def _scale(reducer, u, w, g, rs, noise):
    """The largest term the reduction can sum: max|u| over the included
    rows (times max row_scale for dp), plus dp's noise term."""
    inc = (g > 0) if reducer in ("trimmed_mean", "median") else (w * g > 0)
    if not inc.any():
        return 0.0
    mag = float(np.nanmax(np.abs(u[inc]))) if np.isfinite(u[inc]).any() else 0.0
    if reducer == "dp":
        mag = mag * float(rs[inc].max()) + (float(np.abs(noise).max())
                                            * NOISE_SCALE / float((w * g)[inc].sum()))
    return mag


def _check(reducer, got, want, u, w, g, rs, noise, dtype):
    """NaN masks equal; the median exact; otherwise f32 within 1e-5 of the
    largest term, bf16 within one bf16 ulp of the reference plus that."""
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    if reducer == "median":
        np.testing.assert_array_equal(got[fin], want[fin])
        return
    tol = 1e-5 * _scale(reducer, u, w, g, rs, noise)
    if dtype == "bfloat16":
        tol = tol + np.exp2(np.floor(np.log2(np.maximum(np.abs(want[fin]),
                                                        2.0 ** -126))) - 7)
    assert np.all(np.abs(got[fin] - want[fin]) <= tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,M", TINY + LARGER)
@pytest.mark.parametrize("reducer", REDUCERS)
def test_plain_matches_reference_lowering_and_pallas(reducer, C, M, dtype):
    u, w, g, rs, noise = _case(C, M, seed=C * 1000 + M)
    ju = jnp.asarray(u).astype(getattr(jnp, dtype))
    u32 = np.asarray(ju.astype(jnp.float32))
    got = _port(u32, w, g, _kwargs(reducer, rs, noise, "torch"), dtype)
    jkw = _kwargs(reducer, rs, noise, "jax")
    wants = [jops.fedagg(ju, jnp.asarray(w), jnp.asarray(g), **jkw)]
    if (C, M) in TINY:
        wants.append(jops.fedagg(ju, jnp.asarray(w), jnp.asarray(g),
                                 use_pallas=True, interpret=True, block_m=128,
                                 **jkw))
    for want in wants:
        assert want.dtype == ju.dtype
        _check(reducer, got, np.asarray(want.astype(jnp.float32)), u32, w, g,
               rs, noise, dtype)


@pytest.mark.parametrize("C", [2, 5, 8, 13])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_network_places_nan_and_inf_as_the_reference(C, seed):
    """The bitonic network with NaN-propagating min/max: bit-identical to
    sort_cols_jnp, NaN, +-inf and the +inf padding included."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C, 64)).astype(np.float32)
    x[rng.random((C, 64)) < 0.08] = np.nan
    x[rng.random((C, 64)) < 0.05] = np.inf
    x[rng.random((C, 64)) < 0.05] = -np.inf
    got = fk.sort_cols_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(sort_cols_jnp(jnp.asarray(x))))


@pytest.mark.parametrize("reducer", ["trimmed_mean", "median"])
@pytest.mark.parametrize("C", [5, 8, 13])
def test_nan_in_included_rows_lands_where_the_reference_puts_it(reducer, C):
    """NaNs in included rows spread through the network; which output
    columns turn NaN, and every other value, match the jnp lowering (and
    Pallas interpret where C <= 8)."""
    u, w, g, rs, noise = _case(C, 96, seed=C)
    g[:] = 1.0
    u[1, ::5] = np.nan
    u[C - 1, 3::11] = np.nan
    got = _port(u, w, g, _kwargs(reducer, rs, noise, "torch"))
    assert np.isnan(got).any() and not np.isnan(got).all()
    jkw = _kwargs(reducer, rs, noise, "jax")
    wants = [jops.fedagg(jnp.asarray(u), jnp.asarray(w), jnp.asarray(g), **jkw)]
    if C <= 8:
        wants.append(jops.fedagg(jnp.asarray(u), jnp.asarray(w), jnp.asarray(g),
                                 use_pallas=True, interpret=True, block_m=128,
                                 **jkw))
    for want in wants:
        _check(reducer, got, np.asarray(want), u, w, g, rs, noise, "float32")


@pytest.mark.parametrize("trim_frac,n,t32,t64", [(0.29, 100, 29, 28),
                                                 (0.35, 180, 63, 62)])
def test_trim_count_is_float32(trim_frac, n, t32, t64):
    """t = int32(float32(trim_frac) * float32(n)), not the float64 product:
    at these (trim_frac, n) the two differ, and so do the trimmed means."""
    assert int(np.float32(trim_frac) * np.float32(n)) == t32
    assert int(trim_frac * n) == t64
    rng = np.random.default_rng(n)
    u = rng.permutation(np.arange(n, dtype=np.float32))[:, None] ** 2
    u = np.repeat(u, 3, axis=1)
    w = np.ones(n, np.float32)
    g = np.ones(n, np.float32)
    got = _port(u, w, g, dict(aggregator="trimmed_mean", trim_frac=trim_frac))
    want = np.asarray(jops.fedagg(jnp.asarray(u), jnp.asarray(w), jnp.asarray(g),
                                  aggregator="trimmed_mean", trim_frac=trim_frac))
    s = np.sort(u[:, 0].astype(np.float64))
    mean32, mean64 = s[t32:n - t32].mean(), s[t64:n - t64].mean()
    assert abs(mean32 - mean64) > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, mean32, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reducer", REDUCERS)
def test_zero_inclusion_gives_exact_zeros(reducer, dtype):
    """No included client: exact (positive) zeros, even with a NaN behind a
    zero gate and a NaN clip scale there."""
    u, w, g, rs, noise = _case(6, 257, gates="none")
    u[3] = np.nan
    rs[3] = np.nan
    got = _port(u, w, g, _kwargs(reducer, rs, noise, "torch"), dtype)
    assert np.all(got == 0.0) and not np.any(np.signbit(got))


@pytest.mark.parametrize("reducer", REDUCERS)
def test_nan_in_gated_out_row_does_not_leak(reducer):
    u, w, g, rs, noise = _case(7, 200)
    g[3] = 0.0
    u[3] = np.nan
    rs[3] = np.nan
    got = _port(u, w, g, _kwargs(reducer, rs, noise, "torch"))
    assert np.all(np.isfinite(got))
    jkw = _kwargs(reducer, rs, noise, "jax")
    want = jops.fedagg(jnp.asarray(u), jnp.asarray(w), jnp.asarray(g), **jkw)
    _check(reducer, got, np.asarray(want), u, w, g, rs, noise, "float32")


def test_sorted_reducers_count_zero_weight_clients():
    """trimmed_mean and median are unweighted over gate > 0: a client with
    weight 0 still moves the median (and the mean ignores it)."""
    u = np.array([[1.0], [2.0], [10.0]], np.float32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    g = np.ones(3, np.float32)
    assert _port(u, w, g, dict(aggregator="median"))[0] == 2.0
    assert _port(u, w, g, dict(aggregator="mean"))[0] == 1.5


# ============================================================ aggregator layer
SHAPES = {"b1": (13,), "scale": (), "w1": (7, 13), "w2": (13, 3)}


def _tree(C, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(C,) + s) * (1 + 0.2 * np.arange(C).reshape(
        (C,) + (1,) * len(s)))).astype(dtype) for k, s in SHAPES.items()}


def _wg(C, seed=1):
    rng = np.random.default_rng(seed)
    w = (rng.random(C) + 0.1).astype(np.float32)
    g = (rng.random(C) > 0.4).astype(np.float32)
    g[0] = 1.0
    return w, g


def _feds(name, **kw):
    base = dict(num_clients=6, num_priority=2, aggregator=name, trim_frac=0.25,
                dp_clip=2.0, dp_noise=0.25, outlier_cos=-0.5, sketch_dim=32)
    base.update(kw)
    return JaxFedConfig(**base), FedConfig(**base)


def _keys(name, jfed, fed, round_idx=3):
    if not jagg.get_aggregator(name).needs_key:
        return None, None
    return jagg.aggregator_key(jfed, round_idx), agg.aggregator_key(fed, round_idx)


def _to_t(tree, dtype="float32"):
    return {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
            for k, v in tree.items()}


def test_registry_contract():
    assert agg.AGGREGATORS.names() == sorted(jagg.AGGREGATORS.names())
    for name in agg.AGGREGATORS.names():
        mine, ref = agg.get_aggregator(name), jagg.get_aggregator(name)
        assert (mine.agg_name, mine.needs_key, mine.in_kernel) == (
            ref.agg_name, ref.needs_key, ref.in_kernel)
    assert agg.resolve_aggregator(None) == agg.resolve_aggregator("none") == "mean"
    with pytest.raises(ValueError, match="registered"):
        agg.get_aggregator("krum")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mean", "trimmed_mean", "median", "dp",
                                  "cosine_filter"])
def test_aggregate_clients_matches_reference(name, dtype, fused):
    """aggregate_clients under every aggregator, on the same tree, weights,
    gates and round key. f32: within 1e-5 of the largest term (dp's noise
    is within 3 ulp of jax's draw, far inside that); bf16: one bf16 ulp of
    the reference plus that."""
    tree = _tree(6, seed=5, dtype=np.float32)
    if dtype == "bfloat16":
        tree = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                              .astype(jnp.float32)) for k, v in tree.items()}
    w, g = _wg(6)
    jfed, fed = _feds(name)
    jkey, tkey = _keys(name, jfed, fed)
    want = jagg.aggregate_clients(
        {k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in tree.items()},
        jnp.asarray(w), jnp.asarray(g), fused=fused, aggregator=name, fed=jfed,
        key=jkey)
    got = agg.aggregate_clients(_to_t(tree, dtype), torch.from_numpy(w),
                                torch.from_numpy(g), fused=fused,
                                aggregator=name, fed=fed, key=tkey)
    mag = max(float(np.abs(v).max()) for v in tree.values())
    if name == "dp":
        mag += 4.0 * 0.25 * 2.0 / float((w * g).sum())
    for k in SHAPES:
        a = got[k].float().numpy()
        b = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
        assert got[k].dtype == getattr(torch, dtype) and a.shape == b.shape
        tol = 1e-5 * mag
        if dtype == "bfloat16":
            tol = tol + np.exp2(np.floor(np.log2(np.maximum(np.abs(b),
                                                            2.0 ** -126))) - 7)
        assert np.all(np.abs(a - b) <= tol), k


def test_dp_key_noise_and_clip_scales_match_reference():
    """The round key bit for bit, the [M] noise within 3 ulp of
    jax.random.normal (see test_torch_prng), the clip scales to f32
    rounding of the norms."""
    jfed, fed = _feds("dp")
    for r in (0, 1, 17):
        np.testing.assert_array_equal(
            agg.aggregator_key(fed, r).numpy(),
            np.asarray(jax.random.key_data(jagg.aggregator_key(jfed, r))))
    tree = _tree(6, seed=2)
    w, g = _wg(6)
    jkey, tkey = _keys("dp", jfed, fed)
    _, _, jkw, jnoise = jagg.get_aggregator("dp")(
        jfed, jax.tree.map(jnp.asarray, tree), jnp.asarray(w), jnp.asarray(g),
        jkey)
    _, _, tkw, tnoise = agg.get_aggregator("dp")(
        fed, _to_t(tree), torch.from_numpy(w), torch.from_numpy(g), tkey)
    a = tnoise.numpy()
    b = np.asarray(jnoise)
    ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    assert a.shape == b.shape and ulps.max() <= 3
    np.testing.assert_allclose(tkw["row_scale"].numpy(),
                               np.asarray(jkw["row_scale"]), rtol=1e-6)
    assert tkw["noise_scale"] == jkw["noise_scale"]


def test_dp_needs_the_round_key_and_non_mean_needs_fed():
    tree = _to_t(_tree(6))
    w, g = (torch.from_numpy(a) for a in _wg(6))
    _, fed = _feds("dp")
    with pytest.raises(ValueError, match="aggregator_key"):
        agg.aggregate_clients(tree, w, g, aggregator="dp", fed=fed)
    with pytest.raises(ValueError, match="fed="):
        agg.aggregate_clients(tree, w, g, aggregator="median")


def test_dp_per_leaf_slices_one_noise_draw():
    """fused and per-leaf dp read the same [M_total] draw: equal to f32
    rounding of the sums."""
    tree = _to_t(_tree(6, seed=9))
    w, g = (torch.from_numpy(a) for a in _wg(6))
    _, fed = _feds("dp")
    key = agg.aggregator_key(fed, 4)
    a = agg.aggregate_clients(tree, w, g, fused=True, aggregator="dp", fed=fed,
                              key=key)
    b = agg.aggregate_clients(tree, w, g, fused=False, aggregator="dp", fed=fed,
                              key=key)
    for k in SHAPES:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("z,steps,delta", [(1.0, 1, 1e-5), (0.5, 10, 1e-6),
                                           (2.0, 1000, 1e-5), (0.0, 5, 1e-5),
                                           (1.0, 0, 1e-5)])
def test_dp_epsilon_matches_reference(z, steps, delta):
    assert agg.dp_epsilon(z, steps, delta) == jagg.dp_epsilon(z, steps, delta)
    if (z, steps, delta) == (1.0, 1, 1e-5):
        eps, _ = agg.dp_epsilon(z, steps, delta)
        assert 5.2 < eps < 5.4                  # the accountant's anchor


@pytest.mark.parametrize("name,noise", [("dp", 0.7), ("dp", 0.0),
                                        ("mean", 0.7), ("median", 0.7)])
def test_dp_report_matches_reference(name, noise):
    jfed, fed = _feds(name, dp_noise=noise, dp_delta=1e-6)
    assert agg.dp_report(fed, 12) == jagg.dp_report(jfed, 12)


@pytest.mark.parametrize("name", ["mean", "trimmed_mean", "median", "dp",
                                  "cosine_filter"])
def test_inclusion_mass_per_aggregator(name):
    """mean / dp / cosine_filter: sum p_k I_k; the order statistics: the
    included count, so a zero-weight included client still counts."""
    w = np.array([0.0, 0.5, 0.25, 0.0], np.float32)
    g = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    jfed, fed = _feds(name)
    got = float(agg.inclusion_mass(fed, torch.from_numpy(w), torch.from_numpy(g)))
    assert got == float(jagg.inclusion_mass(jfed, jnp.asarray(w), jnp.asarray(g)))


@pytest.mark.parametrize("knobs,match", [
    (dict(aggregator="trimmed_mean", trim_frac=0.5), "trim_frac"),
    (dict(aggregator="dp", dp_clip=0.0), "dp_clip"),
    (dict(aggregator="dp", dp_noise=-1.0), "dp_noise"),
    (dict(aggregator="cosine_filter", outlier_cos=1.5), "outlier_cos"),
    (dict(aggregator="cosine_filter", sketch_dim=0), "sketch_dim"),
    (dict(aggregator="krum"), "aggregator")])
def test_check_aggregator_config_rejects_as_the_reference(knobs, match):
    for cfg, validate in ((JaxFedConfig(**knobs), jagg.check_aggregator_config),
                          (FedConfig(**knobs), validate_config)):
        with pytest.raises(ValueError, match=match):
            validate(cfg)


@pytest.mark.parametrize("dim", [16, 64])
def test_delta_sketch_matches_reference(dim):
    """CountSketch of each client's delta: the hash and sign streams bit for
    bit, the bucket sums to f32 rounding (another summation order)."""
    tree = _tree(5, seed=3)
    key = jax.random.PRNGKey(11)
    want = jax.vmap(lambda d: jengine.delta_sketch(d, key, dim))(
        jax.tree.map(jnp.asarray, tree))
    got = engine.delta_sketch(_to_t(tree), prng.PRNGKey(11), dim)
    assert got.shape == (5, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_cosine_filter_drops_the_outlier_as_the_reference():
    """A client whose delta points against the cohort loses its gate in
    both packages; the others keep theirs."""
    rng = np.random.default_rng(4)
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tree = {k: np.stack([v + 0.3 * rng.normal(size=v.shape).astype(np.float32)
                         for _ in range(6)]) for k, v in base.items()}
    for k in tree:
        tree[k][4] = -3.0 * tree[k][4]
    w = np.full(6, 0.5, np.float32)
    g = np.ones(6, np.float32)
    jfed, fed = _feds("cosine_filter", outlier_cos=0.0, sketch_dim=64)
    _, jg, _, _ = jagg.get_aggregator("cosine_filter")(
        jfed, jax.tree.map(jnp.asarray, tree), jnp.asarray(w), jnp.asarray(g),
        None)
    _, tg, _, _ = agg.get_aggregator("cosine_filter")(
        fed, _to_t(tree), torch.from_numpy(w), torch.from_numpy(g), None)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tg.numpy().tolist() == [1, 1, 1, 1, 0, 1]
