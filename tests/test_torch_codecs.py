"""The wire codecs of the port against the JAX package: encode (int8 rows
and scales exact, top-k index sets and tie order exact, sketch hash/sign
planes bit for bit), decode, every reducer x codec pair through
``fedagg_plain`` against the reference's jnp lowering (Pallas interpret
as a third witness at C <= 8, M <= 256), the coded ``aggregate_clients``
with its error-feedback rows (which rows advance: transmitted and
finite), ``wire_bytes_per_round`` and the config checks.

Tolerances, stated per test: what both sides compute the same way is
compared exactly; f32 sums taken in another order within 1e-5 of the
largest term (the sketch's bucket sums and every reduction)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.base import FedConfig, validate_config  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.kernels import fedagg as fk  # noqa: E402

CODECS = ["int8", "topk", "sketch"]
REDUCERS = ["mean", "dp", "trimmed_mean", "median"]


def _feds(**kw):
    base = dict(num_clients=6, num_priority=2, codec_topk_frac=0.1,
                codec_sketch_dim=32, trim_frac=0.25, dp_clip=2.0,
                dp_noise=0.25)
    base.update(kw)
    return JaxFedConfig(**base), FedConfig(**base)


def _buf(C, M, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, M)) * (1 + np.arange(C))[:, None]).astype(np.float32)


def _torch_kw(kw):
    return {k: (torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v)
            for k, v in kw.items()}


# ================================================================= encode
@pytest.mark.parametrize("M,dim", [(1, 4), (610, 32), (5000, 2048)])
@pytest.mark.parametrize("seed", [0, 3, -7])
def test_wire_sketch_streams_bit_exact(M, dim, seed):
    jfed, fed = _feds(codec_sketch_dim=dim, seed=seed)
    jh, js = jagg.wire_sketch_streams(jfed, M)
    th, ts = agg.wire_sketch_streams(fed, M)
    assert th.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("C,M", [(3, 50), (6, 610), (9, 1031)])
def test_int8_encode_matches_reference(C, M):
    """q and the per-row scale exactly, an all-zero row (scale 1.0) and
    round-half-to-even ties included; the rows start 16-byte aligned."""
    x = _buf(C, M, seed=C)
    x[1] = 0.0
    x[2, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[2, 6:] = 0.0
    jfed, fed = _feds()
    jq, jkw = jagg.get_wire_codec("int8").encode(jfed, jnp.asarray(x))
    tq, tkw = agg.get_wire_codec("int8").encode(fed, torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tq.stride(0) % 16 == 0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tkw["dequant_scale"].numpy(),
                                  np.asarray(jkw["dequant_scale"]))
    assert tkw["dequant_scale"][1] == 1.0
    assert tq[2, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_topk_encode_matches_reference_with_ties(frac):
    """The kept (index, value) pairs are the reference's top_k, ties broken
    toward the lower index: rows with runs of exact zeros (dead units) and
    equal magnitudes of both signs. The port sends them sorted by index."""
    rng = np.random.default_rng(1)
    x = _buf(5, 400, seed=1)
    x[0, 100:] = 0.0                            # many zero ties
    x[1, ::3] = 2.0
    x[1, 1::3] = -2.0                           # equal magnitudes
    x[2] = np.round(rng.normal(size=400)).astype(np.float32)
    jfed, fed = _feds(codec_topk_frac=frac)
    jv, jkw = jagg.get_wire_codec("topk").encode(jfed, jnp.asarray(x))
    tv, tkw = agg.get_wire_codec("topk").encode(fed, torch.from_numpy(x))
    ti = tkw["topk_idx"].numpy()
    assert tkw["topk_idx"].dtype == torch.int32 and tkw["out_m"] == 400
    assert np.all(np.diff(ti, axis=1) > 0)      # ascending within a row
    ji = np.asarray(jkw["topk_idx"])
    np.testing.assert_array_equal(ti, np.sort(ji, axis=1))
    np.testing.assert_array_equal(
        tv.numpy(), np.take_along_axis(x, np.sort(ji, axis=1), axis=1))


@pytest.mark.parametrize("dim", [8, 64])
def test_sketch_encode_matches_reference(dim):
    """Bucket sums of sign * x over the shared hash: f32 sums in another
    order, within 1e-5 of the largest |x| times the bucket's count."""
    x = _buf(4, 700, seed=2)
    jfed, fed = _feds(codec_sketch_dim=dim)
    js, _ = jagg.get_wire_codec("sketch").encode(jfed, jnp.asarray(x))
    ts, tkw = agg.get_wire_codec("sketch").encode(fed, torch.from_numpy(x))
    assert tkw["out_m"] == 700 and ts.shape == (4, dim)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5 * np.abs(x).max() * 700 / dim * 4)


@pytest.mark.parametrize("codec", CODECS)
def test_decode_matches_reference(codec):
    """The dense decode (used for the error-feedback residual) of the same
    payload: exact (one multiply, or a placement)."""
    x = _buf(5, 300, seed=4)
    jfed, fed = _feds()
    jc = jagg.get_wire_codec(codec)
    ju, jkw = jc.encode(jfed, jnp.asarray(x))
    tu, tkw = agg.get_wire_codec(codec).encode(fed, torch.from_numpy(x))
    got = agg.get_wire_codec(codec).decode(fed, tu, tkw, 300)
    want = jc.decode(jfed, ju, jkw, 300)
    if codec == "sketch":               # bucket sums in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5 * np.abs(x).max() * 40)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ============================================================ reducer x codec
def _reducer_kw(reducer, C, M, framework, seed=0):
    rng = np.random.default_rng(seed + 100)
    rs = rng.random(C).astype(np.float32)
    noise = rng.normal(size=M).astype(np.float32)
    conv = (lambda a: torch.from_numpy(a)) if framework == "torch" else jnp.asarray
    if reducer == "dp":
        return dict(aggregator="dp", row_scale=conv(rs), noise=conv(noise),
                    noise_scale=0.3), rs, noise
    if reducer == "trimmed_mean":
        return dict(aggregator="trimmed_mean", trim_frac=0.25), rs, noise
    return dict(aggregator=reducer), rs, noise


@pytest.mark.parametrize("C,M", [(4, 200), (8, 256), (13, 900)])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("reducer", REDUCERS)
def test_every_reducer_codec_pair_matches_reference(reducer, codec, C, M):
    """The port's encode + fedagg_plain against the reference's encode +
    jnp lowering (and Pallas interpret where C <= 8, M <= 256): f32 output,
    NaN-free, within 1e-5 of the largest decoded term (dp: plus its noise
    term); the median exact except through the sketch's bucket sums."""
    x = _buf(C, M, seed=C + M)
    rng = np.random.default_rng(C)
    w = (rng.random(C) + 0.1).astype(np.float32)
    g = (rng.random(C) > 0.3).astype(np.float32)
    g[0] = 1.0
    jfed, fed = _feds()
    ju, jkw = jagg.get_wire_codec(codec).encode(jfed, jnp.asarray(x))
    tu, tkw = agg.get_wire_codec(codec).encode(fed, torch.from_numpy(x))
    jred, rs, noise = _reducer_kw(reducer, C, M, "jax")
    tred, _, _ = _reducer_kw(reducer, C, M, "torch")
    got = fk.fedagg_plain(tu, torch.from_numpy(w), torch.from_numpy(g),
                          **tkw, **tred)
    assert got.dtype == torch.float32 and got.shape == (M,)
    got = got.numpy()
    wants = [jops.fedagg(ju, jnp.asarray(w), jnp.asarray(g), **jkw, **jred)]
    if C <= 8 and M <= 256:
        wants.append(jops.fedagg(ju, jnp.asarray(w), jnp.asarray(g),
                                 use_pallas=True, interpret=True, block_m=128,
                                 **jkw, **jred))
    dense = np.asarray(jagg.get_wire_codec(codec).decode(jfed, ju, jkw, M))
    inc = (g > 0) if reducer in ("trimmed_mean", "median") else (w * g > 0)
    mag = float(np.abs(dense[inc]).max())
    if reducer == "dp":
        mag = mag * float(rs[inc].max()) + float(np.abs(noise).max()) * 0.3 / float(
            (w * g)[inc].sum())
    for want in wants:
        want = np.asarray(want)
        assert want.dtype == np.float32 and np.all(np.isfinite(got))
        if reducer == "median" and codec != "sketch":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * mag)


# ===================================================== coded aggregation + EF
SHAPES = {"b": (10,), "w": (60, 10)}


def _tree(C, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(C,) + s) * 0.1).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(tree, ef, w, g, codec, name, **knobs):
    jfed, fed = _feds(wire_codec=codec, aggregator=name, **knobs)
    jkey = jagg.aggregator_key(jfed, 2) if name == "dp" else None
    tkey = agg.aggregator_key(fed, 2) if name == "dp" else None
    jout = jagg.aggregate_clients(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(w), jnp.asarray(g),
        aggregator=name, fed=jfed, key=jkey, wire_codec=codec,
        ef_accum=None if ef is None else jax.tree.map(jnp.asarray, ef))
    tout = agg.aggregate_clients(
        {k: torch.from_numpy(v.copy()) for k, v in tree.items()},
        torch.from_numpy(w), torch.from_numpy(g), aggregator=name, fed=fed,
        key=tkey, wire_codec=codec,
        ef_accum=None if ef is None else {k: torch.from_numpy(v.copy())
                                          for k, v in ef.items()})
    return jout, tout


@pytest.mark.parametrize("ef_on", [True, False], ids=["ef", "no_ef"])
@pytest.mark.parametrize("name", ["mean", "median", "dp", "cosine_filter"])
@pytest.mark.parametrize("codec", CODECS)
def test_coded_aggregate_clients_matches_reference(codec, name, ef_on):
    """The aggregate and the advanced error-feedback rows, within 1e-5 of
    the largest term (f32, summation order; dp's noise term included)."""
    C = 6
    tree = _tree(C, seed=7)
    ef = _tree(C, seed=8) if ef_on else None
    w = np.array([0.3, 0.1, 0.2, 0.15, 0.15, 0.1], np.float32)
    g = np.array([1, 1, 0, 1, 1, 1], np.float32)
    jout, tout = _run_both(tree, ef, w, g, codec, name, outlier_cos=0.0,
                           sketch_dim=32)
    jagg_, jef = jout if ef_on else (jout, None)
    tagg_, tef = tout if ef_on else (tout, None)
    tol = 1e-5 * (1.0 + (4 * 0.25 * 2.0 / 0.6 if name == "dp" else 0.0))
    for k in SHAPES:
        np.testing.assert_allclose(tagg_[k].numpy(), np.asarray(jagg_[k]),
                                   rtol=0, atol=tol, err_msg=k)
        if ef_on:
            assert tef[k].dtype == torch.float32
            np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]),
                                       rtol=0, atol=1e-5, err_msg=k)


def test_ef_rows_advance_only_where_transmitted_and_finite():
    """Row 2 is gated out (did not transmit) and row 3 carries a NaN, so its
    sketch residual is not finite: both keep their old accumulator; every
    other row takes its residual x + ef - decode(encode(x + ef)). As the
    reference, row for row."""
    C = 6
    tree = _tree(C, seed=1)
    tree["w"][3, 5, 5] = np.nan
    ef = _tree(C, seed=2)
    w = np.full(C, 0.2, np.float32)
    g = np.array([1, 1, 0, 1, 1, 1], np.float32)
    jout, tout = _run_both(tree, ef, w, g, "sketch", "mean")
    (_, jef), (_, tef) = jout, tout
    for k in SHAPES:
        for r in (2, 3):
            np.testing.assert_array_equal(tef[k][r].numpy(), ef[k][r])
        moved = [r for r in range(C) if r not in (2, 3)]
        assert not np.allclose(tef[k][moved].numpy(), ef[k][moved])
        np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_cosine_filtered_client_still_advances_its_ef_row():
    """A client the cosine filter drops did transmit: its error-feedback row
    advances (tx gates are taken before the rewrite), as in the reference."""
    rng = np.random.default_rng(4)
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tree = {k: np.stack([v + 0.3 * rng.normal(size=v.shape).astype(np.float32)
                         for _ in range(6)]) for k, v in base.items()}
    for k in tree:
        tree[k][4] = -3.0 * tree[k][4]
    ef = {k: np.zeros_like(v) for k, v in tree.items()}
    w = np.full(6, 0.5, np.float32)
    g = np.ones(6, np.float32)
    jout, tout = _run_both(tree, ef, w, g, "int8", "cosine_filter",
                           outlier_cos=0.0, sketch_dim=64)
    (_, jef), (_, tef) = jout, tout
    for k in SHAPES:
        assert np.any(tef[k][4].numpy() != 0.0)
        np.testing.assert_allclose(tef[k].numpy(), np.asarray(jef[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_coded_path_needs_fused_and_fed():
    tree = {k: torch.from_numpy(v) for k, v in _tree(4, 0).items()}
    w = g = torch.ones(4)
    _, fed = _feds(wire_codec="int8")
    with pytest.raises(ValueError, match="fused=True"):
        agg.aggregate_clients(tree, w, g, fused=False, fed=fed,
                              wire_codec="int8")
    with pytest.raises(ValueError, match="fed="):
        agg.aggregate_clients(tree, w, g, wire_codec="int8")
    with pytest.raises(ValueError, match="identity"):
        agg.aggregate_clients(tree, w, g, ef_accum=tree)


@pytest.mark.parametrize("codec,ef", [("identity", True), ("int8", True),
                                      ("topk", False), ("sketch", True)])
def test_init_ef_accum_layout_matches_reference(codec, ef):
    """Zero f32 rows with a leading [C] axis, or () when the codec is
    identity or error feedback is off."""
    jfed, fed = _feds(wire_codec=codec, error_feedback=ef)
    p = {"b": np.zeros(10, np.float32), "w": np.zeros((60, 10), np.float32)}
    want = jengine.init_ef_accum(jax.tree.map(jnp.asarray, p), jfed, 4)
    got = engine.init_ef_accum({k: torch.from_numpy(v) for k, v in p.items()},
                               fed, 4)
    if want == ():
        assert got == ()
        return
    for k in p:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        assert not torch.any(got[k])


@pytest.mark.parametrize("agg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec", ["identity"] + CODECS)
@pytest.mark.parametrize("rows,m", [(60, 579402), (8, 610), (3, 7)])
def test_wire_bytes_per_round_matches_reference(codec, agg_dtype, rows, m):
    jfed, fed = _feds(wire_codec=codec, agg_dtype=agg_dtype,
                      codec_topk_frac=0.01, codec_sketch_dim=2048)
    assert agg.wire_bytes_per_round(fed, rows, m) == jagg.wire_bytes_per_round(
        jfed, rows, m)


@pytest.mark.parametrize("knobs,match", [
    (dict(wire_codec="int8", fused_agg=False), "fused_agg"),
    (dict(wire_codec="topk", codec_topk_frac=0.0), "codec_topk_frac"),
    (dict(wire_codec="topk", codec_topk_frac=1.5), "codec_topk_frac"),
    (dict(wire_codec="sketch", codec_sketch_dim=0), "codec_sketch_dim"),
    (dict(wire_codec="zstd"), "wire codec")])
def test_check_codec_config_rejects_as_the_reference(knobs, match):
    for cfg, validate in ((JaxFedConfig(**knobs), jagg.check_codec_config),
                          (FedConfig(**knobs), validate_config)):
        with pytest.raises(ValueError, match=match):
            validate(cfg)
