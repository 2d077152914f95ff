"""fedagg (gated client mean): the port's plain version against the
reference's oracle (ref.fedagg_ref), its jnp lowering (ops._fedagg_jnp)
and its Pallas kernel in interpret mode, on the reference's edge shapes;
and, on a CUDA card, the hand-written kernel against the plain version.

The JAX package is imported inside the tests that use it, so the card-only
cases also run on a machine without JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fedagg.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fedagg as fk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _reference():
    """(jnp, repro.kernels.ref, repro.kernels.ops, fedagg_pallas)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref
    from repro.kernels.fedagg import fedagg_pallas
    return jnp, ref, jops, fedagg_pallas

# the tests/test_kernels.py shape sweep, a C past one 64-row tile, and the
# slice's quickstart shape
SHAPES = [(1, 64), (1, 7), (4, 100), (5, 513), (3, 2065), (65, 300), (20, 610)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(C, M, seed=0, gates="mixed"):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(C, M)).astype(np.float32)
    w = (rng.random(C) + 0.1).astype(np.float32)
    if gates == "none":
        g = np.zeros(C, np.float32)
    else:
        g = (rng.random(C) > 0.3).astype(np.float32)
        g[0] = 1.0
    return u, w, g


def _check(got, want, u, w, g, dtype):
    """f32: within 1e-5 max|u| — both sides sum in f32, in another order.
    bf16: within one bf16 ulp of the reference — both round an f32 sum to
    bf16 — plus the bound on how far two f32 sums of the same n terms in
    different orders can differ, 2 n 2^-24 sum_k |wg_k u_km| / sum_k wg_k,
    which exceeds a bf16 ulp where a column sum cancels to near 0."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    inc = (w * g) > 0
    if dtype == "float32":
        scale = np.abs(u[inc]).max() if inc.any() else 0.0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        return
    wg = np.where(inc, w * g, 0.0).astype(np.float64)
    absum = np.abs(np.where(inc[:, None], u, 0.0)).T @ wg / max(wg.sum(), 1e-30)
    order = 2.0 * inc.sum() * 2.0 ** -24 * absum
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp + order)


def _port(u, w, g, dtype):
    tu = torch.from_numpy(np.array(u)).to(getattr(torch, dtype))
    out = fk.fedagg_plain(tu, torch.from_numpy(w), torch.from_numpy(g))
    assert out.dtype == tu.dtype and out.shape == (u.shape[1],)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,M", SHAPES)
def test_plain_matches_reference_oracle_lowering_and_pallas(C, M, dtype):
    jnp, ref, jops, fedagg_pallas = _reference()
    u, w, g = _case(C, M, seed=C * 1000 + M)
    ju = jnp.asarray(u).astype(getattr(jnp, dtype))
    jw, jg = jnp.asarray(w), jnp.asarray(g)
    got = _port(np.asarray(ju.astype(jnp.float32)), w, g, dtype)
    for want in (ref.fedagg_ref(ju, jw, jg), jops._fedagg_jnp(ju, jw, jg),
                 fedagg_pallas(ju, jw, jg, block_m=256, interpret=True)):
        _check(got, np.asarray(want.astype(jnp.float32)), u, w, g, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_mass_gives_exact_zeros(dtype):
    u, w, g = _case(6, 257, gates="none")
    got = _port(u, w, g, dtype)
    assert np.all(got == 0.0) and not np.any(np.signbit(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_in_gated_out_row_does_not_leak(dtype):
    jnp, ref, _, _ = _reference()
    u, w, g = _case(6, 257)
    u[3], g[3] = np.nan, 0.0
    got = _port(u, w, g, dtype)
    assert np.all(np.isfinite(got))
    clean = u.copy()
    clean[3] = 0.0
    _check(got, np.asarray(ref.fedagg_ref(jnp.asarray(clean).astype(
        getattr(jnp, dtype)), jnp.asarray(w), jnp.asarray(g)).astype(
            jnp.float32)), clean, w, g, dtype)


def test_all_zero_rows_and_one_hot():
    jnp, ref, _, _ = _reference()
    u, w, g = _case(5, 100)
    u[1] = 0.0
    u[2] = 0.0
    _check(_port(u, w, g, "float32"),
           np.asarray(ref.fedagg_ref(jnp.asarray(u), jnp.asarray(w),
                                     jnp.asarray(g))), u, w, g, "float32")
    g1 = np.zeros(5, np.float32)
    g1[4] = 1.0
    np.testing.assert_allclose(_port(u, w, g1, "float32"), u[4], rtol=1e-6)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    u, w, g = _case(4, 100)
    before = fk.fedagg.launches
    out = ops.fedagg(torch.from_numpy(u), torch.from_numpy(w),
                     torch.from_numpy(g))
    np.testing.assert_array_equal(out.numpy(), _port(u, w, g, "float32"))
    assert fk.fedagg.launches == before


def test_plain_accepts_a_pitched_view():
    """The fused aggregation hands over a [C, M] view with a padded row
    pitch; only the first M columns of each row are read."""
    u, w, g = _case(4, 610)
    buf = torch.full((4, 616), float("nan"))
    buf[:, :610] = torch.from_numpy(u)
    np.testing.assert_array_equal(
        fk.fedagg(buf[:, :610], torch.from_numpy(w), torch.from_numpy(g))
        .numpy(), _port(u, w, g, "float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,M", SHAPES + [(60, 579402)])
def test_cuda_kernel_matches_plain(cuda_device, C, M, dtype):
    u, w, g = _case(C, M, seed=3)
    tu = torch.from_numpy(u).to(getattr(torch, dtype)).to(cuda_device)
    tw, tg = torch.from_numpy(w).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    before = fk.fedagg.launches
    got = fk.fedagg(tu, tw, tg)
    torch.cuda.synchronize()
    assert fk.fedagg.launches == before + 1
    want = fk.fedagg_plain(tu, tw, tg)
    _check(got.float().cpu().numpy(), want.float().cpu().numpy(),
           tu.float().cpu().numpy(), w, g, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_zero_mass_and_nan_row(cuda_device, dtype):
    u, w, g = _case(8, 1000, gates="none")
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    out = fk.fedagg(t(u).to(getattr(torch, dtype)), t(w), t(g))
    assert bool(torch.all(out == 0))
    u, w, g = _case(8, 1000)
    u[2], g[2] = np.nan, 0.0
    out = fk.fedagg(t(u).to(getattr(torch, dtype)), t(w), t(g))
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_cuda_aggregation_matches_cpu(cuda_device, fused):
    """aggregate_clients on the card: one launch for the fused [C, M_total]
    buffer (one per leaf otherwise), and the CPU path's result."""
    from repro_torch.core.aggregation import aggregate_clients
    gen = torch.Generator().manual_seed(0)
    tree = {"b": torch.randn(7, 10, generator=gen),
            "c": torch.randn(7, 5, 5, 3, 4, generator=gen),
            "w": torch.randn(7, 61, 10, generator=gen)}
    w = torch.rand(7, generator=gen) + 0.1
    g = torch.tensor([1, 0, 1, 1, 0, 1, 1], dtype=torch.float32)
    want = aggregate_clients(tree, w, g, fused=fused)
    before = fk.fedagg.launches
    got = aggregate_clients({k: v.to(cuda_device) for k, v in tree.items()},
                            w.to(cuda_device), g.to(cuda_device), fused=fused)
    assert fk.fedagg.launches - before == (1 if fused else len(tree))
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-5)


# ------------------------------------------ robust / private / coded variants
REDUCERS = ["mean", "dp", "trimmed_mean", "median"]
WIRES = ["identity_f32", "identity_bf16", "int8", "topk", "sketch"]


def _variant(reducer, wire, C, M, device, *, gates="mixed", nan_row=None,
             nan_included=False, seed=0, fed=None, block_row=None):
    """(updates, weights, gates, kwargs) for one reducer x wire call: dense
    rows from a numpy seed, encoded by the port's codec on ``device`` (at
    ``fed``'s rates; default topk frac 0.05, sketch dim 256).
    ``block_row`` lifts that row's columns 2048-4095, so that its top-k
    pairs all fall in one block of the topk kernel."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation as agg
    u, w, g = _case(C, M, seed=seed, gates=gates)
    if block_row is not None:
        u[block_row, 2048:4096] += 100.0
    rng = np.random.default_rng(seed + 1)
    rs = rng.random(C).astype(np.float32)
    noise = rng.normal(size=M).astype(np.float32)
    if nan_row is not None:
        u[nan_row, ::7] = np.nan
        g[nan_row] = 1.0 if nan_included else 0.0
        if not nan_included:
            rs[nan_row] = np.nan
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    if wire.startswith("identity"):
        dtype = torch.float32 if wire == "identity_f32" else torch.bfloat16
        updates, kw = agg.flatten_stacked({"u": t(u)}, dtype=dtype), {}
    else:
        fed = fed or FedConfig(codec_topk_frac=0.05, codec_sketch_dim=256)
        updates, kw = agg.get_wire_codec(wire).encode(fed, t(u))
    kw = dict(kw, aggregator=reducer)
    if reducer == "dp":
        kw.update(row_scale=t(rs), noise=t(noise), noise_scale=0.3)
    elif reducer == "trimmed_mean":
        kw["trim_frac"] = 0.2
    return updates, t(w), t(g), kw


def _close_variant(got, want, updates, w, g, kw):
    """NaN masks equal; elsewhere within 1e-5 of the largest term the
    reduction sums (f32 sums in another order; the median is exact) and,
    for a bf16 output, one bf16 ulp of the plain result on top."""
    from repro_torch.kernels.fedagg import decode_wire_plain
    o, p = got.float().cpu(), want.float().cpu()
    assert torch.equal(torch.isnan(o), torch.isnan(p))
    fin = ~torch.isnan(p)
    codec = kw.get("codec", "identity")
    dense = (updates.float() if codec == "identity" else decode_wire_plain(
        updates, codec=codec, out_m=p.shape[0], **{
            k: kw[k] for k in ("dequant_scale", "topk_idx", "sketch_h",
                               "sketch_sign") if k in kw})).cpu()
    red = kw["aggregator"]
    inc = ((g > 0) if red in ("trimmed_mean", "median") else (w * g > 0)).cpu()
    rows = dense[inc]
    rows = rows[torch.isfinite(rows)]
    mag = float(rows.abs().max()) if rows.numel() else 0.0
    if red == "dp" and bool(inc.any()):
        mag = mag * float(kw["row_scale"].cpu()[inc].max()) + float(
            kw["noise"].abs().max()) * 0.3 / float((w * g).cpu()[inc].sum())
    tol = 1e-5 * mag + torch.zeros_like(p[fin])
    if got.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            torch.clamp(p[fin].abs(), min=2.0 ** -126))) - 7)
    assert bool(torch.all((o[fin] - p[fin]).abs() <= tol))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("reducer", REDUCERS)
def test_wrapper_takes_plain_version_on_cpu_for_every_variant(reducer, wire):
    updates, w, g, kw = _variant(reducer, wire, 6, 300, "cpu")
    before = fk.fedagg.launches
    out = ops.fedagg(updates, w, g, **kw)
    assert fk.fedagg.launches == before
    want = fk.fedagg_plain(updates, w, g, **kw)
    assert out.dtype == (torch.bfloat16 if wire == "identity_bf16"
                         else torch.float32)
    np.testing.assert_array_equal(out.float().numpy(), want.float().numpy())


def test_wrapper_refuses_other_devices():
    u = torch.zeros(2, 4, device="meta")
    w = g = torch.ones(2, device="meta")
    with pytest.raises(ValueError, match="device"):
        fk.fedagg(u, w, g)


@pytest.mark.cuda
@pytest.mark.parametrize("C,M", [(1, 1000), (2, 1000), (3, 1001), (4, 1000),
                                 (20, 610), (60, 579402), (65, 4099)])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("reducer", REDUCERS)
def test_cuda_variants_match_plain(cuda_device, reducer, wire, C, M):
    updates, w, g, kw = _variant(reducer, wire, C, M, cuda_device, seed=C)
    before = fk.fedagg.launches
    got = fk.fedagg(updates, w, g, **kw)
    torch.cuda.synchronize()
    assert fk.fedagg.launches == before + 1
    assert got.dtype == (torch.bfloat16 if wire == "identity_bf16"
                         else torch.float32)
    _close_variant(got, fk.fedagg_plain(updates, w, g, **kw), updates, w, g, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("reducer", REDUCERS)
def test_cuda_variants_zero_inclusion_and_nan_rows(cuda_device, reducer, wire):
    """Zero inclusion gives exact zeros; a NaN behind a zero gate (and its
    NaN clip scale) never leaks; a NaN in an included row of a sorted
    reducer lands where the plain network puts it."""
    updates, w, g, kw = _variant(reducer, wire, 8, 1000, cuda_device,
                                 gates="none")
    assert bool(torch.all(fk.fedagg(updates, w, g, **kw) == 0))
    updates, w, g, kw = _variant(reducer, wire, 8, 1000, cuda_device,
                                 nan_row=2)
    out = fk.fedagg(updates, w, g, **kw)
    assert bool(torch.isfinite(out).all())
    if reducer in ("trimmed_mean", "median"):
        updates, w, g, kw = _variant(reducer, wire, 9, 1000, cuda_device,
                                     nan_row=3, nan_included=True)
        _close_variant(fk.fedagg(updates, w, g, **kw),
                       fk.fedagg_plain(updates, w, g, **kw), updates, w, g, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "topk", "sketch"])
@pytest.mark.parametrize("aggregator", ["median", "dp", "cosine_filter"])
def test_cuda_coded_aggregation_matches_cpu(cuda_device, aggregator, codec):
    """aggregate_clients with error feedback on the card: one launch, and
    the CPU path's aggregate and accumulator rows (1e-5 of the largest
    term; int8 may move a coordinate by one quantum where the card's
    rounding of x / scale lands on the other side of a .5)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.aggregation import aggregate_clients, aggregator_key
    fed = FedConfig(aggregator=aggregator, wire_codec=codec, dp_noise=0.2,
                    sketch_dim=64, codec_topk_frac=0.05)
    gen = torch.Generator().manual_seed(0)
    tree = {"b": torch.randn(7, 10, generator=gen),
            "w": torch.randn(7, 61, 10, generator=gen)}
    ef = {k: 0.01 * torch.randn(v.shape, generator=gen) for k, v in tree.items()}
    w = torch.rand(7, generator=gen) + 0.1
    g = torch.tensor([1, 0, 1, 1, 0, 1, 1], dtype=torch.float32)
    key = aggregator_key(fed, 1)
    want, want_ef = aggregate_clients(tree, w, g, aggregator=aggregator,
                                      fed=fed, key=key, wire_codec=codec,
                                      ef_accum=ef)
    dev = lambda t: {k: v.to(cuda_device) for k, v in t.items()}  # noqa: E731
    before = fk.fedagg.launches
    got, got_ef = aggregate_clients(dev(tree), w.to(cuda_device),
                                    g.to(cuda_device), aggregator=aggregator,
                                    fed=fed, key=key, wire_codec=codec,
                                    ef_accum=dev(ef))
    assert fk.fedagg.launches - before == 1
    quantum = max(float(v.abs().max()) for v in tree.values()) / 127 * 2
    atol = 1e-5 * 10 + (quantum if codec == "int8" else 0.0)
    for k in tree:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=atol)
        torch.testing.assert_close(got_ef[k].cpu(), want_ef[k], rtol=0,
                                   atol=atol)


@pytest.mark.cuda
def test_cuda_trim_count_is_float32(cuda_device):
    """The kernel trims t = int32(f32(0.29) * f32(100)) = 29 per side (the
    f64 product would give 28), as the plain version does."""
    rng = np.random.default_rng(0)
    u = rng.permutation(np.arange(100, dtype=np.float32))[:, None] ** 2
    u = torch.from_numpy(np.repeat(u, 5, axis=1)).to(cuda_device)
    w = g = torch.ones(100, device=cuda_device)
    got = fk.fedagg(u, w, g, aggregator="trimmed_mean", trim_frac=0.29)
    want = fk.fedagg_plain(u, w, g, aggregator="trimmed_mean", trim_frac=0.29)
    s = np.sort(np.arange(100, dtype=np.float64) ** 2)
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.cpu().numpy(), s[29:71].mean(), rtol=1e-6)


# ------------------------------------------ K4's decoders under mean and dp
EDGE_M = 8 * 256 * 4 + 3     # not a multiple of a sketch cluster's 8 x 256 x 4
                             # columns, nor of the int8 stream's 4


def _edge(device, reducer, wire, C, M, **kw):
    """One case against the plain version, then the same shape with zero
    inclusion (exact zeros) and with a NaN row behind a zero gate (finite,
    and against the plain version); returns the first case's inputs."""
    case = _variant(reducer, wire, C, M, device, **kw)
    updates, w, g, ops = case
    before = fk.fedagg.launches
    got = fk.fedagg(updates, w, g, **ops)
    torch.cuda.synchronize()
    assert fk.fedagg.launches == before + 1
    _close_variant(got, fk.fedagg_plain(updates, w, g, **ops), updates, w, g, ops)
    kw = {k: v for k, v in kw.items() if k != "gates"}
    updates, w, g, ops = _variant(reducer, wire, C, M, device, gates="none", **kw)
    assert bool(torch.all(fk.fedagg(updates, w, g, **ops) == 0))
    updates, w, g, ops = _variant(reducer, wire, C, M, device, nan_row=2, **kw)
    got = fk.fedagg(updates, w, g, **ops)
    assert bool(torch.isfinite(got).all())
    _close_variant(got, fk.fedagg_plain(updates, w, g, **ops), updates, w, g, ops)
    return case


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 7, 2048, fk.MAX_SKETCH_DIM, fk.MAX_SKETCH_DIM + 1],
                         ids=["1", "7", "2048", "max", "gather"])
@pytest.mark.parametrize("reducer", ["mean", "dp"])
def test_cuda_sketch_dims(cuda_device, reducer, dim):
    """The bucket-first route at dim 1, 7, 2048 and the most buckets shared
    memory holds, and the L2-gather route one past it."""
    from repro_torch.configs.base import FedConfig
    updates, *_ = _edge(cuda_device, reducer, "sketch", 6, EDGE_M,
                        fed=FedConfig(codec_sketch_dim=dim))
    assert updates.shape == (6, dim)


@pytest.mark.cuda
@pytest.mark.parametrize("reducer", ["mean", "dp"])
def test_cuda_sketch_unaligned_planes(cuda_device, reducer):
    """Hash and sign planes 4 bytes off a 16-byte boundary take the
    L2-gather route."""
    updates, w, g, kw = _variant(reducer, "sketch", 6, EDGE_M, cuda_device)
    for k in ("sketch_h", "sketch_sign"):
        buf = torch.empty(EDGE_M + 1, dtype=kw[k].dtype, device=cuda_device)
        buf[1:] = kw[k]
        kw[k] = buf[1:]
    assert kw["sketch_h"].data_ptr() % 16
    got = fk.fedagg(updates, w, g, **kw)
    _close_variant(got, fk.fedagg_plain(updates, w, g, **kw), updates, w, g, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_block", "stages"])
@pytest.mark.parametrize("reducer", ["mean", "dp"])
def test_cuda_topk_windows(cuda_device, reducer, case):
    """All of a row's pairs in one 2048-column block; and more pairs in a
    block than one shared-memory stage holds (frac 0.5: ~1024 a row)."""
    from repro_torch.configs.base import FedConfig
    if case == "one_block":
        updates, w, g, ops = _edge(cuda_device, reducer, "topk", 6, EDGE_M,
                                   block_row=1, fed=FedConfig(codec_topk_frac=0.05))
        idx = ops["topk_idx"][1].cpu()
        assert int(idx.min()) >= 2048 and int(idx.max()) < 4096
    else:
        updates, w, g, ops = _edge(cuda_device, reducer, "topk", 8, EDGE_M,
                                   gates="all", fed=FedConfig(codec_topk_frac=0.5))
        in_block = ((ops["topk_idx"] >= 2048) & (ops["topk_idx"] < 4096)).sum()
        assert int(in_block) > 2048


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1001, EDGE_M])
@pytest.mark.parametrize("reducer", ["mean", "dp"])
def test_cuda_int8_ragged_pitched(cuda_device, reducer, M):
    """int8 rows with a pitch past M and a ragged last column group (the
    stream kernel's scalar tail)."""
    updates, *_ = _edge(cuda_device, reducer, "int8", 6, M)
    assert updates.stride(0) > M and M % 4


# ------------------------- K1 / K2 over identity rows: every vw, and the order
def _rows_with_vw(u, vw, device):
    """u's rows in a buffer whose pitch allows loads of exactly vw elements
    (the widest _vector_width picks): a multiple of vw, not of 2 vw (vw 1:
    odd), as per-leaf rows of an odd size come."""
    C, M = u.shape
    pitch = -(-M // vw) * vw
    if (pitch // vw) % 2 == 0:
        pitch += vw
    buf = torch.full((C, pitch), float("nan"), dtype=u.dtype, device=device)
    buf[:, :M] = u.to(device)
    return buf[:, :M]


def _stream_route(u):
    """The same rows 1 element off a 16-byte boundary with an odd pitch:
    the wrapper picks vw 1, the stream kernel's scalar loads, whose order
    (one fmaf an included row, ascending, from 0; stage_rows' den) every
    wider vw keeps."""
    C, M = u.shape
    flat = torch.empty(C * (M + 1) + 1, dtype=u.dtype, device=u.device)
    rows = flat[1:].view(C, M + 1)[:, :M]
    rows.copy_(u)
    assert fk._vector_width((4, 2, 1), M + 1, rows) == 1
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["mean", "dp"])
@pytest.mark.parametrize("dtype,vw", [("float32", 4), ("float32", 2), ("float32", 1),
                                      ("bfloat16", 8), ("bfloat16", 4),
                                      ("bfloat16", 2), ("bfloat16", 1)])
@pytest.mark.parametrize("C,M", [(1, 1000), (257, 2051), (1000, 1029), (8, 100),
                                 (8, 1027), (60, 8195)],
                         ids=["c1", "c257", "c1000", "below_a_tile", "ragged",
                              "tiles"])
def test_cuda_identity_routes_match_plain_and_the_stream_order(
        cuda_device, C, M, dtype, vw, aggregator):
    """Every row width the wrapper can pick, under mean and dp, C past one
    256-row chunk, M below one tile and ragged: within the file's bounds of
    fedagg_plain, and bit for bit the stream kernel's order (the output of
    the same rows through the vw-1 loads)."""
    tdtype = getattr(torch, dtype)
    updates, w, g, kw = _variant(aggregator, "identity_f32", C, M, cuda_device,
                                 seed=C + M)
    rows = _rows_with_vw(updates.to(tdtype), vw, cuda_device)
    elt = rows.element_size()
    assert fk._vector_width((4, 2, 1) if elt == 4 else (8, 4, 2, 1),
                            rows.stride(0), rows) == vw
    before = fk.fedagg.launches
    got = fk.fedagg(rows, w, g, **kw)
    torch.cuda.synchronize()
    assert fk.fedagg.launches == before + 1 and got.dtype == tdtype
    _close_variant(got, fk.fedagg_plain(rows, w, g, **kw), rows, w, g, kw)
    want = fk.fedagg(_stream_route(rows), w, g, **kw)
    assert torch.equal(got.view(torch.int32 if elt == 4 else torch.int16),
                       want.view(torch.int32 if elt == 4 else torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["mean", "dp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_identity_zero_inclusion_and_gated_nan(cuda_device, dtype, aggregator):
    """C = 1,000 with every gate 0 gives exact +0; NaN rows (and their NaN
    clip scales) behind zero gates never reach the sum."""
    tdtype = getattr(torch, dtype)
    updates, w, g, kw = _variant(aggregator, "identity_f32", 1000, 2051,
                                 cuda_device, gates="none")
    out = fk.fedagg(updates.to(tdtype), w, g, **kw)
    assert bool(torch.all(out == 0)) and not bool(torch.signbit(out.float()).any())
    updates, w, g, kw = _variant(aggregator, "identity_f32", 300, 2051,
                                 cuda_device, nan_row=257)
    rows = updates.to(tdtype)
    got = fk.fedagg(rows, w, g, **kw)
    assert bool(torch.isfinite(got.float()).all())
    want = fk.fedagg(_stream_route(rows), w, g, **kw)
    assert torch.equal(got.float(), want.float())
