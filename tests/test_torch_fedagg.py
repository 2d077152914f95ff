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
