"""The flash-attention backward (K6's plain version) and the two autograd
Functions of the LM, on the CPU, against the JAX package:

* ``flash_attention_bwd_plain`` against ``jax.vjp`` of the reference's jnp
  lowering (``repro/kernels/ops.py:_flash_attention_jnp``) over MHA, GQA,
  MQA, windows, Sq < Skv and ragged lengths, in f32; and against
  ``flash_attention_bwd_pallas(interpret=True)`` at tiny block-aligned
  shapes, in f32 and bf16, both fed the same out and lse;
* ``FlashAttention`` (the Function the models call) against torch
  autograd through ``flash_attention_plain``, an independent route, f32;

bf16 is held to the Pallas backward only: like it, the plain version takes
delta = rowsum(dO * O) from the bf16-rounded output, where autodiff of a
bf16 forward uses its f32 output before the rounding; the two differ by
about 2^-8 |dO| |O| in each ds, far above a bf16 ulp of a small gradient
(a causal first row's dq is exactly 0 by the kernels' formulas).
* ``RMSNorm``'s backward against ``jax.grad`` of the reference's
  ``layers.rmsnorm`` and torch autograd through ``rmsnorm_plain``;
* the ``attn_bf16`` knob's ``mm_dtype``: the plain forward against the jnp
  lowering's ``mm_dtype`` and its backward against ``jax.vjp`` of it.

Tolerances: f32 within F32_TOL of the largest magnitude of the tensor
compared (the reference's f32 kernel tolerance, tests/test_kernels.py:
f32 sums in another order); a bf16 output within one bf16 ulp of the
reference plus that (both round an f32 result once). The card's kernel
against this plain version: tests/test_torch_lm_kernels.py (marked cuda).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402

F32_TOL = 2e-5
# (label, B, Sq, Skv, H, KV, hd, causal, window)
BWD_CASES = [
    ("mha_hd32", 1, 40, 40, 4, 4, 32, True, 0),
    ("gqa4_ragged_hd64", 1, 37, 37, 8, 2, 64, True, 0),
    ("mqa_g8_hd128", 1, 33, 33, 8, 1, 128, True, 0),
    ("hd96_noncausal", 2, 24, 24, 2, 2, 96, False, 0),
    ("sq_lt_skv", 2, 20, 70, 4, 2, 32, True, 0),
    ("window16", 1, 70, 70, 4, 2, 32, True, 16),
    ("window8_noncausal", 1, 40, 40, 2, 2, 32, False, 8),
    ("window8_sq_lt_skv", 2, 13, 45, 4, 4, 32, True, 8),
]
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module, the previous
    count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, t.float().numpy()          # the (rounded) values both sides get


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = F32_TOL * float(np.abs(want).max())
    if dtype == "bfloat16":
        bound = bound + _bf16_ulp(want)
    np.testing.assert_array_less(np.abs(got - want), bound + 1e-30)


def _inputs(case, dtype):
    _, B, Sq, Skv, H, KV, hd, causal, window = case
    q, qn = _rand((B, Sq, H, hd), 1, dtype)
    k, kn = _rand((B, Skv, KV, hd), 2, dtype)
    v, vn = _rand((B, Skv, KV, hd), 3, dtype)
    do, don = _rand((B, Sq, H, hd), 4, dtype)
    return (q, k, v, do), (qn, kn, vn, don), dict(causal=causal, window=window)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_bwd_plain_matches_jax_grad_of_the_jnp_lowering(case):
    from repro.kernels import ops as jops
    dtype = "float32"
    (q, k, v, do), (qn, kn, vn, don), kw = _inputs(case, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (qn, kn, vn, don))
    _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
        a, b, c, block_kv=32, **kw), jq, jk, jv)
    want = vjp(jdo)
    out, lse = fk.flash_attention_plain(q, k, v, **kw)
    got = fk.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        _close(g.float(), w, dtype)


@pytest.mark.parametrize("case", [("gqa2", 1, 32, 32, 4, 2, 32, True, 0),
                                  ("mqa_window_sq_lt_skv", 1, 32, 64, 4, 1,
                                   32, True, 24)],
                         ids=["gqa2", "mqa_window_sq_lt_skv"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bwd_plain_matches_pallas_interpret(case, dtype):
    from repro.kernels.flash_attention import flash_attention_bwd_pallas
    (q, k, v, do), (qn, kn, vn, don), kw = _inputs(case, dtype)
    jd = getattr(jnp, dtype)
    out, lse = fk.flash_attention_plain(q, k, v, **kw)
    jq, jk, jv, jdo, jout = (jnp.asarray(a, jd) for a in
                             (qn, kn, vn, don, out.float().numpy()))
    want = flash_attention_bwd_pallas(jq, jk, jv, jout, jnp.asarray(lse.numpy()),
                                      jdo, block_q=16, block_kv=16,
                                      interpret=True, **kw)
    got = fk.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == q.dtype
        _close(g.float(), w, dtype)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_attention_function_matches_autograd_of_the_plain_forward(case):
    """The Function's backward (the kernels' formulas) against torch
    autograd through the blockwise online-softmax forward."""
    dtype = "float32"
    (q, k, v, do), _, kw = _inputs(case, dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    leaves2 = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        fk.flash_attention_plain(*leaves2, block_kv=32, **kw)[0], leaves2, do)
    for g, w in zip(got, want):
        _close(g.float(), w.float(), dtype)


def test_cpu_backward_takes_the_plain_version_and_launches_nothing():
    (q, k, v, do), _, kw = _inputs(BWD_CASES[1], "float32")
    before = (fk.flash_attention_fwd.launches, fk.flash_attention_bwd.launches,
              rk.rmsnorm_fwd.launches)
    out, lse = fk.flash_attention_fwd(q, k, v, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = fk.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x = torch.randn(3, 64, requires_grad=True)
    ops.rmsnorm(x, torch.ones(64)).sum().backward()
    assert (fk.flash_attention_fwd.launches, fk.flash_attention_bwd.launches,
            rk.rmsnorm_fwd.launches) == before


def test_functions_build_no_graph_without_grad():
    (q, k, v, _), _, kw = _inputs(BWD_CASES[0], "float32")
    q.requires_grad_(True)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, **kw)
        y = ops.rmsnorm(q, torch.ones(q.shape[-1], requires_grad=True))
    assert out.grad_fn is None and y.grad_fn is None


# ---------------------------------------------------------------- RMSNorm
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(37, 256), (2, 3, 1024), (4, 100)],
                         ids=["d256_ragged", "d1024", "d100"])
def test_rmsnorm_function_grad_matches_reference(shape, dtype):
    from repro.models import layers as jlayers
    x, xn = _rand(shape, 13, dtype)
    g, gn = _rand(shape, 14, dtype)
    s = 1.0 + 0.1 * np.random.default_rng(15).normal(size=shape[-1]).astype(np.float32)
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, b: jlayers.rmsnorm({"scale": b}, a),
                     jnp.asarray(xn, jd), jnp.asarray(s))
    want_dx, want_ds = vjp(jnp.asarray(gn, jd))
    tx = x.clone().requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    dx, ds = torch.autograd.grad(ops.rmsnorm(tx, ts), (tx, ts), g)
    assert dx.dtype == x.dtype and ds.dtype == torch.float32
    _close(dx.float(), want_dx, dtype)
    _close(ds, want_ds, "float32")
    tx2 = x.clone().requires_grad_(True)
    ts2 = torch.from_numpy(s).requires_grad_(True)
    pdx, pds = torch.autograd.grad(rk.rmsnorm_plain(tx2, ts2), (tx2, ts2), g)
    _close(dx.float(), pdx.float(), dtype)
    _close(ds, pds, "float32")


# ------------------------------------------------------------ attn_bf16
MM_CASES = [BWD_CASES[1], BWD_CASES[3]]
# the knob's gradients: bf16 products in both, rounded at other points (the
# reference's autodiff of its blockwise scan rounds dP and each block's
# unnormalized p; the plain backward rounds its f32 formulas' inputs and
# its outputs), so within a few bf16 ulp (2^-8 relative) of each tensor's
# largest magnitude: up to 7.3e-3 measured over four of BWD_CASES
MM_GRAD_TOL = 1e-2


@pytest.mark.parametrize("case", MM_CASES, ids=[c[0] for c in MM_CASES])
def test_plain_mm_dtype_matches_the_jnp_lowering(case):
    """``flash_attention_plain(mm_dtype=bf16)`` (the ``attn_bf16`` knob on
    the CPU) against the reference's ``_flash_attention_jnp(mm_dtype=bf16)``
    on f32 inputs, causal and not: the same rounding points, so within
    F32_TOL, where the knob itself moves the output by more than 10x that;
    its backward (``FlashAttention``) against ``jax.vjp`` of the same
    lowering within MM_GRAD_TOL."""
    from repro.kernels import ops as jops
    (q, k, v, do), (qn, kn, vn, don), kw = _inputs(case, "float32")
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (qn, kn, vn, don))
    want, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
        a, b, c, block_kv=32, mm_dtype=jnp.bfloat16, **kw), jq, jk, jv)
    out, _ = fk.flash_attention_plain(q, k, v, block_kv=32, mm_dtype=torch.bfloat16, **kw)
    assert out.dtype == torch.float32
    _close(out, want, "float32")
    f32, _ = fk.flash_attention_plain(q, k, v, block_kv=32, **kw)
    assert float(np.abs(f32.numpy() - np.asarray(want)).max()) \
        > 10 * F32_TOL * float(np.abs(np.asarray(want)).max())
    wgrads = vjp(jdo)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, block_kv=32,
                                                  mm_dtype=torch.bfloat16, **kw),
                              leaves, do)
    for g, w in zip(got, wgrads):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= MM_GRAD_TOL * float(np.abs(w).max())
