"""The LM kernels' plain versions against the reference, and on a CUDA card
the kernels against their plain versions.

* flash attention (K5): ``flash_attention_plain`` against the jnp lowering
  (``repro/kernels/ops.py:_flash_attention_jnp``), the naive oracle
  (``kernels/ref.py:attention_ref``) and, where the shape divides its
  blocks, the Pallas kernel in interpret mode (out and LSE);
* decode attention (K7): ``decode_attention_plain`` against
  ``_decode_attention_jnp``, ``ref.decode_attention_ref`` and
  ``decode_attention_pallas`` in interpret mode;
* RMSNorm (K9): ``rmsnorm_plain`` against ``models/layers.py:rmsnorm``,
  ``ref.rmsnorm_ref`` and ``rmsnorm_pallas`` in interpret mode;
* on the card only: the flash-attention backward (K6) against
  ``flash_attention_bwd_plain``, and the gradients of the ``FlashAttention``
  and ``RMSNorm`` Functions on the card against the same Functions on the
  CPU (the backward's CPU tests against the JAX package:
  tests/test_torch_flash_bwd.py); decode attention also at
  jamba-1.5-large's decode shape and replayed in a CUDA graph against the
  eager call, RMSNorm also at width 8192 with a bf16 scale;

over the case axes ``chip_smoke.py`` uses on the card (causal and not,
windowed, Sq < Skv, ragged lengths, G in {1, 4, 8}, hd in {32, 64, 96,
128}; kv_len in {1, mid, Skv}; ragged rows and the four model widths), at
tiny sizes, in f32 and bf16 (the Pallas kernels, slow in interpret mode, on
the f32 cases: on bf16 inputs they run the same f32 math on the same
rounded values as the jnp lowering).

The JAX package is imported inside the tests that use it, so the card-only
cases also run on a machine without JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402

# f32: the reference's own f32 kernel tolerance (tests/test_kernels.py),
# relative to the largest value attended over: both sides sum in f32, in
# another order
F32_TOL = 2e-5

# (label, B, Sq, Skv, H, KV, hd, causal, window)
FLASH_CASES = [
    ("mha_hd32", 1, 64, 64, 4, 4, 32, True, 0),
    ("gqa4_ragged_hd64", 1, 37, 37, 8, 2, 64, True, 0),
    ("gqa8_hd128", 1, 32, 32, 16, 2, 128, True, 0),
    ("hd96", 2, 32, 32, 2, 2, 96, True, 0),
    ("sq_lt_skv", 2, 32, 96, 8, 2, 64, True, 0),
    ("noncausal_sq_lt_skv", 1, 19, 45, 4, 1, 32, False, 0),
    ("window24", 1, 96, 96, 4, 2, 32, True, 24),
    ("window16_noncausal", 1, 64, 64, 4, 4, 32, False, 16),
    ("window8_sq_lt_skv", 1, 13, 45, 4, 4, 32, True, 8),
]
# (label, B, Skv, H, KV, hd, kv_lens)
DECODE_CASES = [
    ("mha_hd64", 2, 64, 4, 4, 64, (1, 29, 64)),
    ("gqa8_hd128", 1, 40, 16, 2, 128, (1, 17, 40)),
    ("ragged_hd32_g4", 2, 77, 8, 2, 32, (1, 40, 77)),
    ("g8_hd96", 1, 50, 8, 1, 96, (1, 33, 50)),
]
# (label, shape)
RMSNORM_CASES = [("d256_ragged", (37, 256)), ("d1024", (2, 3, 1024)),
                 ("d2048", (5, 2048)), ("d3072", (3, 3072)),
                 ("d100", (4, 100))]
DTYPES = ("float32", "bfloat16")
# on the card only (too large for the Pallas kernels in interpret mode):
# jamba-1.5-large's decode shape (G 8, hd 128, 16 splits) and llava's (G
# 7, padded to 8), jamba's width 8192 with a bf16 scale at ragged prefill
# rows and a decode step's 2 rows, and llava's 7168 at its prefill's rows
CARD_DECODE_CASES = DECODE_CASES + [("jamba_decode", 2, 1040, 64, 8, 128,
                                     (1, 519, 1040)),
                                    ("llava_decode_g7", 2, 1104, 56, 8, 128,
                                     (1, 552, 1104))]
CARD_RMSNORM_CASES = ([(label, shape, "float32") for label, shape in RMSNORM_CASES]
                      + [("d8192", (77, 8192), "bfloat16"),
                         ("d8192_decode", (2, 8192), "bfloat16"),
                         ("d7168", (2176, 7168), "bfloat16")])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors, where torch's intra-op thread pool costs more
    than it saves, badly so with several test workers on the host's cores:
    one thread for the module, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, t.float().numpy()          # the (rounded) values both sides get


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _close(got, want, scale, dtype):
    """f32: within F32_TOL * scale. bf16 outputs: one bf16 ulp of the
    reference plus that (both round an f32 result computed in another
    order)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = F32_TOL * scale + (_bf16_ulp(want) if dtype == "bfloat16" else 0.0)
    np.testing.assert_array_less(np.abs(got - want), bound + 1e-30)


def _jnp(dtype):
    import jax.numpy as jnp
    return jnp, getattr(jnp, dtype)


# ---------------------------------------------------------------- K5 (CPU)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_plain_matches_reference(case, dtype):
    from repro.kernels import ops as jops
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention_fwd_pallas
    jnp, jd = _jnp(dtype)
    _, B, Sq, Skv, H, KV, hd, causal, window = case
    q, qn = _rand((B, Sq, H, hd), 1, dtype)
    k, kn = _rand((B, Skv, KV, hd), 2, dtype)
    v, vn = _rand((B, Skv, KV, hd), 3, dtype)
    out, lse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        block_kv=32)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (B * KV, H // KV, Sq)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (qn, kn, vn))
    vmax = float(np.abs(vn).max())
    want_jnp = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_kv=32)
    want_ref = ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(out.float(), want_jnp, vmax, dtype)
    _close(out.float(), want_ref, vmax, dtype)
    if Sq % 32 == 0 and Skv % 32 == 0 and dtype == "float32":
        want_pal, want_lse = flash_attention_fwd_pallas(
            jq, jk, jv, causal=causal, window=window, block_q=32, block_kv=32,
            interpret=True)
        _close(out.float(), want_pal, vmax, dtype)
        # LSE: scores are f32 sums of hd products at unit scale; only the
        # order differs, so within F32_TOL of max(1, |lse|)
        lse_want = np.asarray(want_lse)
        np.testing.assert_array_less(
            np.abs(lse.numpy() - lse_want),
            F32_TOL * np.maximum(1.0, np.abs(lse_want)))


def test_flash_attention_plain_lse_is_the_log_normaliser():
    """lse = log sum_j exp(s_ij) over the visible keys, checked directly
    (f64 on the same f32 inputs)."""
    B, S, H, KV, hd = 1, 24, 4, 2, 32
    q, _ = _rand((B, S, H, hd), 4, "float32")
    k, _ = _rand((B, S, KV, hd), 5, "float32")
    v, _ = _rand((B, S, KV, hd), 6, "float32")
    _, lse = fk.flash_attention_plain(q, k, v, causal=True, window=5)
    G = H // KV
    qd = (q.double() * hd ** -0.5).reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qd, k.double())
    i = torch.arange(S)
    vis = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 5)
    want = torch.logsumexp(s.masked_fill(~vis, float("-inf")), dim=-1)
    np.testing.assert_allclose(lse.double().numpy(),
                               want.reshape(B * KV, G, S).numpy(), atol=1e-5)


# ---------------------------------------------------------------- K7 (CPU)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_attention_plain_matches_reference(case, dtype):
    from repro.kernels import ops as jops
    from repro.kernels import ref
    from repro.kernels.decode_attention import decode_attention_pallas
    jnp, jd = _jnp(dtype)
    _, B, Skv, H, KV, hd, lens = case
    q, qn = _rand((B, 1, H, hd), 7, dtype)
    kc, kn = _rand((B, Skv, KV, hd), 8, dtype)
    vc, vn = _rand((B, Skv, KV, hd), 9, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (qn, kn, vn))
    for kv_len in lens:
        out = dk.decode_attention_plain(q, kc, vc, kv_len=kv_len)
        assert out.dtype == q.dtype and out.shape == q.shape
        vmax = float(np.abs(vn[:, :kv_len]).max())
        _close(out.float(), jops.decode_attention(jq, jk, jv, kv_len=kv_len),
               vmax, dtype)
        _close(out.float(), ref.decode_attention_ref(jq, jk, jv, kv_len=kv_len),
               vmax, dtype)
        if dtype == "float32":
            block = 32 if Skv % 32 == 0 else Skv
            _close(out.float(), decode_attention_pallas(
                jq, jk, jv, kv_len=kv_len, block_kv=block, interpret=True),
                vmax, dtype)


def test_decode_attention_plain_ignores_rows_past_kv_len():
    """Rows at or past kv_len never count: changing them changes nothing."""
    q, _ = _rand((1, 1, 4, 32), 10, "float32")
    kc, _ = _rand((1, 20, 2, 32), 11, "float32")
    vc, _ = _rand((1, 20, 2, 32), 12, "float32")
    want = dk.decode_attention_plain(q, kc, vc, kv_len=9)
    kc[:, 9:] = 1e4
    vc[:, 9:] = 1e4
    np.testing.assert_array_equal(
        dk.decode_attention_plain(q, kc, vc, kv_len=9).numpy(), want.numpy())


@pytest.mark.parametrize("BKV,kv_len", [(128, 544), (64, 1040), (1, 1), (8, 33),
                                        (300, 1000), (16, 31), (8, 1040),
                                        (16, 1040)])
def test_split_plan_covers_the_rows_with_no_empty_split(BKV, kv_len):
    """Splits of the valid rows over B * KV (x head chunks) blocks: a power
    of two, one cluster of at most MAX_SPLIT, a tile of rows or more each,
    no more than reach TARGET_BLOCKS blocks, none empty."""
    per, n = dk.split_plan(BKV, kv_len)
    assert 1 <= n <= dk.MAX_SPLIT and not n & (n - 1)
    assert (n - 1) * per < kv_len <= n * per
    assert n == 1 or (per >= dk.TILE and BKV * n // 2 < dk.TARGET_BLOCKS)


# ---------------------------------------------------------------- K9 (CPU)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", RMSNORM_CASES, ids=[c[0] for c in RMSNORM_CASES])
def test_rmsnorm_plain_matches_reference(case, dtype):
    from repro.kernels import ref
    from repro.kernels.rmsnorm import rmsnorm_pallas
    from repro.models import layers as jlayers
    jnp, jd = _jnp(dtype)
    _, shape = case
    x, xn = _rand(shape, 13, dtype)
    scale = 1.0 + 0.1 * torch.from_numpy(
        np.random.default_rng(14).normal(size=shape[-1]).astype(np.float32))
    out = rk.rmsnorm_plain(x, scale)
    assert out.dtype == x.dtype and out.shape == x.shape
    jx, js = jnp.asarray(xn, jd), jnp.asarray(scale.numpy())
    D = shape[-1]
    # the mean of D squares in another f32 order moves the norm by at most
    # D/2 * 2^-24 relative, rsqrt and the two products a few ulp more; a
    # bf16 output adds one bf16 ulp (both round once)
    for want in (jlayers.rmsnorm({"scale": js}, jx), ref.rmsnorm_ref(jx, js),
                 rmsnorm_pallas(jx, js, block_r=8, interpret=True)):
        want = np.asarray(want, np.float32)
        bound = (D / 2 + 4) * 2.0 ** -24 * np.abs(want)
        if dtype == "bfloat16":
            bound = bound + _bf16_ulp(want)
        np.testing.assert_array_less(np.abs(out.float().numpy() - want),
                                     bound + 1e-30)


# ------------------------------------------------------ dispatch on the CPU
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    q, _ = _rand((1, 8, 4, 32), 15, "float32")
    k, _ = _rand((1, 8, 2, 32), 16, "float32")
    x, _ = _rand((3, 64), 17, "float32")
    before = (fk.flash_attention_fwd.launches, dk.decode_attention.launches,
              rk.rmsnorm_fwd.launches)
    out, lse = ops.flash_attention_fwd(q, k, k, window=3)
    want, want_lse = fk.flash_attention_plain(q, k, k, window=3)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert torch.equal(ops.flash_attention(q, k, k, window=3), want)
    assert torch.equal(ops.decode_attention(q[:, :1], k, k, kv_len=5),
                       dk.decode_attention_plain(q[:, :1], k, k, kv_len=5))
    assert torch.equal(ops.rmsnorm(x, torch.ones(64)),
                       rk.rmsnorm_plain(x, torch.ones(64)))
    assert (fk.flash_attention_fwd.launches, dk.decode_attention.launches,
            rk.rmsnorm_fwd.launches) == before


@pytest.mark.parametrize("q_shape,k_shape", [((1, 9, 4, 32), (1, 8, 2, 32)),
                                             ((1, 4, 3, 32), (1, 8, 2, 32)),
                                             ((1, 4, 4, 32), (1, 8, 2, 16))])
def test_flash_attention_rejects_mismatched_shapes(q_shape, k_shape):
    """More queries than keys, heads not a multiple of kv heads, or head
    dims that differ."""
    q, k = torch.zeros(q_shape), torch.zeros(k_shape)
    with pytest.raises(ValueError):
        fk.flash_attention_fwd(q, k, k)


# ---------------------------------------------------------------- the card
def _to(x, device):
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_kernel_matches_plain(cuda_device, case, dtype):
    _, B, Sq, Skv, H, KV, hd, causal, window = case
    q, _ = _rand((B, Sq, H, hd), 1, dtype)
    k, _ = _rand((B, Skv, KV, hd), 2, dtype)
    v, vn = _rand((B, Skv, KV, hd), 3, dtype)
    q, k, v = (_to(t, cuda_device) for t in (q, k, v))
    before = fk.flash_attention_fwd.launches
    out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert fk.flash_attention_fwd.launches == before + 1
    want, want_lse = fk.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)
    torch.cuda.synchronize()
    _close(out.float().cpu(), want.float().cpu(), float(np.abs(vn).max()), dtype)
    w = want_lse.cpu().numpy()
    np.testing.assert_array_less(np.abs(lse.cpu().numpy() - w),
                                 F32_TOL * np.maximum(1.0, np.abs(w)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CARD_DECODE_CASES,
                         ids=[c[0] for c in CARD_DECODE_CASES])
def test_decode_attention_kernel_matches_plain(cuda_device, case, dtype):
    _, B, Skv, H, KV, hd, lens = case
    q, _ = _rand((B, 1, H, hd), 7, dtype)
    kc, _ = _rand((2, B, Skv, KV, hd), 8, dtype)      # one layer of a stack
    vc, vn = _rand((2, B, Skv, KV, hd), 9, dtype)
    q, kc, vc = (_to(t, cuda_device) for t in (q, kc[1], vc[1]))
    for kv_len in lens:
        before = dk.decode_attention.launches
        out = dk.decode_attention(q, kc, vc, kv_len=kv_len)
        assert dk.decode_attention.launches == before + 1
        want = dk.decode_attention_plain(q, kc, vc, kv_len=kv_len)
        torch.cuda.synchronize()
        _close(out.float().cpu(), want.float().cpu(),
               float(np.abs(vn[1][:, :kv_len]).max()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CARD_RMSNORM_CASES,
                         ids=[c[0] for c in CARD_RMSNORM_CASES])
def test_rmsnorm_kernel_matches_plain(cuda_device, case, dtype):
    _, shape, scale_dtype = case
    x, _ = _rand(shape, 13, dtype)
    x = x.to(cuda_device)
    scale = torch.linspace(0.5, 1.5, shape[-1], device=cuda_device).to(
        getattr(torch, scale_dtype))
    before = rk.rmsnorm_fwd.launches
    out = rk.rmsnorm(x, scale)
    assert rk.rmsnorm_fwd.launches == before + 1
    want = rk.rmsnorm_plain(x, scale).float().cpu().numpy()
    torch.cuda.synchronize()
    bound = (shape[-1] / 2 + 4) * 2.0 ** -24 * np.abs(want)
    if dtype == "bfloat16":
        bound = bound + _bf16_ulp(want)
    np.testing.assert_array_less(np.abs(out.float().cpu().numpy() - want),
                                 bound + 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Skv,H,KV,hd,kv_len", [(4, 1040, 16, 2, 128, 519),
                                                  (2, 77, 8, 2, 32, 77)])
def test_decode_attention_graph_replays_match_eager(cuda_device, B, Skv, H, KV,
                                                    hd, kv_len, dtype):
    """The splits merge inside one launch (a thread-block cluster): a call
    captured in a CUDA graph and replayed twice gives the eager output bit
    for bit both times."""
    q, _ = _rand((B, 1, H, hd), 7, dtype)
    kc, _ = _rand((B, Skv, KV, hd), 8, dtype)
    vc, _ = _rand((B, Skv, KV, hd), 9, dtype)
    q, kc, vc = (_to(t, cuda_device) for t in (q, kc, vc))
    eager = dk.decode_attention(q, kc, vc, kv_len=kv_len)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dk.decode_attention(q, kc, vc, kv_len=kv_len)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, eager) and torch.equal(out, eager)


@pytest.mark.cuda
def test_kernel_wrappers_raise_instead_of_falling_back(cuda_device):
    q = torch.zeros(1, 1, 4, 32, device=cuda_device)
    kc = torch.zeros(1, 8, 2, 32, device=cuda_device)
    with pytest.raises(TypeError, match="host int"):
        dk.decode_attention(q, kc, kc, kv_len=torch.tensor(3, device=cuda_device))
    with pytest.raises(ValueError, match="kv_len"):
        dk.decode_attention(q, kc, kc, kv_len=0)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention_fwd(torch.zeros(1, 4, 2, 48, device=cuda_device),
                               torch.zeros(1, 4, 2, 48, device=cuda_device),
                               torch.zeros(1, 4, 2, 48, device=cuda_device))
    with pytest.raises(TypeError):
        rk.rmsnorm(torch.zeros(2, 8, dtype=torch.float16, device=cuda_device),
                   torch.ones(8, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        rk.rmsnorm(torch.zeros(8, 4, device=cuda_device).t(),
                   torch.ones(8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, case, dtype):
    """K6 against its plain version on the same out and lse (the forward
    kernel's), each gradient within F32_TOL of its largest magnitude (plus
    one bf16 ulp in bf16)."""
    _, B, Sq, Skv, H, KV, hd, causal, window = case
    q, k, v, do = (_to(_rand(shape, seed, dtype)[0], cuda_device) for shape, seed in
                   (((B, Sq, H, hd), 1), ((B, Skv, KV, hd), 2),
                    ((B, Skv, KV, hd), 3), ((B, Sq, H, hd), 4)))
    out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = fk.flash_attention_bwd.launches
    got = fk.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    assert fk.flash_attention_bwd.launches == before + 1
    want = fk.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        w = w.float().cpu()
        _close(g.float().cpu(), w, float(w.abs().max()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_function_gradients_on_the_card_match_the_cpu(cuda_device, dtype):
    """FlashAttention (K5 + K6) and RMSNorm (K9 + its torch backward) on
    the card against the same Functions on the CPU (the plain versions).
    In bf16 the attention gradients are held against the CPU's backward fed
    the card's forward output: delta = rowsum(dO * O) reads the bf16-rounded
    output, and K5 and the plain forward may round an element of it one
    ulp apart, which moves every ds of its row by that much."""
    B, S, H, KV, hd, window = 2, 77, 8, 2, 64, 24
    q, k, v, do = (_rand(shape, seed, dtype)[0] for shape, seed in
                   (((B, S, H, hd), 21), ((B, S, KV, hd), 22),
                    ((B, S, KV, hd), 23), ((B, S, H, hd), 24)))
    x, _ = _rand((37, 256), 25, dtype)
    gx, _ = _rand((37, 256), 26, dtype)
    scale = torch.linspace(0.5, 1.5, 256)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_attention(*leaves, window=window)
        ga = torch.autograd.grad(out, leaves, do.to(dev))
        xs = [x.to(dev).requires_grad_(True), scale.to(dev).requires_grad_(True)]
        gr = torch.autograd.grad(ops.rmsnorm(*xs), xs, gx.to(dev))
        grads[str(dev)] = [t.float().cpu() for t in ga + gr]
    if dtype == "bfloat16":
        out, lse = fk.flash_attention_fwd(*(t.to(cuda_device) for t in (q, k, v)),
                                          window=window)
        grads["cpu"][:3] = [t.float() for t in fk.flash_attention_bwd_plain(
            q, k, v, out.cpu(), lse.cpu(), do, window=window)]
    torch.cuda.synchronize()
    for g, w in zip(grads[str(cuda_device)], grads["cpu"]):
        assert float(g.abs().max()) > 0.0
        _close(g, w, float(w.abs().max()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernels_take_strided_rows(cuda_device, dtype):
    """K5 and K6 on q, k, v that are views into one fused [B, S, H + 2 KV,
    hd] buffer (seq stride (H + 2 KV) hd, batch stride S times that): the
    bf16 route's TMA maps and the f32 route's pointers take the strides
    the wrapper passes. Held against the plain versions on the same views
    (the backward fed the kernel's out and lse), as above."""
    B, S, H, KV, hd = 2, 150, 8, 2, 64
    fused, _ = _rand((B, S, H + 2 * KV, hd), 31, dtype)
    fused = fused.to(cuda_device)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + KV], fused[:, :, H + KV:]
    assert not q.is_contiguous() and q.stride(1) == (H + 2 * KV) * hd
    do, _ = _rand((B, S, H, hd), 32, dtype)
    do = do.to(cuda_device)
    out, lse = fk.flash_attention_fwd(q, k, v)
    want, want_lse = fk.flash_attention_plain(q, k, v)
    got = fk.flash_attention_bwd(q, k, v, out, lse, do)
    wants = fk.flash_attention_bwd_plain(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    _close(out.float().cpu(), want.float().cpu(), float(v.float().abs().max()), dtype)
    w = want_lse.cpu().numpy()
    np.testing.assert_array_less(np.abs(lse.cpu().numpy() - w),
                                 F32_TOL * np.maximum(1.0, np.abs(w)))
    for g, w in zip(got, wants):
        w = w.float().cpu()
        _close(g.float().cpu(), w, float(w.abs().max()), dtype)
