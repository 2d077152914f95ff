"""The arithmetic of the selective-scan (K8, ``csrc/ssm_scan.cu``) and the
sorted-reducer (K3, ``csrc/fedagg.cu``: ``sorted_reg_kernel``) kernels,
emulated on the CPU in their order of operations, against the plain
versions under ``chip_smoke.py``'s own bounds.

K8, for each channel d of sequence b, from h = 0, step by step:
A' = fl(A log2 e) once; e = ex2(fl(dt A')); dx = fl(dt x);
h_n = fma(e, h_n, fl(dx B_n)). One thread holds the channel's 16 states
(padded with A = B = C = 0 past N); its sum is fl(h C) for the first
state, then an fma chain in ascending state; y = fma(D, x, sum), rounded
once to x's dtype. ex2.approx.ftz is emulated
as the exact 2^z rounded to f32, then moved by its documented bound, 2 ulp
of the result (at most 2^-22 relative), in one direction at every step —
the direction that lets the error pile up — and flushed to 0 below 2^-126.
A far coarser exponential (2^-12 relative) must fail the same bound, so the
emulation can tell.

K3 at P <= 64: the network that the kernel's templates unroll
(``bitonic_from<P, 2, 1>``: stages (K, J) for K = 2, 4, .., P and
J = K/2, .., 1, in each the P/2 pairs T -> (i, l = i + J), i = T with a 0
bit inserted at J, ascending where bit K of i is clear; each exchange one
NaN-propagating min and max), here as the same (k, j, i, l, asc) list,
against ``sort_cols_plain`` bit for bit, NaN placement included; then the
order statistics by the kernel's unrolled selects and predicated adds.

An f32 fma is emulated in f64 (the product of two f32 values is exact in
f64) and rounded to f32.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fedagg as fk  # noqa: E402
from repro_torch.kernels import ssm_scan as sk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

MAX_N = 16
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)   # kLog2e
EX2_ULPS = 2          # CUDA's stated bound for exp2f (one MUFU ex2) and expf
# chip_smoke's SSM_CASES, and S = 1024 (the jamba prefill's length) at
# narrow Di
SCAN_CASES = chip_smoke.SSM_CASES + [(1, 1024, 64, 16), (2, 1024, 32, 16),
                                     (1, 1024, 40, 4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _ulp(x):
    return torch.exp2(torch.floor(torch.log2(torch.clamp(torch.abs(x), min=2.0 ** -126))) - 23)


def ex2_emulated(z, ulps, rel=None):
    """ex2.approx.ftz.f32 of an f32 z: the exact 2^z rounded to f32, moved
    up by ``ulps`` ulp of itself (``rel`` None) or by ``rel`` relative, and
    flushed to 0 below the smallest normal."""
    e = torch.exp2(z.double()).float()
    if rel is None:
        e = (e.double() + ulps * _ulp(e).double()).float()
    else:
        e = (e.double() * (1.0 + rel)).float()
    return torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)


def scan_emulated(x, dt, A, B, C, D, ulps=EX2_ULPS, rel=None):
    """(y, h_S) in the kernel's order of operations, ex2 off by ``ulps``
    (or ``rel``) at every step."""
    Bt, S, Di = x.shape
    N = A.shape[1]
    pad = lambda t: torch.nn.functional.pad(t, (0, MAX_N - N))  # noqa: E731
    Ap = pad(A.float() * LOG2E)                     # [Di, 16], f32 rounding
    Bp, Cp = pad(B.float()), pad(C.float())         # [Bt, S, 16]
    h = torch.zeros(Bt, Di, MAX_N)
    y = torch.empty(Bt, S, Di)
    for t in range(S):
        xv, dtv = x[:, t].float(), dt[:, t]
        e = ex2_emulated(dtv[..., None] * Ap, ulps, rel)
        dx = dtv * xv
        h = _fma(e, h, dx[..., None] * Bp[:, t, None, :])
        c = Cp[:, t, None, :].expand_as(h)
        acc = h[..., 0] * c[..., 0]
        for n in range(1, MAX_N):
            acc = _fma(h[..., n], c[..., n], acc)
        y[:, t] = _fma(D.float(), xv, acc)
    return y.to(x.dtype), h[..., :N]


def _scan_case(i, Bt, S, Di, N, dtype=torch.float32):
    args = chip_smoke.ssm_inputs(Bt, S, Di, N, dtype, "cpu", 400 + i)
    return args, sk.ssm_scan_plain(*args, return_state=True)


@pytest.mark.parametrize("i,case", list(enumerate(SCAN_CASES)))
def test_scan_order_holds_the_card_bound(i, case):
    """The kernel's arithmetic, with ex2 at its stated error in either
    direction, within ssm_close's bound of the plain scan: output and final
    state, f32 x (bf16 only widens the bound by a bf16 ulp)."""
    args, (want, h_want) = _scan_case(i, *case)
    for ulps in (EX2_ULPS, -EX2_ULPS):
        y, h = scan_emulated(*args, ulps)
        ok, err = chip_smoke.ssm_close(y, want, torch.float32)
        h_ok, h_err = chip_smoke.ssm_close(h, h_want, torch.float32)
        assert ok, f"y: max_abs_err {err} (ex2 {ulps:+d} ulp)"
        assert h_ok, f"h_S: max_abs_err {h_err} (ex2 {ulps:+d} ulp)"


@pytest.mark.parametrize("i,case", list(enumerate(SCAN_CASES)))
def test_scan_order_holds_the_bound_in_bf16(i, case):
    """A bf16 x and y, the jamba prefill's dtype, ex2 at its stated error
    upward."""
    args, (want, h_want) = _scan_case(i, *case, dtype=torch.bfloat16)
    y, h = scan_emulated(*args)
    assert y.dtype == torch.bfloat16
    assert chip_smoke.ssm_close(y, want, torch.bfloat16)[0]
    assert chip_smoke.ssm_close(h, h_want, torch.float32)[0]


@pytest.mark.parametrize("case", [(1, 300, 1000, 16), (1, 1024, 64, 16)])
def test_scan_bound_fails_under_a_coarser_exponential(case):
    """ex2 off by 2^-12 relative at every step breaks the bound: the
    emulation above can fail."""
    args, (want, h_want) = _scan_case(SCAN_CASES.index(case), *case)
    y, h = scan_emulated(*args, rel=2.0 ** -12)
    assert not chip_smoke.ssm_close(y, want, torch.float32)[0]
    assert not chip_smoke.ssm_close(h, h_want, torch.float32)[0]


def test_scan_order_alone_leaves_the_margin_to_ex2():
    """With a correctly rounded ex2 the emulated kernel and the plain scan
    differ only by the f32 roundings of the exponent and the summation
    order: under half the bound, so most of its margin is ex2's to spend."""
    args, (want, _) = _scan_case(2, *SCAN_CASES[2])
    y, _ = scan_emulated(*args, ulps=0)
    bound = chip_smoke.SSM_TOL * max(1.0, float(want.abs().max()))
    assert float((y - want).abs().max()) < 0.5 * bound


# ----------------------------------------------------------------- K3 sort
def register_schedule(P):
    """The (k, j, i, l, asc) exchanges of ``bitonic_from<P, 2, 1>``, in the
    order the templates expand them."""
    out = []
    k = 2
    while k <= P:
        j = k // 2
        while j >= 1:
            for t in range(P // 2):
                i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
                out.append((k, j, i, i | j, (i & k) == 0))
            j //= 2
        k *= 2
    return out


def sort_registers(v):
    """The kernel's network over the rows of a [P, M] f32 tensor (each
    column one thread's registers)."""
    v = list(v.unbind(0))
    for _, _, i, l, asc in register_schedule(len(v)):
        lo, hi = torch.minimum(v[i], v[l]), torch.maximum(v[i], v[l])
        v[i], v[l] = (lo, hi) if asc else (hi, lo)
    return torch.stack(v)


def order_statistics(s, n, trim_frac):
    """The kernel's epilogue over sorted columns s [P, M]: median by
    unrolled selects, trimmed mean by predicated adds in ascending i."""
    P = s.shape[0]
    if trim_frac is None:
        lo, hi = (n - 1) >> 1, n >> 1
        a = torch.zeros(s.shape[1])
        b = torch.zeros(s.shape[1])
        for i in range(P):
            a = s[i] if i == lo else a
            b = s[i] if i == hi else b
        return 0.5 * (a + b) if n > 0 else torch.zeros(s.shape[1])
    t = int(np.float32(trim_frac) * np.float32(n))
    total = torch.zeros(s.shape[1])
    for i in range(P):
        if t <= i < n - t:
            total = total + s[i]
    cnt = n - 2 * t
    return total / cnt if cnt > 0 else torch.zeros(s.shape[1])


def _bits_equal(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32)))


def _sort_case(C, seed, *, gated=(), nan_row=None, M=257):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.normal(size=(C, M)).astype(np.float32))
    g = torch.ones(C)
    for r in gated:
        g[r] = 0.0
    if nan_row is not None:
        u[nan_row, ::5] = float("nan")
    return u, g


def _kernel_columns(u, g):
    """The kernel's registers before the network: the included rows, +inf
    for gated-out and pad rows."""
    C = u.shape[0]
    P = fk._next_pow2(C)
    v = torch.full((P, u.shape[1]), float("inf"))
    v[:C] = torch.where((g > 0)[:, None], u, float("inf"))
    return v


@pytest.mark.parametrize("P", [2, 4, 8, 16, 32, 64])
def test_register_schedule_is_the_reference_network(P):
    """P/2 disjoint pairs a stage covering every row, L(L+1)/2 stages, and
    the exchange count chip_smoke's bound charges."""
    sched = register_schedule(P)
    L = P.bit_length() - 1
    assert len(sched) == P // 2 * L * (L + 1) // 2
    assert 2 * len(sched) == chip_smoke.sort_ops(P, 1)
    stages = {}
    for k, j, i, l, _ in sched:
        stages.setdefault((k, j), []).extend([i, l])
    assert len(stages) == L * (L + 1) // 2
    for rows in stages.values():
        assert sorted(rows) == list(range(P))


@pytest.mark.parametrize("C", [2, 3, 4, 5, 7, 8, 9, 13, 16, 17, 31, 32, 33, 48,
                               60, 63, 64])
def test_register_network_matches_the_plain_sort_bit_for_bit(C):
    """Every P in {2, .., 64}, C a power of two or not, two gated-out rows
    and an included NaN row: the same values in the same places as
    sort_cols_plain, NaNs included."""
    gated = (1, C - 1) if C > 2 else ()
    nan_row = C // 2 if C // 2 not in gated else 0
    u, g = _sort_case(C, C, gated=gated, nan_row=nan_row)
    got = sort_registers(_kernel_columns(u, g))[:C]
    want = fk.sort_cols_plain(torch.where((g > 0)[:, None], u, float("inf")))
    assert _bits_equal(got, want)
    assert bool(torch.isnan(got).any())


@pytest.mark.parametrize("C", [1, 3, 8, 20, 60, 64])
@pytest.mark.parametrize("reducer", ["median", "trimmed_mean"])
@pytest.mark.parametrize("case", ["mixed", "nan_included", "none"])
def test_register_epilogue_matches_the_plain_reducers(C, reducer, case):
    """The whole register route against fedagg_plain: the median exactly,
    the trimmed mean within chip_smoke's f32 bound, NaN masks equal, zero
    inclusion exact zeros."""
    rng = np.random.default_rng(100 + C)
    g = torch.from_numpy((rng.random(C) > 0.3).astype(np.float32))
    g[0] = 1.0
    nan_row = None
    if case == "nan_included":
        nan_row = C - 1
        g[nan_row] = 1.0
    if case == "none":
        g[:] = 0.0
    u, _ = _sort_case(C, 200 + C, nan_row=nan_row)
    trim = chip_smoke.TRIM_FRAC if reducer == "trimmed_mean" else None
    n = int((g > 0).sum())
    got = order_statistics(sort_registers(_kernel_columns(u, g)), n, trim)
    w = torch.ones(C)
    want = fk.fedagg_plain(u, w, g, aggregator=reducer,
                           trim_frac=trim if trim is not None else 0.0)
    assert bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = ~torch.isnan(want)
    if case == "none":
        assert bool(torch.all(got == 0))
    if reducer == "median":
        assert bool(torch.equal(got[fin], want[fin]))
    else:
        r = u[g > 0]
        r = r[torch.isfinite(r)]
        bound = chip_smoke.F32_TOL * max(float(r.abs().max()) if r.numel() else 0.0,
                                         1e-30)
        diff = (got[fin] - want[fin]).abs()
        assert (float(diff.max()) if diff.numel() else 0.0) <= bound


def test_sorted_bound_divides_by_the_min_max_rate():
    """At P = 64 the operations bound is the network's min and max over the
    64 results a clock per SM of f32 compare / min / max (compute
    capability 9.0), above the 0.042 ms of bytes at 60 x 579,402 f32."""
    C, M = 60, 579402
    ops = chip_smoke.sort_ops(C, M)
    assert ops == 2 * 672 * M
    bound, by = chip_smoke.variant_bound("median", "identity_f32", {}, C, C, M)
    assert by == "operations"
    assert bound == pytest.approx(1e3 * ops / chip_smoke.H100_MINMAX_PER_S)
    assert chip_smoke.H100_MINMAX_PER_S == pytest.approx(64 * 132 * 1.98e9)
