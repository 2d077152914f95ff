"""The walk of fedagg's stream kernel over identity rows (K1 mean and K2 dp:
``stream_kernel`` with ``DecIdentity`` in ``csrc/fedagg.cu``), emulated on
the CPU, against the order the outputs' bits rest on.

The kernel (``launch_stream``): a block of kThreads threads for each
kThreads x vw columns, thread t of block b the vw columns at (b kThreads +
t) vw, vw the widest load (4, 2, 1 f32; 8, 4, 2, 1 bf16) that the row pitch
and the pointers allow (``_vector_width``). The block stages the included
rows kThreads at a time (``stage_rows``: their indices and weights
compacted in ascending order by a ballot a warp, den += each warp's 32-row
tree sum, the warps in order); each thread adds the staged rows to its
columns, kUnroll rows' loads in flight, then the rest of the chunk row by
row; the thread whose columns run past M (a ragged M) reads them element
by element. Then ``finish``.

The order: per column one fmaf an included row, ascending, from 0; den the
32-row tree sums in row order; then finish. Every vw, chunking and grid
gives it, so the output does not depend on the launch's geometry.

An f32 fma is emulated in f64 (the product of two f32 values is exact
there) and rounded to f32, as in ``test_torch_fedagg_decode_numerics.py``;
both sides use the same emulation, so bit equality is about the order.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.aggregation import pitched_empty  # noqa: E402
from repro_torch.kernels import fedagg as fk  # noqa: E402

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "csrc" / "fedagg.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS = _const("kThreads")             # threads a block; stage_rows' chunk
WARPS = THREADS // 32
UNROLL = int(re.search(r"struct DecIdentity \{.*?kUnroll = (\d+);", SRC,
                       re.S).group(1))
F2_M = 463987712                         # qwen1.5-0.5b's parameter count
WIDTHS = {torch.float32: (4, 2, 1), torch.bfloat16: (8, 4, 2, 1)}

GRID_LINES = ("const long long per_block = static_cast<long long>(kThreads) * Dec::kVW;",
              "const long long blocks = (a.M + per_block - 1) / per_block;")


def stream_grid(M, vw):
    """launch_stream's blocks: one for each kThreads x vw columns."""
    return -(-M // (THREADS * vw))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _bits(x):
    x = x.contiguous()
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16)


def _same_bits(a, b):
    nan = torch.isnan(a.float())
    assert torch.equal(nan, torch.isnan(b.float()))
    assert torch.equal(_bits(a)[~nan], _bits(b)[~nan])


def _tree32(x):
    """Lane 0's value after ``part += __shfl_down_sync(part, off)`` for off
    16, 8, 4, 2, 1 over 32 f32 lanes (a lane past the warp gets its own)."""
    v = x.clone()
    off = 16
    while off:
        shifted = torch.cat([v[off:], v[32 - off:]])
        v = v + shifted
        off //= 2
    return v[0]


def _lanes(wg, k0):
    part = torch.zeros(32, dtype=torch.float32)
    hi = min(k0 + 32, wg.shape[0])
    if hi > k0:
        part[:hi - k0] = wg[k0:hi]
    return part


def den_staged(wg):
    """stage_rows: per chunk of kThreads rows, each warp's tree sum, the
    warps in order (zero sums for rows past C)."""
    den = torch.tensor(0.0)
    for c0 in range(0, wg.shape[0], THREADS):
        for k0 in range(c0, c0 + THREADS, 32):
            den = den + _tree32(_lanes(wg, k0))
    return den


def den_in_row_order(wg):
    """Each 32 rows' tree sum, in row order, up to C."""
    den = torch.tensor(0.0)
    for k0 in range(0, wg.shape[0], 32):
        den = den + _tree32(_lanes(wg, k0))
    return den


def _finish(acc, den, noise, noise_scale, dp):
    if not bool(den > 0):
        return torch.zeros_like(acc)
    safe = torch.clamp(den, min=1e-30)
    if not dp:
        return acc / safe
    return acc / safe + noise * (torch.tensor(noise_scale, dtype=torch.float32) / safe)


def _weights(w, g, rs, dp):
    """wg = fl(w g) and the contraction weight fl(wg rs) (dp) of the
    included rows; dp's clip scale is read only for them."""
    wg = w * g
    inc = wg > 0
    wr = torch.where(inc, wg * torch.where(inc, rs, 1.0) if dp else wg, 0.0)
    return wg, inc, wr


def column_order(u, w, g, rs, noise, noise_scale, dp):
    """Per column an fmaf chain over the included rows in ascending order,
    den in row order, then finish."""
    wg, inc, wr = _weights(w, g, rs, dp)
    acc = torch.zeros(u.shape[1], dtype=torch.float32)
    for k in range(u.shape[0]):
        if inc[k]:
            acc = _fma(wr[k], u[k].float(), acc)
    return _finish(acc, den_in_row_order(wg), noise, noise_scale, dp).to(u.dtype)


def staged_chunk(inc, wr, c0):
    """stage_rows over rows [c0, c0 + kThreads): the included ones in
    ascending order (each warp's ballot, the warps in order), each (row,
    weight)."""
    rows = []
    for warp in range(WARPS):
        for lane in range(32):
            k = c0 + 32 * warp + lane
            if k < inc.shape[0] and inc[k]:
                rows.append((k, wr[k]))
    return rows


def stream_walk(u, w, g, rs, noise, noise_scale, dp, vw):
    """The kernel's schedule on the CPU at load width vw: (out, the number
    of threads that store each column, the row loads a full thread issues
    in groups of kUnroll and one by one, the columns read element by
    element)."""
    C, M = u.shape
    grid = stream_grid(M, vw)
    width = THREADS * vw
    assert (grid - 1) * width < M <= grid * width        # no block without a column
    wg, inc, wr = _weights(w, g, rs, dp)
    uf = u.float()
    out = torch.full((M,), float("nan"))
    owners = torch.zeros(M, dtype=torch.int64)
    scalar = torch.zeros(M, dtype=torch.bool)
    loads = None
    for b in range(grid):
        b0, b1 = b * width, min((b + 1) * width, M)
        full = b0 + (b1 - b0) // vw * vw                 # the full threads' end
        for t in range(THREADS):
            col = (b * THREADS + t) * vw
            if col < M:                                  # live
                owners[col:min(col + vw, M)] += 1
                if col + vw > M:
                    scalar[col:M] = True
        acc = torch.zeros(b1 - b0, dtype=torch.float32)
        den = torch.tensor(0.0)
        groups = singles = 0
        for c0 in range(0, C, THREADS):
            for k0 in range(c0, c0 + THREADS, 32):       # s_warp_den, in order
                den = den + _tree32(_lanes(wg, k0))
            chunk = staged_chunk(inc, wr, c0)
            j = 0
            while j + UNROLL <= len(chunk):              # UNROLL loads, then adds
                for k, weight in chunk[j:j + UNROLL]:
                    acc[:full - b0] = _fma(weight, uf[k, b0:full], acc[:full - b0])
                j += UNROLL
                groups += 1
            for k, weight in chunk[j:]:
                acc[:full - b0] = _fma(weight, uf[k, b0:full], acc[:full - b0])
                singles += 1
            for k, weight in chunk:                      # the ragged tail's thread
                for m in range(full, b1):
                    acc[m - b0] = _fma(weight, uf[k, m:m + 1], acc[m - b0:m - b0 + 1])[0]
        out[b0:b1] = _finish(acc, den, noise[b0:b1], noise_scale, dp)
        assert loads in (None, (groups, singles))        # the same in every block
        loads = (groups, singles)
    return out.to(u.dtype), owners, loads, scalar


def loads_a_thread(C, n_of):
    """(groups of kUnroll, single rows) a full thread loads, chunk by chunk
    of kThreads rows; n_of(c0) the included rows of a chunk."""
    chunks = [n_of(c0) for c0 in range(0, C, THREADS)]
    return sum(c // UNROLL for c in chunks), sum(c % UNROLL for c in chunks)


def _case(C, M, dtype, *, seed=0, gates="mixed", nan_row=None, pitch=None):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(C, M)).astype(np.float32)
    w = (rng.random(C) + 0.1).astype(np.float32)
    g = (rng.random(C) > 0.3).astype(np.float32)
    g[0] = 1.0
    if gates == "all":
        g[:] = 1.0
    elif gates == "none":
        g[:] = 0.0
    rs = rng.random(C).astype(np.float32)
    noise = rng.normal(size=M).astype(np.float32)
    if nan_row is not None:
        u[nan_row] = np.nan
        g[nan_row] = 0.0
        rs[nan_row] = np.nan
    tu = torch.from_numpy(u).to(dtype)
    if pitch is not None:                       # rows of a wider buffer
        buf = torch.full((C, pitch), float("nan"), dtype=dtype)
        buf[:, :M] = tu
        tu = buf[:, :M]
    return (tu, torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(rs),
            torch.from_numpy(noise))


# ------------------------------------------------------------------ geometry
def test_constants_match_the_source():
    """The launch gives a block kThreads x vw columns (the grid this file
    mirrors), the identity decoder keeps kUnroll rows' loads in flight, the
    widest vw is a 16-byte load, and every identity vw runs the stream
    kernel."""
    for line in GRID_LINES:
        assert line in SRC
    assert THREADS % 32 == 0 and UNROLL >= 4
    assert all(vw * torch.empty((), dtype=dt).element_size() <= 16
               for dt, widths in WIDTHS.items() for vw in widths)
    for vw in (4, 2, 1):
        assert f"launch_stream<DecIdentity<F, {vw}>, kDP, F>" in SRC
    for vw in (8, 4, 2, 1):
        assert f"launch_stream<DecIdentity<B, {vw}>, kDP, B>" in SRC


@pytest.mark.parametrize("vw", [1, 2, 4, 8])
@pytest.mark.parametrize("M", [1, 3, 7, 8, 100, 610, 1023, 1024, 1025, 2048,
                               4099, 8195, 579402, 10 ** 7 + 3, F2_M])
def test_stream_grid(M, vw):
    """launch_stream's check: a block for each kThreads x vw columns, no
    block without one, the grid within the launch's limit."""
    grid = stream_grid(M, vw)
    width = THREADS * vw
    assert (grid - 1) * width < M <= grid * width and grid < 2 ** 31


def test_stream_grid_at_the_timed_shapes():
    """Cell (b)'s 579,402 columns, the LM round's 463,987,712 (whose last
    row starts past 2^31 elements: 64-bit offsets) and 20 x 610."""
    assert stream_grid(579402, 4) == 566
    assert stream_grid(579402, 8) == 283
    assert stream_grid(F2_M, 4) == 453113
    assert stream_grid(610, 4) == 1
    assert 7 * F2_M > 2 ** 31


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 7, 610, 1027, 579402])
def test_vector_width_of_the_fused_rows_is_16_bytes(M, dtype):
    """flatten_stacked's rows (pitched_empty) and the output take the
    widest load; rows at an odd pitch (per-leaf rows) take narrower ones."""
    rows = pitched_empty(3, M, dtype, "cpu")
    out = torch.empty(M, dtype=dtype)
    widths = WIDTHS[dtype]
    assert fk._vector_width(widths, rows.stride(0), rows, out) == widths[0]
    odd = torch.empty(3, 2 * M + 1, dtype=dtype)[:, :M]
    assert fk._vector_width(widths, odd.stride(0), odd, out) == 1


# ------------------------------------------------------------------ den order
def test_staged_chunks_are_the_included_rows_in_order():
    """stage_rows' chunks, concatenated, are the included rows in
    ascending order, each at most kThreads."""
    rng = np.random.default_rng(3)
    for C in (1, 40, 129, 300, 1000):
        g = torch.from_numpy((rng.random(C) > 0.3).astype(np.float32))
        wg, inc, wr = _weights(torch.ones(C), g, torch.ones(C), False)
        chunks = [staged_chunk(inc, wr, c0) for c0 in range(0, C, THREADS)]
        assert all(len(c) <= THREADS for c in chunks)
        assert [k for c in chunks for k, _ in c] == torch.nonzero(inc).flatten().tolist()


@pytest.mark.parametrize("C", [1, 5, 31, 32, 33, 60, 255, 256, 257, 300, 1000, 1025])
def test_den_by_chunks_is_the_row_order_sum_bit_for_bit(C):
    """stage_rows' den (the 32-row tree sums by chunks of kThreads, zero
    sums past C) and the same sums in row order up to C are the same bits:
    den starts at +0 and adding +0 changes no value."""
    rng = np.random.default_rng(C)
    w = (rng.random(C) * 10.0 ** rng.integers(-6, 6, C)).astype(np.float32)
    g = (rng.random(C) > 0.3).astype(np.float32)
    wg = torch.from_numpy(w * g)
    _same_bits(den_staged(wg), den_in_row_order(wg))
    zeros = torch.zeros(C)
    assert not bool(torch.signbit(den_staged(zeros)))


# ------------------------------------------------------------------ the walk
WALKS = [  # (C, M): one block and many; less than a block; ragged M; C past
    # one 256-row chunk of stage_rows
    (1, 7), (1, 1000), (3, 100), (8, 1027), (8, 8195), (20, 610),
    (60, 5003), (257, 2051), (1000, 1029)]
ROUTES = [(torch.float32, 4), (torch.float32, 2), (torch.float32, 1),
          (torch.bfloat16, 8), (torch.bfloat16, 4), (torch.bfloat16, 2),
          (torch.bfloat16, 1)]


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
@pytest.mark.parametrize("dtype,vw", ROUTES,
                         ids=[f"{'f32' if d == torch.float32 else 'bf16'}-vw{v}"
                              for d, v in ROUTES])
@pytest.mark.parametrize("C,M", WALKS)
def test_walk_is_the_column_order_bit_for_bit(C, M, dtype, vw, dp):
    """Every column stored by one thread, the ragged tail (and only it)
    read element by element, every included row loaded once a thread, and
    the output bit for bit the column order's, at every vw."""
    u, w, g, rs, noise = _case(C, M, dtype, seed=C + M)
    out, owners, loads, scalar = stream_walk(u, w, g, rs, noise, 0.3, dp, vw)
    assert torch.equal(owners, torch.ones(M, dtype=torch.int64))
    assert int(scalar.sum()) == M % vw
    inc = (w * g) > 0
    assert loads == loads_a_thread(C, lambda c0: int(inc[c0:c0 + THREADS].sum()))
    _same_bits(out, column_order(u, w, g, rs, noise, 0.3, dp))


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_zero_inclusion_gives_exact_zeros(dtype, dp):
    u, w, g, rs, noise = _case(6, 2053, dtype, gates="none")
    out, _, loads, _ = stream_walk(u, w, g, rs, noise, 0.3, dp, WIDTHS[dtype][0])
    assert loads == (0, 0)
    assert bool(torch.all(out == 0)) and not bool(torch.signbit(out.float()).any())


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_nan_behind_a_zero_gate_never_read(dtype, dp):
    """A NaN row and its NaN clip scale behind a zero gate: finite, and the
    same bits as with the row cleaned."""
    u, w, g, rs, noise = _case(300, 1031, dtype, nan_row=257)
    out, *_ = stream_walk(u, w, g, rs, noise, 0.3, dp, WIDTHS[dtype][0])
    assert bool(torch.isfinite(out.float()).all())
    clean_u, clean_rs = u.clone(), rs.clone()
    clean_u[257], clean_rs[257] = 0.0, 1.0
    _same_bits(out, column_order(clean_u, w, g, clean_rs, noise, 0.3, dp))


def _close(got, want, u, w, g, rs, dp):
    """test_torch_fedagg's bounds: f32 within 1e-5 of the largest term
    (max|u|, times max clip scale and plus the noise term under dp); bf16
    one bf16 ulp of the reference on top."""
    inc = (w * g) > 0
    rows = u.float()[inc]
    mag = float(rows.abs().max()) if rows.numel() else 0.0
    if dp and bool(inc.any()):
        mag = mag * float(rs[inc].max()) + 4.0 * 0.3 / float((w * g)[inc].sum())
    tol = 1e-5 * mag + torch.zeros_like(want.float())
    if got.dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            torch.clamp(want.float().abs(), min=2.0 ** -126))) - 7)
    assert bool(torch.all((got.float() - want.float()).abs() <= tol))


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C,M", [(20, 610), (257, 2051), (8, 1027)])
def test_walk_within_tolerance_of_plain_and_the_jnp_lowering(C, M, dtype, dp):
    """The emulated kernel against fedagg_plain and the reference's jnp
    lowering (repro.kernels.ops.fedagg, use_pallas off), on a pitched view
    as flatten_stacked hands it over."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    pitch = -(-M // 8) * 8 + 8
    u, w, g, rs, noise = _case(C, M, dtype, seed=7, pitch=pitch)
    noise = noise.clamp(-4.0, 4.0)
    out, *_ = stream_walk(u, w, g, rs, noise, 0.3, dp, WIDTHS[dtype][0])
    kw = dict(aggregator="dp", row_scale=rs, noise=noise, noise_scale=0.3) if dp else {}
    _close(out, fk.fedagg_plain(u, w, g, **kw), u, w, g, rs, dp)
    jkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v) for k, v in kw.items()}
    ju = jnp.asarray(u.float().numpy()).astype(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    want = jops.fedagg(ju, jnp.asarray(w.numpy()), jnp.asarray(g.numpy()), **jkw)
    _close(out, torch.from_numpy(np.array(want.astype(jnp.float32))).to(dtype),
           u, w, g, rs, dp)
    assert math.isfinite(float(out.float().abs().max()))
