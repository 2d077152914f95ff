"""The arithmetic of the fedagg wire decoders under mean and dp (K4,
``csrc/fedagg.cu``), emulated on the CPU in the kernels' order of
operations, against the first version's order, bit for bit.

sketch (``sketch_kernel``): the bucket sums first, t[b] = an fma chain of
wg_k s[k, b] over the included rows in ascending k, then
out[m] = finish(sign[m] t[h[m]] + 0). The first version decoded first:
per column an fma chain of wg_k fl(s[k, h[m]] sign[m]). With sign = +-1
the two are the same bits (rounding to nearest is odd-symmetric), NaN for
NaN; the + 0 turns the -0 of a zero bucket under sign -1 into the +0 the
decode-first chain gives, and without it the bits differ.

topk (``topk_sum_kernel``): the kernel's control flow at small widths —
the G-ary search for each row's window, the stages (at most a number of
pairs and of rows), the first pair of each (row, owner thread), the owner's
walk over its rows in ascending order — against the first version's
row-by-row scatter (per column an fma chain in ascending row order).

int8 (``stream_kernel``): the bits 0x4B000080 + q, as a float, minus
2^23 + 128 give q exactly.

An f32 fma is emulated in f64 (the product of two f32 values is exact in
f64) and rounded to f32; that rounding is odd-symmetric too, so the sketch
identity holds for it as for the card's fma.
"""
import bisect
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fedagg as fk  # noqa: E402

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "csrc" / "fedagg.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+);", SRC).group(1))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _bits(x):
    return x.contiguous().view(torch.int32)


def _finish(acc, den, noise=None, noise_scale=0.0):
    """The kernel's epilogue, in f32 step by step."""
    if not den > 0:
        return torch.zeros_like(acc)
    safe = torch.tensor(max(den, 1e-30), dtype=torch.float32)
    if noise is None:
        return acc / safe
    return acc / safe + noise * (torch.tensor(noise_scale, dtype=torch.float32) / safe)


def _weights(w, g, rs, dp):
    """(included rows in order, their contraction weights, den) as
    stage_rows stages them: wg = fl(w g), dp's fl(wg rs), den over wg."""
    wg = w * g
    rows = [k for k in range(len(w)) if wg[k] > 0]
    wr = {k: (wg[k] * rs[k] if dp else wg[k]) for k in rows}
    den = float(torch.sum(torch.where(wg > 0, wg, 0.0)))
    return rows, wr, den


# ------------------------------------------------------------------ sketch
def sketch_decode_first(s, h, sign, rows, wr, den, noise, noise_scale):
    acc = torch.zeros(h.shape[0], dtype=torch.float32)
    for k in rows:
        acc = _fma(wr[k], s[k, h] * sign, acc)
    return _finish(acc, den, noise, noise_scale)


def sketch_bucket_first(s, h, sign, rows, wr, den, noise, noise_scale, plus_zero=True):
    t = torch.zeros(s.shape[1], dtype=torch.float32)
    for k in rows:
        t = _fma(wr[k], s[k], t)
    v = sign * t[h]
    if plus_zero:
        v = v + 0.0
    return _finish(v, den, noise, noise_scale)


def _sketch_case(C, dim, M, seed, *, special=False):
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.normal(size=(C, dim)).astype(np.float32))
    h = torch.from_numpy(rng.integers(0, dim, size=M))
    sign = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), size=M))
    w = torch.from_numpy((rng.random(C) + 0.1).astype(np.float32))
    g = torch.from_numpy((rng.random(C) > 0.3).astype(np.float32))
    g[0] = 1.0
    rs = torch.from_numpy(rng.random(C).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=M).astype(np.float32))
    if special and C >= 3:
        s[0, 0] = float("inf")              # an inf in an included row
        s[0, dim - 1] = float("nan")        # a NaN in an included row
        g[2] = 0.0                          # a NaN row behind a zero gate,
        s[2] = float("nan")                 # with its NaN clip scale
        rs[2] = float("nan")
    return s, h, sign, w, g, rs, noise


def _same_bits(a, b):
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(_bits(a[~nan]), _bits(b[~nan]))


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
@pytest.mark.parametrize("dim", [1, 7, 256, 2048])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_sketch_bucket_first_equals_decode_first_bit_for_bit(C, dim, dp):
    s, h, sign, w, g, rs, noise = _sketch_case(C, dim, 3001, seed=C * 10 + dim,
                                               special=True)
    rows, wr, den = _weights(w, g, rs, dp)
    args = (noise, 0.3) if dp else (None, 0.0)
    want = sketch_decode_first(s, h, sign, rows, wr, den, *args)
    got = sketch_bucket_first(s, h, sign, rows, wr, den, *args)
    _same_bits(got, want)
    if C >= 3:
        assert bool(torch.isnan(want[h == dim - 1]).all()) or dim == 1
        assert bool(torch.isinf(want[h == 0]).all()) or dim in (1,)
        # the row behind the zero gate never reaches a column
        assert int(torch.isnan(want).sum()) == int((h == dim - 1).sum()) or dim == 1


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
def test_sketch_zero_buckets_need_the_plus_zero(dp):
    """A zero bucket under sign -1: the decode-first chain gives +0, the
    bare product -0; the kernel's + 0 restores +0."""
    s, h, sign, w, g, rs, noise = _sketch_case(4, 64, 2000, seed=7)
    s[:, ::3] = 0.0
    rows, wr, den = _weights(w, g, rs, dp)
    args = (noise, 0.3) if dp else (None, 0.0)
    want = sketch_decode_first(s, h, sign, rows, wr, den, *args)
    _same_bits(sketch_bucket_first(s, h, sign, rows, wr, den, *args), want)
    if not dp:              # dp adds the noise term, which hides the sign of 0
        bare = sketch_bucket_first(s, h, sign, rows, wr, den, *args, plus_zero=False)
        assert not torch.equal(_bits(bare), _bits(want))


def test_sketch_zero_inclusion_gives_zeros():
    s, h, sign, w, g, rs, noise = _sketch_case(5, 32, 500, seed=3)
    g[:] = 0.0
    rows, wr, den = _weights(w, g, rs, False)
    out = sketch_bucket_first(s, h, sign, rows, wr, den, None, 0.0)
    assert rows == [] and torch.equal(_bits(out), _bits(torch.zeros(500)))


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
def test_sketch_emulation_matches_plain_version(dp):
    """The emulated order against fedagg_plain (einsum over the decoded
    rows) under chip_smoke.py's compare_variant bound."""
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    s, h, sign, w, g, rs, noise = _sketch_case(8, 256, 4000, seed=11)
    rows, wr, den = _weights(w, g, rs, dp)
    ops = dict(aggregator="dp" if dp else "mean", codec="sketch",
               sketch_h=h.to(torch.int32), sketch_sign=sign, out_m=4000)
    if dp:
        ops.update(row_scale=rs, noise=noise, noise_scale=0.3)
    args = (noise, 0.3) if dp else (None, 0.0)
    got = sketch_bucket_first(s, h, sign, rows, wr, den, *args)
    want = fk.fedagg_plain(s, w, g, **ops)
    ok, err = cs.compare_variant(got, want, s, w, g, ops)
    assert ok, err


# ------------------------------------------------------------------- topk
def probe(a, b, s, i):
    return min(a + (i + 1) * s - 1, b - 1)


def narrow(a, b, s, t, G):
    """The kernel's step (``narrow``): the answer in [a, b]; t of the G
    probes lie below the key."""
    if a >= b:
        return a, b
    if t == 0:
        return a, probe(a, b, s, 0)
    na = probe(a, b, s, t - 1) + 1
    if t < G:
        b = probe(a, b, s, t)
    return na, b


def gary_lower_bound(row, x, G):
    """First position of the ascending ``row`` whose value is >= x, by the
    kernel's G-ary search; returns (position, steps)."""
    a, b, steps = 0, len(row), 0
    while a < b:
        s = (b - a + G) // (G + 1)
        t = sum(row[probe(a, b, s, i)] < x for i in range(G))
        a, b = narrow(a, b, s, t, G)
        steps += 1
    return a, steps


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 40, 5794])
def test_gary_search_is_lower_bound(k, G):
    rng = np.random.default_rng(k * 10 + G)
    row = np.sort(rng.choice(10 * k + 10, size=k, replace=False))
    keys = [-1, 0, int(row[0]), int(row[-1]), int(row[-1]) + 1, 10 * k + 20]
    keys += [int(x) for x in rng.integers(0, 10 * k + 10, size=50)]
    for x in keys:
        pos, steps = gary_lower_bound(row, x, G)
        assert pos == bisect.bisect_left(row.tolist(), x)
        assert steps <= math.ceil(math.log(k + 1, G + 1)) + 1


def test_gary_search_steps_at_the_cell_shape():
    """60 rows: 4 lanes a row (G = 4, as the kernel picks for 256 threads),
    at most 6 steps at k = 5,794 (one binary search took 13)."""
    n, G = 60, 1
    while G < _const("kMaxProbe") and 2 * G * n <= _const("kThreads"):
        G *= 2
    assert G == 4
    rng = np.random.default_rng(0)
    row = np.sort(rng.choice(579402, size=5794, replace=False))
    worst = max(gary_lower_bound(row, int(x), G)[1]
                for x in range(0, 579402, 2048))
    assert worst <= 6


def topk_kernel_emulated(idx, vals, wr, rows, M, *, cols, threads, stage, stage_rows,
                         max_probe):
    """topk_sum_kernel's sums (before finish) at the given widths: blocks of
    ``cols`` columns, ``threads`` owners of cols / threads columns each,
    rows staged ``threads`` at a time, stages of at most ``stage`` pairs and
    ``stage_rows`` rows. Returns the sums and the number of stages."""
    own = cols // threads
    out = torch.zeros(M, dtype=torch.float32)
    n_stages = 0
    for c0 in range(0, M, cols):
        c1 = min(c0 + cols, M)
        acc = torch.zeros(cols, dtype=torch.float32)
        for r0 in range(0, len(rows), threads):
            chunk = rows[r0:r0 + threads]
            n = len(chunk)
            G = 1
            while G < max_probe and 2 * G * n <= threads:
                G *= 2
            lo = [gary_lower_bound(idx[r], c0, G)[0] for r in chunk]
            hi = [gary_lower_bound(idx[r], c1, G)[0] for r in chunk]
            off = [0]
            for a, b in zip(lo, hi):
                assert b - a <= stage        # a window always fits a stage
                off.append(off[-1] + b - a)
            jr = 0
            while jr < n:
                je, top = jr + 1, min(n, jr + stage_rows)
                while je < top:             # the kernel's search for je
                    mid = (je + top + 1) // 2
                    if off[mid] <= off[jr] + stage:
                        je = mid
                    else:
                        top = mid - 1
                n_stages += 1
                base = off[jr]
                s_idx, s_val, rowof = [], [], []
                for j in range(jr, je):
                    r = chunk[j]
                    s_idx += idx[r][lo[j]:hi[j]].tolist()
                    s_val += vals[r][lo[j]:hi[j]].tolist()
                    rowof += [j - jr] * (hi[j] - lo[j])
                assert len(s_idx) == off[je] - base <= stage
                first, mask = {}, [0] * threads
                for q in range(len(s_idx)):
                    o = (s_idx[q] - c0) // own
                    if q == 0 or rowof[q - 1] != rowof[q] or (s_idx[q - 1] - c0) // own != o:
                        first[(rowof[q], o)] = q
                        mask[o] |= 1 << rowof[q]
                for t in reversed(range(threads)):     # owners in any order
                    mine = c0 + t * own
                    for jj in range(je - jr):
                        if not mask[t] >> jj & 1:
                            continue
                        end = off[jr + jj + 1] - base
                        p = first[(jj, t)]
                        w = wr[chunk[jr + jj]]
                        while p < end and s_idx[p] - mine < own:
                            c = s_idx[p] - c0
                            acc[c] = _fma(w, torch.tensor(s_val[p]), acc[c])
                            p += 1
                jr = je
        out[c0:c1] = acc[:c1 - c0]
    return out, n_stages


def topk_row_by_row(idx, vals, wr, rows, M):
    """The first version's order: row by row, each column's fma chain in
    ascending row order."""
    acc = torch.zeros(M, dtype=torch.float32)
    for r in rows:
        i = torch.from_numpy(idx[r].astype(np.int64))
        acc[i] = _fma(wr[r], torch.from_numpy(vals[r]), acc[i])
    return acc


def _topk_case(C, M, k, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(M, size=k, replace=False)) for _ in range(C)])
    vals = rng.normal(size=(C, k)).astype(np.float32)
    # a row whose whole k lies in one block, and a row with no pair in the
    # first blocks (empty windows)
    if C > 2 and k <= 64 and M >= 64 + k:
        idx[1] = np.arange(64, 64 + k)
    if C > 2:
        idx[2] = np.sort(rng.choice(np.arange(max(0, M - 2 * k), M), size=k,
                                    replace=False))
    w = torch.from_numpy((rng.random(C) + 0.1).astype(np.float32))
    g = torch.from_numpy((rng.random(C) > 0.3).astype(np.float32))
    g[:3] = 1.0
    rs = torch.from_numpy(rng.random(C).astype(np.float32))
    return idx, vals, w, g, rs


@pytest.mark.parametrize("dp", [False, True], ids=["mean", "dp"])
@pytest.mark.parametrize("C,M,k", [(20, 700, 35), (20, 700, 64), (6, 700, 350),
                                   (3, 64, 64), (1, 100, 1)])
def test_topk_window_walk_equals_row_by_row(C, M, k, dp):
    """Widths cut so that one call has many blocks, row chunks, stages cut
    by rows and by pairs, a row whose whole k is in one block and rows
    with empty windows."""
    idx, vals, w, g, rs = _topk_case(C, M, k, seed=C * 1000 + k)
    rows, wr, _ = _weights(w, g, rs, dp)
    got, n_stages = topk_kernel_emulated(idx, vals, wr, rows, M, cols=64, threads=8,
                                         stage=64, stage_rows=4, max_probe=8)
    want = topk_row_by_row(idx, vals, wr, rows, M)
    assert torch.equal(_bits(got), _bits(want))
    assert n_stages >= (M + 63) // 64


def test_topk_emulated_at_the_kernel_widths():
    """The kernel's own widths (2048 columns, 256 threads, 2048 pairs and 64
    rows a stage) at 70 rows (two stages by rows) and frac 0.5 (stages by
    pairs)."""
    cols, threads = _const("kTopkCols"), _const("kThreads")
    stage, stage_rows = _const("kTopkStage"), _const("kTopkStageRows")
    assert stage >= cols and stage_rows <= 64 and cols % threads == 0
    for C, M, k in [(70, 5000, 50), (4, 4500, 2250)]:
        idx, vals, w, g, rs = _topk_case(C, M, k, seed=C)
        g[:] = 1.0
        rows, wr, _ = _weights(w, g, rs, False)
        got, n_stages = topk_kernel_emulated(
            idx, vals, wr, rows, M, cols=cols, threads=threads, stage=stage,
            stage_rows=stage_rows, max_probe=_const("kMaxProbe"))
        assert torch.equal(_bits(got), _bits(topk_row_by_row(idx, vals, wr, rows, M)))
        assert n_stages > (M + cols - 1) // cols


# ------------------------------------------------------------------- int8
def test_int8_bits_to_float_is_exact():
    q = np.arange(-128, 128, dtype=np.int32)
    assert "0x4B000080 + static_cast<int>(x)" in SRC and "8388736.0f" in SRC
    f = (np.int32(0x4B000080) + q).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, q.astype(np.float32))
    assert not np.signbit(f[q == 0]).any()


def test_route_limits_match_the_source():
    """The wrapper's sketch limit is the kernel's, and its buckets fit the
    227 KB a block may have beside the kernel's own 2 KB."""
    assert _const("kMaxSketchDim") == fk.MAX_SKETCH_DIM
    assert 4 * fk.MAX_SKETCH_DIM + 2 * 4 * _const("kThreads") + 64 <= 227 * 1024
    assert fk.INT8_WIDTHS[-1] == 1
