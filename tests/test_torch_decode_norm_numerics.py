"""The arithmetic of the decode-attention (K7, ``csrc/decode_attention.cu``)
and RMSNorm (K9, ``csrc/rmsnorm.cu``) kernels, emulated on the CPU in their
order of operations, against the plain versions under ``chip_smoke.py``'s
own bounds; and the launch plans both kernels take.

K7, for a (batch, kv head, chunk of GT query heads): ``decode_plan`` splits
the valid rows into n_split runs (one block each, one cluster together); a
block's 8 warps take its 16-row tiles in turn, each with its own online
state. Per tile and head: m_new = max(m, tile max), corr = exp(m - m_new),
p = exp(s - m_new), acc = acc * corr, then p v added. Warps merge with
weights exp(m_w - M) (l: a butterfly over the warps of l_w w, top bit
first; acc: an fma chain in warp order), then splits the same way in split
order; out = sum / max(l, 1e-30), rounded once.

* bf16 (the tensor-core route): s = (q k^T) * scale from unscaled bf16
  operands (each product exact in f32); a lane holds keys 2t, 2t + 1,
  8 + 2t, 9 + 2t of one head and sums their p in that order, the head's
  four lanes add theirs (lane bit 0, then 1); p v as hi v + lo v with
  hi = bf16(p), lo = bf16(p - hi), f32 sums.
* f32 (the CUDA-core route): a lane owns hd / 32 columns
  (``(ch * 32 + lane) * V + e``) and holds q * scale (f32) of them; a score
  is the lane's fma chain over its columns, then the warp's butterfly sum
  (lane bit 4 first); each lane keeps the p-sum of its own keys, summed
  over the head's lanes (key bits, top first) at the end; acc takes an fma
  of p_j v_j for each valid key in order.

K9: thread t of a row's tpr threads (``norm_plan``) sums the squares of
its columns ``(i * tpr + t) * VW + e`` (i over the held vectors, then the
re-read tail) in one fma chain; the warp's butterfly sum (bit 4 first);
then (tpr > 32) the warps' sums in warp order; r = 1 / sqrt(ss / D + eps)
in f32; out = (x r) scale rounded once.

An f32 fma is emulated in f64 (the product of two f32 values is exact in
f64) and rounded to f32. A tensor-core product of bf16 operands is an f32
matmul of their values (exact products, f32 sums in another order).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import rmsnorm as rk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

WARPS = dk.WARPS
NEG = -1e30


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _fma_chain(pairs):
    """fma(a_n, b_n, ... fma(a_0, b_0, 0)) over (a, b) pairs, in order."""
    d = None
    for a, b in pairs:
        d = (a.double() * b.double()).float() if d is None else _fma(a, b, d)
    return d


def _butterfly(x, dim=-1):
    """Sum over a power-of-two axis as a warp's xor-shuffle tree does: the
    pairs that differ in the top index bit first."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _lane_cols(hd):
    """[32, C]: the columns lane l owns, in its loop order."""
    C = hd // 32
    V = 1 if C == 3 else C
    return torch.tensor([[(ch * 32 + lane) * V + e for ch in range(C // V)
                          for e in range(V)] for lane in range(32)])


def _split_bf16(p, split=True):
    hi = p.bfloat16().float()
    return (hi, (p - hi).bfloat16().float()) if split else (hi,)


def k7_emulate(q, kc, vc, kv_len, scale=None, split=True):
    """decode_attention by the kernel's order of operations (the route
    q's dtype takes); ``split=False``: P as one bf16 product."""
    B, _, H, hd = q.shape
    Skv, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    tc = q.dtype == torch.bfloat16
    gt, chunks, per, n_split = dk.decode_plan(B, H, KV, kv_len)
    if scale is None:
        scale = hd ** -0.5
    T = dk.TILE
    cols = _lane_cols(hd)                                   # [32, C]
    C = cols.shape[1]
    # blocks y = (b, kv head, chunk); padded heads carry q = 0
    qs = torch.zeros(B, KV, chunks * gt, hd)
    qs[:, :, :G] = q[:, 0].float().reshape(B, KV, G, hd)
    if not tc:
        qs = qs * scale
    qs = qs.reshape(-1, gt, hd)                             # [Y, gt, hd]
    kf = kc.float().permute(0, 2, 1, 3)                     # [B, KV, Skv, hd]
    vf = vc.float().permute(0, 2, 1, 3)
    kf = kf.repeat_interleave(chunks, dim=1).reshape(-1, Skv, hd)   # [Y, Skv, hd]
    vf = vf.repeat_interleave(chunks, dim=1).reshape(-1, Skv, hd)
    Y = qs.shape[0]

    n_tiles = -(-per // T)
    rounds = -(-n_tiles // WARPS)
    S = n_split
    m = torch.full((Y, S, WARPS, gt), NEG)
    slots = 4 if tc else min(32, T * gt) // gt              # lanes a head's p-sum spans
    l_lane = torch.zeros(Y, S, WARPS, gt, slots)
    acc = torch.zeros(Y, S, WARPS, gt, hd)
    q_lane = qs[:, :, cols]                                 # [Y, gt, 32, C]
    split0 = torch.arange(S) * per
    split1 = torch.clamp(split0 + per, max=kv_len)
    for r in range(rounds):
        tile = torch.arange(WARPS) + r * WARPS              # the warps' tiles
        row0 = split0[:, None] + tile[None, :] * T          # [S, W]
        rows = row0[..., None] + torch.arange(T)            # [S, W, T]
        valid = rows < split1[:, None, None]
        active = row0 < split1[:, None]                     # the warp has this tile
        ri = torch.clamp(rows, max=Skv - 1)
        kt = kf[:, ri]                                      # [Y, S, W, T, hd]
        vt = vf[:, ri]
        if tc:
            s = torch.einsum("ygd,yswtd->yswtg", qs, kt) * scale
        else:
            k_lane = kt[..., cols]                          # [Y, S, W, T, 32, C]
            part = _fma_chain([(q_lane[:, None, None, None, :, :, c],
                                k_lane[..., None, :, c]) for c in range(C)])
            s = _butterfly(part)                            # [Y, S, W, T, gt]
        s = torch.where(valid[None, ..., None], s, -torch.inf)
        tmax = s.amax(dim=3)                                # [Y, S, W, gt]
        m_new = torch.maximum(m, tmax)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, :, :, None])             # [Y, S, W, T, gt]
        pg = p.permute(0, 1, 2, 4, 3)                       # [Y, S, W, gt, T]
        l_new = l_lane * corr[..., None]
        if tc:                                              # lane t: keys 2t, 2t+1, 8+2t, 9+2t
            for key0 in (0, 1, 8, 9):
                l_new = l_new + pg[..., key0:key0 + 7:2]
        else:                                               # lane kk: keys kk, kk + slots, ...
            for bt in range(T // slots):
                l_new = l_new + pg[..., bt * slots:(bt + 1) * slots]
        a_new = acc * corr[..., None]
        if tc:
            for half in _split_bf16(p, split):
                a_new = a_new + torch.einsum("yswtg,yswtd->yswgd", half, vt)
        else:
            for j in range(T):
                stepped = _fma(p[:, :, :, j, :, None], vt[:, :, :, j, None, :], a_new)
                a_new = torch.where(valid[None, :, :, j, None, None], stepped, a_new)
        keep = active[None, :, :, None]
        m = torch.where(keep, m_new, m)
        l_lane = torch.where(keep[..., None], l_new, l_lane)
        acc = torch.where(keep[..., None], a_new, acc)
    if tc:                                                  # lane bit 0, then bit 1
        l = (l_lane[..., 0] + l_lane[..., 1]) + (l_lane[..., 2] + l_lane[..., 3])
    else:
        l = _butterfly(l_lane)                              # [Y, S, W, gt]

    def merge(m, l, acc, dim):
        mx = m.amax(dim=dim, keepdim=True)
        wt = torch.exp(m - mx)
        L = _butterfly(l * wt, dim=dim)
        n = m.shape[dim]
        A = _fma_chain([(acc.select(dim, i), wt.select(dim, i)[..., None])
                        for i in range(n)])
        return mx.squeeze(dim), L, A

    m, l, acc = merge(m, l, acc, 2)                         # warps, in order
    m, l, acc = merge(m, l, acc, 1)                         # splits, in order
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # [Y, gt, hd]
    out = out.reshape(B, KV, chunks * gt, hd)[:, :, :G].reshape(B, 1, H, hd)
    return out.to(q.dtype)


def norm_emulate(x, scale, eps=1e-6):
    """rmsnorm_fwd by the kernel's order of operations."""
    R, D = x.shape
    vw = 1 if D % (4 if x.dtype == torch.float32 else 8) else (
        4 if x.dtype == torch.float32 else 8)
    tpr, nv, _ = rk.norm_plan(R, D, vw)
    chunks = max(nv, -(-D // (tpr * vw)))
    xf = torch.zeros(R, chunks * tpr * vw)
    xf[:, :D] = x.float()
    xf = xf.reshape(R, chunks, tpr, vw)
    ss = _fma_chain([(xf[:, i, :, e], xf[:, i, :, e])
                     for i in range(chunks) for e in range(vw)])    # [R, tpr]
    warp = _butterfly(ss.reshape(R, tpr // 32, 32))                 # [R, warps]
    total = warp[:, 0]
    for w in range(1, tpr // 32):
        total = total + warp[:, w]
    r = 1.0 / torch.sqrt(total / torch.tensor(float(D)) + torch.tensor(eps))
    return ((x.float() * r[:, None]) * scale.float()).to(x.dtype)


def _rand(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)


# (label, B, Skv, H, KV, hd, kv_lens): G 1 / 2 / 3 / 4 / 7 / 8 / 12, hd 32-128,
# one to many splits and tiles, then the three full-width decode shapes
DECODE_CASES = [
    ("mha_hd64", 2, 64, 4, 4, 64, (1, 29, 64)),
    ("g2_hd32", 1, 150, 4, 2, 32, (17, 150)),
    ("g3_pad_hd96", 1, 100, 6, 2, 96, (1, 45, 100)),
    ("g4_hd128_ragged", 2, 77, 8, 2, 128, (40, 77)),
    ("g8_hd64", 1, 300, 8, 1, 64, (1, 150, 300)),
    ("g12_chunks_hd32", 1, 90, 12, 1, 32, (33, 90)),
    ("g7_pad_hd128", 1, 100, 14, 2, 128, (1, 45, 100)),
    ("qwen1.5_decode", 8, 544, 16, 16, 64, (271, 544)),
    ("qwen2.5_decode", 4, 1040, 16, 2, 128, (519, 1040)),
    ("jamba_decode", 2, 1040, 64, 8, 128, (1040,)),
]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_attention_order_holds_the_bound(case, dtype):
    _, B, Skv, H, KV, hd, lens = case
    dt = getattr(torch, dtype)
    q = _rand((B, 1, H, hd), 1, dt)
    kc = _rand((B, Skv, KV, hd), 2, dt)
    vc = _rand((B, Skv, KV, hd), 3, dt)
    for kv_len in lens:
        got = k7_emulate(q, kc, vc, kv_len)
        want = dk.decode_attention_plain(q, kc, vc, kv_len=kv_len)
        ok, err = chip_smoke.attn_close(got, want, vc[:, :kv_len], dt)
        assert ok, f"kv_len {kv_len}: max_abs_err {err}"


def test_single_bf16_p_fails_the_bound():
    """Without the lo half, P V leaves attn_close's bound: the split is not
    redundant."""
    fails = 0
    for _, B, Skv, H, KV, hd, lens in DECODE_CASES[:6]:
        q = _rand((B, 1, H, hd), 1, torch.bfloat16)
        kc = _rand((B, Skv, KV, hd), 2, torch.bfloat16)
        vc = _rand((B, Skv, KV, hd), 3, torch.bfloat16)
        got = k7_emulate(q, kc, vc, Skv, split=False)
        want = dk.decode_attention_plain(q, kc, vc, kv_len=Skv)
        fails += not chip_smoke.attn_close(got, want, vc, torch.bfloat16)[0]
    assert fails


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_decode_emulation_sees_the_rows_it_should(dtype):
    """The emulation is sensitive to what the kernel must read: a changed
    valid row moves it, rows at or past kv_len do not."""
    dt = getattr(torch, dtype)
    q = _rand((1, 1, 8, 64), 4, dt)
    kc = _rand((1, 200, 1, 64), 5, dt)
    vc = _rand((1, 200, 1, 64), 6, dt)
    base = k7_emulate(q, kc, vc, 150)
    past = vc.clone()
    past[:, 150:] = 1e4
    assert torch.equal(k7_emulate(q, kc, past, 150), base)
    for row in (0, 77, 149):
        moved = vc.clone()
        moved[:, row] += 4.0
        assert not torch.equal(k7_emulate(q, kc, moved, 150), base), row


# (label, rows, D, scale dtype): warp rows and block rows at each width
NORM_CASES = [(f"d{D}_r{R}", R, D, sdt) for D, sdt in
              ((100, "float32"), (1024, "float32"), (2048, "float32"),
               (3072, "float32"), (8192, "bfloat16")) for R in (2, 77)]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("case", NORM_CASES, ids=[c[0] for c in NORM_CASES])
def test_rmsnorm_order_holds_the_bound(case, dtype):
    _, R, D, sdt = case
    x = _rand((R, D), 7, getattr(torch, dtype))
    scale = (1.0 + 0.1 * _rand((D,), 8, torch.float32)).to(getattr(torch, sdt))
    got = norm_emulate(x, scale).float()
    want = rk.rmsnorm_plain(x, scale).float()
    # chip_smoke.lm_kernel_phase's bound
    bound = (D / 2 + 4) * 2.0 ** -24 * torch.abs(want)
    if dtype == "bfloat16":
        bound = bound + torch.exp2(torch.floor(torch.log2(
            torch.clamp(torch.abs(want), min=2.0 ** -126))) - 7)
    assert bool(torch.all(torch.abs(got - want) <= bound + 1e-30)), \
        float((got - want).abs().max())


@pytest.mark.parametrize("B,H,KV,kv_len", [(8, 16, 16, 544), (4, 16, 2, 1040),
                                           (2, 64, 8, 1040), (1, 12, 1, 90),
                                           (3, 6, 2, 1), (1, 4, 4, 17)])
def test_decode_plan_serves_each_kv_row_once_per_head_chunk(B, H, KV, kv_len):
    gt, chunks, per, n = dk.decode_plan(B, H, KV, kv_len)
    G = H // KV
    assert gt in (1, 2, 4, 8) and (gt >= G or gt == 8) and (gt == 1 or gt < 2 * G)
    assert chunks == -(-G // gt) and (chunks == 1 or G > 8)
    assert 1 <= n <= dk.MAX_SPLIT and not n & (n - 1)
    assert (n - 1) * per < kv_len <= n * per


@pytest.mark.parametrize("R,D,vw", [(4096, 1024, 8), (8, 1024, 8), (4099, 2048, 8),
                                    (7, 3072, 8), (5, 100, 1), (2048, 8192, 8),
                                    (2, 8192, 8), (4096, 1024, 4), (64, 100000, 1)])
def test_norm_plan_keeps_rows_in_registers(R, D, vw):
    """A row's threads hold it (but for rows past 2048 vectors), a warp or
    a block of at most 256 threads; a decode step's rows take a block, one
    or two vectors a thread up to 512 vectors; the grid covers every row."""
    tpr, nv, grid = rk.norm_plan(R, D, vw)
    nvec = -(-D // vw)
    assert tpr % 32 == 0 and 32 <= tpr <= rk.BLOCK and nv in (1, 2, 4, 8)
    assert tpr * nv >= min(nvec, rk.BLOCK * 8)
    if R <= rk.DECODE_ROWS:
        assert tpr > 32 or nvec <= 32
        assert nvec > 512 or nv <= 2
    groups = rk.BLOCK // tpr if tpr == 32 else 1
    assert 1 <= grid <= -(-R // groups)
