"""The arithmetic of the flash-attention kernels' bf16 tensor-core route
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), emulated on
the CPU, against the plain versions under ``chip_smoke.py``'s own bounds;
and the build's hash over the shared headers.

The route multiplies bf16 operands on the tensor cores with f32
accumulation. A product of two bf16 values is exact in f32, so the scores
S = Q K^T and dP = dO V^T are the reference's f32 scores up to summation
order (the kernels apply ``scale`` to the f32 scores after the product,
where the reference scales q first). The f32 operands P and dS are split
into hi = bf16(x) and lo = bf16(x - hi), and each product that takes them
is issued twice (hi, then lo) into one f32 accumulator. The emulation
below does that arithmetic on whole tiles: the forward's online softmax
over key tiles of the kernel's width (128 keys at hd 32, else 64), ``expf``
on the f32 scores, out = acc / max(l, 1e-30) rounded once, lse =
m + log(max(l, 1e-30)); the backward's dq, dk, dv summed in f32 over the
key / query tiles and the group's G query heads, rounded once.

The bounds are ``chip_smoke.attn_close`` and ``bwd_close`` (LM_TOL x max
plus one bf16 ulp for a bf16 result) and the lse bound of
``lm_kernel_phase``; the same bounds hold the kernels against the plain
versions on the card. A single bf16 P or dS (what SDPA and FlashAttention
use) must fail them on at least one case: the split is what keeps them.
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (label, B, Sq, Skv, H, KV, hd, causal, window, q_offset): hd 32-128, G 1
# / 4 / 8, windows, Sq < Skv, ragged lengths, more than one key tile; the
# query block at the last Sq positions (None) or at its own offset (a
# seq_shard_attn rank's rows: the first, a middle and a windowed block)
CASES = [
    ("mha_hd32", 1, 130, 130, 2, 2, 32, True, 0, None),
    ("gqa4_hd64_ragged", 1, 150, 150, 4, 1, 64, True, 0, None),
    ("gqa8_hd128", 1, 96, 96, 8, 1, 128, True, 0, None),
    ("g4_hd96_noncausal", 1, 70, 70, 4, 1, 96, False, 0, None),
    ("sq_lt_skv_hd64", 1, 37, 150, 4, 1, 64, True, 0, None),
    ("window40_hd128", 1, 140, 140, 2, 2, 128, True, 40, None),
    ("window8_sq_lt_skv_hd32", 1, 13, 45, 8, 1, 32, True, 8, None),
    ("offset0_hd64", 1, 64, 160, 4, 1, 64, True, 0, 0),
    ("offset_mid_gqa8_hd32", 1, 40, 130, 8, 1, 32, True, 0, 45),
    ("offset_window24_hd128", 1, 48, 140, 2, 2, 128, True, 24, 70),
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed):
    _, B, Sq, Skv, H, KV, hd, *_ = case
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).bfloat16()  # noqa: E731
    return mk(B, Sq, H, hd), mk(B, Skv, KV, hd), mk(B, Skv, KV, hd), mk(B, Sq, H, hd)


def _split(x, split):
    """The f32 operand as the kernels feed it to the tensor cores: hi + lo
    (two bf16 products into one f32 sum), or hi alone."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _mm(parts, b):
    """sum_i parts[i] @ b in f32 (one accumulator)."""
    acc = parts[0] @ b
    for p in parts[1:]:
        acc = acc + p @ b
    return acc


def tc_forward(q, k, v, *, causal, window, split=True, q_offset=None):
    """(out, lse) by the bf16 route's arithmetic; lse in [B * KV, G, Sq]."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, hd ** -0.5
    tile = 128 if hd <= 32 else 64
    vis = fk._visible(Sq, Skv, causal, window, q.device, q_offset)
    out = torch.empty(B, Sq, H, hd)
    lse = torch.empty(B, H, Sq)
    for b in range(B):
        for h in range(H):
            qh = q[b, :, h].float()
            kh, vh = k[b, :, h // G].float(), v[b, :, h // G].float()
            m = torch.full((Sq,), -1e30)
            l = torch.zeros(Sq)
            acc = torch.zeros(Sq, hd)
            for t0 in range(0, Skv, tile):
                s = (qh @ kh[t0:t0 + tile].T) * scale
                s = torch.where(vis[:, t0:t0 + tile], s, -torch.inf)
                m_new = torch.maximum(m, s.max(-1).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + _mm(_split(p, split), vh[t0:t0 + tile])
                m = m_new
            out[b, :, h] = acc / torch.clamp(l, min=1e-30)[:, None]
            lse[b, h] = m + torch.log(torch.clamp(l, min=1e-30))
    return out.bfloat16(), lse.reshape(B * KV, G, Sq)


def tc_backward(q, k, v, out, lse, do, *, causal, window, split=True,
                q_offset=None):
    """(dq, dk, dv) by the bf16 route's arithmetic."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, scale = H // KV, hd ** -0.5
    vis = fk._visible(Sq, Skv, causal, window, q.device, q_offset)
    lse = lse.reshape(B, H, Sq)
    dq = torch.empty(B, Sq, H, hd)
    dk = torch.zeros(B, Skv, KV, hd)
    dv = torch.zeros(B, Skv, KV, hd)
    for b in range(B):
        for h in range(H):
            qh, doh = q[b, :, h].float(), do[b, :, h].float()
            kh, vh = k[b, :, h // G].float(), v[b, :, h // G].float()
            delta = (doh * out[b, :, h].float()).sum(-1)
            s = (qh @ kh.T) * scale
            p = torch.where(vis, torch.exp(s - lse[b, h][:, None]), 0.0)
            ds = p * (doh @ vh.T - delta[:, None])
            dq[b, :, h] = _mm(_split(ds, split), kh) * scale
            dk[b, :, h // G] += _mm(_split(ds.T, split), qh) * scale
            dv[b, :, h // G] += _mm(_split(p.T, split), doh)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _forward_ok(case, split):
    *_, causal, window, off = case
    q, k, v, _ = _inputs(case, 7)
    out, lse = tc_forward(q, k, v, causal=causal, window=window, split=split,
                          q_offset=off)
    want, want_lse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                              block_kv=64, q_offset=off)
    ok, err = chip_smoke.attn_close(out, want, v, torch.bfloat16)
    lse_tol = chip_smoke.LM_TOL * max(1.0, float(want_lse.abs().max()))
    lse_err = float((lse - want_lse).abs().max())
    return ok, err, lse_err <= lse_tol, lse_err


def _backward_ok(case, split):
    *_, causal, window, off = case
    q, k, v, do = _inputs(case, 11)
    out, lse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        q_offset=off)
    got = tc_backward(q, k, v, out, lse, do, causal=causal, window=window,
                      split=split, q_offset=off)
    want = fk.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                        window=window, q_offset=off)
    return [chip_smoke.bwd_close(g, w, torch.bfloat16) for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_forward_holds_the_bound(case):
    ok, err, lse_ok, lse_err = _forward_ok(case, split=True)
    assert ok, f"out max_abs_err {err}"
    assert lse_ok, f"lse err {lse_err}"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_backward_holds_the_bound(case):
    for name, (ok, err) in zip(("dq", "dk", "dv"), _backward_ok(case, split=True)):
        assert ok, f"{name} max_abs_err {err}"


def test_single_bf16_p_and_ds_fail_the_bound():
    """Without the lo half, P V and dS K / dS^T Q / P^T dO leave the
    bound: the split is not redundant."""
    assert not all(_forward_ok(c, split=False)[0] for c in CASES)
    assert not all(ok for c in CASES for ok, _ in _backward_ok(c, split=False))


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh changes every library's path, so both flash
    kernels rebuild; an unrelated file does not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "no shared header under csrc/"
    before = {name: build.library_path(name) for name in build.SOURCES}
    (csrc / "notes.txt").write_text("not a source")
    assert {name: build.library_path(name) for name in build.SOURCES} == before
    headers[0].write_text(headers[0].read_text() + "\n// touched\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    for name in build.SOURCES:
        assert after[name] != before[name], name
