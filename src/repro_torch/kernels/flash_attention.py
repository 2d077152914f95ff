"""Flash-attention forward with the per-row LSE on Hopper: causal or
sliding-window grouped-query attention, queries at the last Sq positions.

* ``flash_attention_fwd`` — the wrapper, ``(out, lse)``. On CUDA tensors it
  launches the hand-written kernel ``csrc/flash_attention.cu`` (built with
  nvcc for sm_90a, bound with ctypes) or raises; it takes the plain version
  only because its inputs lie on the CPU. ``flash_attention_fwd.launches``
  counts kernel launches.
* ``flash_attention`` — ``flash_attention_fwd(...)[0]``, the op the
  attention block calls (``kernels/ops.py``).
* ``flash_attention_plain`` — the same function in plain PyTorch: the twin
  of the reference's jnp lowering ``repro/kernels/ops.py:
  _flash_attention_jnp`` (a scan of ``block_kv``-row blocks with -1e30
  masking and an online softmax, the kv axis padded to a block multiple),
  plus the LSE the reference's Pallas kernel emits.

Shapes: q [B, Sq, H, hd], k and v [B, Skv, KV, hd], Sq <= Skv, H a multiple
of KV (query head h reads kv head h // G, G = H / KV); out like q; lse f32
[B * KV, G, Sq] = m + log(max(l, 1e-30)), the layout of the reference's
``flash_attention_fwd_pallas``.

The kernel replaces the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention_fwd_pallas`` (``_kernel_fwd_lse`` over ``_kernel``). What
bounds it and what its design does about it is noted at the top of the
source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d "
                         "[B, S, heads, hd]")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or hdk != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} kv heads")
    if Sq > Skv:
        raise ValueError(f"flash_attention: {Sq} queries but only {Skv} "
                         "keys (queries are the last Sq positions)")
    return B, Sq, H, hd, Skv, KV


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          block_kv=1024):
    """(out, lse) by the reference's blockwise online softmax (f32)."""
    B, Sq, H, hd, Skv, KV = _check_shapes(q, k, v)
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    block = min(block_kv, Skv)
    q_offset = Skv - Sq
    if Skv % block:                       # pad kv to a block multiple, mask the tail
        pad = block - Skv % block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n = k.shape[1]
    qf = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, n, block):
        kc = k[:, start:start + block].float()
        vc = v[:, start:start + block].float()
        k_pos = start + torch.arange(block, device=q.device)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kc)
        mask = (k_pos[None, :] < Skv).expand(Sq, block)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-30))).reshape(B * KV, G, Sq)
    return out, lse


def _bind():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        ll, i = ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ll] * 6 + [i] * 8
                       + [ctypes.c_float, i, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_rows(name, x, dtype, device):
    """x is [B, S, heads, hd] of ``dtype`` on ``device`` whose (heads, hd)
    rows are contiguous and 16-byte aligned; returns its batch and seq
    strides (elements). Shared with the decode-attention wrapper."""
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, q on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, q is {dtype}")
    _, _, heads, hd = x.shape
    if x.stride(3) != 1 or (heads > 1 and x.stride(2) != hd):
        raise ValueError(f"{name}: each [heads, hd] row must be contiguous")
    size = x.element_size()
    if x.data_ptr() % 16 or (x.stride(0) * size) % 16 \
            or (x.stride(1) * size) % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    return x.stride(0), x.stride(1)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, scale=None,
                        block_kv=1024):
    """(out [B, Sq, H, hd] like q, lse [B * KV, G, Sq] f32). ``block_kv``
    is the plain version's block; the kernel's tile is its own."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_kv=block_kv)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, Sq, H, hd, Skv, KV = _check_shapes(q, k, v)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} exceeds 65535")
    if scale is None:
        scale = hd ** -0.5
    q_sb, q_ss = check_rows("flash_attention: q", q, q.dtype, dev)
    k_sb, k_ss = check_rows("flash_attention: k", k, q.dtype, dev)
    v_sb, v_ss = check_rows("flash_attention: v", v, q.dtype, dev)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B * KV, H // KV, Sq), dtype=torch.float32, device=dev)
    if B == 0 or Sq == 0:
        return out, lse
    lib = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, B, Sq, Skv,
            H, KV, hd, int(bool(causal)), int(window or 0), float(scale),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    block_kv=1024):
    """Attention output only: [B, Sq, H, hd] like q."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale, block_kv=block_kv)[0]
