"""Decode attention on Hopper: one query token per sequence against a KV
cache whose first ``kv_len`` rows are valid (in any order: under a sliding
window the cache is a ring).

* ``decode_attention`` — the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/decode_attention.cu`` (built with nvcc for
  sm_90a, bound with ctypes) or raises; it takes the plain version only
  because its inputs lie on the CPU. ``kv_len`` is a host int, passed to
  the kernel as an argument, so a decode step never waits on the device.
  ``decode_attention.launches`` counts calls that launched the kernel (one
  per call: the split-KV partial pass, plus its merge pass when the cache
  is split).
* ``decode_attention_plain`` — the same function in plain PyTorch, the
  twin of the reference's jnp lowering ``repro/kernels/ops.py:
  _decode_attention_jnp`` (the whole cache, -1e30 past kv_len, softmax).

Shapes: q [B, 1, H, hd]; k_cache, v_cache [B, Skv, KV, hd], H a multiple of
KV (query head h reads kv head h // G); out like q.

The kernel replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention_pallas``. What bounds it and what its design does about
it is noted at the top of the source.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS, NEG_INF, check_rows

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                      # the kernel's keys per tile
TARGET_BLOCKS = 1056           # about eight blocks per SM of an H100


def decode_attention_plain(q, k_cache, v_cache, *, kv_len, scale=None):
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k_cache.shape
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k_cache.float())
    valid = torch.arange(Skv, device=q.device)[None, :] < kv_len
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bkgqh", w, v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def split_plan(BH: int, kv_len: int) -> tuple[int, int]:
    """(keys_per_split, n_split): enough splits of the valid rows to give
    the card about TARGET_BLOCKS blocks, each a whole number of tiles and
    none empty."""
    tiles = -(-kv_len // TILE)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // BH)))
    per = -(-tiles // want) * TILE
    return per, -(-kv_len // per)


def _bind():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4
                       + [i] * 7 + [ctypes.c_float, i, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention(q, k_cache, v_cache, *, kv_len, scale=None):
    """[B, 1, H, hd] like q. ``kv_len``: the valid cache rows, 1 <= kv_len
    <= Skv; on the card a host int (a device tensor would need a sync)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len=kv_len,
                                      scale=scale)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {dev}")
    if isinstance(kv_len, torch.Tensor):
        raise TypeError("decode_attention: kv_len must be a host int on the "
                        "card (reading a device tensor would sync the host)")
    kv_len = operator.index(kv_len)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be [B, 1, H, hd], got "
                         f"{tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k_cache.dim() != 4 or tuple(v_cache.shape) != tuple(k_cache.shape) \
            or k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    Skv, KV = k_cache.shape[1], k_cache.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"decode_attention: {H} query heads are not a "
                         f"multiple of {KV} kv heads")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"decode_attention: kv_len {kv_len} outside "
                         f"[1, {Skv}]")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"decode_attention: B * H = {B * H} exceeds 65535")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("decode_attention: q must be contiguous and "
                         "16-byte aligned")
    if scale is None:
        scale = hd ** -0.5
    k_sb, k_ss = check_rows("decode_attention: k_cache", k_cache, q.dtype, dev)
    v_sb, v_ss = check_rows("decode_attention: v_cache", v_cache, q.dtype, dev)
    out = torch.empty_like(q)
    if B == 0:
        return out
    per, n_split = split_plan(B * H, kv_len)
    part = torch.empty(B * H * n_split * (hd + 2) if n_split > 1 else 1,
                       dtype=torch.float32, device=dev)
    lib = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), part.data_ptr(), k_sb, k_ss, v_sb, v_ss, B, H,
            KV, hd, kv_len, per, n_split, float(scale),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
