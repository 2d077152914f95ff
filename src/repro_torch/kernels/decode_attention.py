"""Decode attention on Hopper: one query token per sequence against a KV
cache whose first ``kv_len`` rows are valid (in any order: under a sliding
window the cache is a ring).

* ``decode_attention`` — the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/decode_attention.cu`` (built with nvcc for
  sm_90a, bound with ctypes) or raises; it takes the plain version only
  because its inputs lie on the CPU. ``kv_len`` is a host int, passed to
  the kernel as an argument, so a decode step never waits on the device.
  ``decode_attention.launches`` counts calls that launched the kernel (one
  launch per call: the splits of the cache are one thread-block cluster
  and merge inside the kernel).
* ``decode_plan`` — the launch's shape, which the CPU tests re-derive:
  GT query heads a block serves, the number of head chunks, and
  ``split_plan``'s splits of the valid rows. ``decode_attention_floor``
  launches an empty kernel of that shape (a timing's launch floor).
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
TILE = 16                      # the kernel's keys per warp tile
WARPS = 8                      # warps a block, each taking every 8th tile
MAX_SPLIT = 8                  # blocks a cluster (the portable most)
TARGET_BLOCKS = 64             # blocks worth splitting the rows for: about
                               # half an H100's SMs (a merge across a
                               # cluster costs more than a few tiles)


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


def split_plan(blocks: int, kv_len: int) -> tuple[int, int]:
    """(keys_per_split, n_split) for ``blocks`` (batch, kv head, head chunk)
    triples: the least power of two of splits of the valid rows (one
    cluster, at most MAX_SPLIT) that gives the card TARGET_BLOCKS blocks,
    at least a tile of rows each. No split is empty: per = ceil(kv_len /
    n) >= TILE and n <= MAX_SPLIT give (n - 1) per < kv_len."""
    n = 1
    while n < MAX_SPLIT and blocks * n < TARGET_BLOCKS and 2 * n * TILE <= kv_len:
        n *= 2
    return -(-kv_len // n), n


def head_group(G: int) -> tuple[int, int]:
    """(GT, chunks): a block serves GT query heads of one kv head, the least
    power of two >= G up to 8; G > 8 takes ceil(G / 8) chunks."""
    gt = 1
    while gt < min(G, 8):
        gt *= 2
    return gt, -(-G // gt)


def decode_plan(B, H, KV, kv_len):
    """(gt, chunks, keys_per_split, n_split) of a launch."""
    gt, chunks = head_group(H // KV)
    per, n_split = split_plan(B * KV * chunks, kv_len)
    return gt, chunks, per, n_split


def _bind():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        i = ctypes.c_int
        for f in (fn, lib.decode_attention_floor_launch):
            f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                          + [i] * 8 + [ctypes.c_float, i, ctypes.c_void_p])
            f.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _checked(q, k_cache, v_cache, kv_len, scale):
    """The wrapper's checks on card tensors; returns (B, H, KV, hd,
    kv_len, scale, k strides, v strides)."""
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
    k_strides = check_rows("decode_attention: k_cache", k_cache, q.dtype, dev)
    v_strides = check_rows("decode_attention: v_cache", v_cache, q.dtype, dev)
    return B, H, KV, hd, kv_len, scale, k_strides, v_strides


def _launch(fn, lib, q, k_cache, v_cache, out, dims):
    B, H, KV, hd, kv_len, scale, (k_sb, k_ss), (v_sb, v_ss) = dims
    if B == 0:
        return
    gt, _, per, n_split = decode_plan(B, H, KV, kv_len)
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 out.data_ptr(), k_sb, k_ss, v_sb, v_ss, B, H, KV, hd, kv_len,
                 gt, per, n_split, float(scale), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.decode_attention_error_string(err).decode())


def decode_attention(q, k_cache, v_cache, *, kv_len, scale=None):
    """[B, 1, H, hd] like q. ``kv_len``: the valid cache rows, 1 <= kv_len
    <= Skv; on the card a host int (a device tensor would need a sync)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len=kv_len,
                                      scale=scale)
    dims = _checked(q, k_cache, v_cache, kv_len, scale)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    lib = _bind()
    _launch(lib.decode_attention_launch, lib, q, k_cache, v_cache, out, dims)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_floor(q, k_cache, v_cache, *, kv_len):
    """Launch an empty kernel of the launch shape ``decode_attention`` takes
    for these inputs (grid, cluster, block, shared memory): the launch
    floor a timing compares with. Card tensors only; counts nothing."""
    dims = _checked(q, k_cache, v_cache, kv_len, None)
    lib = _bind()
    _launch(lib.decode_attention_floor_launch, lib, q, k_cache, v_cache, q,
            dims)
