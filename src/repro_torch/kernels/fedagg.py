"""FedALIGN's fused client aggregation on Hopper: one wire decoder composed
with one reducer, over C client rows, in one kernel launch.

Reducers (``aggregator``), over the included rows:

* ``mean`` — the paper's server step (eq. (15)),
  ``out[m] = sum_k w_k g_k u[k, m] / sum_k w_k g_k``;
* ``dp`` — DP-FedAvg: each row times its clip factor ``row_scale`` inside
  the same weighted sum, plus ``noise[m] * noise_scale / sum_k w_k g_k``;
* ``trimmed_mean`` / ``median`` — coordinate-wise order statistics over the
  clients with ``g_k > 0``, unweighted (a bitonic sort down the client
  axis; excluded clients sort to +inf).

Decoders (``codec``): ``identity`` (the dense [C, M] buffer, f32 or bf16),
``int8`` (rows times a per-client scale), ``topk`` ([C, k] values and
indices) and ``sketch`` ([C, dim] CountSketch rows gathered through the
hash ``sketch_h`` and sign ``sketch_sign`` planes). Every variant masks the
excluded rows before reducing and gives exact zeros when nothing is
included. The identity wire keeps ``updates.dtype``; the others give f32.

* ``fedagg`` — the wrapper. On CUDA tensors it launches the hand-written
  kernel ``csrc/fedagg.cu`` (built with nvcc for sm_90a, bound with ctypes)
  or raises; it takes the plain version only because its inputs lie on the
  CPU. ``fedagg.launches`` counts kernel launches, and
  ``fedagg.variant_launches`` counts them per (aggregator, codec).
* ``fedagg_plain`` — the same function in plain PyTorch, the twin of the
  reference's jnp lowering ``repro/kernels/ops.py:fedagg`` (use_pallas off),
  with ``sort_cols_plain`` the twin of ``repro/kernels/fedagg.py:
  sort_cols_jnp`` and ``decode_wire_plain`` of ``ops._decode_wire_jnp``.

The kernel replaces the TPU kernel ``repro/kernels/fedagg.py:fedagg_pallas``
(its ``_mean_kernel``, ``_dp_kernel``, ``_trimmed_kernel`` and
``_median_kernel`` reducers over the ``_decode_*`` decoders). What bounds
each part on the card and what its design does about it is noted at the top
of the source.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build

AGGREGATORS = ("mean", "dp", "trimmed_mean", "median")
CODECS = ("identity", "int8", "topk", "sketch")
_REDUCER_CODE = {name: i for i, name in enumerate(AGGREGATORS)}
_CODEC_CODE = {name: i for i, name in enumerate(CODECS)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_SORT_ROWS = 1024          # the sorted reducers hold C <= 1024 rows a column
# mean / dp over the sketch wire: up to this many buckets (224 KB of f32),
# with sketch_h, sketch_sign and the output on 16-byte boundaries, the
# kernel sums the buckets first in shared memory (sketch_kernel); else it
# gathers every row's bucket from L2 (stream_kernel)
MAX_SKETCH_DIM = 57344
INT8_WIDTHS = (4, 1)          # int8 columns a thread of the stream kernel


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# ============================================================ plain versions
def sort_cols_plain(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort along axis 0 of [C, M]: the reference's bitonic
    network (C padded to a power of two with +inf), stage for stage, with
    NaN-propagating min/max, so a NaN lands where the reference puts it."""
    C = x.shape[0]
    P = _next_pow2(C)
    if P != C:
        pad = torch.full((P - C,) + tuple(x.shape[1:]), float("inf"),
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=0)
    idx = torch.arange(P, device=x.device)
    k = 2
    while k <= P:
        j = k // 2
        while j >= 1:
            px = x[idx ^ j]
            lo = torch.minimum(x, px)
            hi = torch.maximum(x, px)
            take_lo = (((idx & k) == 0) == ((idx & j) == 0))[:, None]
            x = torch.where(take_lo, lo, hi)
            j //= 2
        k *= 2
    return x[:C]


def _mean_plain(updates, weights, gates):
    wg = (weights * gates).float()
    den = torch.sum(wg)
    u = torch.where((wg > 0)[:, None], updates.float(), 0.0)
    num = torch.einsum("c,cm->m", wg, u)
    out = torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0)
    return out.to(updates.dtype)


def _dp_plain(updates, weights, gates, row_scale, noise, noise_scale):
    wg = (weights * gates).float()
    den = torch.sum(wg)
    u = torch.where((wg > 0)[:, None], updates.float(), 0.0)
    # mask the clip scales too: an excluded client's NaN delta makes its
    # row_scale NaN, and 0 * NaN would re-poison the masked row
    wgs = torch.where(wg > 0, wg * row_scale.float(), 0.0)
    num = torch.einsum("c,cm->m", wgs, u)
    safe = torch.clamp(den, min=1e-30)
    noisy = num / safe + noise.float() * (noise_scale / safe)
    return torch.where(den > 0, noisy, 0.0).to(updates.dtype)


def _sorted_plain(updates, gates, trim_frac=None):
    """Trimmed mean (``trim_frac`` set) or median (None) over the clients
    with gate > 0, unweighted; exact zero when none is included."""
    C = updates.shape[0]
    inc = gates > 0
    n = torch.sum(inc.to(torch.int32))
    s = sort_cols_plain(torch.where(inc[:, None], updates.float(), float("inf")))
    idx = torch.arange(C, dtype=torch.int32, device=updates.device)[:, None]
    if trim_frac is None:
        lo, hi = torch.div(n - 1, 2, rounding_mode="floor"), n // 2
        med = 0.5 * (torch.sum(torch.where(idx == lo, s, 0.0), dim=0)
                     + torch.sum(torch.where(idx == hi, s, 0.0), dim=0))
        out = torch.where(n > 0, med, 0.0)
    else:
        # t = int32(float32(trim_frac) * float32(n)), in f32 as the reference
        t = (torch.tensor(trim_frac, dtype=torch.float32, device=n.device)
             * n.float()).to(torch.int32)
        keep = (idx >= t) & (idx < n - t)
        cnt = n - 2 * t
        total = torch.sum(torch.where(keep, s, 0.0), dim=0)
        out = torch.where(cnt > 0, total / torch.clamp(cnt, min=1).float(), 0.0)
    return out.to(updates.dtype)


def decode_wire_plain(updates, *, codec, dequant_scale=None, topk_idx=None,
                      sketch_h=None, sketch_sign=None, out_m=None):
    """Decode a wire payload to the dense f32 [C, M] buffer: int8 rows times
    the row scale after the f32 cast; topk places the (value, index) pairs
    (indices within a row are distinct); sketch gathers each column's bucket
    and applies its sign."""
    if codec == "int8":
        if dequant_scale is None:
            raise ValueError("codec='int8' needs dequant_scale [C]")
        return updates.float() * dequant_scale.float()[:, None]
    if codec == "topk":
        if topk_idx is None or out_m is None:
            raise ValueError("codec='topk' needs topk_idx [C, k] and out_m")
        buf = torch.zeros(updates.shape[0], int(out_m), dtype=torch.float32,
                          device=updates.device)
        return buf.scatter_add_(1, topk_idx.long(), updates.float())
    if codec == "sketch":
        if sketch_h is None or sketch_sign is None:
            raise ValueError("codec='sketch' needs sketch_h [M] and "
                             "sketch_sign [M]")
        return updates.float()[:, sketch_h.long()] * sketch_sign.float()[None, :]
    raise ValueError(f"unknown wire codec {codec!r}")


def fedagg_plain(updates, weights, gates, *, aggregator="mean", trim_frac=0.0,
                 row_scale=None, noise=None, noise_scale=0.0,
                 codec="identity", dequant_scale=None, topk_idx=None,
                 sketch_h=None, sketch_sign=None, out_m=None):
    """Plain PyTorch gated aggregation, [C, M] (or the codec's wire shape),
    [C], [C] -> [M]: decode the wire to a dense buffer, then reduce."""
    if codec != "identity":
        updates = decode_wire_plain(updates, codec=codec,
                                    dequant_scale=dequant_scale,
                                    topk_idx=topk_idx, sketch_h=sketch_h,
                                    sketch_sign=sketch_sign, out_m=out_m)
    if aggregator == "mean":
        return _mean_plain(updates, weights, gates)
    if aggregator == "trimmed_mean":
        return _sorted_plain(updates, gates, trim_frac=float(trim_frac))
    if aggregator == "median":
        return _sorted_plain(updates, gates)
    if aggregator == "dp":
        if row_scale is None or noise is None:
            raise ValueError("aggregator='dp' needs row_scale [C] and noise [M]")
        return _dp_plain(updates, weights, gates, row_scale, noise,
                         float(noise_scale))
    raise ValueError(f"unknown in-kernel aggregator {aggregator!r}")


# ==================================================================== kernel
class FedaggArgs(ctypes.Structure):
    """The kernel's argument block (``FedaggArgs`` in ``csrc/fedagg.cu``)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "u", "w", "g", "row_scale", "noise", "dequant_scale", "topk_idx",
        "sketch_h", "sketch_sign", "out")] + [
        ("ld", ctypes.c_longlong), ("M", ctypes.c_longlong),
        ("noise_scale", ctypes.c_float), ("trim_frac", ctypes.c_float),
        ("reducer", ctypes.c_int), ("codec", ctypes.c_int),
        ("dtype", ctypes.c_int), ("vw", ctypes.c_int), ("C", ctypes.c_int),
        ("sort_cols", ctypes.c_int)]


def _bind():
    lib = build.load("fedagg")
    fn = lib.fedagg_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(FedaggArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fedagg_error_string.argtypes = [ctypes.c_int]
        lib.fedagg_error_string.restype = ctypes.c_char_p
    return lib


def _vector_width(widths, ld: int, *tensors) -> int:
    """The widest load (elements) among the kernel's ``widths`` that the
    row pitch and every base pointer allow; the kernel handles a ragged M
    with a scalar tail."""
    for vw in widths:
        if not ld % vw and not any(t.data_ptr() % (vw * t.element_size())
                                   for t in tensors):
            return vw
    return 1


def _sort_cols(C: int) -> int:
    """Threads (= columns) per block of the shared-memory sorted kernel
    (C > 64; at P <= 64 the register route takes 128): a [P, cols] f32
    tile of at most 64 KB, and at least one warp (128 KB at P = 1024)."""
    return max(32, min(128, 16384 // _next_pow2(C)))


def _check_vec(name, v, n, device, dtype=torch.float32):
    if v is None:
        raise ValueError(f"fedagg: {name} is required")
    if v.device != device:
        raise ValueError(f"fedagg: {name} on {v.device}, updates on {device}")
    if v.dtype != dtype or tuple(v.shape) != (n,) or not v.is_contiguous():
        raise ValueError(f"fedagg: {name} must be a contiguous {dtype} "
                         f"[{n}] vector, got {v.dtype} {tuple(v.shape)}")


def _check_rows(name, x, dtype, device):
    """x is [C, cols] of ``dtype`` with contiguous, non-overlapping rows;
    returns its row pitch."""
    if x.device != device:
        raise ValueError(f"fedagg: {name} on {x.device}, updates on {device}")
    if x.dtype != dtype or x.dim() != 2:
        raise ValueError(f"fedagg: {name} must be a 2-d {dtype} tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    C, n = x.shape
    if n > 1 and x.stride(1) != 1:
        raise ValueError(f"fedagg: each row of {name} must be contiguous")
    if C > 1 and x.stride(0) < n:
        raise ValueError(f"fedagg: rows of {name} overlap")
    return x.stride(0) if C > 1 else n


def fedagg(updates: torch.Tensor, weights: torch.Tensor, gates: torch.Tensor,
           *, aggregator="mean", trim_frac=0.0, row_scale=None, noise=None,
           noise_scale=0.0, codec="identity", dequant_scale=None,
           topk_idx=None, sketch_h=None, sketch_sign=None, out_m=None):
    """Gated client aggregation in one launch: [C, M] (or the codec's wire
    shape), [C], [C] float32 -> [M].

    Operands by codec: ``identity`` — updates [C, M] f32 or bf16 (rows
    contiguous, any row pitch); ``int8`` — updates [C, M] int8 and
    ``dequant_scale`` [C] f32; ``topk`` — updates [C, k] f32 values and
    ``topk_idx`` [C, k] int32, each row ascending (the topk codec's encode
    sorts them so), and ``out_m``; ``sketch`` — updates [C, dim] f32,
    ``sketch_h`` [M] int32 in [0, dim), ``sketch_sign`` [M] f32 and
    ``out_m``. ``dp`` adds ``row_scale`` [C] f32 and ``noise`` [M] f32."""
    if aggregator not in _REDUCER_CODE:
        raise ValueError(f"unknown in-kernel aggregator {aggregator!r}")
    if codec not in _CODEC_CODE:
        raise ValueError(f"unknown wire codec {codec!r}")
    if updates.device.type == "cpu":
        return fedagg_plain(updates, weights, gates, aggregator=aggregator,
                            trim_frac=trim_frac, row_scale=row_scale,
                            noise=noise, noise_scale=noise_scale, codec=codec,
                            dequant_scale=dequant_scale, topk_idx=topk_idx,
                            sketch_h=sketch_h, sketch_sign=sketch_sign,
                            out_m=out_m)
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"fedagg: unsupported device {dev}")
    if updates.dim() != 2:
        raise ValueError(f"fedagg: updates must be 2-d, got "
                         f"{tuple(updates.shape)}")
    C = updates.shape[0]
    _check_vec("weights", weights, C, dev)
    _check_vec("gates", gates, C, dev)
    args = FedaggArgs(reducer=_REDUCER_CODE[aggregator],
                      codec=_CODEC_CODE[codec], C=C,
                      w=weights.data_ptr(), g=gates.data_ptr(),
                      trim_frac=float(trim_frac),
                      noise_scale=float(noise_scale))
    if codec == "identity":
        if updates.dtype not in _DTYPE_CODE:
            raise TypeError(f"fedagg: identity updates must be float32 or "
                            f"bfloat16, got {updates.dtype}")
        M = updates.shape[1]
        args.ld = _check_rows("updates", updates, updates.dtype, dev)
        args.dtype = _DTYPE_CODE[updates.dtype]
        out = torch.empty(M, dtype=updates.dtype, device=dev)
        args.vw = _vector_width((4, 2, 1) if args.dtype == 0 else (8, 4, 2, 1),
                                args.ld, updates, out)
    else:
        if out_m is None and codec != "int8":
            raise ValueError(f"fedagg: codec={codec!r} needs out_m")
        M = updates.shape[1] if codec == "int8" else int(out_m)
        out = torch.empty(M, dtype=torch.float32, device=dev)
        if codec == "int8":
            args.ld = _check_rows("updates", updates, torch.int8, dev)
            _check_vec("dequant_scale", dequant_scale, C, dev)
            args.dequant_scale = dequant_scale.data_ptr()
            args.vw = _vector_width(INT8_WIDTHS, args.ld, updates, out)
        elif codec == "topk":
            updates = updates.contiguous()
            args.ld = _check_rows("updates", updates, torch.float32, dev)
            if topk_idx is None:
                raise ValueError("fedagg: codec='topk' needs topk_idx")
            topk_idx = topk_idx.contiguous()
            _check_rows("topk_idx", topk_idx, torch.int32, dev)
            if topk_idx.shape != updates.shape:
                raise ValueError("fedagg: topk_idx and the values differ in "
                                 "shape")
            args.topk_idx = topk_idx.data_ptr()
        else:
            updates = updates.contiguous()
            args.ld = _check_rows("updates", updates, torch.float32, dev)
            _check_vec("sketch_h", sketch_h, M, dev, torch.int32)
            _check_vec("sketch_sign", sketch_sign, M, dev)
            args.sketch_h = sketch_h.data_ptr()
            args.sketch_sign = sketch_sign.data_ptr()
            args.vw = _vector_width((4, 1), 0, sketch_h, sketch_sign, out)
    if aggregator == "dp":
        _check_vec("row_scale", row_scale, C, dev)
        _check_vec("noise", noise, M, dev)
        args.row_scale = row_scale.data_ptr()
        args.noise = noise.data_ptr()
    elif aggregator in ("trimmed_mean", "median"):
        if _next_pow2(C) > MAX_SORT_ROWS:
            raise ValueError(f"fedagg: {aggregator} on the card takes at most "
                             f"{MAX_SORT_ROWS} clients, got {C}")
        args.sort_cols = _sort_cols(C)
    if M == 0:
        return out
    args.u = updates.data_ptr()
    args.M = M
    args.out = out.data_ptr()
    lib = _bind()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fedagg_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError("fedagg kernel launch failed: "
                           + lib.fedagg_error_string(err).decode())
    fedagg.launches += 1
    fedagg.variant_launches[(aggregator, codec)] += 1
    return out


fedagg.launches = 0
fedagg.variant_launches = collections.Counter()
