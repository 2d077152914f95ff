"""FedALIGN's gated client aggregation (paper eq. (15)) on Hopper:

    out[m] = sum_k w_k g_k u[k, m] / sum_k w_k g_k

over C client rows of a [C, M] buffer, f32 or bf16 in, f32 accumulation,
output in the input dtype. Gated-out rows (w_k g_k <= 0) are masked before
the sum, and zero inclusion mass gives an exact zero vector.

* ``fedagg`` — the wrapper. On CUDA tensors it launches the hand-written
  kernel ``csrc/fedagg.cu`` (built with nvcc for sm_90a, bound with ctypes)
  or raises; it takes the plain version only because its inputs lie on the
  CPU. ``fedagg.launches`` counts kernel launches.
* ``fedagg_plain`` — the same function in plain PyTorch, the twin of the
  reference's jnp lowering ``repro/kernels/ops.py:_fedagg_jnp``.

The kernel replaces the TPU kernel ``repro/kernels/fedagg.py:_mean_kernel``
(identity wire). It is bound by bytes: it streams each included row once
and never reads a gated-out one (see the note at the top of the source).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fedagg_plain(updates, weights, gates):
    """Plain PyTorch gated weighted mean: [C,M],[C],[C] -> [M]."""
    wg = (weights * gates).float()
    den = torch.sum(wg)
    u = torch.where((wg > 0)[:, None], updates.float(), 0.0)
    num = torch.einsum("c,cm->m", wg, u)
    out = torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0)
    return out.to(updates.dtype)


def _bind():
    lib = build.load("fedagg")
    fn = lib.fedagg_mean
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ci, ci, vp, ll, vp, vp, vp, ci, ll, vp]
        fn.restype = ctypes.c_int
        lib.fedagg_error_string.argtypes = [ci]
        lib.fedagg_error_string.restype = ctypes.c_char_p
    return lib


def _vector_width(updates: torch.Tensor, ld: int, out: torch.Tensor) -> int:
    """Widest load (elements, at most 16 bytes) that every row start and
    the output allow; the kernel handles a ragged M with a scalar tail."""
    size = updates.element_size()
    vw = 16 // size
    while vw > 1 and (ld % vw
                      or updates.data_ptr() % (vw * size)
                      or out.data_ptr() % (vw * size)):
        vw //= 2
    return vw


def fedagg(updates: torch.Tensor, weights: torch.Tensor,
           gates: torch.Tensor) -> torch.Tensor:
    """Gated client mean: updates [C, M] (rows contiguous, any row pitch),
    weights and gates [C] float32 -> [M] in ``updates.dtype``."""
    if updates.device.type == "cpu":
        return fedagg_plain(updates, weights, gates)
    if updates.device.type != "cuda":
        raise ValueError(f"fedagg: unsupported device {updates.device}")
    if updates.dtype not in _DTYPE_CODE:
        raise TypeError(f"fedagg: updates must be float32 or bfloat16, "
                        f"got {updates.dtype}")
    if updates.dim() != 2:
        raise ValueError(f"fedagg: updates must be [C, M], got "
                         f"{tuple(updates.shape)}")
    C, M = updates.shape
    if M > 1 and updates.stride(1) != 1:
        raise ValueError("fedagg: each row of updates must be contiguous")
    if C > 1 and updates.stride(0) < M:
        raise ValueError("fedagg: rows of updates overlap")
    for name, v in (("weights", weights), ("gates", gates)):
        if v.device != updates.device:
            raise ValueError(f"fedagg: {name} on {v.device}, updates on "
                             f"{updates.device}")
        if v.dtype != torch.float32 or v.shape != (C,) or not v.is_contiguous():
            raise ValueError(f"fedagg: {name} must be a contiguous float32 "
                             f"[{C}] vector, got {v.dtype} "
                             f"{tuple(v.shape)}")
    out = torch.empty(M, dtype=updates.dtype, device=updates.device)
    if M == 0:
        return out
    lib = _bind()
    ld = updates.stride(0) if C > 1 else M
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        err = lib.fedagg_mean(_DTYPE_CODE[updates.dtype],
                              _vector_width(updates, ld, out),
                              updates.data_ptr(),
                              ld, weights.data_ptr(), gates.data_ptr(),
                              out.data_ptr(), C, M, stream)
    if err != 0:
        raise RuntimeError("fedagg kernel launch failed: "
                           + lib.fedagg_error_string(err).decode())
    fedagg.launches += 1
    return out


fedagg.launches = 0
