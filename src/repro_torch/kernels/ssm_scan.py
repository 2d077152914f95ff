"""The Mamba (S6) selective scan on Hopper, and its one-step decode form.

* ``ssm_scan`` — the wrapper. On CUDA tensors it launches the hand-written
  kernel ``csrc/ssm_scan.cu`` (built with nvcc for sm_90a, bound with
  ctypes) or raises; it takes the plain version only because its inputs
  lie on the CPU. ``ssm_scan.launches`` counts kernel launches (one per
  call). With ``return_state=True`` it also returns the final state h_S,
  which the kernel writes as it ends, so a prefill needs no second pass.
* ``ssm_scan_plain`` — the same function in plain PyTorch: the sequential
  f32 recurrence of the reference's oracle ``repro/kernels/ref.py:
  ssm_scan_ref``, with the final state of ``repro/models/ssm.py:
  _final_state``.
* ``ssm_step`` — one decode step, plain PyTorch on both devices: the twin
  of ``repro/kernels/ops.py:ssm_step`` (the reference has no kernel for
  it).

No backward: the reference's training differentiates its jnp lowering
``_ssm_scan_jnp``. Under grad, with an input that requires grad,
``ssm_scan`` raises ``NotImplementedError`` on both devices (ROADMAP A16f)
rather than return a tensor without a ``grad_fn``.

Shapes (the reference's): x [Bt, S, Di] f32 or bf16, dt [Bt, S, Di] f32,
A [Di, N] f32 (negative), B and C [Bt, S, N] f32, D [Di] f32; y like x, the
state [Bt, Di, N] f32. The kernel holds N <= 16 states a channel.

The kernel replaces the TPU kernel ``repro/kernels/ssm_scan.py:
ssm_scan_pallas``. What bounds it and what its design does about it is
noted at the top of the source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 16


def ssm_scan_plain(x, dt, A, B, C, D, *, return_state=False):
    Bt, S, Di = x.shape
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf = A.float(), B.float(), C.float()
    h = torch.zeros((Bt, Di, A.shape[1]), dtype=torch.float32, device=x.device)
    y = torch.empty_like(xf)
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = torch.sum(h * Cf[:, t, None, :], dim=-1)
    y = (y + xf * D.float()).to(x.dtype)
    return (y, h) if return_state else y


def ssm_step(h, xt, dtt, A, Bt, Ct):
    """h [B, Di, N] f32, xt / dtt [B, Di], Bt / Ct [B, N] -> (h', y [B, Di])
    with y = C . h' (the skip D x is the caller's)."""
    dA = torch.exp(dtt[..., None] * A[None].float())
    dB = dtt[..., None] * Bt[:, None, :].float()
    h = dA * h + dB * xt[..., None].float()
    y = torch.einsum("bdn,bn->bd", h, Ct.float())
    return h, y


def _bind():
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, B, C, D):
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("ssm_scan: x must be [Bt, S, Di] and A [Di, N]")
    Bt, S, Di = x.shape
    N = A.shape[1]
    want = {"dt": (dt, (Bt, S, Di)), "A": (A, (Di, N)), "B": (B, (Bt, S, N)),
            "C": (C, (Bt, S, N)), "D": (D, (Di,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan: {name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ssm_scan: {name} lies on {t.device}, x on "
                             f"{x.device}")
    return Bt, S, Di, N


def ssm_scan(x, dt, A, B, C, D, *, chunk=256, return_state=False):
    """y [Bt, S, Di] in x's dtype, and with ``return_state`` the final
    state [Bt, Di, N] f32. ``chunk`` is the reference's time tile, accepted
    for its signature: it changes nothing here (the kernel stages its own
    tiles, and any S is allowed)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        raise NotImplementedError(
            "ssm_scan has no backward yet: training through the Mamba mixer "
            "is ROADMAP A16f (run serving under torch.no_grad)")
    if int(chunk) < 1:
        raise ValueError(f"ssm_scan: chunk must be positive, got {chunk}")
    Bt, S, Di, N = _check(x, dt, A, B, C, D)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B, C, D, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssm_scan: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} must be float32, got {t.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C, D)):
        raise ValueError("ssm_scan: every input must be contiguous")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan: the kernel holds 1..{MAX_STATE} states "
                         f"a channel, got N = {N}")
    if Bt > 65535:
        raise ValueError(f"ssm_scan: at most 65535 sequences a call, got {Bt}")
    y = torch.empty_like(x)
    h = (torch.empty((Bt, Di, N), dtype=torch.float32, device=x.device)
         if return_state else None)
    lib = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(),
            h.data_ptr() if h is not None else None, Bt, S, Di, N,
            _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    ssm_scan.launches += 1
    return (y, h) if return_state else y


ssm_scan.launches = 0
