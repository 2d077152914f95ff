"""Row-wise RMSNorm on Hopper: ``x * rsqrt(mean(x^2) + eps) * scale``.

* ``rmsnorm_fwd`` — the forward wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/rmsnorm.cu`` (built with nvcc for sm_90a,
  bound with ctypes) or raises; it takes the plain version only because
  its input lies on the CPU. ``rmsnorm_fwd.launches`` counts kernel
  launches. ``norm_plan`` is the launch's shape (threads a row, vectors a
  thread, blocks), which the CPU tests re-derive; ``rmsnorm_floor``
  launches an empty kernel of that shape (a timing's launch floor).
* ``RMSNorm`` — the ``torch.autograd.Function`` around it, and
  ``rmsnorm`` which applies it on both devices (the op the models call).
  Its backward is torch code in f32, not a kernel: the reference has no
  RMSNorm backward kernel (its models differentiate the plain jnp
  ``layers.rmsnorm``).
* ``rmsnorm_plain`` — the same function in plain PyTorch, the twin of the
  reference's ``repro/models/layers.py:rmsnorm`` (and of
  ``kernels/ops.py:_rmsnorm_jnp`` and ``kernels/ref.py:rmsnorm_ref``): f32
  inside, the mean of squares over the last axis, one rounding to x's
  dtype.

The kernel replaces the TPU kernel ``repro/kernels/rmsnorm.py:
rmsnorm_pallas``. The reference left that kernel unwired; the port's models
call this one for every norm (``models/layers.py:rmsnorm``). What bounds it
and what its design does about it is noted at the top of the source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 256                  # threads a block in warp mode; the most a row takes
DECODE_ROWS = 64             # up to this many rows, a row takes a block
SMS = 132                    # an H100 SXM's SMs


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def norm_plan(rows: int, D: int, vw: int) -> tuple[int, int, int]:
    """(tpr, nv, grid): threads a row, 16-byte vectors (or scalars, vw 1) a
    thread holds, and blocks. Many rows of up to 128 vectors: a warp a row
    (eight a block), the least nv in {1, 2, 4} that covers it, and blocks
    for two rows a warp, so the next row's loads overlap this row's stores.
    Else a block a row: many rows (wide ones) take at least two vectors a
    thread, a decode step's few rows one where a block of <= 256 threads
    covers it (the shortest latency chain); blocks for half the card's
    threads, walking the rows."""
    nvec = -(-D // vw)
    per_warp = -(-nvec // 32)
    if rows > DECODE_ROWS and per_warp <= 4:
        nv = 1
        while nv < per_warp:
            nv *= 2
        return 32, nv, min(-(-rows // (BLOCK // 32)), 2 * SMS)
    nv = 1 if rows <= DECODE_ROWS else 2
    while nv < 8 and -(-nvec // nv) > BLOCK:
        nv *= 2
    tpr = min(BLOCK, -(-(-(-nvec // nv)) // 32) * 32)
    if tpr == 32:                       # one warp's worth: eight rows a block
        return tpr, nv, min(-(-rows // (BLOCK // 32)), 2 * SMS)
    return tpr, nv, min(rows, SMS * 1024 // tpr)


def _bind():
    lib = build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        i = ctypes.c_int
        for f in (fn, lib.rmsnorm_floor_launch):
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, i, ctypes.c_float, i, i, i, i, i,
                          i, ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def _checked(x, scale):
    """The wrapper's checks on card tensors; returns D."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {dev}")
    if x.dtype not in _DTYPE_CODE or scale.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm: x and scale must be float32 or bfloat16, "
                        f"got {x.dtype} and {scale.dtype}")
    D = x.shape[-1]
    if scale.device != dev or tuple(scale.shape) != (D,) \
            or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be a contiguous [{D}] vector "
                         f"on {dev}, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    return D


def _launch(fn, x, scale, out, eps):
    """Launch ``fn`` (the kernel or its floor) over x's rows."""
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return
    wide = 4 if x.dtype == torch.float32 else 8
    aligned = (D % wide == 0 and not x.data_ptr() % 16
               and not out.data_ptr() % 16
               and not scale.data_ptr() % (wide * scale.element_size()))
    vw = wide if aligned else 1
    tpr, nv, grid = norm_plan(rows, D, vw)
    lib = _bind()
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                               rows, D, float(eps), _DTYPE_CODE[x.dtype],
                               _DTYPE_CODE[scale.dtype], vw, tpr, nv, grid,
                               stream)
    if err != 0:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.rmsnorm_error_string(err).decode())


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """x: [..., D] float32 or bfloat16, contiguous; scale: [D] float32 or
    bfloat16 on the same device. Returns x's shape and dtype."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    D = _checked(x, scale)
    out = torch.empty_like(x)
    if (x.numel() // D if D else 0) == 0:
        return out
    _launch("rmsnorm_launch", x, scale, out, eps)
    rmsnorm_fwd.launches += 1
    return out


rmsnorm_fwd.launches = 0


def rmsnorm_floor(x: torch.Tensor, scale: torch.Tensor):
    """Launch an empty kernel of the grid and block ``rmsnorm_fwd`` takes
    for these inputs: the launch floor a timing compares with. Card tensors
    only; counts nothing."""
    _checked(x, scale)
    _launch("rmsnorm_floor_launch", x, scale, x, 0.0)


class RMSNorm(torch.autograd.Function):
    """Differentiable RMSNorm: forward ``rmsnorm_fwd`` (the kernel on the
    card, the plain version on the CPU); backward in torch ops, f32:
    with r = rsqrt(mean(x^2) + eps), x_hat = x r and gs = g scale,
    dx = r (gs - x_hat mean(gs x_hat)) and dscale = sum over rows of
    g x_hat, each rounded once to its primal's dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ctx.eps)
        x_hat = xf * r
        gs = gf * scale.float()
        dx = r * (gs - x_hat * torch.mean(gs * x_hat, dim=-1, keepdim=True))
        dscale = torch.sum((gf * x_hat).reshape(-1, x.shape[-1]), dim=0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6):
    """``rmsnorm_fwd`` through ``RMSNorm``: differentiable in x and scale."""
    return RMSNorm.apply(x, scale, eps)
