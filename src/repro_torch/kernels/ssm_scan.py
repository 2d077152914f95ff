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

Gradients: ``ssm_scan`` runs through ``SSMScan``, a
``torch.autograd.Function``, on both devices. Its forward is the kernel on
the card and ``ssm_scan_plain`` on the CPU; its backward, ``ssm_scan_bwd``,
is plain PyTorch on either device (the reference has no Pallas backward:
its training differentiates the jnp lowering ``_ssm_scan_jnp``). The
backward walks the sequence in chunks of ``BWD_CHUNK`` steps: a forward
pass keeps only the state entering each chunk, then a reverse pass
rebuilds the chunk's states from it and runs the adjoint recurrence, both
as associative scans over the chunk (log2 of its length in steps), so it
never holds [Bt, S, Di, N] and makes O(S / BWD_CHUNK) launches.

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


def _work_dtype(x):
    """f32 for f32 / bf16 inputs (the reference's), f64 for f64 ones (so
    that a float64 ``gradcheck`` of the plain route means something)."""
    return torch.promote_types(x.dtype, torch.float32)


def ssm_scan_plain(x, dt, A, B, C, D, *, return_state=False):
    Bt, S, Di = x.shape
    ft = _work_dtype(x)
    xf, dtf = x.to(ft), dt.to(ft)
    Af, Bf, Cf = A.to(ft), B.to(ft), C.to(ft)
    h = torch.zeros((Bt, Di, A.shape[1]), dtype=ft, device=x.device)
    y = torch.empty_like(xf)
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af)
        h = dA * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = torch.sum(h * Cf[:, t, None, :], dim=-1)
    y = (y + xf * D.to(ft)).to(x.dtype)
    return (y, h) if return_state else y


BWD_CHUNK = 64


def _prefix_scan(a, b, reverse=False):
    """Along dim 1 (time): the states h_t of h_t = a_t h_{t-1} + b_t from
    h_{-1} = 0, or with ``reverse`` of h_t = a_t h_{t+1} + b_t from
    h_L = 0 (Hillis-Steele: each element combined with the one k away,
    for k = 1, 2, 4, ..., one fused multiply-add a step into a second
    buffer). Returns a tensor that may be ``b``; ``a`` and ``b`` are
    overwritten."""
    L, k = a.shape[1], 1
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    while k < L:
        if reverse:     # b[t] + a[t] b[t + k] for t < L - k
            near, far, edge = slice(None, -k), slice(k, None), slice(-k, None)
        else:           # b[t] + a[t] b[t - k] for t >= k
            near, far, edge = slice(k, None), slice(None, -k), slice(None, k)
        b2[:, edge] = b[:, edge]
        torch.addcmul(b[:, near], a[:, near], b[:, far], out=b2[:, near])
        b, b2 = b2, b
        if 2 * k < L:
            a2[:, edge] = a[:, edge]
            torch.mul(a[:, near], a[:, far], out=a2[:, near])
            a, a2 = a2, a
        k *= 2
    return b


def _chunk_states(dtc, xc, Bc, A, h0, keep_a=True):
    """(a, h) of one chunk: a_t = exp(dt_t A) (None unless ``keep_a``) and
    the states h_t [Bt, l, Di, N] from the state h0 entering it."""
    a = torch.exp(dtc[..., None] * A)
    h = (dtc * xc)[..., None] * Bc[:, :, None, :]
    h[:, 0] += a[:, 0] * h0
    h = _prefix_scan(a.clone() if keep_a else a, h)
    return (a if keep_a else None), h


def ssm_scan_bwd(x, dt, A, B, C, D, dy):
    """Gradients (dx, ddt, dA, dB, dC, dD) of y = ssm_scan(x, dt, A, B, C,
    D) for the output gradient dy, in plain PyTorch on the inputs' device,
    each in its input's dtype. The reverse-time adjoint of h_t = a_t
    h_{t-1} + dt_t x_t B_t, y_t = h_t . C_t + D x_t with a_t = exp(dt_t A):

        g_t   = dy_t C_t + a_{t+1} g_{t+1}
        dC_t  = sum_d dy_t h_t           dB_t = sum_d g_t dt_t x_t
        dx_t  = dt_t sum_n g_t B_t + D dy_t
        ddt_t = sum_n g_t h_{t-1} a_t A + x_t sum_n g_t B_t
        dA    = sum_{b,t} g_t h_{t-1} a_t dt_t      dD = sum dy x

    computed a chunk of BWD_CHUNK steps at a time (see the module note)."""
    Bt, S, Di = x.shape
    ft = _work_dtype(x)
    xf, dtf, dyf = x.to(ft), dt.to(ft), dy.to(ft)
    Af, Bf, Cf, Df = A.to(ft), B.to(ft), C.to(ft), D.to(ft)
    N = A.shape[1]
    starts = list(range(0, S, BWD_CHUNK))
    # forward: the state entering each chunk
    h0s, h = [], torch.zeros((Bt, Di, N), dtype=ft, device=x.device)
    for s0 in starts:
        sl = slice(s0, s0 + BWD_CHUNK)
        h0s.append(h)
        h = _chunk_states(dtf[:, sl], xf[:, sl], Bf[:, sl], Af, h,
                          keep_a=False)[1][:, -1].clone()
    del h
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    carry = None                           # a_{t+1} g_{t+1} past the chunk
    for s0, h0 in zip(reversed(starts), reversed(h0s)):
        sl = slice(s0, s0 + BWD_CHUNK)
        dtc, xc, Bc, Cc, dyc = dtf[:, sl], xf[:, sl], Bf[:, sl], Cf[:, sl], dyf[:, sl]
        a, h = _chunk_states(dtc, xc, Bc, Af, h0)
        dC[:, sl] = torch.einsum("bldn,bld->bln", h, dyc)
        # h_{t-1} a_t, the factor of dA's and ddt's terms
        q = torch.cat([h0[:, None], h[:, :-1]], dim=1).mul_(a)
        del h
        # the adjoint, scanned backward in time with decay a_{t+1}
        e = dyc[..., None] * Cc[:, :, None, :]
        if carry is not None:
            e[:, -1] += carry
        ar = torch.empty_like(a)
        ar[:, :-1] = a[:, 1:]
        ar[:, -1] = 1.0
        g = _prefix_scan(ar, e, reverse=True)
        del ar
        carry = a[:, 0] * g[:, 0]
        del a
        gB = torch.einsum("bldn,bln->bld", g, Bc)
        dx[:, sl] = dtc * gB + Df * dyc
        dB[:, sl] = torch.einsum("bldn,bld->bln", g, dtc * xc)
        q.mul_(g)
        del g
        ddt[:, sl] = torch.einsum("bldn,dn->bld", q, Af) + xc * gB
        dA += torch.einsum("bldn,bld->dn", q, dtc)
        del q
    dD = torch.einsum("bsd,bsd->d", dyf, xf)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), dD.to(D.dtype))


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


def _forward(x, dt, A, B, C, D, return_state):
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B, C, D, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {x.device}")
    Bt, S, Di, N = _check(x, dt, A, B, C, D)
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


class SSMScan(torch.autograd.Function):
    """y (and, with ``return_state``, the final state, which takes no
    gradient) = the selective scan; the backward is ``ssm_scan_bwd``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, return_state):
        out = _forward(x, dt, A, B, C, D, return_state)
        ctx.save_for_backward(x, dt, A, B, C, D)
        if return_state:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, dy, *_):
        return (*ssm_scan_bwd(*ctx.saved_tensors, dy), None)


def ssm_scan(x, dt, A, B, C, D, *, chunk=256, return_state=False):
    """y [Bt, S, Di] in x's dtype, and with ``return_state`` the final
    state [Bt, Di, N] f32. ``chunk`` is the reference's time tile, accepted
    for its signature: it changes nothing here (the kernel stages its own
    tiles, the backward walks BWD_CHUNK steps at a time, and any S is
    allowed)."""
    if int(chunk) < 1:
        raise ValueError(f"ssm_scan: chunk must be positive, got {chunk}")
    _check(x, dt, A, B, C, D)
    return SSMScan.apply(x, dt, A, B, C, D, bool(return_state))


ssm_scan.launches = 0
