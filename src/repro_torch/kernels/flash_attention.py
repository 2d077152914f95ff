"""Flash attention on Hopper: the forward with the per-row LSE and its
backward, causal or sliding-window grouped-query attention, queries at
positions ``q_offset`` .. ``q_offset + Sq - 1`` (by default the last Sq).

* ``flash_attention_fwd`` — the forward wrapper, ``(out, lse)``. On CUDA
  tensors it launches the hand-written kernel ``csrc/flash_attention.cu``
  (built with nvcc for sm_90a, bound with ctypes) or raises; it takes the
  plain version only because its inputs lie on the CPU.
  ``flash_attention_fwd.launches`` counts kernel launches.
* ``flash_attention_bwd`` — the backward wrapper, ``(dq, dk, dv)`` from q,
  k, v, out, lse and dO: ``csrc/flash_attention_bwd.cu`` on CUDA tensors
  (or it raises), the plain version on CPU tensors.
  ``flash_attention_bwd.launches`` counts its launches (one per call).
* ``FlashAttention`` — the ``torch.autograd.Function`` joining them (the
  counterpart of the reference's ``flash_attention_pallas`` custom_vjp):
  its forward saves (q, k, v, out, lse), its backward is
  ``flash_attention_bwd``. ``flash_attention`` applies it, on both
  devices, and is the op the attention block calls (``kernels/ops.py``).
* ``flash_attention_plain`` — the forward in plain PyTorch: the twin of the
  reference's jnp lowering ``repro/kernels/ops.py:_flash_attention_jnp``
  (a scan of ``block_kv``-row blocks with -1e30 masking and an online
  softmax, the kv axis padded to a block multiple), plus the LSE the
  reference's Pallas kernel emits.
* ``flash_attention_bwd_plain`` — the backward in plain PyTorch, by the
  Pallas kernels' formulas (not autograd of the forward): delta =
  rowsum(dO * O), p = exp(s - lse) (masked entries exactly 0), ds =
  p (dP - delta), dq = ds K scale, dk = ds^T (q scale), dv = p^T dO, dk and
  dv summed over each kv head's G query heads in f32 and rounded once.
* ``mm_dtype`` (bf16 under the ``attn_bf16`` knob): the plain versions
  round the products' inputs as the jnp lowering does; on the card
  ``flash_attention`` sends q, k and v to the kernels' bf16 route.

Shapes: q [B, Sq, H, hd], k and v [B, Skv, KV, hd], Sq <= Skv, H a multiple
of KV (query head h reads kv head h // G, G = H / KV); out and dO like q;
lse f32 [B * KV, G, Sq] = m + log(max(l, 1e-30)), the layout of the
reference's ``flash_attention_fwd_pallas``.

``q_offset`` is the absolute position of query row 0, in [0, Skv - Sq];
``None`` is Skv - Sq, the reference's implicit placement (its kernels
take no offset). A sequence-sharded query block (``seq_shard_attn``: rank
r holds rows [r S / m, (r + 1) S / m) against the whole k and v) passes
its own start; the rows it computes are those rows of the full-sequence
attention.

The kernels replace the TPU kernels ``repro/kernels/flash_attention.py:
flash_attention_fwd_pallas`` (``_kernel_fwd_lse`` over ``_kernel``) and
``flash_attention_bwd_pallas`` (``_kernel_dq``, ``_kernel_dkv``). Each
source has two routes, picked by the inputs' dtype: bf16 runs on the
tensor cores (wgmma tiles loaded by TMA, with P and dS split into bf16 hi
+ lo so that the reference's f32 parity bound holds), f32 on the CUDA
cores in f32. What bounds each route and what its design does about it is
noted at the top of its source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _offset(q_offset, Sq, Skv):
    """The query block's absolute start: ``q_offset``, or Skv - Sq for
    None; it must leave the block inside [0, Skv)."""
    off = Skv - Sq if q_offset is None else int(q_offset)
    if not 0 <= off <= Skv - Sq:
        raise ValueError(f"flash_attention: q_offset {q_offset} puts {Sq} "
                         f"queries outside {Skv} keys")
    return off


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


def _rounding(mm_dtype):
    """f32 -> f32 through ``mm_dtype`` (the identity for None or f32): the
    products' inputs of a ``mm_dtype`` matmul with f32 accumulation, held
    in f32 (products of bf16 values are exact in f32)."""
    if mm_dtype is None or mm_dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(mm_dtype).float()


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          block_kv=1024, mm_dtype=None, q_offset=None):
    """(out, lse) by the reference's blockwise online softmax. ``mm_dtype``
    (the ``attn_bf16`` knob's bf16) as the reference's jnp lowering takes
    it: q scaled in f32, then q, k and v rounded to it, and p rounded to it
    before PV; the products of those rounded values accumulate in f32, the
    softmax state stays f32 and out comes back in q's dtype."""
    B, Sq, H, hd, Skv, KV = _check_shapes(q, k, v)
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    block = min(block_kv, Skv)
    q_offset = _offset(q_offset, Sq, Skv)
    if Skv % block:                       # pad kv to a block multiple, mask the tail
        pad = block - Skv % block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n = k.shape[1]
    md = _rounding(mm_dtype)
    qf = md(q.float() * scale).reshape(B, Sq, KV, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, n, block):
        kc = md(k[:, start:start + block].float())
        vc = md(v[:, start:start + block].float())
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
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", md(p), vc)
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
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ll] * 6 + [i] * 9
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


def _kernel_dims(name, q, k, v):
    """``_check_shapes`` plus what both kernels take: a CUDA device, f32 or
    bf16, hd in HEAD_DIMS, B * H <= 65535 (the grid's y extent)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    B, Sq, H, hd, Skv, KV = _check_shapes(q, k, v)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"{name}: B * H = {B * H} exceeds 65535")
    return dev, (B, Sq, H, hd, Skv, KV)


def _check_mm(name, q, mm_dtype):
    """On the card the route follows q's dtype: ``mm_dtype`` must be None
    or that dtype (``flash_attention`` casts q, k and v for the knob)."""
    if mm_dtype is not None and mm_dtype != q.dtype:
        raise ValueError(f"{name}: mm_dtype {mm_dtype} on {q.dtype} inputs; "
                         "the kernel's route follows the inputs' dtype")


def flash_attention_fwd(q, k, v, *, causal=True, window=0, scale=None,
                        block_kv=1024, mm_dtype=None, q_offset=None):
    """(out [B, Sq, H, hd] like q, lse [B * KV, G, Sq] f32). ``block_kv``
    and ``mm_dtype`` are the plain version's; the kernel's tile is its
    own, and its route follows the inputs' dtype. ``q_offset``: see the
    module note (None: Skv - Sq, passed to the kernel explicitly)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_kv=block_kv,
                                     mm_dtype=mm_dtype, q_offset=q_offset)
    _check_mm("flash_attention", q, mm_dtype)
    dev, (B, Sq, H, hd, Skv, KV) = _kernel_dims("flash_attention", q, k, v)
    q_offset = _offset(q_offset, Sq, Skv)
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
            H, KV, hd, int(bool(causal)), int(window or 0), q_offset,
            float(scale), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _visible(Sq, Skv, causal, window, device, q_offset=None):
    """[Sq, Skv] bool: key j visible to query i (at position q_offset + i,
    Skv - Sq + i for None)."""
    q_pos = (_offset(q_offset, Sq, Skv)
             + torch.arange(Sq, device=device)[:, None])
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal=True,
                              window=0, scale=None, mm_dtype=None,
                              q_offset=None):
    """(dq, dk, dv) like (q, k, v), by the reference's backward formulas in
    f32 over whole [Sq, Skv] score matrices. ``mm_dtype``: the forward's
    rounded inputs (q scale, k, v) and p before dV, and dq, dk, dv rounded
    to it, as a gradient of a ``mm_dtype`` operand is."""
    B, Sq, H, hd, Skv, KV = _check_shapes(q, k, v)
    G = H // KV
    if scale is None:
        scale = hd ** -0.5
    md = _rounding(mm_dtype)
    qf = md(q.float() * scale).reshape(B, Sq, KV, G, hd)
    kf, vf = md(k.float()), md(v.float())
    dof = do.float().reshape(B, Sq, KV, G, hd)
    delta = torch.sum(dof * out.float().reshape(B, Sq, KV, G, hd), dim=-1)
    delta = delta.permute(0, 2, 3, 1)                        # [B, KV, G, Sq]
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf)
    mask = _visible(Sq, Skv, causal, window, q.device, q_offset)
    lse = lse.reshape(B, KV, G, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = md(torch.einsum("bkgqs,bskh->bqkgh", ds, kf)) * scale
    dk = md(torch.einsum("bkgqs,bqkgh->bskh", ds, qf))
    dv = md(torch.einsum("bkgqs,bqkgh->bskh", md(p), dof))
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bind_bwd():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([vp] * 10 + [ll] * 10 + [i] * 9
                       + [ctypes.c_float, i, vp])
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=0,
                        scale=None, mm_dtype=None, q_offset=None):
    """(dq [B, Sq, H, hd] like q, dk and dv [B, Skv, KV, hd] like k) from
    the forward's inputs, its out and lse, and dO (made contiguous here).
    ``mm_dtype`` and ``q_offset`` as ``flash_attention_fwd``'s; a key no
    query row sees gets dk = dv = 0."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                         window=window, scale=scale,
                                         mm_dtype=mm_dtype, q_offset=q_offset)
    _check_mm("flash_attention_bwd", q, mm_dtype)
    dev, (B, Sq, H, hd, Skv, KV) = _kernel_dims("flash_attention_bwd", q, k, v)
    q_offset = _offset(q_offset, Sq, Skv)
    if tuple(out.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and dO "
                         f"{tuple(do.shape)} must be shaped like q "
                         f"{tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.device != dev
            or tuple(lse.shape) != (B * KV, H // KV, Sq)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous f32 "
                         f"[{B * KV}, {H // KV}, {Sq}] tensor on {dev}")
    if scale is None:
        scale = hd ** -0.5
    do = do.contiguous()
    q_sb, q_ss = check_rows("flash_attention_bwd: q", q, q.dtype, dev)
    k_sb, k_ss = check_rows("flash_attention_bwd: k", k, q.dtype, dev)
    v_sb, v_ss = check_rows("flash_attention_bwd: v", v, q.dtype, dev)
    o_sb, o_ss = check_rows("flash_attention_bwd: out", out, q.dtype, dev)
    d_sb, d_ss = check_rows("flash_attention_bwd: dO", do, q.dtype, dev)
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Skv, KV, hd), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Skv, KV, hd), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B * KV, H // KV, Sq), dtype=torch.float32, device=dev)
    lib = _bind_bwd()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
            o_sb, o_ss, d_sb, d_ss, B, Sq, Skv, H, KV, hd, int(bool(causal)),
            int(window or 0), q_offset, float(scale), _DTYPE_CODE[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd kernel launch failed: "
                           + lib.flash_attention_bwd_error_string(err).decode())
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward ``flash_attention_fwd``
    (saving q, k, v, out and the LSE), backward ``flash_attention_bwd``.
    The same Function runs on both devices: the kernels on the card, the
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_kv, mm_dtype=None,
                q_offset=None):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       scale=scale, block_kv=block_kv,
                                       mm_dtype=mm_dtype, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale,
                        mm_dtype=mm_dtype, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    block_kv=1024, mm_dtype=None, q_offset=None):
    """Attention output only, [B, Sq, H, hd] like q; differentiable in q, k
    and v through ``FlashAttention``. ``q_offset``: the absolute position
    of query row 0 (None: Skv - Sq).

    ``mm_dtype`` (bf16 under ``cfg.attn_bf16``): on the CPU the plain
    versions round as the reference's jnp lowering does. On the card q, k
    and v are cast to it and run the kernels' bf16 route (bf16 tensor-core
    products with P and dS split hi + lo, f32 softmax state), the output
    cast back to q's dtype; the backward (K6's bf16 route) follows through
    autograd of the casts. Where that differs from the reference: the
    kernel rounds q, not q * scale (the same for hd 64, whose scale is a
    power of 2), keeps P nearly to f32 where the reference rounds it to
    bf16, and rounds its output to bf16 where the reference returns its
    f32 sum. Under bf16 compute the knob changes nothing on the card."""
    if mm_dtype is not None and q.device.type != "cpu" and q.dtype != mm_dtype:
        out = FlashAttention.apply(q.to(mm_dtype), k.to(mm_dtype),
                                   v.to(mm_dtype), causal, window, scale,
                                   block_kv, None, q_offset)
        return out.to(q.dtype)
    return FlashAttention.apply(q, k, v, causal, window, scale, block_kv,
                                mm_dtype, q_offset)
