"""Core LM layers: init, RMSNorm, RoPE and the SwiGLU FFN.

Counterpart of ``repro/models/layers.py``, with the same names, layouts
([d_in, d_out] weights, ``x @ w``) and numerics: compute runs in
``cfg.cdtype``, params live in ``cfg.pdtype``, norms and RoPE run in f32.
``rmsnorm`` goes through ``kernels/ops.py``, so on the card it is the
hand-written RMSNorm kernel; the matrix products are ``torch.matmul`` (the
reference leaves them to XLA). ``chunked_softmax_xent`` waits for the
training slice (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import ops as kops
from repro_torch.utils import fold_in_name


# --------------------------------------------------------------------------- init
def dense_init(key, shape, dtype, scale: float | None = None):
    """Truncated-normal fan-in init, drawn on the key's device."""
    fan_in = shape[0] if len(shape) > 1 else 1
    if scale is None:
        scale = fan_in ** -0.5
    return (prng.truncated_normal(key, -2.0, 2.0, shape) * scale).to(dtype)


def embed_init(key, shape, dtype):
    return (prng.truncated_normal(key, -2.0, 2.0, shape) * 0.02).to(dtype)


# --------------------------------------------------------------------------- norm
def init_rmsnorm(d, dtype, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale``, f32 inside, x's dtype out."""
    return kops.rmsnorm(x, p["scale"], eps=eps)


# --------------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device="cpu"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [S] (or [..., S]) integers."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                        # [hd/2]
    angles = positions[..., :, None].to(torch.float32) * freqs      # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]                        # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- ffn
def init_swiglu(key, d_model, d_ff, dtype):
    ks = {n: fold_in_name(key, n) for n in ("gate", "up", "down")}
    return {
        "w_gate": dense_init(ks["gate"], (d_model, d_ff), dtype),
        "w_up": dense_init(ks["up"], (d_model, d_ff), dtype),
        "w_down": dense_init(ks["down"], (d_ff, d_model), dtype),
    }


def swiglu_apply(p, x, cdtype):
    g = x @ p["w_gate"].to(cdtype)
    u = x @ p["w_up"].to(cdtype)
    return (F.silu(g) * u) @ p["w_down"].to(cdtype)
