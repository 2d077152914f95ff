"""Core LM layers: init, RMSNorm, LayerNorm, RoPE, the SwiGLU FFN and the
GELU MLP.

Counterpart of ``repro/models/layers.py``, with the same names, layouts
([d_in, d_out] weights, ``x @ w``) and numerics: compute runs in
``cfg.cdtype``, params live in ``cfg.pdtype``, norms and RoPE run in f32.
``rmsnorm`` goes through ``kernels/ops.py``, so on the card it is the
hand-written RMSNorm kernel; the matrix products are ``torch.matmul`` (the
reference leaves them to XLA), the chunked loss's vocabulary product too.
``layernorm`` and ``gelu_mlp_apply`` (the encoder-decoder's) are plain
torch: the reference has no kernel for either.

On a model axis (``tp``, a ``sharding/model_axis.py: ModelAxis``) the FFN
and the loss run on the rank's shards: ``swiglu_apply`` on the local
``w_gate`` / ``w_up`` columns and ``w_down`` rows, its partial product
all-reduced; ``chunked_softmax_xent`` on the local vocab rows of the
embedding (or columns of ``lm_head``), vocab-parallel. ``rmsnorm`` runs on
the replicated rows on every rank, unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import ops as kops
from repro_torch.sharding.model_axis import vocab_xent
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


def init_layernorm(d, dtype, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32 with the
    population variance (jnp.var's), x's dtype out."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


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


def swiglu_apply(p, x, cdtype, tp=None):
    """``(silu(x w_gate) * x w_up) w_down``; on a model axis the local
    columns and rows, then the group's all-reduce."""
    if tp is not None:
        x = tp.copy(x)
    g = x @ p["w_gate"].to(cdtype)
    u = x @ p["w_up"].to(cdtype)
    y = (F.silu(g) * u) @ p["w_down"].to(cdtype)
    return y if tp is None else tp.reduce(y)


def init_gelu_mlp(key, d_model, d_ff, dtype):
    ks = {n: fold_in_name(key, n) for n in ("up", "down")}
    dev = key.device
    return {
        "w_up": dense_init(ks["up"], (d_model, d_ff), dtype),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_down": dense_init(ks["down"], (d_ff, d_model), dtype),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=dev),
    }


def gelu_mlp_apply(p, x, cdtype):
    """``gelu(x w_up + b_up) w_down + b_down`` in ``cdtype``, the biases
    added in it. GELU is the tanh approximation: ``jax.nn.gelu``'s default
    (approximate=True), not torch's default erf form."""
    h = F.gelu(x @ p["w_up"].to(cdtype) + p["b_up"].to(cdtype), approximate="tanh")
    return h @ p["w_down"].to(cdtype) + p["b_down"].to(cdtype)


# ------------------------------------------------------------------ chunked loss
def chunked_softmax_xent(hidden, w_embed, labels, mask, chunk: int, tp=None):
    """Cross-entropy without materializing [B, S, V] logits at once.

    hidden: [B, S, d] (compute dtype); w_embed: [V, d]; labels / mask:
    [B, S]. S is padded to a chunk multiple (padded rows carry mask 0); per
    chunk the logits [B, chunk, V] are ``hc @ w.T`` in the compute dtype,
    then f32: logsumexp minus the gold logit, times the mask. Returns
    (sum_loss, sum_mask) as f32 scalars; a loop where the reference scans.

    On a model axis ``w_embed`` holds the rank's V / m vocab rows (from
    rank * V / m) and each chunk's loss is ``model_axis.vocab_xent`` of
    its local logits.
    """
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    labels = torch.as_tensor(labels, device=hidden.device).long()
    mask = torch.as_tensor(mask, device=hidden.device).float()
    if S % chunk:
        pad = chunk - S % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    wt = w_embed.T.to(hidden.dtype)
    if tp is not None:
        hidden = tp.copy(hidden)
        v0 = tp.rank * w_embed.shape[0]
    s_loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    s_cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, S, chunk):
        hc = hidden[:, start:start + chunk]
        yc = labels[:, start:start + chunk]
        mc = mask[:, start:start + chunk]
        logits = (hc @ wt).float()                                 # [B, c, V]
        if tp is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, yc[..., None])[..., 0]
            nll = logz - gold
        else:
            nll = vocab_xent(tp, logits, yc, v0)
        s_loss = s_loss + torch.sum(nll * mc)
        s_cnt = s_cnt + torch.sum(mc)
    return s_loss, s_cnt
