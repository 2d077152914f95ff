"""Mamba (S6) selective-state-space mixer: init, and the train / prefill /
decode paths with their (conv tail, ssm state) cache.

Counterpart of ``repro/models/ssm.py``, with the same names, layouts and
numerics. Train and prefill run the whole sequence through
``kops.ssm_scan`` (on the card the selective-scan kernel); prefill takes
the final state from the same call (the kernel writes it as it ends),
where the reference runs ``_final_state``, a second sequential pass.
Decode is one recurrent step, ``kops.ssm_step``, in plain torch.

The decode cache is ``{"conv": [B, K-1, di] in the compute dtype, "h":
[B, di, N] f32}``. Unlike the reference (functional, a new cache per
step), decode writes the new conv tail and state into the cache it is
given, in place, as the attention block writes its k / v row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init
from repro_torch.utils import fold_in_name


def init_mamba(key, cfg):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    K, dtr = cfg.ssm_conv_dim, cfg.ssm_dt_rank
    dev = key.device
    ks = {n: fold_in_name(key, n) for n in ("in", "conv", "xproj", "dtproj", "out")}
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(di, N)
    dt_bias = torch.log(torch.expm1(torch.full((di,), 0.01, dtype=torch.float32,
                                               device=dev)))
    return {
        "w_in": dense_init(ks["in"], (d, 2 * di), cfg.pdtype),
        "conv_w": dense_init(ks["conv"], (K, di), cfg.pdtype, scale=K ** -0.5),
        "conv_b": torch.zeros((di,), dtype=cfg.pdtype, device=dev),
        "w_xproj": dense_init(ks["xproj"], (di, dtr + 2 * N), cfg.pdtype),
        "w_dtproj": dense_init(ks["dtproj"], (dtr, di), cfg.pdtype, scale=dtr ** -0.5),
        "dt_bias": dt_bias.to(cfg.pdtype),
        "A_log": torch.log(A).contiguous(),                    # f32 whatever pdtype
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": dense_init(ks["out"], (di, d), cfg.pdtype),
    }


def _causal_conv(xi, w, b, K):
    """Depthwise causal conv, the sum of K shifted products (no cuDNN).
    xi: [B, S, di]; w: [K, di]. Returns (y, the zero-padded input)."""
    S = xi.shape[1]
    pad = F.pad(xi, (0, 0, K - 1, 0))
    y = sum(pad[:, j:j + S] * w[j] for j in range(K))
    return y + b, pad


def _ssm_inputs(p, xi, cfg):
    """xi: [B, S, di] (after conv + silu) -> (dt, Bm, Cm), f32 and
    contiguous (the scan kernel's operands)."""
    N, dtr = cfg.ssm_state_dim, cfg.ssm_dt_rank
    proj = xi @ p["w_xproj"].to(xi.dtype)                        # [B, S, dtr + 2N]
    dt_r, Bm, Cm = torch.split(proj, [dtr, N, N], dim=-1)
    dt = F.softplus(dt_r.float() @ p["w_dtproj"].float() + p["dt_bias"].float())
    return dt, Bm.float().contiguous(), Cm.float().contiguous()


def mamba_block(p, x, cfg, *, mode, cache=None):
    """x: [B, S, d]. cache (decode, updated in place): {"conv": [B, K-1,
    di], "h": [B, di, N]}. Returns (out [B, S, d], new_cache)."""
    K = cfg.ssm_conv_dim
    cd = cfg.cdtype
    u = x @ p["w_in"].to(cd)                                     # [B, S, 2di]
    xi, z = torch.chunk(u, 2, dim=-1)
    A = -torch.exp(p["A_log"])

    if mode in ("train", "prefill"):
        conv, pad = _causal_conv(xi, p["conv_w"].to(cd), p["conv_b"].to(cd), K)
        xc = F.silu(conv)
        dt, Bm, Cm = _ssm_inputs(p, xc, cfg)
        new_cache = None
        if mode == "prefill":
            y, h = kops.ssm_scan(xc, dt, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk,
                                 return_state=True)
            new_cache = {"conv": pad[:, xi.shape[1]:], "h": h}   # the last K-1 inputs
        else:
            y = kops.ssm_scan(xc, dt, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk)
    elif mode == "decode":                                       # S == 1
        window = torch.cat([cache["conv"], xi], dim=1)           # [B, K, di]
        xc = torch.einsum("bkd,kd->bd", window, p["conv_w"].to(cd))
        xc = F.silu(xc + p["conv_b"].to(cd))[:, None]            # [B, 1, di]
        dt, Bm, Cm = _ssm_inputs(p, xc, cfg)
        h, y1 = kops.ssm_step(cache["h"], xc[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = (y1 + xc[:, 0].float() * p["D"][None]).to(cd)[:, None]
        cache["conv"].copy_(window[:, 1:])
        cache["h"].copy_(h)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = y.to(cd) * F.silu(z)
    return y @ p["w_out"].to(cd), new_cache
