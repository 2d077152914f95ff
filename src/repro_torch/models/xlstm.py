"""xLSTM blocks: the mLSTM (matrix memory, chunkwise-parallel) and the
sLSTM (scalar memory, sequential), arXiv:2405.04517.

Counterpart of ``repro/models/xlstm.py``, with the same names, layouts and
numerics. The reference writes no kernel for either block, so this is
plain torch throughout. The mLSTM's train / prefill path is the chunkwise
stabilised form: within a chunk of ``cfg.ssm_chunk`` steps a [c, c]
matrix of log weights, across chunks the [hd, hd] state, carried by a
Python loop over the chunks where the reference scans. The exponential
gates are stabilised with a running log-max ``m``; the forget gate is a
log-sigmoid. The sLSTM has a true recurrence (through h_{t-1} and the
R matrices): a host loop over the S steps, a few small launches each.
Gates, states and their products run in f32 wherever the reference's do.

Decode caches: the mLSTM's ``{"conv": [B, K-1, di] in the compute dtype,
"C": [B, H, hd, hd], "n": [B, H, hd], "m": [B, H]}`` and the sLSTM's
``{"conv": [B, K-1, d], "h", "c", "n", "m": [B, d]}``, the states f32.
Unlike the reference (a new cache per step), decode writes the new conv
tail and states into the cache it is given, in place, as the Mamba block
does. Prefill keeps the last K-1 inputs of the zero-padded conv input as
the conv tail, so a prompt shorter than K-1 leaves a tail of the right
length (zeros first); the reference keeps ``x[:, S - (K - 1):]``, too few
rows there (ROADMAP Queue C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.ssm import _causal_conv
from repro_torch.utils import fold_in_name

NEG_INF = -1e30


# ===================================================================== mLSTM
def init_mlstm(key, cfg):
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    H = cfg.num_heads
    K = cfg.ssm_conv_dim
    dev = key.device
    ks = {n: fold_in_name(key, n) for n in ("up", "q", "k", "v", "if", "down", "conv")}
    return {
        "w_up": dense_init(ks["up"], (d, 2 * di), cfg.pdtype),
        "conv_w": dense_init(ks["conv"], (K, di), cfg.pdtype, scale=K ** -0.5),
        "conv_b": torch.zeros((di,), dtype=cfg.pdtype, device=dev),
        "wq": dense_init(ks["q"], (di, di), cfg.pdtype),
        "wk": dense_init(ks["k"], (di, di), cfg.pdtype),
        "wv": dense_init(ks["v"], (di, di), cfg.pdtype),
        "w_if": dense_init(ks["if"], (di, 2 * H), torch.float32),
        "b_if": torch.zeros((2 * H,), dtype=torch.float32, device=dev),
        "gn_scale": torch.ones((di,), dtype=cfg.pdtype, device=dev),
        "w_down": dense_init(ks["down"], (di, d), cfg.pdtype),
    }


def _qkv_gates(p, xc, xv, H):
    """The projections of one step or a sequence: xc (after conv + silu)
    gives q, k (scaled by hd^-1/2) and the f32 log gates, xv gives v.
    xc, xv: [..., di] -> q, k, v [..., H, hd]; li, lf [..., H] f32."""
    cd = xc.dtype
    hd = xc.shape[-1] // H
    lead = xc.shape[:-1]
    q = (xc @ p["wq"].to(cd)).reshape(lead + (H, hd))
    k = (xc @ p["wk"].to(cd)).reshape(lead + (H, hd)) * hd ** -0.5
    v = (xv @ p["wv"].to(cd)).reshape(lead + (H, hd))
    gates = xc.float() @ p["w_if"] + p["b_if"]                         # [..., 2H]
    return q, k, v, gates[..., :H], F.logsigmoid(gates[..., H:])


def _mlstm_qkv_gates(p, xi, cfg):
    """xi: [B, S, di] -> (q, k, v [B, S, H, hd], li, lf [B, S, H] f32 log
    gates, the zero-padded conv input [B, S + K - 1, di])."""
    cd = cfg.cdtype
    conv, pad = _causal_conv(xi, p["conv_w"].to(cd), p["conv_b"].to(cd),
                             cfg.ssm_conv_dim)
    return _qkv_gates(p, F.silu(conv), xi, cfg.num_heads) + (pad,)


def _group_norm(h, scale, H):
    """Per-head normalisation of h: [B, S, H, hd] -> [B, S, H * hd], in
    f32, h's dtype out."""
    B, S, Hh, hd = h.shape
    hf = h.float()
    mu = torch.mean(hf, dim=-1, keepdim=True)
    var = torch.var(hf, dim=-1, keepdim=True, unbiased=False)
    y = (hf - mu) * torch.rsqrt(var + 1e-6)
    return (y.reshape(B, S, Hh * hd) * scale.float()).to(h.dtype)


def mlstm_chunked(q, k, v, li, lf, state=None, chunk=256):
    """Chunkwise stabilised mLSTM.

    q / k / v: [B, S, H, hd]; li / lf: [B, S, H].
    state: (C [B, H, hd, hd], n [B, H, hd], m [B, H]) or None.
    Returns (h [B, S, H, hd] in q's dtype, state'), the state f32.
    S % chunk is padded with identity steps (li = -inf: no input; lf = 0:
    no decay), which leave the state as it was."""
    B, S, H, hd = q.shape
    S0 = S
    chunk = min(chunk, S)
    if S % chunk:
        pad = chunk - S % chunk
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG_INF)
        lf = F.pad(lf, (0, 0, 0, pad), value=0.0)
        S += pad
    nch = S // chunk

    def resh(x):
        return x.reshape((B, nch, chunk) + tuple(x.shape[2:]))
    qc, kc, vc = (resh(t.float()) for t in (q, k, v))               # [B, n, c, H, hd]
    lic, lfc = resh(li.float()), resh(lf.float())                   # [B, n, c, H]

    dev = q.device
    if state is None:
        Cp = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
        np_ = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
        mp = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    else:
        Cp, np_, mp = state
    above = ~torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))

    hs = []
    # unbind, not one select a chunk: in a backward, unbind joins the
    # chunks' gradients in one stack, where each select would add a
    # zero-filled full-size gradient
    for qb, kb, vb, lib, lfb in zip(*(t.unbind(1) for t in (qc, kc, vc, lic, lfc))):
        Fc = torch.cumsum(lfb, dim=1)                         # [B, c, H], inclusive
        # in-chunk log weights: w[t, s] = F_t - F_s + li_s (s <= t)
        logw = Fc[:, :, None] - Fc[:, None, :] + lib[:, None, :]     # [B, t, s, H]
        logw = logw.masked_fill(above[None, :, :, None], NEG_INF)
        carry_log = Fc + mp[:, None]                                 # [B, c, H]
        m_t = torch.maximum(torch.amax(logw, dim=2), carry_log)      # [B, c, H]
        w_in = torch.exp(logw - m_t[:, :, None])                     # [B, t, s, H]
        w_carry = torch.exp(carry_log - m_t)                         # [B, c, H]

        qk = torch.einsum("bthd,bshd->btsh", qb, kb)                 # [B, t, s, H]
        num_in = torch.einsum("btsh,bshd->bthd", w_in * qk, vb)
        num_carry = torch.einsum("bthd,bhde->bthe", qb, Cp) * w_carry[..., None]
        den_in = torch.einsum("btsh,btsh->bth", w_in, qk)
        den_carry = torch.einsum("bthd,bhd->bth", qb, np_) * w_carry
        num = num_in + num_carry
        den = den_in + den_carry
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])

        # ---- the state at the end of the chunk --------------------------
        Fe = Fc[:, -1]                                               # [B, H]
        src_log = Fe[:, None] - Fc + lib                             # [B, c, H]
        m_out = torch.maximum(mp + Fe, torch.amax(src_log, dim=1))
        w_src = torch.exp(src_log - m_out[:, None])                  # [B, c, H]
        w_old = torch.exp(mp + Fe - m_out)                           # [B, H]
        Cp = (Cp * w_old[..., None, None]
              + torch.einsum("bshd,bshe->bhde", w_src[..., None] * kb, vb))
        np_ = np_ * w_old[..., None] + torch.einsum("bsh,bshd->bhd", w_src, kb)
        mp = m_out
    h = torch.cat(hs, dim=1)[:, :S0]
    return h.to(q.dtype), (Cp, np_, mp)


def mlstm_step(q, k, v, li, lf, state):
    """One decode step. q / k / v: [B, H, hd]; li / lf: [B, H]. Returns
    (h [B, H, hd] in q's dtype, the f32 state')."""
    Cp, np_, mp = state
    qf, kf, vf = q.float(), k.float(), v.float()
    m_new = torch.maximum(lf + mp, li)
    fw = torch.exp(lf + mp - m_new)
    iw = torch.exp(li - m_new)
    C = (Cp * fw[..., None, None]
         + iw[..., None, None] * kf[..., :, None] * vf[..., None, :])
    n = np_ * fw[..., None] + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.einsum("bhd,bhd->bh", qf, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C, n, m_new)


def _conv_step(p, cache, x, cd):
    """One step of the depthwise causal conv over the cached tail: returns
    (silu(conv) [B, D], the window [B, K, D])."""
    window = torch.cat([cache["conv"], x.to(cd)], dim=1)             # [B, K, D]
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"].to(cd))
    return F.silu(xc + p["conv_b"].to(cd)), window


def mlstm_block(p, x, cfg, *, mode, cache=None):
    """x: [B, S, d]. cache (decode, updated in place): {"conv": [B, K-1,
    di], "C", "n", "m"}. Returns (out [B, S, d], new_cache)."""
    B, S, d = x.shape
    H = cfg.num_heads
    cd = cfg.cdtype
    u = x @ p["w_up"].to(cd)
    xi, z = torch.chunk(u, 2, dim=-1)

    if mode in ("train", "prefill"):
        q, k, v, li, lf, pad = _mlstm_qkv_gates(p, xi, cfg)
        h, state = mlstm_chunked(q, k, v, li, lf, chunk=cfg.ssm_chunk)
        new_cache = None
        if mode == "prefill":                          # conv: the last K-1 inputs
            new_cache = {"conv": pad[:, S:], "C": state[0], "n": state[1],
                         "m": state[2]}
    elif mode == "decode":                                           # S == 1
        xc, window = _conv_step(p, cache, xi, cd)
        q, k, v, li, lf = _qkv_gates(p, xc, xi[:, 0], H)
        h, state = mlstm_step(q, k, v, li, lf,
                              (cache["C"], cache["n"], cache["m"]))
        h = h[:, None]                                               # [B, 1, H, hd]
        cache["conv"].copy_(window[:, 1:])
        for name, t in zip(("C", "n", "m"), state):
            cache[name].copy_(t)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = _group_norm(h, p["gn_scale"], H) * F.silu(z)
    return y @ p["w_down"].to(cd), new_cache


# ===================================================================== sLSTM
def init_slstm(key, cfg):
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    dff = int(cfg.slstm_proj_factor * d)
    K = cfg.ssm_conv_dim
    dev = key.device
    ks = {n: fold_in_name(key, n) for n in ("w", "r", "conv", "up", "down")}
    return {
        "conv_w": dense_init(ks["conv"], (K, d), cfg.pdtype, scale=K ** -0.5),
        "conv_b": torch.zeros((d,), dtype=cfg.pdtype, device=dev),
        "w_gates": dense_init(ks["w"], (d, 4 * d), torch.float32),
        "b_gates": torch.zeros((4 * d,), dtype=torch.float32, device=dev),
        "r_gates": dense_init(ks["r"], (H, hd, 4 * hd), torch.float32,
                              scale=hd ** -0.5),
        "gn_scale": torch.ones((d,), dtype=cfg.pdtype, device=dev),
        "w_up": dense_init(ks["up"], (d, 2 * dff), cfg.pdtype),
        "w_down": dense_init(ks["down"], (dff, d), cfg.pdtype),
    }


def _slstm_cell(p, gx, state, H, hd):
    """One sLSTM step. gx: [B, 4d] input-side gate pre-activations; state
    (h, c, n, m), each [B, d] f32. Returns the new state."""
    h, c, n, m = state
    B = h.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, hd),
                       p["r_gates"]).reshape(B, 4 * H * hd)
    li_raw, f_raw, z_raw, o_raw = torch.chunk(gx + rec, 4, dim=-1)
    lfm = F.logsigmoid(f_raw) + m
    m_new = torch.maximum(lfm, li_raw)
    i_ = torch.exp(li_raw - m_new)
    f_ = torch.exp(lfm - m_new)
    z = torch.tanh(z_raw)
    o = torch.sigmoid(o_raw)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new)


def slstm_block(p, x, cfg, *, mode, cache=None):
    """x: [B, S, d]. cache (decode, updated in place): {"conv": [B, K-1,
    d], "h", "c", "n", "m"}. Returns (out [B, S, d], new_cache)."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    K = cfg.ssm_conv_dim
    cd = cfg.cdtype

    if mode in ("train", "prefill"):
        conv, pad = _causal_conv(x.to(cd), p["conv_w"].to(cd), p["conv_b"].to(cd), K)
        gx = F.silu(conv).float() @ p["w_gates"] + p["b_gates"]     # [B, S, 4d]
        z0 = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        state = (z0, z0, z0, torch.full((B, d), NEG_INF, dtype=torch.float32,
                                        device=x.device))
        hs = []
        for gxt in gx.unbind(1):          # the recurrence (unbind: see mlstm_chunked)
            state = _slstm_cell(p, gxt, state, H, hd)
            hs.append(state[0])
        h = torch.stack(hs, dim=1)                                   # [B, S, d]
        new_cache = None
        if mode == "prefill":                          # conv: the last K-1 inputs
            new_cache = {"conv": pad[:, S:], "h": state[0], "c": state[1],
                         "n": state[2], "m": state[3]}
    elif mode == "decode":
        xc, window = _conv_step(p, cache, x, cd)
        gx = xc.float() @ p["w_gates"] + p["b_gates"]
        state = _slstm_cell(p, gx, (cache["h"], cache["c"], cache["n"], cache["m"]),
                            H, hd)
        h = state[0][:, None]
        cache["conv"].copy_(window[:, 1:])
        for name, t in zip(("h", "c", "n", "m"), state):
            cache[name].copy_(t)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = _group_norm(h.reshape(B, -1, H, hd), p["gn_scale"], H).to(cd)
    a, b = torch.chunk(y @ p["w_up"].to(cd), 2, dim=-1)
    return (F.silu(a) * b) @ p["w_down"].to(cd), new_cache
