"""Attention: grouped-query attention (GQA) and multi-head latent
attention (MLA), each with its train / prefill / decode paths and cache,
and the encoder-decoder's cross-attention.

Counterpart of ``repro/models/attention.py``. Train and prefill go
through ``kops.flash_attention``, the ``FlashAttention`` autograd Function
(on the card the flash-attention forward kernel, and its backward kernel
when a gradient flows; no graph is built when nothing requires grad), GQA
decode through ``kops.decode_attention`` (the decode-attention kernel).
Layouts are the reference's: q [B, S, H, hd], k / v [B, S, KV, hd], cache
k / v [B, W, KV, hd]; MLA's cache c_kv [B, W, kv_lora_rank], k_rope
[B, W, qk_rope_head_dim].

Under a sliding window the cache is a ring: absolute position p lives at
slot p % W. Prefill keeps the last W positions rolled by S % W, decode
writes slot pos % W and attends over min(pos + 1, W) rows.

Unlike the reference (functional, a new cache per step), decode writes the
new k / v row (MLA: the new latent row) into the cache it is given, in
place, and returns that same cache: a copy of every layer's cache per
token would move more bytes than the attention itself.

On a model axis (``tp``, a ``sharding/model_axis.py: ModelAxis``; training
only) ``gqa_attention_block`` runs on the rank's shards of ``wq`` / ``wk``
/ ``wv`` (columns) and ``wo`` (rows), the reference's
``attention.py:60-90`` under GSPMD:

* heads layout: K5 / K6 on the rank's H / m query heads and their kv
  heads. Where the spec splits ``wk`` / ``wv`` inside a kv head (KV % m,
  e.g. the smoke qwen2.5 at model 4), k and v are all-gathered whole
  first and the rank takes the kv heads its query heads read;
* ``cfg.seq_shard_attn``: q goes to the sequence layout (rank r holds rows
  [r S / m, (r + 1) S / m) of every head, an all-to-all), k and v are
  gathered whole, and K5 / K6 run with ``q_offset = r S / m``; the output
  comes back to ``wo``'s row layout by the inverse all-to-all. The
  backward's partial dk / dv are summed over the group (the copy after
  the gather). On one rank the knob is the identity, as the reference's
  sharding constraint is.

Either way ``wo``'s partial product is all-reduced (``tp.reduce``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense_init, init_rmsnorm, rmsnorm
from repro_torch.sharding.model_axis import kv_whole
from repro_torch.utils import fold_in_name


def init_gqa(key, cfg):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = {n: fold_in_name(key, n) for n in ("wq", "wk", "wv", "wo")}
    p = {
        "wq": dense_init(ks["wq"], (d, H * hd), cfg.pdtype),
        "wk": dense_init(ks["wk"], (d, KV * hd), cfg.pdtype),
        "wv": dense_init(ks["wv"], (d, KV * hd), cfg.pdtype),
        "wo": dense_init(ks["wo"], (H * hd, d), cfg.pdtype),
    }
    if cfg.qkv_bias:
        dev = key.device
        p["bq"] = torch.zeros((H * hd,), dtype=cfg.pdtype, device=dev)
        p["bk"] = torch.zeros((KV * hd,), dtype=cfg.pdtype, device=dev)
        p["bv"] = torch.zeros((KV * hd,), dtype=cfg.pdtype, device=dev)
    return p


def gqa_project(p, x, cfg):
    """x: [B,S,d] -> q [B,S,H,hd], k,v [B,S,KV,hd] (un-roped)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cd = cfg.cdtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if "bq" in p:
        q, k, v = q + p["bq"].to(cd), k + p["bk"].to(cd), v + p["bv"].to(cd)
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _decode_slot(pos, W, window):
    """The cache row a decode step at host-int ``pos`` writes."""
    if pos is None:
        raise ValueError("decode needs the position as a host int (pos=)")
    slot = pos % W if window else pos
    if not 0 <= slot < W:
        raise ValueError(f"decode position {pos} outside a cache of {W} "
                         "rows (pad_caches grows it)")
    return slot


def _gqa_model_axis(p, x, cfg, positions, tp):
    """The train-mode GQA block on this rank's shards (see the module
    note) -> the replicated [B, S, d] output."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    m, r = tp.size, tp.rank
    cd = cfg.cdtype
    xf = tp.copy(x)

    def project(w, b):
        t = xf @ p[w].to(cd)
        return t + p[b].to(cd) if b in p else t
    q, k, v = project("wq", "bq"), project("wk", "bk"), project("wv", "bv")
    if cfg.seq_shard_attn:
        q = tp.seq_from_heads(q)                        # [B, S/m, H hd]
        Hq, h0, Sq = H, 0, S // m
        q_pos, q_offset = positions[r * Sq:(r + 1) * Sq], r * Sq
    else:
        Hq, h0, Sq = H // m, r * (H // m), S
        q_pos, q_offset = positions, None
    q = q.reshape(B, Sq, Hq, hd)
    if kv_whole(cfg, m):
        # k and v whole on every rank (their columns split inside a kv head,
        # or every query row's keys); the copy sums the ranks' dk / dv
        kv = tp.copy(tp.gather_cols(torch.stack([k, v])))
        k, v = kv[0].reshape(B, S, KV, hd), kv[1].reshape(B, S, KV, hd)
        # the kv heads the local query heads read, each by as many of them
        G = H // KV
        want = [(h0 + j) // G for j in range(Hq)]
        lo, n = want[0], want[-1] - want[0] + 1
        if Hq % n or want != [lo + j // (Hq // n) for j in range(Hq)]:
            raise NotImplementedError("the model axis: local query heads that "
                                      "split a kv group unevenly (ROADMAP A17b)")
        k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    else:
        k = k.reshape(B, S, KV // m, hd)
        v = v.reshape(B, S, KV // m, hd)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(q, k, v, causal=cfg.causal,
                               window=cfg.sliding_window,
                               block_kv=cfg.attn_block_kv,
                               mm_dtype=torch.bfloat16 if cfg.attn_bf16 else None,
                               q_offset=q_offset)
    out = out.reshape(B, Sq, Hq * hd)
    if cfg.seq_shard_attn:
        out = tp.heads_from_seq(out)                    # [B, S, H hd / m]
    return tp.reduce(out @ p["wo"].to(cd))


def gqa_attention_block(p, x, cfg, *, positions, mode, cache=None,
                        pos: int | None = None, tp=None):
    """Full GQA block. mode: 'train' | 'prefill' | 'decode'.

    positions: [S] absolute positions (a tensor on x's device). In decode,
    ``pos`` is the same position as a host int (S == 1): it picks the cache
    slot and kv_len without reading the device. cache (prefill out, decode
    in-out): dict(k, v: [B, W, KV, hd], len). ``cfg.attn_bf16``: train
    and prefill attend with bf16 products (``kops.flash_attention``'s
    ``mm_dtype``); decode is unchanged, as in the reference. ``tp``: the
    model axis (train mode only; see the module note). Returns (out
    [B, S, d], new_cache)."""
    if tp is not None:
        if mode != "train":
            raise NotImplementedError(f"the model axis: {mode} (serving on "
                                      "local heads) is not ported yet "
                                      "(ROADMAP A17b)")
        return _gqa_model_axis(p, x, cfg, positions, tp), None
    B, S, _ = x.shape
    cd = cfg.cdtype
    q, k, v = gqa_project(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window

    if mode in ("train", "prefill"):
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                   block_kv=cfg.attn_block_kv,
                                   mm_dtype=torch.bfloat16 if cfg.attn_bf16 else None)
        new_cache = None
        if mode == "prefill":
            W = min(window, S) if window else S
            kc, vc = k[:, S - W:], v[:, S - W:]
            if window and S > window:
                # ring layout: absolute position p lives at slot p % W
                kc = torch.roll(kc, S % W, dims=1)
                vc = torch.roll(vc, S % W, dims=1)
            new_cache = {"k": kc, "v": vc, "len": min(W, S)}
    elif mode == "decode":
        W = cache["k"].shape[1]
        slot = _decode_slot(pos, W, window)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        kv_len = min(pos + 1, W)
        out = kops.decode_attention(q, cache["k"], cache["v"], kv_len=kv_len)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": kv_len}
    else:
        raise ValueError(f"unknown mode {mode!r}")

    B_, S_, H, hd = out.shape
    y = out.reshape(B_, S_, H * hd) @ p["wo"].to(cd)
    return y, new_cache


# ============================================================== MLA attention
def init_mla(key, cfg):
    d = cfg.d_model
    H = cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dev = key.device
    ks = {n: fold_in_name(key, n) for n in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")}
    return {
        "wq_a": dense_init(ks["wq_a"], (d, qr), cfg.pdtype),
        "q_norm": init_rmsnorm(qr, cfg.pdtype, dev),
        "wq_b": dense_init(ks["wq_b"], (qr, H * (nope + rope)), cfg.pdtype),
        "wkv_a": dense_init(ks["wkv_a"], (d, kvr + rope), cfg.pdtype),
        "kv_norm": init_rmsnorm(kvr, cfg.pdtype, dev),
        "wkv_b": dense_init(ks["wkv_b"], (kvr, H * (nope + vd)), cfg.pdtype),
        "wo": dense_init(ks["wo"], (H * vd, d), cfg.pdtype),
    }


def mla_attention_block(p, x, cfg, *, positions, mode, cache=None,
                        pos: int | None = None):
    """MLA (multi-head latent attention, the MiniCPM3 / DeepSeek-V2 form).
    Arguments and return as ``gqa_attention_block``; the cache is
    dict(c_kv [B, W, kv_lora_rank], k_rope [B, W, qk_rope_head_dim], len).

    Train and prefill expand the latents into full k and v and run flash
    attention at head dim nope + rope, v zero-padded to it and the output
    sliced back to v_head_dim. Decode takes the absorbed path in f32 plain
    torch, as the reference computes it outside any kernel: q_nope folded
    through w_uk into the latent space, scores over the cached latents and
    shared roped keys, the context mapped out through w_uv. It reads only
    the cache's first kv_len rows, the ones the reference's NEG_INF mask
    keeps (every row when the ring is full)."""
    B, S, _ = x.shape
    cd = cfg.cdtype
    H = cfg.num_heads
    nope, rope, vd, kvr = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.v_head_dim, cfg.kv_lora_rank)
    scale = (nope + rope) ** -0.5
    window = cfg.sliding_window

    q = rmsnorm(p["q_norm"], x @ p["wq_a"].to(cd)) @ p["wq_b"].to(cd)
    q = q.reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ p["wkv_a"].to(cd)                                     # [B,S,kvr+rope]
    # the latent columns are a strided view (row pitch kvr + rope); the
    # RMSNorm kernel takes contiguous rows only
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :kvr].contiguous())
    k_rope = apply_rope(kv_a[..., kvr:].reshape(B, S, 1, rope), positions,
                        cfg.rope_theta)

    wkv_b = p["wkv_b"].to(cd).reshape(kvr, H, nope + vd)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]               # [kvr,H,nope], [kvr,H,vd]

    if mode in ("train", "prefill"):
        k_nope = torch.einsum("bsr,rhn->bshn", c_kv, w_uk)
        v = torch.einsum("bsr,rhv->bshv", c_kv, w_uv)
        k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        # v padded to k's head dim for the shared flash kernel, sliced back
        pad = nope + rope - vd
        v_p = F.pad(v, (0, pad)) if pad > 0 else v
        out = kops.flash_attention(qfull, k, v_p.contiguous(), causal=cfg.causal,
                                   window=window, block_kv=cfg.attn_block_kv)
        out = out[..., :vd]
        new_cache = None
        if mode == "prefill":
            W = min(window, S) if window else S
            cc, rc = c_kv[:, S - W:], k_rope[:, S - W:, 0]
            if window and S > window:
                cc = torch.roll(cc, S % W, dims=1)
                rc = torch.roll(rc, S % W, dims=1)
            new_cache = {"c_kv": cc, "k_rope": rc, "len": min(W, S)}
    elif mode == "decode":
        W = cache["c_kv"].shape[1]
        slot = _decode_slot(pos, W, window)
        cache["c_kv"][:, slot] = c_kv[:, 0]
        cache["k_rope"][:, slot] = k_rope[:, 0, 0]
        kv_len = min(pos + 1, W)
        f32 = torch.float32
        c = cache["c_kv"][:, :kv_len].to(f32)
        r = cache["k_rope"][:, :kv_len].to(f32)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.to(f32), w_uk.to(f32))
        s = (torch.einsum("bqhr,bsr->bhqs", q_lat, c)
             + torch.einsum("bqhp,bsp->bhqs", q_rope.to(f32), r)) * scale
        w = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhqs,bsr->bqhr", w, c)
        out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv.to(f32)).to(cd)
        new_cache = {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
                     "len": kv_len}
    else:
        raise ValueError(f"unknown mode {mode!r}")

    y = out.reshape(B, S, H * vd) @ p["wo"].to(cd)
    return y, new_cache


# ===================================================== cross-attention (enc-dec)
def init_cross_attn(key, cfg):
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    ks = {n: fold_in_name(key, n) for n in ("wq", "wk", "wv", "wo")}
    return {
        "wq": dense_init(ks["wq"], (d, H * hd), cfg.pdtype),
        "wk": dense_init(ks["wk"], (d, H * hd), cfg.pdtype),
        "wv": dense_init(ks["wv"], (d, H * hd), cfg.pdtype),
        "wo": dense_init(ks["wo"], (H * hd, d), cfg.pdtype),
    }


def cross_kv(p, enc, cfg):
    """Cross-attention K / V [B, T, H, hd] from the encoder states enc [B,
    T, d]: on every train call, once a request in serving."""
    B, T, _ = enc.shape
    H, hd = cfg.num_heads, cfg.head_dim
    cd = cfg.cdtype
    k = (enc @ p["wk"].to(cd)).reshape(B, T, H, hd)
    v = (enc @ p["wv"].to(cd)).reshape(B, T, H, hd)
    return {"k": k, "v": v}


def cross_attention_cached(p, x, ckv, cfg):
    """x: [B, S, d] queries against projected K / V (``cross_kv``), every
    encoder row visible: f32 scores, softmax and weighted sum in plain
    torch, as the reference's einsums (it wrote no kernel for them).
    Returns [B, S, d]."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    cd = cfg.cdtype
    q = (x @ p["wq"].to(cd)).reshape(B, S, H, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ckv["k"].float()) * hd ** -0.5
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, ckv["v"].float()).to(cd)
    return out.reshape(B, S, H * hd) @ p["wo"].to(cd)


def cross_attention(p, x, enc, cfg):
    """x: [B, S, d] queries; enc: [B, T, d] encoder states (full,
    non-causal), K / V projected on this call (the train path)."""
    return cross_attention_cached(p, x, cross_kv(p, enc, cfg), cfg)
