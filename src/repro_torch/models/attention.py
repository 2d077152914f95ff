"""Grouped-query attention: projections, RoPE, and the train / prefill /
decode paths with their KV cache.

Counterpart of ``repro/models/attention.py`` (GQA only; MLA is ROADMAP
A16). Train and prefill go through ``kops.flash_attention``, the
``FlashAttention`` autograd Function (on the card the flash-attention
forward kernel, and its backward kernel when a gradient flows; no graph
is built when nothing requires grad), decode through
``kops.decode_attention`` (the decode-attention kernel). Layouts are the
reference's: q [B, S, H, hd], k / v [B, S, KV, hd], cache k / v
[B, W, KV, hd].

Under a sliding window the cache is a ring: absolute position p lives at
slot p % W. Prefill keeps the last W positions rolled by S % W, decode
writes slot pos % W and attends over min(pos + 1, W) rows.

Unlike the reference (functional, a new cache per step), decode writes the
new k / v row into the cache it is given, in place, and returns that same
cache: a copy of every layer's cache per token would move more bytes than
the attention itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense_init
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


def gqa_attention_block(p, x, cfg, *, positions, mode, cache=None,
                        pos: int | None = None):
    """Full GQA block. mode: 'train' | 'prefill' | 'decode'.

    positions: [S] absolute positions (a tensor on x's device). In decode,
    ``pos`` is the same position as a host int (S == 1): it picks the cache
    slot and kv_len without reading the device. cache (prefill out, decode
    in-out): dict(k, v: [B, W, KV, hd], len). Returns (out [B, S, d],
    new_cache)."""
    B, S, _ = x.shape
    cd = cfg.cdtype
    q, k, v = gqa_project(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window

    if mode in ("train", "prefill"):
        out = kops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                   block_kv=cfg.attn_block_kv)
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
        if pos is None:
            raise ValueError("decode needs the position as a host int (pos=)")
        W = cache["k"].shape[1]
        slot = pos % W if window else pos
        if not 0 <= slot < W:
            raise ValueError(f"decode position {pos} outside a cache of {W} "
                             "rows (pad_caches grows it)")
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
