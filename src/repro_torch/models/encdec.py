"""Whisper-style encoder-decoder backbone (arXiv:2212.04356): init, the
encoder, the decoder in its three modes, the training loss and the serving
entry points.

Counterpart of ``repro/models/encdec.py``. The mel-spectrogram + conv
feature extractor is a stub, as in the reference: ``frames`` [B, T, d] are
precomputed frame embeddings (already conv-downsampled). The backbone: a
bidirectional encoder over the frames and a causal decoder with self- and
cross-attention; pre-LayerNorm, a GELU MLP with biases, learned positional
embeddings (``pos_enc`` of num_frames rows, ``pos_dec`` of max(num_frames,
65536) rows), no RoPE, the embeddings tied to the output.

The parameter tree is the reference's: ``embed``, ``pos_enc``,
``pos_dec``, ``enc_blocks`` and ``dec_blocks`` (each block's leaves
stacked on a leading [layers] axis), ``enc_norm`` and ``dec_norm``.
Layers run in a Python loop where the reference scans them.

Kernels: the self-attention of both stacks goes through
``kernels/ops.py``: the flash-attention kernel (K5, its backward K6 under
autograd) non-causal in the encoder and causal in the decoder, the
decode-attention kernel (K7) in a decode step. Cross-attention, LayerNorm
and the MLP are plain torch, as the reference has them (it wrote no kernel
for them). ``attn_bf16`` does nothing here: the reference's
``encdec._self_attn`` passes no ``mm_dtype`` either.

Serving: ``prefill({"tokens", "frames"})`` encodes the frames once,
projects every decoder layer's cross K / V from them once, and returns
the caches ``{"dec": {"self": {k, v, len}, "cross": {k, v}}, "enc_out"}``
(leaves stacked on [layers]). ``launch/serve.py:pad_caches`` grows the
self k / v to the request's length; the cross k / v and ``enc_out`` are
already at full shape (the request's frames are num_frames rows) and come
back as the same tensors. ``decode_step`` at host-int ``pos`` reads
``pos_dec[pos]``, writes each layer's new self k / v row in place at slot
``pos`` and attends over min(pos + 1, cache_len) rows; the 1500 frames
are never projected again. ``generate`` and the scheduler serve text
only, as the reference's.

API (functional, as the reference's):
    init(key, cfg, device)                             -> params
    encode(params, frames, cfg)                        -> enc_out [B, T, d]
    decode_forward(params, tokens, enc_out, cfg, mode=...) -> (hidden, caches)
    loss_fn(params, batch, cfg)                        -> (loss, metrics)
    make_cache(cfg, batch_size, cache_len, device)     -> caches
    prefill(params, batch, cfg)                        -> (caches, last_logits)
    decode_step(params, caches, tokens, pos, cfg)      -> (logits, caches)

Training: ``decode_forward(mode="train")`` with grad enabled and
``cfg.remat`` checkpoints each decoder block (``torch.utils.checkpoint``,
non-reentrant), as the reference checkpoints its scanned decoder block;
the encoder runs outside any checkpoint, as in the reference. Whisper has
no federated round: the reference's ``launch/train.run`` refuses enc-dec.
"""
from __future__ import annotations

import operator

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.attention import (_decode_slot, cross_attention,
                                         cross_attention_cached, cross_kv,
                                         init_cross_attn)
from repro_torch.models.transformer import (_period, _periods, _stacked,
                                           check_model_config)
from repro_torch.utils import fold_in_name, resolve_device, tree_map


# ------------------------------------------------------------------------ init
# the self-attentions' four matrices are the cross-attention's shapes (H ==
# KV, no bias), so ``init_cross_attn`` draws them, as in the reference
def _init_enc_block(key, cfg):
    d, dev = cfg.d_model, key.device
    return {
        "norm1": L.init_layernorm(d, cfg.pdtype, dev),
        "attn": init_cross_attn(fold_in_name(key, "attn"), cfg),
        "norm2": L.init_layernorm(d, cfg.pdtype, dev),
        "mlp": L.init_gelu_mlp(fold_in_name(key, "mlp"), d, cfg.d_ff, cfg.pdtype),
    }


def _init_dec_block(key, cfg):
    d, dev = cfg.d_model, key.device
    return {
        "norm1": L.init_layernorm(d, cfg.pdtype, dev),
        "self_attn": init_cross_attn(fold_in_name(key, "sa"), cfg),
        "norm_x": L.init_layernorm(d, cfg.pdtype, dev),
        "cross_attn": init_cross_attn(fold_in_name(key, "xa"), cfg),
        "norm2": L.init_layernorm(d, cfg.pdtype, dev),
        "mlp": L.init_gelu_mlp(fold_in_name(key, "mlp"), d, cfg.d_ff, cfg.pdtype),
    }


def init(key, cfg, device="cuda"):
    """The reference's init, leaf for leaf: ``fold_in_name`` for ``enc``,
    ``dec``, ``embed``, ``pe`` and ``pd``, ``prng.split`` over the layers,
    looped where the reference vmaps. The draws run on ``device``."""
    check_model_config(cfg)
    dev = resolve_device(device)
    key = key.to(dev)
    d = cfg.d_model
    enc_keys = prng.split(fold_in_name(key, "enc"), cfg.encoder_layers)
    dec_keys = prng.split(fold_in_name(key, "dec"), cfg.num_layers)
    return {
        "embed": L.embed_init(fold_in_name(key, "embed"),
                              (cfg.vocab_size, d), cfg.pdtype),
        "pos_enc": L.embed_init(fold_in_name(key, "pe"),
                                (cfg.num_frames, d), cfg.pdtype),
        "pos_dec": L.embed_init(fold_in_name(key, "pd"),
                                (max(cfg.num_frames, 65536), d), cfg.pdtype),
        "enc_blocks": _stacked(enc_keys, lambda k: _init_enc_block(k, cfg)),
        "enc_norm": L.init_layernorm(d, cfg.pdtype, dev),
        "dec_blocks": _stacked(dec_keys, lambda k: _init_dec_block(k, cfg)),
        "dec_norm": L.init_layernorm(d, cfg.pdtype, dev),
    }


# ------------------------------------------------------------- self-attention
def _self_attn(p, x, cfg, *, causal, mode="train", cache=None, pos=None):
    """Non-roped MHA of both stacks. Train and prefill: K5 over the whole
    sequence (prefill returns the cache {k, v, len=S}). Decode (S == 1, at
    host-int ``pos``): the new k / v row written in place at slot ``pos``
    of the cache, K7 over min(pos + 1, cache_len) rows."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    cd = cfg.cdtype
    q = (x @ p["wq"].to(cd)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(cd)).reshape(B, S, H, hd)
    v = (x @ p["wv"].to(cd)).reshape(B, S, H, hd)
    new_cache = None
    if mode == "decode":
        W = cache["k"].shape[1]
        slot = _decode_slot(pos, W, 0)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        kv_len = min(pos + 1, W)
        out = kops.decode_attention(q, cache["k"], cache["v"], kv_len=kv_len)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": kv_len}
    elif mode in ("train", "prefill"):
        out = kops.flash_attention(q, k, v, causal=causal,
                                   block_kv=cfg.attn_block_kv)
        if mode == "prefill":
            new_cache = {"k": k, "v": v, "len": S}
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = out.reshape(B, S, H * hd) @ p["wo"].to(cd)
    return y, new_cache


# --------------------------------------------------------------------- encoder
def encode(params, frames, cfg):
    """frames: [B, T, d] stubbed conv-frontend output -> [B, T, d] in the
    compute dtype: ``pos_enc``, the pre-LN blocks, ``enc_norm``."""
    cd = cfg.cdtype
    dev = params["embed"].device
    frames = torch.as_tensor(frames, device=dev)
    T = frames.shape[1]
    x = frames.to(cd) + params["pos_enc"][:T].to(cd)[None]
    for p in _periods(params["enc_blocks"], cfg.encoder_layers):
        h, _ = _self_attn(p["attn"], L.layernorm(p["norm1"], x), cfg, causal=False)
        x = x + h
        x = x + L.gelu_mlp_apply(p["mlp"], L.layernorm(p["norm2"], x), cd)
    return L.layernorm(params["enc_norm"], x)


# --------------------------------------------------------------------- decoder
def _dec_block(p, x, enc_out, cfg, *, mode, cache, pos):
    """One decoder layer -> (x, its cache: {"self"} in train, {"self",
    "cross"} in prefill and decode)."""
    cd = cfg.cdtype
    c_sa = cache["self"] if cache is not None else None
    h, new_sa = _self_attn(p["self_attn"], L.layernorm(p["norm1"], x), cfg,
                           causal=True, mode=mode, cache=c_sa, pos=pos)
    x = x + h
    xq = L.layernorm(p["norm_x"], x)
    if mode == "train":                 # K / V recomputed (remat-friendly)
        x = x + cross_attention(p["cross_attn"], xq, enc_out, cfg)
        x = x + L.gelu_mlp_apply(p["mlp"], L.layernorm(p["norm2"], x), cd)
        return x, {"self": new_sa}
    ckv = (cache["cross"] if cache is not None and cache.get("cross") is not None
           else cross_kv(p["cross_attn"], enc_out, cfg))
    x = x + cross_attention_cached(p["cross_attn"], xq, ckv, cfg)
    x = x + L.gelu_mlp_apply(p["mlp"], L.layernorm(p["norm2"], x), cd)
    return x, {"self": new_sa, "cross": ckv}


def decode_forward(params, tokens, enc_out, cfg, *, mode, positions=None,
                   caches=None, pos=None):
    """-> (hidden [B, S, d] after ``dec_norm``, caches): None in train; in
    prefill the stacked per-layer caches and ``enc_out``; in decode the
    ``caches`` given, written in place, their self ``len`` moved.
    ``pos`` (decode): the position as a host int."""
    check_model_config(cfg)
    cd = cfg.cdtype
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    S = tokens.shape[1]
    if positions is None:
        positions = torch.arange(S, device=dev)
    x = params["embed"][tokens].to(cd) + params["pos_dec"][positions].to(cd)[None]
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    layer_caches = []
    for i, p in enumerate(_periods(params["dec_blocks"], cfg.num_layers)):
        if remat:
            x = checkpoint(lambda xc, p=p: _dec_block(
                p, xc, enc_out, cfg, mode=mode, cache=None, pos=None)[0],
                x, use_reentrant=False)
            continue
        c_in = _period(caches["dec"], i) if caches is not None else None
        x, c = _dec_block(p, x, enc_out, cfg, mode=mode, cache=c_in, pos=pos)
        layer_caches.append(c)
    x = L.layernorm(params["dec_norm"], x)
    if mode == "train":
        return x, None
    if mode == "prefill":
        dec = tree_map(lambda *cs: torch.stack(cs) if isinstance(cs[0], torch.Tensor)
                       else cs[0], *layer_caches)
        return x, {"dec": dec, "enc_out": enc_out}
    # decode: each layer wrote its k / v row into the stacked cache in
    # place; only the host-int len moves
    dec = dict(caches["dec"], self=dict(caches["dec"]["self"],
                                        len=layer_caches[0]["self"]["len"]))
    return x, {"dec": dec, "enc_out": caches["enc_out"]}


# ----------------------------------------------------------------------- train
def loss_fn(params, batch, cfg):
    """batch: frames [B, T, d], tokens / labels / mask [B, S]. Returns
    (scalar loss, metrics): the masked mean next-token cross-entropy
    against the tied ``embed``; ``aux_loss`` 0."""
    enc_out = encode(params, batch["frames"], cfg)
    hidden, _ = decode_forward(params, batch["tokens"], enc_out, cfg, mode="train")
    s_loss, s_cnt = L.chunked_softmax_xent(hidden, params["embed"], batch["labels"],
                                           batch["mask"], cfg.loss_chunk)
    loss = s_loss / torch.clamp(s_cnt, min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"task_loss": loss, "aux_loss": aux, "tokens": s_cnt}


# --------------------------------------------------------------------- serving
def make_cache(cfg, batch_size, cache_len, device="cuda"):
    """Zero decode cache, stacked on [num_layers]: self k, v [L, B,
    cache_len, H, hd] and len 0 (a host int); cross k, v [L, B,
    num_frames, H, hd]; ``enc_out`` [B, num_frames, d]; all in the compute
    dtype. ``device="meta"`` gives the shapes alone."""
    check_model_config(cfg)
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    Ln, B, H, hd, T = (cfg.num_layers, batch_size, cfg.num_heads, cfg.head_dim,
                       cfg.num_frames)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.cdtype, device=dev)
    return {"dec": {"self": {"k": zeros(Ln, B, cache_len, H, hd),
                             "v": zeros(Ln, B, cache_len, H, hd), "len": 0},
                    "cross": {"k": zeros(Ln, B, T, H, hd),
                              "v": zeros(Ln, B, T, H, hd)}},
            "enc_out": zeros(B, T, cfg.d_model)}


def _unembed_last(params, hidden):
    return hidden[:, -1].float() @ params["embed"].T.float()


@torch.no_grad()
def prefill(params, batch, cfg):
    """batch: tokens [B, S], frames [B, T, d] -> (caches, the last
    position's f32 logits [B, V])."""
    enc_out = encode(params, batch["frames"], cfg)
    hidden, caches = decode_forward(params, batch["tokens"], enc_out, cfg,
                                    mode="prefill")
    return caches, _unembed_last(params, hidden)


@torch.no_grad()
def decode_step(params, caches, tokens, pos, cfg):
    """tokens: [B, 1]; pos: the absolute position, a host int.
    -> (f32 logits [B, V], caches)."""
    pos = operator.index(pos)
    positions = torch.full((1,), pos, dtype=torch.int64,
                           device=params["embed"].device)
    hidden, new_caches = decode_forward(params, tokens, caches["enc_out"], cfg,
                                        mode="decode", positions=positions,
                                        caches=caches, pos=pos)
    return _unembed_last(params, hidden), new_caches
