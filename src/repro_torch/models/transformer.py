"""Decoder-only LM, dense ``pattern="attn"`` family: init, forward, the
training loss and the serving entry points.

Counterpart of ``repro/models/transformer.py`` for the dense GQA models
(qwen1.5-0.5b, qwen2.5-3b, phi3-mini-3.8b). The parameter tree is the
reference's: ``embed``, ``final_norm``, ``lm_head`` when the embeddings are
untied, ``pre_blocks`` (empty here) and ``periods``, whose leaves are
stacked on a leading [n_periods] axis. ``forward`` walks the periods in a
Python loop where the reference scans them.

API (functional, as the reference's):
    init(key, cfg, device)                           -> params
    forward(params, tokens, cfg, mode=...)           -> (hidden, caches, aux)
    loss_fn(params, batch, cfg)                      -> (loss, metrics)
    make_cache(cfg, batch_size, cache_len, device)   -> caches
    prefill(params, batch, cfg)                      -> (caches, last_logits)
    decode_step(params, caches, tokens, pos, cfg)    -> (logits, caches)

The decode position ``pos`` is a host int: it picks the cache slot and the
valid length without reading the device. A cache's ``len`` is a host int
too (every layer's cache holds the same number of valid rows); decode
writes each layer's new k / v row into ``caches`` in place. ``prefill``
and ``decode_step`` run under ``torch.no_grad``: serving builds no
autograd graph even on params that require grad.

Training: ``forward(mode="train")`` with grad enabled and ``cfg.remat``
checkpoints each period (``torch.utils.checkpoint``, non-reentrant: the
period's forward runs again in the backward), the reference's "full"
policy; ``remat_policy="save_mixer"`` is not ported (ROADMAP A16d).

Out of this slice, and refused with ``NotImplementedError`` by
``check_model_config``: MLA, MoE, the jamba / xlstm patterns,
``first_dense`` > 0, encoder-decoder, VLM, ``attn_bf16`` and
``seq_shard_attn`` (ROADMAP A16).
"""
from __future__ import annotations

import operator
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.models import layers as L
from repro_torch.models.attention import gqa_attention_block, init_gqa
from repro_torch.utils import (fold_in_name, resolve_device, tree_leaves,
                               tree_map, tree_unflatten_like)

_UNPORTED = (
    ("mla", lambda c: c.mla, "MLA attention"),
    ("moe", lambda c: c.moe, "mixture-of-experts FFNs"),
    ("pattern", lambda c: c.pattern != "attn", "the jamba / xlstm layer patterns"),
    ("first_dense", lambda c: c.first_dense > 0, "leading dense blocks"),
    ("encdec", lambda c: c.encdec, "the encoder-decoder model"),
    ("vlm", lambda c: c.vlm, "image inputs"),
    ("attn_bf16", lambda c: c.attn_bf16, "bf16 attention products"),
    ("seq_shard_attn", lambda c: c.seq_shard_attn, "sequence-sharded attention"),
)


def check_model_config(cfg):
    """Refuse every knob outside the dense GQA slice; returns ``cfg``."""
    for knob, on, what in _UNPORTED:
        if on(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {knob}={getattr(cfg, knob)!r} ({what}) is not "
                "ported yet (ROADMAP A16)")
    return cfg


# ------------------------------------------------------------------ block init
def _init_block(key, cfg):
    d = cfg.d_model
    dev = key.device
    return {
        "norm1": L.init_rmsnorm(d, cfg.pdtype, dev),
        "attn": init_gqa(fold_in_name(key, "attn"), cfg),
        "norm2": L.init_rmsnorm(d, cfg.pdtype, dev),
        "mlp": L.init_swiglu(fold_in_name(key, "mlp"), d, cfg.d_ff, cfg.pdtype),
    }


def _apply_block(p, x, cfg, *, positions, mode, cache, pos):
    h = L.rmsnorm(p["norm1"], x)
    h, new_cache = gqa_attention_block(p["attn"], h, cfg, positions=positions,
                                       mode=mode, cache=cache, pos=pos)
    x = x + h
    x = x + L.swiglu_apply(p["mlp"], L.rmsnorm(p["norm2"], x), cfg.cdtype)
    return x, new_cache


# ------------------------------------------------------------------- model init
def init(key, cfg, device="cuda"):
    """The reference's init, leaf for leaf: ``fold_in_name`` per leaf, the
    period keys from ``split``, looped where the reference vmaps. The draws
    run on ``device``; each period is written into the stacked leaves as it
    is drawn, so the peak is the model plus one period."""
    check_model_config(cfg)
    dev = resolve_device(device)
    key = key.to(dev)
    params: dict[str, Any] = {
        "embed": L.embed_init(fold_in_name(key, "embed"),
                              (cfg.vocab_size, cfg.d_model), cfg.pdtype),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(fold_in_name(key, "lm_head"),
                                         (cfg.d_model, cfg.vocab_size), cfg.pdtype)
    params["pre_blocks"] = []
    pkeys = prng.split(fold_in_name(key, "periods"), cfg.n_periods)
    stacked = None
    for i in range(cfg.n_periods):
        period = {"l0": _init_block(fold_in_name(pkeys[i], "l0"), cfg)}
        if stacked is None:
            stacked = tree_map(lambda x: x.new_empty((cfg.n_periods,) + x.shape),
                               period)
        tree_map(lambda s, x: s[i].copy_(x), stacked, period)
    params["periods"] = stacked
    return params


# --------------------------------------------------------------------- forward
def _period(tree, i):
    return tree_map(lambda t: t[i] if isinstance(t, torch.Tensor) else t, tree)


def _periods(tree, n):
    """The n per-period trees of stacked [n, ...] leaves, each leaf unbound
    once: in a backward, unbind joins the n gradients in one stack, where
    n separate selects would each add a zero-filled full-size gradient."""
    unbound = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten_like(tree, [u[i] for u in unbound]) for i in range(n)]


def forward(params, tokens, cfg, *, mode, positions=None, caches=None,
            pos=None):
    """Returns (hidden [B,S,d], new_caches, aux). ``pos`` (decode): the
    position as a host int. aux is 0.0: the dense family has no auxiliary
    loss."""
    check_model_config(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    x = params["embed"][tokens].to(cfg.cdtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=dev)

    periods = params["periods"]
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet (ROADMAP "
            "A16d); the port checkpoints whole periods ('full')")
    layer_caches = []
    for i, p_i in enumerate(_periods(periods["l0"], cfg.n_periods)):
        if remat:
            x = checkpoint(lambda xc, p=p_i: _apply_block(
                p, xc, cfg, positions=positions, mode=mode, cache=None,
                pos=None)[0], x, use_reentrant=False)
            continue
        c_in = _period(caches["periods"]["l0"], i) if caches is not None else None
        x, c = _apply_block(p_i, x, cfg, positions=positions, mode=mode,
                            cache=c_in, pos=pos)
        layer_caches.append(c)

    x = L.rmsnorm(params["final_norm"], x)
    new_caches = None
    if mode == "prefill":
        new_caches = {"pre": [], "periods": {"l0": {
            "k": torch.stack([c["k"] for c in layer_caches]),
            "v": torch.stack([c["v"] for c in layer_caches]),
            "len": layer_caches[0]["len"]}}}
    elif mode == "decode":
        # each layer wrote its row into the stacked cache in place
        new_caches = {"pre": [], "periods": {"l0": dict(
            caches["periods"]["l0"], len=layer_caches[0]["len"])}}
    return x, new_caches, 0.0


# --------------------------------------------------------------------- heads
def _unembed_last(params, hidden, cfg):
    """Logits for the final position only: [B,d] @ [d,V], in f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden[:, -1].float() @ w.float()


# ----------------------------------------------------------------------- train
def loss_fn(params, batch, cfg):
    """batch: tokens / labels / mask [B, S]. Returns (scalar loss,
    metrics): the masked mean next-token cross-entropy plus the auxiliary
    loss (0 for the dense family), differentiable in params."""
    hidden, _, aux = forward(params, batch["tokens"], cfg, mode="train")
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    s_loss, s_cnt = L.chunked_softmax_xent(hidden, w, batch["labels"],
                                           batch["mask"], cfg.loss_chunk)
    task_loss = s_loss / torch.clamp(s_cnt, min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=task_loss.device)
    loss = task_loss + aux
    return loss, {"task_loss": task_loss, "aux_loss": aux, "tokens": s_cnt}


# --------------------------------------------------------------------- serving
def make_cache(cfg, batch_size, cache_len, device="cuda"):
    """Zero decode cache for every layer, stacked per period: k, v
    [n_periods, B, W, KV, hd] in the compute dtype (W = the window, capped
    at cache_len), len 0. ``device="meta"`` gives the shapes alone."""
    check_model_config(cfg)
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    W = min(cfg.sliding_window, cache_len) if cfg.sliding_window else cache_len
    shape = (cfg.n_periods, batch_size, W, cfg.num_kv_heads, cfg.head_dim)
    return {"pre": [], "periods": {"l0": {
        "k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
        "len": 0}}}


@torch.no_grad()
def prefill(params, batch, cfg):
    hidden, caches, _ = forward(params, batch["tokens"], cfg, mode="prefill")
    return caches, _unembed_last(params, hidden, cfg)


@torch.no_grad()
def decode_step(params, caches, tokens, pos, cfg):
    """tokens: [B,1]; pos: the absolute position, a host int.
    -> (logits [B,V], caches)."""
    pos = operator.index(pos)
    positions = torch.full((1,), pos, dtype=torch.int64,
                           device=params["embed"].device)
    hidden, new_caches, _ = forward(params, tokens, cfg, mode="decode",
                                    positions=positions, caches=caches,
                                    pos=pos)
    return _unembed_last(params, hidden, cfg), new_caches
