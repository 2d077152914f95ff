"""Decoder-only LM: the ``pattern="attn"`` family (GQA or MLA attention,
dense or MoE FFNs, optionally leading dense blocks, optionally image
inputs), the hybrid ``pattern="jamba"`` and ``pattern="xlstm"``: init,
forward, the training loss and the serving entry points.

Counterpart of ``repro/models/transformer.py`` for the dense GQA models
(qwen1.5-0.5b, qwen2.5-3b, phi3-mini-3.8b), the MoE ones
(granite-moe-3b-a800m, deepseek-moe-16b), minicpm3-4b's MLA,
llava-next-34b's image inputs, jamba-1.5-large-398b and xlstm-125m. The
parameter tree is the reference's: ``embed``, ``final_norm``, ``lm_head``
when the embeddings are untied, ``img_norm`` under ``cfg.vlm``,
``pre_blocks`` (a list: the ``first_dense`` leading blocks with a dense
FFN, deepseek's layer 0; empty elsewhere) and ``periods``, which holds
one subtree per layer of a period (``l0`` for the attn family; ``l0``..
``l7`` for jamba: attention then 7 Mamba mixers, a MoE FFN on every other
layer; ``l0`` an mLSTM and ``l1`` an sLSTM block for xlstm, neither with
an FFN) with its leaves stacked on a leading [n_periods] axis.
``forward`` runs the pre blocks, then walks the periods in a Python loop
where the reference scans them.

Image inputs (``cfg.vlm``): ``image_embeds`` [B, n_img, d] (the stubbed
vision tower's output) are normed by ``img_norm`` in the compute dtype and
put before the text embeddings; ``loss_fn`` drops the first n_img hidden
rows, so only text positions carry loss. ``prefill`` takes
``batch["image_embeds"]``; decode steps carry no images, and their
positions count the image rows (n_img + S + i).

API (functional, as the reference's):
    init(key, cfg, device)                           -> params
    forward(params, tokens, cfg, mode=...)           -> (hidden, caches, aux)
    loss_fn(params, batch, cfg)                      -> (loss, metrics)
    make_cache(cfg, batch_size, cache_len, device)   -> caches
    prefill(params, batch, cfg)                      -> (caches, last_logits)
    decode_step(params, caches, tokens, pos, cfg)    -> (logits, caches)

Caches are ``{"pre": [one cache a pre block], "periods": {l0: ...}}``,
the periods' leaves stacked on [n_periods]. The decode position ``pos`` is
a host int: it picks the cache slot and the valid length without reading
the device. An attention cache's ``len`` is a host int too (every
attention layer's cache holds the same number of valid rows). Decode
writes in place into the ``caches`` it is given: each attention layer its
new k / v row (MLA: its latent and roped-key row), each Mamba, mLSTM and
sLSTM layer its conv tail and states. ``prefill`` and ``decode_step`` run
under ``torch.no_grad``: serving builds no autograd graph even on params
that require grad.

Training: ``forward(mode="train")`` with grad enabled and ``cfg.remat``
checkpoints each period (``torch.utils.checkpoint``, non-reentrant: the
period's forward runs again in the backward), the reference's "full"
policy; the pre blocks run outside any checkpoint, as in the reference.
``remat_policy="save_mixer"`` keeps each layer's mixer and recomputes
only its FFN, the reference's intent (its comment at
repro/models/transformer.py:155: keep the expensive mixer outputs,
recompute only the cheap norm / FFN chains). The mixer (``norm1`` and the
attention or the Mamba / xLSTM block) runs outside any checkpoint, so
autograd keeps what its backward reads (K5's q, k, v, out and lse; the
scan kernel's inputs); the residual add, ``norm2`` and the FFN run as
one checkpoint a layer, whose forward runs again in the backward. The
reference names only the mixer output h, but its mixer's backward needs
the mixer's residuals, which keeping h alone would rerun the mixer to
get. The gradients are the "full" policy's bit for bit: the same ops run
in the same order (the mixer's forward, run once here and twice there,
is deterministic), and each tensor's gradient sums the same terms.
``torch.utils.checkpoint``'s selective policies are not used: they choose
by the torch ops they see, and the kernels' ctypes launches are none.
The Mamba mixer differentiates through
``kernels/ssm_scan.py:SSMScan`` (the scan kernel forward, a plain-torch
backward); under "full" remat a period's scan runs twice a gradient,
once in the forward and once in the backward, under "save_mixer" once.

On a model axis (``tp``, a ``sharding/model_axis.py: ModelAxis``, which
``fl/sharded.py: make_pod_round`` binds into the loss for the dense GQA
family) ``forward(mode="train")`` and ``loss_fn`` run on the rank's
shards: the vocab-parallel embedding lookup, each layer's attention and
FFN as column / row-parallel regions (``models/attention.py``,
``models/layers.py``), RMSNorm on the replicated rows, and the
vocab-parallel loss; the remat and ``attn_bf16`` handling are the same.
``cfg.seq_shard_attn`` picks the attention's sequence layout there; on
one rank it is the identity, as the reference's sharding constraint is.
The encoder-decoder is ``models/encdec.py``.
"""
from __future__ import annotations

import operator
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.models import layers as L
from repro_torch.models.attention import (gqa_attention_block, init_gqa,
                                         init_mla, mla_attention_block)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import init_mamba, mamba_block
from repro_torch.models.xlstm import (NEG_INF, init_mlstm, init_slstm,
                                      mlstm_block, slstm_block)
from repro_torch.sharding.model_axis import vocab_embed
from repro_torch.utils import (fold_in_name, resolve_device, tree_leaves,
                               tree_map, tree_unflatten_like)

# (knob, on, what, ROADMAP item) of every model knob outside the port:
# none since seq_shard_attn was ported
_UNPORTED = ()


def check_model_config(cfg):
    """Refuse every knob outside the ported slices; returns ``cfg``."""
    for knob, on, what, item in _UNPORTED:
        if on(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {knob}={getattr(cfg, knob)!r} ({what}) is not "
                f"ported yet (ROADMAP {item})")
    return cfg


# ------------------------------------------------------------------ block init
def _init_block(key, cfg, kind):
    d = cfg.d_model
    dev = key.device
    p = {"norm1": L.init_rmsnorm(d, cfg.pdtype, dev)}
    mixer = kind["mixer"]
    if mixer == "attn":
        init_attn = init_mla if cfg.mla else init_gqa
        p["attn"] = init_attn(fold_in_name(key, "attn"), cfg)
    else:
        init_mixer = {"mamba": init_mamba, "mlstm": init_mlstm,
                      "slstm": init_slstm}[mixer]
        p[mixer] = init_mixer(fold_in_name(key, mixer), cfg)
    # xlstm's blocks ("ffn": "none") carry neither norm2 nor an FFN
    if kind["ffn"] == "dense":
        p["norm2"] = L.init_rmsnorm(d, cfg.pdtype, dev)
        p["mlp"] = L.init_swiglu(fold_in_name(key, "mlp"), d, cfg.d_ff, cfg.pdtype)
    elif kind["ffn"] == "moe":
        p["norm2"] = L.init_rmsnorm(d, cfg.pdtype, dev)
        p["moe"] = init_moe(fold_in_name(key, "moe"), cfg)
    return p


def _mixer(p, x, cfg, kind, *, positions, mode, cache, pos, tp=None):
    """``norm1`` and the layer's mixer -> (h, new_cache)."""
    h = L.rmsnorm(p["norm1"], x)
    mixer = kind["mixer"]
    if tp is not None:          # the dense GQA family (model_axis.check_model)
        return gqa_attention_block(p["attn"], h, cfg, positions=positions,
                                   mode=mode, cache=cache, pos=pos, tp=tp)
    if mixer == "attn":
        attend = mla_attention_block if cfg.mla else gqa_attention_block
        return attend(p["attn"], h, cfg, positions=positions, mode=mode,
                      cache=cache, pos=pos)
    block = {"mamba": mamba_block, "mlstm": mlstm_block,
             "slstm": slstm_block}[mixer]
    return block(p[mixer], h, cfg, mode=mode, cache=cache)


def _ffn(p, x, h, cfg, kind, tp=None):
    """The residual add of the mixer output h, then ``norm2`` and the FFN
    -> (x, aux): aux is the router's ``router_aux_coef * lb_loss`` for a
    MoE FFN, else 0.0."""
    x = x + h
    aux = 0.0
    if kind["ffn"] == "dense":
        x = x + L.swiglu_apply(p["mlp"], L.rmsnorm(p["norm2"], x), cfg.cdtype,
                               tp=tp)
    elif kind["ffn"] == "moe":
        y, moe_aux = moe_apply(p["moe"], L.rmsnorm(p["norm2"], x), cfg)
        x = x + y
        aux = cfg.router_aux_coef * moe_aux["lb_loss"]
    return x, aux


def _apply_block(p, x, cfg, kind, *, positions, mode, cache, pos,
                 save_mixer=False, tp=None):
    """One layer. Returns (x, new_cache, aux). ``save_mixer`` (training
    under ``remat_policy="save_mixer"``): the FFN as a checkpoint, the
    mixer outside it, so the backward reruns only the FFN."""
    h, new_cache = _mixer(p, x, cfg, kind, positions=positions, mode=mode,
                          cache=cache, pos=pos, tp=tp)
    if save_mixer:
        x, aux = checkpoint(lambda xc, hc: _ffn(p, xc, hc, cfg, kind, tp), x,
                            h, use_reentrant=False)
    else:
        x, aux = _ffn(p, x, h, cfg, kind, tp)
    return x, new_cache, aux


def _apply_period(p, x, cfg, kinds, *, positions, mode, caches, pos,
                  save_mixer=False, tp=None):
    """The layers l0..l{n-1} of one period in order. Returns (x, the
    per-layer caches, the period's aux).

    The period's aux is its last layer's (0.0 if that layer is dense), as
    the reference's ``period_fn`` returns ``aux_acc + aux`` after its layer
    loop (repro/models/transformer.py:142-151): of jamba's four MoE layers
    a period only l7's counts."""
    new_caches, aux = {}, 0.0
    for j, kind in enumerate(kinds):
        name = f"l{j}"
        c_in = caches[name] if caches is not None else None
        x, c, aux = _apply_block(p[name], x, cfg, kind, positions=positions,
                                 mode=mode, cache=c_in, pos=pos,
                                 save_mixer=save_mixer, tp=tp)
        new_caches[name] = c
    return x, new_caches, aux


def _pre_kind(cfg):
    """The kind of every leading block: the first layer's mixer, a dense FFN."""
    return {"mixer": cfg.layer_kinds()[0]["mixer"], "ffn": "dense"}


# ------------------------------------------------------------------- model init
def _stacked(keys, init_one):
    """``init_one(key)`` for each of ``keys`` [n, 2], its leaves written into
    stacked [n, ...] leaves as each is drawn, so the peak is the stack plus
    one tree (a single tree is stacked as a view, with no copy). Meta keys
    draw nothing, so the first tree's shapes stand for all n."""
    n = keys.shape[0]
    if keys.device.type == "meta":
        return tree_map(lambda x: x.new_empty((n,) + x.shape),
                        init_one(keys[0]))
    stacked = None
    for i in range(n):
        one = init_one(keys[i])
        if n == 1:
            return tree_map(lambda x: x[None], one)
        if stacked is None:
            stacked = tree_map(lambda x: x.new_empty((n,) + x.shape), one)
        tree_map(lambda s, x: s[i].copy_(x), stacked, one)
    return stacked


def init(key, cfg, device="cuda"):
    """The reference's init, leaf for leaf: ``fold_in_name`` per leaf, the
    period keys from ``split``, each layer ``l{j}`` of a period from
    ``fold_in_name(period key, "l{j}")``, looped where the reference vmaps.
    The leading blocks ``pre{i}`` come first, as in the reference. The
    draws run on ``device``; each period is written into the stacked
    leaves as it is drawn, so the peak is the model plus one period (a
    single period is stacked as a view, with no copy)."""
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
    if cfg.vlm:
        # the projector's norm (the vision tower is a stub: image_embeds)
        params["img_norm"] = L.init_rmsnorm(cfg.d_model, cfg.pdtype, dev)
    # leading dense blocks outside the periods (deepseek-moe's layer 0)
    params["pre_blocks"] = [
        _init_block(fold_in_name(key, f"pre{i}"), cfg, _pre_kind(cfg))
        for i in range(cfg.first_dense)]
    pkeys = prng.split(fold_in_name(key, "periods"), cfg.n_periods)
    kinds = cfg.layer_kinds()
    params["periods"] = _stacked(pkeys, lambda k: {
        f"l{j}": _init_block(fold_in_name(k, f"l{j}"), cfg, kind)
        for j, kind in enumerate(kinds)})
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


def _embed_inputs(params, tokens, cfg, image_embeds=None, tp=None):
    """The token embeddings in the compute dtype (on a model axis the
    vocab-parallel lookup of the rank's rows); under ``cfg.vlm`` with
    ``image_embeds`` [B, n_img, d], those rows normed by ``img_norm`` (K9)
    and put first. Decode steps carry no images."""
    rows = (params["embed"][tokens] if tp is None
            else vocab_embed(tp, params["embed"], tokens))
    x = rows.to(cfg.cdtype)
    if cfg.vlm and image_embeds is not None:
        img = torch.as_tensor(image_embeds, device=x.device).to(cfg.cdtype)
        x = torch.cat([L.rmsnorm(params["img_norm"], img), x], dim=1)
    return x


def forward(params, tokens, cfg, *, mode, positions=None, caches=None,
            pos=None, image_embeds=None, tp=None):
    """Returns (hidden [B,S',d], new_caches, aux); S' counts the image
    rows under ``cfg.vlm``. ``pos`` (decode): the position as a host int.
    aux: the sum over periods of each period's last layer's
    ``router_aux_coef * lb_loss`` (an f32 scalar; 0.0 where that layer is
    dense), plus each pre block's (0.0: they are dense), as the
    reference's ``forward``. ``tp``: the model axis (see the module note;
    ``mode="train"`` only)."""
    check_model_config(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    x = _embed_inputs(params, tokens, cfg, image_embeds, tp)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=dev)

    kinds = cfg.layer_kinds()
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    # any other policy checkpoints whole periods, as the reference's else
    save_mixer = remat and cfg.remat_policy == "save_mixer"
    aux_total = 0.0
    pre_caches = []
    for i, bp in enumerate(params["pre_blocks"]):
        c_in = caches["pre"][i] if caches is not None else None
        x, c, aux = _apply_block(bp, x, cfg, _pre_kind(cfg), positions=positions,
                                 mode=mode, cache=c_in, pos=pos)
        pre_caches.append(c)
        aux_total = aux_total + aux
    period_caches = []
    for i, p_i in enumerate(_periods(params["periods"], cfg.n_periods)):
        if remat and not save_mixer:
            x, aux = checkpoint(lambda xc, p=p_i: _apply_period(
                p, xc, cfg, kinds, positions=positions, mode=mode, caches=None,
                pos=None, tp=tp)[::2], x, use_reentrant=False)
        else:
            c_in = _period(caches["periods"], i) if caches is not None else None
            x, c, aux = _apply_period(p_i, x, cfg, kinds, positions=positions,
                                      mode=mode, caches=c_in, pos=pos,
                                      save_mixer=save_mixer, tp=tp)
            period_caches.append(c)
        aux_total = aux_total + aux

    x = L.rmsnorm(params["final_norm"], x)
    new_caches = None
    if mode == "prefill":
        new_caches = {"pre": pre_caches, "periods": tree_map(
            lambda *cs: torch.stack(cs) if isinstance(cs[0], torch.Tensor) else cs[0],
            *period_caches)}
    elif mode == "decode":
        # each layer wrote its k / v row or its states into the stacked
        # cache in place (period_caches hold views of it); only the
        # attention layers' host-int len moves
        new_caches = {"pre": pre_caches, "periods": {
            name: dict(c, len=period_caches[0][name]["len"]) if "len" in c else c
            for name, c in caches["periods"].items()}}
    return x, new_caches, aux_total


# --------------------------------------------------------------------- heads
def _unembed_last(params, hidden, cfg):
    """Logits for the final position only: [B,d] @ [d,V], in f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden[:, -1].float() @ w.float()


# ----------------------------------------------------------------------- train
def loss_fn(params, batch, cfg, tp=None):
    """batch: tokens / labels / mask [B, S] (text), plus image_embeds [B,
    n_img, d] under ``cfg.vlm``. Returns (scalar loss, metrics): the
    masked mean next-token cross-entropy over the text positions (image
    positions carry no loss) plus the auxiliary loss (the MoE router's; 0
    without MoE), differentiable in params. A VLM batch without
    image_embeds raises the reference's ``AttributeError``. ``tp``: the
    model axis; ``params`` are then the rank's shards."""
    image_embeds = batch.get("image_embeds")
    hidden, _, aux = forward(params, batch["tokens"], cfg, mode="train",
                             image_embeds=image_embeds, tp=tp)
    if cfg.vlm:
        hidden = hidden[:, image_embeds.shape[1]:]
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    s_loss, s_cnt = L.chunked_softmax_xent(hidden, w, batch["labels"],
                                           batch["mask"], cfg.loss_chunk, tp=tp)
    task_loss = s_loss / torch.clamp(s_cnt, min=1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=task_loss.device)
    loss = task_loss + aux
    return loss, {"task_loss": task_loss, "aux_loss": aux, "tokens": s_cnt}


# --------------------------------------------------------------------- serving
def make_cache(cfg, batch_size, cache_len, device="cuda"):
    """Zero decode cache for every layer, stacked per period, and one
    unstacked for each pre block. GQA attention: k, v [n_periods, B, W, KV,
    hd] in the compute dtype (W = the window, capped at cache_len), len 0;
    MLA: c_kv [n_periods, B, W, kv_lora_rank] and k_rope [n_periods, B, W,
    qk_rope_head_dim] in the compute dtype, len 0. Mamba: conv
    [n_periods, B, K-1, di] in the compute dtype, h [n_periods, B, di, N]
    f32. mLSTM (di = mlstm_proj_factor * d, hd = di / H): conv [.., B,
    K-1, di] in the compute dtype, C [.., B, H, hd, hd], n [.., B, H, hd]
    and m [.., B, H] f32, m filled with -1e30. sLSTM: conv [.., B, K-1, d]
    in the compute dtype, h, c, n and m [.., B, d] f32, m -1e30. The
    recurrent caches are length-free. ``device="meta"`` gives the shapes
    alone."""
    check_model_config(cfg)
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    P, B, cd = cfg.n_periods, batch_size, cfg.cdtype
    W = min(cfg.sliding_window, cache_len) if cfg.sliding_window else cache_len

    def one(kind, lead):
        def full(*shape, dtype=cd, fill=0.0):
            return torch.full(lead + shape, fill, dtype=dtype, device=dev)
        f32 = torch.float32
        mixer, K1 = kind["mixer"], cfg.ssm_conv_dim - 1
        if mixer == "attn":
            if cfg.mla:
                return {"c_kv": full(B, W, cfg.kv_lora_rank),
                        "k_rope": full(B, W, cfg.qk_rope_head_dim), "len": 0}
            return {"k": full(B, W, cfg.num_kv_heads, cfg.head_dim),
                    "v": full(B, W, cfg.num_kv_heads, cfg.head_dim), "len": 0}
        if mixer == "mamba":
            return {"conv": full(B, K1, cfg.d_inner),
                    "h": full(B, cfg.d_inner, cfg.ssm_state_dim, dtype=f32)}
        H = cfg.num_heads
        if mixer == "mlstm":
            di = int(cfg.mlstm_proj_factor * cfg.d_model)
            hd = di // H
            return {"conv": full(B, K1, di),
                    "C": full(B, H, hd, hd, dtype=f32),
                    "n": full(B, H, hd, dtype=f32),
                    "m": full(B, H, dtype=f32, fill=NEG_INF)}
        d = cfg.d_model
        return {"conv": full(B, K1, d), "h": full(B, d, dtype=f32),
                "c": full(B, d, dtype=f32), "n": full(B, d, dtype=f32),
                "m": full(B, d, dtype=f32, fill=NEG_INF)}
    return {"pre": [one(_pre_kind(cfg), ()) for _ in range(cfg.first_dense)],
            "periods": {f"l{j}": one(kind, (P,))
                        for j, kind in enumerate(cfg.layer_kinds())}}


@torch.no_grad()
def prefill(params, batch, cfg):
    """batch: tokens [B, S], plus image_embeds [B, n_img, d] under
    ``cfg.vlm``. -> (caches of n_img + S rows, the last position's
    logits)."""
    hidden, caches, _ = forward(params, batch["tokens"], cfg, mode="prefill",
                                image_embeds=batch.get("image_embeds"))
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
