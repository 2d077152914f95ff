"""Model registry: maps a ModelConfig to its functional implementation.

Counterpart of ``repro/models/registry.py``. ``init`` and ``make_cache``
take ``device=`` (default ``"cuda"``); the other functions follow the
device their params lie on.

``param_shapes``, ``cache_shapes`` and ``prefill_cache_shapes`` are the
counterparts of ``jax.eval_shape`` over ``model.init``, ``make_cache`` and
the prefill step: trees of ``meta`` tensors, leaf for leaf the reference's
names, shapes and dtypes, made without a PRNG draw (``prng``'s meta path)
and without allocating.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import prng
from repro_torch.models import encdec, transformer


@dataclass(frozen=True)
class Model:
    """Functional model bundle; cfg is pre-bound into every fn."""
    init: Callable            # (key, device="cuda") -> params
    loss_fn: Callable         # (params, batch) -> (loss, metrics)
    prefill: Callable         # (params, batch) -> (caches, last_logits)
    decode_step: Callable     # (params, caches, tokens, pos) -> (logits, caches)
    make_cache: Callable      # (batch_size, cache_len, device="cuda") -> caches
    cfg: Any


def get_model(cfg) -> Model:
    transformer.check_model_config(cfg)
    mod = encdec if cfg.encdec else transformer
    return Model(
        init=lambda key, device="cuda": mod.init(key, cfg, device),
        loss_fn=lambda params, batch: mod.loss_fn(params, batch, cfg),
        prefill=lambda params, batch: mod.prefill(params, batch, cfg),
        decode_step=lambda params, caches, tokens, pos: mod.decode_step(
            params, caches, tokens, pos, cfg),
        make_cache=lambda batch_size, cache_len, device="cuda": mod.make_cache(
            cfg, batch_size, cache_len, device),
        cfg=cfg,
    )


def param_shapes(cfg):
    """The params of ``cfg`` as meta tensors: ``init``'s tree, no values."""
    return get_model(cfg).init(prng.PRNGKey(0, device="meta"), device="meta")


def cache_shapes(cfg, batch_size, cache_len):
    """The decode cache of ``make_cache`` as meta tensors. Each attention
    ``len`` (a host int in the port's caches) is the reference's int32
    counter, stacked as its layers are: [n_periods] in a period, [] in a
    leading block, [num_layers] in whisper's decoder."""
    caches = get_model(cfg).make_cache(batch_size, cache_len, device="meta")

    def counters(tree, lead):
        if isinstance(tree, dict):
            return {k: (torch.empty(lead, dtype=torch.int32, device="meta")
                        if k == "len" else counters(v, lead))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [counters(v, lead) for v in tree]
        return tree
    if cfg.encdec:
        return dict(caches, dec=counters(caches["dec"], (cfg.num_layers,)))
    return {"pre": counters(caches["pre"], ()),
            "periods": counters(caches["periods"], (cfg.n_periods,))}


def prefill_cache_shapes(cfg, batch_size, seq_len):
    """The caches ``prefill`` returns for ``batch_size`` prompts of
    ``seq_len`` tokens (plus ``num_image_tokens`` image rows under
    ``cfg.vlm``), as meta tensors: the decode cache over that many rows
    (a window's at most), as ``cache_shapes`` gives it."""
    rows = seq_len + (cfg.num_image_tokens if cfg.vlm else 0)
    return cache_shapes(cfg, batch_size, rows)
