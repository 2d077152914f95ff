"""Model registry: maps a ModelConfig to its functional implementation.

Counterpart of ``repro/models/registry.py``. ``init`` and ``make_cache``
take ``device=`` (default ``"cuda"``); the other functions follow the
device their params lie on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

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
