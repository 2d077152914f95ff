"""Functional optimizers over parameter dicts. Counterpart of
``repro/optim/optimizers.py``: ``Optimizer.update(grads, state, params,
lr)`` returns (new_params, new_state), with lr passed per call so
schedules stay outside. Only plain SGD is ported so far; it is the server
optimizer of the FedALIGN round (``server_opt="none"`` resolves to it)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.utils import tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]      # (grads, state, params, lr) -> (params, state)
    name: str = "opt"


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """Plain SGD. The momentum variant is not ported yet."""
    if momentum != 0.0 or nesterov:
        raise NotImplementedError(
            "sgd(momentum=..., nesterov=...) is not ported yet; only plain "
            "sgd(0.0) is")

    def init(params):
        return ()

    def update(grads, state, params, lr):
        new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, state
    return Optimizer(init, update, "sgd")
