"""Functional optimizers over parameter dicts. Counterpart of
``repro/optim/optimizers.py``: ``Optimizer.update(grads, state, params,
lr)`` returns (new_params, new_state), with lr passed per call so
schedules stay outside. ``sgd`` (with optional momentum / nesterov),
``adam``, ``yogi`` and ``adamw``, each in the reference's order of
operations, so f32 results agree to rounding. adam and yogi keep f32
moments and an int32 step count ``t`` (a 0-d tensor on the params'
device); they serve as the FedAdam / FedYogi server optimizers, and
momentum sgd as FedAvgM's."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.utils import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]      # (grads, state, params, lr) -> (params, state)
    name: str = "opt"


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """Plain SGD (the paper's local solver) with optional momentum; the
    momentum buffer has the params' dtype."""
    if momentum == 0.0:
        def init(params):
            return ()

        def update(grads, state, params, lr):
            new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
            return new, state
    else:
        def init(params):
            return {"m": tree_map(torch.zeros_like, params)}

        def update(grads, state, params, lr):
            m = tree_map(lambda mi, g: momentum * mi + g.to(mi.dtype),
                         state["m"], grads)
            if nesterov:
                step = tree_map(lambda g, mi: g.to(mi.dtype) + momentum * mi,
                                grads, m)
            else:
                step = m
            new = tree_map(lambda p, s: p - lr * s.to(p.dtype), params, step)
            return new, {"m": m}
    return Optimizer(init, update, "sgd")


def _moments_init(params):
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    dev = tree_leaves(params)[0].device
    return {"m": z, "v": tree_map(torch.zeros_like, z),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def _adaptive(b1, b2, eps, second_moment, name) -> Optimizer:
    """Adam-family update: m and v in f32, bias corrections 1 - b ** t in
    f32, and p - lr * (m / bc1) / (sqrt(v / bc2) + eps) cast back to the
    param dtype. ``second_moment(v, g2)`` is the rule's v step."""
    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda vi, g: second_moment(vi, torch.square(g.float())),
                     state["v"], grads)
        tf = t.float()
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        new = tree_map(
            lambda p, mi, vi: (p - lr * (mi / bc1)
                               / (torch.sqrt(vi / bc2) + eps)).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}
    return Optimizer(_moments_init, update, name)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adaptive(b1, b2, eps, lambda v, g2: b2 * v + (1 - b2) * g2,
                     "adam")


def yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3) -> Optimizer:
    """Yogi (Zaheer et al., NeurIPS 2018): Adam with an additive second
    moment, v <- v - (1-b2) sign(v - g^2) g^2, so v can shrink when recent
    gradients are small; on the aggregated federation delta it is the
    FedYogi server optimizer (Reddi et al., arXiv:2003.00295)."""
    return _adaptive(b1, b2, eps,
                     lambda v, g2: v - (1 - b2) * torch.sign(v - g2) * g2,
                     "yogi")


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    base = adam(b1, b2, eps)

    def update(grads, state, params, lr):
        decayed = tree_map(lambda p: p * (1 - lr * weight_decay), params)
        return base.update(grads, state, decayed, lr)
    return Optimizer(base.init, update, "adamw")
