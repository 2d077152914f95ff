"""Learning-rate schedules, including the paper's decaying rate
eta_t = 2 / (mu (t + gamma)) (Theorem 1). Counterpart of
``repro/optim/schedules.py``; each schedule returns a 0-d float32 tensor
computed in the reference's order of operations."""
from __future__ import annotations

import torch


def constant_schedule(lr):
    return lambda t: torch.tensor(lr, dtype=torch.float32)


def paper_decay_schedule(mu: float, gamma: float):
    """eta_t = 2 / (mu (t + gamma)) — the Theorem-1 rate."""
    return lambda t: 2.0 / (mu * (torch.tensor(t, dtype=torch.float32) + gamma))


def make_schedule(fed_cfg):
    if fed_cfg.lr_schedule == "constant":
        return constant_schedule(fed_cfg.lr)
    if fed_cfg.lr_schedule == "paper_decay":
        return paper_decay_schedule(fed_cfg.mu_strong, fed_cfg.gamma_decay)
    raise ValueError(fed_cfg.lr_schedule)
