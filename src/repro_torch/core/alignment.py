"""FedALIGN's selection rule (the paper's core contribution, §3.1).

A non-priority client k is included in the aggregation of round t iff

    |F(w_t) - F_k(w_t)| < eps_t

evaluated at the *received* global model w_t. Priority clients are always
included. Counterpart of ``repro/core/alignment.py``; every value is a
float32 tensor computed in the reference's order of operations.
"""
from __future__ import annotations

import torch


def epsilon_at(fed, round_idx):
    """eps_t schedule: constant | exp | linear | step (0-d float32)."""
    t = torch.tensor(round_idx, dtype=torch.float32)
    eps0 = torch.tensor(fed.epsilon, dtype=torch.float32)
    if fed.epsilon_schedule == "constant":
        return eps0
    if fed.epsilon_schedule == "exp":
        return eps0 * (1.0 - fed.epsilon_decay) ** t
    if fed.epsilon_schedule == "linear":
        return torch.clamp(eps0 * (1.0 - fed.epsilon_decay * t), min=0.0)
    if fed.epsilon_schedule == "step":
        # halve every 1/decay rounds
        k = torch.floor(t * fed.epsilon_decay)
        return eps0 * 0.5 ** k
    raise ValueError(fed.epsilon_schedule)


def inclusion_gates(local_losses, global_loss, eps, priority_mask, *,
                    warmup=False, participation_mask=None, selection="fedalign",
                    topk=4, sim_threshold=0.0, delta_cos=None):
    """I_{k,t} per client: a stateless wrapper over the strategy registry in
    ``fl/engine.py`` (the single gating implementation)."""
    from repro_torch.fl import engine
    ctx = engine.SelectionContext(
        align_vals=local_losses, global_align=global_loss, eps=eps,
        priority_mask=priority_mask, participation=participation_mask,
        warmup=warmup, delta_cos=delta_cos, topk=topk,
        sim_threshold=sim_threshold)
    return engine.compute_gates(ctx, selection)


def global_loss_from_locals(local_losses, priority_mask, weights):
    """F(w) = sum_{k in P} p_k F_k(w); weights normalized so priority mass = 1."""
    pri = priority_mask.float()
    num = torch.sum(pri * weights * local_losses)
    den = torch.clamp(torch.sum(pri * weights), min=1e-30)
    return num / den
