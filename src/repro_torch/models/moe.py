"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch.

Counterpart of ``repro/models/moe.py``, the same algorithm and numerics:
the router in f32, top-k (ties to the lower expert index, as
``jax.lax.top_k``), a stable argsort of the token -> expert assignments,
each assignment's rank within its expert, a capacity-bounded [E, C, d]
buffer (assignments past C go to a spill row that is dropped), the expert
SwiGLU as batched products (``torch.matmul``, which the reference leaves
to XLA), and the gather back weighted by the normalised top-k
probabilities. Returns the load-balancing and router-z losses and the
dropped fraction beside the output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, init_swiglu, swiglu_apply
from repro_torch.utils import ceil_div, fold_in_name


def init_moe(key, cfg):
    d, E, dff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    ks = {n: fold_in_name(key, n) for n in ("router", "gate", "up", "down", "shared")}
    p = {
        "w_router": dense_init(ks["router"], (d, E), torch.float32),   # router in f32
        "w_gate": dense_init(ks["gate"], (E, d, dff), cfg.pdtype),
        "w_up": dense_init(ks["up"], (E, d, dff), cfg.pdtype),
        "w_down": dense_init(ks["down"], (E, dff, d), cfg.pdtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_swiglu(ks["shared"], d, cfg.num_shared_experts * dff,
                                  cfg.pdtype)
    return p


def moe_apply(p, x, cfg, *, capacity: int | None = None):
    """x: [B, S, d] -> (y [B, S, d], aux) with aux = {"lb_loss",
    "router_z", "drop_frac"} (f32 scalars)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    cd = cfg.cdtype
    T = B * S
    xf = x.reshape(T, d)

    logits = xf.float() @ p["w_router"].float()                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index first
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :k], tope[:, :k]                              # [T, k]
    topw = topw / torch.clamp(torch.sum(topw, dim=-1, keepdim=True), min=1e-9)

    if capacity is None:
        capacity = max(1, int(ceil_div(T * k, E) * cfg.capacity_factor))
    C = capacity

    # ---- sort-based dispatch
    e_flat = tope.reshape(-1)                                          # [T*k]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_flat, minlength=E)                       # [E]
    starts = torch.cumsum(counts, 0) - counts                          # exclusive
    rank = torch.arange(T * k, device=x.device) - starts[e_sorted]     # within expert
    keep = rank < C
    slot = torch.where(keep, rank, C)                                  # overflow -> spill row
    tok_sorted = torch.div(order, k, rounding_mode="floor")

    buf = torch.zeros((E, C + 1, d), dtype=cd, device=x.device)
    # several overflowing assignments of one expert write its spill row C:
    # duplicate indices, whichever write lands is harmless, the row is dropped
    buf[e_sorted, slot] = xf[tok_sorted].to(cd)
    ex_in = buf[:, :C]                                                 # [E, C, d]

    # ---- expert FFN (SwiGLU), one batched product per weight
    g = torch.matmul(ex_in, p["w_gate"].to(cd))
    u = torch.matmul(ex_in, p["w_up"].to(cd))
    ex_out = torch.matmul(F.silu(g) * u, p["w_down"].to(cd))          # [E, C, d]

    # ---- combine
    gathered = ex_out[e_sorted, torch.where(keep, rank, 0)]           # [T*k, d]
    gathered = torch.where(keep[:, None], gathered, 0)
    contrib = torch.zeros((T * k, d), dtype=cd, device=x.device)
    contrib[order] = gathered
    y = torch.einsum("tkd,tk->td", contrib.reshape(T, k, d), topw.to(cd))

    if cfg.num_shared_experts:
        y = y + swiglu_apply(p["shared"], xf.to(cd), cd)

    # ---- aux losses
    frac = counts.float() / max(T * k, 1)                              # f_e
    imp = torch.mean(probs, dim=0)                                     # P_e
    lb_loss = E * torch.sum(frac * imp)
    router_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    dropped = torch.sum(~keep) / max(T * k, 1)
    aux = {"lb_loss": lb_loss, "router_z": router_z, "drop_frac": dropped}
    return y.reshape(B, S, d), aux
