"""FedALIGN rounds over the LM zoo on one card: the spatial round.

Counterpart of ``repro/fl/sharded.py``, its single-card part:
``make_spatial_round`` (without ``max_cohort``) and
``make_round_step(..., fsdp=False)``. A round has the engine's
persistent-state signature

    round_step(state: engine.FederationState, batch, round_idx=0)
        -> (new_state, stats)

and runs, in the reference's order:

1. the server statistic F(w_t): the loss on the server-held batch;
2. per client, its loss at the received model (the matching statistic)
   and E full-batch local SGD steps, ``p <- -lr * grad + p``
   (``tree_axpy(-lr, g, p)``, the reference's order of operations);
3. the utility EMA and the eps gates of the configured strategy;
4. the gated aggregation of the client deltas (one fedagg launch on the
   card) under the configured aggregator and wire codec, the
   error-feedback rows advancing through ``engine.server_delta``;
5. the server step (sgd), skipped bit-exactly on a zero-mass round.

The reference ``vmap``s the clients; the port loops over them, because
``torch.func.vmap`` cannot batch through the ctypes kernels and one
client's params are 1.86 GB at qwen1.5-0.5b's full width. The math is per
client, so the result is the same. Each client's trained leaves are
written into preallocated ``[C, ...]`` stacked leaves (the round holds the
stack once); the loss at the received model runs under ``torch.no_grad``
and each local step takes ``torch.autograd.grad`` of a ``requires_grad``
view of the client's slot, then updates the slot in place.

Out of this slice, each raising ``NotImplementedError`` with its ROADMAP
item: ``max_cohort`` and the non-sgd server optimizers (A6b), the delta
strategies and the other rank strategies (A8), ``async_depth`` (A11),
failure models, the event clock and the divergence guard (A12),
``candidate_pool`` (A13) and the temporal FSDP round (A17).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import validate_config
from repro_torch.core.aggregation import (aggregator_key, apply_server_opt,
                                          get_aggregator, inclusion_mass,
                                          resolve_server_opt,
                                          resolve_wire_codec)
from repro_torch.core.alignment import epsilon_at
from repro_torch.fl import engine
from repro_torch.utils import (resolve_device, tree_leaves, tree_map,
                               tree_unflatten_like)

# (knob, test, ROADMAP item) for every FedConfig knob the spatial round of
# this slice does not run
_OUT_OF_SLICE = (
    ("max_cohort", lambda f: f.max_cohort > 0, "A6b"),
    ("server_opt", lambda f: resolve_server_opt(f.server_opt) != "sgd", "A6b"),
    ("selection", lambda f: f.selection in ("grad_sim", "topk_align",
                                            "welfare"), "A8"),
    ("async_depth", lambda f: f.async_depth > 0 or f.backend == "scan_async",
     "A11"),
    ("failure_model", lambda f: f.failure_model not in (None, "", "none"),
     "A12"),
    ("latency_mode", lambda f: f.latency_mode != "none", "A12"),
    ("round_deadline", lambda f: float(f.round_deadline) != float("inf"),
     "A12"),
    ("divergence_guard", lambda f: f.divergence_guard, "A12"),
    ("candidate_pool", lambda f: f.candidate_pool > 0, "A13"),
)


def check_round_config(fed):
    """Refuse the knobs this slice's pod round does not run, naming their
    ROADMAP item, then run the shared ``validate_config``."""
    for knob, on, item in _OUT_OF_SLICE:
        if on(fed):
            raise NotImplementedError(
                f"FedConfig.{knob}={getattr(fed, knob)!r} is not ported to "
                f"the LM round yet (ROADMAP {item})")
    return validate_config(fed)


def _train_steps(model, params, batch, lr, n_steps, out):
    """E local SGD steps on one client's batch (full-batch gradients, no
    PRNG), from ``params``, in ``out``: the client's preallocated slot
    (leaves like params), trained in place and returned."""
    tree_map(lambda o, p: o.copy_(p), out, params)
    slots = tree_leaves(out)
    for _ in range(n_steps):
        with torch.enable_grad():
            leaves = [s.detach().requires_grad_(True) for s in slots]
            loss = model.loss_fn(tree_unflatten_like(out, leaves), batch)[0]
            grads = torch.autograd.grad(loss, leaves)
        del leaves, loss
        with torch.no_grad():
            for s, g in zip(slots, grads):
                s.copy_(-lr * g + s)              # tree_axpy(-lr, g, p)
        del grads
    return out


def _local_steps(model, params, batch, lr, n_steps, out):
    """Local training plus F_k(w_t) of the *received* model (the paper's
    matching statistic). Returns (params', loss0)."""
    with torch.no_grad():
        loss0, _ = model.loss_fn(params, batch)
    return _train_steps(model, params, batch, lr, n_steps, out), loss0


def _gate_ctx(fed, state, util_ema, local_losses, server_loss, pm, w,
              round_idx=0):
    """SelectionContext for one pod-scale round: eps_t of ``round_idx``,
    the bias-corrected utility EMA, backlog and inclusion EMA from the
    state; no warm-up and full participation, as the reference's."""
    return engine.SelectionContext(
        align_vals=local_losses, global_align=server_loss,
        eps=epsilon_at(fed, round_idx), priority_mask=pm, weights=w,
        topk=fed.topk, sim_threshold=fed.sim_threshold,
        backlog=state.backlog,
        util_ema=engine.utility_estimate(fed, util_ema, round_idx),
        incl_ema=state.incl_ema, welfare_floor=fed.welfare_floor)


def _next_state(fed, state, new_params, opt_state, gates, util_ema,
                ef_accum=None):
    """Advance the cross-round carry with the engine's update rules (the
    selection and the effective gates are one here: no cohort overflow and
    no lost clients in this slice)."""
    return state.replace(
        params=new_params, opt_state=opt_state,
        backlog=engine.backlog_update(state.backlog, gates, gates),
        util_ema=util_ema,
        incl_ema=engine.inclusion_update(fed, state.incl_ema, gates),
        ef_accum=state.ef_accum if ef_accum is None else ef_accum)


def _apply_delta(fed, state, params, agg_delta, mass):
    """The synchronous server step: ``apply_server_opt`` unless the
    round's inclusion mass is zero, where params and moments stay
    bit-identical. Returns (new_params, opt_state)."""
    applied, opt_state = apply_server_opt(fed, params, state.opt_state,
                                          agg_delta)
    has_mass = mass > 0
    new_params = tree_map(lambda a, p: torch.where(has_mass, a, p),
                          applied, params)
    return new_params, opt_state


def make_spatial_round(model, fed, num_clients: int, device="cuda"):
    """Returns round_step(state, batch, round_idx=0) -> (new_state, stats).

    batch: ``clients`` (tokens / labels / mask, [C, b, S]), ``server``
    ([b, S]), ``priority_mask`` and ``weights`` ([C]); state and batch on
    ``device`` (asking for a missing card raises). Every client trains
    (train-first, as the reference's dense spatial round); the gates drop
    the excluded ones from the aggregation."""
    E = fed.local_epochs
    lr = fed.lr
    check_round_config(fed)
    dev = resolve_device(device)
    agg_needs_key = get_aggregator(fed.aggregator).needs_key
    ef_on = (resolve_wire_codec(fed.wire_codec) != "identity"
             and bool(fed.error_feedback))

    def round_step(state, batch, round_idx=0):
        round_idx = int(round_idx)
        params = state.params
        have = tree_leaves(params)[0].device
        if have.type != dev.type:
            raise ValueError(f"params lie on {have}, the round runs on {dev}")
        client_batch = batch["clients"]
        pm = batch["priority_mask"]
        w = batch["weights"]
        C = pm.shape[0]

        with torch.no_grad():
            server_loss, _ = model.loss_fn(params, batch["server"])
        akey = aggregator_key(fed, round_idx) if agg_needs_key else None

        stacked = tree_map(lambda p: p.new_empty((C,) + tuple(p.shape)),
                           params)
        losses = []
        for c in range(C):
            cb = {k: v[c] for k, v in client_batch.items()}
            _, loss0 = _local_steps(model, params, cb, lr, E,
                                    out=tree_map(lambda s: s[c], stacked))
            losses.append(loss0)
        local_losses = torch.stack(losses)

        with torch.no_grad():
            util_ema = engine.utility_update(fed, state.util_ema,
                                             local_losses, server_loss)
            gates = engine.compute_gates(
                _gate_ctx(fed, state, util_ema, local_losses, server_loss,
                          pm, w, round_idx=round_idx), fed.selection)
            ef_accum = None
            if ef_on:
                agg_delta, ef_accum = engine.server_delta(
                    fed, params, stacked, w, gates, key=akey,
                    ef_accum=state.ef_accum)
            else:
                agg_delta = engine.server_delta(fed, params, stacked, w,
                                                gates, key=akey)
            del stacked
            new_params, opt_state = _apply_delta(
                fed, state, params, agg_delta, inclusion_mass(fed, w, gates))
            new_state = _next_state(fed, state, new_params, opt_state, gates,
                                    util_ema, ef_accum=ef_accum)
            npri = 1.0 - pm.float()
            stats = {
                "server_loss": server_loss,
                "local_losses": local_losses,
                "gates": gates,
                "backlog": new_state.backlog,
                "theta_round": 1.0 / (1.0 + torch.sum(npri * w * gates)),
            }
        return new_state, stats

    return round_step


def make_round_step(model, fed, num_clients: int, *, fsdp: bool,
                    device="cuda"):
    if fsdp:
        raise NotImplementedError(
            "the temporal (FSDP) round is not ported yet (ROADMAP A17); use "
            "fsdp=False")
    return make_spatial_round(model, fed, num_clients, device)
