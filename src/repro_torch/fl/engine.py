"""Federation round engine: client selection + execution backends.

Counterpart of ``repro/fl/engine.py``, synchronous dense slice. A round
runs, in order:

1. the eval pre-pass: each client's loss and accuracy of the received w_t;
2. the eps-band inclusion gates of the configured SelectionStrategy
   (``fedalign``, ``all``, ``priority_only``), warm-up and the straggler
   cadence applied on top;
3. E epochs of minibatch SGD (or FedProx) per client;
4. one fused gated aggregation of the client deltas (one ``fedagg`` kernel
   launch on the card);
5. the server optimizer step (sgd), skipped bit-exactly on a round with
   zero inclusion mass.

Two backends execute the client axis:

* ``vmap_spatial`` — all clients in parallel: each SGD step is one
  ``torch.func.vmap`` of ``torch.func.grad`` over the client axis, with
  per-client parameters;
* ``scan_temporal`` — a client loop that skips gated-out clients (their
  slot returns the unmodified global params, which the aggregation drops).

Both give the same gates and the same per-round computation. The PRNG
chain is the reference's, key for key (``repro_torch.prng``), so every
client trains on the same minibatches as in the JAX package; the
``[C, E, steps, bs]`` minibatch permutations are computed up front on the
data's device and handed to the solver.

Knobs outside this slice (the other strategies, ``scan_async``, partial
participation, cohorts, candidate pools, failure models, the latency clock
and the divergence guard) raise ``NotImplementedError`` naming the knob.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.func import grad, vmap

from repro_torch import prng
from repro_torch.configs.base import register_validator, validate_config
from repro_torch.core.aggregation import (aggregate_delta, apply_server_opt,
                                          inclusion_mass, server_optimizer)
from repro_torch.core.alignment import epsilon_at, global_loss_from_locals
from repro_torch.optim.schedules import make_schedule
from repro_torch.utils import Registry, tree_axpy, tree_map

BACKENDS = ("vmap_spatial", "scan_temporal", "scan_async")


# ============================================================ federation state
@dataclass
class FederationState:
    """Everything FedALIGN carries across the round boundary.

    * ``params`` — global model parameters w_t (dict of tensors).
    * ``opt_state`` — server-optimizer moments (``()`` for sgd).
    * ``backlog`` — [C] int32 rounds each client was dropped by cohort
      overflow (always 0 here: cohorts are not ported).
    * ``util_ema`` — [C] f32 EMA of the alignment gap |F_k - F|.
    * ``incl_ema`` — [C] f32 EMA of the effective inclusion gates.

    The reference's async buffer, drift sketch, latency, skip counter and
    error-feedback leaves belong to features this slice does not port;
    they stay ``()``, as they do in the reference when disabled.
    """
    params: Any
    opt_state: Any
    backlog: Any
    util_ema: Any
    incl_ema: Any
    inflight: Any = ()
    last_delta: Any = ()
    latency: Any = ()
    nonfinite_skips: Any = ()
    ef_accum: Any = ()

    def replace(self, **kw) -> "FederationState":
        return dataclasses.replace(self, **kw)


def _not_ported(knob: str, value, hint: str):
    raise NotImplementedError(
        f"FedConfig.{knob}={value!r} is not ported yet ({hint})")


@register_validator("async")
def check_async_config(fed):
    """The scan_async pipeline is not ported."""
    if fed.backend == "scan_async":
        _not_ported("backend", fed.backend,
                    "use vmap_spatial or scan_temporal")
    if fed.async_depth > 0:
        _not_ported("async_depth", fed.async_depth, "use 0")


@register_validator("clock")
def check_clock_config(fed):
    """The event clock, deadlines, failure models and the divergence guard
    are not ported."""
    if fed.latency_mode not in ("none", "lognormal"):
        raise ValueError(f"unknown FedConfig.latency_mode {fed.latency_mode!r}; "
                         "known: 'none' | 'lognormal'")
    if fed.latency_mode != "none":
        _not_ported("latency_mode", fed.latency_mode, "use 'none'")
    if float(fed.round_deadline) != float("inf"):
        _not_ported("round_deadline", fed.round_deadline, "use inf")
    if fed.failure_model not in (None, "", "none"):
        _not_ported("failure_model", fed.failure_model, "use 'none'")
    if fed.divergence_guard:
        _not_ported("divergence_guard", True, "use False")


@register_validator("selection")
def check_selection_config(fed):
    """Strategy names, partial participation and the training cohort."""
    get_strategy(fed.selection)
    if fed.participation < 1.0:
        _not_ported("participation", fed.participation, "use 1.0")
    if fed.max_cohort > 0:
        _not_ported("max_cohort", fed.max_cohort, "use 0")
    if fed.algorithm not in ("fedavg", "fedprox"):
        raise ValueError(f"unknown FedConfig.algorithm {fed.algorithm!r}")


def init_state(params, fed, num_clients: Optional[int] = None) -> FederationState:
    """Fresh FederationState for a federation of ``num_clients`` (defaults
    to ``fed.num_clients``), on the device of ``params``."""
    validate_config(fed)
    C = int(num_clients if num_clients is not None else fed.num_clients)
    dev = next(iter(params.values())).device
    return FederationState(
        params=params,
        opt_state=server_optimizer(fed).init(params),
        backlog=torch.zeros(C, dtype=torch.int32, device=dev),
        util_ema=torch.zeros(C, dtype=torch.float32, device=dev),
        incl_ema=torch.zeros(C, dtype=torch.float32, device=dev))


# ============================================================ selection seam
@dataclass
class SelectionContext:
    """Everything a SelectionStrategy may look at for one round (fields as
    in the reference; ``delta_cos`` and the welfare fields are unused by
    the ported strategies)."""
    align_vals: Any                    # [C] F_k(w_t) (or acc_k(w_t))
    global_align: Any                  # scalar F(w_t)
    eps: Any                           # scalar eps_t
    priority_mask: Any                 # [C] bool
    weights: Any = None                # [C] data fractions p_k
    participation: Any = None          # [C] bool availability, or None
    warmup: Any = False                # bool: inside warm-up rounds
    delta_cos: Any = None
    topk: int = 4
    sim_threshold: float = 0.0
    backlog: Any = None
    util_ema: Any = None
    incl_ema: Any = None
    welfare_floor: float = 0.0


STRATEGIES = Registry("selection strategy")
_UNPORTED_STRATEGIES = ("topk_align", "grad_sim", "welfare")


def register_strategy(name: str, *, needs_deltas: bool = False,
                      warmup_excludes_nonpriority: bool = True):
    """Register ``fn(ctx) -> [C] float32`` (non-priority inclusion)."""
    return STRATEGIES.register(
        name, strategy_name=name, needs_deltas=needs_deltas,
        warmup_excludes_nonpriority=warmup_excludes_nonpriority)


def get_strategy(name: str) -> Callable:
    if name in _UNPORTED_STRATEGIES:
        _not_ported("selection", name, f"ported: {STRATEGIES.names()}")
    return STRATEGIES.lookup(name)


@register_strategy("fedalign")
def _fedalign(ctx):
    return (torch.abs(ctx.align_vals - ctx.global_align) < ctx.eps).float()


@register_strategy("all", warmup_excludes_nonpriority=False)
def _all(ctx):
    return torch.ones(ctx.priority_mask.shape, dtype=torch.float32,
                      device=ctx.priority_mask.device)


@register_strategy("priority_only")
def _priority_only(ctx):
    return torch.zeros(ctx.priority_mask.shape, dtype=torch.float32,
                       device=ctx.priority_mask.device)


def compute_gates(ctx: SelectionContext, selection: str = "fedalign"):
    """I_{k,t} per client: priority clients always in, the strategy decides
    the rest; warm-up (strategy-dependent) and participation on top."""
    strat = get_strategy(selection)
    pri = ctx.priority_mask.float()
    gates = pri + (1.0 - pri) * strat(ctx)
    if strat.warmup_excludes_nonpriority:
        warm = torch.as_tensor(ctx.warmup, device=pri.device)
        gates = torch.where(warm, pri, gates)
    if ctx.participation is not None:
        gates = gates * ctx.participation.float()
    return gates


def backlog_update(backlog, gates, eff_gates):
    """Overflow-fairness ledger: +1 for a client that gated in but lost its
    slot, reset for clients the aggregation honoured."""
    dropped = (gates > 0) & (eff_gates == 0)
    included = eff_gates > 0
    return torch.where(dropped, backlog + 1,
                       torch.where(included, torch.zeros_like(backlog), backlog))


def utility_update(fed, util_ema, align_vals, global_align):
    """Loss-gap EMA step (decay ``fed.utility_ema``), raw (zero-init)."""
    beta = torch.tensor(fed.utility_ema, dtype=torch.float32)
    gap = torch.abs(align_vals - global_align).float()
    return beta * util_ema + (1.0 - beta) * gap


def utility_estimate(fed, util_ema, round_idx):
    """Bias-corrected smoothed gap (adam-style 1 - beta^t divisor)."""
    beta = torch.tensor(fed.utility_ema, dtype=torch.float32)
    t = torch.tensor(round_idx, dtype=torch.float32) + 1.0
    return util_ema / torch.clamp(1.0 - beta ** t, min=1e-12)


def inclusion_update(fed, incl_ema, eff_gates):
    """Inclusion-history EMA step over the effective gates."""
    beta = torch.tensor(fed.utility_ema, dtype=torch.float32)
    return beta * incl_ema + (1.0 - beta) * eff_gates.float()


def server_delta(fed, global_params, client_params, weights, gates, *,
                 key=None, ef_accum=None):
    """Renormalized gated delta aggregation (one fused fedagg launch),
    without the server optimizer step."""
    return aggregate_delta(global_params, client_params, weights, gates,
                           fed=fed, key=key, ef_accum=ef_accum)


def participation_mask(fed, key, priority_mask, round_idx, client_ids=None):
    """Paper App. A.4 straggler cadence: non-priority client k joins every
    2 + k % period rounds. Bernoulli sampling (``participation < 1``) and
    pool identities are not ported."""
    if fed.participation < 1.0:
        _not_ported("participation", fed.participation, "use 1.0")
    if client_ids is not None:
        _not_ported("candidate_pool", fed.candidate_pool, "use 0")
    C = priority_mask.shape[0]
    part = torch.ones(C, dtype=torch.bool, device=priority_mask.device)
    if fed.straggler_period > 0:
        ids = torch.arange(C, device=priority_mask.device)
        cadence = 2 + ids % fed.straggler_period
        available = (round_idx % cadence) == 0
        part = part & (available | priority_mask)
    return part


# ============================================================ local training
def minibatch_order(fed, keys, n: int) -> torch.Tensor:
    """The local solver's minibatch indices for a batch of client keys:
    ``[K, 2]`` -> ``[K, E, steps, bs]`` int64, on the keys' device.

    Epoch e of client k visits ``permutation(split(key_k, E)[e], n)``
    truncated to ``steps * bs`` and cut into ``steps`` minibatches — the
    reference's ``local_solver`` order, key for key."""
    E = fed.local_epochs
    bs = min(fed.batch_size, n)
    steps = n // bs
    perm = prng.permutation(prng.split(keys, E), n)          # [K, E, n]
    return perm[..., :steps * bs].reshape(keys.shape[0], E, steps, bs)


def local_solver(loss_fn, fed):
    """Returns f(global_params, data, order, lr) -> local params of K
    clients after E epochs of minibatch SGD (FedProx when
    ``fed.algorithm == 'fedprox'``). ``data`` leaves are [K, n, ...],
    ``order`` is ``minibatch_order``'s [K, E, steps, bs]; the result has
    params-shaped leaves with a leading [K] axis. Each step is one vmapped
    gradient over the K clients."""
    prox_mu = fed.prox_mu if fed.algorithm == "fedprox" else 0.0
    batch_grad = vmap(grad(lambda p, b: loss_fn(p, b)[0]))

    def solve(global_params, data, order, lr):
        K, E, steps, _ = order.shape
        rows = torch.arange(K, device=order.device)[:, None]
        params = tree_map(lambda p: p.expand((K,) + p.shape).clone(),
                          global_params)
        for e in range(E):
            for s in range(steps):
                idx = order[:, e, s]                             # [K, bs]
                batch = {k: v[rows, idx] for k, v in data.items()}
                grads = batch_grad(params, batch)
                if prox_mu > 0.0:
                    grads = tree_map(lambda g, q, w0: g + prox_mu * (q - w0),
                                     grads, params, global_params)
                params = tree_axpy(-lr, grads, params)
        return params

    return solve


# ============================================================ backend seam
def _eval_vmap(loss_fn, params, data):
    return vmap(lambda d: loss_fn(params, d))(data)


def _eval_scan(loss_fn, params, data):
    C = next(iter(data.values())).shape[0]
    outs = [loss_fn(params, {k: v[c] for k, v in data.items()})
            for c in range(C)]
    losses = torch.stack([o[0] for o in outs])
    metrics = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
    return losses, metrics


def _train_vmap(solver, global_params, data, order, lr, gates=None):
    # every client trains; gated-out rows are dropped by the aggregation
    return solver(global_params, data, order, lr)


def _train_scan(solver, global_params, data, order, lr, gates=None):
    """Client by client. With ``gates`` (known before training), gated-out
    clients skip their E local epochs; their slot returns the unmodified
    global params, which the aggregation drops at gate 0."""
    C = order.shape[0]
    skip = [False] * C if gates is None else (gates <= 0).tolist()
    slots = []
    for c in range(C):
        if skip[c]:
            slots.append(tree_map(lambda p: p[None], global_params))
        else:
            slots.append(solver(global_params,
                                {k: v[c:c + 1] for k, v in data.items()},
                                order[c:c + 1], lr))
    return tree_map(lambda *xs: torch.cat(xs), *slots)


_BACKENDS = {
    "vmap_spatial": (_eval_vmap, _train_vmap),
    "scan_temporal": (_eval_scan, _train_scan),
}


# ============================================================ the round
def make_round_fn(loss_fn: Callable, fed, *,
                  backend: Optional[str] = None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics); batch = {'x','y'}.

    Returns round_fn(state, data, priority_mask, weights, rng, round_idx)
    -> (new_state, stats), with ``state`` a FederationState (``init_state``),
    ``data`` leaves [C, n, ...] on the round's device, ``rng`` a
    ``repro_torch.prng`` key and ``round_idx`` a python int. The stats keys
    are the reference's. The reference's ``delta_transform`` seam (attack
    injection for benchmarks) is not ported."""
    backend = backend or fed.backend
    if backend == "scan_async":
        _not_ported("backend", backend, "use vmap_spatial or scan_temporal")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    validate_config(fed)
    eval_clients, train_clients = _BACKENDS[backend]
    solver = local_solver(loss_fn, fed)
    sched = make_schedule(fed)
    warmup_rounds = int(fed.warmup_frac * fed.rounds)

    @torch.no_grad()
    def round_fn(state: FederationState, data, priority_mask, weights, rng,
                 round_idx):
        round_idx = int(round_idx)
        global_params = state.params
        C = priority_mask.shape[0]
        n = data["y"].shape[1]
        dev = priority_mask.device
        lr = sched(round_idx)
        eps = epsilon_at(fed, round_idx)

        # (1) local loss / accuracy of the received model; the paper's
        # experiments match ACCURACIES (fed.align_stat), the theory losses
        local_losses, local_metrics = eval_clients(loss_fn, global_params, data)
        if fed.align_stat == "accuracy" and "acc" in local_metrics:
            align_vals = local_metrics["acc"]
        else:
            align_vals = local_losses
        g_loss = global_loss_from_locals(local_losses, priority_mask, weights)
        g_align = global_loss_from_locals(align_vals, priority_mask, weights)
        util_ema = utility_update(fed, state.util_ema, align_vals, g_align)

        # the reference's key chain: participation key, then local keys
        rng, pkey = prng.split(rng)
        part = participation_mask(fed, pkey, priority_mask, round_idx)
        warm = round_idx < warmup_rounds
        rng, lkey = prng.split(rng)
        lkeys = prng.split(lkey, C).to(dev)

        # (2) gates first: every ported strategy gates from the eval pre-pass
        ctx = SelectionContext(
            align_vals=align_vals, global_align=g_align, eps=eps,
            priority_mask=priority_mask, weights=weights, participation=part,
            warmup=warm, topk=fed.topk, sim_threshold=fed.sim_threshold,
            backlog=state.backlog,
            util_ema=utility_estimate(fed, util_ema, round_idx),
            incl_ema=state.incl_ema, welfare_floor=fed.welfare_floor)
        gates = compute_gates(ctx, fed.selection)

        # (3) local training; the scan backend skips gated-out clients
        order = minibatch_order(fed, lkeys, n)
        client_params = train_clients(solver, global_params, data, order, lr,
                                      gates=gates)

        # (4) one fused fedagg launch; (5) the server step, skipped on a
        # zero-inclusion round so params stay bit-identical
        agg_delta = server_delta(fed, global_params, client_params, weights,
                                 gates)
        applied, opt_state = apply_server_opt(fed, global_params,
                                              state.opt_state, agg_delta)
        has_mass = inclusion_mass(fed, weights, gates) > 0
        new_global = tree_map(lambda a, b: torch.where(has_mass, a, b),
                              applied, global_params)

        backlog = backlog_update(state.backlog, gates, gates)
        incl_ema = inclusion_update(fed, state.incl_ema, gates)
        new_state = state.replace(params=new_global, opt_state=opt_state,
                                  backlog=backlog, util_ema=util_ema,
                                  incl_ema=incl_ema)

        npri = 1.0 - priority_mask.float()
        included_mass = torch.sum(npri * weights * gates)
        stats = {
            "round": torch.tensor(round_idx, dtype=torch.int32),
            "lr": lr,
            "eps": eps,
            "global_loss": g_loss,
            "local_losses": local_losses,
            "gates": gates,
            "backlog": backlog,
            "theta_round": 1.0 / (1.0 + included_mass),   # paper eq. (7) term
            "included_nonpriority": torch.sum(npri * gates),
            "warmup": torch.tensor(int(warm), dtype=torch.int32),
        }
        return new_state, stats

    return round_fn
