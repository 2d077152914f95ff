"""Federation round engine: client selection + execution backends.

Counterpart of ``repro/fl/engine.py``. A round runs, in order:

1. the eval pre-pass: each client's loss and accuracy of the received w_t;
2. participation sampling (a Bernoulli draw of ``fed.participation``, the
   priority set never empty) and the straggler cadence;
3. the inclusion gates of the configured SelectionStrategy (``fedalign``,
   ``all``, ``priority_only``, ``topk_align``, ``welfare``, ``grad_sim``),
   warm-up and participation applied on top;
4. E epochs of minibatch SGD (or FedProx) per client;
5. one fused gated aggregation of the client deltas (one ``fedagg`` kernel
   launch on the card) under the configured aggregator (mean,
   trimmed_mean, median, dp, cosine_filter) and wire codec (identity,
   int8, topk, sketch, with error-feedback rows);
6. the server optimizer step (sgd, momentum, adam, yogi), skipped
   bit-exactly on a round with zero inclusion mass (the aggregator's own
   mass) or, under the divergence guard, a non-finite aggregate: params
   and optimizer moments stay as they were. Under ``scan_async`` the
   aggregate enters the in-flight buffer instead, and the slots it pops
   are applied.

The order of (3) and (4) depends on the strategy, as in the reference.
Strategies that gate from the eval pre-pass gate first; with
``fed.max_cohort = K > 0`` only the K clients ``cohort_select`` gathers
train (backlog-aware overflow), their rows aggregated in cohort space.
``grad_sim`` (``needs_deltas``) trains every client first and gates on
the cosine of each client delta to the priority mean delta (exact, or on
CountSketches under ``fed.grad_sim_sketch``); it ignores ``max_cohort``.

Three backends execute the client axis:

* ``vmap_spatial`` — all clients in parallel: each SGD step is one
  ``torch.func.vmap`` of ``torch.func.grad`` over the client axis, with
  per-client parameters;
* ``scan_temporal`` — a client loop that skips gated-out clients (their
  slot returns the unmodified global params, which the aggregation drops);
* ``scan_async`` — clients scheduled as ``vmap_spatial``, but with
  ``fed.async_depth = D > 0`` the round's aggregated delta enters the
  in-flight buffer (``FederationState.inflight``) instead of the params
  and lands when the ``fed.async_mode`` pop policy says so
  (``async_apply``: "fifo", exactly D rounds late; "ready", every slot
  aged ``min_lag`` or more, oldest first; under the event clock, every
  slot whose countdown expired), scaled by its staleness discount (times
  the drift cosine under ``adaptive_staleness``). At D = 0 it is
  ``vmap_spatial``, bit for bit.

The synchronous backends give the same gates and the same per-round
computation. The PRNG chain is the reference's, key for key
(``repro_torch.prng``), so every client trains on the same minibatches as
in the JAX package; the ``[C, E, steps, bs]`` minibatch permutations are
computed up front on the data's device and handed to the solver.

The fault layer models real clients. A registered failure model
(``none``, ``crash``, ``dropout``, ``corrupt``, ``chaos``) draws each
round's ``FailurePlan`` from its own named PRNG stream: drop-outs fold
into participation, crashed and deadline-late clients (the lognormal
event clock, ``fed.latency_mode``) train but lose their aggregation mass
(``lost_mask``), and corrupted clients' trained params are NaN'd or
scaled through the ``delta_transform`` seam. The divergence guard
(``fed.divergence_guard``) keeps a non-finite aggregate off the params
and the optimizer moments and counts consecutive skips.

Candidate pools (``fed.candidate_pool = P``, 0 < P < C) decouple the
population from the round's cost: ``pool_select`` draws P clients a
round (priority always in, the rest by Gumbel-top-k under
``fed.pool_weighting``), the round runs on the [P] gather of the data and
of the per-client state leaves, and scatters them back at the pool's
indices; an out-of-pool client's rows stay bit-identical. Inside a pool
round every per-client draw (participation, the failure models, the local
training keys) is keyed on the client's identity with ``fold_in``, so it
does not depend on which pool the client landed in. P = 0 and P >= C run
the dense round unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.func import grad, vmap

from repro_torch import prng
from repro_torch.configs.base import register_validator, validate_config
from repro_torch.core.aggregation import (_AGG_DTYPES, aggregate_delta,
                                          aggregator_key,
                                          apply_server_opt, flatten_stacked,
                                          get_aggregator, inclusion_mass,
                                          resolve_wire_codec,
                                          server_optimizer)
from repro_torch.core.alignment import epsilon_at, global_loss_from_locals
from repro_torch.optim.schedules import make_schedule
from repro_torch.utils import (Registry, fold_in_name, tree_axpy,
                               tree_leaves, tree_map)

BACKENDS = ("vmap_spatial", "scan_temporal", "scan_async")


# ============================================================ federation state
@dataclass
class FederationState:
    """Everything FedALIGN carries across the round boundary.

    * ``params`` — global model parameters w_t (dict of tensors).
    * ``opt_state`` — server-optimizer moments (``()`` for sgd).
    * ``backlog`` — [C] int32 rounds each client was dropped by
      ``max_cohort`` overflow since it last aggregated; wins cohort ties.
    * ``util_ema`` — [C] f32 EMA of the alignment gap |F_k - F|.
    * ``incl_ema`` — [C] f32 EMA of the effective inclusion gates.
    * ``inflight`` — the ``scan_async`` buffer of D = ``fed.async_depth``
      slots, or ``()`` at depth 0: ``delta`` (params-shaped leaves with a
      leading [D] axis in ``fed.agg_dtype``, oldest at 0), ``valid`` ([D]
      f32, a prefix), ``age`` ([D] int32 rounds waited) and, under the
      event clock, ``timer`` ([D] int32 countdown, set at push by
      ``slot_timer``). ``async_apply`` updates the buffer in place.
    * ``last_delta`` — [``fed.sketch_dim``] f32 CountSketch of the last
      delta that landed (``adaptive_staleness``), else ``()``.
    * ``latency`` — the event clock's ``{"compute", "net"}`` [C] f32
      completion times in round units, drawn once (``init_latency``), or
      ``()`` when ``fed.latency_mode == "none"``.
    * ``nonfinite_skips`` — 0-d int32 count of consecutive rounds the
      divergence guard skipped, or ``()`` when the guard is off.
    * ``ef_accum`` — the wire codec's per-client error-feedback rows
      (params-shaped f32 leaves with a leading [C] axis), or ``()`` when the
      codec is identity or ``error_feedback`` is off.

    Disabled features keep their leaves ``()``, as in the reference.
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


@register_validator("async")
def check_async_config(fed):
    """The scan_async knobs whose bad values would corrupt the in-flight
    buffer silently, with the reference's errors."""
    if fed.async_depth <= 0:
        return
    if fed.async_mode not in ("fifo", "ready"):
        raise ValueError(f"unknown FedConfig.async_mode {fed.async_mode!r}; "
                         "known: 'fifo' (fixed-lag pipe) | 'ready' "
                         "(variable-lag readiness buffer)")
    if fed.async_mode == "ready" and not 1 <= fed.min_lag <= fed.async_depth:
        raise ValueError(
            f"FedConfig.min_lag={fed.min_lag} outside [1, async_depth="
            f"{fed.async_depth}]: a delta can never age past the buffer "
            "capacity (no slot would ever become ready), and it can never "
            "pop before its first birthday either — the push happens after "
            "the pop phase, so min_lag=0 would silently behave as 1")


@register_validator("clock")
def check_clock_config(fed):
    """The event-clock, deadline, failure-model and guard knobs, with the
    reference's errors: a non-positive deadline, a deadline without a
    clock, a clock over the fifo pipe, rates outside [0, 1], windows
    shorter than a round, a negative skip budget."""
    lm = fed.latency_mode
    if lm not in ("none", "lognormal"):
        raise ValueError(f"unknown FedConfig.latency_mode {lm!r}; known: "
                         "'none' (no event clock) | 'lognormal' "
                         "(per-client compute + network time draws)")
    if lm != "none":
        if fed.latency_sigma < 0 or fed.latency_net_sigma < 0:
            raise ValueError(
                f"FedConfig.latency_sigma={fed.latency_sigma} / "
                f"latency_net_sigma={fed.latency_net_sigma} must be >= 0 "
                "(they are lognormal log-stds)")
        if fed.async_depth > 0 and fed.async_mode != "ready":
            raise ValueError(
                "the event-driven clock gives every in-flight slot its OWN "
                "countdown (variable lag); async_mode='fifo' constant-folds "
                f"a fixed lag of async_depth={fed.async_depth} rounds and "
                "would ignore the timers — use async_mode='ready'")
    deadline = float(fed.round_deadline)
    if deadline != float("inf"):
        if not deadline > 0:
            raise ValueError(
                f"FedConfig.round_deadline={fed.round_deadline} must be > 0 "
                "(round units): at a zero or negative deadline EVERY client "
                "is late, so every slot would force-land with no finished "
                "members' mass — disable the deadline with float('inf')")
        if lm == "none":
            raise ValueError(
                "FedConfig.round_deadline compares per-client simulated "
                "completion times against the deadline, but "
                "latency_mode='none' draws no completion times — set "
                "latency_mode='lognormal' (or leave round_deadline=inf)")
    name = resolve_failure_model(fed.failure_model)
    if name != "none":
        get_failure_model(name)            # unknown names raise here
        for knob in ("crash_rate", "dropout_rate", "corrupt_rate"):
            v = float(getattr(fed, knob))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FedConfig.{knob}={v} outside [0, 1] "
                                 "(a per-client probability)")
        if int(fed.dropout_len) < 1:
            raise ValueError(
                f"FedConfig.dropout_len={fed.dropout_len} must be >= 1 "
                "(rounds per transient drop-out window)")
    if int(fed.max_nonfinite_skips) < 0:
        raise ValueError(
            f"FedConfig.max_nonfinite_skips={fed.max_nonfinite_skips} must "
            "be >= 0 (0 = the divergence guard never halts the run)")


@register_validator("selection")
def check_selection_config(fed):
    """Strategy and algorithm names. ``participation`` and ``max_cohort``
    take any value, as in the reference: a rate >= 1 samples everyone and
    a budget <= 0 disables the cohort."""
    get_strategy(fed.selection)
    if fed.algorithm not in ("fedavg", "fedprox"):
        raise ValueError(f"unknown FedConfig.algorithm {fed.algorithm!r}")


def init_ef_accum(params, fed, num_clients):
    """Zero per-client error-feedback rows for the wire codec
    (params-shaped f32 leaves with a leading [C] axis), or ``()`` when the
    codec is identity or ``fed.error_feedback`` is off."""
    if resolve_wire_codec(fed.wire_codec) == "identity" or not fed.error_feedback:
        return ()
    C = int(num_clients)
    return tree_map(lambda p: torch.zeros((C,) + tuple(p.shape),
                                          dtype=torch.float32, device=p.device),
                    params)


def init_latency(fed, num_clients, device="cpu"):
    """The event clock's per-client completion times, or ``()`` when
    ``fed.latency_mode == "none"``: lognormal compute plus lognormal
    network time in round units, drawn once from
    ``fold_in_name(PRNGKey(seed), "latency_model")`` (the round's key
    chain is untouched)."""
    if fed.latency_mode == "none":
        return ()
    key = fold_in_name(prng.PRNGKey(fed.seed), "latency_model")
    kc, kn = prng.split(key)
    C = int(num_clients)
    compute = torch.exp(fed.latency_mu + fed.latency_sigma
                        * prng.normal(kc, (C,)))
    net = torch.exp(fed.latency_net_mu + fed.latency_net_sigma
                    * prng.normal(kn, (C,)))
    return {"compute": compute.to(device), "net": net.to(device)}


def init_inflight(params, fed):
    """The empty in-flight buffer of ``fed.async_depth`` (D) slots, or
    ``()`` at depth 0, on the params' device: ``delta`` [D, ...] in
    ``fed.agg_dtype``, ``valid`` and ``age``, and ``timer`` under the
    event clock."""
    D = int(fed.async_depth)
    if D <= 0:
        return ()
    ad = _AGG_DTYPES[fed.agg_dtype]
    dev = tree_leaves(params)[0].device
    buf = {
        "delta": tree_map(lambda p: torch.zeros((D,) + tuple(p.shape),
                                                dtype=ad, device=p.device),
                          params),
        "valid": torch.zeros(D, dtype=torch.float32, device=dev),
        "age": torch.zeros(D, dtype=torch.int32, device=dev),
    }
    if fed.latency_mode != "none":
        buf["timer"] = torch.zeros(D, dtype=torch.int32, device=dev)
    return buf


def init_last_delta(fed, device="cpu"):
    """The zero drift-reference sketch under ``adaptive_staleness`` (with a
    buffer), else ``()``."""
    if fed.async_depth > 0 and fed.adaptive_staleness:
        return torch.zeros(int(fed.sketch_dim), dtype=torch.float32,
                           device=device)
    return ()


def init_state(params, fed, num_clients: Optional[int] = None) -> FederationState:
    """Fresh FederationState for a federation of ``num_clients`` (defaults
    to ``fed.num_clients``), on the device of ``params``: zero moments,
    backlog and EMAs; the in-flight buffer, drift sketch, latency draws,
    skip counter and error-feedback rows only where their feature is on."""
    validate_config(fed)
    C = int(num_clients if num_clients is not None else fed.num_clients)
    dev = tree_leaves(params)[0].device
    return FederationState(
        params=params,
        opt_state=server_optimizer(fed).init(params),
        backlog=torch.zeros(C, dtype=torch.int32, device=dev),
        util_ema=torch.zeros(C, dtype=torch.float32, device=dev),
        incl_ema=torch.zeros(C, dtype=torch.float32, device=dev),
        inflight=init_inflight(params, fed),
        last_delta=init_last_delta(fed, dev),
        latency=init_latency(fed, C, dev),
        nonfinite_skips=(torch.zeros((), dtype=torch.int32, device=dev)
                         if fed.divergence_guard else ()),
        ef_accum=init_ef_accum(params, fed, C))


# ============================================================ selection seam
@dataclass
class SelectionContext:
    """Everything a SelectionStrategy may look at for one round (fields as
    in the reference). ``delta_cos`` is filled only for a ``needs_deltas``
    strategy; ``util_ema`` is the bias-corrected smoothed gap with this
    round's observation folded in, ``incl_ema`` and ``backlog`` describe
    the previous rounds."""
    align_vals: Any                    # [C] F_k(w_t) (or acc_k(w_t))
    global_align: Any                  # scalar F(w_t)
    eps: Any                           # scalar eps_t
    priority_mask: Any                 # [C] bool
    weights: Any = None                # [C] data fractions p_k
    participation: Any = None          # [C] bool availability, or None
    warmup: Any = False                # bool: inside warm-up rounds
    delta_cos: Any = None              # [C] cosine(delta_k, delta_P)
    topk: int = 4
    sim_threshold: float = 0.0
    backlog: Any = None
    util_ema: Any = None
    incl_ema: Any = None
    welfare_floor: float = 0.0


STRATEGIES = Registry("selection strategy")


def register_strategy(name: str, *, needs_deltas: bool = False,
                      warmup_excludes_nonpriority: bool = True):
    """Register ``fn(ctx) -> [C] float32`` (non-priority inclusion)."""
    return STRATEGIES.register(
        name, strategy_name=name, needs_deltas=needs_deltas,
        warmup_excludes_nonpriority=warmup_excludes_nonpriority)


def get_strategy(name: str) -> Callable:
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


@register_strategy("topk_align")
def _topk_align(ctx):
    """The k best-matched available non-priority clients, each also inside
    the eps band (ties at the k-th gap all get in)."""
    C = ctx.align_vals.shape[0]
    k = int(ctx.topk)
    if k <= 0:
        return torch.zeros(C, dtype=torch.float32,
                           device=ctx.align_vals.device)
    diff = torch.abs(ctx.align_vals - ctx.global_align)
    cand = ~ctx.priority_mask.bool()
    if ctx.participation is not None:
        cand = cand & ctx.participation.bool()
    ranked = torch.where(cand, diff, torch.full_like(diff, float("inf")))
    kth = torch.sort(ranked).values[min(k, C) - 1]
    return ((ranked <= kth) & (ranked < ctx.eps)).float()


@register_strategy("grad_sim", needs_deltas=True)
def _grad_sim(ctx):
    if ctx.delta_cos is None:
        raise ValueError("grad_sim needs ctx.delta_cos (client-update cosine "
                         "similarities); this backend did not provide deltas")
    return (ctx.delta_cos >= ctx.sim_threshold).float()


@register_strategy("welfare")
def _welfare(ctx):
    """Welfare / fairness-aware selection (Travadi et al.,
    arXiv:2302.08976): a non-priority client is in when its smoothed
    alignment gap is inside the eps band, or when its inclusion EMA has
    starved below the fairness floor."""
    if ctx.util_ema is None or ctx.incl_ema is None:
        raise ValueError(
            "welfare needs ctx.util_ema/ctx.incl_ema (cross-round client "
            "utility EMAs from FederationState); this caller is stateless — "
            "thread a FederationState through the round")
    aligned = ctx.util_ema < ctx.eps
    starved = ctx.incl_ema < ctx.welfare_floor
    return (aligned | starved).float()


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


def cosine_to_priority(flat_deltas, weights, priority_mask):
    """[C, M] client deltas -> [C] cosine to the priority-weighted mean
    delta (the grad_sim statistic), accumulated in f32."""
    f = flat_deltas.float()
    wp = weights.float() * priority_mask.float()
    d_pri = torch.einsum("c,cm->m", wp, f) / torch.clamp(torch.sum(wp),
                                                         min=1e-30)
    dots = f @ d_pri
    norms = (torch.sqrt(torch.sum(f * f, dim=1))
             * torch.sqrt(torch.sum(d_pri * d_pri)))
    return dots / torch.clamp(norms, min=1e-12)


def cohort_select(gates, align_vals, global_align, priority_mask, k: int,
                  backlog=None, backlog_boost=0.0):
    """The gate-before-train cohort's gather order.

    Returns (cohort_idx [K], cohort_gates [K], effective_gates [C]). Slots
    fill priority clients first, then the included non-priority clients by
    alignment gap |F_k - F| (with ``backlog_boost`` > 0, by the gap minus
    ``backlog_boost * backlog``), then gated-out clients as zero-gate
    padding; ties go to the longer backlog, then the lower index. When
    more than K clients gate in, the worst-matched non-priority ones drop
    this round. The reference's ``lexsort((arange(C), -backlog, key))`` is
    two stable argsorts, least significant key first."""
    pri = priority_mask.bool()
    C = gates.shape[0]
    dev = gates.device
    diff = torch.abs(align_vals - global_align).float()
    bl = (torch.zeros(C, dtype=torch.float32, device=dev) if backlog is None
          else backlog.float())
    cap = torch.tensor(1e30, dtype=torch.float32, device=dev)
    boost = float(backlog_boost)
    if boost != 0.0:
        # priority pins to -inf: no boosted rank can displace it
        rank = torch.where(pri, torch.tensor(float("-inf"), device=dev),
                           torch.minimum(diff, cap)
                           - torch.tensor(boost, dtype=torch.float32) * bl)
    else:
        rank = torch.where(pri, torch.tensor(-1.0, device=dev),
                           torch.minimum(diff, cap))
    key = torch.where(gates > 0, rank, torch.tensor(float("inf"), device=dev))
    order = torch.argsort(-bl, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    cohort_idx = order[:k]
    cohort_gates = gates[cohort_idx]
    eff_gates = torch.zeros_like(gates)
    eff_gates[cohort_idx] = cohort_gates
    return cohort_idx, cohort_gates, eff_gates


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
                 key=None, ef_accum=None, reduce=None):
    """Renormalized gated delta aggregation (one fused fedagg launch, or
    ``reduce`` in its place), without the server optimizer step."""
    return aggregate_delta(global_params, client_params, weights, gates,
                           fed=fed, key=key, ef_accum=ef_accum,
                           reduce=reduce)


def participation_mask(fed, key, priority_mask, round_idx, client_ids=None):
    """Paper App. C.3 / A.4: Bernoulli participation sampling at rate
    ``fed.participation`` (the priority set never empty: if the draw
    misses every priority client, all of them join), plus the straggler
    cadence (non-priority client k joins every 2 + k % period rounds).
    A dense round's draw is ``jax.random.bernoulli(key, rate, (C,))`` bit
    for bit. ``client_ids`` carries a pool round's [P] global identities:
    each draw is keyed on the identity (``_identity_bernoulli``) and the
    cadence uses the global index, so a client's availability does not
    depend on the pool it landed in."""
    C = priority_mask.shape[0]
    dev = priority_mask.device
    pm = priority_mask.bool()
    if fed.participation < 1.0:
        part = _identity_bernoulli(key, fed.participation, C,
                                   client_ids).to(dev)
        part = part | ((torch.sum(part & pm) == 0) & pm)
    else:
        part = torch.ones(C, dtype=torch.bool, device=dev)
    if fed.straggler_period > 0:
        ids = torch.arange(C, device=dev) if client_ids is None else client_ids
        cadence = 2 + ids % fed.straggler_period
        available = (round_idx % cadence) == 0
        part = part & (available | pm)
    return part


def pool_select(fed, key, priority_mask, backlog, incl_ema, pool: int):
    """One round's candidate pool: [P] sorted global client indices, on
    the mask's device. Priority clients score +inf (always in); the rest
    are drawn without replacement by Gumbel-top-k, score = Gumbel noise
    over [C] (``prng.gumbel``) plus the log of the weight of
    ``fed.pool_weighting``: ``uniform`` 1, ``backlog`` 1 + backlog_k (a
    client starved by cohort overflow comes back sooner), ``ema`` (1 +
    1e-6) - incl_ema_k floored at 1e-6 (a client rarely included gets a
    boost). The top P indices are sorted ascending, so the pool is an
    order-preserving slice of the dense index space."""
    dev = priority_mask.device
    g = prng.gumbel(torch.as_tensor(key).cpu(),
                    (priority_mask.shape[0],)).to(dev)
    if fed.pool_weighting == "backlog":
        g = g + torch.log1p(backlog.float())
    elif fed.pool_weighting == "ema":
        g = g + torch.log(torch.clamp(1.0 + 1e-6 - incl_ema.float(),
                                      min=1e-6))
    score = torch.where(priority_mask.bool(),
                        torch.tensor(float("inf"), device=dev), g)
    return torch.sort(torch.topk(score, int(pool)).indices).values


def sketch_key(fed, round_idx):
    """grad_sim's per-round CountSketch projection key, shared by every
    client and both backends."""
    return prng.fold_in(prng.PRNGKey(fed.seed ^ 0x5E7C), round_idx)


def apply_if_mass(fed, params, opt_state, agg_delta, mass, finite=None):
    """The synchronous server step, ``apply_server_opt``, kept only where
    the round's inclusion mass is positive (and, under the divergence
    guard, ``finite`` holds): on a zero-mass or non-finite round params
    and every optimizer moment (adam's ``t`` too) stay bit-identical
    instead of momentum decaying on an all-zero delta. A ``torch.where``
    per leaf, so the host never waits on the mass. Returns (new_params,
    new_opt_state)."""
    applied, new_opt = apply_server_opt(fed, params, opt_state, agg_delta)
    has_mass = mass > 0
    if finite is not None:
        has_mass = has_mass & finite

    def keep(a, b):
        return torch.where(has_mass, a, b)
    return tree_map(keep, applied, params), tree_map(keep, new_opt, opt_state)


def delta_sketch(deltas, key, dim: int):
    """[C, dim] CountSketches of client-stacked parameter deltas ([C, ...]
    leaves): every coordinate lands in one random bucket with a random
    sign, the hash and sign of leaf i drawn from ``split(fold_in(key, i))``
    (the reference's streams), so every client is projected identically
    and sketched cosines estimate the true delta cosines."""
    leaves = tree_leaves(deltas)
    dev = leaves[0].device
    C = leaves[0].shape[0]
    out = torch.zeros(C, dim, dtype=torch.float32, device=dev)
    key = torch.as_tensor(key).to(dev)
    for i, leaf in enumerate(leaves):
        x = leaf.reshape(C, -1).float()
        kh, ks = prng.split(prng.fold_in(key, i))
        h = prng.randint(kh, (x.shape[1],), 0, dim)
        s = prng.rademacher(ks, (x.shape[1],))
        out.index_add_(1, h.long(), s * x)
    return out


# ============================================================ async buffer
def staleness_discount(fed, age=None):
    """The scale of a delta that waited in the buffer: under fifo
    (``age=None``) the python constant ``staleness_decay ** async_depth``,
    under ready the f32 ``staleness_decay ** age``."""
    if age is None:
        return float(fed.staleness_decay) ** int(fed.async_depth)
    return (torch.tensor(fed.staleness_decay, dtype=torch.float32,
                         device=age.device) ** age.float())


def drift_sketch_key(fed):
    """The one CountSketch projection of every drift sketch of a run (they
    are compared across rounds)."""
    return fold_in_name(prng.PRNGKey(fed.seed), "async_drift_sketch")


def drift_factor(sketch, last_sketch):
    """max(0, cos(delta, last landed delta)) on CountSketches, or 1 while
    the reference sketch is still zero."""
    s, last = sketch.float(), last_sketch.float()
    dot = torch.dot(s, last)
    n_last = torch.sqrt(torch.sum(last ** 2))
    n_new = torch.sqrt(torch.sum(s ** 2))
    cos = dot / torch.clamp(n_new * n_last, min=1e-12)
    return torch.where(n_last > 0, torch.clamp(cos, min=0.0),
                       torch.ones_like(cos))


def _apply_stale(fed, carry, delta, age):
    """Apply one popped slot's delta through the server optimizer with its
    staleness scale; ``carry = (params, opt_state, last_delta)``. Under
    ``adaptive_staleness`` the scale also takes the drift factor, a slot
    clamped to scale 0 is dropped with the optimizer untouched (adam's
    ``t`` too), and the reference sketch advances only on a landed delta:
    the scale is read on the host for that decision."""
    params, opt_state, last = carry
    scale = (staleness_discount(fed) if fed.async_mode == "fifo"
             else staleness_discount(fed, age))
    if fed.adaptive_staleness:
        sk = delta_sketch(tree_map(lambda d: d[None], delta),
                          drift_sketch_key(fed), int(fed.sketch_dim))[0]
        scale = scale * drift_factor(sk, last)
        if not bool(scale > 0):
            return params, opt_state, last
        last = sk
    new_params, new_opt = apply_server_opt(fed, params, opt_state, delta,
                                           scale=scale)
    return new_params, new_opt, last


def _slot(buf, i):
    return tree_map(lambda b: b[i], buf)


def async_apply(fed, global_params, opt_state, inflight, agg_delta,
                last_delta=(), push_timer=None):
    """One tick of the ``scan_async`` state machine, the reference's:

    1. every valid slot ages a round (and under the event clock its
       countdown ticks down);
    2. the ready slots pop oldest first, each through ``_apply_stale``:
       fifo, slot 0 once it aged ``async_depth``; ready, the prefix aged
       ``min_lag`` or more (a ``cumprod``); clocked, every slot whose
       countdown expired, in any positions. A full buffer with nothing
       ready force-pops slot 0;
    3. the survivors move to the front in push order and this round's
       ``agg_delta`` is pushed behind them at age 0 (with ``push_timer``,
       required under the clock).

    The [D] ready mask is read on the host once (the reference's per-slot
    ``lax.cond``): a slot that does not pop costs nothing, where a
    ``torch.where`` per slot would run the optimizer D times. The buffer
    is updated in place, every leaf of it, so the ``inflight`` passed in
    is the new buffer: each surviving delta is copied to its new position
    in ascending order (a survivor never moves up the ring, so none is
    overwritten before it is read), the fresh delta into its slot, and
    ``valid``, ``age`` and ``timer`` are overwritten; no second [D, ...]
    buffer is made. The slots behind the survivors keep stale bytes, as
    the reference's, and are never read.

    Returns ``(new_params, new_opt_state, inflight, new_last_delta,
    info)``, ``info = {"applied_valid": popped count (f32),
    "applied_age": oldest applied age (int32, 0 when none landed)}``."""
    valid = inflight["valid"] > 0
    D = int(valid.shape[0])
    dev = valid.device
    vi = valid.to(torch.int32)
    age = inflight["age"] + vi
    occ = torch.sum(vi)
    clocked = "timer" in inflight
    ready = torch.zeros(D, dtype=torch.bool, device=dev)
    if clocked:
        if push_timer is None:
            raise ValueError(
                "this in-flight buffer carries countdown timers "
                "(latency_mode != 'none') but no push_timer was given — "
                "compute one with slot_timer(fed, state.latency, gates)")
        timer = torch.clamp(inflight["timer"] - vi, min=0)
        ready = valid & (timer <= 0)
        force = (occ >= D) & (torch.sum(ready.to(torch.int32)) == 0)
        ready[0] = ready[0] | force
    elif fed.async_mode == "fifo":
        ready[0] = valid[0] & ((age[0] >= int(fed.async_depth)) | (occ >= D))
    else:
        thr = int(fed.min_lag)
        ready = torch.cumprod((valid & (age >= thr)).to(torch.int32),
                              dim=0) > 0
        force = (occ >= D) & ~ready[0] & valid[0]
        ready[0] = ready[0] | force
    valid_h, ready_h = torch.stack([valid, ready]).tolist()
    carry = (global_params, opt_state, last_delta)
    for i in range(D):
        if ready_h[i]:
            carry = _apply_stale(fed, carry, _slot(inflight["delta"], i),
                                 age[i])
    new_params, new_opt, new_last = carry

    k = sum(ready_h)
    pos = sum(valid_h) - k               # the fresh delta lands behind
    if clocked:
        # survivors in push order (the reference's stable permutation)
        src = [i for i in range(D) if valid_h[i] and not ready_h[i]][:pos]
    else:
        src = [j + k for j in range(pos)]    # the reference's roll by -k
    for leaf, d in zip(tree_leaves(inflight["delta"]),
                       tree_leaves(agg_delta)):
        for j, i in enumerate(src):
            if i != j:
                leaf[j].copy_(leaf[i])
        leaf[pos].copy_(d)
    idx = torch.arange(D, device=dev)
    src_t = torch.tensor(src + [0] * (D - pos), dtype=torch.long, device=dev)
    survivor = idx < pos
    zero = torch.zeros_like(age)
    info = {"applied_valid": torch.tensor(float(k), dtype=torch.float32,
                                          device=dev),
            "applied_age": torch.max(torch.where(ready, age, zero))}
    inflight["valid"].copy_(idx <= pos)
    inflight["age"].copy_(torch.where(survivor, age[src_t], zero))
    if clocked:
        inflight["timer"].copy_(torch.where(
            idx == pos, torch.as_tensor(push_timer, dtype=torch.int32,
                                        device=dev),
            torch.where(survivor, timer[src_t], zero)))
    return new_params, new_opt, inflight, new_last, info


def drain_inflight(fed, state: FederationState) -> FederationState:
    """Flush the buffer at the end of a run: apply every valid slot oldest
    first with the discount it would have had in-stream (its stored age,
    not aged again), and return the state with an emptied buffer (new
    zero leaves; the given state's buffer is left as it was). No-op for a
    synchronous state."""
    if not isinstance(state.inflight, dict):
        return state
    valid_h = (state.inflight["valid"] > 0).tolist()
    age = state.inflight["age"]
    carry = (state.params, state.opt_state, state.last_delta)
    for i, v in enumerate(valid_h):
        if v:
            carry = _apply_stale(fed, carry, _slot(state.inflight["delta"], i),
                                 age[i])
    params, opt_state, last = carry
    return state.replace(params=params, opt_state=opt_state,
                         inflight=tree_map(torch.zeros_like, state.inflight),
                         last_delta=last)


# ============================================================ failure models
@dataclass
class FailurePlan:
    """One round's injected faults; a ``None`` field injects nothing.

    * ``available`` — [C] bool, clients present (folds into participation);
    * ``crashed`` — [C] bool, clients whose trained delta is lost;
    * ``corrupt`` — [C] bool, clients whose delta is corrupted in transit.
    """
    available: Any = None
    crashed: Any = None
    corrupt: Any = None


FAILURE_MODELS = Registry("failure model", aliases={None: "none", "": "none"})


def register_failure_model(name: str):
    """Register ``fn(fed, key, round_idx, num_clients, client_ids=None) ->
    FailurePlan``; a model draws only from ``key`` (the round's failure
    stream) and the named streams it folds off the seed."""
    return FAILURE_MODELS.register(name, failure_name=name)


def resolve_failure_model(name) -> str:
    """Canonical failure-model name: None and '' mean 'none'."""
    return str(FAILURE_MODELS.resolve(name))


def get_failure_model(name) -> Callable:
    return FAILURE_MODELS.lookup(name)


def failure_key(fed, round_idx):
    """The round's fault PRNG: ``fold_in(fold_in_name(PRNGKey(seed),
    "failure_model"), round_idx)``, off the round's key chain."""
    base = fold_in_name(prng.PRNGKey(fed.seed), "failure_model")
    return prng.fold_in(base, round_idx)


def failure_plan(fed, round_idx, num_clients, client_ids=None, device="cpu"):
    """The configured failure model's plan for one round, its masks on
    ``device``, or None when the model is ``none``. With ``client_ids`` (a
    pool round's [P] global identities) the masks are in pool space, each
    drawn on the client's identity."""
    name = resolve_failure_model(fed.failure_model)
    if name == "none":
        return None
    plan = FAILURE_MODELS[name](fed, failure_key(fed, round_idx),
                                int(round_idx), int(num_clients),
                                client_ids=client_ids)
    return FailurePlan(*(None if m is None else m.to(device)
                         for m in (plan.available, plan.crashed,
                                   plan.corrupt)))


@register_failure_model("none")
def _fm_none(fed, key, round_idx, num_clients, client_ids=None):
    return FailurePlan()


def _identity_bernoulli(key, rate, num_clients, client_ids):
    """[num_clients] Bernoulli draws on the CPU. A dense round
    (``client_ids=None``) takes the reference's one shaped draw; a pool
    round keys each draw on the client's identity, ``bernoulli(fold_in(key,
    id), rate)``, so client k's draw is the same in whichever pool it
    landed, and the cost is O(P), not O(C)."""
    if client_ids is None:
        return prng.bernoulli(key, rate, (num_clients,))
    return prng.bernoulli(prng.fold_in(key, torch.as_tensor(client_ids).cpu()),
                          rate, ())


def _crashed_mask(fed, key, num_clients, client_ids=None):
    return _identity_bernoulli(fold_in_name(key, "crash"), fed.crash_rate,
                               num_clients, client_ids)


def _corrupt_mask(fed, key, num_clients, client_ids=None):
    return _identity_bernoulli(fold_in_name(key, "corrupt"),
                               fed.corrupt_rate, num_clients, client_ids)


def _dropout_available(fed, round_idx, num_clients, client_ids=None):
    # one draw per (window, client): the same clients sit out every round
    # of a dropout_len-round window
    window = round_idx // max(int(fed.dropout_len), 1)
    base = fold_in_name(prng.PRNGKey(fed.seed), "failure_dropout")
    k = prng.fold_in(base, window)
    return ~_identity_bernoulli(k, fed.dropout_rate, num_clients, client_ids)


@register_failure_model("crash")
def _fm_crash(fed, key, round_idx, num_clients, client_ids=None):
    """A per-round Bernoulli crash: the client trains, its delta is lost."""
    return FailurePlan(crashed=_crashed_mask(fed, key, num_clients,
                                             client_ids))


@register_failure_model("dropout")
def _fm_dropout(fed, key, round_idx, num_clients, client_ids=None):
    """Transient drop-out for whole ``dropout_len``-round windows."""
    return FailurePlan(
        available=_dropout_available(fed, round_idx, num_clients, client_ids))


@register_failure_model("corrupt")
def _fm_corrupt(fed, key, round_idx, num_clients, client_ids=None):
    """Delta corruption in transit (NaN'd or scaled rows)."""
    return FailurePlan(corrupt=_corrupt_mask(fed, key, num_clients,
                                             client_ids))


@register_failure_model("chaos")
def _fm_chaos(fed, key, round_idx, num_clients, client_ids=None):
    """All three, each on its own named substream."""
    return FailurePlan(
        available=_dropout_available(fed, round_idx, num_clients, client_ids),
        crashed=_crashed_mask(fed, key, num_clients, client_ids),
        corrupt=_corrupt_mask(fed, key, num_clients, client_ids))


def corruption_transform(fed, corrupt_mask):
    """The ``delta_transform`` that corrupts the masked clients' trained
    params: ``corrupt_scale == 0`` fills their rows with NaN, any other
    scale s makes them ``g + s * (p - g)``. It reads the mask on the host
    and rewrites the corrupted rows of the client stack in place (no
    stack-sized temporary), then returns the stack."""
    scale = float(fed.corrupt_scale)

    def tf(client_params, global_params, client_idx):
        rows = torch.nonzero(corrupt_mask[client_idx]).flatten().tolist()
        for cp, gp in zip(tree_leaves(client_params),
                          tree_leaves(global_params)):
            for j in rows:
                if scale == 0.0:
                    cp[j].fill_(float("nan"))
                else:
                    cp[j].copy_(gp + scale * (cp[j] - gp))
        return client_params

    return tf


# ============================================================ event clock
def client_latency(latency):
    """[C] simulated completion time (round units): compute + network."""
    return latency["compute"] + latency["net"]


def lost_mask(fed, state, plan):
    """[C] bool of the clients whose trained delta never reaches the
    server this round (crashed, or slower than a finite
    ``fed.round_deadline``), or None when nothing can be lost."""
    lost = None
    if plan is not None and plan.crashed is not None:
        lost = plan.crashed
    if (fed.latency_mode != "none"
            and float(fed.round_deadline) != float("inf")):
        lat = client_latency(state.latency)
        late = lat > torch.tensor(float(fed.round_deadline),
                                  dtype=torch.float32, device=lat.device)
        lost = late if lost is None else (lost | late)
    return lost


def aggregate_finite(fed, agg_delta, loss=None):
    """The divergence guard's predicate (0-d bool on the delta's device):
    every delta leaf finite and, when given, the eval loss; None when the
    guard is off."""
    if not fed.divergence_guard:
        return None
    leaves = tree_leaves(agg_delta)
    finite = (torch.ones((), dtype=torch.bool, device=leaves[0].device)
              if loss is None else torch.isfinite(loss))
    for leaf in leaves:
        finite = finite & torch.all(torch.isfinite(leaf))
    return finite


def skips_update(state, finite):
    """The consecutive-skip counter: +1 on a guarded skip, 0 on a finite
    round, passed through when the guard is off."""
    if finite is None:
        return state.nonfinite_skips
    return torch.where(finite, torch.zeros_like(state.nonfinite_skips),
                       state.nonfinite_skips + 1)


def slot_timer(fed, latency, eff_gates):
    """int32 countdown for the slot pushed this round: the ceiling of its
    slowest surviving included member's completion time, clamped to
    [1, ceil(round_deadline)]."""
    lat = client_latency(latency)
    t = torch.max(torch.where(eff_gates > 0, lat, torch.zeros_like(lat)))
    t = torch.ceil(t).to(torch.int32)
    deadline = float(fed.round_deadline)
    if deadline != float("inf"):
        t = torch.clamp(t, max=int(math.ceil(deadline)))
    return torch.clamp(t, min=1)


# ============================================================ candidate pools
def _ef_on(fed) -> bool:
    return (resolve_wire_codec(fed.wire_codec) != "identity"
            and bool(fed.error_feedback))


def pool_view(fed, state: FederationState, idx) -> FederationState:
    """The [P] view of a federation state for a pool round: the
    per-client leaves (``backlog``, the EMAs, the event clock's latency
    draws and the error-feedback rows) gathered at ``idx``; params,
    moments, the in-flight buffer, the drift sketch and the skip counter
    pass through."""
    def take(a):
        return a[idx]
    return state.replace(
        backlog=take(state.backlog), util_ema=take(state.util_ema),
        incl_ema=take(state.incl_ema),
        latency=(tree_map(take, state.latency)
                 if fed.latency_mode != "none" else state.latency),
        ef_accum=(tree_map(take, state.ef_accum) if _ef_on(fed)
                  else state.ef_accum))


def pool_scatter(fed, state: FederationState, sub: FederationState, stats,
                 idx):
    """Write a pool round's per-client leaves back at ``idx``: ``backlog``
    and the EMAs into new [C] tensors, the error-feedback rows in place
    into ``state.ef_accum`` (no second [C, ...] copy), ``latency`` kept
    (drawn once at init). Every out-of-pool row stays bit-identical. The
    stats' ``local_losses`` and ``gates`` move to the [C] space, zero out
    of the pool, ``backlog`` is the scattered ledger and ``pool_idx`` the
    pool. Returns (new_state, stats)."""
    if _ef_on(fed):
        for full, rows in zip(tree_leaves(state.ef_accum),
                              tree_leaves(sub.ef_accum)):
            full.index_copy_(0, idx, rows)
    new_state = sub.replace(
        backlog=state.backlog.index_copy(0, idx, sub.backlog),
        util_ema=state.util_ema.index_copy(0, idx, sub.util_ema),
        incl_ema=state.incl_ema.index_copy(0, idx, sub.incl_ema),
        latency=state.latency, ef_accum=state.ef_accum)
    C = state.backlog.shape[0]
    for name in ("local_losses", "gates"):
        v = stats[name]
        stats[name] = v.new_zeros(C).index_copy_(0, idx, v)
    stats["backlog"] = new_state.backlog
    stats["pool_idx"] = idx
    return new_state, stats


# ============================================================ local training
def round_faults(fed, state, round_idx, num_clients, device,
                 delta_transform=None, client_ids=None):
    """The round's fault prologue, shared by ``make_round_fn`` and both LM
    rounds: ``(available, lost, transform)``, drawn per identity in a
    pool round (``client_ids``, its [P] global indices). ``available`` is
    the plan's [C] availability (None: everyone present), to fold into
    participation; ``lost`` the [C] mask of crashed and deadline-late
    clients (None when no client can be lost), whose mass the aggregation
    drops after training; ``transform`` the corruption transform composed
    under ``delta_transform`` (either alone when the other is None)."""
    plan = failure_plan(fed, round_idx, num_clients, client_ids=client_ids,
                        device=device)
    available = plan.available if plan is not None else None
    tf = delta_transform
    if plan is not None and plan.corrupt is not None:
        ctf = corruption_transform(fed, plan.corrupt)
        if delta_transform is None:
            tf = ctf
        else:
            def tf(cp, gp, idx, _user=delta_transform, _ctf=ctf):
                return _user(_ctf(cp, gp, idx), gp, idx)
    return available, lost_mask(fed, state, plan), tf


def apply_aggregate(fed, state, params, agg_delta, mass, gates, finite=None):
    """Step (6) of every round: at ``fed.async_depth == 0`` the server step
    at the round barrier (``apply_if_mass``, skipped bit-exactly on a
    zero-mass or guarded round); otherwise through the in-flight buffer
    (``async_apply``): a non-finite aggregate is zeroed in place first, so
    its slot lands as a no-op, and under the event clock the slot's
    countdown comes from the effective ``gates`` (``slot_timer``).
    Returns (new_params, opt_state, inflight, last_delta, info or None)."""
    if fed.async_depth > 0:
        if finite is not None:
            for d in tree_leaves(agg_delta):
                d.masked_fill_(~finite, 0.0)
        push_timer = (slot_timer(fed, state.latency, gates)
                      if fed.latency_mode != "none" else None)
        return async_apply(fed, params, state.opt_state, state.inflight,
                           agg_delta, last_delta=state.last_delta,
                           push_timer=push_timer)
    new_params, opt_state = apply_if_mass(fed, params, state.opt_state,
                                          agg_delta, mass, finite=finite)
    return new_params, opt_state, state.inflight, state.last_delta, None


def add_fault_stats(fed, stats, new_state, info, lost):
    """Add the buffer's and the fault layer's keys to a round's ``stats``,
    each only where its feature is on (the reference's ``_async_stats``
    and ``_failure_stats``): ``staleness`` (the oldest landed age, 0 when
    none landed), ``applied_valid`` and ``inflight_occupancy`` with a
    buffer, ``lost_clients`` when clients can be lost,
    ``skipped_nonfinite`` under the guard."""
    if fed.async_depth > 0:
        stats["staleness"] = info["applied_age"]
        stats["applied_valid"] = info["applied_valid"]
        stats["inflight_occupancy"] = torch.sum(new_state.inflight["valid"])
    if lost is not None:
        stats["lost_clients"] = torch.sum(lost.float())
    if fed.divergence_guard:
        stats["skipped_nonfinite"] = new_state.nonfinite_skips
    return stats


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


def local_steps(loss_fn, fed):
    """Returns f(params, anchor, data, order, lr) -> the [K]-stacked
    ``params`` of K clients after E epochs of minibatch SGD (FedProx,
    pulled toward ``anchor``, when ``fed.algorithm == 'fedprox'``).
    ``anchor`` is the unstacked global params (a round) or [K]-stacked
    starting points (the local-only baseline); ``data`` leaves are
    [K, n, ...], ``order`` is ``minibatch_order``'s [K, E, steps, bs].
    Each step is one vmapped gradient over the K clients."""
    prox_mu = fed.prox_mu if fed.algorithm == "fedprox" else 0.0
    batch_grad = vmap(grad(lambda p, b: loss_fn(p, b)[0]))

    def run(params, anchor, data, order, lr):
        K, E, steps, _ = order.shape
        rows = torch.arange(K, device=order.device)[:, None]
        for e in range(E):
            for s in range(steps):
                idx = order[:, e, s]                             # [K, bs]
                batch = {k: v[rows, idx] for k, v in data.items()}
                grads = batch_grad(params, batch)
                if prox_mu > 0.0:
                    grads = tree_map(lambda g, q, w0: g + prox_mu * (q - w0),
                                     grads, params, anchor)
                params = tree_axpy(-lr, grads, params)
        return params

    return run


def local_solver(loss_fn, fed):
    """Returns f(global_params, data, order, lr) -> local params of K
    clients after E epochs of minibatch SGD from the global params
    (``local_steps`` over K copies of them, anchored there); the result
    has params-shaped leaves with a leading [K] axis."""
    run = local_steps(loss_fn, fed)

    def solve(global_params, data, order, lr):
        K = order.shape[0]
        params = tree_map(lambda p: p.expand((K,) + p.shape).clone(),
                          global_params)
        return run(params, global_params, data, order, lr)

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
    # scan_async schedules clients as vmap_spatial: its "scan" is the round
    # axis, over which cohorts overlap through the in-flight buffer
    "scan_async": (_eval_vmap, _train_vmap),
}


# ============================================================ the round
def make_round_fn(loss_fn: Callable, fed, *, backend: Optional[str] = None,
                  delta_transform: Optional[Callable] = None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics); batch = {'x','y'}.

    Returns round_fn(state, data, priority_mask, weights, rng, round_idx)
    -> (new_state, stats), with ``state`` a FederationState (``init_state``),
    ``data`` leaves [C, n, ...] on the round's device, ``rng`` a
    ``repro_torch.prng`` key and ``round_idx`` a python int. The stats keys
    are the reference's; ``gates`` are the effective gates the aggregation
    honoured. ``staleness``, ``applied_valid`` and ``inflight_occupancy``
    appear only with an in-flight buffer, ``lost_clients`` only when
    clients can be lost, ``skipped_nonfinite`` only under the guard.

    ``delta_transform(client_params, global_params, client_idx) ->
    client_params`` rewrites the trained client params right before the
    aggregation (``client_idx`` indexes the rows' clients in the round's
    index space: the dense [C] one, or in a pool round the pool's [P]
    one, as the reference's code passes them); the corruption fault
    composes under it. With ``backend="scan_async"`` and
    ``fed.async_depth > 0`` the aggregate goes through the in-flight
    buffer (``async_apply``).

    ``fed.candidate_pool = P`` with 0 < P < C runs the pool round: the
    pool key is split off ``rng`` first, ``pool_select`` draws the [P]
    indices, the round runs on the gathered view (``pool_view``) with
    identity-keyed draws, and ``pool_scatter`` writes the per-client
    leaves back; the stats carry ``pool_idx``, and ``local_losses`` and
    ``gates`` in the [C] space with zeros out of the pool. The
    error-feedback rows are scattered back in place, so the state passed
    in shares them with the new one. P = 0 and P >= C run the dense
    round, bit for bit."""
    backend = backend or fed.backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if fed.async_depth > 0 and backend != "scan_async":
        raise ValueError(
            f"FedConfig.async_depth={fed.async_depth} requires the "
            f"'scan_async' backend; {backend!r} applies every delta at its "
            "own round barrier and would silently ignore the in-flight "
            "buffer (set async_depth=0 or backend='scan_async')")
    validate_config(fed)
    # stochastic aggregators (dp) get a per-round key; the error-feedback
    # rows exist only under a non-identity codec with error_feedback on
    agg_needs_key = get_aggregator(fed.aggregator).needs_key
    ef_on = _ef_on(fed)
    eval_clients, train_clients = _BACKENDS[backend]
    gate_before_train = not get_strategy(fed.selection).needs_deltas
    solver = local_solver(loss_fn, fed)
    sched = make_schedule(fed)
    warmup_rounds = int(fed.warmup_frac * fed.rounds)
    pool = int(fed.candidate_pool)

    def round_body(state: FederationState, data, priority_mask, weights, rng,
                   round_idx, client_ids=None):
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

        # (2) the reference's key chain: participation key, then local keys
        rng, pkey = prng.split(rng)
        part = participation_mask(fed, pkey, priority_mask, round_idx,
                                  client_ids=client_ids)
        # the fault plan: drop-outs fold into participation, crashed and
        # deadline-late clients lose their mass after training, corruption
        # rides the delta_transform seam
        available, lost, tf = round_faults(fed, state, round_idx, C, dev,
                                           delta_transform, client_ids)
        if available is not None:
            part = part & available
        keep = None if lost is None else 1.0 - lost.float()
        warm = round_idx < warmup_rounds
        # per-client training keys by identity: a pool round folds the
        # global index in (O(P)), where the dense round splits C keys
        rng, lkey = prng.split(rng)
        lkeys = (prng.split(lkey, C) if client_ids is None
                 else prng.fold_in(lkey, client_ids.cpu())).to(dev)
        order = minibatch_order(fed, lkeys, n)
        akey = aggregator_key(fed, round_idx) if agg_needs_key else None

        def make_ctx(delta_cos=None):
            return SelectionContext(
                align_vals=align_vals, global_align=g_align, eps=eps,
                priority_mask=priority_mask, weights=weights,
                participation=part, warmup=warm, delta_cos=delta_cos,
                topk=fed.topk, sim_threshold=fed.sim_threshold,
                backlog=state.backlog,
                util_ema=utility_estimate(fed, util_ema, round_idx),
                incl_ema=state.incl_ema, welfare_floor=fed.welfare_floor)

        def aggregate(client_params, agg_w, agg_g, ef_rows):
            # (5) one fused fedagg launch; the error-feedback rows advance
            # with it
            if ef_on:
                return server_delta(fed, global_params, client_params, agg_w,
                                    agg_g, key=akey, ef_accum=ef_rows)
            return server_delta(fed, global_params, client_params, agg_w,
                                agg_g, key=akey), ef_rows

        k = min(int(fed.max_cohort), C) if fed.max_cohort > 0 else 0
        ef_accum = state.ef_accum
        if gate_before_train:
            # (3) gates from the eval pre-pass, then (4) training; the scan
            # backend skips gated-out clients
            sel_gates = compute_gates(make_ctx(), fed.selection)
            if k > 0:
                # gather-train-scatter: only the K cohort slots train, their
                # error-feedback rows gather with them and scatter back
                cohort_idx, cohort_gates, gates = cohort_select(
                    sel_gates, align_vals, g_align, priority_mask, k,
                    backlog=state.backlog,
                    backlog_boost=float(fed.backlog_boost))
                client_params = train_clients(
                    solver, global_params,
                    {key: v[cohort_idx] for key, v in data.items()},
                    order[cohort_idx], lr, gates=cohort_gates)
                if tf is not None:
                    client_params = tf(client_params, global_params,
                                       cohort_idx)
                agg_w, agg_g = weights[cohort_idx], cohort_gates
                if keep is not None:
                    # lost: trained, but the delta never arrives; the
                    # selection gates stay for the backlog (+1)
                    agg_g = agg_g * keep[cohort_idx]
                    gates = gates * keep
                agg_delta, cohort_ef = aggregate(
                    client_params, agg_w, agg_g,
                    tree_map(lambda a: a[cohort_idx], ef_accum))
                if ef_on:
                    ef_accum = tree_map(
                        lambda full, sub: full.index_copy(0, cohort_idx, sub),
                        ef_accum, cohort_ef)
            else:
                gates = sel_gates
                client_params = train_clients(solver, global_params, data,
                                              order, lr, gates=gates)
                if tf is not None:
                    client_params = tf(client_params, global_params,
                                       torch.arange(C, device=dev))
                if keep is not None:
                    gates = gates * keep
                agg_w, agg_g = weights, gates
                agg_delta, ef_accum = aggregate(client_params, agg_w, agg_g,
                                                ef_accum)
        else:
            # (4) train first: the statistic needs the client updates
            client_params = train_clients(solver, global_params, data, order,
                                          lr)
            if tf is not None:
                # before the statistic: an attacker's delta moves its score
                client_params = tf(client_params, global_params,
                                   torch.arange(C, device=dev))
            deltas = tree_map(lambda ck, g: ck - g[None], client_params,
                              global_params)
            if fed.grad_sim_sketch:
                flat = delta_sketch(deltas, sketch_key(fed, round_idx),
                                    int(fed.sketch_dim))
            else:
                flat = flatten_stacked(deltas)
            del deltas
            gates = sel_gates = compute_gates(
                make_ctx(cosine_to_priority(flat, weights, priority_mask)),
                fed.selection)
            del flat
            if keep is not None:
                gates = gates * keep
            agg_w, agg_g = weights, gates
            agg_delta, ef_accum = aggregate(client_params, agg_w, agg_g,
                                            ef_accum)

        # the divergence guard: a non-finite aggregate, or a non-finite
        # eval loss, never touches params or optimizer moments
        finite = aggregate_finite(fed, agg_delta, g_loss)
        # (6) the server step, or the push through the in-flight buffer
        new_global, opt_state, inflight, last_delta, ainfo = apply_aggregate(
            fed, state, global_params, agg_delta,
            inclusion_mass(fed, agg_w, agg_g), gates, finite)
        nonfinite_skips = skips_update(state, finite)

        # the backlog ledger and the inclusion EMA follow the effective
        # gates the aggregation honoured
        backlog = backlog_update(state.backlog, sel_gates, gates)
        incl_ema = inclusion_update(fed, state.incl_ema, gates)
        new_state = state.replace(params=new_global, opt_state=opt_state,
                                  backlog=backlog, util_ema=util_ema,
                                  incl_ema=incl_ema, inflight=inflight,
                                  last_delta=last_delta,
                                  nonfinite_skips=nonfinite_skips,
                                  ef_accum=ef_accum)

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
        return new_state, add_fault_stats(fed, stats, new_state, ainfo, lost)

    @torch.no_grad()
    def round_fn(state: FederationState, data, priority_mask, weights, rng,
                 round_idx):
        C = priority_mask.shape[0]
        if not 0 < pool < C:
            return round_body(state, data, priority_mask, weights, rng,
                              round_idx)
        # the pool key first, so the round's own chain (participation,
        # then local keys) is consumed in the dense round's order
        rng, pool_key = prng.split(rng)
        idx = pool_select(fed, pool_key, priority_mask, state.backlog,
                          state.incl_ema, pool)
        sub, stats = round_body(
            pool_view(fed, state, idx), {k: v[idx] for k, v in data.items()},
            priority_mask[idx], weights[idx], rng, round_idx, client_ids=idx)
        return pool_scatter(fed, state, sub, stats, idx)

    return round_fn
