"""FedALIGN rounds over the LM zoo: the spatial round and the temporal
(streamed-client) round on one card, and the spatial round as a pod round
over the (pod, data, model) ranks of a process group.

Counterpart of ``repro/fl/sharded.py``: ``make_spatial_round``,
``make_temporal_round``, ``make_round_step``, ``needs_fsdp`` and, for its
data axes and its model axis (tensor-parallel params for the dense GQA
family), ``make_pod_round`` (see its docstring; ``pod_round_plan`` the
collectives a round promises, ``COLLECTIVES`` those it issued). A round
has the engine's persistent-state signature

    round_step(state: engine.FederationState, batch, round_idx=0)
        -> (new_state, stats)

**The spatial round** runs, in the reference's order:

1. the server statistic F(w_t): the loss on the server-held batch;
2. per client, its loss at the received model (the matching statistic)
   and E full-batch local SGD steps, ``p <- -lr * grad + p``
   (``tree_axpy(-lr, g, p)``, the reference's order of operations);
3. the utility EMA and the gates of the configured strategy (``grad_sim``
   from the cosine of each client delta to the priority mean delta, exact
   or on CountSketches under ``fed.grad_sim_sketch``);
4. the gated aggregation of the client deltas (one fedagg launch on the
   card) under the configured aggregator and wire codec, the
   error-feedback rows advancing through ``engine.server_delta``;
5. the server step (sgd, momentum, adam, yogi), skipped on a zero-mass
   round with params and optimizer moments bit-identical.

With ``fed.max_cohort = K > 0`` and a strategy that gates from losses
(not ``grad_sim``), the round gates before it trains: a no-grad eval pass
over the C clients, the gates, ``engine.cohort_select``, and only the K
gathered clients run their E steps, into a K-row client stack. As in the
reference, the LM round reads no ``fed.participation``: everyone is
available.

The reference ``vmap``s the clients; the port loops over them, because
``torch.func.vmap`` cannot batch through the ctypes kernels and one
client's params are 1.86 GB at qwen1.5-0.5b's full width. The math is per
client, so the result is the same. Each client's trained leaves are
written into preallocated ``[C, ...]`` (cohort: ``[K, ...]``) stacked
leaves (the round holds the stack once); the loss at the received model runs under ``torch.no_grad``
and each local step takes ``torch.autograd.grad`` of a ``requires_grad``
view of the client's slot, then updates the slot in place.

**The temporal round** (the reference's FSDP round, which ``needs_fsdp``
picks for jamba) fixes every gate before any client trains: a no-grad
eval pass (the server loss, each client's loss at the received model),
the utility EMA and the gates, read on the host once a round. Then the
clients stream one at a time, ascending, through one reused client
buffer; a client with gate 0 skips its E steps. Under the gated ``mean``
with the identity wire, an f32 running ``num += (w_k g_k) p_k``, ``den +=
w_k g_k`` (the reference's order) gives the delta ``num / den - p`` in
place in ``num``, an exact zero on a zero-mass round; no fedagg kernel
runs. The round then holds params, one client copy, its gradients and the
accumulator: four copies, where the spatial round holds C + 3. Any other
aggregator or wire gathers the trained params into ``[C, ...]`` (a gated-
out row holds the received params, as the reference's cond) and goes
through ``engine.server_delta`` (fedagg) as the spatial round does.
``grad_sim`` needs ``fed.grad_sim_sketch``: a first pass trains every
client and keeps only the CountSketch of its delta, the cosines fix the
gates, and a second pass re-trains the included clients. ``max_cohort``
is not read, as in the reference.

**Overlapped cohorts and faults**, in both rounds as in the reference:
``fed.async_depth = D > 0`` sends the round's aggregate through the
engine's in-flight buffer (``engine.async_apply``: the slots that pop are
applied, the fresh delta is pushed; the buffer holds D params-sized
slots). A failure model's plan folds drop-outs into the gates'
participation; crashed and deadline-late clients (the event clock) lose
their aggregation mass but keep their selection gates for the backlog;
the spatial round corrupts the trained rows in place
(``engine.corruption_transform``), the temporal round refuses corruption
with the reference's ``ValueError`` and skips a lost client's E steps.
The divergence guard (with the server loss) skips a non-finite aggregate
bit-exactly, or zeroes it before it enters the buffer. The temporal round
raises the reference's ``ValueError`` for a ``corrupt`` / ``chaos``
failure model with ``corrupt_rate > 0``, and for ``grad_sim`` without
sketches.

**Candidate pools** (``fed.candidate_pool = P``, 0 < P < C) wrap both
rounds (``_pool_wrap``): the pool is drawn by ``engine.pool_select`` from
the named stream ``pool_round_key`` (the rounds take no rng), the round
runs on the [P] gather of ``batch["clients"]``, the priority mask, the
weights and the per-client state leaves, with the fault draws keyed on
the clients' identities, and ``engine.pool_scatter`` writes the leaves
back; an out-of-pool client's rows stay bit-identical. P = 0 and P >= C
run the round unwrapped.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import validate_config
from repro_torch.core.aggregation import (aggregator_key, flatten_stacked,
                                          get_aggregator, inclusion_mass,
                                          resolve_aggregator,
                                          resolve_wire_codec)
from repro_torch.core.alignment import epsilon_at
from repro_torch.fl import engine
from repro_torch.kernels import ops as kops
from repro_torch import prng
from repro_torch.sharding import model_axis
from repro_torch.utils import (fold_in_name, resolve_device, tree_leaves,
                               tree_map, tree_unflatten_like)

FSDP_ARCHS = {"jamba-1.5-large-398b", "llava-next-34b"}


def needs_fsdp(cfg) -> bool:
    """The archs the reference runs through the temporal round."""
    return cfg.name in FSDP_ARCHS


def pool_round_key(fed, round_idx):
    """The LM rounds' candidate-pool key: the named stream
    ``"candidate_pool"`` off the config seed, folded with the absolute
    round index (a resumed run redraws round r's pool)."""
    base = fold_in_name(prng.PRNGKey(fed.seed), "candidate_pool")
    return prng.fold_in(base, int(round_idx))


def _pool_wrap(fed, round_step):
    """Run ``round_step`` on a [P] candidate pool of the batch's C clients
    when 0 < ``fed.candidate_pool`` < C (see the module note); otherwise
    the round itself."""
    pool = int(fed.candidate_pool)
    if pool <= 0:
        return round_step

    def pooled_step(state, batch, round_idx=0):
        pm = batch["priority_mask"]
        if pool >= pm.shape[0]:
            return round_step(state, batch, round_idx)
        idx = engine.pool_select(fed, pool_round_key(fed, round_idx), pm,
                                 state.backlog, state.incl_ema, pool)
        sub_batch = dict(batch, priority_mask=pm[idx],
                         weights=batch["weights"][idx],
                         clients={k: v[idx]
                                  for k, v in batch["clients"].items()})
        sub, stats = round_step(engine.pool_view(fed, state, idx), sub_batch,
                                round_idx, client_ids=idx)
        return engine.pool_scatter(fed, state, sub, stats, idx)

    return pooled_step


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


def _gate_ctx(fed, state, util_ema, local_losses, server_loss, pm, w,
              delta_cos=None, round_idx=0, participation=None):
    """SelectionContext for one pod-scale round: eps_t of ``round_idx``,
    the bias-corrected utility EMA, backlog and inclusion EMA from the
    state; no warm-up, as the reference's. ``participation`` is the
    failure plan's availability (None: everyone present)."""
    return engine.SelectionContext(
        align_vals=local_losses, global_align=server_loss,
        eps=epsilon_at(fed, round_idx), priority_mask=pm, weights=w,
        participation=participation, delta_cos=delta_cos, topk=fed.topk,
        sim_threshold=fed.sim_threshold,
        backlog=state.backlog,
        util_ema=engine.utility_estimate(fed, util_ema, round_idx),
        incl_ema=state.incl_ema, welfare_floor=fed.welfare_floor)


def _next_state(fed, state, new_params, opt_state, sel_gates, eff_gates,
                util_ema, inflight, last_delta, nonfinite_skips,
                ef_accum=None):
    """Advance the cross-round carry with the engine's update rules: the
    backlog from the selection and the effective gates (they differ when
    the cohort overflowed or a client was lost), the inclusion EMA from
    the effective ones."""
    return state.replace(
        params=new_params, opt_state=opt_state,
        backlog=engine.backlog_update(state.backlog, sel_gates, eff_gates),
        util_ema=util_ema,
        incl_ema=engine.inclusion_update(fed, state.incl_ema, eff_gates),
        inflight=inflight, last_delta=last_delta,
        nonfinite_skips=nonfinite_skips,
        ef_accum=state.ef_accum if ef_accum is None else ef_accum)


def _client(client_batch, c):
    return {k: v[c] for k, v in client_batch.items()}


def _train_stack(model, params, client_batch, rows, lr, E, trains=None):
    """E local steps for each client c of ``rows``, into row j of a fresh
    [len(rows), ...] stack; a client with ``trains[c]`` false gets the
    received params in its row instead."""
    stacked = tree_map(lambda p: p.new_empty((len(rows),) + tuple(p.shape)),
                       params)
    for j, c in enumerate(rows):
        row = tree_map(lambda s: s[j], stacked)
        if trains is None or trains[c]:
            _train_steps(model, params, _client(client_batch, c), lr, E,
                         out=row)
        else:
            with torch.no_grad():
                tree_map(lambda o, p: o.copy_(p), row, params)
    return stacked


def _check_params_device(params, dev):
    have = tree_leaves(params)[0].device
    if have.type != dev.type:
        raise ValueError(f"params lie on {have}, the round runs on {dev}")


def _eval_pass(model, fed, state, batch, pod=None):
    """No grad: the server statistic F(w_t), each client's F_k(w_t) at the
    received model (the paper's matching statistic) and the utility EMA
    updated with them. In a pod round the batch holds the rank's own
    clients, and their losses are gathered into the [C] vector."""
    params, client_batch = state.params, batch["clients"]
    n = next(iter(client_batch.values())).shape[0]
    with torch.no_grad():
        server_loss, _ = model.loss_fn(params, batch["server"])
        local_losses = torch.stack([
            model.loss_fn(params, _client(client_batch, c))[0]
            for c in range(n)])
        if pod is not None:
            local_losses = pod.all_gather(local_losses)
        util_ema = engine.utility_update(fed, state.util_ema, local_losses,
                                         server_loss)
    return server_loss, local_losses, util_ema


def _round_stats(fed, server_loss, local_losses, gates, new_state, pm, w,
                 info, lost):
    """The round's stats, with the buffer's and the fault layer's keys
    where their feature is on (``engine.add_fault_stats``)."""
    npri = 1.0 - pm.float()
    stats = {
        "server_loss": server_loss,
        "local_losses": local_losses,
        "gates": gates,
        "backlog": new_state.backlog,
        "theta_round": 1.0 / (1.0 + torch.sum(npri * w * gates)),
    }
    return engine.add_fault_stats(fed, stats, new_state, info, lost)


def make_spatial_round(model, fed, num_clients: int, device="cuda"):
    """Returns round_step(state, batch, round_idx=0) -> (new_state, stats).

    batch: ``clients`` (tokens / labels / mask, [C, b, S]), ``server``
    ([b, S]), ``priority_mask`` and ``weights`` ([C]); state and batch on
    ``device`` (asking for a missing card raises). Without a cohort every
    client trains (train-first, as the reference's dense spatial round)
    and the gates drop the excluded ones from the aggregation; with
    ``fed.max_cohort = K`` (and a strategy that gates from losses) only
    the K gathered clients train."""
    return _pool_wrap(fed, _spatial_step(model, fed, device))


def _spatial_step(model, fed, device, pod=None, axis=None):
    """The spatial round's step, in one process (``pod`` None: every
    client is local) or as one rank of a pod round (``pod``: a ``_Pod``,
    whose block of clients the batch holds; ``axis``: its model group, a
    ``model_axis.ModelAxis``, when the params are its shards; see
    ``make_pod_round``)."""
    E = fed.local_epochs
    lr = fed.lr
    validate_config(fed)
    dev = resolve_device(device)
    agg_needs_key = get_aggregator(fed.aggregator).needs_key
    ef_on = (resolve_wire_codec(fed.wire_codec) != "identity"
             and bool(fed.error_feedback))
    strategy = engine.get_strategy(fed.selection)
    use_cohort = fed.max_cohort > 0 and not strategy.needs_deltas

    def round_step(state, batch, round_idx=0, client_ids=None):
        round_idx = int(round_idx)
        params = state.params
        _check_params_device(params, dev)
        client_batch = batch["clients"]
        pm = batch["priority_mask"]
        w = batch["weights"]
        C = pm.shape[0]
        # the clients held here: [lo, lo + n) of the C
        lo, n = (0, C) if pod is None else pod.block(C)
        server_loss, local_losses, util_ema = _eval_pass(model, fed, state,
                                                         batch, pod)
        akey = aggregator_key(fed, round_idx) if agg_needs_key else None
        ef_rows = state.ef_accum
        # the fault plan: availability gates, lost clients' mass masked
        # after training, corruption of the trained rows in place
        part, lost, ctf = engine.round_faults(fed, state, round_idx, C,
                                               dev, client_ids=client_ids)

        if use_cohort:
            # gates -> gather-train: only the K cohort rows train
            with torch.no_grad():
                sel_gates = engine.compute_gates(
                    _gate_ctx(fed, state, util_ema, local_losses,
                              server_loss, pm, w, round_idx=round_idx,
                              participation=part),
                    fed.selection)
                idx, agg_g, gates = engine.cohort_select(
                    sel_gates, local_losses, server_loss, pm,
                    min(fed.max_cohort, C), backlog=state.backlog,
                    backlog_boost=float(fed.backlog_boost))
            # this rank's cohort rows, in cohort order
            mine = None if pod is None else (idx >= lo) & (idx < lo + n)
            row_ids = idx if mine is None else idx[mine]
            stacked = _train_stack(model, params, client_batch,
                                   (row_ids - lo).tolist(), lr, E)
            with torch.no_grad():
                if ctf is not None:
                    stacked = ctf(stacked, params, row_ids)
                if lost is not None:
                    keep = 1.0 - lost.float()
                    agg_g = agg_g * keep[idx]
                    gates = gates * keep
            agg_w, agg_ids = w[idx], idx
            if ef_on:
                ef_rows = tree_map(lambda a: a[row_ids], state.ef_accum)
        else:
            # train first: every client, then the gates
            mine = None if pod is None else slice(lo, lo + n)
            stacked = _train_stack(model, params, client_batch, range(n), lr,
                                   E)
            with torch.no_grad():
                if ctf is not None:
                    # before the delta statistic, as the reference's
                    stacked = ctf(stacked, params,
                                  torch.arange(lo, lo + n, device=dev))
                delta_cos = None
                if strategy.needs_deltas:
                    deltas = tree_map(lambda ck, g: ck - g[None], stacked,
                                      params)
                    if fed.grad_sim_sketch:
                        flat = engine.delta_sketch(
                            deltas, engine.sketch_key(fed, round_idx),
                            int(fed.sketch_dim))
                    else:
                        flat = flatten_stacked(deltas)
                    del deltas
                    delta_cos = engine.cosine_to_priority(flat, w, pm)
                    del flat
                sel_gates = gates = engine.compute_gates(
                    _gate_ctx(fed, state, util_ema, local_losses,
                              server_loss, pm, w, delta_cos,
                              round_idx=round_idx, participation=part),
                    fed.selection)
                if lost is not None:
                    gates = gates * (1.0 - lost.float())
            agg_w, agg_g, agg_ids = w, gates, None
            if ef_on and pod is not None:
                ef_rows = tree_map(lambda a: a[lo:lo + n], state.ef_accum)

        with torch.no_grad():
            rows_w, rows_g, reduce = agg_w, agg_g, None
            if pod is not None:
                rows_w, rows_g = agg_w[mine], agg_g[mine]
                reduce = pod.reducer(fed, agg_w, agg_g, agg_ids, C)
            ef_accum = None
            if ef_on:
                agg_delta, ef_rows = engine.server_delta(
                    fed, params, stacked, rows_w, rows_g, key=akey,
                    ef_accum=ef_rows, reduce=reduce)
                if use_cohort or pod is not None:
                    at = (row_ids if use_cohort
                          else torch.arange(lo, lo + n, device=dev))
                    ef_accum = tree_map(
                        lambda full, sub: full.index_copy(0, at, sub),
                        state.ef_accum, ef_rows)
                else:
                    ef_accum = ef_rows
            else:
                agg_delta = engine.server_delta(fed, params, stacked, rows_w,
                                                rows_g, key=akey,
                                                reduce=reduce)
            del stacked
            finite = engine.aggregate_finite(fed, agg_delta, server_loss)
            if finite is not None and axis is not None:
                finite = axis.all_true(finite)      # every shard finite
            new_params, opt_state, inflight, last_delta, info = (
                engine.apply_aggregate(fed, state, params, agg_delta,
                                       inclusion_mass(fed, agg_w, agg_g),
                                       gates, finite))
            del agg_delta
            new_state = _next_state(fed, state, new_params, opt_state,
                                    sel_gates, gates, util_ema, inflight,
                                    last_delta,
                                    engine.skips_update(state, finite),
                                    ef_accum=ef_accum)
        return new_state, _round_stats(fed, server_loss, local_losses, gates,
                                       new_state, pm, w, info, lost)

    return round_step


def make_temporal_round(model, fed, cohort: int, device="cuda"):
    """Returns round_step(state, batch, round_idx=0) -> (new_state, stats),
    the batch and stats as ``make_spatial_round``'s: the clients stream
    one at a time (see the module note). ``cohort`` is the client count,
    the reference's argument; the round reads C from the batch."""
    E = fed.local_epochs
    lr = fed.lr
    if (engine.resolve_failure_model(fed.failure_model) in ("corrupt", "chaos")
            and fed.corrupt_rate > 0):
        raise ValueError(
            f"failure model {fed.failure_model!r} with corrupt_rate="
            f"{fed.corrupt_rate} poisons trained params in transit, but the "
            "temporal (FSDP) round streams clients through a scan carry and "
            "has no per-client materialization to corrupt on the linear "
            "path — use the spatial round for corruption faults, or set "
            "corrupt_rate=0 (crash/drop-out faults stream fine)")
    validate_config(fed)
    strategy = engine.get_strategy(fed.selection)
    if strategy.needs_deltas and not fed.grad_sim_sketch:
        raise ValueError(
            f"selection {fed.selection!r} needs client deltas; the temporal "
            "(FSDP) round streams clients and can only score them on a "
            "CountSketch of their delta — set FedConfig.grad_sim_sketch=True "
            "(and size sketch_dim) to opt in to the JL-approximate statistic "
            "(the spatial round then sketches too, keeping the modes "
            "identical), or use the spatial round for exact cosines")
    dev = resolve_device(device)
    codec_on = resolve_wire_codec(fed.wire_codec) != "identity"
    ef_on = codec_on and bool(fed.error_feedback)
    # order statistics, whole-delta norms, direction cosines and coded
    # rows need every client's delta at once: gather [C, ...]
    robust_gather = resolve_aggregator(fed.aggregator) != "mean" or codec_on
    agg_needs_key = get_aggregator(fed.aggregator).needs_key

    def sketches(params, client_batch, C, buf, round_idx):
        """grad_sim's pass 1: [C, sketch_dim], each client trained into
        ``buf`` and sketched from its delta, made in place in ``buf``."""
        one = tree_map(lambda d: d[None], buf)
        key = engine.sketch_key(fed, round_idx)
        rows = []
        for c in range(C):
            _train_steps(model, params, _client(client_batch, c), lr, E,
                         out=buf)
            with torch.no_grad():
                tree_map(torch.Tensor.sub_, buf, params)
                rows.append(engine.delta_sketch(one, key,
                                                int(fed.sketch_dim))[0])
        return torch.stack(rows)

    def round_step(state, batch, round_idx=0, client_ids=None):
        round_idx = int(round_idx)
        params = state.params
        _check_params_device(params, dev)
        client_batch = batch["clients"]
        pm = batch["priority_mask"]
        w = batch["weights"]
        C = pm.shape[0]
        server_loss, local_losses, util_ema = _eval_pass(model, fed, state,
                                                         batch)
        part, lost, _ = engine.round_faults(fed, state, round_idx, C, dev,
                                            client_ids=client_ids)
        buf = None                          # the one streamed client copy
        delta_cos = None
        if strategy.needs_deltas:
            buf = tree_map(torch.empty_like, params)
            flat = sketches(params, client_batch, C, buf, round_idx)
            with torch.no_grad():
                delta_cos = engine.cosine_to_priority(flat, w, pm)
        with torch.no_grad():
            sel_gates = gates = engine.compute_gates(
                _gate_ctx(fed, state, util_ema, local_losses, server_loss, pm,
                          w, delta_cos, round_idx=round_idx,
                          participation=part), fed.selection)
            if lost is not None:
                # a lost client's delta never reaches the sum: it skips its
                # E steps, and keeps its selection gate for the backlog
                gates = gates * (1.0 - lost.float())
        trains = (gates > 0).tolist()       # the host's one read a round

        ef_accum = None
        if robust_gather:
            del buf
            stacked = _train_stack(model, params, client_batch, range(C), lr,
                                   E, trains)
            with torch.no_grad():
                akey = (aggregator_key(fed, round_idx) if agg_needs_key
                        else None)
                if ef_on:
                    agg_delta, ef_accum = engine.server_delta(
                        fed, params, stacked, w, gates, key=akey,
                        ef_accum=state.ef_accum)
                else:
                    agg_delta = engine.server_delta(fed, params, stacked, w,
                                                    gates, key=akey)
                del stacked
                mass = inclusion_mass(fed, w, gates)
        else:
            if buf is None:
                buf = tree_map(torch.empty_like, params)
            with torch.no_grad():
                num = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)
                den = torch.zeros((), dtype=torch.float32, device=dev)
            for c in range(C):
                if not trains[c]:           # adds w_k * 0 * p: nothing
                    continue
                _train_steps(model, params, _client(client_batch, c), lr, E,
                             out=buf)
                with torch.no_grad():
                    wg = w[c] * gates[c]
                    tree_map(lambda n, pk: n.add_(wg * pk.float()), num, buf)
                    den = den + wg
            del buf
            with torch.no_grad():
                # where(den > 0, num / max(den, 1e-30) - p, 0), in place
                safe, empty = torch.clamp(den, min=1e-30), den <= 0
                for n, p in zip(tree_leaves(num), tree_leaves(params)):
                    n.div_(safe).sub_(p.float()).masked_fill_(empty, 0.0)
            agg_delta, mass = num, den

        with torch.no_grad():
            finite = engine.aggregate_finite(fed, agg_delta, server_loss)
            new_params, opt_state, inflight, last_delta, info = (
                engine.apply_aggregate(fed, state, params, agg_delta, mass,
                                       gates, finite))
            del agg_delta
            new_state = _next_state(fed, state, new_params, opt_state,
                                    sel_gates, gates, util_ema, inflight,
                                    last_delta,
                                    engine.skips_update(state, finite),
                                    ef_accum=ef_accum)
        return new_state, _round_stats(fed, server_loss, local_losses, gates,
                                       new_state, pm, w, info, lost)

    return _pool_wrap(fed, round_step)


def make_round_step(model, fed, num_clients: int, *, fsdp: bool,
                    device="cuda"):
    return (make_temporal_round(model, fed, num_clients, device) if fsdp
            else make_spatial_round(model, fed, num_clients, device))


# ------------------------------------------------------------ the pod round
# Every collective a pod round issued in this process, dp and model alike:
# the collective layer's list, re-exported here
COLLECTIVES = model_axis.COLLECTIVES

_ORDER_STATS = ("trimmed_mean", "median")


class _Pod:
    """One rank of the dp group: its block of the C clients and the
    round's two collectives, each recorded in ``COLLECTIVES``."""

    def __init__(self, group, name):
        import torch.distributed as dist
        self.group, self.name = group, name
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def block(self, C):
        """(offset, count) of the rank's clients: a contiguous block."""
        n = C // self.size
        return self.rank * n, n

    def _record(self, kind, t):
        COLLECTIVES.append({"kind": kind, "group": self.name,
                            "bytes": t.numel() * t.element_size()})

    def all_gather(self, x):
        """The ranks' equal [n, ...] blocks -> [size * n, ...], rank order."""
        import torch.distributed as dist
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        self._record("all_gather", out)
        return out

    def all_reduce(self, x):
        import torch.distributed as dist
        dist.all_reduce(x, group=self.group)
        self._record("all_reduce", x)
        return x

    def reducer(self, fed, agg_w, agg_g, agg_ids, C):
        """The ``reduce=`` of this rank's aggregation (see
        ``make_pod_round``). ``agg_w`` / ``agg_g`` are the replicated
        weights and gates of the round's aggregation rows, client ids
        ``agg_ids`` (a cohort's) or 0..C-1 (None)."""
        _, n = self.block(C)
        ids = (torch.arange(agg_w.shape[0], device=agg_w.device)
               if agg_ids is None else agg_ids)
        owner = ids // n                    # the rank that trained each row
        if resolve_aggregator(fed.aggregator) in _ORDER_STATS:
            return self._order_stats(agg_w, agg_g, owner, _row_cap(fed, n))
        mass = inclusion_mass(fed, agg_w, agg_g)
        by_rank = torch.zeros(self.size, dtype=torch.float32,
                              device=agg_w.device).index_add_(
            0, owner, agg_w.float() * agg_g.float())
        has = torch.nonzero(by_rank > 0).flatten().tolist()
        noise_here = bool(has) and has[0] == self.rank

        def reduce(updates, weights, gates, *, noise=None, **kw):
            # the rank's rows reduce to its share of the mean: the kernel's
            # mean over them times their share of the round's mass; the
            # ranks' shares sum to the mean in the one all-reduce
            if kw.get("aggregator") == "dp" and not noise_here:
                kw["noise_scale"] = 0.0     # the one noise draw lands once
            if updates.shape[0] == 0:
                m = updates.shape[1] if kw.get("out_m") is None else kw["out_m"]
                dt = (updates.dtype if kw.get("codec", "identity") == "identity"
                      else torch.float32)
                out = torch.zeros(int(m), dtype=dt, device=updates.device)
            else:
                out = kops.fedagg(updates, weights, gates, noise=noise, **kw)
                local = inclusion_mass(fed, weights, gates)
                share = torch.where(mass > 0, local / mass,
                                    torch.zeros_like(mass))
                out.mul_(share)
            return self.all_reduce(out)
        return reduce

    def _order_stats(self, agg_w, agg_g, owner, cap):
        """trimmed_mean / median: every rank gathers the round's rows (each
        rank's padded to ``cap``), puts them in the aggregation's order and
        runs the one launch over all of them."""
        # each row's place in the gathered buffer: its owner's block, then
        # its place among the owner's rows (they are in agg order)
        perm, seen = [], [0] * self.size
        for r in owner.tolist():
            perm.append(r * cap + seen[r])
            seen[r] += 1
        identity = perm == list(range(self.size * cap))
        perm = torch.tensor(perm, device=owner.device)

        def reduce(updates, weights, gates, *, noise=None, **kw):
            mine = updates.shape[0]
            padded = updates.new_zeros((cap,) + tuple(updates.shape[1:]))
            padded[:mine] = updates
            every = self.all_gather(padded)
            if not identity:
                every = every[perm]
            return kops.fedagg(every, agg_w, agg_g, noise=noise, **kw)
        return reduce


def _row_cap(fed, n):
    """The most aggregation rows a rank of n clients holds: n, or a
    cohort's K when that is fewer."""
    cohort = (fed.max_cohort > 0
              and not engine.get_strategy(fed.selection).needs_deltas)
    return min(int(fed.max_cohort), n) if cohort else n


def pod_round_plan(fed, M_total: int, C: int, dp: int, *, axes=("data",),
                   model=None, trained=None):
    """The collectives one pod round promises over ``dp`` ranks of C / dp
    clients each, in the order it issues them: the all-gather of the [C]
    f32 local losses (the control plane), then one all-reduce of the
    [M_total] aggregate (mean, dp and every wire codec: ``fed.agg_dtype``
    on the identity wire, f32 decoded), or, under trimmed_mean / median,
    the all-gather of every rank's client rows (``_row_cap`` of them, in
    ``fed.agg_dtype``), the reference's documented allowance. Raises as
    ``make_pod_round`` does for a knob the pod round refuses.

    On a model axis, ``M_total`` is the rank's M_local and ``model`` a
    ``model_axis.LossPlan``: the model group's collectives of the server
    loss and the rank's n client losses come first, those of its
    ``trained`` (default n) clients' E local steps each between the loss
    gather and the reduce, and, under the divergence guard, the group's
    finite flag last."""
    check_pod_config(fed, model=1 if model is None else model.size)
    n = C // dp
    group = "+".join(axes)
    plan = []
    if model is not None:
        plan += model.loss(model.server, train=False)
        plan += model.loss(model.client, train=False) * n
    plan.append({"kind": "all_gather", "group": group, "bytes": C * 4})
    if model is not None:
        steps = fed.local_epochs * (n if trained is None else int(trained))
        plan += model.loss(model.client, train=True) * steps
    ad = torch.empty((), dtype=getattr(torch, fed.agg_dtype)).element_size()
    if resolve_aggregator(fed.aggregator) in _ORDER_STATS:
        plan.append({"kind": "all_gather", "group": group,
                     "bytes": dp * _row_cap(fed, n) * M_total * ad})
    else:
        wire = 4 if resolve_wire_codec(fed.wire_codec) != "identity" else ad
        plan.append({"kind": "all_reduce", "group": group,
                     "bytes": M_total * wire})
    if model is not None and fed.divergence_guard:
        plan.append({"kind": "all_reduce", "group": model_axis.MODEL,
                     "bytes": 4})
    return plan


def _refuse(what):
    raise NotImplementedError(f"the pod round: {what} is not ported yet "
                              "(ROADMAP A17b)")


def check_pod_config(fed, model: int = 1):
    """Refuse the FedConfig knobs the pod round has not reached (ROADMAP
    A17b) with ``NotImplementedError``: ``grad_sim``, ``cosine_filter``,
    candidate pools, ``fused_agg=False`` and a wire codec under
    trimmed_mean / median on any mesh; on a model axis ``model`` > 1 also
    the ``dp`` aggregator, every wire codec and ``adaptive_staleness``
    (a per-row clip norm, int8 scale, top-k, sketch or drift sketch spans
    the whole row, across the shards)."""
    if model > 1:
        if resolve_aggregator(fed.aggregator) == "dp":
            _refuse("aggregator='dp' on a model axis (its per-row clip "
                    "norm spans the shards)")
        if resolve_wire_codec(fed.wire_codec) != "identity":
            _refuse(f"wire_codec={fed.wire_codec!r} on a model axis (its "
                    "row scale, top-k or sketch spans the shards)")
        if fed.async_depth > 0 and fed.adaptive_staleness:
            _refuse("adaptive_staleness on a model axis (its drift sketch "
                    "spans the shards)")
    if engine.get_strategy(fed.selection).needs_deltas:
        _refuse(f"selection={fed.selection!r} (the cosine to the priority "
                "mean delta crosses ranks)")
    if resolve_aggregator(fed.aggregator) == "cosine_filter":
        _refuse("aggregator='cosine_filter'")
    if int(fed.candidate_pool) > 0:
        _refuse("candidate_pool")
    if not fed.fused_agg:
        _refuse("fused_agg=False (one all-reduce a leaf)")
    if (resolve_aggregator(fed.aggregator) in _ORDER_STATS
            and resolve_wire_codec(fed.wire_codec) != "identity"):
        _refuse(f"wire_codec={fed.wire_codec!r} under {fed.aggregator}")


def make_pod_round(model, fed, num_clients: int, mesh, device="cuda"):
    """Returns round_step(state, batch, round_idx=0) -> (new_state, stats):
    the spatial round as one SPMD program a rank over ``mesh``'s dp axes
    (``pod``, ``data``) and its ``model`` axis.

    Rank r of a dp group owns the contiguous block of C / dp clients from
    r * C / dp (C must divide, as the reference's ``P(dp, None)`` client
    spec requires): its ``batch["clients"]`` holds only that block, the
    rest of the batch (server batch, priority mask, weights) and the state
    are replicated over dp. A round:

    1. each rank evaluates its own clients at the received model and the
       [C] losses are all-gathered (a control-plane collective); the
       server loss is computed on every rank;
    2. every rank computes the same gates, cohort and fault plan from the
       replicated state, with global client ids for the fault layer and
       the codecs;
    3. each rank trains its included (or cohort) clients and reduces its
       own rows in the one fused fedagg launch: under mean, dp and every
       wire codec into its share of the aggregate, then one all-reduce of
       the [M] aggregate (dp clips per row; its noise, drawn once from the
       replicated key, is added on one rank only); under trimmed_mean /
       median the rows are all-gathered and K3 runs over all of them on
       every rank;
    4. the server optimizer, the in-flight buffer, the guard and the EMAs
       step identically on every rank.

    A rank with no included client contributes zeros. The wire codecs'
    error-feedback rows stay on the rank that owns the client: each rank
    advances its own rows of ``state.ef_accum`` and reads no other.

    **The model axis** (``model`` > 1; the dense GQA family: qwen1.5-0.5b,
    qwen2.5-3b, phi3-mini-3.8b). ``make_host_mesh`` is rank-major with
    model the minor axis: the model group is the ranks that share a dp
    index, the dp group the ranks that share a model index. Each rank
    holds only its shard of every leaf as ``specs.auto_param_specs``
    places it (``step.shard`` / ``step.gather`` move whole params to and
    from them; the state's leaves follow ``federation_state_specs``, as
    ``engine.init_state`` of the shards makes them). Every loss runs
    tensor-parallel over the model group (``sharding/model_axis.py``,
    ``cfg.seq_shard_attn`` its attention's sequence layout), so every rank
    of a group computes the same losses, gates and decisions; each rank
    flattens its local leaves into [n, M_local] rows, one fedagg launch
    and one dp all-reduce (or row gather) of [M_local] aggregate them, the
    replicated leaves (norm scales) identically on every model rank, and
    the server optimizer steps the local shards. Under the divergence
    guard the finite flag is agreed over the model group.

    Refused with ``NotImplementedError`` (ROADMAP A17b): an FSDP arch
    (``needs_fsdp``, the FSDP temporal pod round), ``grad_sim``,
    ``cosine_filter``, candidate pools, ``fused_agg=False`` and a wire
    codec under trimmed_mean / median; on a model axis > 1 also every arch
    outside the dense GQA family (MoE, MLA, jamba, xlstm, enc-dec, llava),
    query heads that do not divide the axis without ``seq_shard_attn``,
    a spec placed off its layer's dim, the ``dp`` aggregator, the four
    wire codecs and ``adaptive_staleness``. ``pod_round_plan`` gives the
    collectives a round issues; ``COLLECTIVES`` records them."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.sharding.specs import dp_axes, mesh_axes
    dev = resolve_device(device)
    sizes = mesh_axes(mesh)
    m = sizes.get("model", 1)
    cfg = model.cfg
    if needs_fsdp(cfg):
        _refuse(f"{cfg.name}'s FSDP temporal round")
    check_pod_config(fed, model=m)
    axes = dp_axes(mesh)
    if list(sizes) not in (list(axes), list(axes) + ["model"]):
        raise ValueError(f"make_pod_round: mesh axes {list(sizes)}; give "
                         "(pod,) data(, model) with model last")
    axis, specs = None, None
    if m > 1:
        model_axis.check_model(cfg, m)
        specs = model_axis.param_specs(cfg, mesh)
    ranks = mesh.mesh.reshape(-1, m)            # [dp, m], rank-major
    if m == 1:
        flat = ranks.flatten().tolist()
        group = (None if len(flat) == dist.get_world_size()
                 else dist.new_group(sorted(flat)))
    else:
        me = dist.get_rank()
        # every rank makes every group, in one order
        dp_groups = [dist.new_group(ranks[:, j].tolist()) for j in range(m)]
        mp_groups = [dist.new_group(row.tolist()) for row in ranks]
        i, j = [int(x) for x in (ranks == me).nonzero()[0]]
        group = dp_groups[j]
        axis = model_axis.ModelAxis(mp_groups[i])
        from repro_torch.models import transformer
        model = dataclasses.replace(model, loss_fn=lambda params, batch:
                                    transformer.loss_fn(params, batch, cfg,
                                                        tp=axis))
    pod = _Pod(group, "+".join(axes))
    if int(num_clients) % pod.size:
        raise ValueError(f"{num_clients} clients do not split over the "
                         f"{pod.size} dp ranks ({'x'.join(axes)})")
    step = _spatial_step(model, fed, dev, pod=pod, axis=axis)
    step.pod = pod                          # .rank, .size, .block(C)
    step.specs = specs                      # None on a model axis of 1
    step.shard = (lambda params: params) if specs is None else (
        lambda params: model_axis.shard_params(params, specs, mesh))
    step.gather = (lambda params: params) if specs is None else (
        lambda params: model_axis.gather_params(params, specs, mesh))
    return step
