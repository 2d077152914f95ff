"""FedALIGN rounds over the LM zoo on one card: the spatial round and the
temporal (streamed-client) round.

Counterpart of ``repro/fl/sharded.py``, its single-card part:
``make_spatial_round``, ``make_temporal_round``, ``make_round_step`` and
``needs_fsdp``. A round has the engine's persistent-state signature

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
from repro_torch import prng
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


def _eval_pass(model, fed, state, batch):
    """No grad: the server statistic F(w_t), each client's F_k(w_t) at the
    received model (the paper's matching statistic) and the utility EMA
    updated with them."""
    params, client_batch = state.params, batch["clients"]
    C = batch["priority_mask"].shape[0]
    with torch.no_grad():
        server_loss, _ = model.loss_fn(params, batch["server"])
        local_losses = torch.stack([
            model.loss_fn(params, _client(client_batch, c))[0]
            for c in range(C)])
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
        server_loss, local_losses, util_ema = _eval_pass(model, fed, state,
                                                         batch)
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
            stacked = _train_stack(model, params, client_batch, idx.tolist(),
                                   lr, E)
            with torch.no_grad():
                if ctf is not None:
                    stacked = ctf(stacked, params, idx)
                if lost is not None:
                    keep = 1.0 - lost.float()
                    agg_g = agg_g * keep[idx]
                    gates = gates * keep
            agg_w = w[idx]
            if ef_on:
                ef_rows = tree_map(lambda a: a[idx], state.ef_accum)
        else:
            # train first: every client, then the gates
            stacked = _train_stack(model, params, client_batch, range(C), lr,
                                   E)
            with torch.no_grad():
                if ctf is not None:
                    # before the delta statistic, as the reference's
                    stacked = ctf(stacked, params,
                                  torch.arange(C, device=dev))
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
            agg_w, agg_g = w, gates

        with torch.no_grad():
            ef_accum = None
            if ef_on:
                agg_delta, ef_rows = engine.server_delta(
                    fed, params, stacked, agg_w, agg_g, key=akey,
                    ef_accum=ef_rows)
                ef_accum = (tree_map(
                    lambda full, sub: full.index_copy(0, idx, sub),
                    state.ef_accum, ef_rows) if use_cohort else ef_rows)
            else:
                agg_delta = engine.server_delta(fed, params, stacked, agg_w,
                                                agg_g, key=akey)
            del stacked
            finite = engine.aggregate_finite(fed, agg_delta, server_loss)
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

    return _pool_wrap(fed, round_step)


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
