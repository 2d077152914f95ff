"""In-silico federation driver: FedALIGN rounds, evaluation and history.

Counterpart of ``repro/fl/simulator.py``. The reference scans chunks of
``eval_every`` rounds inside one jitted program; here a chunk is a python
loop of rounds, and the host reads the chunk's stats (one transfer per stat)
and evaluates the test set at the same boundaries, so the eval cadence and
the History contents are the reference's. The round key chain is the same:
``rng, rkey = split(rng)`` once per round. The divergence guard's halt is
read at the same chunk boundaries, and ``drain_inflight`` flushes a
``scan_async`` buffer after the last round, as in the reference.

Runs are resumable, in the reference's file format: ``checkpoint_path``
writes the full (state, rng) carry at every chunk boundary
(``save_federation_state``, ``checkpoint/io.py``), and
``load_federation_state`` plus ``run_federation(state=..., rng=...,
start_round=...)`` continue the run bit for bit, an in-flight
``scan_async`` buffer and candidate-pool draws included: the round key is
split once a round whatever the chunking, and every other stream is keyed
on the absolute round. A checkpoint written by either package loads in
the other.

``run_local_baseline`` (paper App. C.1) trains every listed client alone
from its own init, all of them in one vmapped solve, and reports each
one's accuracy on the global test set.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint.io import load_pytree, save_pytree
from repro_torch.core.aggregation import (check_client_weights, dp_report,
                                          resolve_aggregator,
                                          resolve_wire_codec)
from repro_torch.core.metrics import History
from repro_torch.data.synth import Federation
from repro_torch.fl import engine
from repro_torch.fl.engine import init_state, make_round_fn
from repro_torch.utils import resolve_device, tree_map


def _param_device(params) -> torch.device:
    return next(iter(params.values())).device


@torch.no_grad()
def evaluate(loss_fn, params, x, y, batch=4096):
    """Mean loss and accuracy over a test set, on the params' device: full
    batches plus one remainder batch, summed on the device and moved to the
    host once."""
    dev = _param_device(params)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    n = y.shape[0]
    bs = min(batch, n)
    m, rem = divmod(n, bs)
    loss_tot = acc_tot = torch.zeros((), dtype=torch.float32, device=dev)
    if m:
        losses, accs = [], []
        for i in range(m):
            loss, met = loss_fn(params, {"x": x[i * bs:(i + 1) * bs],
                                         "y": y[i * bs:(i + 1) * bs]})
            losses.append(loss)
            accs.append(met["acc"])
        loss_tot = torch.sum(torch.stack(losses)) * bs
        acc_tot = torch.sum(torch.stack(accs)) * bs
    if rem:
        loss, met = loss_fn(params, {"x": x[m * bs:], "y": y[m * bs:]})
        loss_tot = loss_tot + loss * rem
        acc_tot = acc_tot + met["acc"] * rem
    out = torch.stack([loss_tot, acc_tot]).cpu().numpy() / n
    return float(out[0]), float(out[1])


def _state_fingerprint(fed) -> Optional[dict]:
    """The run knobs whose mismatch on resume changes no leaf shape, the
    reference's dict in its key order (it is written into the file): the
    buffer's pop policy, a non-mean aggregator, the event clock's draws
    and deadline, the failure model and its rates, a non-identity wire
    codec and its rate, the candidate pool and its weighting. Only
    non-default knobs are recorded; None when there are none."""
    if fed is None:
        return None
    fp = {}
    if fed.async_depth > 0:
        fp.update(async_mode=fed.async_mode, min_lag=int(fed.min_lag),
                  adaptive_staleness=bool(fed.adaptive_staleness))
    agg = resolve_aggregator(fed.aggregator)
    if agg != "mean":
        fp["aggregator"] = agg
    if fed.latency_mode != "none":
        fp.update(latency_mode=fed.latency_mode,
                  latency_mu=float(fed.latency_mu),
                  latency_sigma=float(fed.latency_sigma),
                  latency_net_mu=float(fed.latency_net_mu),
                  latency_net_sigma=float(fed.latency_net_sigma))
    if float(fed.round_deadline) != float("inf"):
        fp["round_deadline"] = float(fed.round_deadline)
    fm = engine.resolve_failure_model(fed.failure_model)
    if fm != "none":
        fp.update(failure_model=fm, crash_rate=float(fed.crash_rate),
                  dropout_rate=float(fed.dropout_rate),
                  dropout_len=int(fed.dropout_len),
                  corrupt_rate=float(fed.corrupt_rate),
                  corrupt_scale=float(fed.corrupt_scale))
    wc = resolve_wire_codec(fed.wire_codec)
    if wc != "identity":
        fp.update(wire_codec=wc, error_feedback=bool(fed.error_feedback))
        if wc == "topk":
            fp["codec_topk_frac"] = float(fed.codec_topk_frac)
        if wc == "sketch":
            fp["codec_sketch_dim"] = int(fed.codec_sketch_dim)
    if int(fed.candidate_pool) > 0:
        fp.update(candidate_pool=int(fed.candidate_pool),
                  pool_weighting=str(fed.pool_weighting))
    return fp or None


def save_federation_state(path: str, state, rng, round_idx: int,
                          fed=None) -> None:
    """Checkpoint the full cross-round carry, the FederationState and the
    driver's PRNG key (on disk as the reference's uint32 words), as one
    pytree ``{"state", "rng"}`` with step ``round_idx``; with ``fed``, its
    ``_state_fingerprint`` rides along for ``load_federation_state`` to
    check."""
    key = np.asarray(torch.as_tensor(rng).cpu().numpy(), dtype=np.uint32)
    save_pytree(path, {"state": state, "rng": key}, step=int(round_idx),
                meta=_state_fingerprint(fed))


def load_federation_state(path: str, like_state, fed=None, device="cuda"):
    """Restore ``(state, rng, next_round)`` written by
    ``save_federation_state`` (of either package). ``like_state`` fixes
    the structure, shapes and dtypes (``engine.init_state`` with the
    run's config makes one); the state goes to ``device``, the key stays
    on the host, as the simulator keeps it. With ``fed``, a fingerprint
    that differs from the writer's raises the reference's ``ValueError``;
    a file with no fingerprint loads unchecked."""
    dev = resolve_device(device)
    tree, step, meta = load_pytree(path, {"state": like_state,
                                          "rng": prng.PRNGKey(0)},
                                   device=dev)
    if fed is not None and meta is not None:
        want = _state_fingerprint(fed) or {}
        if meta != want:
            raise ValueError(
                f"checkpoint {path!r} was written with run fingerprint "
                f"{meta} but this config resumes with {want or '{}'} — "
                "async slot ages/timers would pop on the wrong schedule, "
                "the optimizer moments would be fed by a different "
                "aggregator, the restored error-feedback accumulators "
                "would re-inject residuals of a different wire codec (or "
                "topk/sketch rate), and/or the fault-injection stream "
                "would diverge from the writer's, and/or the candidate-pool "
                "sampler would draw different pools from this round on. "
                "Resume with the writer's async_mode/min_lag/"
                "adaptive_staleness/aggregator/latency_*/round_deadline/"
                "failure-model/wire_codec/error_feedback/codec-rate/"
                "candidate_pool/pool_weighting knobs (or drain the buffer "
                "before switching policies)")
    return tree["state"], tree["rng"].cpu(), step


def federation_tensors(federation: Federation, device):
    """The round's inputs on ``device``: data {'x','y'} [C, n, ...], the
    priority mask and the checked client weights."""
    data = {"x": torch.from_numpy(np.ascontiguousarray(federation.x)).to(device),
            "y": torch.from_numpy(np.asarray(federation.y, np.int64)).to(device)}
    pm = torch.from_numpy(np.asarray(federation.priority_mask, bool)).to(device)
    w = check_client_weights(np.asarray(federation.weights, np.float32),
                             where="Federation.weights")
    return data, pm, torch.from_numpy(w).to(device)


def run_federation(loss_fn: Callable, init_params, fed, federation: Federation,
                   *, eval_every: int = 1, verbose: bool = False,
                   state=None, rng=None, start_round: int = 0,
                   checkpoint_path: Optional[str] = None,
                   drain_inflight: bool = False, device="cuda") -> History:
    """Run FedALIGN communication rounds ``start_round .. fed.rounds - 1`` on
    ``device`` (default the card; raises if there is none).

    ``init_params`` seeds a fresh FederationState (copied to ``device``);
    pass ``state``/``rng`` plus ``start_round`` (``load_federation_state``)
    to continue a run bit for bit; the in-flight buffer and the
    error-feedback rows are copied, since the rounds update them in place.
    ``checkpoint_path`` writes the (state, rng) carry at every chunk
    boundary (``save_federation_state``), so a killed run loses at most
    ``eval_every`` rounds. Under the divergence guard with
    ``fed.max_nonfinite_skips > 0`` the run halts at the first chunk
    boundary whose rounds reached that many consecutive skips, and
    ``hist.diverged_at`` names the (absolute) round. ``drain_inflight=True``
    applies the still-buffered deltas after the last round
    (``engine.drain_inflight``) and rewrites the final checkpoint with the
    drained state, so a resume can never apply them twice. Returns the
    History, with ``params``, ``state`` and ``rng`` of the last round
    attached."""
    dev = resolve_device(device)
    round_fn = make_round_fn(loss_fn, fed)
    data, pm, w = federation_tensors(federation, dev)
    test_x = torch.from_numpy(np.ascontiguousarray(federation.test_x)).to(dev)
    test_y = torch.from_numpy(np.asarray(federation.test_y, np.int64)).to(dev)
    C = int(pm.shape[0])
    if state is None:
        # private copy: the caller keeps ownership of what it passed in
        state = init_state(tree_map(lambda p: p.to(dev, copy=True), init_params),
                           fed, C)
    else:
        state = state.replace(inflight=tree_map(torch.clone, state.inflight),
                              ef_accum=tree_map(torch.clone, state.ef_accum))
    rng = prng.PRNGKey(fed.seed) if rng is None else torch.as_tensor(rng).cpu()
    hist = History()

    # chunk boundaries = the eval rounds (r % eval_every == 0, plus the
    # final round), absolute, so a continued run keeps the cadence
    bounds = sorted(b for b in set(range(0, fed.rounds, eval_every))
                    | {fed.rounds - 1} if b >= start_round)
    halt_skips = (int(fed.max_nonfinite_skips)
                  if fed.divergence_guard else 0)
    hist.diverged_at = None
    start = start_round
    for b in bounds:
        n = b - start + 1
        chunk = []
        for i in range(n):
            rng, rkey = prng.split(rng)
            state, stats = round_fn(state, data, pm, w, rkey, start + i)
            chunk.append(stats)
        stats_np = {k: torch.stack([s[k] for s in chunk]).cpu().numpy()
                    for k in chunk[0]}
        tl, ta = evaluate(loss_fn, state.params, test_x, test_y)
        for i in range(n):
            s = {k: v[i] for k, v in stats_np.items()}
            if i == n - 1:
                hist.log(s, test_acc=ta, test_loss=tl)
                if verbose:
                    print(f"  round {b:4d} loss={float(s['global_loss']):.4f} "
                          f"test_acc={ta:.4f} "
                          f"inc={float(s['included_nonpriority']):.1f}")
            else:
                hist.log(s)
        if checkpoint_path is not None:
            save_federation_state(checkpoint_path, state, rng, b + 1, fed=fed)
        start = b + 1
        if halt_skips > 0:
            # the guard already kept every non-finite aggregate off the
            # params; past the skip budget the run stops, as the reference's
            skips = stats_np["skipped_nonfinite"]
            hit = np.flatnonzero(skips >= halt_skips)
            if hit.size:
                hist.diverged_at = int(b - n + 1 + hit[0])
                print(f"run_federation: halting at round {hist.diverged_at} "
                      f"— {int(skips[hit[0]])} consecutive non-finite "
                      f"aggregates (>= max_nonfinite_skips={halt_skips}); "
                      "params are the last finite ones")
                break
    if drain_inflight:
        had_buffer = isinstance(state.inflight, dict)
        state = engine.drain_inflight(fed, state)
        if checkpoint_path is not None and had_buffer:
            # the last boundary's file predates the drain: rewrite it, so a
            # resume sees an empty buffer and a second drain is a no-op
            save_federation_state(checkpoint_path, state, rng, fed.rounds,
                                  fed=fed)
    hist.params = state.params
    hist.state = state
    hist.rng = rng
    # DP budget spent (None unless aggregator='dp' with noise): one Gaussian
    # mechanism per executed round since round 0 (a halted run's last
    # chunk included), via the RDP accountant
    dp = dp_report(fed, start)
    hist.dp_epsilon, hist.dp_delta = dp if dp is not None else (None, None)
    return hist


def train_local_baseline(loss_fn, init_fn, fed, federation: Federation, *,
                         epochs: Optional[int] = None, client_ids=None,
                         device="cuda"):
    """The training of ``run_local_baseline``: every listed client (all by
    default) alone on its local data, all of them in one vmapped solve on
    ``device``. Returns (the client ids in order, their trained params
    stacked on a leading [K] axis).

    The reference's key stream and chunks: ``rng = PRNGKey(fed.seed + 1)``
    is split once a client in ``client_ids`` order, and that client's key
    into ``max(epochs // E, 1)`` chunk keys; a chunk is E epochs of the
    round's local solver from the chunk's starting params (FedProx's
    anchor), its minibatch order ``minibatch_order`` of the chunk key, at
    the constant ``fed.lr``. ``epochs`` defaults to ``fed.rounds * E``;
    only whole chunks run, as in the reference. Client c starts from
    ``init_fn(fed.seed + 100 + c, device=...)``."""
    dev = resolve_device(device)
    E = fed.local_epochs
    epochs = epochs or fed.rounds * E
    chunks = max(epochs // E, 1)
    ids = list(client_ids) if client_ids is not None else list(
        range(federation.x.shape[0]))
    rng = prng.PRNGKey(fed.seed + 1)
    keys = []
    for _ in ids:
        rng, k = prng.split(rng)
        keys.append(prng.split(k, chunks))
    keys = torch.stack(keys, dim=1).to(dev)                   # [chunks, K, 2]
    sel = np.asarray(ids, np.int64)
    data = {"x": torch.from_numpy(np.ascontiguousarray(federation.x[sel])).to(dev),
            "y": torch.from_numpy(np.asarray(federation.y[sel], np.int64)).to(dev)}
    n = data["y"].shape[1]
    params = tree_map(lambda *ps: torch.stack(ps),
                      *[init_fn(fed.seed + 100 + c, device=dev) for c in ids])
    steps = engine.local_steps(loss_fn, fed)
    lr = torch.tensor(fed.lr, dtype=torch.float32)
    for j in range(chunks):
        order = engine.minibatch_order(fed, keys[j], n)
        params = steps(params, params, data, order, lr)
    return ids, params


def local_accuracies(loss_fn, federation: Federation, ids, params):
    """``{client: accuracy}`` on the global test set of each client's model
    in ``params`` ([K]-stacked in ``ids`` order, as
    ``train_local_baseline`` returns them), on the params' device."""
    dev = _param_device(params)
    test_x = torch.from_numpy(np.ascontiguousarray(federation.test_x)).to(dev)
    test_y = torch.from_numpy(np.asarray(federation.test_y, np.int64)).to(dev)
    return {c: evaluate(loss_fn, tree_map(lambda p: p[i], params),
                        test_x, test_y)[1]
            for i, c in enumerate(ids)}


def run_local_baseline(loss_fn, init_fn, fed, federation: Federation, *,
                       epochs: Optional[int] = None, client_ids=None,
                       device="cuda"):
    """Paper App. C.1: train each client alone on its local data; report the
    per-client locally-trained model accuracy on the global test set, as
    ``{client: accuracy}``. Runs on ``device`` (default the card; raises if
    there is none): ``train_local_baseline``, then ``local_accuracies``."""
    ids, params = train_local_baseline(loss_fn, init_fn, fed, federation,
                                       epochs=epochs, client_ids=client_ids,
                                       device=device)
    return local_accuracies(loss_fn, federation, ids, params)
