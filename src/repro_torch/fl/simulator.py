"""In-silico federation driver: FedALIGN rounds, evaluation and history.

Counterpart of ``repro/fl/simulator.py``. The reference scans chunks of
``eval_every`` rounds inside one jitted program; here a chunk is a python
loop of rounds, and the host reads the chunk's stats (one transfer per stat)
and evaluates the test set at the same boundaries, so the eval cadence and
the History contents are the reference's. The round key chain is the same:
``rng, rkey = split(rng)`` once per round. The divergence guard's halt is
read at the same chunk boundaries, and ``drain_inflight`` flushes a
``scan_async`` buffer after the last round, as in the reference.

Checkpoint/resume to disk (``checkpoint_path``, ROADMAP A14) is not
ported and raises.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.aggregation import check_client_weights, dp_report
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
    pass ``state``/``rng`` plus ``start_round`` to continue a run held in
    memory (its in-flight buffer is copied: the rounds move its slots in
    place). Under the divergence guard with ``fed.max_nonfinite_skips > 0``
    the run halts at the first chunk boundary whose rounds reached that
    many consecutive skips, and ``hist.diverged_at`` names the round.
    ``drain_inflight=True`` applies the still-buffered deltas after the
    last round (``engine.drain_inflight``). Returns the History, with
    ``params``, ``state`` and ``rng`` of the last round attached."""
    if checkpoint_path is not None:
        raise NotImplementedError(
            "run_federation(checkpoint_path=...) is not ported yet "
            "(ROADMAP A14)")
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
    elif isinstance(state.inflight, dict):
        state = state.replace(inflight=tree_map(torch.clone, state.inflight))
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
        state = engine.drain_inflight(fed, state)
    hist.params = state.params
    hist.state = state
    hist.rng = rng
    # DP budget spent (None unless aggregator='dp' with noise): one Gaussian
    # mechanism per executed round since round 0 (a halted run's last
    # chunk included), via the RDP accountant
    dp = dp_report(fed, start)
    hist.dp_epsilon, hist.dp_delta = dp if dp is not None else (None, None)
    return hist
