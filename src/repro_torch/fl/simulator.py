"""In-silico federation driver: FedALIGN rounds, evaluation and history.

Counterpart of ``repro/fl/simulator.py``. The reference scans chunks of
``eval_every`` rounds inside one jitted program; here a chunk is a python
loop of rounds, and the host reads the chunk's stats (one transfer per stat)
and evaluates the test set at the same boundaries, so the eval cadence and
the History contents are the reference's. The round key chain is the same:
``rng, rkey = split(rng)`` once per round.

Checkpoint/resume to disk (``checkpoint_path``) and draining an async
buffer (``drain_inflight``) belong to features not ported yet and raise.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.aggregation import check_client_weights
from repro_torch.core.metrics import History
from repro_torch.data.synth import Federation
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
    memory. Returns the History, with ``params``, ``state`` and ``rng`` of
    the last round attached."""
    if checkpoint_path is not None:
        raise NotImplementedError(
            "run_federation(checkpoint_path=...) is not ported yet")
    if drain_inflight:
        raise NotImplementedError(
            "run_federation(drain_inflight=True) is not ported yet "
            "(scan_async is not ported)")
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
    rng = prng.PRNGKey(fed.seed) if rng is None else torch.as_tensor(rng).cpu()
    hist = History()

    # chunk boundaries = the eval rounds (r % eval_every == 0, plus the
    # final round), absolute, so a continued run keeps the cadence
    bounds = sorted(b for b in set(range(0, fed.rounds, eval_every))
                    | {fed.rounds - 1} if b >= start_round)
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
    hist.params = state.params
    hist.state = state
    hist.rng = rng
    hist.dp_epsilon, hist.dp_delta = None, None   # no dp aggregator ported
    return hist
