"""End-to-end FedALIGN training driver for the LM-scale architectures, on
one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --smoke --rounds 20 --clients 8 --seq 128 [--device cuda]

Counterpart of ``repro/launch/train.py``: the same flags (the shared
federation surface of ``configs/cli.py``) plus ``--device`` (default
``cuda``), the same token federation and per-round batches (numpy
``default_rng(seed)``, so both packages see the same tokens) and the same
round (``fl/sharded.py``'s spatial round). As in the reference, ``--smoke``
is a ``store_true`` flag whose default is already True; ``--full`` selects
the full-size config.

Each round is timed on the host clock after a device sync (the
reference's ``sec`` measures the dispatch of an asynchronous call).

**The pod round.** ``run(..., mesh=...)`` (a ``DeviceMesh`` of
``launch/mesh.py: make_host_mesh`` over an initialised process group)
runs ``fl/sharded.py: make_pod_round``: every rank draws the same
batches, keeps its own block of clients and trains them, and the ranks
meet in the round's collectives. From the command line, ``--mesh
pod,data,model`` (or ``data,model``) does the same, one process a rank:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --mesh 2,2,1 --clients 8 --rounds 2

under gloo on the CPU; on the card the backend is NCCL by default, each
rank on ``cuda:<local rank>`` (modulo the cards there are), or gloo with
``--dist-backend gloo``, which lets two ranks share one card:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --full \
        --mesh 1,2 --dist-backend gloo --clients 4 --seq 512

A model axis > 1 (the last size) runs the dense GQA family with
tensor-parallel params: every rank draws the same whole params (the
ported threefry init) and keeps its shard. A single process with
``--mesh 1,1`` rendezvouses in a ``HashStore``; under torchrun the store
is torchrun's, on the loopback. No other address is used.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import FedConfig
from repro_torch.configs.cli import add_fed_args, fed_from_args
from repro_torch.core.aggregation import check_client_weights, dp_report
from repro_torch.data.tokens import make_token_federation
from repro_torch.fl import engine, sharded
from repro_torch.models import get_model
from repro_torch.utils import param_count, resolve_device, tree_map


def build_batches(cfg, fed_data, *, clients, per_client, seq, rng,
                  device="cuda", block=None):
    """Assemble one round's client-stacked token batch + server batch, on
    ``device`` (the reference's draws from ``rng``, in its order). With
    ``block=(offset, n)`` the batch holds only clients offset..offset+n-1
    (a pod rank's block); the draws are the same."""
    dev = resolve_device(device)
    toks = fed_data["tokens"]                       # [C, n_seq, seq+1]
    C, n_seq, _ = toks.shape
    idx = rng.integers(0, n_seq, size=(clients, per_client))
    lo, n = (0, clients) if block is None else block
    sel = np.stack([toks[c, idx[c]] for c in range(lo, lo + n)])  # [n,b,seq+1]
    test = fed_data["test_tokens"]
    sidx = rng.integers(0, test.shape[0], size=(per_client,))
    server = test[sidx]

    def split(x):
        return {"tokens": torch.from_numpy(x[..., :-1].copy()).to(dev),
                "labels": torch.from_numpy(x[..., 1:].copy()).to(dev),
                "mask": torch.ones(x[..., 1:].shape, dtype=torch.float32,
                                   device=dev)}

    return {
        "clients": split(sel),
        "server": split(server),
        "priority_mask": torch.from_numpy(
            fed_data["priority_mask"].astype(np.float32)).to(dev),
        "weights": torch.from_numpy(fed_data["weights"]).to(dev),
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch="qwen1.5-0.5b", smoke=True, rounds=10, clients=8, n_priority=4,
        per_client=4, seq=128, lr=0.05, epsilon=0.5, local_epochs=2,
        misalign_max=1.0, log_every=1, seed=0, verbose=True, device="cuda",
        mesh=None, **fed_kw):
    """``fed_kw`` passes any further FedConfig knob straight through (the
    aggregators, wire codecs, server optimizers, strategies, the training
    cohort, overlapped cohorts (``async_depth``, ``async_mode``, ...), the
    fault layer and candidate pools (``candidate_pool``,
    ``pool_weighting``: a pooled round's ``gates`` are in the [C] space,
    zero out of the pool, so ``included`` counts the pool's included
    clients).
    Returns (params, history): the final global params, detached, and one
    record per round with the reference's keys (``lost_clients`` and
    ``skipped_nonfinite`` where their feature is on) plus the round's
    ``gates`` and ``local_losses``. Under the divergence guard the run
    halts once ``max_nonfinite_skips`` consecutive rounds were skipped
    (when that is > 0). Like the reference's, it never drains an
    in-flight buffer, and it refuses an enc-dec config (whisper-medium)
    with the reference's assertion: whisper has no federated round.

    With ``mesh`` (a DeviceMesh over the process group's ranks) the round
    is the pod round: this rank holds its block of the clients (and, on a
    model axis, its shard of every leaf); the params returned (gathered
    whole), the history and every decision are the same on every rank."""
    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    assert not cfg.encdec, "use examples/whisper for enc-dec training"
    model = get_model(cfg)
    fed = FedConfig(num_clients=clients, num_priority=n_priority,
                    local_epochs=local_epochs, epsilon=epsilon, lr=lr,
                    **fed_kw)
    fed_data = make_token_federation(seed=seed, vocab=cfg.vocab_size,
                                     n_clients=clients, n_priority=n_priority,
                                     seq_len=seq, misalign_max=misalign_max,
                                     tokens_per_client=max(8192, per_client * (seq + 1) * 4))
    check_client_weights(fed_data["weights"], where="federation weights")

    block = None                    # a pod rank's (offset, n) of the clients
    if mesh is None:
        round_step = sharded.make_round_step(model, fed, clients, fsdp=False,
                                             device=dev)
    else:
        round_step = sharded.make_pod_round(model, fed, clients, mesh,
                                            device=dev)
        block = round_step.pod.block(clients)
    # the state holds the only reference to the params: a round replaces
    # them, and no copy of the initial ones outlives round 0
    params = model.init(prng.PRNGKey(seed), device=dev)
    n_params = param_count(params)
    if mesh is not None:
        params = round_step.shard(params)
    state = engine.init_state(params, fed, clients)
    del params
    if verbose:
        print(f"[train] {cfg.name} params={n_params:,} "
              f"clients={clients} device={dev}")
    rng = np.random.default_rng(seed)
    history = []
    halt_skips = int(fed.max_nonfinite_skips) if fed.divergence_guard else 0
    for r in range(rounds):
        batch = build_batches(cfg, fed_data, clients=clients,
                              per_client=per_client, seq=seq, rng=rng,
                              device=dev, block=block)
        _sync(dev)
        t0 = time.perf_counter()
        state, stats = round_step(state, batch, r)
        _sync(dev)
        dt = time.perf_counter() - t0
        gates = stats["gates"].cpu()
        rec = {"round": r,
               "server_loss": float(stats["server_loss"]),
               "included": float(torch.sum(gates)) - n_priority,
               "theta_round": float(stats["theta_round"]),
               "sec": dt,
               "gates": gates.tolist(),
               "local_losses": stats["local_losses"].cpu().tolist()}
        if "lost_clients" in stats:
            rec["lost_clients"] = float(stats["lost_clients"])
        if "skipped_nonfinite" in stats:
            rec["skipped_nonfinite"] = int(stats["skipped_nonfinite"])
        history.append(rec)
        if verbose and r % log_every == 0:
            print(f"  round {r:3d} server_loss={rec['server_loss']:.4f} "
                  f"included_nonpri={rec['included']:.0f} ({dt:.2f}s)")
        if halt_skips > 0 and rec.get("skipped_nonfinite", 0) >= halt_skips:
            print(f"[train] halting at round {r}: "
                  f"{rec['skipped_nonfinite']} consecutive non-finite "
                  f"aggregates (>= max_nonfinite_skips={halt_skips}); "
                  "params are the last finite ones")
            break
    dp = dp_report(fed, len(history))
    if dp is not None and verbose:
        eps, delta = dp
        print(f"[train] DP budget spent: epsilon={eps:.3g} at "
              f"delta={delta:g} (z={fed.dp_noise}, "
              f"{len(history)} rounds, RDP accountant)")
    params = state.params if mesh is None else round_step.gather(state.params)
    return tree_map(torch.Tensor.detach, params), history


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="POD,DATA,MODEL",
                    help="run the pod round, one process a rank, over a "
                         "(pod, data, model) or (data, model) host mesh "
                         "of the process group (under torchrun, or one "
                         "rank alone)")
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="the process group's backend under --mesh: NCCL "
                         "on the card, gloo on the CPU by default; gloo "
                         "lets ranks share one card")
    add_fed_args(ap)
    return ap


def _pod_group(mesh_arg, device, backend=None):
    """Initialise the process group for ``--mesh`` and build its mesh:
    ``backend`` (default NCCL on the card, gloo on the CPU; this rank on
    ``cuda:<local rank>``, modulo the cards there are, so gloo ranks can
    share one), torchrun's loopback store, or a HashStore for one rank
    alone. Returns (mesh, device)."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    sizes = [int(x) for x in mesh_arg.split(",")]
    if len(sizes) not in (2, 3):
        raise ValueError(f"--mesh {mesh_arg!r}: give pod,data,model or "
                         "data,model")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    want = math.prod(sizes)
    if want != dist.get_world_size():
        raise ValueError(f"--mesh {mesh_arg} has {want} ranks, the process "
                         f"group {dist.get_world_size()}")
    mesh = make_host_mesh(sizes[-1], pods=sizes[0] if len(sizes) == 3
                          else None, device_type=dev.type)
    return mesh, dev


def main(argv=None):
    a = build_parser().parse_args(argv)
    if a.mesh is None:
        return run(arch=a.arch, smoke=a.smoke, rounds=a.rounds,
                   clients=a.clients, seq=a.seq, lr=a.lr, device=a.device,
                   **fed_from_args(a))
    import torch.distributed as dist
    mesh, dev = _pod_group(a.mesh, a.device, a.dist_backend)
    try:
        return run(arch=a.arch, smoke=a.smoke, rounds=a.rounds,
                   clients=a.clients, seq=a.seq, lr=a.lr, device=dev,
                   mesh=mesh, verbose=dist.get_rank() == 0,
                   **fed_from_args(a))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
