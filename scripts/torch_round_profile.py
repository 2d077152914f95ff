#!/usr/bin/env python3
"""Where a FedALIGN round's time goes in the PyTorch port, on one CUDA card.

    python3 scripts/torch_round_profile.py [--out DIR]

Config (b) of ``chip_smoke.py``: the paper's CIFAR ``cnn`` at full width on
the CIFAR stand-in (60 clients x 1000 images, E=5, batch 32). After a
warm-up round it

1. times the round's phases with the host clock, each ending in a device
   sync: eval pre-pass, minibatch permutations, local training (E epochs
   of vmapped SGD), aggregation + server step (one fedagg launch);
2. traces one whole ``round_fn`` call with ``torch.profiler``: device time
   by kernel, the fedagg kernel's share, and the device's idle share
   (1 - summed kernel time / the unprofiled round's wall time).

Prints one JSON line and writes it to ``DIR/torch_round_profile.json``
(default ``results/``, which git ignores). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "results"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_round_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import cifar_config, smi_line
    from repro_torch import prng
    from repro_torch.data.shards import make_benchmark_federation
    from repro_torch.fl import engine
    from repro_torch.fl.simulator import federation_tensors
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn

    dev = torch.device("cuda")
    fed = cifar_config(3)
    fedn = make_benchmark_federation("cifar", seed=0, n_priority=2)
    data, pm, w = federation_tensors(fedn, dev)
    init_fn, apply_fn = SMALL_MODELS["cnn"]
    loss_fn = make_loss_fn(apply_fn)
    state = engine.init_state(init_fn(0, dev), fed, int(pm.shape[0]))
    round_fn = engine.make_round_fn(loss_fn, fed)
    key = prng.PRNGKey(fed.seed)

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    state, _ = round_fn(state, data, pm, w, prng.fold_in(key, 0), 0)   # warm-up

    # 1. phases of one round, as make_round_fn runs them
    params = state.params
    solver = engine.local_solver(loss_fn, fed)
    C, n = int(pm.shape[0]), int(data["y"].shape[1])
    with torch.no_grad():
        (losses, met), t_eval = sync_time(
            lambda: engine._eval_vmap(loss_fn, params, data))
        order, t_perm = sync_time(lambda: engine.minibatch_order(
            fed, prng.split(key, C).to(dev), n))
        gates = torch.ones(C, device=dev)
        clients, t_train = sync_time(
            lambda: solver(params, data, order, torch.tensor(fed.lr)))
        _, t_agg = sync_time(lambda: engine.apply_server_opt(
            fed, params, (), engine.server_delta(fed, params, clients, w,
                                                 gates)))
    _, t_round = sync_time(
        lambda: round_fn(state, data, pm, w, prng.fold_in(key, 1), 1))

    # 2. one round under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        round_fn(state, data, pm, w, prng.fold_in(key, 2), 2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device kernels only: key_averages also lists the host-side aten ops
    # that launched them, whose device time would count every kernel twice
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        if evt.self_device_time_total > 0:
            kernels[evt.key] = (evt.self_device_time_total, evt.count)
    busy_s = sum(us for us, _ in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    fedagg = {k: v for k, v in kernels.items() if "fedagg" in k}

    out = {
        "card": smi_line(), "torch": torch.__version__,
        "config": "cifar cnn, C=60, n=1000, E=5, bs=32",
        "phase_s": {"eval_prepass": t_eval, "minibatch_perms": t_perm,
                    "local_training_all_clients": t_train,
                    "aggregate_and_server_step": t_agg,
                    "whole_round": t_round},
        "profiled_round": {
            "wall_s": wall, "device_busy_s": busy_s,
            # against the unprofiled round: the profiler slows the host
            "device_idle_share": 1.0 - busy_s / t_round,
            "fedagg": {k: {"device_us": us, "count": c}
                       for k, (us, c) in fedagg.items()},
            "top_kernels": [{"name": k[:120], "device_us": us, "count": c}
                            for k, (us, c) in top]},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    line = json.dumps(out)
    print(line)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "torch_round_profile.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
