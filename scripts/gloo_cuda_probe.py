"""Which collectives the gloo backend carries for CUDA tensors, with two
ranks on one card, and how long each takes at a few sizes.

    python3 scripts/gloo_cuda_probe.py [--device cuda:0] [--mb 1,64]

Spawns two processes on the same device (NCCL cannot put two ranks on one
card), joined by gloo through a FileStore in a temporary directory. Each
collective is tried once at 1 KiB; the ones that run are then timed at
each ``--mb`` size (host clock around the call and a device sync, the
median of 5). Prints one JSON line a collective and, last, the card's
name and torch's version. Gloo moves CUDA tensors through host memory, so
the times are a host path's, not a pod's interconnect.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time


def _ops(dist, x, world):
    """name -> callable(x) running that collective on the tensor x."""
    import torch

    def all_reduce(t):
        dist.all_reduce(t)

    def all_reduce_max(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)

    def all_gather_into_tensor(t):
        out = t.new_empty((world * t.numel(),))
        dist.all_gather_into_tensor(out, t.reshape(-1))

    def all_gather(t):
        outs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(outs, t)

    def all_to_all_single(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)

    def reduce_scatter_tensor(t):
        out = t.new_empty((t.numel() // world,))
        dist.reduce_scatter_tensor(out, t.reshape(-1))

    def broadcast(t):
        dist.broadcast(t, src=0)

    return {f.__name__: f for f in (all_reduce, all_reduce_max,
                                   all_gather_into_tensor, all_gather,
                                   all_to_all_single, reduce_scatter_tensor,
                                   broadcast)}


def _rank(rank, world, store_path, device, sizes_mb, out_path):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    rows = []
    try:
        small = torch.arange(256, dtype=torch.float32, device=device)
        for name, fn in _ops(dist, small, world).items():
            row = {"op": name}
            try:
                fn(small.clone())
                torch.cuda.synchronize()
                row["cuda"] = True
            except Exception as exc:          # noqa: BLE001 - recorded
                row.update(cuda=False, error=f"{type(exc).__name__}: "
                           f"{str(exc).splitlines()[0][:200]}")
            dist.barrier()
            if row["cuda"]:
                for mb in sizes_mb:
                    n = int(mb * (1 << 20)) // 4 // world * world
                    t = torch.ones(n, dtype=torch.float32, device=device)
                    times = []
                    for _ in range(5):
                        torch.cuda.synchronize()
                        dist.barrier()
                        t0 = time.perf_counter()
                        fn(t)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    row[f"ms_{mb}MB"] = 1e3 * statistics.median(times)
            rows.append(row)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)


def main(argv=None) -> int:
    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--mb", default="1,64")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA card", file=sys.stderr)
        return 1
    sizes = [float(x) for x in a.mb.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.json")
        mp.start_processes(_rank, args=(2, os.path.join(tmp, "store"),
                                        a.device, sizes, out),
                           nprocs=2, join=True, start_method="spawn")
        with open(out) as f:
            rows = json.load(f)
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
