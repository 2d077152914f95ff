"""Where a federated LM local step's time goes in the PyTorch port, on one
CUDA card.

    PYTHONPATH=src python3 -m repro_torch.launch.train_profile \\
        [--arch qwen1.5-0.5b] [--batch 8] [--seq 512]
        [--remat-policy full|save_mixer] [--out DIR]

The full-width config at its own dtypes (f32 params, bf16 compute), random
init, one client's local SGD step as ``fl/sharded.py`` runs it: the loss
with the autograd graph, ``torch.autograd.grad``, the in-place update
(whisper-medium: ``--seq`` tokens decoded over num_frames stub frames,
normal draws from seed 5, as ``chip_smoke.py``'s slice (l3); whisper has
no federated round, but its loss's step is this one). After a warm-up
step it

1. times the phases with the host clock, each ending in a device sync:
   the forward, the backward with remat (which runs each period's forward
   again; under ``--remat-policy save_mixer`` each layer's FFN only), the
   update; then the same forward and backward without remat.
   The remat's cost is the difference of the two backwards;
2. traces one step (remat on) with ``torch.profiler``: device time by
   kernel, the shares of the port's kernels (flash-attention forward K5
   and backward K6, RMSNorm K9) and of cuBLAS's products, kernel launches,
   the kernels' launch counters, and the device's idle share (1 - summed
   kernel time / the unprofiled step's wall time).

Prints one JSON line and writes it to ``DIR/torch_train_profile.json``
(default ``results/`` at the repository root, which git ignores). Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.launch.serve_profile import (ROOT, device_kernels, smi_line,
                                              summarize)

CUBLAS = ("gemm", "cutlass", "xmma", "cublas", "nvjet")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--remat-policy", default="full",
                    choices=("full", "save_mixer"))
    ap.add_argument("--out", default=str(ROOT / "results"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.fl.sharded import _train_steps
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.models import get_model
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten_like

    dev = torch.device("cuda")
    cfg = get_config(args.arch).replace(remat_policy=args.remat_policy)
    model = get_model(cfg)
    params = model.init(prng.PRNGKey(0), device=dev)
    B, S, L = args.batch, args.seq, cfg.num_layers
    toks = prng.randint(prng.PRNGKey(1), (B, S + 1), 0, cfg.vocab_size).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones(B, S, device=dev)}
    if cfg.encdec:
        gen = torch.Generator().manual_seed(5)
        batch["frames"] = torch.randn(B, cfg.num_frames, cfg.d_model,
                                      generator=gen).to(cfg.cdtype).to(dev)
    slot = tree_map(torch.clone, params)

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def phases(m):
        """(forward s, backward s, update s) of one step of model m."""
        slots = tree_leaves(slot)
        leaves = [s.detach().requires_grad_(True) for s in slots]
        loss, t_fwd = sync_time(
            lambda: m.loss_fn(tree_unflatten_like(slot, leaves), batch)[0])
        grads, t_bwd = sync_time(lambda: torch.autograd.grad(loss, leaves))
        del loss, leaves

        def update():
            with torch.no_grad():
                for s, g in zip(slots, grads):
                    s.copy_(-args.lr * g + s)
        _, t_upd = sync_time(update)
        return t_fwd, t_bwd, t_upd

    def step():
        return _train_steps(model, params, batch, args.lr, 1, out=slot)

    step()                                                        # warm-up
    phases(model)                                                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    t_fwd, t_bwd, t_upd = phases(model)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, t_step = sync_time(step)
    plain = get_model(cfg.replace(remat=False))
    phases(plain)                                                 # warm-up
    n_fwd, n_bwd, _ = phases(plain)

    from torch.profiler import ProfilerActivity, profile
    counters = (fk.flash_attention_fwd, fk.flash_attention_bwd, rk.rmsnorm_fwd)
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launches = {name: c.launches - b for name, c, b in
                zip(("flash_attention", "flash_attention_bwd", "rmsnorm"),
                    counters, before)}
    kernels = device_kernels(prof)
    traced = summarize(kernels, t_step, 1)
    busy = sum(us for us, _ in kernels.values())
    gemm = sum(us for name, (us, _) in kernels.items()
               if any(f in name.lower() for f in CUBLAS))
    traced["cublas_share_of_busy"] = gemm / busy
    rerun = cfg.remat_policy == "full"      # save_mixer reruns no mixer
    out = {
        "card": smi_line(), "torch": torch.__version__, "arch": cfg.name,
        "batch": B, "seq": S, "layers": L, "remat": cfg.remat,
        "remat_policy": cfg.remat_policy,
        "step_s": t_step, "forward_s": t_fwd, "backward_s": t_bwd,
        "update_s": t_upd, "forward_no_remat_s": n_fwd,
        "backward_no_remat_s": n_bwd, "remat_s": t_bwd - n_bwd,
        "peak_mem_gb": peak, "launch_counters": launches,
        "expected_launches": (
            {"flash_attention": cfg.encoder_layers + 2 * L,
             "flash_attention_bwd": cfg.encoder_layers + L, "rmsnorm": 0}
            if cfg.encdec else {"flash_attention": L * (1 + rerun),
                                "flash_attention_bwd": L,
                                "rmsnorm": 2 * L + 1 + (2 if rerun else 1) * L}),
        "profiled_step": traced,
    }
    line = json.dumps(out)
    print(line)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    name = "torch_train_profile" + (
        "" if cfg.remat_policy == "full" else f"_{cfg.remat_policy}")
    (Path(args.out) / f"{name}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
