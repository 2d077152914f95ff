"""Where LM serving's time goes in the PyTorch port, on one CUDA card.

    PYTHONPATH=src python3 -m repro_torch.launch.serve_profile \
        [--arch qwen1.5-0.5b] [--batch 8] [--prompt 512] [--steps 8] \
        [--num-layers L] [--num-experts E] [--out DIR]

The full-width config at its own dtypes, random init; ``--num-layers`` and
``--num-experts`` cut depth and experts where the whole model does not fit
one card (jamba-1.5-large-398b: ``--num-layers 8 --num-experts 4``, one
period of its published widths; llava-next-34b fits uncut in its bf16
params). Serving is text-only, as ``generate`` is (llava and xlstm-125m
included), but for whisper-medium, whose prefill encodes B x num_frames
stub frames (normal draws from seed 5) under the prompt, as
``chip_smoke.py``'s slice (l2) serves it. After a warm-up (a generate;
whisper: a prefill and ``--steps`` decode steps) it

1. times one prefill and ``--steps`` decode steps with the host clock,
   each ending in a device sync;
2. traces one prefill and then ``--steps`` decode steps with
   ``torch.profiler``: device time by kernel, kernel launches per decode
   step, the shares of the port's kernels (flash attention, decode
   attention, RMSNorm, the selective scan), and the device's idle share in
   each phase
   (1 - summed kernel time / the unprofiled phase's wall time).

Prints one JSON line and writes it to ``DIR/torch_serve_profile.json``
(default ``results/`` at the repository root, which git ignores). Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]

PORT_KERNELS = {"flash_fwd_kernel": "flash_attention",
                "flash_fwd_tc_kernel": "flash_attention",
                "flash_bwd_dq_kernel": "flash_attention_bwd",
                "flash_bwd_dkv_kernel": "flash_attention_bwd",
                "flash_bwd_dq_tc_kernel": "flash_attention_bwd",
                "flash_bwd_dkv_tc_kernel": "flash_attention_bwd",
                "decode_attention_kernel": "decode_attention",
                "decode_attention_tc_kernel": "decode_attention",
                "rmsnorm_kernel": "rmsnorm",
                "ssm_scan_kernel": "ssm_scan"}


def device_kernels(prof):
    """{kernel name: (device us, count)} of the device kernels alone (the
    host-side aten ops that launched them would count each twice)."""
    from torch.autograd import DeviceType
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            out[evt.key] = (evt.self_device_time_total, evt.count)
    return out


def summarize(kernels, wall_s, n):
    """Per-call figures of a traced phase run ``n`` times; ``wall_s`` is
    one call's unprofiled wall time."""
    busy = sum(us for us, _ in kernels.values()) / 1e6
    launches = sum(c for _, c in kernels.values())
    port = {}
    for name, (us, c) in kernels.items():
        for frag, k in PORT_KERNELS.items():
            if frag in name:
                u, cc = port.get(k, (0.0, 0))
                port[k] = (u + us, cc + c)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_busy_ms": 1e3 * busy / n, "kernel_launches": launches / n,
            "device_idle_share": 1.0 - busy / n / wall_s,
            "port_kernels": {k: {"device_ms": us / 1e3 / n, "launches": c / n,
                                 "share_of_busy": us / 1e6 / busy}
                             for k, (us, c) in port.items()},
            "top_kernels": [{"name": k[:100], "device_ms": us / 1e3 / n,
                             "launches": c / n} for k, (us, c) in top]}


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--num-layers", type=int, default=None)
    ap.add_argument("--num-experts", type=int, default=None)
    ap.add_argument("--out", default=str(ROOT / "results"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, pad_caches
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    cut = {k: v for k, v in (("num_layers", args.num_layers),
                             ("num_experts", args.num_experts)) if v is not None}
    cfg = cfg.replace(**cut)
    model = get_model(cfg)
    params = model.init(prng.PRNGKey(0), device=dev)
    B, S, n = args.batch, args.prompt, args.steps
    prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size).to(dev)
    inputs = {"tokens": prompt}
    if cfg.encdec:
        gen = torch.Generator().manual_seed(5)
        inputs["frames"] = torch.randn(B, cfg.num_frames, cfg.d_model,
                                       generator=gen).to(cfg.cdtype).to(dev)

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def prefill():
        caches, logits = model.prefill(params, inputs)
        return pad_caches(model, caches, B, S + n), logits

    def decode(caches, logits):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for i in range(n):
            logits, caches = model.decode_step(params, caches, tok, S + i)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        return caches

    if cfg.encdec:                                                   # warm-up
        decode(*prefill())
    else:
        generate(model, params, prompt, 2, device=dev)

    # 1. host clock
    (caches, logits), t_pre = sync_time(prefill)
    _, t_dec = sync_time(lambda: decode(caches, logits))

    # 2. the profiler, one phase at a time
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof_pre:
        caches, logits = prefill()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof_dec:
        decode(caches, logits)
        torch.cuda.synchronize()

    out = {
        "card": smi_line(), "torch": torch.__version__, "arch": cfg.name,
        "cut": cut,
        "batch": B, "prompt": S, "decode_steps": n,
        "prefill": dict(wall_ms=1e3 * t_pre,
                        **summarize(device_kernels(prof_pre), t_pre, 1)),
        "decode_step": dict(wall_ms=1e3 * t_dec / n,
                            **summarize(device_kernels(prof_dec), t_dec / n, n)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    line = json.dumps(out)
    print(line)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "torch_serve_profile.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
