#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the FedALIGN round end to
end through the hand-written fedagg kernel.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if a check fails:

1. the card's name and power limit (nvidia-smi); the CUDA kernels are
   built from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. kernel phase: ``fedagg`` (the CUDA kernel) against ``fedagg_plain`` on
   the card, f32 and bf16, on the slice's shapes and the reference's edge
   cases, then timed beside the plain version, a library yardstick
   (``torch.mv``, timed here only) and the byte bound;
3. slice (a): the quickstart config (SYNTH, ``synth_logreg``, C=20) for a
   few rounds on both backends, held against the same run on the CPU;
4. slice (b): the paper's CIFAR ``cnn`` at full width, C=60, E=5, for 3
   rounds through ``run_federation``.

It ends with a JSON line of the kernels (launch counts from the slice
phases, errors and times from this run) and, last, the ok line. It needs
no JAX and none of the ``repro`` package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
F32_TOL = 1e-5                    # x max|u|: only the summation order differs


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Check:
    """Collects failed checks; the run exits non-zero if any failed."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str):
        if not ok:
            self.failed.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


# ------------------------------------------------------------------ kernels
def make_case(C, M, dtype, device, *, gates="mixed", zero_rows=(),
              nan_row=None, pitch=None, seed=0):
    """Inputs for one fedagg case, drawn from a seeded generator on the
    host. ``pitch`` lays the rows out with that row stride (a view into a
    wider buffer, as the fused aggregation does)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(C, M, generator=gen)
    for r in zero_rows:
        u[r] = 0.0
    w = torch.rand(C, generator=gen) + 0.1
    if gates == "all":
        g = torch.ones(C)
    elif gates == "none":
        g = torch.zeros(C)
    else:
        g = (torch.rand(C, generator=gen) > 0.3).float()
        g[0] = 1.0
    if nan_row is not None:
        u[nan_row] = float("nan")
        g[nan_row] = 0.0
    u = u.to(dtype)
    if pitch is not None:
        buf = torch.zeros(C, pitch, dtype=dtype)
        buf[:, :M] = u
        u = buf.to(device)[:, :M]
    else:
        u = u.to(device)
    return u, w.to(device), g.to(device)


def compare(out, want, u, weights, gates, dtype):
    """(ok, max_abs_err) under the stated tolerance.

    f32: within F32_TOL * max|u| over the included rows (only the order of
    the f32 sums differs). bf16: within one bf16 ulp of the plain result,
    plus the bound on how far two f32 sums of the same n terms taken in
    different orders can differ, 2 n 2^-24 sum_k |wg_k u_km| / sum_k wg_k
    per column. Both bf16 outputs round an f32 sum; where the column sum
    cancels to near 0 that f32 difference exceeds a bf16 ulp of the result
    (a few of 579,402 columns at the slice's shape)."""
    import torch
    o, p = out.float(), want.float()
    err = float(torch.max(torch.abs(o - p))) if o.numel() else 0.0
    if not bool(torch.isfinite(o).all()):
        return False, float("inf")
    inc = (weights * gates) > 0
    if dtype == torch.float32:
        rows = u.float()[inc]
        scale = float(torch.max(torch.abs(rows))) if rows.numel() else 0.0
        return err <= F32_TOL * max(scale, 1e-30), err
    wg = torch.where(inc, weights * gates, 0.0).float()
    den = torch.clamp(torch.sum(wg), min=1e-30)
    absum = torch.abs(torch.where(inc[:, None], u.float(), 0.0)).t() @ wg / den
    order = 2.0 * int(inc.sum()) * 2.0 ** -24 * absum
    mag = torch.clamp(torch.abs(p), min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(torch.all(torch.abs(o - p) <= ulp + order)), err


def kernel_cases():
    """(label, make_case kwargs): the slice's shapes, the reference's edge
    shapes (tests/test_kernels.py sweep and C=65), all-zero rows, zero
    inclusion mass and a NaN in a gated-out row."""
    cases = [("slice_a", dict(C=20, M=610, gates="all")),
             ("slice_a_pitched", dict(C=20, M=610, pitch=616)),
             ("slice_b", dict(C=60, M=579402, gates="all")),
             ("slice_b_pitched", dict(C=60, M=579402, pitch=579408)),
             ("slice_b_mixed", dict(C=60, M=579402))]
    for C, M in [(1, 64), (1, 7), (4, 100), (5, 513), (3, 2065), (65, 4096)]:
        cases.append((f"edge_{C}x{M}", dict(C=C, M=M)))
    cases += [("zero_rows", dict(C=8, M=1000, zero_rows=(1, 3))),
              ("zero_mass", dict(C=8, M=1000, gates="none")),
              ("nan_gated_out", dict(C=8, M=1000, nan_row=2)),
              ("many_clients", dict(C=300, M=1000))]
    return cases


def kernel_phase(check: Check, device="cuda"):
    """Hold the kernel against its plain version on every case, f32 and
    bf16. Returns the worst f32 error on the main-path shape."""
    import torch
    from repro_torch.kernels import fedagg as fk
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, kw in kernel_cases():
            u, w, g = make_case(dtype=dtype, device=device, **kw)
            out = fk.fedagg(u, w, g)
            want = fk.fedagg_plain(u, w, g)
            ok, err = compare(out, want, u, w, g, dtype)
            name = f"{label}/{str(dtype).split('.')[-1]}"
            worst[name] = err
            check(ok, f"fedagg {name}: max_abs_err {err}")
            if kw.get("gates") == "none":
                check(bool(torch.all(out == 0)), f"fedagg {name}: zero mass "
                      "must give exact zeros")
            if kw.get("nan_row") is not None:
                check(bool(torch.isfinite(out).all()),
                      f"fedagg {name}: NaN leaked from a gated-out row")
    if device != "cpu":
        torch.cuda.synchronize()
    print("kernel phase:", json.dumps(worst), flush=True)
    return worst


def time_ms(fn, iters=50, warmup=5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fedagg_bound(C_inc, M, in_size, out_size, C):
    """Least time for the work: bytes (included rows, the output, w and g)
    over the memory rate vs the multiply-adds over the f32 rate."""
    bytes_ = C_inc * M * in_size + M * out_size + 2 * C * 4
    flops = 2.0 * C_inc * M
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timing_phase(device="cuda"):
    """Kernel, plain version and torch.mv yardstick at the slice's shapes
    (all gates 1, as in the bound). Returns rows for PERF.md and the line."""
    import torch
    from repro_torch.core.aggregation import flatten_stacked
    from repro_torch.kernels import fedagg as fk
    rows = []
    for label, C, M in (("slice_b", 60, 579402), ("slice_a", 20, 610)):
        for dtype in (torch.float32, torch.bfloat16):
            u, w, g = make_case(C, M, dtype, device, gates="all")
            # the fused path hands the kernel a 16-byte row pitch
            up = flatten_stacked({"u": u}, dtype=dtype)
            wg = (w * g).to(dtype)
            masked = torch.where((g > 0)[:, None], u, torch.zeros_like(u))
            ms = time_ms(lambda: fk.fedagg(up, w, g))
            plain = time_ms(lambda: fk.fedagg_plain(u, w, g))
            library = time_ms(lambda: torch.mv(masked.t(), wg))
            size = u.element_size()
            bound, by = fedagg_bound(int((g > 0).sum()), M, size, size, C)
            rows.append(dict(shape=f"{C}x{M}", dtype=str(dtype).split(".")[-1],
                             label=label, ms=ms, plain_ms=plain,
                             library_ms=library, bound_ms=bound, bound_by=by))
            print("timing:", json.dumps(rows[-1]), flush=True)
    return rows


# -------------------------------------------------------------------- slices
def quickstart_config(rounds, backend):
    from repro_torch.configs.base import FedConfig
    return FedConfig(num_clients=20, num_priority=10, rounds=rounds,
                     local_epochs=5, epsilon=0.2, lr=0.1, warmup_frac=0.1,
                     selection="fedalign", backend=backend)


def parity_config():
    """The shortened quickstart of tests/test_torch_round.py, where the
    port matches the JAX package on the CPU."""
    from repro_torch.configs.base import FedConfig
    return FedConfig(num_clients=8, num_priority=4, rounds=6, local_epochs=2,
                     epsilon=0.2, lr=0.1, warmup_frac=0.1, batch_size=8)


def slice_a(check: Check, device="cuda", rounds=4, samples=200):
    """Config (a), the quickstart (C=20, 200 samples, E=5), on both
    backends on ``device`` and on the CPU: identical gates every round,
    finite losses, one fedagg launch per round. Its local SGD amplifies
    float noise ~1000x per round (a 1e-7 change of the initial params moves
    them by 3e-4 after one round on the CPU alone), so its params are not
    compared. They are on the shortened quickstart (C=8, 40 samples, E=2,
    6 rounds), which is stable: gates exact, global loss per round within
    rtol 1e-5, final params within 1e-4 max|p| of the CPU run — the
    tolerances the CPU tests hold the port to against JAX."""
    import numpy as np
    import torch
    from repro_torch.data.synth import make_synth_federation
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS["synth_logreg"]
    loss_fn = make_loss_fn(apply_fn)
    fedn = make_synth_federation(seed=0, n_priority=10, n_nonpriority=10,
                                 samples_per_client=samples,
                                 label_noise_skew=1.5, random_data_skew=1.5)
    ref = run_federation(loss_fn, init_fn(42, "cpu"),
                         quickstart_config(rounds, "vmap_spatial"), fedn,
                         eval_every=2, device="cpu")
    out = {}
    for backend in ("vmap_spatial", "scan_temporal"):
        before = fk.fedagg.launches
        t0 = time.perf_counter()
        h = run_federation(loss_fn, init_fn(42, device),
                           quickstart_config(rounds, backend), fedn,
                           eval_every=2, device=device)
        secs = time.perf_counter() - t0
        launches = fk.fedagg.launches - before
        check(np.array_equal(np.array(h.gates), np.array(ref.gates)),
              f"slice (a) {backend}: gates differ from the CPU run")
        check(bool(np.all(np.isfinite(h.global_loss))),
              f"slice (a) {backend}: non-finite loss")
        if device != "cpu":
            check(launches == rounds, f"slice (a) {backend}: {launches} "
                  f"fedagg launches in {rounds} rounds")
        out[backend] = dict(seconds=secs, launches=launches,
                            included=h.included, test_acc=h.test_acc[-1])
        print(f"slice (a) {backend}:", json.dumps(out[backend]), flush=True)

    small = make_synth_federation(seed=0, n_priority=4, n_nonpriority=4,
                                  samples_per_client=40, test_samples=200)
    gen = torch.Generator().manual_seed(42)
    p0 = {"b": 0.05 * torch.randn(10, generator=gen),
          "w": 0.05 * torch.randn(60, 10, generator=gen)}
    cpu = run_federation(loss_fn, p0, parity_config(), small, eval_every=2,
                         device="cpu")
    before = fk.fedagg.launches
    dev = run_federation(loss_fn, p0, parity_config(), small, eval_every=2,
                         device=device)
    launches = fk.fedagg.launches - before
    check(np.array_equal(np.array(dev.gates), np.array(cpu.gates)),
          "slice (a) parity config: gates differ from the CPU run")
    loss_rel = float(np.max(np.abs(np.array(dev.global_loss)
                                   / np.array(cpu.global_loss) - 1.0)))
    check(loss_rel <= 1e-5, f"slice (a) parity config: global loss off the "
          f"CPU run by rtol {loss_rel}")
    rel = max(float((dev.params[k].cpu() - cpu.params[k]).abs().max()
                    / cpu.params[k].abs().max()) for k in cpu.params)
    check(rel <= 1e-4, f"slice (a) parity config: params off the CPU run by "
          f"{rel} x max|p|")
    if device != "cpu":
        check(launches == 6, f"slice (a) parity config: {launches} fedagg "
              "launches in 6 rounds")
    out["parity_config"] = dict(launches=launches, included=dev.included,
                                global_loss_rtol_vs_cpu=loss_rel,
                                params_rel_err_vs_cpu=rel)
    print("slice (a) parity config:", json.dumps(out["parity_config"]),
          flush=True)
    return out


def cifar_config(rounds):
    from repro_torch.configs.base import FedConfig
    # the paper's CIFAR-10 settings: N=60, |P|=2, E=5, eps=0.2 on accuracies
    return FedConfig(num_clients=60, num_priority=2, rounds=rounds,
                     local_epochs=5, epsilon=0.2, lr=0.1, warmup_frac=0.1,
                     align_stat="accuracy", selection="fedalign",
                     backend="vmap_spatial")


def slice_b(check: Check, device="cuda", rounds=3, fedn=None):
    """Config (b): the full-width cnn on the CIFAR stand-in (C=60, 1000
    samples per client, M=579,402), a 1-round warm-up run, then ``rounds``
    timed rounds through run_federation."""
    import numpy as np
    import torch
    from repro_torch.data.shards import make_benchmark_federation
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    from repro_torch.utils import param_count
    t0 = time.perf_counter()
    if fedn is None:
        fedn = make_benchmark_federation("cifar", seed=0, n_priority=2)
    gen_s = time.perf_counter() - t0
    init_fn, apply_fn = SMALL_MODELS["cnn"]
    loss_fn = make_loss_fn(apply_fn)
    p0 = init_fn(0, device)
    M = param_count(p0)
    run_federation(loss_fn, p0, cifar_config(1), fedn, device=device)
    before = fk.fedagg.launches
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = run_federation(loss_fn, p0, cifar_config(rounds), fedn,
                       eval_every=1, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fk.fedagg.launches - before
    finite = (np.all(np.isfinite(h.global_loss))
              and np.all(np.isfinite(h.test_acc))
              and all(bool(torch.isfinite(v).all()) for v in h.params.values()))
    check(bool(finite), "slice (b): non-finite loss, accuracy or params")
    check(np.array(h.gates).shape == (rounds, fedn.x.shape[0]),
          "slice (b): gates of the wrong shape")
    if device != "cpu":
        check(launches == rounds, f"slice (b): {launches} fedagg launches in "
              f"{rounds} rounds")
    out = dict(M=M, clients=int(fedn.x.shape[0]),
               samples_per_client=int(fedn.x.shape[1]), data_gen_s=gen_s,
               seconds_per_round=secs / rounds, launches=launches,
               included_nonpriority=h.included, global_loss=h.global_loss,
               test_acc=h.test_acc)
    if device != "cpu":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("slice (b):", json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import build, fedagg as fk
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing ({exc})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul", torch.backends.cuda.matmul.allow_tf32,
          "cudnn", torch.backends.cudnn.allow_tf32)
    print(smi_line(), flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    check = Check()

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        print(f"ptxas[{name}]:", log.strip().replace("\n", " | ")[:4000])

    errs = kernel_phase(check)
    timings = timing_phase()

    fk.fedagg.launches = 0            # count only the main path from here
    a = slice_a(check)
    b = slice_b(check)
    launches = fk.fedagg.launches

    main_row = next(r for r in timings
                    if r["label"] == "slice_b" and r["dtype"] == "float32")
    max_err = max(errs["slice_b/float32"], errs["slice_b_pitched/float32"])
    line = {"kernels": [{
        "name": "fedagg_mean", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedagg.cu",
        "replaces": "src/repro/kernels/fedagg.py:189",
        "launches": launches, "max_abs_err": max_err, "max_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"]}]}
    expected = 2 * 4 + 6 + 1 + 3   # (a): 4 rounds x 2 backends + 6; (b): 1 + 3
    check(launches == expected, f"main path: {launches} fedagg launches, "
          f"expected {expected}")
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed",
              file=sys.stderr)
        return 1
    print("slices:", json.dumps({"a": a, "b": {
        k: b[k] for k in ("seconds_per_round", "launches", "M")}}))
    print(smi_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
