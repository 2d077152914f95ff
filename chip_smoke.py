#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the FedALIGN round end to
end through the hand-written fedagg kernel, under every aggregator and wire
codec; LM serving (prefill + decode of the dense GQA models, the MoE
archs, minicpm3's MLA, jamba, llava's image inputs and xlstm) through the
hand-written flash-attention, decode-attention, RMSNorm and
selective-scan kernels; and federated LM training (the spatial and the
temporal round over the dense GQA models, the MoE and MLA archs, jamba,
llava and xlstm) through the
flash-attention forward and backward, RMSNorm, selective-scan and fedagg
kernels; and the paper's own experiments (Figs. 1-6, the local-only
baseline, the Theorem 1 testbed) through the fedagg kernel.

    python3 chip_smoke.py

Phases, in the order they run, each of which fails the run (non-zero exit)
if a check fails:

1. the card's name and power limit (nvidia-smi); the CUDA kernels are
   built from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one
   nvcc per source, all started together; ptxas's report must show no
   stack and no spills in K3's register route, no spills in K8 and in
   K4's int8 stream, sketch and topk kernels;
2. kernel phase: ``fedagg`` (the CUDA kernel) against ``fedagg_plain`` on
   the card: mean + identity (f32, bf16) on the reference's edge cases,
   then every reducer (mean, dp, trimmed_mean, median) x wire (identity
   f32 and bf16, int8, topk, sketch) at the slice's shapes, C = 65, zero
   inclusion and NaN rows, and K4's edge cases under mean and dp (sketch
   dims up to and past the shared-memory route's, topk windows in one
   block and past one stage, ragged pitched int8); then each timed by
   CUDA-graph replay, warm and cold, beside the eager call, the plain
   version, a library yardstick (timed here only) and the bound, the
   sorted reducers (K3) also at C = 65; K1 is also held against its plain
   version at the LM round's 8 x 463,987,712 f32 (slice f2's aggregation:
   C x ld > 2^31), where ``--fedagg-timing`` also times K1 and K2;
3. LM kernel phase: flash-attention forward (K5, with its LSE), decode
   attention (K7) and RMSNorm (K9) against their plain versions on the
   card over causal / windowed / ragged / grouped cases in f32 and bf16
   (K5, K6 and K7 take their tensor-core route in bf16, the CUDA cores in
   f32; the cases include the tensor-core tiles' edges, and K7 also runs
   replayed in a CUDA graph against its eager output), then each timed at
   the serving path's shapes beside the plain version, its bound and a
   PyTorch yardstick (timed here only); K7 and K9 at every shape the
   serving paths give them (qwen1.5-0.5b, qwen2.5-3b, jamba-1.5-large,
   granite-moe, deepseek-moe, minicpm3),
   warm and cold, beside an empty kernel of the same launch shape; then the
   flash-attention backward (K6) against its plain version over the same
   cases, the FlashAttention and RMSNorm Functions' gradients on the card
   against the CPU, and K6 timed at the training shapes beside the plain
   version, its bound and scaled_dot_product_attention's backward; then
   the selective scan (K8) against its plain version (f32 and bf16 x, N in
   {4, 8, 16}, ragged S and Di, Bt 1 and 3, output and final state), and
   checked and timed at jamba's full-width prefill (Bt 2) and at one prompt
   (Bt 1) beside the plain version and its bound (no single PyTorch call
   computes a selective scan); then K8 under autograd (its forward, the
   plain-torch chunked backward) against autograd through the plain
   version on the card at Bt 2, S 512, jamba's 16384 channels, N 16, x
   f32 and bf16, the backward timed (slice g3's part ii);
4. slice (a): the quickstart config (SYNTH, ``synth_logreg``, C=20) for a
   few rounds on both backends, held against the same run on the CPU; and
   its shortened parity config under cosine_filter, slice (c)'s three
   aggregator + codec pairs and dp + sketch, each held against the CPU
   run; then the selection layer against the CPU: paper Fig. 5 cut to 3
   rounds and 200 samples a client (the FMNIST stand-in, ``logreg``,
   C=60, 18 priority, participation 0.3) on both backends, the parity config under an
   overflowing training cohort with a backlog boost and each of momentum,
   adam and yogi, and under topk_align, welfare, grad_sim and grad_sim
   on CountSketches (participation masks, cohorts, backlog and gates
   exactly);
5. slice (b): the paper's CIFAR ``cnn`` at full width, C=60, E=5, for 3
   rounds through ``run_federation``;
6. slice (c): the same config for 2 rounds each under median + int8 +
   error feedback, trimmed_mean + sketch, and dp + topk + error feedback;
7. slice (d): the serving path at smoke size (qwen1.5-0.5b, qwen2.5-3b,
   and qwen1.5-0.5b with a sliding window shorter than the prompt) on the
   card against the same code on the CPU: logits of prefill and every
   decode step, greedy tokens, and the scheduler's tokens vs generate's;
8. slice (e): full width with random init: qwen1.5-0.5b through generate
   (B 8, prompt 512, 32 new) and a BatchScheduler (16 requests), its f32
   teacher-forced check (prefill + decode vs the train-mode forward), and
   qwen2.5-3b through generate (B 4, prompt 1024, 16 new);
9. slice (g1): the smoke jamba (attention + 7 Mamba layers, 4 MoE FFNs)
   on the card against the same code on the CPU: logits of prefill and
   every decode step, the prefill caches (k, v, conv, h), greedy tokens,
   and (at a capacity that drops no token) the scheduler's tokens vs
   generate's; slice (g2): jamba-1.5-large-398b at its published widths
   cut to one period (8 of 72 layers) and 4 of 16 experts, random init,
   bf16: generate (B 2, prompt 1024, 16 new), a BatchScheduler (8
   requests), and the f32 teacher-forced check;
10. slice (f1): federated LM training at smoke size (qwen1.5-0.5b,
   qwen2.5-3b, and qwen1.5-0.5b with a sliding window) through
   ``launch.train.run`` on the card against the same code on the CPU:
   gates, losses, params, and one loss_fn gradient leaf for leaf;
11. slice (f2): full-width qwen1.5-0.5b federated training (8 clients,
   8 x 512 tokens each, E = 2, remat, 1 + 2 rounds) and an f32 gradient
   of the kernels against the plain versions on the card; slice (f3):
   the same round under a training cohort (2 priority, K = 4, FedAdam):
   8 clients evaluated, 4 trained into a 4-row client stack, the rest
   dropped with a backlog, s/round and peak GB beside (f2)'s;
12. slice (f4): (f2)'s config and batches through the temporal round
   (clients streamed one at a time through one client buffer and an f32
   running sum, no fedagg launch): gates equal to (f2)'s, the params
   after the first round within PARITY_ATOL of (f2)'s, s/round and peak
   GB beside (f2)'s; slice (f5): qwen2.5-3b at full width (3.09 B params)
   through the temporal round, 4 clients x 8 x 512, E = 2, 1 + 1 rounds,
   peak GB under 80 (the spatial round's C + 3 f32 copies of 12.34 GB
   would not fit);
13. slice (g3): jamba federated training: (i) the smoke jamba through
   ``launch.train.run`` on the card against the CPU, as (f1); (iii) one
   temporal round over jamba-1.5-large-398b cut to one period at d_model
   4096, d_ff 8192 and 4 experts (the published head_dim, ssm_state,
   conv, expand and top-2; 3.33 B params), with the sizing table beside
   the published widths' (16.25 B a period with 4 experts, 11.42 B with
   2: four f32 copies would not fit);
14. slice (h): the asynchronous round and the fault layer. (h1) slice
   (a)'s parity config on the card against the CPU under the fifo pipe,
   the variable-lag buffer with adaptive staleness and momentum, the
   event clock with chaos faults, the guard and a drain, and under
   crashes with NaN corruption on the temporal backend, dp,
   trimmed_mean and int8 + error feedback (discrete stats exactly; a
   NaN row included is skipped by the guard, NaN rows lost or gated out
   leave the aggregate finite; the int8 run's error-feedback rows held
   to the CPU's every round, a NaN client's row kept bit for bit); (h2)
   cell (b) under the buffer, the
   clock, crash and drop-out, then one guarded NaN round (params bit
   for bit); (h3) (f2)'s full-width round under the buffer, the clock,
   crashes and the guard (peak GB a round); (h4) the temporal round at
   smoke size, fifo D = 1 with crash and drop-out, against the CPU.
15. slice (i): candidate pools and checkpoints. (i1) tests/test_pool.py's
   federation (3 + 9 clients, a pool of 6) on the card against the CPU
   under six configs (each weighting, a cohort under momentum on the
   temporal backend, welfare with participation, the async buffer with
   the clock and chaos drawn per identity, dp with crashes, median +
   int8 + error feedback): pools, gates, lost clients and backlog
   exactly, every round's top-P margin checked, out-of-pool rows bit for
   bit; (i2) cell (b) with a pool of 20 of 60 under backlog weighting;
   (i3) population scale, a pool of 20 at C = 1,000 and C = 10,000
   beside the dense quickstart and a dense round at C = 1,000; (i4)
   (f2)'s round with a pool of 8 of 16 clients, and the temporal round
   with a pool at smoke size against the CPU; (i5) checkpoint and resume
   on the card (bit for bit), files crossing between the CPU and the
   card, the fingerprint's errors, and cell (b)'s state saved and loaded.
16. slice (j): the MoE and MLA archs. (j1) the smoke granite-moe,
   deepseek-moe (its leading dense block) and minicpm3 (MLA) on the card
   against the CPU: prefill and decode logits, expert choices exactly
   (router margins checked), the scheduler against generate, and 2
   rounds of ``launch.train.run`` (gates exactly, expert choices equal);
   (j2) the three at their published widths, every expert, granite every
   layer, deepseek and minicpm3 at half depth since slice (k) (f32
   params, bf16 compute): generate, a BatchScheduler for deepseek
   and minicpm3, the f32 teacher-forced check, init s, peak GB and
   launches; minicpm3's latent cache bytes beside an expanded k / v's.
17. slice (k): llava-next-34b (image inputs) and xlstm-125m (mLSTM,
   sLSTM). (k1) both smoke configs on the card against the CPU from
   the same params: prefill (llava's with image rows) and decode logits,
   the text-only generate's tokens, and 2 rounds of the LM round (llava's
   temporal round on image batches, xlstm through ``launch.train.run``);
   (k2) llava uncut in its bf16 params (34.39 B, 68.8 GB; init peak under
   the card's memory): B 2 x (576 image rows + 512 tokens) prefill, 16
   decode steps at n_img + S + i, a text-only generate and the f32
   teacher-forced check with image rows; (k3) one temporal round over
   llava cut to 2 of 60 layers (f32 params), K5 / K6 at G 7 under
   autograd; (k4) xlstm-125m at full width: generate B 4 x 1024, the
   sLSTM host loop's share of prefill, one spatial round.
18. slice (l): whisper-medium (the encoder-decoder) and the single-card
   knobs. (l1) the smoke whisper on the card against the CPU from the
   same params: prefill over its frames then decode logits, greedy
   tokens, loss_fn and its gradient; ``attn_bf16`` on the smoke qwen1.5
   (against the knob's route cast by hand on the card and the card's f32
   route; the gap to the CPU's rounding measured);
   ``remat_policy="save_mixer"`` against "full" on the smoke qwen1.5 and
   jamba; (l2) whisper-medium uncut (f32 params, bf16 compute): encode B
   8 x 1500 frames, prefill 32 tokens, 224 decode steps, the f32
   teacher-forced check; (l3) its loss differentiated at B 2 x 1500 x 448;
   (l4) ``save_mixer`` against "full" on qwen1.5-0.5b at full width, one
   8 x 512 client step: both peaks, both step times, the gradients.
19. slice (m): the paper's experiments, every configuration taken from
   ``repro_torch.configs.paper``. (m1) FIG1 (fmnist ``logreg``, emnist
   ``mlp2``, cifar ``cnn`` on slice (b)'s federation), FIG2's three
   SYNTH noise levels, FIG4 (FedProx), FIG5 (participation 0.3) and
   FIG6's points over FIG1's fmnist, at full data size for 3 rounds each
   through ``run_federation``; the fmnist runs held against the CPU
   (gates, included counts, loss and accuracy), the SYNTH ones by their
   gates and by an f64 CPU run (the card no more than WITNESS_K times as
   far from it as the CPU's f32 run), emnist and cifar on the card alone;
   each run's gate margin printed. (m2) Fig. 2: the three levels x
   fedalign, priority_only and all, M2_ROUNDS rounds (the paper's 200 cut
   to fit the time): final and best accuracy, mean included. (m3) App.
   C.1 / Fig. 3: FedALIGN for 20 rounds on the fmnist stand-in at 50
   samples a client against ``train_local_baseline`` at clients 5, 20, 40
   (held against the CPU), then all 60 in one solve, timed, each client's
   accuracy by ``local_accuracies`` (the two halves of
   ``run_local_baseline``). (m4) Theorem 1 in f64: bench_theory.py's
   instance at 200 rounds for five eps against the CPU (gates exactly,
   the rest within 1e-12), and the bound at the reference test's case.
20. slice (n): the pod round's data axes. (n1) ``make_pod_round`` on a
   one-rank NCCL group (``make_host_mesh(1)``), reached through
   ``launch.train.run(..., mesh=...)``: qwen1.5-0.5b at full width, 4
   clients of 4 x 512 tokens, E 2, 2 rounds under mean and one each under
   dp, median and int8, every round beside ``make_spatial_round`` on the
   same state and batch; gates, included counts and every param leaf the
   same bits, the recorded collectives ``pod_round_plan``'s, each round's
   seconds and peak GB for both; each case's fedagg launch (K1-K4) held
   against ``fedagg_plain`` on the [4, M_total] operands the pod reduce
   gave it. (n2) the dry-run CLI over every baseline target on both
   production meshes (one CPU subprocess beside (n1)), its GB a device
   beside the H100's 80 GB. NCCL puts one rank on a card;
21. slice (o), the pod round's model axis: (o2) K5 and K6 against their
   plain versions at a query offset (0, Skv / 2, the default) at
   qwen1.5-0.5b's 8 local heads and its seq-sharded rows, f32 and bf16,
   timed beside SDPA with the same boolean mask; (o1) qwen1.5-0.5b at
   published widths, 12 of its 24 layers, f32, on a (data 1, model 2)
   mesh of two spawned processes
   on cuda:0 over gloo, under mean, median and mean with
   ``seq_shard_attn``, each held against the one-process round on the
   card (decisions exactly, params within O1_PARAMS_TOL, replicated
   leaves the same bits on both ranks, collectives as planned).

The fedagg launches of slices (a)-(c), the LM launches of slices (d), (e),
(g1) and (g2), the training launches of slices (f) and (g3) (K5, K6,
K8, K9, fedagg) and those of slices (h), (i), (j), (k), (l), (m), (n) and
(o, in its ranks) are each counted from
zero just before their slices and must equal what the slices' rounds, forwards,
gradients and decode steps imply (a remat gradient runs each period's
forward twice).

It ends with a JSON line of the kernels (launch counts from the slice
phases, errors and times from this run) and, last, the ok line. It needs
no JAX and none of the ``repro`` package. ``--fedagg-timing`` and
``--compare`` run the fedagg kernel alone (``fedagg_main``).
"""
from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
# f32 compare / min / max: 64 results a clock per SM on compute capability
# 9.0 (the CUDA C++ programming guide's arithmetic throughput table), half
# the FMA rate, at the 1.98 GHz clock of the 67 TFLOP/s above
H100_MINMAX_PER_S = 64 * 132 * 1.98e9
F32_TOL = 1e-5                    # x max|u|: only the summation order differs


def ptxas_entries(log):
    """{kernel symbol: (registers, stack bytes, spill store bytes, spill
    load bytes)} from an nvcc -Xptxas -v report."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", chunk)
        if regs and frame:
            out[chunk.split("'", 1)[0]] = (int(regs.group(1)),
                                           *(int(v) for v in frame.groups()))
    return out


# (library, the substrings of the kernel's symbol, whether its frame must
# have no stack): K3's register route, K8, and K4's int8 stream, sketch and
# topk kernels
PTXAS_KERNELS = (("fedagg", ("sorted_reg_kernel",), True),
                 ("ssm_scan", ("ssm_scan_kernel",), False),
                 ("fedagg", ("stream_kernel", "DecInt8"), False),
                 ("fedagg", ("sketch_kernel",), False),
                 ("fedagg", ("topk_sum_kernel",), False))


def ptxas_check(check: Check, reports):
    """K3's register route (sorted_reg_kernel) compiles to no stack and no
    spills (no register array indexed at run time); K8 and K4's kernels to
    no spills. Prints their registers."""
    summary = {}
    for name, parts, stack_ok in PTXAS_KERNELS:
        found = False
        for sym, (regs, stack, st, ld) in ptxas_entries(reports.get(name, "")).items():
            if not all(part in sym for part in parts):
                continue
            found = True
            summary[sym] = dict(registers=regs, stack=stack, spill_stores=st,
                                spill_loads=ld)
            check(st == 0 and ld == 0, f"ptxas: {sym} spills ({st} / {ld} bytes)")
            if stack_ok:
                check(stack == 0, f"ptxas: {sym} has a {stack}-byte stack frame")
        check(found, f"ptxas: no report of {' / '.join(parts)}")
    print("ptxas K3 / K4 / K8:", json.dumps(summary), flush=True)
    return summary


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
    inclusion mass and a NaN in a gated-out row. Slice (m)'s FIG1 shapes:
    emnist's ``mlp2`` over 25 clients, fmnist's ``logreg`` over 60 (also
    FIG4, FIG5, FIG6 and (m3)); FIG2's SYNTH rows are slice (a)'s."""
    cases = [("slice_a", dict(C=20, M=610, gates="all")),
             ("slice_a_pitched", dict(C=20, M=610, pitch=616)),
             ("slice_b", dict(C=60, M=579402, gates="all")),
             ("slice_b_pitched", dict(C=60, M=579402, pitch=579408)),
             ("slice_b_mixed", dict(C=60, M=579402)),
             ("fig1_emnist", dict(C=25, M=206647, gates="all")),
             ("fig1_emnist_pitched", dict(C=25, M=206647, pitch=206648)),
             ("fig1_emnist_mixed", dict(C=25, M=206647)),
             ("fig1_fmnist", dict(C=60, M=7850, gates="all")),
             ("fig1_fmnist_pitched", dict(C=60, M=7850, pitch=7856)),
             ("fig1_fmnist_mixed", dict(C=60, M=7850))]
    for C, M in [(1, 64), (1, 7), (4, 100), (5, 513), (3, 2065), (65, 4096)]:
        cases.append((f"edge_{C}x{M}", dict(C=C, M=M)))
    cases += [("zero_rows", dict(C=8, M=1000, zero_rows=(1, 3))),
              ("zero_mass", dict(C=8, M=1000, gates="none")),
              ("nan_gated_out", dict(C=8, M=1000, nan_row=2)),
              ("many_clients", dict(C=300, M=1000))]
    return cases


def kernel_phase(check: Check, device="cuda"):
    """Hold the mean + identity kernel against its plain version on every
    case, f32 and bf16. Returns the worst error per case."""
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


# ------------------------------------------------- variants (K2, K3, K4)
REDUCERS = ("mean", "dp", "trimmed_mean", "median")
WIRES = ("identity_f32", "identity_bf16", "int8", "topk", "sketch")
# the JSON line's kernels: (name, TPU function it replaces, which
# (aggregator, codec) launches count for it, the variant timed for it, the
# (reducer, wire) rows listed under its shapes; K1's are timing_phase's).
# The reducers count whatever wire feeds them; the decoders whatever they
# feed.
KERNELS = [
    ("fedagg_mean", "src/repro/kernels/fedagg.py:189",
     lambda a, c: a == "mean", ("mean", "identity_f32"), ()),
    ("fedagg_dp", "src/repro/kernels/fedagg.py:200",
     lambda a, c: a == "dp", ("dp", "identity_f32"),
     (("dp", "identity_f32"), ("dp", "identity_bf16"))),
    ("fedagg_trimmed_mean", "src/repro/kernels/fedagg.py:216",
     lambda a, c: a == "trimmed_mean", ("trimmed_mean", "identity_f32"),
     tuple(("trimmed_mean", w) for w in WIRES)),
    ("fedagg_median", "src/repro/kernels/fedagg.py:230",
     lambda a, c: a == "median", ("median", "identity_f32"),
     tuple(("median", w) for w in WIRES)),
    ("fedagg_decode_int8", "src/repro/kernels/fedagg.py:151",
     lambda a, c: c == "int8", ("mean", "int8"), (("mean", "int8"), ("dp", "int8"))),
    ("fedagg_decode_topk", "src/repro/kernels/fedagg.py:157",
     lambda a, c: c == "topk", ("mean", "topk"), (("mean", "topk"), ("dp", "topk"))),
    ("fedagg_decode_sketch", "src/repro/kernels/fedagg.py:178",
     lambda a, c: c == "sketch", ("mean", "sketch"),
     (("mean", "sketch"), ("dp", "sketch"))),
]
TRIM_FRAC = 0.2


def wire_fed():
    """The codec rates of the slice's configs (the reference defaults)."""
    from repro_torch.configs.base import FedConfig
    return FedConfig(codec_topk_frac=0.01, codec_sketch_dim=2048)


def variant_case(reducer, wire, C, M, device, *, gates="mixed", nan_row=None,
                 nan_included=False, seed=0, fed=None, block_row=None):
    """(updates, weights, gates, kwargs) for one reducer x wire case: dense
    rows from a seeded generator, encoded by the port's codec (at ``fed``'s
    rates, default wire_fed()). ``nan_row`` puts NaNs in that row, gated
    out unless ``nan_included``; ``block_row`` lifts that row's columns
    2048-4095, so that its top-k pairs all fall in one topk block."""
    import torch
    from repro_torch.core import aggregation as agg
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(C, M, generator=gen)
    if block_row is not None:
        u[block_row, 2048:4096] += 100.0
    w = torch.rand(C, generator=gen) + 0.1
    if gates == "all":
        g = torch.ones(C)
    elif gates == "none":
        g = torch.zeros(C)
    else:
        g = (torch.rand(C, generator=gen) > 0.3).float()
        g[0] = 1.0
    row_scale = torch.rand(C, generator=gen)
    noise = torch.randn(M, generator=gen)
    if nan_row is not None:
        u[nan_row, ::7] = float("nan")
        g[nan_row] = 1.0 if nan_included else 0.0
        if not nan_included:
            row_scale[nan_row] = float("nan")    # as a NaN delta's clip scale
    dev = torch.device(device)
    if wire.startswith("identity"):
        dtype = torch.float32 if wire == "identity_f32" else torch.bfloat16
        updates = agg.flatten_stacked({"u": u.to(dev)}, dtype=dtype)
        kw = {}
    else:
        updates, kw = agg.get_wire_codec(wire).encode(fed or wire_fed(), u.to(dev))
    kw = dict(kw, aggregator=reducer)
    if reducer == "dp":
        kw.update(row_scale=row_scale.to(dev), noise=noise.to(dev),
                  noise_scale=0.3)
    elif reducer == "trimmed_mean":
        kw["trim_frac"] = TRIM_FRAC
    return updates, w.to(dev), g.to(dev), kw


def decoded_rows(updates, kw, M):
    """The dense f32 [C, M] rows the kernel reduces (the plain decode)."""
    from repro_torch.kernels.fedagg import decode_wire_plain
    codec = kw.get("codec", "identity")
    if codec == "identity":
        return updates.float()
    return decode_wire_plain(updates, codec=codec, out_m=M, **{
        k: kw[k] for k in ("dequant_scale", "topk_idx", "sketch_h",
                           "sketch_sign") if k in kw})


def compare_variant(out, want, updates, w, g, kw):
    """(ok, max_abs_err) of the kernel's output against the plain version's.

    Where both are NaN they agree (a NaN in an included row of a sorted
    reducer must land where the plain network puts it, so the NaN masks
    must be equal). Elsewhere, f32 outputs: within 1e-5 of the largest
    magnitude the sum can reach, max|rows| (times max row_scale for dp)
    plus dp's noise term, since only the order of the f32 sums differs
    (the median takes two values and is exact). bf16 outputs: one bf16 ulp
    of the plain result plus that f32 bound (both round an f32 result)."""
    import torch
    red = kw["aggregator"]
    o, p = out.float(), want.float()
    nan_o, nan_p = torch.isnan(o), torch.isnan(p)
    if not bool(torch.equal(nan_o, nan_p)):
        return False, float("inf")
    fin = ~nan_p
    err = float(torch.max(torch.abs(o[fin] - p[fin]))) if bool(fin.any()) else 0.0
    M = out.shape[0]
    rows = decoded_rows(updates, kw, M)
    inc = (g > 0) if red in ("trimmed_mean", "median") else (w * g > 0)
    r = rows[inc]
    r = r[torch.isfinite(r)]
    mag = float(torch.max(torch.abs(r))) if r.numel() else 0.0
    if red == "dp":
        den = float(torch.sum(torch.where(inc, w * g, 0.0)))
        rs = kw["row_scale"][inc]
        mag = mag * (float(torch.max(rs)) if rs.numel() else 0.0)
        if den > 0:
            mag += float(torch.max(torch.abs(kw["noise"]))) * kw["noise_scale"] / den
    bound = 1e-5 * max(mag, 1e-30)
    if out.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(torch.abs(p[fin]),
                                                            min=2.0 ** -126))) - 7)
        return bool(torch.all(torch.abs(o[fin] - p[fin]) <= ulp + bound)), err
    return err <= bound, err


def variant_cases():
    """(label, C, M, case kwargs): the slice's shapes (K1's plus the
    cell-(b) width), C = 1-4 (P = 1, 2, 4 for the sorted reducers), C = 65
    (P = 128), zero inclusion, a NaN in a gated-out row, and a NaN in an
    included row."""
    return [("slice_a", 20, 610, {}),
            ("c1", 1, 1000, {}),
            ("c2", 2, 1000, {}),
            ("c3", 3, 1001, {}),
            ("c4", 4, 1000, {}),
            ("slice_b", 60, 579402, {}),
            ("slice_b_all", 60, 579402, dict(gates="all")),
            ("c65", 65, 4099, {}),
            ("zero_inclusion", 8, 1000, dict(gates="none")),
            ("nan_gated_out", 8, 1000, dict(nan_row=2)),
            ("nan_included", 9, 1000, dict(nan_row=3, nan_included=True))]


def decoder_cases():
    """(label, wire, C, M, variant_case kwargs): K4's edge cases under mean
    and dp, at an M that is not a multiple of a sketch cluster's columns
    (8 x 256 x 4) nor of 4: the sketch at dim 1, 7, 2048 and the largest
    dim its shared-memory route takes, and one past it (the gather route);
    topk with one row's pairs all in one block, and with more pairs than
    one stage holds (frac 0.5); int8 with a ragged, pitched row. Each with
    a NaN row behind a zero gate but the stage case (all gates 1)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.kernels import fedagg as fk
    M = 8 * 256 * 4 + 3
    cases = [(f"sketch_dim{d}", "sketch", 6, M,
              dict(nan_row=2, fed=FedConfig(codec_sketch_dim=d)))
             for d in (1, 7, 2048, fk.MAX_SKETCH_DIM, fk.MAX_SKETCH_DIM + 1)]
    return cases + [
        ("topk_one_block", "topk", 6, M,
         dict(nan_row=2, block_row=1, fed=FedConfig(codec_topk_frac=0.05))),
        ("topk_stages", "topk", 8, M,
         dict(gates="all", fed=FedConfig(codec_topk_frac=0.5))),
        ("int8_ragged_pitched", "int8", 6, M, dict(nan_row=2))]


def variant_phase(check: Check, device="cuda"):
    """Every reducer x wire against its plain version on the card, then
    K4's edge cases under mean and dp. Returns the worst error per
    (reducer, wire) at the cell-(b) shape."""
    import torch
    from repro_torch.kernels import fedagg as fk
    worst = {}
    cases = [(red, wire, label, C, M, kw) for red in REDUCERS for wire in WIRES
             for label, C, M, kw in variant_cases()
             # a NaN in an included row poisons a sum
             if label != "nan_included" or red in ("trimmed_mean", "median")]
    cases += [(red, wire, label, C, M, kw) for label, wire, C, M, kw in decoder_cases()
              for red in ("mean", "dp")]
    for red, wire, label, C, M, kw in cases:
        updates, w, g, ops = variant_case(red, wire, C, M, device, **kw)
        before = fk.fedagg.launches
        out = fk.fedagg(updates, w, g, **ops)
        launched = fk.fedagg.launches - before
        want = fk.fedagg_plain(updates, w, g, **ops)
        ok, err = compare_variant(out, want, updates, w, g, ops)
        name = f"{red}/{wire}/{label}"
        check(launched == 1, f"fedagg {name}: {launched} launches")
        check(ok, f"fedagg {name}: max_abs_err {err}")
        if label == "zero_inclusion":
            check(bool(torch.all(out == 0)), f"fedagg {name}: zero "
                  "inclusion must give exact zeros")
        if kw.get("nan_row") is not None and not kw.get("nan_included"):
            check(bool(torch.isfinite(out).all()),
                  f"fedagg {name}: NaN leaked from a gated-out row")
        if label == "nan_included" and wire.startswith("identity"):
            # the int8 wire sends a NaN as 0 (the reference's cast)
            check(bool(torch.isnan(out).any()),
                  f"fedagg {name}: the included NaN vanished")
        if label == "slice_b":
            worst[f"{red}/{wire}"] = err
    # the trim count in f32: at trim_frac 0.29 and n = 100 clients
    # int32(f32(0.29) * f32(100)) = 29 where the f64 product truncates to 28
    updates, w, g, ops = variant_case("trimmed_mean", "identity_f32", 100,
                                      4096, device, gates="all")
    ops["trim_frac"] = 0.29
    out = fk.fedagg(updates, w, g, **ops)
    ok, err = compare_variant(out, fk.fedagg_plain(updates, w, g, **ops),
                              updates, w, g, ops)
    check(ok, f"fedagg trimmed_mean/trim 0.29 x 100: max_abs_err {err}")
    if device != "cpu":
        torch.cuda.synchronize()
    print("variant phase:", json.dumps(worst), flush=True)
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


def fedagg_times(fk, updates, w, g, ops):
    """One fedagg call's device time by CUDA-graph replay, warm (ms: the
    same inputs every call) and cold (ms_cold: the inputs and clones of
    every input tensor, rotated over COLD_BYTES, each call's inputs out of
    L2: one clone where the inputs alone exceed it), and the eager call's
    time with its host cost (eager_ms: Python, the checks, the ctypes
    launch)."""
    import torch
    call = lambda: fk.fedagg(updates, w, g, **ops)   # noqa: E731
    tensors = {k: v for k, v in ops.items() if torch.is_tensor(v)}
    nbytes = sum(t.numel() * t.element_size()
                 for t in (updates, w, g, *tensors.values()))
    n = cold_copies(nbytes)
    copies = [(updates, w, g, ops)] + [
        (updates.clone(), w.clone(), g.clone(),
         dict(ops, **{k: v.clone() for k, v in tensors.items()}))
        for _ in range(n - 1)]
    ms_cold = graph_each_ms([lambda c=c: fk.fedagg(c[0], c[1], c[2], **c[3])
                             for c in copies])
    del copies
    torch.cuda.empty_cache()
    return dict(ms=graph_ms(call), ms_cold=ms_cold, cold_copies=n,
                eager_ms=time_ms(call))


@functools.lru_cache(maxsize=None)
def f2_width() -> int:
    """M of the LM round's aggregation (slice f2): the parameter count of
    qwen1.5-0.5b, from an init on the meta device (shapes alone)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils import param_count
    model = get_model(get_config("qwen1.5-0.5b"))
    return param_count(model.init(prng.PRNGKey(0), device="meta"))


F2_CLIENTS = 8                    # slice (f2)'s clients


def f2_case(reducer, gates="all", seed=0):
    """(updates, weights, gates, kwargs) at the LM round's shape: 8 x
    f2_width() f32 rows laid out as flatten_stacked lays them
    (pitched_empty), drawn on the card from a seeded generator (the same
    bits in every run on one card: 14.85 GB would take the host minutes).
    ``gates`` "mixed" gates out rows 2 and 5, whose clip scales are NaN
    under dp."""
    import torch
    from repro_torch.core.aggregation import pitched_empty
    C, M = F2_CLIENTS, f2_width()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    updates = pitched_empty(C, M, torch.float32, "cuda")
    updates.normal_(generator=gen)
    w = torch.rand(C, generator=gen, device="cuda") + 0.1
    g = torch.ones(C, device="cuda")
    kw = dict(aggregator=reducer)
    if reducer == "dp":
        rs = torch.rand(C, generator=gen, device="cuda")
        kw.update(row_scale=rs, noise=torch.randn(M, generator=gen, device="cuda"),
                  noise_scale=0.3)
    if gates == "mixed":
        g[[2, 5]] = 0.0
        if reducer == "dp":
            kw["row_scale"][[2, 5]] = float("nan")
    return updates, w, g, kw


def f2_check(check, out, want, updates):
    """The kernel's f2 output against the plain version's, all rows
    included: within F32_TOL x max|u| (aminmax: no [C, M] temporary).
    Returns max_abs_err."""
    import torch
    lo, hi = torch.aminmax(updates)
    scale = max(-float(lo), float(hi))
    err = float(torch.max(torch.abs(out - want)))
    finite = bool(torch.isfinite(out).all())
    check(finite and err <= F32_TOL * scale, f"fedagg f2 {out.shape[0]} columns "
          f"(C x ld = {updates.shape[0] * updates.stride(0)}): max_abs_err {err}")
    return err


def timing_phase(check: Check, device="cuda", f2=False):
    """K1 (mean + identity) at the slice's shapes, all gates 1 as in the
    bound: the kernel (fedagg_times), the plain version (eager) and the
    torch.mv yardstick (graph replay, library_ms). At the LM round's shape
    (f2_case: C x ld > 2^31 elements) the kernel is held against its plain
    version (f2_check), and with ``f2`` also timed there. Returns rows for
    PERF.md and the line."""
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
            times = fedagg_times(fk, up, w, g, {})
            plain = time_ms(lambda: fk.fedagg_plain(u, w, g))
            library = graph_ms(lambda: torch.mv(masked.t(), wg))
            size = u.element_size()
            bound, by = fedagg_bound(int((g > 0).sum()), M, size, size, C)
            rows.append(dict(shape=f"{C}x{M}", dtype=str(dtype).split(".")[-1],
                             label=label, **times, plain_ms=plain,
                             library_ms=library, bound_ms=bound, bound_by=by))
            print("timing:", json.dumps(rows[-1]), flush=True)
    up, w, g, _ = f2_case("mean")
    C, M = up.shape
    err = f2_check(check, fk.fedagg(up, w, g), fk.fedagg_plain(up, w, g), up)
    print("fedagg f2 check:", json.dumps(dict(shape=f"{C}x{M}", ld=up.stride(0),
                                              max_abs_err=err)), flush=True)
    if f2:
        times = fedagg_times(fk, up, w, g, {})
        plain = time_ms(lambda: fk.fedagg_plain(up, w, g), iters=3, warmup=1)
        library = graph_ms(lambda: torch.mv(up.t(), w * g))   # every row included
        bound, by = fedagg_bound(C, M, 4, 4, C)
        rows.append(dict(shape=f"{C}x{M}", dtype="float32", label="f2", **times,
                         plain_ms=plain, library_ms=library, bound_ms=bound,
                         bound_by=by, max_abs_err=err))
        print("timing:", json.dumps(rows[-1]), flush=True)
    del up
    torch.cuda.empty_cache()
    return rows


def sort_ops(C, M):
    """min + max of every compare-exchange of the bitonic network down the
    client axis (C padded to P = 2^L): P/2 * L(L+1)/2 exchanges a column.
    They run at the min / max rate (H100_MINMAX_PER_S), not the FMA's."""
    P = 1 << max(0, (C - 1).bit_length())
    L = P.bit_length() - 1
    return 2.0 * M * (P // 2) * L * (L + 1) // 2


def variant_bound(red, wire, ops, C_inc, C, M):
    """Least time for one call: the bytes it must move (the included rows'
    wire payload, the hash planes, dp's noise and scales, the output, w
    and g) over the memory rate vs its operations over the f32 rate (the
    weighted sum's multiply-adds and the decode's multiply; for the sorted
    reducers the min and max of every compare-exchange, over the min / max
    rate)."""
    out_size = 2 if wire == "identity_bf16" else 4
    if wire.startswith("identity"):
        wire_bytes = C_inc * M * out_size
    elif wire == "int8":
        wire_bytes = C_inc * M + 4 * C_inc
    elif wire == "topk":
        wire_bytes = C_inc * ops["topk_idx"].shape[1] * 8
    else:
        wire_bytes = C_inc * 4 * int(wire_fed().codec_sketch_dim) + 8 * M
    bytes_ = wire_bytes + M * out_size + 8 * C
    if red == "dp":
        bytes_ += 4 * M + 4 * C
    if red in ("trimmed_mean", "median"):
        t_ops = sort_ops(C, M) / H100_MINMAX_PER_S
    elif wire == "topk":
        t_ops = 2.0 * C_inc * ops["topk_idx"].shape[1] / H100_F32_FLOPS
    else:
        t_ops = (2.0 if wire.startswith("identity") else 3.0) * C_inc * M / H100_F32_FLOPS
    t_bytes = bytes_ / H100_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def variant_timing_phase(device="cuda", C=60, M=579402, f2=False):
    """Every reducer x wire but K1's mean + identity at the cell-(b) shape,
    all gates 1: the kernel (fedagg_times: device time warm and cold by
    graph replay, and the eager call's), the plain version (eager), the
    bound, and a library yardstick timed here only — torch.mv of the
    decoded, masked rows for mean and dp (graph replay); torch.sort of the
    decoded rows down the client axis for trimmed_mean (the sort alone,
    without the order statistics; eager); for the median
    torch.quantile(rows, 0.5, dim=0, interpolation="midpoint"),
    jnp.median's function in one call (eager), with torch.sort beside it
    (sort_ms). The sorted reducers also at C = 65 (label c65: P = 128, the
    shared-memory route) with f32 rows; with ``f2``, K2 over f32 rows also
    at the LM round's shape (label f2, f2_case), where every row is
    included and torch.mv reads the rows in place."""
    import torch
    from repro_torch.kernels import fedagg as fk
    rows = []
    cases = [(red, wire, C, "slice_b") for red in REDUCERS for wire in WIRES
             if (red, wire) != ("mean", "identity_f32")]   # K1, timed above
    cases += [(red, "identity_f32", 65, "c65") for red in ("trimmed_mean", "median")]
    if f2:
        cases += [("dp", "identity_f32", F2_CLIENTS, "f2")]
    for red, wire, rows_c, label in cases:
        if label == "f2":
            updates, w, g, ops = f2_case(red)
        else:
            updates, w, g, ops = variant_case(red, wire, rows_c, M, device,
                                              gates="all")
        cols = f2_width() if label == "f2" else M
        dense = decoded_rows(updates, ops, cols)
        extra = {}
        if red in ("trimmed_mean", "median"):
            keyed = torch.where((g > 0)[:, None], dense, float("inf"))
            library = time_ms(lambda: torch.sort(keyed, dim=0), iters=10)
            if red == "median":               # the function itself, one call
                extra["sort_ms"] = library
                library = time_ms(lambda: torch.quantile(
                    dense, 0.5, dim=0, interpolation="midpoint"), iters=10)
        else:
            wg = w * g
            if red == "dp":
                wg = torch.where(wg > 0, wg * ops["row_scale"], 0.0)
            masked = dense if label == "f2" else torch.where(
                (w * g > 0)[:, None], dense, 0.0)
            library = graph_ms(lambda: torch.mv(masked.t(), wg))
        times = fedagg_times(fk, updates, w, g, ops)
        plain = time_ms(lambda: fk.fedagg_plain(updates, w, g, **ops),
                        iters=10)
        bound, by = variant_bound(red, wire, ops, int((g > 0).sum()), rows_c, cols)
        rows.append(dict(reducer=red, wire=wire, shape=f"{rows_c}x{cols}",
                         label=label, **times, plain_ms=plain,
                         library_ms=library, bound_ms=bound, bound_by=by,
                         **extra))
        print("variant timing:", json.dumps(rows[-1]), flush=True)
        del updates, dense, ops
        if label == "f2":
            del masked
            torch.cuda.empty_cache()
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
    """Cell (b)'s config: the paper's CIFAR-10 settings (N=60, |P|=2, E=5,
    eps=0.2 on accuracies) but lr 0.1, where ``paper.FIG1["cifar"]`` has
    0.01; kept so that (b)'s times stay comparable across revisions.
    Slice (m1) runs ``FIG1["cifar"]`` itself."""
    from repro_torch.configs.base import FedConfig
    return FedConfig(num_clients=60, num_priority=2, rounds=rounds,
                     local_epochs=5, epsilon=0.2, lr=0.1, warmup_frac=0.1,
                     align_stat="accuracy", selection="fedalign",
                     backend="vmap_spatial")


def slice_b(check: Check, device="cuda", rounds=3, fedn=None):
    """Config (b): the full-width cnn on the CIFAR stand-in (C=60, 1000
    samples per client, M=579,402), a 1-round warm-up run, then ``rounds``
    timed rounds through run_federation. Returns the stats and the
    federation (slice (c) reuses it)."""
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
    return out, fedn


# the robust, private and compressed configs of slice (c) and of the
# small-input parity runs
SLICE_C = {
    "c1": dict(aggregator="median", wire_codec="int8", error_feedback=True),
    "c2": dict(aggregator="trimmed_mean", trim_frac=0.1, wire_codec="sketch",
               error_feedback=False),
    "c3": dict(aggregator="dp", dp_clip=1.0, dp_noise=0.1, wire_codec="topk",
               error_feedback=True),
}
PARITY_AGG = {
    "cosine_filter": dict(aggregator="cosine_filter", outlier_cos=0.2,
                          sketch_dim=64),
    "median_int8_ef": SLICE_C["c1"],
    "trimmed_sketch": dict(SLICE_C["c2"], codec_sketch_dim=256),
    "dp_topk_ef": dict(SLICE_C["c3"], codec_topk_frac=0.2),
    # K4's sketch_kernel on the main path. mean + int8 is not here: the
    # int8 wire's one-quantum flips (a last-bit difference in x / scale)
    # move its global loss ~7e-5 off the CPU run, above the 1e-5 bound
    "dp_sketch": dict(SLICE_C["c3"], wire_codec="sketch", codec_sketch_dim=256,
                      error_feedback=False),
}


def int8_quanta():
    """Wrap the int8 codec's encode to record each round's largest row
    scale (one quantum); returns the list and the undo function."""
    from repro_torch.core import aggregation as agg
    scales, encode = [], agg._Int8Codec.encode

    def recording(fed, buf):
        q, kw = encode(fed, buf)
        scales.append(float(kw["dequant_scale"].max()))
        return q, kw

    agg._Int8Codec.encode = staticmethod(recording)
    return scales, lambda: setattr(agg._Int8Codec, "encode", staticmethod(encode))


def slice_a_aggregators(check: Check, device="cuda"):
    """The shortened quickstart (C=8, E=2, 6 rounds) under cosine_filter
    (identity wire), under slice (c)'s three aggregator + codec pairs and
    under dp + sketch, on both backends on the card, each held against the
    same run on the
    CPU: gates exact, global loss within rtol 1e-5, params within 1e-4
    max|p| — plus, where the int8 wire is on, one quantum of the run's
    largest row scale (a last-bit difference can cross a rounding boundary;
    error feedback keeps it from accumulating). One fedagg launch a round."""
    import numpy as np
    import torch
    from repro_torch.data.synth import make_synth_federation
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    small = make_synth_federation(seed=0, n_priority=4, n_nonpriority=4,
                                  samples_per_client=40, test_samples=200)
    gen = torch.Generator().manual_seed(42)
    p0 = {"b": 0.05 * torch.randn(10, generator=gen),
          "w": 0.05 * torch.randn(60, 10, generator=gen)}
    out = {}
    for label, knobs in PARITY_AGG.items():
        for backend in ("vmap_spatial", "scan_temporal"):
            fed = parity_config().replace(backend=backend, **knobs)
            scales, undo = int8_quanta()
            try:
                cpu = run_federation(loss_fn, p0, fed, small, eval_every=2,
                                     device="cpu")
            finally:
                undo()
            before = fk.fedagg.launches
            dev = run_federation(loss_fn, p0, fed, small, eval_every=2,
                                 device=device)
            launches = fk.fedagg.launches - before
            name = f"slice (a) {label} {backend}"
            check(np.array_equal(np.array(dev.gates), np.array(cpu.gates)),
                  f"{name}: gates differ from the CPU run")
            loss_rel = float(np.max(np.abs(np.array(dev.global_loss)
                                           / np.array(cpu.global_loss) - 1.0)))
            check(loss_rel <= 1e-5, f"{name}: global loss off the CPU run by "
                  f"rtol {loss_rel}")
            extra = max(scales, default=0.0)
            errs = {k: float((dev.params[k].cpu() - cpu.params[k]).abs().max())
                    for k in cpu.params}
            ok = all(errs[k] <= 1e-4 * float(cpu.params[k].abs().max()) + extra
                     for k in cpu.params)
            check(ok, f"{name}: params off the CPU run by {errs} (one "
                  f"quantum {extra})")
            check(dev.dp_epsilon == cpu.dp_epsilon,
                  f"{name}: dp report differs from the CPU run")
            if device != "cpu":
                check(launches == 6, f"{name}: {launches} fedagg launches in "
                      "6 rounds")
            out[f"{label}/{backend}"] = dict(
                launches=launches, included=dev.included,
                global_loss_rtol_vs_cpu=loss_rel, params_abs_err_vs_cpu=errs)
            print(f"{name}:", json.dumps(out[f"{label}/{backend}"]), flush=True)
    return out


# slice (a), selection: (label, backend, knobs) on the shortened quickstart.
# The cohort runs gate on losses with an eps that admits every client, so
# K = 6 of 8 overflows each round and the boosted backlog rotates the last
# two slots; the backends alternate
SELECT_COHORT = dict(max_cohort=6, backlog_boost=0.2, epsilon=1.0,
                     align_stat="loss")
SELECTION_RUNS = [
    ("cohort_momentum", "vmap_spatial",
     dict(SELECT_COHORT, server_opt="momentum", server_lr=0.2)),
    ("cohort_adam", "scan_temporal",
     dict(SELECT_COHORT, server_opt="adam", server_lr=0.05)),
    ("cohort_yogi", "vmap_spatial",
     dict(SELECT_COHORT, server_opt="yogi", server_lr=0.05)),
    ("topk_align", "scan_temporal", dict(selection="topk_align", topk=2)),
    ("welfare", "vmap_spatial", dict(selection="welfare", welfare_floor=0.3)),
    ("grad_sim", "scan_temporal", dict(selection="grad_sim")),
    ("grad_sim_sketch", "vmap_spatial",
     dict(selection="grad_sim", grad_sim_sketch=True, sketch_dim=64)),
]
FIG5_ROUNDS = 3
# of each client's 1,000: the scan backend's client loop is host-bound
# (16.5 s for 3 rounds at 1,000 on the H100's host)
FIG5_SAMPLES = 200


def fig5_config(backend):
    """Paper App. C.3 / Fig. 5 (``repro_torch.configs.paper.FIG5``) cut to
    FIG5_ROUNDS rounds: 60 clients, 18 priority, 30% sampled a round."""
    from repro_torch.configs import paper
    return paper.FIG5["fed"].replace(rounds=FIG5_ROUNDS, backend=backend)


@contextmanager
def selection_records():
    """Record every participation mask and cohort the engine draws (the
    cohort's indices, gates, effective gates and the backlog going in)."""
    from repro_torch.fl import engine
    rec = {"part": [], "cohort": []}
    part, cohort = engine.participation_mask, engine.cohort_select

    def recording_part(*a, **k):
        out = part(*a, **k)
        rec["part"].append([out.cpu()])
        return out

    def recording_cohort(*a, **k):
        out = cohort(*a, **k)
        rec["cohort"].append([x.cpu() for x in out] + [k["backlog"].cpu()])
        return out

    engine.participation_mask, engine.cohort_select = (recording_part,
                                                       recording_cohort)
    try:
        yield rec
    finally:
        engine.participation_mask, engine.cohort_select = part, cohort


def same_records(a, b) -> bool:
    import torch
    flat_a, flat_b = ([t for k in sorted(r) for call in r[k] for t in call]
                      for r in (a, b))
    return len(flat_a) == len(flat_b) and all(
        torch.equal(x, y) for x, y in zip(flat_a, flat_b))


def run_pair(check, name, loss_fn, p0, fed, fedn, device, rounds):
    """One run_federation on the CPU and one on ``device`` from the same
    params: gates, participation masks and cohorts exactly; global loss
    within rtol 1e-5 and params within 1e-4 max|p| of the CPU run; adam's
    and yogi's step count exactly; one fedagg launch a round."""
    import numpy as np
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    with selection_records() as rec_cpu:
        cpu = run_federation(loss_fn, p0, fed, fedn, eval_every=2,
                             device="cpu")
    before = fk.fedagg.launches
    t0 = time.perf_counter()
    with selection_records() as rec_dev:
        dev = run_federation(loss_fn, p0, fed, fedn, eval_every=2,
                             device=device)
    secs = time.perf_counter() - t0
    launches = fk.fedagg.launches - before
    check(np.array_equal(np.array(dev.gates), np.array(cpu.gates)),
          f"{name}: gates differ from the CPU run")
    check(same_records(rec_dev, rec_cpu), f"{name}: participation masks or "
          "cohorts (indices, gates, backlog) differ from the CPU run")
    loss_rel = float(np.max(np.abs(np.array(dev.global_loss)
                                   / np.array(cpu.global_loss) - 1.0)))
    check(loss_rel <= 1e-5, f"{name}: global loss off the CPU run by rtol "
          f"{loss_rel}")
    rel = max(float((dev.params[k].cpu() - cpu.params[k]).abs().max()
                    / cpu.params[k].abs().max()) for k in cpu.params)
    check(rel <= 1e-4, f"{name}: params off the CPU run by {rel} x max|p|")
    steps = None
    if isinstance(dev.state.opt_state, dict) and "t" in dev.state.opt_state:
        steps = int(dev.state.opt_state["t"])
        check(steps == int(cpu.state.opt_state["t"]) == rounds,
              f"{name}: server optimizer step count {steps}, expected "
              f"{rounds}")
    if device != "cpu":
        check(launches == rounds, f"{name}: {launches} fedagg launches in "
              f"{rounds} rounds")
    backlog = [c[3].tolist() for c in rec_cpu["cohort"]]
    return dict(seconds=secs, launches=launches, included=dev.included,
                global_loss_rtol_vs_cpu=loss_rel, params_rel_err_vs_cpu=rel,
                server_steps=steps, masks=len(rec_cpu["part"]),
                cohort_backlog_in=backlog)


def slice_a_selection(check: Check, device="cuda"):
    """The selection layer on the card against the CPU: paper Fig. 5 cut
    to FIG5_ROUNDS rounds and FIG5_SAMPLES samples a client (the FMNIST
    stand-in, ``logreg``, C = 60, 18 priority, participation 0.3, E = 5)
    on both backends; then the
    shortened quickstart (C = 8, E = 2, 6 rounds) under a training cohort
    that overflows with a backlog boost, once with each of momentum, adam
    and yogi, and under topk_align, welfare, grad_sim and grad_sim on
    CountSketches (``run_pair``'s checks)."""
    import torch
    from repro_torch.data.shards import make_benchmark_federation
    from repro_torch.data.synth import make_synth_federation
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    out = {}
    init_fn, apply_fn = SMALL_MODELS["logreg"]
    fmnist = make_benchmark_federation("fmnist", seed=0, n_priority=18,
                                       samples_per_client=FIG5_SAMPLES)
    for backend in ("vmap_spatial", "scan_temporal"):
        name = f"slice (a) fig5 {backend}"
        row = run_pair(check, name, make_loss_fn(apply_fn), init_fn(0, "cpu"),
                       fig5_config(backend), fmnist, device, FIG5_ROUNDS)
        check(row["masks"] == FIG5_ROUNDS, f"{name}: {row['masks']} masks")
        out[f"fig5/{backend}"] = row
        print(f"{name}:", json.dumps(row), flush=True)
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    small = make_synth_federation(seed=0, n_priority=4, n_nonpriority=4,
                                  samples_per_client=40, test_samples=200)
    gen = torch.Generator().manual_seed(42)
    p0 = {"b": 0.05 * torch.randn(10, generator=gen),
          "w": 0.05 * torch.randn(60, 10, generator=gen)}
    for label, backend, knobs in SELECTION_RUNS:
        name = f"slice (a) {label} {backend}"
        fed = parity_config().replace(backend=backend, **knobs)
        row = run_pair(check, name, loss_fn, p0, fed, small, device,
                       fed.rounds)
        if fed.max_cohort:
            check(any(max(b) > 0 for b in row["cohort_backlog_in"]),
                  f"{name}: the cohort never overflowed")
        out[f"{label}/{backend}"] = row
        print(f"{name}:", json.dumps(row), flush=True)
    return out


def slice_c(check: Check, fedn, device="cuda", rounds=2):
    """Config (c): the full-width cnn on the CIFAR stand-in (cell (b)'s
    federation and model) under median + int8 + error feedback (c1),
    trimmed_mean + sketch without it (c2: sketch with error feedback
    diverges by design) and dp + topk + error feedback (c3); each a 1-round
    warm-up run, then ``rounds`` timed rounds, one fedagg launch a round."""
    import numpy as np
    import torch
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS["cnn"]
    loss_fn = make_loss_fn(apply_fn)
    p0 = init_fn(0, device)
    out = {}
    for label, knobs in SLICE_C.items():
        run_federation(loss_fn, p0, cifar_config(1).replace(**knobs), fedn,
                       device=device)
        fed = cifar_config(rounds).replace(**knobs)
        variant = (fed.aggregator, fed.wire_codec)
        before, before_v = fk.fedagg.launches, fk.fedagg.variant_launches[variant]
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = run_federation(loss_fn, p0, fed, fedn, eval_every=1, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = fk.fedagg.launches - before
        launches_v = fk.fedagg.variant_launches[variant] - before_v
        finite = (np.all(np.isfinite(h.global_loss))
                  and np.all(np.isfinite(h.test_acc))
                  and all(bool(torch.isfinite(v).all())
                          for v in h.params.values()))
        check(bool(finite), f"slice ({label}): non-finite loss, accuracy or "
              "params")
        check(np.array(h.gates).shape == (rounds, fedn.x.shape[0]),
              f"slice ({label}): gates of the wrong shape")
        if fed.aggregator == "dp":
            check(h.dp_epsilon is not None and np.isfinite(h.dp_epsilon),
                  f"slice ({label}): no finite dp epsilon")
        if fed.error_feedback:
            ef = h.state.ef_accum
            check(isinstance(ef, dict) and all(bool(torch.isfinite(v).all())
                                               for v in ef.values()),
                  f"slice ({label}): error-feedback rows missing or "
                  "non-finite")
        if device != "cpu":
            check(launches == rounds and launches_v == rounds,
                  f"slice ({label}): {launches} fedagg launches ({launches_v} "
                  f"of {variant}) in {rounds} rounds")
        out[label] = dict(aggregator=fed.aggregator, wire_codec=fed.wire_codec,
                          error_feedback=fed.error_feedback,
                          seconds_per_round=secs / rounds, launches=launches,
                          included_nonpriority=h.included,
                          global_loss=h.global_loss, test_acc=h.test_acc,
                          dp_epsilon=h.dp_epsilon)
        if device != "cpu":
            out[label]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"slice ({label}):", json.dumps(out[label]), flush=True)
    return out


# ------------------------------------------------------- LM kernels (K5, K7, K9)
H100_BF16_FLOPS = 989e12          # dense bf16 tensor-core rate
LM_TOL = 2e-5                     # x max|v| (attention) or |out| (rmsnorm):
                                  # f32 sums in another order; the reference's
                                  # own f32 kernel tolerance (tests/test_kernels.py)

# (label, B, Sq, Skv, H, KV, hd, causal, window): causal and not, windowed,
# Sq < Skv, ragged lengths, G in {1, 3, 4, 8}, hd in {32, 64, 96, 128}, and
# the slices' prefill shapes (qwen1.5-0.5b at B 8 x 512, qwen2.5-3b at 4 x
# 1024; granite-moe at G 3, deepseek-moe, and minicpm3's MLA at hd 96 =
# nope 64 + rope 32 with v zero past its 64 columns, as MLA pads it)
FLASH_CASES = [
    ("mha_hd32", 2, 128, 128, 8, 8, 32, True, 0),
    ("gqa4_ragged_hd64", 2, 100, 100, 8, 2, 64, True, 0),
    ("gqa8_hd128", 1, 77, 77, 16, 2, 128, True, 0),
    ("hd96", 2, 64, 64, 4, 4, 96, True, 0),
    ("sq_lt_skv", 2, 37, 150, 8, 2, 64, True, 0),
    ("noncausal_sq_lt_skv", 1, 50, 90, 4, 1, 32, False, 0),
    ("window48", 2, 200, 200, 8, 2, 64, True, 48),
    ("window16_noncausal", 1, 64, 64, 4, 4, 32, False, 16),
    ("window8_sq_lt_skv", 2, 13, 45, 8, 8, 32, True, 8),
    ("qwen1.5_prefill", 8, 512, 512, 16, 16, 64, True, 0),
    ("qwen2.5_prefill", 4, 1024, 1024, 16, 2, 128, True, 0),
    # the tensor-core tiling's edges: one query, tiles cut by 129 / 191
    # rows at hd 96, a long sequence at G 8 and hd 128
    ("s1", 2, 1, 1, 8, 2, 64, True, 0),
    ("tile_edges_hd96", 1, 129, 191, 8, 2, 96, True, 0),
    ("long_g8_hd128", 1, 2048, 2048, 32, 4, 128, True, 0),
    ("granite_prefill", 8, 512, 512, 24, 8, 64, True, 0),
    ("deepseek_prefill", 4, 1024, 1024, 16, 16, 128, True, 0),
    ("minicpm3_prefill", 4, 1024, 1024, 40, 40, 96, True, 0),
    # G 7 (llava-next-34b: 56 query heads over 8 kv heads): a ragged small
    # case, and llava's prefill of 576 image rows + 512 tokens (1088 is no
    # multiple of the 128-key tile)
    ("g7_ragged_hd128", 2, 75, 75, 14, 2, 128, True, 0),
    ("llava_prefill", 2, 1088, 1088, 56, 8, 128, True, 0),
    # whisper-medium: the encoder non-causal over 1500 frames (no multiple
    # of the 128-key tile: every query tile runs all 12 key tiles, the last
    # cut at 92 rows) and the decoder's causal prefill of 32 tokens
    ("whisper_encoder", 8, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper_prefill", 8, 32, 32, 16, 16, 64, True, 0),
]
# the cases whose v (and dO) carry zeros in their last columns: MLA pads v
# from v_head_dim to nope + rope, and its output's padded columns take no
# gradient
V_ZERO_COLS = {"minicpm3_prefill": 32}
# (label, B, Skv, H, KV, hd, [kv_len, ...]): kv_len in {1, mid, Skv}, ragged
# Skv, G in {1, 3, 4, 8}, the slices' decode shapes (qwen1.5-0.5b,
# qwen2.5-3b, jamba-1.5-large, granite-moe at G 3: its head group padded
# to 4, the padding masked; deepseek-moe); "strided" reads one layer of a
# stacked
# [P, B, Skv, KV, hd] cache
DECODE_CASES = [
    ("qwen1.5_decode", 8, 544, 16, 16, 64, (1, 271, 544)),
    ("qwen2.5_decode", 4, 1040, 16, 2, 128, (1, 519, 1040)),
    ("jamba_decode", 2, 1040, 64, 8, 128, (1, 519, 1040)),
    ("ragged_hd32_g4", 2, 77, 8, 2, 32, (1, 40, 77)),
    ("g8_hd96", 3, 100, 8, 1, 96, (1, 33, 100)),
    ("strided", 2, 300, 8, 2, 64, (1, 150, 300)),
    ("granite_decode", 8, 544, 24, 8, 64, (1, 271, 544)),
    ("deepseek_decode", 4, 1040, 16, 16, 128, (1, 519, 1040)),
    # llava at G 7: the head group padded to 8, one row masked
    ("llava_decode", 2, 1104, 56, 8, 128, (1, 552, 1104)),
    # whisper-medium's decoder self-attention: G 1, 32 + 224 positions
    ("whisper_decode", 8, 256, 16, 16, 64, (1, 128, 256)),
]
# (label, rows, D, scale dtype): ragged rows, the zoo's widths (jamba's
# 8192 with its bf16 scale, at ragged prefill rows and a decode step's 2;
# granite's 1536, minicpm3's 2560 and its MLA q_norm's 768), a width
# without 16-byte rows
RMSNORM_CASES = [
    ("d256", 37, 256, "float32"), ("d1024_decode", 8, 1024, "float32"),
    ("d1024_prefill", 4096, 1024, "float32"), ("d2048", 4099, 2048, "float32"),
    ("d3072", 7, 3072, "float32"), ("d100_scalar", 5, 100, "float32"),
    ("d8192", 77, 8192, "bfloat16"), ("d8192_decode", 2, 8192, "bfloat16"),
    ("d1536", 4096, 1536, "float32"), ("d2560", 4096, 2560, "float32"),
    ("d768_qnorm", 4096, 768, "float32"),
    # llava's 7168 with its bf16 scale (norm1, norm2, img_norm, the final
    # norm) at its prefill's 2 x 1088 rows and a decode step's 2; xlstm's
    # 768 at its f32 scale, a decode step's 4 rows (its prefill's are
    # d768_qnorm's shape)
    ("d7168", 2176, 7168, "bfloat16"), ("d7168_decode", 2, 7168, "bfloat16"),
    ("d768_decode", 4, 768, "float32"),
]


def lm_inputs(shape, dtype, device, seed):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(dtype).to(device)


def flash_inputs(i, case, dtype, device):
    """q, k, v of FLASH_CASES[i], v's last V_ZERO_COLS columns zero."""
    label, B, Sq, Skv, H, KV, hd = case[:7]
    q = lm_inputs((B, Sq, H, hd), dtype, device, 3 * i)
    k = lm_inputs((B, Skv, KV, hd), dtype, device, 3 * i + 1)
    v = lm_inputs((B, Skv, KV, hd), dtype, device, 3 * i + 2)
    if label in V_ZERO_COLS:
        v[..., hd - V_ZERO_COLS[label]:] = 0
    return q, k, v


def attn_close(out, want, v, dtype):
    """(ok, max_abs_err): f32 within LM_TOL * max|v|; a bf16 output within
    one bf16 ulp of the plain result plus that (both round an f32 sum)."""
    import torch
    o, p = out.float(), want.float()
    err = float(torch.max(torch.abs(o - p)))
    tol = LM_TOL * float(torch.max(torch.abs(v.float())))
    if not bool(torch.isfinite(o).all()):
        return False, float("inf")
    if dtype == torch.float32:
        return err <= tol, err
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(torch.abs(p), min=2.0 ** -126))) - 7)
    return bool(torch.all(torch.abs(o - p) <= ulp + tol)), err


GRAPH_DECODE = ("qwen2.5_decode", "jamba_decode", "ragged_hd32_g4",
                "granite_decode", "llava_decode")


def graph_replays_match(fn, eager) -> bool:
    """``fn`` captured in a CUDA graph and replayed twice gives ``eager``'s
    output bit for bit both times (K7's splits merge inside one launch of
    a thread-block cluster: nothing may carry over between calls)."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(first, eager)) and bool(torch.equal(out, eager))


def lm_kernel_phase(check: Check, device="cuda"):
    """K5, K7 and K9 against their plain versions on the card, every case
    in f32 and bf16. Returns the worst error per kernel."""
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    worst = {"flash_attention": 0.0, "decode_attention": 0.0, "rmsnorm": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, case in enumerate(FLASH_CASES):
            label, B, Sq, Skv, H, KV, hd, causal, window = case
            q, k, v = flash_inputs(i, case, dtype, device)
            before = fk.flash_attention_fwd.launches
            out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window)
            check(fk.flash_attention_fwd.launches == before + 1,
                  f"flash_attention {label}/{dn}: not one launch")
            want, want_lse = fk.flash_attention_plain(q, k, v, causal=causal,
                                                      window=window, block_kv=64)
            ok, err = attn_close(out, want, v, dtype)
            lse_err = float(torch.max(torch.abs(lse - want_lse)))
            lse_tol = LM_TOL * max(1.0, float(torch.max(torch.abs(want_lse))))
            check(ok, f"flash_attention {label}/{dn}: max_abs_err {err}")
            check(lse_err <= lse_tol, f"flash_attention {label}/{dn}: lse err "
                  f"{lse_err} > {lse_tol}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
        for i, (label, B, Skv, H, KV, hd, lens) in enumerate(DECODE_CASES):
            q = lm_inputs((B, 1, H, hd), dtype, device, 100 + 3 * i)
            if label == "strided":
                kc = lm_inputs((3, B, Skv, KV, hd), dtype, device, 101 + 3 * i)[1]
                vc = lm_inputs((3, B, Skv, KV, hd), dtype, device, 102 + 3 * i)[1]
            else:
                kc = lm_inputs((B, Skv, KV, hd), dtype, device, 101 + 3 * i)
                vc = lm_inputs((B, Skv, KV, hd), dtype, device, 102 + 3 * i)
            for kv_len in lens:
                before = dk.decode_attention.launches
                out = dk.decode_attention(q, kc, vc, kv_len=kv_len)
                check(dk.decode_attention.launches == before + 1,
                      f"decode_attention {label}: not one launch")
                want = dk.decode_attention_plain(q, kc, vc, kv_len=kv_len)
                ok, err = attn_close(out, want, vc[:, :kv_len], dtype)
                check(ok, f"decode_attention {label}/kv_len {kv_len}/{dn}: "
                      f"max_abs_err {err}")
                worst["decode_attention"] = max(worst["decode_attention"], err)
                if label in GRAPH_DECODE and kv_len != 1 and device != "cpu":
                    same = graph_replays_match(
                        lambda: dk.decode_attention(q, kc, vc, kv_len=kv_len), out)
                    check(same, f"decode_attention {label}/kv_len {kv_len}/{dn}: "
                          f"a replayed CUDA graph differs from the eager call")
        for i, (label, R, D, sdt) in enumerate(RMSNORM_CASES):
            x = lm_inputs((R, D), dtype, device, 200 + i)
            scale = (1.0 + 0.1 * lm_inputs((D,), torch.float32, device, 300 + i)
                     ).to(getattr(torch, sdt))
            before = rk.rmsnorm_fwd.launches
            out = rk.rmsnorm_fwd(x, scale)
            check(rk.rmsnorm_fwd.launches == before + 1, f"rmsnorm {label}: not one launch")
            want = rk.rmsnorm_plain(x, scale)
            # the sum of D squares in another f32 order moves the norm by at
            # most D/2 * 2^-24 relative (worst case), rsqrt and the products a
            # few ulp more; a bf16 output adds one bf16 ulp (both round once)
            o, p = out.float(), want.float()
            err = float(torch.max(torch.abs(o - p)))
            bound = (D / 2 + 4) * 2.0 ** -24 * torch.abs(p)
            if dtype == torch.bfloat16:
                bound = bound + torch.exp2(torch.floor(torch.log2(
                    torch.clamp(torch.abs(p), min=2.0 ** -126))) - 7)
            check(bool(torch.all(torch.abs(o - p) <= bound + 1e-30)),
                  f"rmsnorm {label}/{dn}: max_abs_err {err}")
            worst["rmsnorm"] = max(worst["rmsnorm"], err)
    torch.cuda.synchronize()
    print("LM kernel phase:", json.dumps(worst), flush=True)
    return worst


def graph_ms(fn, calls=20, reps=5, stream=None) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph
    (on ``stream``, default the capture's own), replayed ``reps`` times
    between two events. Unlike time_ms, the host's cost per call (Python,
    the ctypes launch) is not in it: a decode-size kernel takes less device
    time than its launch takes on the host."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


COLD_BYTES = 100e6                # input bytes a cold timing rotates over: more
                                  # than the H100's 50 MB L2, so each call reads
                                  # device memory, as in a decode step, where the
                                  # weights read between two layers evict the cache


def graph_each_ms(fns, reps=3) -> float:
    """Device time of one call when each of ``fns`` is captured once, in
    order, in one CUDA graph, replayed ``reps`` times: with ``fns`` on
    distinct input copies, the calls find their inputs cold."""
    import torch
    for fn in fns[:2]:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(fns) * reps)


def lm_row(fn, plain, library, bytes_, flops, peak_flops, cold=None, floor=None):
    """ms, plain_ms and library_ms as device time (graph_ms, warm: the same
    inputs every call), the kernel's eager time with its host cost
    (time_ms), the bound, and the kernel's rate in TFLOP/s (the function's
    flops over ms). ``cold``: (inputs, kernel, library, copies), the
    kernel and the library call timed over ``copies`` clones of ``inputs``
    in turn (ms_cold, library_ms_cold; graph_each_ms). ``floor``: an empty
    kernel of the kernel's launch shape (floor_ms)."""
    import torch
    t_b, t_o = bytes_ / H100_BYTES_PER_S, flops / peak_flops
    ms = graph_ms(fn)
    row = dict(ms=ms, eager_ms=time_ms(fn),
               plain_ms=graph_ms(plain, calls=3, reps=3),
               library_ms=graph_ms(library), bound_ms=1e3 * max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               tflops=flops / (ms * 1e9))
    if cold is not None:
        inputs, kernel, lib_call, n = cold
        copies = [tuple(t.clone() for t in inputs) for _ in range(n)]
        row["ms_cold"] = graph_each_ms([lambda c=c: kernel(*c) for c in copies])
        row["library_ms_cold"] = graph_each_ms([lambda c=c: lib_call(*c) for c in copies])
        row["cold_copies"] = n
        del copies
        torch.cuda.empty_cache()
    if floor is not None:
        row["floor_ms"] = graph_ms(floor)
    return row


def cold_copies(nbytes) -> int:
    return max(2, -(-int(COLD_BYTES) // int(nbytes)))


# K5, K7 and K9 at every shape the serving paths give them: (label, B, S,
# H, KV, hd), (label, B, Skv, H, KV, hd) and (label, rows, D, scale dtype);
# K5 causal but at the labels of NONCAUSAL (whisper's encoder)
PREFILL_TIMING = (("qwen1.5_prefill", 8, 512, 16, 16, 64),
                  ("qwen2.5_prefill", 4, 1024, 16, 2, 128),
                  ("granite_prefill", 8, 512, 24, 8, 64),
                  ("deepseek_prefill", 4, 1024, 16, 16, 128),
                  ("minicpm3_prefill", 4, 1024, 40, 40, 96),
                  ("llava_prefill", 2, 1088, 56, 8, 128),
                  ("whisper_encoder", 8, 1500, 16, 16, 64))
NONCAUSAL = ("whisper_encoder", "whisper_encoder_train")
DECODE_TIMING = (("qwen1.5_decode", 8, 544, 16, 16, 64),
                 ("qwen2.5_decode", 4, 1040, 16, 2, 128),
                 ("jamba_decode", 2, 1040, 64, 8, 128),
                 ("granite_decode", 8, 544, 24, 8, 64),
                 ("deepseek_decode", 4, 1040, 16, 16, 128),
                 ("llava_decode", 2, 1104, 56, 8, 128),
                 ("whisper_decode", 8, 256, 16, 16, 64))
NORM_TIMING = (("qwen1.5_prefill_norm", 4096, 1024, "float32"),
               ("qwen1.5_decode_norm", 8, 1024, "float32"),
               ("qwen2.5_prefill_norm", 4096, 2048, "float32"),
               ("qwen2.5_decode_norm", 4, 2048, "float32"),
               ("jamba_prefill_norm", 2048, 8192, "bfloat16"),
               ("jamba_decode_norm", 2, 8192, "bfloat16"),
               ("granite_prefill_norm", 4096, 1536, "float32"),
               ("minicpm3_prefill_norm", 4096, 2560, "float32"),
               ("minicpm3_prefill_qnorm", 4096, 768, "float32"),
               ("llava_prefill_norm", 2176, 7168, "bfloat16"),
               ("llava_decode_norm", 2, 7168, "bfloat16"),
               ("xlstm_prefill_norm", 4096, 768, "float32"),
               ("xlstm_decode_norm", 4, 768, "float32"))


def lm_timing_phase(device="cuda"):
    """Each LM kernel at the slices' shapes (bf16): K5 at the prefill of
    PREFILL_TIMING, K7 at the last decode step of DECODE_TIMING, K9 at the
    rows of NORM_TIMING; beside its plain version, its bound and one
    PyTorch call of the same function timed here only
    (scaled_dot_product_attention; rms_norm). Device times from CUDA-graph replay; the kernel's eager time
    beside them. K7 and K9 also cold (inputs rotated over COLD_BYTES), with
    the library call cold too, and beside the launch floor (an empty kernel
    of the same launch shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    bf16 = torch.bfloat16
    rows = {}
    for label, B, S, H, KV, hd in PREFILL_TIMING:
        q = lm_inputs((B, S, H, hd), bf16, device, 1)
        k = lm_inputs((B, S, KV, hd), bf16, device, 2)
        v = lm_inputs((B, S, KV, hd), bf16, device, 3)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        causal = label not in NONCAUSAL
        # visible (query, key) pairs
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
        bytes_ = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd) + 4 * B * H * S
        rows[label] = lm_row(
            lambda: fk.flash_attention_fwd(q, k, v, causal=causal),
            lambda: fk.flash_attention_plain(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=KV != H),
            bytes_, 4.0 * hd * pairs, H100_BF16_FLOPS)
    floor_k7 = getattr(dk, "decode_attention_floor", None)
    for label, B, Skv, H, KV, hd in DECODE_TIMING:
        q = lm_inputs((B, 1, H, hd), bf16, device, 4)
        kc = lm_inputs((B, Skv, KV, hd), bf16, device, 5)
        vc = lm_inputs((B, Skv, KV, hd), bf16, device, 6)

        def kernel(q, kc, vc, Skv=Skv):
            return dk.decode_attention(q, kc, vc, kv_len=Skv)

        def library(q, kc, vc, gqa=KV != H):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                enable_gqa=gqa)
        bytes_ = 2 * (2 * B * H * hd + 2 * B * Skv * KV * hd)
        rows[label] = lm_row(
            lambda: kernel(q, kc, vc),
            lambda: dk.decode_attention_plain(q, kc, vc, kv_len=Skv),
            lambda: library(q, kc, vc),
            bytes_, 4.0 * B * H * Skv * hd, H100_BF16_FLOPS,
            cold=((q, kc, vc), kernel, library, cold_copies(bytes_)),
            floor=floor_k7 and (lambda: floor_k7(q, kc, vc, kv_len=Skv)))
    floor_k9 = getattr(rk, "rmsnorm_floor", None)
    for label, R, D, sdt in NORM_TIMING:
        x = lm_inputs((R, D), bf16, device, 7)
        scale = torch.ones(D, device=device, dtype=getattr(torch, sdt))
        sb = scale.to(bf16)                         # rms_norm takes x's dtype

        def kernel(x, scale, sb):
            return rk.rmsnorm_fwd(x, scale)

        def library(x, scale, sb, D=D):
            return F.rms_norm(x, (D,), sb, eps=1e-6)
        bytes_ = 2 * 2 * R * D + D * scale.element_size()
        rows[label] = lm_row(
            lambda: kernel(x, scale, sb), lambda: rk.rmsnorm_plain(x, scale),
            lambda: library(x, scale, sb), bytes_, 4.0 * R * D, H100_F32_FLOPS,
            cold=((x, scale, sb), kernel, library,
                  cold_copies(2 * R * D + D * scale.element_size())),
            floor=floor_k9 and (lambda: floor_k9(x, scale)))
    for label, row in rows.items():
        print("LM timing:", label, json.dumps(row), flush=True)
    return rows


# ------------------------------------------------------------- LM slices (d, e)
LM_KERNELS = ("flash_attention", "decode_attention", "rmsnorm", "ssm_scan")
SHAPE_KEYS = ("ms", "ms_cold", "eager_ms", "plain_ms", "library_ms",
              "library_ms_cold", "floor_ms", "bound_ms", "bound_by")


def lm_counts():
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssm_scan as sk
    return {"flash_attention": fk.flash_attention_fwd.launches,
            "decode_attention": dk.decode_attention.launches,
            "rmsnorm": rk.rmsnorm_fwd.launches, "ssm_scan": sk.ssm_scan.launches}


def reset_lm_counts():
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssm_scan as sk
    fk.flash_attention_fwd.launches = 0
    dk.decode_attention.launches = 0
    rk.rmsnorm_fwd.launches = 0
    sk.ssm_scan.launches = 0


def layer_kinds(cfg, pre=True):
    """Every layer's kind, over all periods and, with ``pre``, the leading
    dense blocks (deepseek-moe's layer 0, whose mixer is the first
    layer's)."""
    kinds = cfg.layer_kinds() * cfg.n_periods
    if pre:
        kinds += [{"mixer": cfg.layer_kinds()[0]["mixer"], "ffn": "dense"}] * cfg.first_dense
    return kinds


def mixer_counts(cfg, pre=True):
    """(attention layers, Mamba layers) of a config (``layer_kinds``)."""
    mixers = [k["mixer"] for k in layer_kinds(cfg, pre)]
    return mixers.count("attn"), mixers.count("mamba")


def norm_count(cfg, pre=True, images=False):
    """RMSNorm launches of one forward over the layers (norm1, norm2 where
    the layer has an FFN: xlstm's blocks have none; two more an MLA
    attention layer: q_norm and kv_norm), with ``pre`` the leading blocks'
    and the final norm too, and with ``images`` (and ``pre``) llava's
    img_norm."""
    kinds = layer_kinds(cfg, pre)
    A = mixer_counts(cfg, pre)[0]
    return (len(kinds) + sum(k["ffn"] != "none" for k in kinds)
            + (2 * A if cfg.mla else 0) + (1 if pre else 0) + (1 if pre and images else 0))


class Expected(dict):
    """The LM launches a run should make. With A attention and M Mamba
    layers of L in all (the dense family: A = L, M = 0; jamba: A = 1 and
    M = 7 a period): per full-sequence forward (train or prefill) A
    flash-attention, M selective-scan and 2L + 1 RMSNorm launches (2A more
    under MLA); per decode step A decode-attention (none under MLA, whose
    absorbed decode is plain torch) and the same RMSNorm launches (a
    Mamba decode step is plain torch). ``images``: the forwards carry
    llava's image rows (one img_norm launch more each)."""

    def __init__(self):
        super().__init__({k: 0 for k in LM_KERNELS})

    def add(self, cfg, forwards=0, steps=0, images=False):
        A, M = mixer_counts(cfg)
        self["flash_attention"] += A * forwards
        self["ssm_scan"] += M * forwards
        self["decode_attention"] += 0 if cfg.mla else A * steps
        self["rmsnorm"] += (norm_count(cfg, images=images) * forwards
                            + norm_count(cfg) * steps)

    def add_encdec(self, cfg, forwards=0, steps=0, encodes=0):
        """whisper: a full forward (prefill, or encode + the train-mode
        decoder) runs K5 in each encoder and each decoder layer, an encode
        alone in each encoder layer, a decode step K7 in each decoder
        layer; its LayerNorms are plain torch (no K9)."""
        E, D = cfg.encoder_layers, cfg.num_layers
        self["flash_attention"] += (E + D) * forwards + E * encodes
        self["decode_attention"] += D * steps


def logits_trace(model, params, prompt, max_new, image_embeds=None,
                 frames=None):
    """generate's calls one by one (prefill, pad_caches, decode_step), the
    logits of each kept on the host: [prefill, step 0, ...]. With
    ``image_embeds`` [B, n_img, d] (llava) the prefill carries them first
    and the decode positions count them (n_img + S + i), as the model's
    API allows and the text-only ``generate`` does not; with ``frames``
    [B, T, d] (whisper) the prefill encodes them."""
    import torch
    from repro_torch.launch.serve import pad_caches
    B, S = prompt.shape
    batch, n_img = {"tokens": prompt}, 0
    if image_embeds is not None:
        batch["image_embeds"], n_img = image_embeds, image_embeds.shape[1]
    if frames is not None:
        batch["frames"] = frames
    caches, logits = model.prefill(params, batch)
    caches = pad_caches(model, caches, B, n_img + S + max_new)
    out = [logits.float().cpu()]
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(max_new):
        logits, caches = model.decode_step(params, caches, tok, n_img + S + i)
        out.append(logits.float().cpu())
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    return out


SERVE_ATOL, SERVE_RTOL = 5e-4, 5e-3   # tests/test_serve.py's bound
# smoke-size logits of two f32 runs of the same model (card vs CPU): about
# ten chained f32 products of K <= 512 terms, each off by ~sqrt(K) 2^-24
# relative in another summation order (~1.3e-5 in all), on logits of
# magnitude ~1
PARITY_ATOL = 2e-5


def decision_gap(trace):
    """The smallest top-1 / top-2 gap over the logits generate turns into
    tokens (all but the last step's)."""
    import torch
    gaps = []
    for logits in trace[:-1]:
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append(float(torch.min(top[..., 0] - top[..., 1])))
    return min(gaps)


def scheduler_vs_generate(check: Check, expected: Expected, model, p_cpu,
                          p_dev, name, device="cuda", tol=PARITY_ATOL):
    """A BatchScheduler on the card (2 slots, 4 prompts of 5-9 tokens, 6
    new each) against generate on the card for each prompt alone, after
    checking every decision of the CPU's generate is resolved (top-2 gap
    over 2 tol)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.serving import BatchScheduler, Request
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 9, 7)]
    sched = BatchScheduler(model, p_dev, batch_slots=2, max_len=32, device=device)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = {r.rid: r for r in sched.run()}
    expected.add(cfg, steps=sched.ticks)
    same, gap = True, float("inf")
    for i, p in enumerate(prompts):
        tp = torch.as_tensor(p)[None]
        gap = min(gap, decision_gap(logits_trace(model, p_cpu, tp, 6)))
        want = generate(model, p_dev, tp, 6, device=device)
        expected.add(cfg, forwards=1, steps=6)
        same &= bool(np.array_equal(np.asarray(done[i].out_tokens),
                                    want[0, len(p):].cpu().numpy()))
    check(gap > 2 * tol, f"{name} scheduler: top-2 gap {gap} "
          "too small to compare tokens exactly")
    check(same, f"{name}: scheduler tokens differ from generate's")
    return dict(scheduler_ticks=sched.ticks, scheduler_equal=same,
                scheduler_top2_gap=gap)


def slice_d(check: Check, expected: Expected, device="cuda"):
    """Smoke-size parity on the card against the same port code on the
    CPU: qwen1.5-0.5b and qwen2.5-3b smoke configs (f32), and qwen1.5-0.5b
    with sliding_window 8 and a 13-token prompt (prefill past the window,
    the ring roll). Prefill and every decode step's logits within
    PARITY_ATOL of the CPU run; greedy tokens equal, after asserting that
    every token decision's top-1 / top-2 gap on the CPU exceeds twice that;
    the scheduler's tokens (teacher-forced through decode steps) equal
    generate's (prefill, then decode), guarded the same way."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model
    out = {}
    runs = [("qwen1.5-0.5b", {}, 2, 12, 6), ("qwen2.5-3b", {}, 2, 12, 6),
            ("qwen1.5-0.5b", dict(sliding_window=8), 1, 13, 4)]
    for arch, knobs, B, S, new in runs:
        cfg = get_smoke(arch).replace(**knobs)
        model = get_model(cfg)
        name = f"slice (d) {arch}" + (" window 8" if knobs else "")
        p_cpu = model.init(prng.PRNGKey(0), device="cpu")
        p_dev = model.init(prng.PRNGKey(0), device=device)
        prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size)
        cpu = logits_trace(model, p_cpu, prompt, new)
        dev = logits_trace(model, p_dev, prompt.to(device), new)
        expected.add(cfg, forwards=1, steps=new)
        err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(dev, cpu))
        check(err <= PARITY_ATOL, f"{name}: logits off the CPU run by {err}")
        gap = decision_gap(cpu)
        check(gap > 2 * PARITY_ATOL, f"{name}: top-2 gap {gap} too small to "
              "compare tokens exactly")
        t_cpu = generate(model, p_cpu, prompt, new, device="cpu")
        t_dev = generate(model, p_dev, prompt, new, device=device)
        expected.add(cfg, forwards=1, steps=new)
        same = bool(torch.equal(t_dev.cpu(), t_cpu))
        check(same, f"{name}: greedy tokens differ from the CPU run")
        row = dict(max_logits_err=err, top2_gap=gap, tokens_equal=same)
        if not knobs:
            row.update(scheduler_vs_generate(check, expected, model, p_cpu,
                                             p_dev, name, device))
        out[name] = row
        print(f"{name}:", json.dumps(row), flush=True)
    return out


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def serve_run(check: Check, expected: Expected, cfg, params, B, S, new, label,
              device="cuda"):
    """At full width: one warm-up generate, then prefill and the decode
    steps timed one phase at a time (generate's own calls), then generate
    end to end. Returns prefill s and tokens/s, decode ms/step and
    tokens/s, generate s, and the peak GB."""
    import torch
    from repro_torch import prng
    from repro_torch.launch.serve import generate, pad_caches
    from repro_torch.models import get_model
    model = get_model(cfg)
    prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size).to(device)
    generate(model, params, prompt[:, :64], 2, device=device)       # warm-up
    expected.add(cfg, forwards=1, steps=2)
    torch.cuda.reset_peak_memory_stats()
    (caches, logits), t_pre = sync_time(lambda: model.prefill(params, {"tokens": prompt}))
    caches = pad_caches(model, caches, B, S + new)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)

    def decode():
        nonlocal caches, tok
        for i in range(new):
            lg, caches = model.decode_step(params, caches, tok, S + i)
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        return lg
    last, t_dec = sync_time(decode)
    expected.add(cfg, forwards=1, steps=new)
    toks, t_gen = sync_time(lambda: generate(model, params, prompt, new, device=device))
    expected.add(cfg, forwards=1, steps=new)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ok = (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(last).all())
          and tuple(toks.shape) == (B, S + new)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size)
    check(ok, f"{label}: non-finite logits or tokens out of range")
    row = dict(batch=B, prompt=S, new_tokens=new, prefill_s=t_pre,
               prefill_tokens_per_s=B * S / t_pre, decode_ms_per_step=1e3 * t_dec / new,
               decode_tokens_per_s=B * new / t_dec, generate_s=t_gen, peak_gb=peak)
    print(f"{label}:", json.dumps(row), flush=True)
    return row


def scheduler_run(check: Check, expected: Expected, model, params, label,
                  slots, max_len, n_req, lo, hi, new, device="cuda"):
    """A BatchScheduler of ``slots`` slots over ``n_req`` requests of
    lo-hi prompt tokens, ``new`` new each: every request finished with
    tokens in range; its ticks, seconds and token rates."""
    import numpy as np
    from repro_torch.serving import BatchScheduler, Request
    cfg = model.cfg
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=int(n)).astype(np.int32),
                    max_new_tokens=new)
            for i, n in enumerate(rng.integers(lo, hi + 1, size=n_req))]
    sched = BatchScheduler(model, params, batch_slots=slots, max_len=max_len,
                           device=device)
    for r in reqs:
        sched.submit(r)
    done, secs = sync_time(sched.run)
    expected.add(cfg, steps=sched.ticks)
    n_out = sum(len(r.out_tokens) for r in done)
    ok = (len(done) == n_req and all(len(r.out_tokens) == new for r in done)
          and all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens))
    check(ok, f"{label} scheduler: requests unfinished or tokens out of range")
    fed = sum(len(r.prompt) for r in reqs) + n_out
    row = dict(requests=len(done), ticks=sched.ticks, seconds=secs,
               ms_per_tick=1e3 * secs / sched.ticks,
               generated_tokens_per_s=n_out / secs,
               fed_and_generated_tokens_per_s=fed / secs)
    print(f"{label} scheduler:", json.dumps(row), flush=True)
    return row


def teacher_forced_check(check: Check, expected: Expected, cfg, params,
                         label, device="cuda", B=2, S=64, S2=72, images=False):
    """A full-width model in f32 (params shared with the bf16 runs):
    prefill's last logits and each decode step's logits against
    forward(mode="train") logits on the same tokens, within
    tests/test_serve.py's atol 5e-4 + rtol 5e-3. Both sides are f32 on the
    card and differ only in summation order (K5 over the whole sequence vs
    K7 over the cache, K8 vs the plain decode step, and the product
    shapes); over 24 layers that is of order 24 x 2^-24 x sqrt(d_ff) ~
    1e-4 relative, below the bound. This holds K7 against the K5 path, and
    the prefill -> decode handoff (the conv tail and K8's final state), at
    full width. With ``images`` (llava) both sides carry n_img image rows
    first (``image_rows``) and the decode positions count them."""
    import torch
    from repro_torch import prng
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import get_model
    from repro_torch.models import transformer as T
    cfg = cfg.replace(compute_dtype="float32")
    model = get_model(cfg)
    toks = prng.randint(prng.PRNGKey(2), (B, S2), 0, cfg.vocab_size).to(device)
    img = image_rows(cfg, B, device, seed=3) if images else None
    n_img = img.shape[1] if images else 0
    hidden, _, _ = T.forward(params, toks, cfg, mode="train", image_embeds=img)
    expected.add(cfg, forwards=1, images=images)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    ref = hidden[:, n_img:].float() @ w.float()
    del hidden
    batch = {"tokens": toks[:, :S]}
    if images:
        batch["image_embeds"] = img
    caches, logits = model.prefill(params, batch)
    caches = pad_caches(model, caches, B, n_img + S2)
    got = [(S - 1, logits)]
    for t in range(S, S2):
        logits, caches = model.decode_step(params, caches, toks[:, t:t + 1],
                                           n_img + t)
        got.append((t, logits))
    expected.add(cfg, forwards=1, steps=S2 - S, images=images)
    errs = [float(torch.max(torch.abs(lg - ref[:, t]))) for t, lg in got]
    ok = all(bool(torch.all(torch.abs(lg - ref[:, t])
                            <= SERVE_ATOL + SERVE_RTOL * torch.abs(ref[:, t])))
             for t, lg in got)
    check(ok, f"{label} f32 teacher-forced: logits off by {max(errs)}")
    row = dict(max_abs_err=max(errs), logits_max=float(ref.abs().max()),
               steps=len(got))
    print(f"{label} f32 teacher-forced:", json.dumps(row), flush=True)
    return row


def slice_e(check: Check, expected: Expected, device="cuda"):
    """Full width, random init from PRNGKey(0) drawn on the card:
    qwen1.5-0.5b at its own dtypes (f32 params, bf16 compute) through
    generate (B 8, prompt 512, 32 new) and a BatchScheduler (8 slots,
    max_len 320, 16 requests of 16-256 prompt tokens, 32 new each), the
    f32 teacher-forced check, then qwen2.5-3b through generate (B 4,
    prompt 1024, 16 new)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils import param_count
    out = {}
    cfg = get_config("qwen1.5-0.5b")
    model = get_model(cfg)
    params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
    out["qwen1.5-0.5b"] = dict(params=param_count(params), init_s=t_init)
    out["qwen1.5-0.5b"]["generate"] = serve_run(check, expected, cfg, params,
                                                8, 512, 32, "slice (e) qwen1.5-0.5b",
                                                device)
    out["qwen1.5-0.5b"]["scheduler"] = scheduler_run(
        check, expected, model, params, "slice (e) qwen1.5-0.5b", 8, 320, 16,
        16, 256, 32, device)
    out["qwen1.5-0.5b"]["f32_teacher_forced"] = teacher_forced_check(
        check, expected, cfg, params, "slice (e) qwen1.5-0.5b", device)
    del params
    torch.cuda.empty_cache()
    cfg = get_config("qwen2.5-3b")
    model = get_model(cfg)
    params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
    out["qwen2.5-3b"] = dict(params=param_count(params), init_s=t_init)
    out["qwen2.5-3b"]["generate"] = serve_run(check, expected, cfg, params,
                                              4, 1024, 16, "slice (e) qwen2.5-3b",
                                              device)
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- K8 and the jamba slice (g)
# f32: 1e-5 x max(1, max|y|) (or |h|). Kernel and plain version run the
# same f32 recurrence; the kernel contracts products into FMAs and its
# one-instruction ex2 (2 ulp, of an exponent rounded twice) and torch.exp
# differ by a few ulp, once a step, and the state decays (dt A < 0), so those errors do not grow with S. bf16 y: one bf16
# ulp more (both round the same f32 value once).
SSM_TOL = 1e-5
# (Bt, S, Di, N): N in {4, 8, 16}, S a multiple of no tile, Bt 1 and 3, Di
# not a multiple of 128, one step, and a grid of more blocks than SMs with
# S, Di and N ragged; the slice's prefill shapes (the smoke jamba's Di 256;
# full width: 2 x 1024 x 16384) are checked in the timing
SSM_CASES = [(1, 100, 200, 4), (3, 77, 130, 8), (1, 300, 1000, 16),
             (3, 257, 384, 16), (2, 1, 64, 16), (1, 65, 256, 16),
             (2, 77, 16400, 8)]
# the SFU's exponentials: 16 a clock per SM, 132 SMs, at the 1.98 GHz clock
# that gives the data sheet's 67 TFLOP/s f32 (132 x 128 lanes x 2 x clock)
H100_EXP_PER_S = 16 * 132 * 1.98e9


def ssm_inputs(Bt, S, Di, N, dtype, device, seed):
    """x in ``dtype``; dt = 0.1 softplus(normal), A = -exp(0.5 normal), as
    the reference's kernel test draws them; B, C, D normal."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    x = (0.5 * f(Bt, S, Di)).to(dtype)
    dt = 0.1 * F.softplus(f(Bt, S, Di))
    A = -torch.exp(0.5 * f(Di, N))
    return [t.to(device) for t in (x, dt, A, f(Bt, S, N), f(Bt, S, N), f(Di))]


def ssm_close(got, want, dtype):
    """(ok, max_abs_err) of a scan output or state against the plain one."""
    import torch
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return False, float("inf")
    err = torch.abs(g - w)
    bound = SSM_TOL * max(1.0, float(torch.max(torch.abs(w))))
    if dtype == torch.bfloat16:
        bound = bound + torch.exp2(torch.floor(torch.log2(
            torch.clamp(torch.abs(w), min=2.0 ** -126))) - 7)
    return bool(torch.all(err <= bound)), float(torch.max(err))


def ssm_kernel_phase(check: Check, device="cuda"):
    """K8 against ssm_scan_plain on the card, f32 and bf16 x, output and
    final state; an N past the kernel's 16 raises. Returns the worst
    error."""
    import torch
    from repro_torch.kernels import ssm_scan as sk
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, (Bt, S, Di, N) in enumerate(SSM_CASES):
            args = ssm_inputs(Bt, S, Di, N, dtype, device, 400 + i)
            before = sk.ssm_scan.launches
            y, h = sk.ssm_scan(*args, return_state=True)
            check(sk.ssm_scan.launches == before + 1,
                  f"ssm_scan {Bt}x{S}x{Di}x{N}/{dn}: not one launch")
            want, h_want = sk.ssm_scan_plain(*args, return_state=True)
            ok, err = ssm_close(y, want, dtype)
            h_ok, h_err = ssm_close(h, h_want, torch.float32)
            check(ok, f"ssm_scan {Bt}x{S}x{Di}x{N}/{dn}: max_abs_err {err}")
            check(h_ok, f"ssm_scan {Bt}x{S}x{Di}x{N}/{dn}: state err {h_err}")
            worst = max(worst, err)
    x, dt, A, B, C, D = ssm_inputs(1, 8, 64, 17, torch.float32, device, 499)
    try:
        sk.ssm_scan(x, dt, A, B, C, D)
        check(False, "ssm_scan: N = 17 did not raise")
    except ValueError:
        pass
    torch.cuda.synchronize()
    print("K8 kernel phase:", json.dumps({"ssm_scan": worst}), flush=True)
    return worst


# K8's timed shapes: (label, Bt, S, Di, N): jamba-1.5-large's prefill at
# the g2 batch, and one prompt of 1024 tokens through launch/serve.py's
# generate (serve_profile --batch 1)
SSM_TIMING = (("jamba_prefill_scan", 2, 1024, 16384, 16),
              ("jamba_prefill_scan_b1", 1, 1024, 16384, 16))


def ssm_timing_phase(check: Check, device="cuda"):
    """K8 at SSM_TIMING's shapes (x bf16, with the final state, as prefill
    calls it): device time by graph replay beside the plain version's and
    the bound, and checked against the plain version at each shape. No
    single PyTorch call computes a selective scan: library_ms is null.
    Returns {label: row}."""
    import torch
    from repro_torch.kernels import ssm_scan as sk
    rows = {}
    for label, Bt, S, Di, N in SSM_TIMING:
        args = ssm_inputs(Bt, S, Di, N, torch.bfloat16, device, 7)
        y, h = sk.ssm_scan(*args, return_state=True)
        want, h_want = sk.ssm_scan_plain(*args, return_state=True)
        ok, err = ssm_close(y, want, torch.bfloat16)
        h_ok, h_err = ssm_close(h, h_want, torch.float32)
        check(ok and h_ok, f"ssm_scan {label}: max_abs_err {err}, state {h_err}")
        del want, h_want
        elems = Bt * S * Di * N
        bytes_ = (2 + 4 + 2) * Bt * S * Di + 2 * 4 * Bt * S * N + 4 * Di * N \
            + 4 * Di + 4 * Bt * Di * N
        t_b, t_e = bytes_ / H100_BYTES_PER_S, elems / H100_EXP_PER_S
        t_f = 6.0 * elems / H100_F32_FLOPS       # dt a, e h, dx b, acc: 6 flops
        rows[label] = dict(
            ms=graph_ms(lambda: sk.ssm_scan(*args, return_state=True)),
            eager_ms=time_ms(lambda: sk.ssm_scan(*args, return_state=True)),
            plain_ms=graph_ms(lambda: sk.ssm_scan_plain(*args, return_state=True),
                              calls=2, reps=2),
            library_ms=None, bound_ms=1e3 * max(t_b, t_e, t_f),
            bound_by="bytes" if t_b >= max(t_e, t_f) else "operations",
            bytes=bytes_, exps=elems, max_abs_err=err, state_err=h_err)
        print("LM timing:", label, json.dumps(rows[label]), flush=True)
    return rows


def slice_g1(check: Check, expected: Expected, device="cuda"):
    """The smoke jamba (one period: attention + 7 Mamba layers, 4 MoE
    FFNs, d 128, f32) on the card against the same code on the CPU:
    prefill and every decode step's logits and the prefill caches (k, v,
    conv, h) within PARITY_ATOL of the larger magnitude (at least 1);
    greedy tokens equal, after checking every decision's top-2 gap on the
    CPU exceeds twice that; and, at capacity_factor 16 (no token dropped:
    at the config's 1.25 a decode tick's expert capacity couples the
    slots, so a slot's tokens depend on its neighbours'), a
    BatchScheduler's tokens equal generate's."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model
    from repro_torch.utils import tree_leaves
    name = "slice (g1) jamba-1.5-large-398b"
    cfg = get_smoke("jamba-1.5-large-398b")
    model = get_model(cfg)
    p_cpu = model.init(prng.PRNGKey(0), device="cpu")
    p_dev = model.init(prng.PRNGKey(0), device=device)
    B, S, new = 2, 12, 6
    prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size)
    cpu = logits_trace(model, p_cpu, prompt, new)
    dev = logits_trace(model, p_dev, prompt.to(device), new)
    expected.add(cfg, forwards=1, steps=new)
    tol = PARITY_ATOL * max(1.0, max(float(torch.max(torch.abs(c))) for c in cpu))
    err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(dev, cpu))
    check(err <= tol, f"{name}: logits off the CPU run by {err} > {tol}")
    gap = decision_gap(cpu)
    check(gap > 2 * tol, f"{name}: top-2 gap {gap} too small to compare tokens")
    c_cpu, _ = model.prefill(p_cpu, {"tokens": prompt})
    c_dev, _ = model.prefill(p_dev, {"tokens": prompt.to(device)})
    expected.add(cfg, forwards=1)
    cache_err, cache_ok = 0.0, True
    for a, b in zip(tree_leaves(c_dev), tree_leaves(c_cpu)):
        if isinstance(b, torch.Tensor):
            e = float(torch.max(torch.abs(a.cpu() - b)))
            cache_ok &= e <= PARITY_ATOL * max(1.0, float(torch.max(torch.abs(b))))
            cache_err = max(cache_err, e)
        else:
            cache_ok &= a == b
    check(cache_ok, f"{name}: prefill caches off the CPU's by {cache_err}")
    t_cpu = generate(model, p_cpu, prompt, new, device="cpu")
    t_dev = generate(model, p_dev, prompt, new, device=device)
    expected.add(cfg, forwards=1, steps=new)
    same = bool(torch.equal(t_dev.cpu(), t_cpu))
    check(same, f"{name}: greedy tokens differ from the CPU run")
    row = dict(max_logits_err=err, tol=tol, top2_gap=gap, max_cache_err=cache_err,
               tokens_equal=same)
    nodrop = get_model(cfg.replace(capacity_factor=16.0))
    row.update(scheduler_vs_generate(check, expected, nodrop, p_cpu, p_dev,
                                     name + " capacity 16", device, tol))
    print(f"{name}:", json.dumps(row), flush=True)
    return row


def jamba_full_config():
    """jamba-1.5-large-398b at its published widths, cut to one period (8
    of 72 layers: attention + 7 Mamba, 4 dense and 4 MoE FFNs) and 4 of
    its 16 experts (top-2 kept): 16.2 B params, 32.5 GB in bf16."""
    from repro_torch.configs import get_config
    return get_config("jamba-1.5-large-398b").replace(num_layers=8, num_experts=4)


def slice_g2(check: Check, expected: Expected, device="cuda"):
    """Full width (jamba_full_config), random init from PRNGKey(0) drawn
    on the card, bf16 params and compute: generate (B 2, prompt 1024, 16
    new), a BatchScheduler (4 slots, 8 requests of 16-128 prompt tokens,
    16 new each), and the f32 teacher-forced check (compute_dtype f32, the
    bf16 params shared) at capacity_factor = experts / top_k = 2, the
    least at which no token can drop (each expert can take every token),
    so that a token's output does not depend on how many share its batch."""
    import torch
    from repro_torch import prng
    from repro_torch.models import get_model
    from repro_torch.utils import param_bytes, param_count
    label = "slice (g2) jamba-1.5-large-398b"
    cfg = jamba_full_config()
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
    out = dict(params=param_count(params), param_gb=param_bytes(params) / 1e9,
               init_s=t_init, init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{label} init:", json.dumps(out), flush=True)
    out["generate"] = serve_run(check, expected, cfg, params, 2, 1024, 16, label, device)
    out["scheduler"] = scheduler_run(check, expected, model, params, label, 4,
                                     144, 8, 16, 128, 16, device)
    nodrop = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    out["f32_teacher_forced"] = teacher_forced_check(check, expected, nodrop,
                                                     params, label, device)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------- K6 and the training slice (f)
# (label, B, Sq, Skv, H, KV, hd, causal, window): FLASH_CASES plus the
# training shapes (qwen1.5-0.5b's 8 x 512 and qwen2.5-3b's 4 x 1024 are in it)
def bwd_close(got, want, dtype):
    """(ok, max_abs_err) of one gradient: f32 within LM_TOL * max|want|; a
    bf16 gradient within one bf16 ulp of the plain result plus that (both
    round the same f32 sums, taken in another order)."""
    import torch
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return False, float("inf")
    diff = torch.abs(g - w)
    tol = LM_TOL * float(torch.max(torch.abs(w)))
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            torch.clamp(torch.abs(w), min=2.0 ** -126))) - 7)
    return bool(torch.all(diff <= tol)), float(torch.max(diff))


def cancelled_close(got, want, q, k, v, do):
    """(ok, max_abs_err) of dq or dk where every query sees one key (Skv =
    1): there p = 1 and O = v, so ds = dO v - dO O is 0 by the formulas and
    both sides hold only the residue of that cancellation, each in its own
    summation order; a bound relative to max|want| (itself residue) holds
    for no two orders. LM_TOL is taken relative to the cancelling terms
    instead: max|dO v| times the largest q or k element times scale, times
    G (dk sums the group's heads)."""
    import torch
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return False, float("inf")
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    dp = torch.einsum("bqkgh,bskh->bkgqs", do.float().reshape(B, Sq, KV, G, hd), v.float())
    terms = float(dp.abs().max()) * max(float(q.abs().max()), float(k.abs().max()))
    tol = LM_TOL * terms * hd ** -0.5 * G
    err = float(torch.max(torch.abs(g - w)))
    return err <= tol, err


def lm_bwd_phase(check: Check, device="cuda"):
    """K6 against flash_attention_bwd_plain on the card over FLASH_CASES
    (hd 32-128, G 1/4/8, windows, ragged S, Sq < Skv, the training shapes),
    f32 and bf16, both fed the forward kernel's out and lse (where Skv = 1,
    dq and dk under ``cancelled_close``); then the
    FlashAttention and RMSNorm Functions' gradients on the card against the
    same Functions on the CPU. Returns the worst K6 error."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, case in enumerate(FLASH_CASES):
            label, B, Sq, Skv, H, KV, hd, causal, window = case
            q, k, v = flash_inputs(i, case, dtype, device)
            do = lm_inputs((B, Sq, H, hd), dtype, device, 500 + i)
            if label in V_ZERO_COLS:
                do[..., hd - V_ZERO_COLS[label]:] = 0
            out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window)
            before = fk.flash_attention_bwd.launches
            got = fk.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                         window=window)
            check(fk.flash_attention_bwd.launches == before + 1,
                  f"flash_attention_bwd {label}/{dn}: not one launch")
            want = fk.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal=causal, window=window)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                if Skv == 1 and name != "dv":
                    ok, err = cancelled_close(g, w, q, k, v, do)
                else:
                    ok, err = bwd_close(g, w, dtype)
                check(ok and g.dtype == dtype, f"flash_attention_bwd "
                      f"{label}/{dn} {name}: max_abs_err {err}")
                worst = max(worst, err)
            del q, k, v, do, out, lse, got, want
        # the two Functions: gradients on the card against the CPU; in bf16
        # the attention's against the CPU's backward fed the card's forward
        # output (K5 and the plain forward may round an element of the bf16
        # output one ulp apart, and delta = rowsum(dO * O) reads it)
        B, S, H, KV, hd, window = 2, 77, 8, 2, 64, 24
        q, k, v, do = (lm_inputs(shape, dtype, "cpu", 600 + j) for j, shape in
                       enumerate(((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                                  (B, S, H, hd))))
        x, gx = lm_inputs((37, 256), dtype, "cpu", 610), lm_inputs((37, 256), dtype, "cpu", 611)
        scale = torch.linspace(0.5, 1.5, 256)
        grads = []
        for dev in ("cpu", device):
            leaves = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
            ga = torch.autograd.grad(ops.flash_attention(*leaves, window=window),
                                     leaves, do.to(dev))
            xs = [x.to(dev).requires_grad_(True), scale.to(dev).requires_grad_(True)]
            gr = torch.autograd.grad(ops.rmsnorm(*xs), xs, gx.to(dev))
            grads.append([t.float().cpu() for t in ga + gr])
        if dtype == torch.bfloat16:
            out, lse = fk.flash_attention_fwd(*(t.to(device) for t in (q, k, v)),
                                              window=window)
            grads[0][:3] = [t.float() for t in fk.flash_attention_bwd_plain(
                q, k, v, out.cpu(), lse.cpu(), do, window=window)]
        for name, g, w in zip(("dq", "dk", "dv", "dx", "dscale"), *grads[::-1]):
            ok, err = bwd_close(g, w, dtype)
            check(ok and float(torch.max(torch.abs(g))) > 0.0,
                  f"Functions' {name}/{dn} on the card vs the CPU: max_abs_err {err}")
    torch.cuda.synchronize()
    print("LM backward phase:", json.dumps({"flash_attention_bwd": worst}), flush=True)
    return worst


# K6 at the training shapes: (label, B, S, H, KV, hd)
BWD_TIMING = (("qwen1.5_train", 8, 512, 16, 16, 64),
              ("qwen2.5_train", 4, 1024, 16, 2, 128),
              ("llava_train", 2, 1088, 56, 8, 128),
              ("whisper_encoder_train", 2, 1500, 16, 16, 64))


def lm_bwd_timing(device="cuda"):
    """K6 at the training shapes of BWD_TIMING (bf16, causal; qwen1.5-0.5b's
    8 x 512 with 16 heads at hd 64, qwen2.5-3b's 4 x 1024 with 16 / 2 heads
    at hd 128, llava's 2 x (576 + 512) with 56 / 8 at hd 128; whisper's
    encoder non-causal, 2 x 1500 frames with 16 heads at hd 64):
    device time by CUDA-graph replay and eager time, the plain version's
    device time, the bound, the rate in TFLOP/s, and
    scaled_dot_product_attention's backward (``enable_gqa``, causal) as the
    library time, timed here only. The library time is device time too:
    ``torch.autograd.grad(..., retain_graph=True)`` over SDPA's output,
    captured in a CUDA graph and replayed (graph_ms). SDPA's forward runs
    once beforehand on the capture stream, so that autograd issues the
    backward there; the graph holds the backward alone. The eager time of
    the same call, with autograd's host cost, is kept beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    bf16 = torch.bfloat16
    rows = {}
    for label, B, S, H, KV, hd in BWD_TIMING:
        q = lm_inputs((B, S, H, hd), bf16, device, 1)
        k = lm_inputs((B, S, KV, hd), bf16, device, 2)
        v = lm_inputs((B, S, KV, hd), bf16, device, 3)
        do = lm_inputs((B, S, H, hd), bf16, device, 4)
        causal = label not in NONCAUSAL
        out, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        capture = torch.cuda.Stream()
        capture.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(capture):
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=KV != H)
        torch.cuda.current_stream().wait_stream(capture)
        dot = do.transpose(1, 2)
        library = lambda: torch.autograd.grad(  # noqa: E731
            o_lib, (qt, kt, vt), dot, retain_graph=True)
        # visible (query, key) pairs
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
        # q, out, dO, dq and k, v, dk, dv once each, lse and delta in f32
        bytes_ = 2 * (4 * B * S * H * hd + 4 * B * S * KV * hd) + 2 * 4 * B * H * S
        flops = 10.0 * hd * pairs
        t_b, t_o = bytes_ / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
        kernel = lambda: fk.flash_attention_bwd(q, k, v, out, lse, do,  # noqa: E731
                                                causal=causal)
        ms = graph_ms(kernel)
        rows[label] = dict(
            ms=ms, eager_ms=time_ms(kernel),
            plain_ms=graph_ms(lambda: fk.flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal=causal), calls=3, reps=3),
            library_ms=graph_ms(library, stream=capture),
            library_eager_ms=time_ms(library),
            bound_ms=1e3 * max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            bytes=bytes_, flops=flops, tflops=flops / (ms * 1e9))
        print("LM timing:", label, json.dumps(rows[label]), flush=True)
        del q, k, v, do, out, lse, qt, kt, vt, o_lib, library
    torch.cuda.empty_cache()
    return rows


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "ssm_scan", "fedagg")


def train_counts():
    from repro_torch.kernels import fedagg as fa
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssm_scan as sk
    return {"flash_attention": fk.flash_attention_fwd.launches,
            "flash_attention_bwd": fk.flash_attention_bwd.launches,
            "rmsnorm": rk.rmsnorm_fwd.launches,
            "ssm_scan": sk.ssm_scan.launches, "fedagg": fa.fedagg.launches}


def reset_train_counts():
    from repro_torch.kernels import fedagg as fa
    reset_lm_counts()
    from repro_torch.kernels import flash_attention as fk
    fk.flash_attention_bwd.launches = 0
    fa.fedagg.launches = 0
    fa.fedagg.variant_launches.clear()


class TrainExpected(dict):
    """The launches the training path should make, with A attention and M
    Mamba layers of L (the dense family: A = L, M = 0; jamba: A = 1, M = 7
    a period). A no-grad forward: A of K5, M of K8, 2L + 1 of K9 (the
    final norm is outside the periods; ``norm_count``: 2A more under MLA).
    One loss_fn gradient with remat (every shipped config's): the
    forward's and, as the backward re-runs each period, again A of K5 and
    M of K8, A of K6, and 2L + 1 + 2L of K9; the leading dense blocks run
    outside the periods' checkpoints, so their launches are not repeated.
    Under ``remat_policy="save_mixer"`` the backward re-runs only each
    layer's norm2 + FFN: one K9 a layer with an FFN, no K5 or K8 again.
    A round of C clients and E local steps: the server loss and each
    client's loss at the received model (no graph), E gradients for each
    client that trains, and one fedagg launch (none on the temporal
    round's mean stream). ``images``: llava's batches, whose img_norm runs
    once a forward, outside the periods' checkpoints."""

    def __init__(self):
        super().__init__({k: 0 for k in TRAIN_KERNELS})

    def add_forwards(self, cfg, n, images=False):
        A, M = mixer_counts(cfg)
        self["flash_attention"] += A * n
        self["ssm_scan"] += M * n
        self["rmsnorm"] += norm_count(cfg, images=images) * n

    def add_grad(self, cfg, n=1, images=False):
        A, M = mixer_counts(cfg)
        if cfg.remat_policy == "save_mixer":      # only norm2 + FFN run again
            A_p = M_p = 0
            norms_p = sum(k["ffn"] != "none" for k in layer_kinds(cfg, False))
        else:
            A_p, M_p = mixer_counts(cfg, pre=False)
            norms_p = norm_count(cfg, pre=False)
        self["flash_attention"] += (A + A_p) * n
        self["flash_attention_bwd"] += A * n
        self["ssm_scan"] += (M + M_p) * n
        self["rmsnorm"] += (norm_count(cfg, images=images) + norms_p) * n

    def add_encdec_grad(self, cfg, n=1):
        """One whisper loss_fn gradient: K5 in each encoder layer once and,
        with remat, in each decoder layer twice (its checkpoint runs again
        in the backward); K6 in every layer."""
        E, D = cfg.encoder_layers, cfg.num_layers
        self["flash_attention"] += (E + (2 if cfg.remat else 1) * D) * n
        self["flash_attention_bwd"] += (E + D) * n

    def add_rounds(self, cfg, C, E, rounds, trained=None, fedagg=True,
                   images=False):
        """``trained``: the clients that take their E steps a round (a
        cohort's K, or the temporal round's gated-in count; default all
        C); ``fedagg``: whether the round aggregates through the kernel."""
        self.add_forwards(cfg, (1 + C) * rounds, images)
        self["fedagg"] += rounds if fedagg else 0
        self.add_grad(cfg, (C if trained is None else trained) * E * rounds,
                      images)


# slice (f1): (arch, model knobs, eps), the settings of
# tests/test_torch_train_round.py: eps admits some non-priority client in
# some round and drops one in another, every decision >= 0.05 from eps
TRAIN_PARITY = [("qwen1.5-0.5b", {}, 0.15), ("qwen2.5-3b", {}, 0.15),
                ("qwen1.5-0.5b", {"sliding_window": 16}, 0.2)]
TRAIN_RUN = dict(rounds=3, clients=4, n_priority=2, per_client=2, seq=64,
                 local_epochs=2, lr=0.05)
GATE_MARGIN = 1e-3
# f32 full-width gradient, kernels vs plain versions on the card: relative
# L2 error per leaf (see slice_f2)
GRAD_RTOL = 1e-4


@contextmanager
def smoke_knobs(**knobs):
    """``launch.train`` builds its smoke config with these knobs replaced
    (the windowed parity run); restored on exit."""
    from repro_torch.launch import train
    orig = train.get_smoke
    train.get_smoke = lambda arch: orig(arch).replace(**knobs)
    try:
        yield
    finally:
        train.get_smoke = orig


def loss_grads(model, params, batch):
    """(loss, [grad per leaf]) of model.loss_fn, as a local step takes it."""
    import torch
    from repro_torch.utils import tree_leaves, tree_unflatten_like
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = model.loss_fn(tree_unflatten_like(params, leaves), batch)[0]
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def leaf_errs(got, want):
    """(the largest per-leaf error relative to the leaf's largest
    magnitude, every leaf present and nonzero where ``want``'s is)."""
    import torch
    err, complete = 0.0, len(got) == len(want)
    for a, b in zip(got, want):
        a, b = a.float().cpu(), b.float().cpu()
        scale = float(torch.max(torch.abs(b)))
        complete &= scale == 0.0 or float(torch.max(torch.abs(a))) > 0.0
        err = max(err, float(torch.max(torch.abs(a - b))) / max(scale, 1e-30))
    return err, complete


def rel_l2(got, want):
    import torch
    return max(float(torch.linalg.vector_norm((a - b).float())
                     / torch.linalg.vector_norm(b.float())) for a, b in zip(got, want))


def same_bits(a, b):
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def token_batch(cfg, B, S, device, seed=0):
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S + 1))
    toks = torch.from_numpy(toks.astype(np.int32)).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones(B, S, device=device)}


def train_parity(check: Check, expected: TrainExpected, name, arch, knobs,
                 eps, device="cuda", tol=PARITY_ATOL, run=TRAIN_RUN):
    """One smoke config through launch.train.run on the card against the
    same port code on the CPU (``run``: f32, 4 clients of which 2
    priority, 2 sequences of 64 tokens each, E = 2, 3 rounds): gates and
    included counts equal, after checking every gate decision is more
    than GATE_MARGIN from eps; server and client losses and the final
    params within ``tol`` of the largest magnitude (at least 1); and a
    gradient-completeness check: one loss_fn gradient at the CPU run's
    final params, on the card and on the CPU, leaf for leaf within
    ``tol`` of the leaf's largest magnitude, no leaf zero on the card
    where the CPU's is not."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.utils import tree_leaves, tree_map
    cfg = get_smoke(arch).replace(**knobs)
    with smoke_knobs(**knobs):
        p_cpu, h_cpu = train.run(arch=arch, epsilon=eps, device="cpu",
                                 verbose=False, **run)
        p_dev, h_dev = train.run(arch=arch, epsilon=eps, device=device,
                                 verbose=False, **run)
    expected.add_rounds(cfg, run["clients"], run["local_epochs"],
                        run["rounds"])
    npri = run["n_priority"]
    margin = min(abs(abs(l - h["server_loss"]) - eps)
                 for h in h_cpu for l in h["local_losses"][npri:])
    check(margin > GATE_MARGIN, f"{name}: gate margin {margin}")
    included = [h["included"] for h in h_cpu]
    check(0 < sum(included) < (run["clients"] - npri) * len(h_cpu),
          f"{name}: eps {eps} gates every client in or every one out")
    same = all(a["gates"] == b["gates"] and a["included"] == b["included"]
               for a, b in zip(h_dev, h_cpu))
    check(same, f"{name}: gates differ from the CPU run")
    loss_err = max(abs(a[k] - b[k]) / max(1.0, abs(b[k]))
                   for a, b in zip(h_dev, h_cpu) for k in ("server_loss",))
    local_err = max(float(np.max(np.abs(np.subtract(a["local_losses"], b["local_losses"]))))
                    / max(1.0, float(np.max(np.abs(b["local_losses"]))))
                    for a, b in zip(h_dev, h_cpu))
    check(max(loss_err, local_err) <= tol,
          f"{name}: losses off the CPU run by {loss_err}, {local_err}")
    param_err = max(float(torch.max(torch.abs(a.cpu() - b)))
                    / max(1.0, float(torch.max(torch.abs(b))))
                    for a, b in zip(tree_leaves(p_dev), tree_leaves(p_cpu)))
    check(param_err <= tol, f"{name}: params off the CPU run by {param_err}")
    # gradient completeness: the same loss_fn gradient on both devices
    model = get_model(cfg)
    batch = token_batch(cfg, 2, 64, "cpu", seed=5)
    l_cpu, g_cpu = loss_grads(model, p_cpu, batch)
    l_dev, g_dev = loss_grads(model, tree_map(lambda t: t.to(device), p_cpu),
                              {k: t.to(device) for k, t in batch.items()})
    expected.add_grad(cfg)
    grad_err, complete = leaf_errs(g_dev, g_cpu)
    check(complete, f"{name}: a gradient leaf is missing or zero on the card")
    check(grad_err <= tol, f"{name}: loss_fn gradient off the CPU's by "
          f"{grad_err} (relative to each leaf's largest)")
    row = dict(eps=eps, gate_margin=margin, included=included,
               gates_equal=same, max_loss_rel_err=max(loss_err, local_err),
               max_param_rel_err=param_err, grad_leaves=len(g_dev),
               max_grad_rel_err=grad_err,
               loss_grad_err=abs(float(l_dev) - float(l_cpu)))
    print(f"{name}:", json.dumps(row), flush=True)
    return row


def slice_f1(check: Check, expected: TrainExpected, device="cuda"):
    """Smoke-size federated training of the dense configs on the card
    against the same port code on the CPU (``train_parity``)."""
    out = {}
    for arch, knobs, eps in TRAIN_PARITY:
        name = f"slice (f1) {arch}" + (f" window {knobs['sliding_window']}" if knobs else "")
        out[name] = train_parity(check, expected, name, arch, knobs, eps,
                                 device)
    return out


def slice_f2(check: Check, expected: TrainExpected, device="cuda"):
    """Full width: qwen1.5-0.5b (random init on the card, f32 params, bf16
    compute, remat on) in federated training through launch.train.run: 8
    clients (4 priority), 8 sequences of 512 tokens each, E = 2, lr 0.05,
    1 warm-up round and 2 timed rounds (the params after the first kept on
    the host for slice f4; peak GB the largest round's, as ``lm_rounds``
    reads it for the temporal cells). Then the f32 full-width gradient
    check: one client's loss_fn gradient (8 x 512, compute_dtype float32)
    through the kernels against the same gradient through the plain
    versions (flash_attention_plain and rmsnorm_plain, differentiated by
    autograd) on the same card, each leaf's relative L2 error within
    GRAD_RTOL: the two routes differ only in f32 summation order, over 24
    layers (errors of order 1e-6 relative)."""
    import math
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.utils import param_count
    C, P, E, rounds = 8, 4, 2, 3
    cfg = get_config("qwen1.5-0.5b")
    torch.cuda.empty_cache()
    before = train_counts()
    with lm_rounds(keep_first=True) as rec:
        params, hist = train.run(arch="qwen1.5-0.5b", smoke=False,
                                 rounds=rounds, clients=C, n_priority=P,
                                 per_client=8, seq=512, local_epochs=E,
                                 lr=0.05, device=device)
    peak = max(rec["peak_gb"])
    expected.add_rounds(cfg, C, E, rounds)
    # this run's own launches: per round L (1 + C (1 + 2E)) of K5, L C E of
    # K6, (2L + 1)(1 + C) + C E (4L + 1) of K9 and one fedagg
    launches = {k: v - before[k] for k, v in train_counts().items()}
    want = TrainExpected()
    want.add_rounds(cfg, C, E, rounds)
    check(launches == want, f"slice (f2): launches {launches}, expected {want}")
    ok = all(math.isfinite(h["server_loss"]) and 0 <= h["included"] <= C - P
             for h in hist) and len(hist) == rounds
    check(ok, "slice (f2): non-finite server loss or included count out of range")
    timed = [h["sec"] for h in hist[1:]]
    row = dict(params=param_count(params), clients=C, priority=P, per_client=8,
               seq=512, local_epochs=E, warmup_round_s=hist[0]["sec"],
               round_s=timed, s_per_round=sum(timed) / len(timed), peak_gb=peak,
               round_peak_gb=rec["peak_gb"],
               server_loss=[h["server_loss"] for h in hist],
               included=[h["included"] for h in hist],
               gates=[h["gates"] for h in hist], launches=launches)
    print("slice (f2) qwen1.5-0.5b federated training:", json.dumps(row), flush=True)
    del params
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(compute_dtype="float32")
    model = get_model(cfg32)
    params = model.init(prng.PRNGKey(0), device=device)
    batch = token_batch(cfg32, 8, 512, device, seed=7)
    l_k, g_k = loss_grads(model, params, batch)
    expected.add_grad(cfg32)
    saved = ops.flash_attention, ops.rmsnorm
    ops.flash_attention = (lambda q, k, v, *, causal, window, scale=None, block_kv,
                           mm_dtype=None: fk.flash_attention_plain(
                               q, k, v, causal=causal, window=window, scale=scale,
                               block_kv=block_kv)[0])
    ops.rmsnorm = lambda x, s, *, eps: rk.rmsnorm_plain(x, s, eps)
    try:
        l_p, g_p = loss_grads(model, params, batch)
    finally:
        ops.flash_attention, ops.rmsnorm = saved
    rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
           for a, b in zip(g_k, g_p)]
    check(max(rel) <= GRAD_RTOL and all(math.isfinite(r) for r in rel),
          f"slice (f2) f32 gradient: kernel route off the plain route by {max(rel)}")
    grad_row = dict(leaves=len(rel), max_rel_l2=max(rel), loss_kernel=float(l_k),
                    loss_plain=float(l_p))
    print("slice (f2) f32 gradient, kernels vs plain:", json.dumps(grad_row), flush=True)
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return dict(row, f32_gradient=grad_row), rec["first"]


@contextmanager
def lm_rounds(temporal=False, cfg=None, keep_first=False):
    """Record, for each LM round ``launch.train.run`` makes inside the
    block, its peak device GB (the counter reset as the round starts) and,
    with ``keep_first``, keep on the host the global params after round 0
    (a list of leaves, the last run's; the copy falls in round 0's time).
    With ``temporal`` the run's rounds are the temporal
    round's (``make_round_step(..., fsdp=True)``); with ``cfg`` the run
    trains ``cfg`` in place of its arch's full-size config. Yields
    {"peak_gb": [...], "first": [...]}."""
    import torch
    from repro_torch.fl import sharded
    from repro_torch.launch import train
    from repro_torch.utils import tree_leaves
    rec = {"peak_gb": [], "first": []}
    make, get = sharded.make_round_step, train.get_config

    def recording_make(model, fed, num_clients, *, fsdp, device="cuda"):
        step = make(model, fed, num_clients, fsdp=fsdp or temporal,
                    device=device)

        def recording_step(state, batch, round_idx=0):
            torch.cuda.reset_peak_memory_stats()
            new, stats = step(state, batch, round_idx)
            rec["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
            if keep_first and int(round_idx) == 0:
                rec["first"][:] = [t.detach().cpu() for t in tree_leaves(new.params)]
            return new, stats
        return recording_step

    sharded.make_round_step = recording_make
    if cfg is not None:
        train.get_config = lambda arch: cfg
    try:
        yield rec
    finally:
        sharded.make_round_step, train.get_config = make, get


# slice (f3): the LM round under a training cohort at full width
F3 = dict(clients=8, n_priority=2, per_client=8, seq=512, local_epochs=2,
          lr=0.05, epsilon=1.0, max_cohort=4, server_opt="adam",
          server_lr=1e-3, selection="fedalign")
F3_ROUNDS = 3


@contextmanager
def lm_round_records():
    """Record, for each LM round ``launch.train.run`` makes, the client
    rows the aggregation receives, and after it the backlog, adam's step
    count (where the server optimizer has one), whether the round had
    inclusion mass and a pool round's pool."""
    from repro_torch.fl import engine, sharded
    rec = {"rows": [], "backlog": [], "t": [], "mass": [], "pool_idx": []}
    make, delta = sharded.make_round_step, engine.server_delta

    def recording_delta(fed, gp, cp, w, g, **k):
        rec["rows"].append(int(next(iter(cp.values())).shape[0]))
        rec["mass"].append(bool((w * g).sum() > 0))
        return delta(fed, gp, cp, w, g, **k)

    def recording_make(*a, **k):
        step = make(*a, **k)

        def recording_step(state, batch, round_idx=0):
            new, stats = step(state, batch, round_idx)
            rec["backlog"].append(new.backlog.cpu().tolist())
            if isinstance(new.opt_state, dict) and "t" in new.opt_state:
                rec["t"].append(int(new.opt_state["t"]))
            if "pool_idx" in stats:
                rec["pool_idx"].append(stats["pool_idx"].cpu().tolist())
            return new, stats
        return recording_step

    sharded.make_round_step, engine.server_delta = recording_make, recording_delta
    try:
        yield rec
    finally:
        sharded.make_round_step, engine.server_delta = make, delta


def slice_f3(check: Check, expected: TrainExpected, f2_row, device="cuda"):
    """Full width under a training cohort: qwen1.5-0.5b (random init, f32
    params, bf16 compute, remat) through launch.train.run, 8 clients (2
    priority), 8 x 512 tokens each, E = 2, max_cohort = 4, FedAdam
    (server lr 1e-3), fedalign with an eps that admits every client: the
    round evaluates 8 clients, trains the 4 of its cohort (the 2 priority
    and the 2 best-matched) into a 4-row client stack, and drops the rest
    with a backlog. 1 + 2 rounds. Checks: the cohort overflowed (some
    backlog above 0 after round 0), every aggregation got 4 client rows,
    adam's t equals the rounds with inclusion mass, finite params and
    losses, one fedagg launch a round; s/round and peak GB beside (f2)'s."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils import param_count, tree_leaves
    cfg = get_config("qwen1.5-0.5b")
    K = F3["max_cohort"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = train_counts()
    with lm_round_records() as rec:
        params, hist = train.run(arch="qwen1.5-0.5b", smoke=False,
                                 rounds=F3_ROUNDS, device=device, **F3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    expected.add_rounds(cfg, F3["clients"], F3["local_epochs"], F3_ROUNDS,
                        trained=K)
    launches = {k: v - before[k] for k, v in train_counts().items()}
    want = TrainExpected()
    want.add_rounds(cfg, F3["clients"], F3["local_epochs"], F3_ROUNDS,
                    trained=K)
    check(launches == want, f"slice (f3): launches {launches}, expected {want}")
    check(len(rec["backlog"]) == F3_ROUNDS and max(rec["backlog"][0]) > 0,
          f"slice (f3): no overflow after round 0 (backlog {rec['backlog']})")
    check(rec["rows"] == [K] * F3_ROUNDS,
          f"slice (f3): client stacks of {rec['rows']} rows, expected {K}")
    check(rec["t"][-1] == sum(rec["mass"]),
          f"slice (f3): adam's t {rec['t']}, rounds with mass {rec['mass']}")
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    check(finite and all(math.isfinite(h["server_loss"]) for h in hist),
          "slice (f3): non-finite params or server loss")
    check(all(sum(h["gates"]) == K for h in hist),
          "slice (f3): a round's effective gates do not fill the cohort")
    timed = [h["sec"] for h in hist[1:]]
    row = dict(params=param_count(params), clients=F3["clients"],
               priority=F3["n_priority"], cohort=K,
               per_client=F3["per_client"], seq=F3["seq"],
               local_epochs=F3["local_epochs"], warmup_round_s=hist[0]["sec"],
               round_s=timed, s_per_round=sum(timed) / len(timed),
               peak_gb=peak, f2_s_per_round=f2_row["s_per_round"],
               f2_peak_gb=f2_row["peak_gb"],
               server_loss=[h["server_loss"] for h in hist],
               gates=[h["gates"] for h in hist], backlog=rec["backlog"],
               adam_t=rec["t"], client_rows=rec["rows"], launches=launches)
    print("slice (f3) qwen1.5-0.5b training cohort:", json.dumps(row),
          flush=True)
    del params
    torch.cuda.empty_cache()
    return row


# ------------------------------- the temporal round (f4, f5), jamba training (g3)
def lm_param_count(cfg) -> int:
    """The params of a dense-GQA or jamba config from its widths (the
    shapes ``models/transformer.py:init`` draws), so that a sizing table
    needs no init; checked against an init in slice (g3)."""
    d, V, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    attn = 2 * d * H * hd + 2 * d * KV * hd
    if cfg.qkv_bias:
        attn += (H + 2 * KV) * hd
    di, N, K, r = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_dim, cfg.ssm_dt_rank
    mamba = 2 * d * di + K * di + di + di * (r + 2 * N) + r * di + di + di * N + di + di * d
    dense = 3 * d * cfg.d_ff
    moe = d * cfg.num_experts + 3 * cfg.num_experts * d * cfg.moe_d_ff \
        + 3 * d * cfg.num_shared_experts * cfg.moe_d_ff
    period = sum(2 * d + (attn if k["mixer"] == "attn" else mamba)
                 + (dense if k["ffn"] == "dense" else moe)
                 for k in cfg.layer_kinds())
    return V * d + d + (0 if cfg.tie_embeddings else d * V) + cfg.n_periods * period


def gate_margin(hist, eps, n_priority):
    return min(abs(abs(l - h["server_loss"]) - eps)
               for h in hist for l in h["local_losses"][n_priority:])


def repeat_equal(cfg, params, batch, lr, E):
    """Whether one client's E local steps (``sharded._train_steps``), run
    twice from the same params on the same batch, give the same bits: the
    temporal round's grad_sim re-trains a client in its second pass."""
    import torch
    from repro_torch.fl import sharded
    from repro_torch.models import get_model
    from repro_torch.utils import tree_leaves, tree_map
    model = get_model(cfg)
    a = sharded._train_steps(model, params, batch, lr, E,
                             out=tree_map(torch.empty_like, params))
    b = sharded._train_steps(model, params, batch, lr, E,
                             out=tree_map(torch.empty_like, params))
    same = all(bool(torch.equal(x, y)) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    del a, b
    return same


def temporal_cell(check: Check, expected: TrainExpected, name, arch, rounds,
                  kw, device="cuda", cfg=None, keep_first=False):
    """``launch.train.run(arch, smoke=False, **kw)`` through the temporal
    round (``lm_rounds``, on ``cfg`` if given, keeping round 0's params if
    ``keep_first``), with the checks every
    temporal cell makes: the launches equal the count from 1 + C no-grad
    forwards a round and E steps for each gated-in client, with no fedagg
    launch; finite params and losses; peak under 80 GB. Returns (params,
    history with each round's ``peak_gb``, first-round params,
    launches)."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils import tree_leaves
    cfg = cfg or get_config(arch)
    torch.cuda.empty_cache()
    before = train_counts()
    with lm_rounds(temporal=True, cfg=cfg, keep_first=keep_first) as rec:
        params, hist = train.run(arch=arch, smoke=False, rounds=rounds,
                                 device=device, verbose=False, **kw)
    for h, peak in zip(hist, rec["peak_gb"], strict=True):
        h["peak_gb"] = peak
    launches = {k: v - before[k] for k, v in train_counts().items()}
    want = TrainExpected()
    for h in hist:
        want.add_rounds(cfg, kw["clients"], kw["local_epochs"], 1,
                        trained=sum(g > 0 for g in h["gates"]), fedagg=False)
    for k, v in want.items():
        expected[k] += v
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    losses_ok = all(math.isfinite(h["server_loss"])
                    and all(math.isfinite(l) for l in h["local_losses"])
                    for h in hist)
    check(finite and losses_ok, f"{name}: non-finite params or losses")
    peak = max(h["peak_gb"] for h in hist)
    check(peak < 80.0, f"{name}: peak {peak} GB")
    return params, hist, rec["first"], launches


def round_times(hist):
    """The rounds after the first (warm-up) one: their seconds and peak."""
    timed = hist[1:]
    return dict(warmup_round_s=hist[0]["sec"],
                round_s=[h["sec"] for h in timed],
                s_per_round=sum(h["sec"] for h in timed) / len(timed),
                peak_gb=max(h["peak_gb"] for h in timed),
                round_peak_gb=[h["peak_gb"] for h in hist],
                server_loss=[h["server_loss"] for h in hist])


# slice (f4): slice (f2)'s config and batches through the temporal round
F4 = dict(clients=8, n_priority=4, per_client=8, seq=512, local_epochs=2,
          lr=0.05, epsilon=0.5)
F4_ROUNDS = 3


def slice_f4(check: Check, expected: TrainExpected, f2_row, f2_first,
             device="cuda"):
    """(f2)'s round (qwen1.5-0.5b full width, random init, f32 params, bf16
    compute, remat, sgd; 8 clients of which 4 priority, 8 x 512 tokens
    each, E = 2, eps 0.5: the same ``launch.train.run`` call, so the same
    federation, batches and init) through the temporal round: the clients stream through one client buffer and
    an f32 running sum, no fedagg launch. 1 + 2 rounds. Checks: gates
    equal to (f2)'s in every round (each decision > GATE_MARGIN from eps);
    the params after the first round within PARITY_ATOL x max(1, max|p|)
    of (f2)'s, leaf for leaf (the running sum against K1's mean of the
    deltas, in another order); finite params; launches equal to the count
    from 9 no-grad forwards a round and E steps for each gated-in client.
    Also whether one client's E steps, run twice, give the same bits."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.utils import param_count
    name = "slice (f4) qwen1.5-0.5b temporal round"
    cfg = get_config("qwen1.5-0.5b")
    params, hist, first, launches = temporal_cell(
        check, expected, name, "qwen1.5-0.5b", F4_ROUNDS, F4, device,
        keep_first=True)
    margin = gate_margin(hist, F4["epsilon"], F4["n_priority"])
    check(margin > GATE_MARGIN, f"{name}: gate margin {margin}")
    gates = [h["gates"] for h in hist]
    check(gates == f2_row["gates"], f"{name}: gates {gates}, (f2)'s "
          f"{f2_row['gates']}")
    err = max(float(torch.max(torch.abs(a - b))) / max(1.0, float(torch.max(torch.abs(b))))
              for a, b in zip(first, f2_first)) if len(first) == len(f2_first) else math.inf
    check(err <= PARITY_ATOL, f"{name}: first-round params off (f2)'s by {err}")
    batch = token_batch(cfg, F4["per_client"], F4["seq"], device, seed=9)
    same = repeat_equal(cfg, params, batch, F4["lr"], F4["local_epochs"])
    expected.add_grad(cfg, 2 * F4["local_epochs"])
    row = dict(params=param_count(params), **F4, **round_times(hist),
               f2_s_per_round=f2_row["s_per_round"], f2_peak_gb=f2_row["peak_gb"],
               gates=gates, gate_margin=margin,
               first_round_param_rel_err_vs_f2=err, repeat_bit_equal=same,
               launches=launches)
    print(f"{name}:", json.dumps(row), flush=True)
    del params, first
    torch.cuda.empty_cache()
    return row


# slice (f5): qwen2.5-3b at full width through the temporal round; eps
# 1e3 gates every client in (at lr 0.05 the second round's gaps reach ~2)
F5 = dict(clients=4, n_priority=2, per_client=8, seq=512, local_epochs=2,
          lr=0.05, epsilon=1e3)
F5_ROUNDS = 2


def slice_f5(check: Check, expected: TrainExpected, device="cuda"):
    """qwen2.5-3b (3.09 B params, random init on the card, f32 params,
    bf16 compute, remat, sgd) through the temporal round: 4 clients of
    which 2 priority, 8 x 512 tokens each, E = 2, 1 + 1 rounds. The round
    holds params, one client copy, its gradients and the f32 accumulator
    (4 x 12.34 GB) plus activations. Checks: every client gated in (8
    local steps a round), finite losses and params, launches equal to the
    count from 5 no-grad forwards and 8 steps a round, peak GB under 80."""
    import torch
    from repro_torch.utils import param_bytes, param_count
    name = "slice (f5) qwen2.5-3b temporal round"
    params, hist, _, launches = temporal_cell(check, expected, name,
                                              "qwen2.5-3b", F5_ROUNDS, F5,
                                              device)
    check(all(h["gates"] == [1.0] * F5["clients"] for h in hist),
          f"{name}: a client was gated out ({[h['gates'] for h in hist]})")
    row = dict(params=param_count(params), param_gb=param_bytes(params) / 1e9,
               **F5, **round_times(hist),
               local_losses=[h["local_losses"] for h in hist],
               launches=launches)
    print(f"{name}:", json.dumps(row), flush=True)
    del params
    torch.cuda.empty_cache()
    return row


# (g3)(ii): K8's gradient at jamba's published channel count
SSM_GRAD = (2, 512, 16384, 16)
SSM_GRAD_TOL = 1e-5


def ssm_grad_phase(check: Check, device="cuda"):
    """Slice (g3)(ii): K8 under autograd (the SSMScan Function: the kernel
    forward, ``ssm_scan_bwd``'s chunked reverse scans) against autograd
    through ``ssm_scan_plain`` on the card (the sequential recurrence,
    differentiated step by step), on the same inputs and output gradient,
    at Bt 2, S 512, Di 16384 (jamba's d_inner), N 16, x f32 and bf16:
    every input's gradient within SSM_GRAD_TOL x max(1, max|want|) (the
    two routes sum in another order; ~4e-7 relative on the CPU), dx of a
    bf16 x within one bf16 ulp more (both round one f32 value). The
    backward alone is timed (CUDA events, eager: plain torch, about
    S / 64 chunks of ~40 launches). Launches here are outside every
    path's count."""
    import torch
    from repro_torch.kernels import ssm_scan as sk
    Bt, S, Di, N = SSM_GRAD
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        args = ssm_inputs(Bt, S, Di, N, dtype, device, 600)
        gen = torch.Generator().manual_seed(601)
        dy = torch.randn(Bt, S, Di, generator=gen).to(device=device, dtype=dtype)
        leaves = [a.detach().requires_grad_(True) for a in args]
        got = torch.autograd.grad(sk.ssm_scan(*leaves), leaves, dy)
        want = torch.autograd.grad(sk.ssm_scan_plain(*leaves), leaves, dy)
        errs = {}
        for nm, g, w in zip(("x", "dt", "A", "B", "C", "D"), got, want):
            gf, wf = g.float(), w.float()
            bound = SSM_GRAD_TOL * max(1.0, float(torch.max(torch.abs(wf))))
            if nm == "x" and dtype == torch.bfloat16:
                bound = bound + torch.exp2(torch.floor(torch.log2(
                    torch.clamp(torch.abs(wf), min=2.0 ** -126))) - 7)
            err = torch.abs(gf - wf)
            ok = bool(torch.isfinite(gf).all()) and bool(torch.all(err <= bound))
            check(ok and g.dtype == w.dtype,
                  f"slice (g3)(ii) K8 gradient {nm}/{dn}: max_abs_err {float(err.max())}")
            errs[nm] = float(err.max()) / max(1.0, float(torch.max(torch.abs(wf))))
        del got, want, leaves
        plain = [a.detach() for a in args]
        bwd_ms = time_ms(lambda: sk.ssm_scan_bwd(*plain, dy), iters=5, warmup=1)
        out[dn] = dict(shape=list(SSM_GRAD), max_rel_err=errs, bwd_ms=bwd_ms)
        print("slice (g3)(ii) K8 gradient:", dn, json.dumps(out[dn]), flush=True)
        del args, plain, dy
    torch.cuda.empty_cache()
    return out


# slice (g3)(i): (f1)'s run and bound cut to 2 rounds (the CPU half of
# the run is the slice's time) at the smoke jamba's eps (every client gated
# in in round 0, both non-priority out in round 1; every decision > 0.04
# from eps on the CPU)
JAMBA_TRAIN_EPS = 0.1
JAMBA_TRAIN_RUN = dict(TRAIN_RUN, rounds=2)
G3 = dict(clients=4, n_priority=2, per_client=4, seq=512, local_epochs=2,
          lr=0.05, epsilon=1.0)


def jamba_train_config():
    """jamba-1.5-large-398b cut to train on one card: one period (8 of 72
    layers: attention + 7 Mamba, 4 dense and 4 MoE FFNs), the published
    head_dim 128 with 8 kv heads, ssm_state 16, conv 4, expand 2 and top-2,
    with d_model 8192 -> 4096 (32 heads, d_inner 8192, dt rank 256),
    d_ff and the experts' 24576 -> 8192, and 16 -> 4 experts; f32
    params, bf16 compute (sizing table: slice_g3)."""
    from repro_torch.configs import get_config
    return get_config("jamba-1.5-large-398b").replace(
        num_layers=8, d_model=4096, num_heads=32, d_ff=8192, moe_d_ff=8192,
        num_experts=4, ssm_dt_rank=256, param_dtype="float32",
        compute_dtype="bfloat16")


def slice_g3(check: Check, expected: TrainExpected, device="cuda"):
    """Jamba federated training. (i) The smoke jamba through
    launch.train.run (the spatial round, as the reference's run) on the
    card against the same code on the CPU (``train_parity``, 2 rounds).
    (iii) One temporal round over ``jamba_train_config`` (4 clients of
    which 2 priority, 4 x 512 tokens each, E = 2, eps admitting every
    client): ``temporal_cell``'s checks (each remat step runs a period's 7
    scans twice), s/round and peak GB, the sizing table (params and GB of
    one f32 copy at the published widths with 16, 4 and 2 experts, and at
    the cut, whose count must equal the init's), and whether one client's
    E steps, run twice, give the same bits (the MoE's index_put dispatch
    is plain torch). (ii) is ``ssm_grad_phase``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.utils import param_count
    out = {"i": train_parity(check, expected,
                             "slice (g3)(i) jamba-1.5-large-398b",
                             "jamba-1.5-large-398b", {}, JAMBA_TRAIN_EPS,
                             device, run=JAMBA_TRAIN_RUN)}
    name = "slice (g3)(iii) jamba temporal round"
    cfg = jamba_train_config()
    pub = get_config("jamba-1.5-large-398b").replace(num_layers=8)
    sizing = {label: dict(params=n, f32_copy_gb=4 * n / 1e9,
                          four_f32_copies_gb=16 * n / 1e9)
              for label, n in (
                  ("published_one_period_16_experts", lm_param_count(pub)),
                  ("published_one_period_4_experts",
                   lm_param_count(pub.replace(num_experts=4))),
                  ("published_one_period_2_experts",
                   lm_param_count(pub.replace(num_experts=2))),
                  ("cut", lm_param_count(cfg)))}
    print(f"{name} sizing:", json.dumps(sizing), flush=True)
    params, hist, _, launches = temporal_cell(check, expected, name,
                                              "jamba-1.5-large-398b", 1, G3,
                                              device, cfg=cfg)
    check(param_count(params) == sizing["cut"]["params"],
          f"{name}: {param_count(params)} params, the sizing table's "
          f"{sizing['cut']['params']}")
    check(hist[0]["gates"] == [1.0] * G3["clients"],
          f"{name}: a client was gated out")
    batch = token_batch(cfg, G3["per_client"], G3["seq"], device, seed=9)
    same = repeat_equal(cfg, params, batch, G3["lr"], G3["local_epochs"])
    expected.add_grad(cfg, 2 * G3["local_epochs"])
    out["iii"] = dict(params=param_count(params), **G3, round_s=hist[0]["sec"],
                      peak_gb=hist[0]["peak_gb"],
                      server_loss=hist[0]["server_loss"],
                      local_losses=hist[0]["local_losses"],
                      repeat_bit_equal=same, launches=launches, sizing=sizing)
    print(f"{name}:", json.dumps(out["iii"]), flush=True)
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------- the asynchronous round and the fault layer (h)
# (h1): (label, backend, knobs, drain) on slice (a)'s parity config. NaN
# corruption (corrupt_scale 0) with crashes runs under the guard: an
# included NaN row reaches K1 / K2 / K3 and the round is skipped; NaN rows
# that are all lost or gated out must leave the aggregate finite (seed 3:
# rounds 0, 2, 4 and 5 have an included NaN row, rounds 1 and 3 only
# excluded ones). The int8 wire maps a NaN row to zeros before the kernel
# (its row scale falls back to 1 and NaN converts to the integer 0, in the
# reference as here): no skip, and the error-feedback rows must not take
# the NaN residual
H1_NAN = dict(failure_model="chaos", crash_rate=0.3, corrupt_rate=0.2,
              corrupt_scale=0.0, divergence_guard=True, seed=3)
H1_RUNS = [
    ("fifo_d2", "scan_async", dict(async_depth=2, staleness_decay=0.7),
     False),
    ("ready_d3_adaptive_momentum", "scan_async",
     dict(async_depth=3, async_mode="ready", min_lag=1, staleness_decay=0.9,
          adaptive_staleness=True, sketch_dim=64, server_opt="momentum",
          server_lr=0.5), False),
    ("clock_chaos_guard_drain", "scan_async",
     dict(async_depth=2, async_mode="ready", latency_mode="lognormal",
          round_deadline=2.0, failure_model="chaos", crash_rate=0.2,
          dropout_rate=0.2, dropout_len=2, corrupt_rate=0.1,
          corrupt_scale=0.0, divergence_guard=True), True),
    ("temporal_crash_nan_guard", "scan_temporal", H1_NAN, False),
    ("dp_crash_nan", "vmap_spatial",
     dict(H1_NAN, aggregator="dp", dp_clip=1.0, dp_noise=0.1), False),
    ("trimmed_nan", "vmap_spatial",
     dict(H1_NAN, aggregator="trimmed_mean", trim_frac=0.2), False),
    ("int8_ef_nan", "vmap_spatial",
     dict(H1_NAN, wire_codec="int8", error_feedback=True), False),
]
# the stats a buffer or the fault layer adds, held exactly against the CPU
H_DISCRETE = ("gates", "backlog", "staleness", "applied_valid",
              "inflight_occupancy", "lost_clients", "skipped_nonfinite")
LATENCY_MARGIN = 1e-4


@contextmanager
def round_stats():
    """Record every round's stats dict (as numpy) of the run_federation
    calls inside the block: the simulator's History.log sees them all."""
    import numpy as np
    from repro_torch.core.metrics import History
    from repro_torch.fl import simulator
    rec = []

    class Recording(History):
        def log(self, stats, **kw):
            rec.append({k: np.asarray(v) for k, v in stats.items()})
            return super().log(stats, **kw)

    simulator.History = Recording
    try:
        yield rec
    finally:
        simulator.History = History


@contextmanager
def ef_rows():
    """Record the error-feedback rows after every round of the
    run_federation calls inside the block, copied to the host (one sync a
    round): wraps the round that the simulator builds."""
    from repro_torch.fl import simulator
    from repro_torch.utils import tree_leaves
    make = simulator.make_round_fn
    rec = []

    def recording(*args, **kw):
        round_fn = make(*args, **kw)

        def recorded(*a):
            state, stats = round_fn(*a)
            rec.append([t.detach().cpu().clone()
                        for t in tree_leaves(state.ef_accum)])
            return state, stats
        return recorded

    simulator.make_round_fn = recording
    try:
        yield rec
    finally:
        simulator.make_round_fn = make


# the card's error-feedback rows against the CPU's, as a fraction of the
# row's quantum; at most EF_MAX_FLIPS of the elements may take the other
# int8 code
EF_ROW_RTOL = 1e-2
EF_MAX_FLIPS = 0.01


def ef_rows_agree(fed, dev_rows, cpu_rows, stats, C, corrupt=True):
    """The error-feedback rows of the card's run against the CPU run's,
    round by round. An element agrees within EF_ROW_RTOL of its row's
    quantum (at least twice the row's largest residual), or is a flip of
    its int8 code, where a last-bit difference of x / scale crossed a
    rounding boundary: a residual r near +-q/2 becomes r -+ q, so the two
    are opposite within the same bound. A flip moves the aggregate, so
    the two runs go on from different params: the rows are compared up to
    the first round with a flip. Every corrupted (NaN) client's row must
    keep its previous value bit for bit, in both runs, every round (with
    ``corrupt``: a run with no corruption fault skips that part).
    Returns (problems, summary)."""
    import numpy as np
    import torch
    from repro_torch.fl import engine
    problems, flips, total, worst, sent = [], 0, 0, 0.0, 0
    prev_d = prev_c = None
    compared = 0
    for r, (dv, cv, st) in enumerate(zip(dev_rows, cpu_rows, stats)):
        compared += int(flips == 0)
        if not all(bool(torch.isfinite(t).all()) for t in dv):
            problems.append(f"round {r}: non-finite rows")
        for a, b in zip(dv, cv) if flips == 0 else ():
            a = a.reshape(C, -1).double().numpy()
            b = b.reshape(C, -1).double().numpy()
            q = 2 * np.abs(b).max(axis=1, keepdims=True)
            tol = EF_ROW_RTOL * q
            same = np.abs(a - b) <= tol
            flip = ~same & (np.abs(a + b) <= tol)
            if not (same | flip).all():
                problems.append(f"round {r}: rows off the CPU's")
            flips += int(flip.sum())
            total += a.size
            ratio = np.abs(a - b) / np.maximum(q, 1e-30)
            worst = max(worst, float(np.where(same, ratio, 0.0).max()))
        if not corrupt:
            continue
        prev_d = prev_d or [torch.zeros_like(t) for t in dv]
        prev_c = prev_c or [torch.zeros_like(t) for t in cv]
        bad = engine.failure_plan(fed, r, C).corrupt.numpy()
        sent += int((bad & (np.asarray(st["gates"]) > 0)).sum())
        for c in np.flatnonzero(bad):
            for new, old in zip(dv + cv, prev_d + prev_c):
                if not torch.equal(new[c], old[c]):
                    problems.append(f"round {r}: NaN client {c}'s row moved")
        prev_d, prev_c = dv, cv
    if flips > EF_MAX_FLIPS * total:
        problems.append(f"{flips} of {total} elements flipped")
    if corrupt and sent == 0:
        problems.append("no NaN row was transmitted")
    return problems, dict(ef_max_rel_to_quantum=worst, ef_flips=flips,
                          ef_elements=total, ef_rounds_compared=compared,
                          ef_nan_rows_sent=sent)


def latency_margin(fed, C):
    """The completion times' least distance to an integer up to
    ceil(deadline) or to the deadline, where a ceiling or a comparison
    would flip."""
    import math
    from repro_torch.fl import engine
    lat = engine.client_latency(engine.init_latency(fed, C)).tolist()
    d = float(fed.round_deadline)
    marks = list(range(1, math.ceil(d) + 1)) + [d]
    return min(abs(x - m) for x in lat for m in marks)


def nan_rows(fed, stats, C):
    """(rounds where a corrupted NaN row was included, rounds where NaN
    rows were all lost or gated out) by the recorded effective gates."""
    import numpy as np
    from repro_torch.fl import engine
    inc, masked = [], []
    for r, st in enumerate(stats):
        plan = engine.failure_plan(fed, r, C)
        if plan is None or plan.corrupt is None:
            continue
        bad = plan.corrupt.numpy()
        g = np.asarray(st["gates"]) > 0
        if (bad & g).any():
            inc.append(r)
        elif bad.any():
            masked.append(r)
    return inc, masked


def slice_h1(check: Check, expected: TrainExpected, device="cuda"):
    """The asynchronous round and the fault layer on the card against the
    CPU, on slice (a)'s parity config (the shortened quickstart: SYNTH,
    4 + 4 clients, ``synth_logreg``, E = 2, 6 rounds), under each of
    H1_RUNS: the discrete stats (H_DISCRETE) exactly, global loss within
    rtol 1e-5 and params within 1e-4 max|p| of the CPU run (no int8 run
    is held to that bound: a one-quantum flip of its wire moves them), one
    fedagg launch a round (the drain makes none). NaN rows: every round
    with an included corrupted client is skipped by the guard, every round
    whose corrupted clients were all lost or gated out is not (K1, K2, K3
    keep the aggregate finite), and the int8 run's error-feedback rows
    agree with the CPU run's every round (``ef_rows_agree``), a NaN
    client's row unmoved. The latency margins of the clocked run are
    checked."""
    import numpy as np
    import torch
    from repro_torch.data.synth import make_synth_federation
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    small = make_synth_federation(seed=0, n_priority=4, n_nonpriority=4,
                                  samples_per_client=40, test_samples=200)
    gen = torch.Generator().manual_seed(42)
    p0 = {"b": 0.05 * torch.randn(10, generator=gen),
          "w": 0.05 * torch.randn(60, 10, generator=gen)}
    C = 8
    out, masked_rounds = {}, 0
    before_v = dict(fk.fedagg.variant_launches)
    for label, backend, knobs, drain in H1_RUNS:
        name = f"slice (h1) {label}"
        fed = parity_config().replace(backend=backend, **knobs)
        if fed.latency_mode != "none":
            margin = latency_margin(fed, C)
            check(margin > LATENCY_MARGIN, f"{name}: latency margin {margin}")
        ef_on = fed.error_feedback and fed.wire_codec != "identity"
        rows = ef_rows if ef_on else nullcontext
        with round_stats() as rec_cpu, rows() as ef_cpu:
            cpu = run_federation(loss_fn, p0, fed, small, eval_every=2,
                                 drain_inflight=drain, device="cpu")
        before = fk.fedagg.launches
        t0 = time.perf_counter()
        with round_stats() as rec_dev, rows() as ef_dev:
            dev = run_federation(loss_fn, p0, fed, small, eval_every=2,
                                 drain_inflight=drain, device=device)
        secs = time.perf_counter() - t0
        launches = fk.fedagg.launches - before
        same = len(rec_dev) == len(rec_cpu) and all(
            sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in H_DISCRETE if k in b)
            for a, b in zip(rec_dev, rec_cpu))
        check(same, f"{name}: discrete stats differ from the CPU run")
        loss_rel = float(np.max(np.abs(np.array(dev.global_loss)
                                       / np.array(cpu.global_loss) - 1.0)))
        rel = max(float((dev.params[k].cpu() - cpu.params[k]).abs().max()
                        / cpu.params[k].abs().max()) for k in cpu.params)
        if fed.wire_codec != "int8":
            check(loss_rel <= 1e-5, f"{name}: global loss off the CPU run "
                  f"by rtol {loss_rel}")
            check(rel <= 1e-4, f"{name}: params off the CPU run by {rel} x "
                  "max|p|")
        check(all(bool(torch.isfinite(v).all()) for v in dev.params.values()),
              f"{name}: non-finite params")
        if device != "cpu":
            check(launches == fed.rounds, f"{name}: {launches} fedagg "
                  f"launches in {fed.rounds} rounds")
        expected["fedagg"] += fed.rounds
        row = dict(seconds=secs, launches=launches,
                   global_loss_rtol_vs_cpu=loss_rel,
                   params_rel_err_vs_cpu=rel, included=dev.included)
        for k in H_DISCRETE[2:]:
            if k in rec_dev[0]:
                row[k] = [float(st[k]) for st in rec_dev]
        if fed.failure_model in ("corrupt", "chaos") and fed.corrupt_rate > 0:
            inc, masked = nan_rows(fed, rec_dev, C)
            skipped = [r for r, st in enumerate(rec_dev)
                       if int(st["skipped_nonfinite"]) > 0]
            want = [] if fed.wire_codec == "int8" else inc
            check(skipped == want and len(inc) > 0, f"{name}: guard skipped "
                  f"rounds {skipped}, included NaN rows in rounds {inc}")
            if fed.wire_codec != "int8":
                masked_rounds += len(masked)
            row.update(nan_included_rounds=inc, nan_masked_rounds=masked)
        if ef_on:
            problems, summary = ef_rows_agree(fed, ef_dev, ef_cpu, rec_dev,
                                              C)
            check(not problems, f"{name}: error-feedback rows: "
                  + "; ".join(problems[:5]))
            row.update(summary)
        if drain:
            check(float(dev.state.inflight["valid"].sum()) == 0.0,
                  f"{name}: the buffer is not empty after the drain")
        out[label] = row
        print(f"{name}:", json.dumps(row), flush=True)
    check(masked_rounds > 0, "slice (h1): no round had a NaN row that was "
          "lost or gated out")
    variants = {f"{k[0]}/{k[1]}": v - before_v.get(k, 0)
                for k, v in sorted(fk.fedagg.variant_launches.items())
                if v - before_v.get(k, 0)}
    print("slice (h1) fedagg launches per (aggregator, codec):",
          json.dumps(variants), flush=True)
    out["launches_by_variant"] = variants
    return out


def h2_config(rounds):
    """Cell (b) through the asynchronous round with the event clock and
    crash + drop-out faults."""
    return cifar_config(rounds).replace(
        backend="scan_async", async_depth=2, async_mode="ready", min_lag=1,
        staleness_decay=0.8, latency_mode="lognormal", round_deadline=2.0,
        failure_model="chaos", crash_rate=0.1, dropout_rate=0.1,
        corrupt_rate=0.0)


H2_ROUNDS = 3
H2_NAN = dict(failure_model="corrupt", corrupt_rate=0.1, corrupt_scale=0.0,
              divergence_guard=True)


def slice_h2(check: Check, expected: TrainExpected, fedn, b_row,
             device="cuda"):
    """Cell (b) (the full-width cnn on the CIFAR stand-in, C = 60, E = 5)
    under ``h2_config``: H2_ROUNDS rounds and a drain through
    run_federation, s/round beside slice (b)'s, the per-round lost
    clients, staleness, pops and occupancy; checks that a client was lost,
    the buffer is empty after the drain, and fedagg made one launch a
    round (none in the drain). Then one synchronous round of cell (b)
    under NaN corruption (priority client 1 is hit) and the guard: one
    launch, one skip, params bit-identical to the initial ones."""
    import torch
    from repro_torch.fl import engine
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS["cnn"]
    loss_fn = make_loss_fn(apply_fn)
    p0 = init_fn(0, device)
    fed = h2_config(H2_ROUNDS)
    before = fk.fedagg.launches
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()    # (h2)'s own peak
    t0 = time.perf_counter()
    with round_stats() as rec:
        h = run_federation(loss_fn, p0, fed, fedn, eval_every=1,
                           drain_inflight=True, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fk.fedagg.launches - before
    lost = [float(st["lost_clients"]) for st in rec]
    check(sum(lost) > 0, "slice (h2): no client was lost")
    check(float(h.state.inflight["valid"].sum()) == 0.0,
          "slice (h2): the buffer is not empty after the drain")
    check(all(bool(torch.isfinite(v).all()) for v in h.params.values()),
          "slice (h2): non-finite params")
    if device != "cpu":
        check(launches == H2_ROUNDS, f"slice (h2): {launches} fedagg "
              f"launches in {H2_ROUNDS} rounds and a drain")
    expected["fedagg"] += H2_ROUNDS
    row = dict(rounds=H2_ROUNDS, seconds_per_round=secs / H2_ROUNDS,
               b_seconds_per_round=b_row["seconds_per_round"],
               launches=launches, lost_clients=lost,
               staleness=[int(st["staleness"]) for st in rec],
               applied_valid=[float(st["applied_valid"]) for st in rec],
               inflight_occupancy=[float(st["inflight_occupancy"])
                                   for st in rec],
               included_nonpriority=h.included, test_acc=h.test_acc)
    nan_fed = cifar_config(1).replace(**H2_NAN)
    check(bool(engine.failure_plan(nan_fed, 0, fedn.x.shape[0]).corrupt[
        :nan_fed.num_priority].any()), "slice (h2): no priority client is "
        "corrupted in the guarded round")
    before = fk.fedagg.launches
    with round_stats() as rec:
        g = run_federation(loss_fn, p0, nan_fed, fedn, device=device)
    launches = fk.fedagg.launches - before
    same = all(torch.equal(g.params[k], p0[k]) for k in p0)
    check(same, "slice (h2): the guarded round moved the params")
    check(int(rec[0]["skipped_nonfinite"]) == 1,
          "slice (h2): the guard did not skip the NaN round")
    if device != "cpu":
        check(launches == 1, f"slice (h2): {launches} fedagg launches in "
              "the guarded round")
    expected["fedagg"] += 1
    row["guarded_round"] = dict(launches=launches, params_bit_identical=same,
                                skipped_nonfinite=int(rec[0]["skipped_nonfinite"]))
    if device != "cpu":
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("slice (h2) cnn async + faults:", json.dumps(row), flush=True)
    return row


# (h3): (f2)'s round through scan_async with the clock, crashes and guard
H3 = dict(clients=8, n_priority=4, per_client=8, seq=512, local_epochs=2,
          lr=0.05, backend="scan_async", async_depth=2, async_mode="ready",
          latency_mode="lognormal", round_deadline=2.0, failure_model="crash",
          crash_rate=0.25, divergence_guard=True)
H3_ROUNDS = 3


def slice_h3(check: Check, expected: TrainExpected, f2_row, device="cuda"):
    """Full width: qwen1.5-0.5b (random init, f32 params, bf16 compute,
    remat) through launch.train.run's spatial round under H3: the
    variable-lag buffer (D = 2 slots of 1.86 GB), the lognormal clock with
    deadline 2.0, crash 0.25, the guard; 3 rounds. Lost clients still
    train in the spatial round, so K5 / K6 / K9 launch as (f2)'s rounds
    and fedagg once a round. s/round, each round's peak GB (beside
    (f2)'s), the lost clients a round."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils import param_count, tree_leaves
    cfg = get_config("qwen1.5-0.5b")
    torch.cuda.empty_cache()
    before = train_counts()
    with lm_rounds() as rec:
        params, hist = train.run(arch="qwen1.5-0.5b", smoke=False,
                                 rounds=H3_ROUNDS, device=device,
                                 verbose=False, **H3)
    expected.add_rounds(cfg, H3["clients"], H3["local_epochs"], H3_ROUNDS)
    launches = {k: v - before[k] for k, v in train_counts().items()}
    want = TrainExpected()
    want.add_rounds(cfg, H3["clients"], H3["local_epochs"], H3_ROUNDS)
    check(launches == want, f"slice (h3): launches {launches}, expected {want}")
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    check(finite and all(math.isfinite(h["server_loss"]) for h in hist),
          "slice (h3): non-finite params or server loss")
    check(sum(h["lost_clients"] for h in hist) > 0,
          "slice (h3): no client was lost")
    timed = [h["sec"] for h in hist[1:]]
    row = dict(params=param_count(params), rounds=H3_ROUNDS,
               warmup_round_s=hist[0]["sec"], round_s=timed,
               s_per_round=sum(timed) / len(timed),
               f2_s_per_round=f2_row["s_per_round"],
               round_peak_gb=rec["peak_gb"], f2_peak_gb=f2_row["peak_gb"],
               lost_clients=[h["lost_clients"] for h in hist],
               skipped_nonfinite=[h["skipped_nonfinite"] for h in hist],
               server_loss=[h["server_loss"] for h in hist],
               gates=[h["gates"] for h in hist], launches=launches)
    print("slice (h3) qwen1.5-0.5b async + faults:", json.dumps(row),
          flush=True)
    del params
    torch.cuda.empty_cache()
    return row


# (h4): the temporal round at smoke size, fifo D = 1, crash + drop-out
H4 = dict(local_epochs=2, lr=0.05, epsilon=0.1, async_depth=1,
          failure_model="chaos", crash_rate=0.3, dropout_rate=0.3,
          dropout_len=2, corrupt_rate=0.0)
H4_RUN = dict(clients=4, n_priority=2, per_client=2, seq=32, rounds=2)
H4_TOL = 2e-5


def slice_h4(check: Check, expected: TrainExpected, device="cuda"):
    """The temporal round (smoke qwen1.5-0.5b, f32) under H4 on the card
    and on the CPU from the same init and batches: gates, lost clients and
    backlog exactly, after checking every gate decision lies farther than
    GATE_MARGIN from eps; params within H4_TOL x max(1, max|p|), leaf for
    leaf. Launches: 1 + C no-grad forwards a round and E steps for each
    client that is neither gated out nor lost; no fedagg."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.tokens import make_token_federation
    from repro_torch.fl import engine, sharded
    from repro_torch.launch.train import build_batches
    from repro_torch.models import get_model
    from repro_torch.utils import tree_leaves
    cfg = get_smoke("qwen1.5-0.5b")
    model = get_model(cfg)
    C, P = H4_RUN["clients"], H4_RUN["n_priority"]
    fed = FedConfig(num_clients=C, num_priority=P, **H4)
    data = make_token_federation(seed=0, vocab=cfg.vocab_size, n_clients=C,
                                 n_priority=P, seq_len=H4_RUN["seq"],
                                 tokens_per_client=(H4_RUN["seq"] + 1) * 8)

    def rounds(dev):
        step = sharded.make_round_step(model, fed, C, fsdp=True, device=dev)
        state = engine.init_state(model.init(prng.PRNGKey(0), device=dev),
                                  fed, C)
        rng = np.random.default_rng(0)
        stats = []
        for r in range(H4_RUN["rounds"]):
            batch = build_batches(cfg, data, clients=C,
                                  per_client=H4_RUN["per_client"],
                                  seq=H4_RUN["seq"], rng=rng, device=dev)
            state, st = step(state, batch, r)
            stats.append({k: v.cpu().numpy() for k, v in st.items()})
        return state, stats

    cpu_state, cpu_stats = rounds("cpu")
    before = train_counts()
    dev_state, dev_stats = rounds(device)
    launches = {k: v - before[k] for k, v in train_counts().items()}
    margin = min(abs(abs(float(l) - float(st["server_loss"])) - fed.epsilon)
                 for st in cpu_stats for l in st["local_losses"][P:])
    check(margin > GATE_MARGIN, f"slice (h4): gate margin {margin}")
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(dev_stats, cpu_stats)
               for k in ("gates", "backlog", "lost_clients", "staleness",
                         "applied_valid", "inflight_occupancy"))
    check(same, "slice (h4): gates, lost clients, backlog or buffer stats "
          "differ from the CPU run")
    err = max(float(torch.max(torch.abs(a.cpu() - b)))
              / max(1.0, float(torch.max(torch.abs(b))))
              for a, b in zip(tree_leaves(dev_state.params),
                              tree_leaves(cpu_state.params)))
    check(err <= H4_TOL, f"slice (h4): params off the CPU run by {err}")
    want = TrainExpected()
    for st in dev_stats:
        want.add_rounds(cfg, C, fed.local_epochs, 1,
                        trained=int((st["gates"] > 0).sum()), fedagg=False)
    for k, v in want.items():
        expected[k] += v
    if device != "cpu":
        check(launches == want, f"slice (h4): launches {launches}, expected "
              f"{want}")
    row = dict(gate_margin=margin, params_rel_err_vs_cpu=err,
               gates=[st["gates"].tolist() for st in dev_stats],
               lost_clients=[float(st["lost_clients"]) for st in dev_stats],
               backlog=[st["backlog"].tolist() for st in dev_stats],
               launches=launches)
    print("slice (h4) temporal round, fifo D = 1 + faults:", json.dumps(row),
          flush=True)
    return row


# ------------------------------------------------------------- slice (i)
# (i1): tests/test_pool.py's federation (SYNTH seed 11, 3 priority + 9
# non-priority clients, 64 samples) and its knobs, P = 6
POOL_FEDN = dict(seed=11, n_priority=3, n_nonpriority=9, samples_per_client=64)
POOL_BASE = dict(num_clients=12, num_priority=3, rounds=6, local_epochs=1,
                 epsilon=0.5, warmup_frac=0.0, align_stat="loss",
                 candidate_pool=6)
I1_RUNS = [
    ("uniform_vmap_spatial", dict()),
    ("backlog_cohort4_momentum_scan_temporal", dict(
        pool_weighting="backlog", max_cohort=4, epsilon=1.0,
        backlog_boost=0.1, server_opt="momentum", server_lr=0.5,
        backend="scan_temporal")),
    ("ema_welfare_participation", dict(
        pool_weighting="ema", selection="welfare", welfare_floor=0.3,
        participation=0.5)),
    ("async_ready_clock_chaos", dict(
        backend="scan_async", async_depth=2, async_mode="ready",
        latency_mode="lognormal", round_deadline=2.0, failure_model="chaos",
        crash_rate=0.2, dropout_rate=0.2, dropout_len=2, corrupt_rate=0.2,
        corrupt_scale=3.0)),
    ("dp_crash", dict(aggregator="dp", dp_clip=0.5, dp_noise=0.1,
                      failure_model="crash", crash_rate=0.3)),
    ("median_int8_ef", dict(aggregator="median", wire_codec="int8",
                            error_feedback=True)),
]
# the stats a pool round adds or scatters, held exactly against the CPU
I_DISCRETE = ("pool_idx",) + H_DISCRETE
POOL_MARGIN = 1e-4
PER_CLIENT = ("backlog", "util_ema", "incl_ema", "ef_accum")


@contextmanager
def pool_rounds():
    """Record every pool round of the run_federation calls inside the
    block: its key, its pool, the backlog and inclusion EMA it started
    from and the error-feedback rows it ended with (on the host), and
    every (round, leaf) whose out-of-pool rows moved (``moved``: the
    per-client leaves are compared on their device, bit for bit)."""
    import torch
    from repro_torch.fl import simulator
    from repro_torch.utils import tree_leaves
    make = simulator.make_round_fn
    rec = {"rounds": [], "moved": []}

    def recording(*args, **kw):
        round_fn = make(*args, **kw)

        def recorded(state, data, pm, w, rng, r):
            before = {n: [t.clone() for t in tree_leaves(getattr(state, n))]
                      for n in PER_CLIENT}
            state, stats = round_fn(state, data, pm, w, rng, r)
            idx = stats["pool_idx"]
            out = torch.ones(pm.shape[0], dtype=torch.bool, device=idx.device)
            out[idx] = False
            for n in PER_CLIENT:
                for a, b in zip(tree_leaves(getattr(state, n)), before[n]):
                    if not torch.equal(a[out], b[out]):
                        rec["moved"].append((int(r), n))
            rec["rounds"].append(dict(
                key=torch.as_tensor(rng).cpu(), pool_idx=idx.cpu(),
                backlog=before["backlog"][0].cpu(),
                incl_ema=before["incl_ema"][0].cpu(),
                ef=[t.detach().cpu().clone()
                    for t in tree_leaves(state.ef_accum)]))
            return state, stats
        return recorded

    simulator.make_round_fn = recording
    try:
        yield rec
    finally:
        simulator.make_round_fn = make


def pool_margin(fed, key, pm, backlog, incl_ema):
    """The gap between the P-th and (P+1)-th largest finite pool scores of
    a round with round key ``key`` (the pool key is split off it first),
    recomputed on the host as ``engine.pool_select`` scores them."""
    import torch
    from repro_torch import prng
    g = prng.gumbel(prng.split(key)[1], (pm.shape[0],))
    if fed.pool_weighting == "backlog":
        g = g + torch.log1p(backlog.float())
    elif fed.pool_weighting == "ema":
        g = g + torch.log(torch.clamp(1.0 + 1e-6 - incl_ema.float(),
                                      min=1e-6))
    pm = torch.as_tensor(pm).cpu().bool()
    finite = torch.sort(g[~pm], descending=True).values
    k = int(fed.candidate_pool) - int(pm.sum())
    return float(finite[k - 1] - finite[k])


@contextmanager
def fedagg_rows():
    """The client rows of every fedagg call inside the block."""
    from repro_torch.kernels import ops
    call, rows = ops.fedagg, []

    def recording(updates, *a, **k):
        rows.append(int(updates.shape[0]))
        return call(updates, *a, **k)

    ops.fedagg = recording
    try:
        yield rows
    finally:
        ops.fedagg = call


def pool_params0():
    import torch
    gen = torch.Generator().manual_seed(42)
    return {"b": 0.05 * torch.randn(10, generator=gen),
            "w": 0.05 * torch.randn(60, 10, generator=gen)}


def pool_run(fed, fedn, device, **kw):
    """run_federation of ``synth_logreg`` from ``pool_params0``, every
    round's stats and pool recorded: (history, stats, pool rounds)."""
    from repro_torch.fl.simulator import run_federation
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    with round_stats() as stats, pool_rounds() as pools:
        h = run_federation(loss_fn, pool_params0(), fed, fedn, device=device,
                           **kw)
    return h, stats, pools


def slice_i1(check: Check, expected: TrainExpected, device="cuda"):
    """Candidate pools on the card against the CPU, on tests/test_pool.py's
    federation and P = 6 under each of I1_RUNS (6 rounds): the pool, the
    gates, the lost clients, the backlog and every other buffer or fault
    stat exactly, after checking that in every round the P-th and
    (P+1)-th largest finite pool scores differ by more than POOL_MARGIN;
    global loss within rtol 1e-5 and params within 1e-4 max|p| of the CPU
    run (not for int8: a one-quantum flip of its wire moves them), the
    int8 run's error-feedback rows as (h1) holds them; every out-of-pool
    row of backlog, util_ema, incl_ema and ef_accum bit-identical across
    each round, on the card and on the CPU; one fedagg launch a round."""
    import numpy as np
    import torch
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synth import make_synth_federation
    from repro_torch.kernels import fedagg as fk
    fedn = make_synth_federation(**POOL_FEDN)
    pm = torch.from_numpy(np.asarray(fedn.priority_mask, bool))
    C = pm.shape[0]
    out = {}
    before_v = dict(fk.fedagg.variant_launches)
    for label, knobs in I1_RUNS:
        name = f"slice (i1) {label}"
        fed = FedConfig(**dict(POOL_BASE, **knobs))
        if fed.latency_mode != "none":
            margin = latency_margin(fed, C)
            check(margin > LATENCY_MARGIN, f"{name}: latency margin {margin}")
        cpu, rec_cpu, pools_cpu = pool_run(fed, fedn, "cpu", eval_every=2)
        before = fk.fedagg.launches
        t0 = time.perf_counter()
        dev, rec_dev, pools_dev = pool_run(fed, fedn, device, eval_every=2)
        secs = time.perf_counter() - t0
        launches = fk.fedagg.launches - before
        margins = [pool_margin(fed, p["key"], pm, p["backlog"], p["incl_ema"])
                   for p in pools_cpu["rounds"]]
        check(min(margins) > POOL_MARGIN, f"{name}: pool margin "
              f"{min(margins)}")
        same = len(rec_dev) == len(rec_cpu) == fed.rounds and all(
            sorted(a) == sorted(b) and all(
                np.array_equal(a[k], b[k]) for k in I_DISCRETE if k in b)
            for a, b in zip(rec_dev, rec_cpu))
        check(same, f"{name}: discrete stats differ from the CPU run")
        check(all(set(range(3)) <= set(st["pool_idx"].tolist())
                  for st in rec_dev), f"{name}: a priority client out of "
              "the pool")
        check(not pools_dev["moved"] and not pools_cpu["moved"],
              f"{name}: out-of-pool rows moved: {pools_dev['moved'][:4]} "
              f"{pools_cpu['moved'][:4]}")
        loss_rel = float(np.max(np.abs(np.array(dev.global_loss)
                                       / np.array(cpu.global_loss) - 1.0)))
        rel = max(float((dev.params[k].cpu() - cpu.params[k]).abs().max()
                        / cpu.params[k].abs().max()) for k in cpu.params)
        if fed.wire_codec != "int8":
            check(loss_rel <= 1e-5, f"{name}: global loss off the CPU run "
                  f"by rtol {loss_rel}")
            check(rel <= 1e-4, f"{name}: params off the CPU run by {rel} x "
                  "max|p|")
        check(all(bool(torch.isfinite(v).all()) for v in dev.params.values()),
              f"{name}: non-finite params")
        if device != "cpu":
            check(launches == fed.rounds, f"{name}: {launches} fedagg "
                  f"launches in {fed.rounds} rounds")
        expected["fedagg"] += fed.rounds
        row = dict(seconds=secs, launches=launches, min_pool_margin=min(margins),
                   global_loss_rtol_vs_cpu=loss_rel,
                   params_rel_err_vs_cpu=rel, included=dev.included,
                   pool_idx=[st["pool_idx"].tolist() for st in rec_dev])
        if "lost_clients" in rec_dev[0]:
            row["lost_clients"] = [float(st["lost_clients"]) for st in rec_dev]
        if fed.wire_codec == "int8":
            problems, summary = ef_rows_agree(
                fed, [p["ef"] for p in pools_dev["rounds"]],
                [p["ef"] for p in pools_cpu["rounds"]], rec_dev, C,
                corrupt=False)
            check(not problems, f"{name}: error-feedback rows: "
                  + "; ".join(problems[:5]))
            row.update(summary)
        out[label] = row
        print(f"{name}:", json.dumps(row), flush=True)
    variants = {f"{k[0]}/{k[1]}": v - before_v.get(k, 0)
                for k, v in sorted(fk.fedagg.variant_launches.items())
                if v - before_v.get(k, 0)}
    print("slice (i1) fedagg launches per (aggregator, codec):",
          json.dumps(variants), flush=True)
    out["launches_by_variant"] = variants
    return out


I2_ROUNDS = 3


def slice_i2(check: Check, expected: TrainExpected, fedn, b_row,
             device="cuda"):
    """Cell (b) (the full-width cnn on the CIFAR stand-in, C = 60, E = 5)
    with a candidate pool of 20 (the 2 priority clients and 18 sampled)
    under backlog weighting, I2_ROUNDS rounds through run_federation:
    s/round beside slice (b)'s and the run's own peak GB; checks that
    priority is in every pool, that fedagg made one launch a round over
    20 rows, and that every out-of-pool row is untouched."""
    import torch
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS["cnn"]
    loss_fn = make_loss_fn(apply_fn)
    p0 = init_fn(0, device)
    fed = cifar_config(I2_ROUNDS).replace(candidate_pool=20,
                                          pool_weighting="backlog")
    before = fk.fedagg.launches
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with round_stats() as rec, pool_rounds() as pools, fedagg_rows() as rows:
        h = run_federation(loss_fn, p0, fed, fedn, eval_every=1,
                           device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fk.fedagg.launches - before
    pool_idx = [st["pool_idx"].tolist() for st in rec]
    check(all(len(p) == 20 and {0, 1} <= set(p) for p in pool_idx),
          f"slice (i2): pools {pool_idx}")
    check(rows == [20] * I2_ROUNDS, f"slice (i2): fedagg rows {rows}")
    check(not pools["moved"], f"slice (i2): out-of-pool rows moved: "
          f"{pools['moved'][:4]}")
    check(all(bool(torch.isfinite(v).all()) for v in h.params.values()),
          "slice (i2): non-finite params")
    if device != "cpu":
        check(launches == I2_ROUNDS, f"slice (i2): {launches} fedagg "
              f"launches in {I2_ROUNDS} rounds")
    expected["fedagg"] += I2_ROUNDS
    row = dict(rounds=I2_ROUNDS, pool=20, seconds_per_round=secs / I2_ROUNDS,
               b_seconds_per_round=b_row["seconds_per_round"],
               launches=launches, fedagg_rows=rows, pool_idx=pool_idx,
               backlog_max=[int(st["backlog"].max()) for st in rec],
               included_nonpriority=h.included, test_acc=h.test_acc)
    if device != "cpu":
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("slice (i2) cnn, a pool of 20 of 60:", json.dumps(row), flush=True)
    return row


I3_ROUNDS = 5
I3_POOL = 20


def tiled_federation(fedn, clients):
    """``fedn``'s priority clients (the first ones) beside its
    non-priority clients repeated cyclically up to ``clients`` clients in
    all (each copy keeps its weight)."""
    import numpy as np
    from repro_torch.data.synth import Federation
    pm = np.asarray(fedn.priority_mask, bool)
    P = int(pm.sum())
    rest = P + np.arange(clients - P) % (len(pm) - P)

    def tile(a):
        return np.concatenate([a[:P], a[rest]])
    return Federation(x=tile(fedn.x), y=tile(fedn.y),
                      priority_mask=tile(pm), weights=tile(fedn.weights),
                      test_x=fedn.test_x, test_y=fedn.test_y)


def timed_rounds(fed, fedn, rounds, device):
    """``rounds`` rounds of ``make_round_fn`` on the federation's tensors
    on ``device`` (the quickstart's ``synth_logreg`` init), each timed on
    the host clock after a sync: (seconds a round, the last stats)."""
    import torch
    from repro_torch import prng
    from repro_torch.fl import engine
    from repro_torch.fl.simulator import federation_tensors
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS["synth_logreg"]
    data, pm, w = federation_tensors(fedn, device)
    round_fn = engine.make_round_fn(make_loss_fn(apply_fn), fed)
    state = engine.init_state(init_fn(42, device), fed, pm.shape[0])
    rng = prng.PRNGKey(fed.seed)
    times = []
    for r in range(rounds):
        rng, rkey = prng.split(rng)
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = round_fn(state, data, pm, w, rkey, r)
        if device != "cpu":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, stats


def slice_i3(check: Check, expected: TrainExpected, device="cuda"):
    """Population scale: the quickstart's knobs (E = 5, eps 0.2) with a
    pool of 20 (10 priority + 10 sampled), I3_ROUNDS rounds each, at C =
    1,000 (make_synth_federation, 10 + 990 clients of 200 samples) and C =
    10,000 (the same 990 non-priority clients repeated cyclically to 9,990
    beside the 10 priority ones: x [10,000, 200, 60] f32, 0.48 GB on the
    card), each
    round timed after a sync; beside them the dense 10 + 10 quickstart
    (5 rounds) and a dense round at C = 1,000 (the second of two). The
    first round of each run is its warm-up; s/round is the mean of the
    rest. Checks that the pooled round costs less than twice as much at
    C = 10,000 as at C = 1,000, and one fedagg launch a round."""
    import numpy as np
    from repro_torch.data.synth import make_synth_federation
    from repro_torch.kernels import fedagg as fk
    t0 = time.perf_counter()
    f1k = make_synth_federation(seed=0, n_priority=10, n_nonpriority=990,
                                samples_per_client=200)
    gen_s = time.perf_counter() - t0
    f10k = tiled_federation(f1k, 10_000)
    quick = make_synth_federation(seed=0, n_priority=10, n_nonpriority=10,
                                  samples_per_client=200)
    print("slice (i3): the C = 10,000 population is tiled: the C = 1,000 "
          "one's 10 priority clients beside its 990 non-priority clients "
          "repeated cyclically (9,990 rows)", flush=True)
    before = fk.fedagg.launches
    row = dict(data_gen_s=gen_s, x_gb_10k=f10k.x.nbytes / 1e9)
    runs = (("pool20_c1000", f1k, I3_POOL, I3_ROUNDS),
            ("pool20_c10000", f10k, I3_POOL, I3_ROUNDS),
            ("dense_quickstart_c20", quick, 0, I3_ROUNDS),
            ("dense_c1000", f1k, 0, 2))
    for label, fedn, pool, rounds in runs:
        C = int(fedn.x.shape[0])
        fed = quickstart_config(rounds, "vmap_spatial").replace(
            num_clients=C, candidate_pool=pool)
        times, stats = timed_rounds(fed, fedn, rounds, device)
        if pool:
            check(stats["pool_idx"].shape[0] == pool and set(range(10))
                  <= set(stats["pool_idx"].tolist()),
                  f"slice (i3) {label}: pool {stats['pool_idx'].tolist()}")
        row[label] = dict(clients=C, round_s=times,
                          s_per_round=float(np.mean(times[1:])))
        expected["fedagg"] += rounds
    ratio = (row["pool20_c10000"]["s_per_round"]
             / row["pool20_c1000"]["s_per_round"])
    row["c10000_over_c1000"] = ratio
    check(ratio < 2.0, f"slice (i3): a pooled round costs {ratio:.2f}x as "
          "much at C = 10,000 as at C = 1,000")
    launches = fk.fedagg.launches - before
    want = sum(r[3] for r in runs)
    if device != "cpu":
        check(launches == want, f"slice (i3): {launches} fedagg launches, "
              f"expected {want}")
    row["launches"] = launches
    print("slice (i3) population scale:", json.dumps(row), flush=True)
    return row


# (i4): (f2)'s round with 16 clients (4 priority) and a pool of 8
I4 = dict(clients=16, n_priority=4, per_client=8, seq=512, local_epochs=2,
          lr=0.05, candidate_pool=8)
I4_ROUNDS = 2
# the temporal round at smoke size, 6 clients (2 priority), a pool of 4
I4_SMOKE = dict(local_epochs=2, lr=0.05, epsilon=0.1, candidate_pool=4)
I4_SMOKE_RUN = dict(clients=6, n_priority=2, per_client=2, seq=32, rounds=2)
I4_TOL = 2e-5


def slice_i4(check: Check, expected: TrainExpected, f2_row, device="cuda"):
    """Full width: qwen1.5-0.5b (random init, f32 params, bf16 compute,
    remat) through launch.train.run's spatial round under I4: 16 clients
    of which a pool of 8 (the 4 priority) is evaluated and trained a
    round, I4_ROUNDS rounds. K5 / K6 / K9 launch as (f2)'s formula for 8
    clients, fedagg once a round over 8 rows; each round's peak GB beside
    (f2)'s; the pools read from the round step's stats. Then the temporal
    round with a pool of 4 of 6 at smoke size (f32) on the card and on the
    CPU from the same init and batches: pools and gates exactly (every
    gate decision farther than GATE_MARGIN from eps), params within
    I4_TOL x max(1, max|p|); 1 + 4 no-grad forwards a round and E steps
    for each gated-in pool client, no fedagg."""
    import math
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.tokens import make_token_federation
    from repro_torch.fl import engine, sharded
    from repro_torch.launch import train
    from repro_torch.launch.train import build_batches
    from repro_torch.models import get_model
    from repro_torch.utils import param_count, tree_leaves
    cfg = get_config("qwen1.5-0.5b")
    P, E = I4["candidate_pool"], I4["local_epochs"]
    torch.cuda.empty_cache()
    before = train_counts()
    with lm_round_records() as recs, lm_rounds() as rec:
        params, hist = train.run(arch="qwen1.5-0.5b", smoke=False,
                                 rounds=I4_ROUNDS, device=device,
                                 verbose=False, **I4)
    launches = {k: v - before[k] for k, v in train_counts().items()}
    want = TrainExpected()
    want.add_rounds(cfg, P, E, I4_ROUNDS)
    for k, v in want.items():
        expected[k] += v
    check(launches == want, f"slice (i4): launches {launches}, expected {want}")
    check(recs["rows"] == [P] * I4_ROUNDS, f"slice (i4): fedagg rows "
          f"{recs['rows']}")
    check(all(len(p) == P and set(range(I4["n_priority"])) <= set(p)
              for p in recs["pool_idx"]) and len(recs["pool_idx"]) == I4_ROUNDS,
          f"slice (i4): pools {recs['pool_idx']}")
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    check(finite and all(math.isfinite(h["server_loss"]) for h in hist),
          "slice (i4): non-finite params or server loss")
    row = dict(params=param_count(params), clients=I4["clients"], pool=P,
               rounds=I4_ROUNDS, warmup_round_s=hist[0]["sec"],
               round_s=[h["sec"] for h in hist[1:]],
               f2_s_per_round=f2_row["s_per_round"],
               round_peak_gb=rec["peak_gb"], f2_peak_gb=f2_row["peak_gb"],
               pool_idx=recs["pool_idx"], gates=[h["gates"] for h in hist],
               server_loss=[h["server_loss"] for h in hist],
               launches=launches)
    del params
    torch.cuda.empty_cache()

    smoke = get_smoke("qwen1.5-0.5b")
    model = get_model(smoke)
    C, npri = I4_SMOKE_RUN["clients"], I4_SMOKE_RUN["n_priority"]
    fed = FedConfig(num_clients=C, num_priority=npri, **I4_SMOKE)
    data = make_token_federation(seed=0, vocab=smoke.vocab_size, n_clients=C,
                                 n_priority=npri, seq_len=I4_SMOKE_RUN["seq"],
                                 tokens_per_client=(I4_SMOKE_RUN["seq"] + 1) * 8)

    def rounds(dev):
        step = sharded.make_round_step(model, fed, C, fsdp=True, device=dev)
        state = engine.init_state(model.init(prng.PRNGKey(0), device=dev),
                                  fed, C)
        rng = np.random.default_rng(0)
        stats = []
        for r in range(I4_SMOKE_RUN["rounds"]):
            batch = build_batches(smoke, data, clients=C,
                                  per_client=I4_SMOKE_RUN["per_client"],
                                  seq=I4_SMOKE_RUN["seq"], rng=rng, device=dev)
            state, st = step(state, batch, r)
            stats.append({k: v.cpu().numpy() for k, v in st.items()})
        return state, stats

    cpu_state, cpu_stats = rounds("cpu")
    before = train_counts()
    dev_state, dev_stats = rounds(device)
    launches = {k: v - before[k] for k, v in train_counts().items()}
    margin = min(abs(abs(float(st["local_losses"][c]) - float(st["server_loss"]))
                     - fed.epsilon)
                 for st in cpu_stats for c in st["pool_idx"] if c >= npri)
    check(margin > GATE_MARGIN, f"slice (i4) temporal: gate margin {margin}")
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(dev_stats, cpu_stats)
               for k in ("pool_idx", "gates", "backlog"))
    check(same, "slice (i4) temporal: pools, gates or backlog differ from "
          "the CPU run")
    err = max(float(torch.max(torch.abs(a.cpu() - b)))
              / max(1.0, float(torch.max(torch.abs(b))))
              for a, b in zip(tree_leaves(dev_state.params),
                              tree_leaves(cpu_state.params)))
    check(err <= I4_TOL, f"slice (i4) temporal: params off the CPU run by "
          f"{err}")
    want = TrainExpected()
    for st in dev_stats:
        want.add_rounds(smoke, fed.candidate_pool, fed.local_epochs, 1,
                        trained=int((st["gates"] > 0).sum()), fedagg=False)
    for k, v in want.items():
        expected[k] += v
    if device != "cpu":
        check(launches == want, f"slice (i4) temporal: launches {launches}, "
              f"expected {want}")
    row["temporal_smoke"] = dict(
        gate_margin=margin, params_rel_err_vs_cpu=err,
        pool_idx=[st["pool_idx"].tolist() for st in dev_stats],
        gates=[st["gates"].tolist() for st in dev_stats], launches=launches)
    print("slice (i4) qwen1.5-0.5b, a pool of 8 of 16:", json.dumps(row),
          flush=True)
    return row


# (i5): (i1)'s scan_async + chaos config under adam and int8 + EF
I5 = dict(dict(I1_RUNS)["async_ready_clock_chaos"], server_opt="adam",
          server_lr=0.05, wire_codec="int8", error_feedback=True)


def state_leaves(state):
    from repro_torch.checkpoint.io import flatten
    return flatten(state)[0]


def slice_i5(check: Check, expected: TrainExpected, device="cuda"):
    """Checkpoint and resume on the card, under I5 with P = 6: two
    uninterrupted 6-round runs (``checkpoint_path`` on the first) to see
    whether the round is deterministic; a 3-round run whose checkpoint
    (step 3) is loaded and resumed for rounds 3-5, which must equal the
    uninterrupted run bit for bit (where two uninterrupted runs differ,
    each such leaf is named and held to their spread). A checkpoint the
    CPU run wrote loads into the card run (leaf for leaf) and resumes
    there with the CPU run's pools and gates; the card's loads on the CPU
    leaf for leaf. A fingerprint mismatch (``async_mode``,
    ``candidate_pool``) raises. Then cell (b)'s width: a state with int8
    error-feedback rows [60, 579,402] and adam moments, filled with
    random values, saved and loaded on the card, every leaf bit for bit:
    MB written, seconds to save and to load."""
    import numpy as np
    import torch
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.synth import make_synth_federation
    from repro_torch.fl import engine
    from repro_torch.fl.simulator import (load_federation_state,
                                          save_federation_state)
    from repro_torch.models.small import SMALL_MODELS
    from repro_torch.utils import param_count, tree_map
    fedn = make_synth_federation(**POOL_FEDN)
    fed = FedConfig(**dict(POOL_BASE, **I5))
    C = int(fedn.x.shape[0])
    tmp = ROOT / "build" / "checkpoints"
    tmp.mkdir(parents=True, exist_ok=True)
    paths = {k: str(tmp / f"i5_{k}.msgpack")
             for k in ("full", "half", "cpu", "b")}

    def like(dev):
        return engine.init_state(tree_map(lambda p: p.to(dev),
                                          pool_params0()), fed, C)

    full, rec_full, _ = pool_run(fed, fedn, device, eval_every=3,
                                 checkpoint_path=paths["full"])
    again, _, _ = pool_run(fed, fedn, device, eval_every=3)
    a, b = state_leaves(full.state), state_leaves(again.state)
    spread = [float((x.double() - y.double()).abs().max()) if
              x.is_floating_point() else float((x != y).sum())
              for x, y in zip(a, b)]
    deterministic = all(torch.equal(x, y) for x, y in zip(a, b))
    half, _, _ = pool_run(fed.replace(rounds=3), fedn, device, eval_every=3,
                          checkpoint_path=paths["half"])
    check(float(half.state.inflight["valid"].sum()) > 0,
          "slice (i5): no cohort in flight at the checkpoint")
    state, rng, step = load_federation_state(paths["half"], like(device),
                                             fed=fed, device=device)
    resumed, rec_res, _ = pool_run(fed, fedn, device, eval_every=3,
                                   state=state, rng=rng, start_round=step)
    r = state_leaves(resumed.state)
    off = [i for i, (x, y) in enumerate(zip(a, r)) if not torch.equal(x, y)]
    if deterministic:
        check(not off and torch.equal(resumed.rng, full.rng),
              f"slice (i5): the resumed run differs from the uninterrupted "
              f"one in leaves {off}")
    else:
        print(f"slice (i5): two uninterrupted runs differ in leaves "
              f"{[i for i, s in enumerate(spread) if s]}", flush=True)
        worse = [i for i in off if float((a[i].double() - r[i].double())
                                         .abs().max()) > spread[i]]
        check(not worse, f"slice (i5): resumed leaves {worse} differ from "
              "the uninterrupted run by more than two such runs do")
    check(all(np.array_equal(x["pool_idx"], y["pool_idx"])
              and np.array_equal(x["gates"], y["gates"])
              for x, y in zip(rec_full[step:], rec_res)),
          "slice (i5): the resumed run's pools or gates differ")
    # the CPU's file on the card, and the card's on the CPU
    cpu_full, rec_cpu, _ = pool_run(fed, fedn, "cpu", eval_every=3)
    cpu_half, _, _ = pool_run(fed.replace(rounds=3), fedn, "cpu",
                              eval_every=3, checkpoint_path=paths["cpu"])
    state, rng, step = load_federation_state(paths["cpu"], like(device),
                                             fed=fed, device=device)
    loaded = all(torch.equal(x.cpu(), y) for x, y in
                 zip(state_leaves(state), state_leaves(cpu_half.state)))
    check(loaded, "slice (i5): the CPU's checkpoint changed on the card")
    _, rec_x, _ = pool_run(fed, fedn, device, eval_every=3, state=state,
                           rng=rng, start_round=step)
    check(all(np.array_equal(x["pool_idx"], y["pool_idx"])
              and np.array_equal(x["gates"], y["gates"])
              for x, y in zip(rec_cpu[step:], rec_x)),
          "slice (i5): the card run resumed from the CPU's checkpoint has "
          "other pools or gates than the CPU run")
    state, _, _ = load_federation_state(paths["half"], like("cpu"), fed=fed,
                                        device="cpu")
    check(all(torch.equal(x, y.cpu()) for x, y in
              zip(state_leaves(state), state_leaves(half.state))),
          "slice (i5): the card's checkpoint changed on the CPU")
    raised = []
    for kw in (dict(async_mode="fifo"), dict(candidate_pool=0)):
        try:
            load_federation_state(paths["half"], like(device),
                                  fed=fed.replace(**kw), device=device)
        except ValueError as exc:
            raised.append(next(iter(kw)) in str(exc))
    check(raised == [True, True], f"slice (i5): fingerprint checks {raised}")
    card_rounds = 2 * fed.rounds + 3 + 3 + 3
    expected["fedagg"] += card_rounds
    # cell (b)'s width: int8 error-feedback rows and adam moments
    init_fn = SMALL_MODELS["cnn"][0]
    bfed = cifar_config(1).replace(server_opt="adam", wire_codec="int8",
                                   error_feedback=True)
    gen = torch.Generator(device=device).manual_seed(0)
    big = engine.init_state(init_fn(0, device), bfed, 60)
    for t in state_leaves(big):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen, device=device))
    big.opt_state["t"].fill_(7)
    rng = torch.tensor([12345, 678], dtype=torch.int64)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_federation_state(paths["b"], big, rng, 1, fed=bfed)
    save_s = time.perf_counter() - t0
    mb = Path(paths["b"]).stat().st_size / 1e6
    t0 = time.perf_counter()
    back, brng, _ = load_federation_state(
        paths["b"], engine.init_state(init_fn(1, device), bfed, 60),
        fed=bfed, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    exact = torch.equal(brng, rng) and all(
        torch.equal(x, y) and x.dtype == y.dtype and x.device == y.device
        for x, y in zip(state_leaves(back), state_leaves(big)))
    check(exact, "slice (i5): cell (b)'s state did not load back bit for bit")
    for p in paths.values():
        Path(p).unlink(missing_ok=True)
    row = dict(deterministic=deterministic,
               nonzero_spread_leaves=[i for i, s in enumerate(spread) if s],
               resumed_bit_identical=not off, resumed_from_step=int(step),
               cpu_checkpoint_loads_on_card=loaded,
               fingerprint_mismatch_raises=raised, launches=card_rounds,
               b_width=dict(M=param_count(big.params), clients=60,
                            leaves=len(state_leaves(big)), mb_written=mb,
                            save_s=save_s, load_s=load_s,
                            bit_identical=exact))
    print("slice (i5) checkpoint and resume:", json.dumps(row), flush=True)
    del big, back
    return row


# ------------------------------------- the MoE and MLA archs, slice (j)
J_ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b", "minicpm3-4b")
# (j1) training: eps per arch, a non-priority client gated in in one of
# the 2 rounds and out in another, every decision > GATE_MARGIN from eps
# (the CPU run's gaps are checked in train_parity); the MoE archs' bound
# is the MoE gradient's of tests/test_torch_moe_archs.py (1e-4), MLA's
# the dense family's
J_TRAIN = {"granite-moe-3b-a800m": (0.023, 1e-4),
           "deepseek-moe-16b": (0.2, 1e-4),
           "minicpm3-4b": (0.04, PARITY_ATOL)}
J_TRAIN_RUN = dict(TRAIN_RUN, rounds=2)
# a serving run's routing is compared exactly only where every token's k-th
# and (k+1)-th router probability lie farther apart than this (the card's
# and the CPU's f32 router logits differ by ~1e-7)
ROUTE_MARGIN = 1e-4
# (j2) at full width: (arch, B, prompt, new, scheduler), as slice (e)
J2_RUNS = (("granite-moe-3b-a800m", 8, 512, 32, False),
           ("deepseek-moe-16b", 4, 1024, 16, True),
           ("minicpm3-4b", 4, 1024, 16, True))
# two of (j2)'s archs cut in depth, published widths: deepseek-moe-16b at
# 8 of 28 layers (the dense layer 0 and 7 MoE layers) and minicpm3-4b at
# 16 of 62; since slice (n) (14 and 31 from slice (k) until then), to keep
# the script under ~850 s of its 1,200 s limit on the slower hosts with
# slice (n) and (k2)'s llava uncut (888 s with (j2) at 14 / 31). Uncut
# (deepseek 65.5 GB in f32 with 13.6 GB free) both served in the slice
# (j) runs
J2_LAYERS = {"deepseek-moe-16b": 8, "minicpm3-4b": 16}


@contextmanager
def routes():
    """Every MoE layer's routing while the block runs, in call order:
    (device type, top-k experts [T, k] on the host, the least k-th minus
    (k+1)-th router probability), computed from the layer's own input as
    ``moe_apply`` computes it (f32 router, stable descending sort)."""
    import torch
    from repro_torch.models import transformer as T
    rec = []
    orig = T.moe_apply

    def recorded(p, x, cfg, **kw):
        with torch.no_grad():
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["w_router"].float(), dim=-1)
            srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = cfg.top_k
        rec.append((x.device.type, idx[:, :k].cpu(),
                    float(torch.min(srt[:, k - 1] - srt[:, k]))))
        return orig(p, x, cfg, **kw)
    T.moe_apply = recorded
    try:
        yield rec
    finally:
        T.moe_apply = orig


def same_routes(rec):
    """(equal, n): the card's routing calls against the CPU's, in order."""
    import torch
    cpu = [r[1] for r in rec if r[0] == "cpu"]
    dev = [r[1] for r in rec if r[0] != "cpu"]
    return (len(cpu) == len(dev) and all(torch.equal(a, b) for a, b in zip(cpu, dev)),
            len(dev))


def slice_j1(check: Check, expected: Expected, train_expected: TrainExpected,
             device="cuda"):
    """The smoke granite-moe, deepseek-moe (its leading dense block) and
    minicpm3 (MLA) on the card against the same code on the CPU: prefill
    and every decode step's logits within PARITY_ATOL of the larger
    magnitude (at least 1), every decision's top-2 gap on the CPU over
    twice that, each MoE layer's expert choices equal after checking
    their router margins exceed ROUTE_MARGIN; a BatchScheduler against
    generate (the MoE archs at capacity 16, where no token drops); then
    ``launch.train.run`` for 2 rounds through ``train_parity`` (gates
    exact, losses, params and one loss_fn gradient within the arch's
    bound), its expert choices on the card equal to the CPU's."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.models import get_model
    out = {}
    for arch in J_ARCHS:
        name = f"slice (j1) {arch}"
        cfg = get_smoke(arch)
        model = get_model(cfg)
        p_cpu = model.init(prng.PRNGKey(0), device="cpu")
        p_dev = model.init(prng.PRNGKey(0), device=device)
        B, S, new = 2, 12, 6
        prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size)
        with routes() as rec:
            cpu = logits_trace(model, p_cpu, prompt, new)
            dev = logits_trace(model, p_dev, prompt.to(device), new)
        expected.add(cfg, forwards=1, steps=new)
        tol = PARITY_ATOL * max(1.0, max(float(torch.max(torch.abs(c))) for c in cpu))
        err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(dev, cpu))
        check(err <= tol, f"{name}: logits off the CPU run by {err} > {tol}")
        gap = decision_gap(cpu)
        check(gap > 2 * tol, f"{name}: top-2 gap {gap} too small to compare tokens")
        row = dict(max_logits_err=err, tol=tol, top2_gap=gap)
        if cfg.moe:
            margin = min(r[2] for r in rec)
            equal, n = same_routes(rec)
            check(margin > ROUTE_MARGIN, f"{name}: router margin {margin}")
            check(equal and n > 0, f"{name}: expert choices differ from the CPU's")
            row.update(route_margin=margin, routes_equal=equal, routed_calls=n)
        nodrop = get_model(cfg.replace(capacity_factor=16.0)) if cfg.moe else model
        row.update(scheduler_vs_generate(check, expected, nodrop, p_cpu, p_dev,
                                         name, device, tol))
        eps, train_tol = J_TRAIN[arch]
        with routes() as rec:
            row["train"] = train_parity(check, train_expected, name + " training",
                                        arch, {}, eps, device, tol=train_tol,
                                        run=J_TRAIN_RUN)
        if cfg.moe:
            equal, n = same_routes(rec)
            check(equal and n > 0, f"{name} training: expert choices differ "
                  "from the CPU's")
            row["train"].update(routes_equal=equal, routed_calls=n,
                                route_margin=min(r[2] for r in rec))
        print(f"{name}:", json.dumps(row), flush=True)
        out[arch] = row
    return out


def mla_cache_bytes(cfg, B, W):
    """(bytes of the MLA cache of B sequences of W rows, bytes of the
    expanded k (nope + rope) and v (v_head_dim) caches of the same heads),
    in the compute dtype."""
    from repro_torch.models import transformer as T
    c = T.make_cache(cfg, B, W, device="meta")
    mla = sum(t.numel() * t.element_size() for layer in c["periods"].values()
              for t in (layer["c_kv"], layer["k_rope"]))
    size = c["periods"]["l0"]["c_kv"].element_size()
    expanded = (cfg.num_layers * B * W * cfg.num_heads * size
                * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim))
    return mla, expanded


def slice_j2(check: Check, expected: Expected, device="cuda"):
    """Published widths, random init from PRNGKey(0) drawn on the card, f32
    params and bf16 compute, every expert: granite-moe-3b-a800m (every
    layer) through generate (B 8, prompt 512, 32 new); deepseek-moe-16b (the
    card must keep > 4 GB free at its peak, the init's included) and
    minicpm3-4b, both cut to J2_LAYERS' depth, through generate (B 4,
    prompt 1024, 16 new) and a
    BatchScheduler (4 slots, 8 requests of 16-128 prompt tokens, 16 new
    each), minicpm3's MLA cache bytes beside an expanded k / v cache's;
    each arch's f32 teacher-forced check (the MoE archs at capacity_factor
    = experts / top_k, where no token drops), its init seconds, peak GB,
    free GB at the peak and LM launches."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.utils import param_bytes, param_count
    out = {}
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, B, S, new, sched in J2_RUNS:
        label = f"slice (j2) {arch}"
        before = lm_counts()
        cfg = get_config(arch)
        if arch in J2_LAYERS:
            cfg = cfg.replace(num_layers=J2_LAYERS[arch])
        model = get_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
        row = dict(num_layers=cfg.num_layers, params=param_count(params),
                   param_gb=param_bytes(params) / 1e9,
                   init_s=t_init, init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"{label} init:", json.dumps(row), flush=True)
        row["generate"] = serve_run(check, expected, cfg, params, B, S, new,
                                    label, device)
        if sched:
            row["scheduler"] = scheduler_run(check, expected, model, params, label,
                                             4, 144, 8, 16, 128, 16, device)
        if cfg.mla:
            mla, expanded = mla_cache_bytes(cfg, B, S + new)
            row["cache"] = dict(mla_bytes=mla, expanded_kv_bytes=expanded,
                                ratio=expanded / mla)
            print(f"{label} cache:", json.dumps(row["cache"]), flush=True)
        nodrop = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k) \
            if cfg.moe else cfg
        row["f32_teacher_forced"] = teacher_forced_check(check, expected, nodrop,
                                                         params, label, device)
        # serve_run resets the peak counter: the init's peak counts too
        peak = max(torch.cuda.max_memory_allocated(), 1e9 * row["init_peak_gb"])
        row.update(peak_gb=peak / 1e9, free_at_peak_gb=(total - peak) / 1e9,
                   launches={k: v - before[k] for k, v in lm_counts().items()})
        check(total - peak > 4e9, f"{label}: {(total - peak) / 1e9:.2f} GB free "
              "at the peak")
        print(f"{label}:", json.dumps({k: row[k] for k in (
            "init_s", "peak_gb", "free_at_peak_gb", "launches")}), flush=True)
        out[arch] = row
        del params
        torch.cuda.empty_cache()
    return out


# --------------------------------------------- llava and xlstm, slice (k)
K_ARCHS = ("llava-next-34b", "xlstm-125m")
# (k1) xlstm through launch.train.run (the spatial round): eps gates a
# non-priority client in and one out, every decision > GATE_MARGIN from
# eps (train_parity checks the CPU run's gaps)
XLSTM_TRAIN_EPS = 0.05
K_TRAIN_RUN = dict(TRAIN_RUN, rounds=2)
# (k1) the smoke llava through the temporal round (the round needs_fsdp
# picks for it) on batches carrying image embeds: 4 clients (2 priority),
# 2 sequences of 16 image rows + 32 tokens each, E = 2, 2 rounds
VLM_ROUND = dict(clients=4, n_priority=2, per_client=2, seq=32,
                 local_epochs=2, lr=0.05, rounds=2)
VLM_EPS = 0.1
# (k2) llava at full width: B x (576 image rows + S tokens), new tokens
K2 = dict(batch=2, prompt=512, new=16)
# (k3) one temporal round over llava cut to 2 of 60 layers (f32 params,
# bf16 compute), eps admitting every client
K3 = dict(clients=2, n_priority=1, per_client=2, seq=512, local_epochs=1,
          lr=0.05, epsilon=1.0)
# (k4) xlstm at full width: generate (B, prompt, new) and one spatial round
K4_SERVE = (4, 1024, 16)
K4 = dict(clients=4, n_priority=2, per_client=2, seq=512, local_epochs=1,
          lr=0.05, epsilon=1.0)


def image_rows(cfg, B, device, seed=0, lead=()):
    """The stubbed vision tower's output [*lead, B, n_img, d] in the
    compute dtype: normal draws from a seeded CPU generator, so the card
    and the CPU see the same rows."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    shape = tuple(lead) + (B, cfg.num_image_tokens, cfg.d_model)
    return torch.randn(*shape, generator=gen).to(cfg.cdtype).to(device)


def report(label, row, keys):
    """Each of ``keys`` of ``row`` on a line of its own."""
    for k in keys:
        print(f"{label} {k}: {row[k]}", flush=True)


def vlm_round_parity(check: Check, expected: TrainExpected, name, model,
                     p_cpu, device="cuda", tol=PARITY_ATOL):
    """The smoke llava through ``make_round_step(fsdp=needs_fsdp)`` (the
    temporal round) for VLM_ROUND's rounds on the card and on the CPU,
    from the same params, on the same token batches (``build_batches``)
    with the same image embeds: gates equal, after checking every
    decision is more than GATE_MARGIN from eps and some non-priority
    client is in and some out; losses and the final params within ``tol``
    of the largest magnitude (at least 1). The reference's ``train.run``
    cannot train llava (its batches carry no images), so neither does this
    through ``train.run``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.tokens import make_token_federation
    from repro_torch.fl import engine, sharded
    from repro_torch.launch.train import build_batches
    from repro_torch.utils import tree_leaves, tree_map
    cfg, kw = model.cfg, VLM_ROUND
    C, npri, b, S = kw["clients"], kw["n_priority"], kw["per_client"], kw["seq"]
    fed = FedConfig(num_clients=C, num_priority=npri, local_epochs=kw["local_epochs"],
                    epsilon=VLM_EPS, lr=kw["lr"])
    data = make_token_federation(seed=0, vocab=cfg.vocab_size, n_clients=C,
                                 n_priority=npri, seq_len=S,
                                 tokens_per_client=(S + 1) * 8)
    runs = {}
    for dev in ("cpu", device):
        step = sharded.make_round_step(model, fed, C, fsdp=sharded.needs_fsdp(cfg),
                                       device=dev)
        state = engine.init_state(tree_map(lambda t: t.to(dev, copy=True), p_cpu),
                                  fed, C)
        rng = np.random.default_rng(0)
        hist = []
        for r in range(kw["rounds"]):
            batch = build_batches(cfg, data, clients=C, per_client=b, seq=S,
                                  rng=rng, device=dev)
            batch["clients"]["image_embeds"] = image_rows(cfg, b, dev, 10 + r, (C,))
            batch["server"]["image_embeds"] = image_rows(cfg, b, dev, 20 + r)
            state, st = step(state, batch, r)
            hist.append({k: st[k].cpu() for k in ("server_loss", "local_losses",
                                                   "gates")})
            if dev != "cpu":
                expected.add_rounds(cfg, C, kw["local_epochs"], 1,
                                    trained=int((st["gates"] > 0).sum()),
                                    fedagg=False, images=True)
        runs[dev] = ([t.cpu() for t in tree_leaves(state.params)], hist)
    (p_dev, h_dev), (p_ref, h_ref) = runs[device], runs["cpu"]
    margin = min(abs(abs(float(l) - float(h["server_loss"])) - VLM_EPS)
                 for h in h_ref for l in h["local_losses"][npri:])
    check(margin > GATE_MARGIN, f"{name}: gate margin {margin}")
    gated = torch.stack([h["gates"][npri:] for h in h_ref])
    check(0 < float(gated.sum()) < gated.numel(),
          f"{name}: eps {VLM_EPS} gates every client in or every one out")
    same = all(torch.equal(a["gates"], b_["gates"]) for a, b_ in zip(h_dev, h_ref))
    check(same, f"{name}: gates differ from the CPU run")
    loss_err = max(float(torch.max(torch.abs(a[k] - b_[k])))
                   / max(1.0, float(torch.max(torch.abs(b_[k]))))
                   for a, b_ in zip(h_dev, h_ref) for k in ("server_loss", "local_losses"))
    check(loss_err <= tol, f"{name}: losses off the CPU run by {loss_err}")
    param_err = max(float(torch.max(torch.abs(a - b_))) / max(1.0, float(torch.max(torch.abs(b_))))
                    for a, b_ in zip(p_dev, p_ref))
    check(param_err <= tol, f"{name}: params off the CPU run by {param_err}")
    row = dict(eps=VLM_EPS, gate_margin=margin, gates=[h["gates"].tolist() for h in h_ref],
               gates_equal=same, max_loss_rel_err=loss_err, max_param_rel_err=param_err)
    print(f"{name}:", json.dumps(row), flush=True)
    return row


def slice_k1(check: Check, expected: Expected, train_expected: TrainExpected,
             device="cuda"):
    """The smoke llava (images) and xlstm (mLSTM + sLSTM) on the card
    against the same code on the CPU, from the same params carried across
    by ``convert.py``: prefill then every decode step's logits within
    PARITY_ATOL of the larger magnitude (at least 1; llava's prefill with
    16 image rows, its decode at n_img + S + i), every decision's top-2
    gap on the CPU over twice that; the text-only ``generate``'s tokens
    equal; then two rounds of the LM round: llava's temporal round on
    image batches (``vlm_round_parity``), xlstm through
    ``launch.train.run``'s spatial round (``train_parity``)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.launch.serve import generate
    from repro_torch.models import get_model
    out = {}
    for arch in K_ARCHS:
        name = f"slice (k1) {arch}"
        cfg = get_smoke(arch)
        model = get_model(cfg)
        p_cpu = model.init(prng.PRNGKey(0), device="cpu")
        p_dev = params_from_jax(params_to_numpy(p_cpu), device)
        B, S, new = 2, 12, 6
        prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size)
        img = image_rows(cfg, B, "cpu", seed=4) if cfg.vlm else None
        cpu = logits_trace(model, p_cpu, prompt, new, img)
        dev = logits_trace(model, p_dev, prompt.to(device), new,
                           None if img is None else img.to(device))
        expected.add(cfg, forwards=1, steps=new, images=cfg.vlm)
        tol = PARITY_ATOL * max(1.0, max(float(torch.max(torch.abs(c))) for c in cpu))
        err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(dev, cpu))
        check(err <= tol, f"{name}: logits off the CPU run by {err} > {tol}")
        gap = decision_gap(cpu)
        check(gap > 2 * tol, f"{name}: top-2 gap {gap} too small to compare tokens")
        text_gap = decision_gap(logits_trace(model, p_cpu, prompt, new))
        check(text_gap > 2 * tol, f"{name}: text-only top-2 gap {text_gap}")
        t_cpu = generate(model, p_cpu, prompt, new, device="cpu")
        t_dev = generate(model, p_dev, prompt, new, device=device)
        expected.add(cfg, forwards=1, steps=new)
        same = bool(torch.equal(t_dev.cpu(), t_cpu))
        check(same, f"{name}: text-only greedy tokens differ from the CPU run")
        row = dict(max_logits_err=err, tol=tol, top2_gap=gap, text_top2_gap=text_gap,
                   tokens_equal=same)
        if cfg.vlm:
            row["train"] = vlm_round_parity(check, train_expected, name + " training",
                                            model, p_cpu, device)
        else:
            row["train"] = train_parity(check, train_expected, name + " training",
                                        arch, {}, XLSTM_TRAIN_EPS, device,
                                        run=K_TRAIN_RUN)
        print(f"{name}:", json.dumps(row), flush=True)
        out[arch] = row
    return out


def slice_k2(check: Check, expected: Expected, device="cuda"):
    """llava-next-34b uncut: published widths, every one of its 60 layers,
    random init drawn on the card from PRNGKey(0), bf16 params as the
    config says (34.39 B params, 68.8 GB; f32 would need 137.6 GB) and
    bf16 compute; the init's peak under the card's memory. Serves B 2 x
    (576 image rows + 512 tokens) by prefill with image_embeds, pad_caches
    to n_img + S + new, and 16 decode steps at n_img + S + i (after one
    warm-up of 64 tokens and 2 steps); a text-only ``generate`` of the same
    prompt; and the f32-compute teacher-forced check with image rows (2 x
    (576 + 16), 4 decode steps) at the bounds of (e) / (j2)."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, pad_caches
    from repro_torch.models import get_model
    from repro_torch.utils import param_bytes, param_count
    label = "slice (k2) llava-next-34b"
    cfg = get_config("llava-next-34b")
    model = get_model(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
    init_peak = torch.cuda.max_memory_allocated()
    row = dict(params=param_count(params), param_gb=param_bytes(params) / 1e9,
               param_dtype=str(cfg.pdtype), init_s=t_init, init_peak_gb=init_peak / 1e9)
    check(init_peak < total, f"{label}: init peak {init_peak / 1e9} GB")
    report(label, row, ("init_s", "init_peak_gb"))
    B, S, new = K2["batch"], K2["prompt"], K2["new"]
    n_img = cfg.num_image_tokens
    img = image_rows(cfg, B, device, seed=5)
    prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size).to(device)

    def serve(toks, steps):
        caches, logits = model.prefill(params, {"tokens": toks, "image_embeds": img})
        caches = pad_caches(model, caches, B, n_img + toks.shape[1] + steps)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        return caches, logits, tok

    serve(prompt[:, :64], 2)                                         # warm-up
    expected.add(cfg, forwards=1, images=True)
    torch.cuda.reset_peak_memory_stats()
    (caches, logits, tok), t_pre = sync_time(lambda: serve(prompt, new))
    expected.add(cfg, forwards=1, images=True)

    def decode():
        nonlocal caches, tok
        out = [tok]
        for i in range(new):
            lg, caches = model.decode_step(params, caches, tok, n_img + S + i)
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            out.append(tok)
        return lg, torch.cat(out, dim=1)
    (last, toks), t_dec = sync_time(decode)
    expected.add(cfg, steps=new)
    ok = (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(last).all())
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size)
    check(ok, f"{label}: non-finite logits or tokens out of range")
    row.update(batch=B, image_rows=n_img, prompt=S, new_tokens=new, prefill_s=t_pre,
               prefill_tokens_per_s=B * (n_img + S) / t_pre,
               decode_ms_per_step=1e3 * t_dec / new,
               decode_tokens_per_s=B * new / t_dec,
               serve_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del caches
    text, t_gen = sync_time(lambda: generate(model, params, prompt, new, device=device))
    expected.add(cfg, forwards=1, steps=new)
    check(tuple(text.shape) == (B, S + new) and int(text.max()) < cfg.vocab_size,
          f"{label}: text-only generate gave {tuple(text.shape)}")
    row["text_generate_s"] = t_gen
    row["f32_teacher_forced"] = teacher_forced_check(
        check, expected, cfg, params, label, device, S=16, S2=20, images=True)
    peak = max(torch.cuda.max_memory_allocated(), init_peak)
    row.update(peak_gb=peak / 1e9, free_at_peak_gb=(total - peak) / 1e9)
    check(peak < total, f"{label}: peak {peak / 1e9} GB")
    report(label, row, ("prefill_tokens_per_s", "decode_ms_per_step", "peak_gb"))
    print(f"{label}:", json.dumps(row), flush=True)
    del params
    torch.cuda.empty_cache()
    return row


def slice_k3(check: Check, expected: TrainExpected, device="cuda"):
    """llava training, cut: published widths (d 7168, 56 / 8 heads at hd
    128, d_ff 20480, the 64,000-token embed and head) at 2 of 60 layers,
    f32 params and bf16 compute (2.04 B params; the temporal round holds
    4 f32 copies, ~33 GB; uncut they would be 550 GB). One temporal round
    (``make_round_step(fsdp=True)``, the round needs_fsdp picks): 2
    clients (1 priority) of 2 x (576 image rows + 512 tokens), E = 1, eps
    admitting both: K5 and K6 at G 7 under autograd. Checks the launches,
    finite params and losses, both clients gated in, peak under the
    card's memory."""
    import math
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.tokens import make_token_federation
    from repro_torch.fl import engine, sharded
    from repro_torch.launch.train import build_batches
    from repro_torch.models import get_model
    from repro_torch.utils import param_count, tree_leaves
    import numpy as np
    name = "slice (k3) llava temporal round"
    cfg = get_config("llava-next-34b").replace(num_layers=2, param_dtype="float32")
    model = get_model(cfg)
    kw = K3
    C, b, S = kw["clients"], kw["per_client"], kw["seq"]
    fed = FedConfig(num_clients=C, num_priority=kw["n_priority"],
                    local_epochs=kw["local_epochs"], epsilon=kw["epsilon"], lr=kw["lr"])
    data = make_token_federation(seed=0, vocab=cfg.vocab_size, n_clients=C,
                                 n_priority=kw["n_priority"], seq_len=S,
                                 tokens_per_client=max(8192, b * (S + 1) * 4))
    torch.cuda.empty_cache()
    params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
    n = param_count(params)
    step = sharded.make_round_step(model, fed, C, fsdp=sharded.needs_fsdp(cfg),
                                   device=device)
    state = engine.init_state(params, fed, C)
    del params
    batch = build_batches(cfg, data, clients=C, per_client=b, seq=S,
                          rng=np.random.default_rng(0), device=device)
    batch["clients"]["image_embeds"] = image_rows(cfg, b, device, 30, (C,))
    batch["server"]["image_embeds"] = image_rows(cfg, b, device, 31)
    before = train_counts()
    torch.cuda.reset_peak_memory_stats()
    (state, st), t_round = sync_time(lambda: step(state, batch, 0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v - before[k] for k, v in train_counts().items()}
    gates = st["gates"].tolist()
    want = TrainExpected()
    want.add_rounds(cfg, C, kw["local_epochs"], 1, trained=sum(g > 0 for g in gates),
                    fedagg=False, images=True)
    for k, v in want.items():
        expected[k] += v
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    check(gates == [1.0] * C, f"{name}: a client was gated out: {gates}")
    losses = [float(st["server_loss"])] + st["local_losses"].tolist()
    finite = all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))
    check(finite and all(math.isfinite(x) for x in losses),
          f"{name}: non-finite params or losses")
    check(peak < 80.0, f"{name}: peak {peak} GB")
    row = dict(num_layers=cfg.num_layers, params=n, f32_copy_gb=4 * n / 1e9,
               **kw, image_rows=cfg.num_image_tokens, init_s=t_init, round_s=t_round,
               peak_gb=peak, server_loss=losses[0], local_losses=losses[1:],
               gates=gates, launches=launches)
    print(f"{name}:", json.dumps(row), flush=True)
    del state, batch
    torch.cuda.empty_cache()
    return row


@contextmanager
def timed_blocks(mixers):
    """The host-clock seconds spent in each of ``mixers``' blocks (e.g.
    "slstm" for ``slstm_block``) while the block runs, each call between
    two device syncs: {mixer: seconds}."""
    import torch
    from repro_torch.models import transformer as T
    spent = {m: 0.0 for m in mixers}
    orig = {m: getattr(T, f"{m}_block") for m in mixers}

    def timed(m):
        def block(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[m](*args, **kw)
            torch.cuda.synchronize()
            spent[m] += time.perf_counter() - t0
            return out
        return block
    for m in mixers:
        setattr(T, f"{m}_block", timed(m))
    try:
        yield spent
    finally:
        for m in mixers:
            setattr(T, f"{m}_block", orig[m])


def slice_k4(check: Check, expected: Expected, train_expected: TrainExpected,
             device="cuda"):
    """xlstm-125m at full width: random init on the card, f32 params and
    bf16 compute. ``generate`` (serve_run: B 4, prompt 1024, 16 new) and
    the f32 teacher-forced check; what the sLSTM's host loop costs at
    prefill (one more prefill of the same B x S with each mLSTM and sLSTM
    block timed inside it, ``timed_blocks``); then one spatial round through
    ``launch.train.run`` (4 clients, 2 priority, 2 x 512 tokens each, E =
    1, eps admitting all), its launches (K9 and fedagg; xlstm runs no
    attention) checked."""
    import math
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.utils import param_bytes, param_count, tree_leaves
    label = "slice (k4) xlstm-125m"
    cfg = get_config("xlstm-125m")
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
    row = dict(params=param_count(params), param_gb=param_bytes(params) / 1e9,
               init_s=t_init, init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    report(label, row, ("init_s",))
    B, S, new = K4_SERVE
    row["generate"] = serve_run(check, expected, cfg, params, B, S, new, label, device)
    row["f32_teacher_forced"] = teacher_forced_check(check, expected, cfg, params,
                                                     label, device)
    prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size).to(device)
    with timed_blocks(("mlstm", "slstm")) as spent:
        _, t_pre = sync_time(lambda: model.prefill(params, {"tokens": prompt}))
    expected.add(cfg, forwards=1)
    row["prefill_blocks"] = dict(
        prefill_s=t_pre, mlstm_s=spent["mlstm"], slstm_s=spent["slstm"],
        layers_each=cfg.n_periods, slstm_steps=S,
        slstm_ms_per_step=1e3 * spent["slstm"] / (cfg.n_periods * S),
        slstm_share_of_prefill=spent["slstm"] / t_pre,
        mlstm_share_of_prefill=spent["mlstm"] / t_pre)
    print(f"{label} prefill blocks:", json.dumps(row["prefill_blocks"]), flush=True)
    del params
    torch.cuda.empty_cache()
    before = train_counts()
    with lm_rounds() as rec:
        p_run, hist = train.run(arch="xlstm-125m", smoke=False, rounds=1,
                                device=device, verbose=False, **K4)
    train_expected.add_rounds(cfg, K4["clients"], K4["local_epochs"], 1)
    launches = {k: v - before[k] for k, v in train_counts().items()}
    want = TrainExpected()
    want.add_rounds(cfg, K4["clients"], K4["local_epochs"], 1)
    check(launches == want, f"{label} round: launches {launches}, expected {want}")
    h = hist[0]
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(p_run))
    check(finite and math.isfinite(h["server_loss"])
          and all(math.isfinite(v) for v in h["local_losses"]),
          f"{label} round: non-finite params or losses")
    check(h["gates"] == [1.0] * K4["clients"], f"{label} round: gates {h['gates']}")
    row["round"] = dict(**K4, round_s=h["sec"], peak_gb=rec["peak_gb"][0],
                        server_loss=h["server_loss"], local_losses=h["local_losses"],
                        launches=launches)
    row["peak_gb"] = max(row["init_peak_gb"], row["generate"]["peak_gb"],
                         rec["peak_gb"][0])
    row.update(prefill_tokens_per_s=row["generate"]["prefill_tokens_per_s"],
               decode_ms_per_step=row["generate"]["decode_ms_per_step"])
    report(label, row, ("prefill_tokens_per_s", "decode_ms_per_step", "peak_gb"))
    print(f"{label}:", json.dumps({k: row[k] for k in ("prefill_blocks", "round")}),
          flush=True)
    del p_run
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------- slice (l): whisper-medium
# (l1) attn_bf16 on the card against the same model with the knob off and
# its attention's q, k, v cast to bf16 by hand (the knob's route spelled
# out: the same launches, so equal but for nondeterminism, which K5 has
# none of), relative to max(1, max|x|); the knob must move the card's loss
# and logits off its f32 route by L_ATTN_BF16_EFFECT x that bound (it
# moved them by 3.5e-5 and 4.6e-3), so an ignored knob fails both checks
L_ATTN_BF16_ROUTE_TOL = 1e-7
L_ATTN_BF16_EFFECT = 20
# the card's bf16 route (q, k, v rounded, P split hi + lo, the output
# rounded to bf16) against the CPU's plain version, which rounds as the
# reference does (q scale, k, v and each block's p rounded, an f32
# output): a few bf16 ulp (2^-8) of each attention output, carried through
# the rest of the f32 model; a bound on gross faults only (the two
# roundings differ by about the knob's own effect), the gap reported
L_ATTN_BF16_TOL = 1e-2
# (l2) whisper-medium uncut: B x 1500 frames, a 32-token prompt, then 224
# greedy decode steps (whisper's sample_len, n_text_ctx // 2: 256 cache rows)
L2 = dict(batch=8, prompt=32, new=224)
# (l3) its loss: B x 1500 frames x 448 tokens (n_text_ctx), remat on
L3 = dict(batch=2, tokens=448)
# (l4) save_mixer against "full": one (f2)-sized client step of qwen1.5-0.5b,
# in alternating turns (the host's jitter between steps is +-20%)
L4 = dict(batch=8, seq=512, turns=10)


def frame_rows(cfg, B, device, seed=0):
    """The stubbed audio frontend's output [B, num_frames, d] in the
    compute dtype: normal draws from a seeded CPU generator, so the card
    and the CPU see the same rows."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, cfg.num_frames, cfg.d_model, generator=gen).to(
        cfg.cdtype).to(device)


def encdec_batch(cfg, B, S, device, seed=0):
    """``token_batch`` plus its frames."""
    return dict(token_batch(cfg, B, S, device, seed),
                frames=frame_rows(cfg, B, device, seed + 100))


def slice_l1(check: Check, expected: Expected, train_expected: TrainExpected,
             device="cuda"):
    """Smoke size on the card against the same code on the CPU, from the
    same params (drawn on the card, copied to the host). whisper: prefill
    of 2 x 6 tokens over its 32 frames, then 4 decode steps, every call's
    logits within PARITY_ATOL of the larger magnitude (at least 1) and the
    greedy tokens equal, after each decision's top-2 gap on the CPU
    exceeds twice that; loss_fn and its gradient leaf for leaf within
    PARITY_ATOL of each leaf's largest. Then the knobs on the smoke
    qwen1.5 (f32): ``attn_bf16``'s loss and prefill logits against the
    card's own explicit bf16 casts (within L_ATTN_BF16_ROUTE_TOL) and its
    f32 route (at least L_ATTN_BF16_EFFECT times that away), and against
    the CPU's (the gap measured, within L_ATTN_BF16_TOL);
    ``save_mixer``'s loss and gradients against "full"'s,
    on the smoke qwen1.5 and the smoke jamba: bit for bit wherever two
    "full" gradients on the card are."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.models import get_model
    from repro_torch.utils import tree_map
    out = {}
    name = "slice (l1) whisper-medium"
    cfg = get_smoke("whisper-medium")
    model = get_model(cfg)
    p_dev = model.init(prng.PRNGKey(0), device=device)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    B, S, new = 2, 6, 4
    prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size)
    frames = frame_rows(cfg, B, "cpu", seed=4)
    cpu = logits_trace(model, p_cpu, prompt, new, frames=frames)
    dev = logits_trace(model, p_dev, prompt.to(device), new, frames=frames.to(device))
    expected.add_encdec(cfg, forwards=1, steps=new)
    tol = PARITY_ATOL * max(1.0, max(float(torch.max(torch.abs(c))) for c in cpu))
    err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(dev, cpu))
    check(err <= tol, f"{name}: logits off the CPU run by {err} > {tol}")
    gap = decision_gap(cpu)
    check(gap > 2 * tol, f"{name}: top-2 gap {gap} too small to compare tokens")
    same = all(torch.equal(torch.argmax(a, -1), torch.argmax(b, -1))
               for a, b in zip(dev, cpu))
    check(same, f"{name}: greedy tokens differ from the CPU run")
    batch = encdec_batch(cfg, 2, 10, "cpu", seed=5)
    l_cpu, g_cpu = loss_grads(model, p_cpu, batch)
    l_dev, g_dev = loss_grads(model, p_dev, {k: t.to(device) for k, t in batch.items()})
    train_expected.add_encdec_grad(cfg)
    loss_err = abs(float(l_dev) - float(l_cpu)) / max(1.0, abs(float(l_cpu)))
    grad_err, complete = leaf_errs(g_dev, g_cpu)
    check(loss_err <= PARITY_ATOL, f"{name}: loss off the CPU's by {loss_err}")
    check(complete, f"{name}: a gradient leaf is missing or zero on the card")
    check(grad_err <= PARITY_ATOL, f"{name}: loss_fn gradient off the CPU's by "
          f"{grad_err} (relative to each leaf's largest)")
    out["whisper"] = dict(max_logits_err=err, tol=tol, top2_gap=gap, tokens_equal=same,
                          loss=float(l_cpu), loss_rel_err=loss_err,
                          grad_leaves=len(g_dev), max_grad_rel_err=grad_err)
    print(f"{name}:", json.dumps(out["whisper"]), flush=True)
    del p_dev, p_cpu, g_cpu, g_dev

    # attn_bf16 on the smoke qwen1.5: the loss (a no-grad train-mode
    # forward) and the prefill's logits
    name = "slice (l1) attn_bf16 qwen1.5-0.5b"
    q32 = get_smoke("qwen1.5-0.5b")
    runs = {}
    p_dev = get_model(q32).init(prng.PRNGKey(0), device=device)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    batch = token_batch(q32, 2, 64, "cpu", seed=6)

    def run(m, p):
        b = {k: t.to(p["embed"].device) for k, t in batch.items()}
        with torch.no_grad():
            loss = float(m.loss_fn(p, b)[0])
        logits = m.prefill(p, {"tokens": b["tokens"]})[1].float().cpu()
        if p["embed"].device.type != "cpu":
            train_expected.add_forwards(m.cfg, 1)
            expected.add(m.cfg, forwards=1)
        return loss, logits

    for knob in (True, False):
        m = get_model(q32.replace(attn_bf16=knob))
        for on_cpu, p in ((True, p_cpu), (False, p_dev)):
            runs[(knob, on_cpu)] = run(m, p)
    # the knob's route by hand: knob off, the attention's inputs cast
    from repro_torch.kernels import ops as kops
    flash = kops.flash_attention
    kops.flash_attention = lambda q, k, v, **kw: flash(
        q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
        **kw).to(q.dtype)
    try:
        runs[("by_hand", False)] = run(get_model(q32), p_dev)
    finally:
        kops.flash_attention = flash

    def gaps(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        return (abs(la - lb) / max(1.0, abs(lb)),
                float(torch.max(torch.abs(ga - gb))) / max(1.0, float(torch.max(torch.abs(gb)))))
    row = dict(zip(("loss_gap", "logits_gap"), gaps((True, False), (True, True))))
    row.update(zip(("knob_loss_card", "knob_logits_card"), gaps((True, False), (False, False))))
    row.update(zip(("knob_loss_cpu", "knob_logits_cpu"), gaps((True, True), (False, True))))
    row.update(zip(("route_loss_gap", "route_logits_gap"), gaps((True, False), ("by_hand", False))))
    row["loss_bf16_card"], row["loss_bf16_cpu"] = runs[(True, False)][0], runs[(True, True)][0]
    check(max(row["route_loss_gap"], row["route_logits_gap"]) <= L_ATTN_BF16_ROUTE_TOL,
          f"{name}: the knob off the card's bf16 casts by hand by {row['route_loss_gap']} "
          f"(loss), {row['route_logits_gap']} (logits) > {L_ATTN_BF16_ROUTE_TOL}")
    effect = L_ATTN_BF16_EFFECT * L_ATTN_BF16_ROUTE_TOL
    check(min(row["knob_loss_card"], row["knob_logits_card"]) >= effect,
          f"{name}: the knob moved the card's loss by {row['knob_loss_card']}, its "
          f"logits by {row['knob_logits_card']} (< {effect}): the f32 route taken")
    check(max(row["loss_gap"], row["logits_gap"]) <= L_ATTN_BF16_TOL,
          f"{name}: card off the CPU by {row['loss_gap']} (loss), "
          f"{row['logits_gap']} (logits) > {L_ATTN_BF16_TOL}")
    print(f"{name}:", json.dumps(row), flush=True)
    out["attn_bf16"] = row
    del p_dev, p_cpu

    # save_mixer against "full" on the card: loss and gradients
    for arch in ("qwen1.5-0.5b", "jamba-1.5-large-398b"):
        name = f"slice (l1) save_mixer {arch}"
        c = get_smoke(arch)
        p = get_model(c).init(prng.PRNGKey(0), device=device)
        b = token_batch(c, 2, 32, device, seed=7)
        res = {pol: loss_grads(get_model(c.replace(remat_policy=pol)), p, b)
               for pol in ("full", "save_mixer")}
        full2 = loss_grads(get_model(c), p, b)
        train_expected.add_grad(c, 2)
        train_expected.add_grad(c.replace(remat_policy="save_mixer"))
        (lf, gf), (ls, gs) = res["full"], res["save_mixer"]
        repro = same_bits([lf] + gf, [full2[0]] + full2[1])
        bitwise = same_bits([lf] + gf, [ls] + gs)
        rel = rel_l2(gs, gf)
        check(bitwise if repro else rel <= GRAD_RTOL,
              f"{name}: gradients off the full policy's by {rel} (bit for bit: "
              f"{bitwise}; two full runs bit for bit: {repro})")
        row = dict(bitwise=bitwise, full_repeat_bitwise=repro, max_rel_l2=rel,
                   loss=float(lf), loss_equal=bool(torch.equal(lf, ls)))
        print(f"{name}:", json.dumps(row), flush=True)
        out[f"save_mixer {arch}"] = row
        del p, res, full2
    torch.cuda.empty_cache()
    return out


def encdec_teacher_forced(check: Check, expected: Expected, cfg, params, label,
                          device="cuda", B=2, S=16, S2=24):
    """whisper at full width in f32 (params shared with the bf16 runs):
    prefill's last logits and each decode step's against the train-mode
    forward's (``encode`` + ``decode_forward(mode="train")``) on the same
    tokens and 1500 frames, within tests/test_serve.py's atol 5e-4 + rtol
    5e-3, as ``teacher_forced_check``: K7 over the self cache and the
    cached cross K / V against K5 and the per-call cross projection."""
    import torch
    from repro_torch import prng
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import encdec, get_model
    cfg = cfg.replace(compute_dtype="float32")
    model = get_model(cfg)
    toks = prng.randint(prng.PRNGKey(2), (B, S2), 0, cfg.vocab_size).to(device)
    frames = frame_rows(cfg, B, device, seed=3)
    with torch.no_grad():
        enc = encdec.encode(params, frames, cfg)
        hidden, _ = encdec.decode_forward(params, toks, enc, cfg, mode="train")
    expected.add_encdec(cfg, forwards=1)
    ref = hidden.float() @ params["embed"].T.float()
    del hidden, enc
    caches, logits = model.prefill(params, {"tokens": toks[:, :S], "frames": frames})
    caches = pad_caches(model, caches, B, S2)
    got = [(S - 1, logits)]
    for t in range(S, S2):
        logits, caches = model.decode_step(params, caches, toks[:, t:t + 1], t)
        got.append((t, logits))
    expected.add_encdec(cfg, forwards=1, steps=S2 - S)
    errs = [float(torch.max(torch.abs(lg - ref[:, t]))) for t, lg in got]
    ok = all(bool(torch.all(torch.abs(lg - ref[:, t])
                            <= SERVE_ATOL + SERVE_RTOL * torch.abs(ref[:, t])))
             for t, lg in got)
    check(ok, f"{label} f32 teacher-forced: logits off by {max(errs)}")
    row = dict(max_abs_err=max(errs), logits_max=float(ref.abs().max()),
               steps=len(got))
    print(f"{label} f32 teacher-forced:", json.dumps(row), flush=True)
    return row


def slice_l2(check: Check, expected: Expected, device="cuda"):
    """whisper-medium uncut: published widths, all 24 encoder and 24
    decoder layers, random init drawn on the card from PRNGKey(0), f32
    params as the config says (0.83 B params with the 65,536-row
    ``pos_dec``, 3.3 GB) and bf16 compute. Encodes B 8 x 1500 stub frames
    (timed alone), then serves a 32-token prompt over them: prefill (the
    encoder again; each decoder layer's cross K / V projected once),
    ``pad_caches`` to 256 rows and 224 greedy decode steps, after a warm-up
    of 8 tokens and 2 steps; K5's and K7's launches against the code's
    counts (E + D and D a step); then ``encdec_teacher_forced``."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_caches
    from repro_torch.models import encdec, get_model
    from repro_torch.utils import param_bytes, param_count
    label = "slice (l2) whisper-medium"
    cfg = get_config("whisper-medium")
    model = get_model(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(lambda: model.init(prng.PRNGKey(0), device=device))
    row = dict(params=param_count(params), param_gb=param_bytes(params) / 1e9,
               init_s=t_init, init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    B, S, new = L2["batch"], L2["prompt"], L2["new"]
    E, D = cfg.encoder_layers, cfg.num_layers
    frames = frame_rows(cfg, B, device, seed=5)
    prompt = prng.randint(prng.PRNGKey(1), (B, S), 0, cfg.vocab_size).to(device)

    def serve(toks, steps):
        caches, logits = model.prefill(params, {"tokens": toks, "frames": frames})
        caches = pad_caches(model, caches, B, toks.shape[1] + steps)
        out = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
        for i in range(steps):
            lg, caches = model.decode_step(params, caches, out[-1], toks.shape[1] + i)
            out.append(torch.argmax(lg, -1)[:, None].to(torch.int32))
        return logits, lg, torch.cat(out, dim=1)

    serve(prompt[:, :8], 2)                                          # warm-up
    expected.add_encdec(cfg, forwards=1, steps=2)
    with torch.no_grad():
        _, t_enc = sync_time(lambda: encdec.encode(params, frames, cfg))
    expected.add_encdec(cfg, encodes=1)
    torch.cuda.reset_peak_memory_stats()
    (caches, logits), t_pre = sync_time(lambda: model.prefill(
        params, {"tokens": prompt, "frames": frames}))
    caches = pad_caches(model, caches, B, S + new)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    before = lm_counts()

    def decode():
        nonlocal caches, tok
        out = [tok]
        for i in range(new):
            lg, caches = model.decode_step(params, caches, tok, S + i)
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            out.append(tok)
        return lg, torch.cat(out, dim=1)
    (last, toks), t_dec = sync_time(decode)
    k7 = lm_counts()["decode_attention"] - before["decode_attention"]
    expected.add_encdec(cfg, forwards=1, steps=new)
    check(k7 == D * new, f"{label}: {k7} K7 launches over {new} steps, expected {D * new}")
    before = lm_counts()
    (_, _, toks2), t_gen = sync_time(lambda: serve(prompt, new))
    k5 = lm_counts()["flash_attention"] - before["flash_attention"]
    expected.add_encdec(cfg, forwards=1, steps=new)
    check(k5 == E + D, f"{label}: {k5} K5 launches a prefill, expected {E + D}")
    ok = (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(last).all())
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
          and tuple(toks.shape) == (B, new + 1) and torch.equal(toks, toks2))
    check(ok, f"{label}: non-finite logits, tokens out of range, or the two "
          "runs' tokens differ")
    row.update(batch=B, frames=cfg.num_frames, prompt=S, new_tokens=new,
               encode_s=t_enc, frames_per_s=B * cfg.num_frames / t_enc,
               prefill_s=t_pre, prefill_tokens_per_s=B * S / t_pre,
               decode_ms_per_step=1e3 * t_dec / new, decode_tokens_per_s=B * new / t_dec,
               serve_s=t_gen, serve_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               k5_per_prefill=k5, k7_per_step=k7 / new,
               self_cache_gb=2 * caches["dec"]["self"]["k"].numel()
               * caches["dec"]["self"]["k"].element_size() / 1e9,
               cross_cache_gb=2 * caches["dec"]["cross"]["k"].numel()
               * caches["dec"]["cross"]["k"].element_size() / 1e9)
    del caches
    row["f32_teacher_forced"] = encdec_teacher_forced(check, expected, cfg, params,
                                                      label, device)
    peak = max(torch.cuda.max_memory_allocated(), int(row["init_peak_gb"] * 1e9))
    row.update(peak_gb=peak / 1e9)
    check(peak < total, f"{label}: peak {peak / 1e9} GB")
    report(label, row, ("encode_s", "prefill_tokens_per_s", "decode_ms_per_step",
                        "peak_gb", "k5_per_prefill", "k7_per_step"))
    print(f"{label}:", json.dumps(row), flush=True)
    del params
    torch.cuda.empty_cache()
    return row


def slice_l3(check: Check, expected: TrainExpected, device="cuda"):
    """whisper-medium's loss differentiated at full width: B 2 x 1500
    frames x 448 tokens (n_text_ctx), f32 params, bf16 compute, remat on
    (each decoder block a checkpoint; the encoder outside, as the
    reference's): a warm-up gradient, then one timed. Reports the loss,
    the gradient's global norm, step ms, peak GB, and the K5 / K6 launches
    against the code's counts (E + 2D and E + D a gradient); every leaf's
    gradient present, finite and nonzero."""
    import math
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    label = "slice (l3) whisper-medium loss"
    cfg = get_config("whisper-medium")
    check(cfg.remat, f"{label}: remat is off")
    model = get_model(cfg)
    params = model.init(prng.PRNGKey(0), device=device)
    batch = encdec_batch(cfg, L3["batch"], L3["tokens"], device, seed=8)
    loss_grads(model, params, batch)                                 # warm-up
    expected.add_encdec_grad(cfg)
    before = train_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (loss, grads), t = sync_time(lambda: loss_grads(model, params, batch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v - before[k] for k, v in train_counts().items()}
    want = TrainExpected()
    want.add_encdec_grad(cfg)
    for k, v in want.items():
        expected[k] += v
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    gnorm = math.sqrt(sum(float(torch.sum(g.float() ** 2)) for g in grads))
    ok = (math.isfinite(float(loss)) and math.isfinite(gnorm)
          and all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                  for g in grads))
    check(ok, f"{label}: a non-finite loss or gradient, or a zero leaf")
    row = dict(**L3, frames=cfg.num_frames, loss=float(loss), grad_norm=gnorm,
               grad_leaves=len(grads), step_ms=1e3 * t, peak_gb=peak,
               k5=launches["flash_attention"], k6=launches["flash_attention_bwd"])
    report(label, row, ("loss", "grad_norm", "step_ms", "peak_gb", "k5", "k6"))
    print(f"{label}:", json.dumps(row), flush=True)
    del params, grads
    torch.cuda.empty_cache()
    return row


def slice_l4(check: Check, expected: TrainExpected, device="cuda"):
    """``remat_policy="save_mixer"`` against "full" on qwen1.5-0.5b at full
    width: one (f2)-sized client step, a loss_fn gradient over 8 x 512
    tokens (f32 params, bf16 compute), in L4["turns"] alternating turns
    (full, save_mixer, ...) after a warm-up of each: the step times, their
    medians and minima, and the peaks (the counter reset before each step; the first
    two steps' gradients of each policy moved to the host, so that a peak
    holds one step's); the losses and gradients bit for bit (the same ops
    in the same order), else within GRAD_RTOL if two "full" gradients
    differ too."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    label = "slice (l4) save_mixer qwen1.5-0.5b"
    cfg = get_config("qwen1.5-0.5b")
    params = get_model(cfg).init(prng.PRNGKey(0), device=device)
    batch = token_batch(cfg, L4["batch"], L4["seq"], device, seed=9)
    models = {pol: get_model(cfg.replace(remat_policy=pol))
              for pol in ("full", "save_mixer")}
    for model in models.values():
        loss_grads(model, params, batch)                             # warm-up
    runs = {"full": [], "save_mixer": []}
    for _ in range(L4["turns"]):
        for policy, rs in runs.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            (loss, grads), t = sync_time(lambda: loss_grads(models[policy], params, batch))
            peak = torch.cuda.max_memory_allocated() / 1e9
            kept = [loss.cpu()] + [g.cpu() for g in grads] if len(rs) < 2 else None
            rs.append((kept, 1e3 * t, peak))
            del loss, grads
    for model in models.values():                    # warm-up + the turns
        expected.add_grad(model.cfg, 1 + L4["turns"])
    (full, *_), (full2, *_) = runs["full"][:2]
    (sm, *_), (sm2, *_) = runs["save_mixer"][:2]
    repro = same_bits(full, full2) and same_bits(sm, sm2)
    bitwise = same_bits(full, sm)
    rel = rel_l2(sm[1:], full[1:])
    check(bitwise if repro else rel <= GRAD_RTOL,
          f"{label}: gradients off the full policy's by {rel} (bit for bit: "
          f"{bitwise}; two runs of each bit for bit: {repro})")
    row = dict(**L4, loss=float(full[0]), bitwise=bitwise, repeat_bitwise=repro,
               max_rel_l2=rel)
    for policy, rs in runs.items():
        row[f"{policy}_step_ms"] = [r[1] for r in rs]
        row[f"{policy}_median_ms"] = statistics.median(r[1] for r in rs)
        row[f"{policy}_min_ms"] = min(r[1] for r in rs)
        row[f"{policy}_peak_gb"] = max(r[2] for r in rs)
    report(label, row, ("full_median_ms", "save_mixer_median_ms", "full_min_ms",
                        "save_mixer_min_ms", "full_peak_gb",
                        "save_mixer_peak_gb", "bitwise"))
    print(f"{label}:", json.dumps(row), flush=True)
    del params, runs, full, full2, sm, sm2
    torch.cuda.empty_cache()
    return row


# ------------------------------------------- slice (m): the paper's layer
M1_ROUNDS = 3
# (m1)'s SYNTH pairs: the card's distance from the f64 run, at most this
# many times the CPU f32 run's (paper_run)
WITNESS_K = 10.0
# every paper run starts from init_fn(42), benchmarks/common.py's init_seed
PAPER_INIT = 42
# Fig. 2's 200 rounds cut to 20: a SYNTH round takes 83-149 ms on an
# H100 80GB HBM3 at 700 W (the host paces it, and hosts differ), so the 9
# runs take 15-27 s (30-54 s at 40 rounds, 150-270 s at 200); cut from 40
# to make room for slice (n) inside the script's time limit
M2_ROUNDS = 20
M2_SELECTIONS = ("fedalign", "priority_only", "all")
# bench_local_vs_global.py: the fmnist stand-in at 50 samples a client,
# batch 16, 20 rounds, the local baseline at three non-priority clients
M3_SAMPLES = 50
M3_FED = dict(num_priority=2, rounds=20, local_epochs=5, epsilon=0.2,
              lr=0.1, warmup_frac=0.1, batch_size=16)
M3_CLIENTS = [5, 20, 40]
M3_PARAMS_REL = 1e-4
# bench_theory.py's instance and eps grid at its full 200 rounds; the
# reference test's case (tests/test_theory.py: 60 rounds, eps 0.5)
M4_QUAD = dict(seed=3, n_priority=4, n_nonpriority=6, dim=8)
M4_E = 5
M4_ROUNDS = 200
M4_EPS = (0.0, 0.2, 0.5, 2.0, 1e9)
M4_BOUND_CASE = (60, 0.5)
M4_REL = 1e-12


def fig2_federation(skew):
    """benchmarks/bench_synth_noise.py's SYNTH(1,1) at one noise level."""
    from repro_torch.data.synth import make_synth_federation
    return make_synth_federation(seed=0, n_priority=10, n_nonpriority=10,
                                 samples_per_client=200,
                                 label_noise_factor=2.5,
                                 label_noise_skew=skew,
                                 random_data_factor=1.0,
                                 random_data_skew=skew)


def paper_configs():
    """(name, model, FedConfig, federation key, CPU check) for every paper
    configuration at M1_ROUNDS rounds: FIG1's three datasets, FIG2's three
    noise levels, FIG4, FIG5 and FIG6's points over FIG1's fmnist
    (``paper.py``'s docstring). A federation key is ("synth", skew) or
    ("shards", dataset, n_priority), built as the bench_*.py scripts
    build them with fast=False. The CPU check (``paper_run``) is "parity"
    for the fmnist ``logreg`` runs, "witness" for SYNTH, None for emnist's
    ``mlp2`` and cifar's ``cnn`` (the card alone)."""
    from repro_torch.configs import paper
    runs = [(f"fig1/{ds}", e["model"], e["fed"], ("shards", ds,
             e["fed"].num_priority), "parity" if e["model"] == "logreg"
             else None) for ds, e in paper.FIG1.items()]
    runs += [(f"fig2/{level}", e["model"], e["fed"], ("synth", e["skew"]),
              "witness") for level, e in paper.FIG2.items()]
    for name, e in (("fig4", paper.FIG4), ("fig5", paper.FIG5)):
        runs.append((name, e["model"], e["fed"],
                     ("shards", e["dataset"], e["fed"].num_priority),
                     "parity"))
    fm = paper.FIG1["fmnist"]
    for pt in paper.FIG6:
        fed = fm["fed"].replace(num_priority=pt["n_priority"],
                                local_epochs=pt["E"])
        runs.append((f"fig6/p{pt['n_priority']}_E{pt['E']}", fm["model"],
                     fed, ("shards", fm["dataset"], pt["n_priority"]),
                     "parity"))
    return [(name, model, fed.replace(rounds=M1_ROUNDS), key, cpu)
            for name, model, fed, key, cpu in runs]


def paper_federation(key, cache):
    from repro_torch.data.shards import make_benchmark_federation
    if key not in cache:
        cache[key] = (fig2_federation(key[1]) if key[0] == "synth" else
                      make_benchmark_federation(key[1], seed=0,
                                                n_priority=key[2]))
    return cache[key]


@contextmanager
def align_records():
    """Record each round's alignment statistics (the clients' values and
    the priority objective's) as the engine computes them."""
    from repro_torch.fl import engine
    rec = []
    update = engine.utility_update

    def recording(fed, util_ema, align_vals, global_align):
        rec.append((align_vals.cpu(), global_align.cpu()))
        return update(fed, util_ema, align_vals, global_align)

    engine.utility_update = recording
    try:
        yield rec
    finally:
        engine.utility_update = update


def align_margin(rec, hist, fedn):
    """min over the rounds and non-priority clients of | |a_k - a_P| - eps
    |: how far the run's gates were from flipping."""
    import numpy as np
    npri = ~np.asarray(fedn.priority_mask, bool)
    return min(float(np.min(np.abs(np.abs(a.numpy()[npri] - float(g)) - e)))
               for (a, g), e in zip(rec, hist.eps))


def deviation(h, ref):
    """(global loss rtol, test accuracy difference, params x max|p|) of
    run ``h`` from run ``ref``, each the largest over the rounds."""
    import numpy as np
    return (float(np.max(np.abs(np.array(h.global_loss)
                                / np.array(ref.global_loss) - 1.0))),
            float(np.max(np.abs(np.array(h.test_acc) - np.array(ref.test_acc)))),
            max(float((h.params[k].cpu() - ref.params[k]).abs().max()
                      / ref.params[k].abs().max()) for k in ref.params))


def f64_run(loss_fn, p0, fed, fedn, eval_every):
    """The same run on the CPU in f64 (params and inputs cast exactly): the
    trajectory that every f32 run of the configuration rounds."""
    import dataclasses
    import numpy as np
    from repro_torch.fl.simulator import run_federation
    from repro_torch.utils import tree_map
    f64 = dataclasses.replace(fedn, x=fedn.x.astype(np.float64),
                              test_x=fedn.test_x.astype(np.float64))
    return run_federation(loss_fn, tree_map(lambda p: p.double(), p0), fed,
                          f64, eval_every=eval_every, device="cpu")


def paper_run(check, name, model, fed, fedn, device, cpu, eval_every=1):
    """One paper configuration through run_federation on ``device`` from
    init_fn(PAPER_INIT): finite, one K1 launch a round, the gate margin.
    ``cpu`` runs it on the CPU too, from the same params: gates and
    included counts exactly; under "parity" also the global loss within
    rtol 1e-5 (slice (a)'s parity config's bound) and the test accuracy
    within one test example. Under "witness" (SYNTH at lr 0.1, slice (a)'s
    quickstart: its local SGD amplifies each step's rounding past those
    bounds within 3 rounds, so (a) holds only its gates) the run is also
    taken on the CPU in f64 (``f64_run``), and the card's loss, accuracy
    and params may be no more than WITNESS_K times as far from that run
    as the CPU's own f32 run is (each floored at the parity bounds and
    1e-5 x max|p|): an f32 run that rounds the same computation falls
    within a few times the CPU's distance, a wrong one does not."""
    import numpy as np
    import torch
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS[model]
    loss_fn = make_loss_fn(apply_fn)
    p0 = init_fn(PAPER_INIT, "cpu")
    before = fk.fedagg.launches
    with align_records() as rec:
        t0 = time.perf_counter()
        h = run_federation(loss_fn, p0, fed, fedn, eval_every=eval_every,
                           device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = fk.fedagg.launches - before
    finite = (np.all(np.isfinite(h.global_loss))
              and np.all(np.isfinite(h.test_acc))
              and all(bool(torch.isfinite(v).all()) for v in h.params.values()))
    check(bool(finite), f"{name}: non-finite loss, accuracy or params")
    if device != "cpu":
        check(launches == fed.rounds, f"{name}: {launches} fedagg launches "
              f"in {fed.rounds} rounds")
    row = dict(rounds=fed.rounds, seconds=secs,
               ms_per_round=1e3 * secs / fed.rounds, launches=launches,
               included=h.included, global_loss=h.global_loss,
               test_acc=h.test_acc, gate_margin=align_margin(rec, h, fedn))
    if cpu:
        t0 = time.perf_counter()
        ref = run_federation(loss_fn, p0, fed, fedn, eval_every=eval_every,
                             device="cpu")
        row["cpu_seconds"] = time.perf_counter() - t0
        check(np.array_equal(np.array(h.gates), np.array(ref.gates))
              and h.included == ref.included,
              f"{name}: gates or included counts differ from the CPU run")
        loss_rel, acc_diff, params_rel = deviation(h, ref)
        row.update(global_loss_rtol_vs_cpu=loss_rel, acc_diff_vs_cpu=acc_diff,
                   params_rel_err_vs_cpu=params_rel)
        if cpu == "parity":
            n_test = len(fedn.test_y)
            check(loss_rel <= 1e-5, f"{name}: global loss off the CPU run by "
                  f"rtol {loss_rel}")
            check(acc_diff <= 1.0 / n_test + 1e-7, f"{name}: test accuracy "
                  f"off the CPU run by {acc_diff} (1 / n_test = "
                  f"{1.0 / n_test})")
        else:
            exact = f64_run(loss_fn, p0, fed, fedn, eval_every)
            card, own = deviation(h, exact), deviation(ref, exact)
            row["vs_f64"] = dict(card=card, cpu_f32=own)
            floors = (1e-5, 1.0 / len(fedn.test_y), 1e-5)
            for what, c, w, f in zip(("global loss rtol", "test accuracy",
                                      "params x max|p|"), card, own, floors):
                check(c <= WITNESS_K * max(w, f), f"{name}: the card's "
                      f"{what} {c} off the f64 run, over {WITNESS_K} x the "
                      f"CPU f32 run's {w} (floor {f})")
    print(f"slice (m1) {name}:", json.dumps(row), flush=True)
    return row


def slice_m1(check: Check, cifar_fedn, device="cuda"):
    """Every paper configuration (``paper_configs``) at its full data size
    for M1_ROUNDS rounds through run_federation on the card; the logreg
    and SYNTH ones held against the CPU, emnist's mlp2 and cifar's cnn on
    the card alone (cifar on slice (b)'s federation, the same build). A
    run identical to an earlier one (FIG6's (2, 5) point is FIG1's fmnist
    config) is reported under both names and run once. Returns the rows,
    the FIG2 federations (m2 reuses them) and the rounds run."""
    feds = {("shards", "cifar", 2): cifar_fedn}
    out, done, rounds = {}, {}, 0
    t0 = time.perf_counter()
    for name, _, _, key, _ in paper_configs():
        paper_federation(key, feds)
    data_s = time.perf_counter() - t0
    for name, model, fed, key, cpu in paper_configs():
        if (fed, key) in done:
            out[name] = dict(out[done[(fed, key)]], same_as=done[(fed, key)])
            print(f"slice (m1) {name}: the run of {done[(fed, key)]}",
                  flush=True)
            continue
        out[name] = paper_run(check, name, model, fed,
                              paper_federation(key, feds), device, cpu)
        done[(fed, key)] = name
        rounds += fed.rounds
    print(f"slice (m1): federations built in {data_s:.1f} s", flush=True)
    synth = {k[1]: v for k, v in feds.items() if k[0] == "synth"}
    return dict(runs=out, data_gen_s=data_s), synth, rounds


def slice_m2(check: Check, synth, device="cuda"):
    """Paper Fig. 2 on the card: each SYNTH noise level (m1's federations)
    under fedalign, priority_only and all, M2_ROUNDS rounds from
    init_fn(PAPER_INIT), evaluated every 5 rounds (benchmarks/common.py's
    fed_suite). Final and best accuracy and mean included are findings;
    the checks are finite values in [0, 1] and one K1 launch a round."""
    import numpy as np
    import torch
    from repro_torch.configs import paper
    from repro_torch.fl.simulator import run_federation
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS["synth_logreg"]
    loss_fn = make_loss_fn(apply_fn)
    if M2_ROUNDS < paper.FIG2["low"]["fed"].rounds:
        print(f"slice (m2): rounds cut from {paper.FIG2['low']['fed'].rounds}"
              f" to {M2_ROUNDS} to keep the phase near a minute", flush=True)
    out, rounds = {}, 0
    for level, e in paper.FIG2.items():
        for sel in M2_SELECTIONS:
            fed = e["fed"].replace(rounds=M2_ROUNDS, selection=sel, seed=0)
            before = fk.fedagg.launches
            t0 = time.perf_counter()
            h = run_federation(loss_fn, init_fn(PAPER_INIT, device), fed,
                               synth[e["skew"]], eval_every=5, device=device)
            if device != "cpu":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = fk.fedagg.launches - before
            s = h.summary()
            name = f"slice (m2) {level}/{sel}"
            accs = np.array(h.test_acc)
            check(bool(np.all(np.isfinite(accs)) and np.all(accs >= 0)
                       and np.all(accs <= 1)
                       and np.all(np.isfinite(h.global_loss))),
                  f"{name}: accuracy or loss not finite in [0, 1]")
            if device != "cpu":
                check(launches == M2_ROUNDS, f"{name}: {launches} fedagg "
                      f"launches in {M2_ROUNDS} rounds")
            row = dict(final_acc=s["final_acc"], best_acc=s["best_acc"],
                       mean_included=s["mean_included"],
                       final_loss=s["final_loss"], seconds=secs,
                       ms_per_round=1e3 * secs / M2_ROUNDS, launches=launches)
            out[f"{level}/{sel}"] = row
            rounds += M2_ROUNDS
            print(f"{name}:", json.dumps(row), flush=True)
    return out, rounds


def slice_m3(check: Check, device="cuda"):
    """Paper App. C.1 / Fig. 3: FedALIGN for 20 rounds against locally
    trained models on the fmnist stand-in at 50 samples a client
    (bench_local_vs_global.py). The two halves of ``run_local_baseline``:
    ``train_local_baseline`` for M3_CLIENTS on the card and on the CPU
    (accuracies by ``local_accuracies`` as counts of correct test examples
    exactly, the trained params within M3_PARAMS_REL x max|p|); then all
    60 clients in one solve on the card, its training timed as the three
    clients' is, then evaluated."""
    import numpy as np
    import torch
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.shards import make_benchmark_federation
    from repro_torch.fl.simulator import (local_accuracies, run_federation,
                                          train_local_baseline)
    from repro_torch.kernels import fedagg as fk
    from repro_torch.models.small import SMALL_MODELS, make_loss_fn
    init_fn, apply_fn = SMALL_MODELS["logreg"]
    loss_fn = make_loss_fn(apply_fn)
    fedn = make_benchmark_federation("fmnist", seed=0, n_priority=2,
                                     samples_per_client=M3_SAMPLES)
    fed = FedConfig(num_clients=fedn.x.shape[0], **M3_FED)
    n_test = len(fedn.test_y)
    before = fk.fedagg.launches
    t0 = time.perf_counter()
    h = run_federation(loss_fn, init_fn(PAPER_INIT, device), fed, fedn,
                       eval_every=5, device=device)
    fed_s = time.perf_counter() - t0
    launches = fk.fedagg.launches - before
    if device != "cpu":
        check(launches == fed.rounds, f"slice (m3): {launches} fedagg "
              f"launches in {fed.rounds} rounds")
    check(bool(np.all(np.isfinite(h.test_acc))), "slice (m3): non-finite "
          "FedALIGN accuracy")

    def train(client_ids, on):
        if on != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, params = train_local_baseline(loss_fn, init_fn, fed, fedn,
                                           client_ids=client_ids, device=on)
        if on != "cpu":
            torch.cuda.synchronize()
        return ids, params, time.perf_counter() - t0

    ids, dev_params, three_s = train(M3_CLIENTS, device)
    accs = local_accuracies(loss_fn, fedn, ids, dev_params)
    _, cpu_params, _ = train(M3_CLIENTS, "cpu")
    cpu_accs = local_accuracies(loss_fn, fedn, ids, cpu_params)
    check({c: round(a * n_test) for c, a in accs.items()}
          == {c: round(a * n_test) for c, a in cpu_accs.items()},
          f"slice (m3): local accuracies {accs} differ from the CPU's "
          f"{cpu_accs}")
    rel = max(float((dev_params[k].cpu() - cpu_params[k]).abs().max()
                    / cpu_params[k].abs().max()) for k in cpu_params)
    check(rel <= M3_PARAMS_REL, f"slice (m3): local params off the CPU run "
          f"by {rel} x max|p|")
    all_ids, all_params, all_s = train(None, device)
    all_accs = local_accuracies(loss_fn, fedn, all_ids, all_params)
    vals = np.array(list(all_accs.values()))
    check(len(all_accs) == fedn.x.shape[0] and bool(np.all(np.isfinite(vals))),
          "slice (m3): the all-client baseline is incomplete or non-finite")
    out = dict(fedalign_final_acc=h.summary()["final_acc"],
               fedalign_seconds=fed_s, launches=launches, local_accs=accs,
               local_accs_cpu=cpu_accs, local_params_rel_err_vs_cpu=rel,
               three_clients_train_seconds=three_s,
               all_clients_train_seconds=all_s,
               all_local_min=float(vals.min()),
               all_local_median=float(np.median(vals)),
               all_local_max=float(vals.max()),
               fedalign_beats_every_local=bool(h.summary()["final_acc"]
                                               > vals.max()))
    print("slice (m3):", json.dumps(out), flush=True)
    return out


def theorem1_row(q, T, eps, record=None):
    """bench_theory.py's row for one eps: the error F(w_T) - F(w*) (as
    ``excess``: the same value without the subtraction's rounding), the
    bound with the paper's constants (sigma 0; bench_theory's G),
    theta_T, rho, and w_T."""
    import numpy as np
    import torch
    from repro_torch.core import theory
    L, mu = q.smoothness()
    gamma = max(8 * L / mu, M4_E)
    t0 = time.perf_counter()
    w_T, th, rh = theory.run_fedalign_gd(q, T, M4_E, eps,
                                         lambda t: 2.0 / (mu * (t + gamma)),
                                         record=record)
    secs = time.perf_counter() - t0
    err = float(q.excess(w_T))
    theta_T, rho_un = theory.empirical_theta_rho(th, rh, gamma, M4_E)
    zero = torch.zeros_like(q.c[0])
    G = np.sqrt(max(float(torch.linalg.norm(q.A[k] @ (zero - q.c[k]))) ** 2
                    for k in range(len(q.d))) * 4 + 1.0)
    C1, C2, _ = theory.theorem1_constants(
        L, mu, 0.0, G, M4_E, float(torch.linalg.norm(q.w_star())) ** 2)
    bound = theory.theorem1_bound(T * M4_E, C1=C1, C2=C2, gamma=gamma,
                                  Gamma=float(q.gamma()), theta_T=theta_T,
                                  rho_T=2 * L / mu * rho_un)
    return dict(eps=eps, error=err, bound=bound, theta_T=theta_T,
                rho_unscaled=rho_un, bound_holds=bool(err <= bound),
                seconds=secs, w_T=w_T.cpu().tolist())


def rel_diff(a, b) -> float:
    scale = max(abs(a), abs(b))
    return 0.0 if scale == 0 else abs(a - b) / scale


def slice_m4(check: Check, device="cuda"):
    """Theorem 1 on the card in f64: bench_theory.py's instance at
    M4_ROUNDS rounds for each eps of M4_EPS, against the CPU (gates every
    round exactly; error, theta_T, rho and w_T within M4_REL relative);
    the bound must hold at the reference test's case."""
    import numpy as np
    from repro_torch.core import theory
    qs = {d: theory.make_quadratic_pfl(**M4_QUAD, device=d)
          for d in ("cpu", device)}
    out = {}
    for eps in M4_EPS:
        recs = {d: {} for d in qs}
        rows = {d: theorem1_row(q, M4_ROUNDS, eps, recs[d])
                for d, q in qs.items()}
        dev, cpu = rows[device], rows["cpu"]
        check(np.array_equal(recs[device]["gates"], recs["cpu"]["gates"]),
              f"slice (m4) eps {eps}: gates differ from the CPU run")
        worst = max([rel_diff(dev[k], cpu[k])
                     for k in ("error", "theta_T", "rho_unscaled")]
                    + [max(abs(a - b) for a, b in zip(dev["w_T"], cpu["w_T"]))
                       / max(abs(b) for b in cpu["w_T"])])
        check(worst <= M4_REL, f"slice (m4) eps {eps}: off the CPU run by "
              f"{worst} relative")
        dev.update(rel_err_vs_cpu=worst, cpu_seconds=cpu["seconds"],
                   gate_margin=float(recs[device]["margin"].min()))
        out[str(eps)] = dev
        print(f"slice (m4) eps {eps}:", json.dumps(dev), flush=True)
    T, eps = M4_BOUND_CASE
    row = theorem1_row(qs[device], T, eps)
    check(row["bound_holds"], f"slice (m4): the bound fails at {T} rounds, "
          f"eps {eps}: {row}")
    out[f"bound_case_T{T}_eps{eps}"] = row
    print("slice (m4) the reference test's case:", json.dumps(row), flush=True)
    return out


def paper_phases(check: Check, cifar_fedn):
    """Slices (m1)-(m4), counted on their own: every round of (m1)-(m3)
    aggregates through K1 (mean over identity), once; no other kernel
    runs. Returns {"m1": ..., "m4": ...} and the fedagg launches by
    (aggregator, codec)."""
    from repro_torch.kernels import fedagg as fk
    reset_train_counts()
    m1, synth, m1_rounds = phase(slice_m1, check, cifar_fedn)
    m2, m2_rounds = phase(slice_m2, check, synth)
    m3 = phase(slice_m3, check)
    m4 = phase(slice_m4, check)
    launches = train_counts()
    variants = dict(fk.fedagg.variant_launches)
    expected = m1_rounds + m2_rounds + M3_FED["rounds"]
    print("paper path launches:", json.dumps(launches), "expected:",
          json.dumps({"fedagg": expected}), flush=True)
    check(launches["fedagg"] == expected, f"paper path: "
          f"{launches['fedagg']} fedagg launches, expected {expected}")
    check(set(variants) == {("mean", "identity")}, "paper path: fedagg ran "
          f"other variants than mean over identity: {sorted(variants)}")
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "ssm_scan"):
        check(launches[name] == 0, f"paper path: {launches[name]} {name} "
              "launches, expected none")
    return dict(m1=m1, m2=m2, m3=m3, m4=m4), variants


# ------------------------------------- slice (n): the pod round's data axes
# (n1): qwen1.5-0.5b at full width (f32 params, bf16 compute), 4 clients of
# 4 x 512 tokens, E 2, through launch.train.run on a one-rank NCCL mesh:
# 2 rounds under mean, then 1 each under dp, median and int8 (error
# feedback on)
N1_RUN = dict(arch="qwen1.5-0.5b", smoke=False, clients=4, n_priority=2,
              per_client=4, seq=512, local_epochs=2, lr=0.05)
N1_CASES = [("mean", 2, {}),
            ("dp", 1, dict(aggregator="dp", dp_clip=1.0, dp_noise=0.01)),
            ("median", 1, dict(aggregator="median")),
            ("int8", 1, dict(wire_codec="int8"))]
H100_GB = 80.0
# (n1)'s fedagg outputs are held against fedagg_plain this many columns at
# a time, so the plain median's bitonic temporaries stay near 2 GB
N1_PLAIN_COLS = 1 << 25


def plain_by_columns(updates, w, g, ops, out):
    """(max_abs_err, max|u|) of a fedagg output against ``fedagg_plain`` on
    the same operands, N1_PLAIN_COLS columns at a time: mean, dp, trimmed
    mean and median over the identity or int8 wire reduce each column
    alone, so no [C, M] temporary of the plain version outlives its chunk.
    max|u| is over the included rows, decoded."""
    import torch
    from repro_torch.kernels import fedagg as fk
    ops = dict(ops)
    codec = ops.pop("codec", "identity")
    scales = ops.pop("dequant_scale", None)
    if codec not in ("identity", "int8"):
        raise ValueError(f"plain_by_columns: codec {codec!r}")
    noise = ops.pop("noise", None)
    inc = (w * g) > 0
    err = top = 0.0
    for lo in range(0, out.shape[0], N1_PLAIN_COLS):
        hi = min(lo + N1_PLAIN_COLS, out.shape[0])
        u = updates[:, lo:hi]
        if codec == "int8":
            u = fk.decode_wire_plain(u, codec="int8", dequant_scale=scales)
        want = fk.fedagg_plain(u, w, g, noise=None if noise is None
                               else noise[lo:hi], **ops)
        err = max(err, float(torch.max(torch.abs(out[lo:hi].float()
                                                 - want.float()))))
        if bool(inc.any()):
            top = max(top, float(torch.max(torch.abs(u[inc].float()))))
    return err, top


@contextmanager
def beside_spatial(rec):
    """Each pod round ``launch.train.run`` makes inside the block runs, on
    the same state and batch, beside the one-process ``make_spatial_round``
    (one rank holds every client, so its block is the whole batch). rec
    gets, a round: both rounds' seconds and peak GB, whether gates,
    included count and every param leaf are the same bits, and the
    collectives the pod round recorded. In each run's first round every
    fedagg launch of the pod round's reduce is also held against
    ``fedagg_plain`` on the operands it received (``plain_by_columns``),
    under "plain" (none in later rounds)."""
    import torch
    from repro_torch.fl import sharded
    from repro_torch.utils import tree_leaves
    make = sharded.make_pod_round
    fedagg = sharded.kops.fedagg

    def held(holds):
        def fedagg_held(updates, weights, gates, *, noise=None, **kw):
            out = fedagg(updates, weights, gates, noise=noise, **kw)
            # the hold's time and memory stay out of the round's figures:
            # its seconds are taken off, its temporaries' peak forgotten
            torch.cuda.synchronize()
            peak, t0 = torch.cuda.max_memory_allocated(), time.perf_counter()
            err, top = plain_by_columns(updates, weights, gates,
                                        dict(kw, noise=noise), out)
            finite = bool(torch.isfinite(out).all())
            holds.append(dict(aggregator=kw.get("aggregator", "mean"),
                              codec=kw.get("codec", "identity"),
                              shape=list(updates.shape), max_abs_err=err,
                              max_abs_u=top, finite=finite,
                              seconds=time.perf_counter() - t0,
                              peak_before=peak))
            torch.cuda.reset_peak_memory_stats()
            return out
        return fedagg_held

    def timed(step, state, batch, r):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = step(state, batch, r)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9

    def recording_make(model, fed, num_clients, mesh, device="cuda"):
        pod_step = make(model, fed, num_clients, mesh, device=device)
        spatial = sharded.make_spatial_round(model, fed, num_clients, device=device)

        def step(state, batch, round_idx=0):
            sharded.COLLECTIVES.clear()
            holds = []
            if not rec:                     # the run's first round
                sharded.kops.fedagg = held(holds)
            try:
                (new, stats), pod_s, pod_gb = timed(pod_step, state, batch,
                                                    round_idx)
            finally:
                sharded.kops.fedagg = fedagg
            pod_s -= sum(h["seconds"] for h in holds)
            pod_gb = max([pod_gb] + [h.pop("peak_before") / 1e9 for h in holds])
            coll = list(sharded.COLLECTIVES)
            (ref, ref_stats), sp_s, sp_gb = timed(spatial, state, batch, round_idx)
            same = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(new.params), tree_leaves(ref.params)))
            rec.append(dict(
                pod_s=pod_s, spatial_s=sp_s, pod_peak_gb=pod_gb,
                spatial_peak_gb=sp_gb, params_equal=same,
                gates_equal=bool(torch.equal(stats["gates"], ref_stats["gates"])),
                included=float(stats["gates"].sum()),
                included_spatial=float(ref_stats["gates"].sum()),
                collectives=coll, plain=holds))
            del ref, ref_stats
            return new, stats
        for attr in ("pod", "specs", "shard", "gather"):
            setattr(step, attr, getattr(pod_step, attr))
        return step

    sharded.make_pod_round = recording_make
    try:
        yield
    finally:
        sharded.make_pod_round = make


def slice_n1(check: Check, expected: TrainExpected, device="cuda"):
    """The pod round on a one-rank NCCL group (``make_host_mesh(1)``: data
    1, model 1), through ``launch.train.run(..., mesh=...)``, each round
    beside ``make_spatial_round`` on the same state and batch (N1_RUN,
    N1_CASES). At one rank the rank's partial is the whole and NCCL's
    in-place all-reduce of one rank is the identity, so gates, included
    count and every param leaf must be the same bits. The recorded
    collectives must equal ``pod_round_plan``: the [C] f32 loss gather and
    one all-reduce of the [M_total] f32 aggregate a round, or under median
    the gather of the [C, M_total] rows. Each case's first round holds its
    one fedagg launch (K1 mean, K2 dp, K3 median, K4 int8) against
    ``fedagg_plain`` on the [C, M_total] operands the pod reduce gave it,
    within F32_TOL x max|u| (the kernel phases stop at 60 x 579,402, and
    f2's [8, M_total] cases hold mean only)."""
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedConfig
    from repro_torch.fl import sharded
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import param_shapes
    from repro_torch.utils import param_count
    cfg = get_config(N1_RUN["arch"])
    M = param_count(param_shapes(cfg))
    C, E = N1_RUN["clients"], N1_RUN["local_epochs"]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        for name, rounds, knobs in N1_CASES:
            torch.cuda.empty_cache()
            rec = []
            with beside_spatial(rec):
                params, hist = train.run(rounds=rounds, device=device,
                                         mesh=mesh, verbose=False,
                                         **N1_RUN, **knobs)
            del params
            # the pod round and the spatial round beside it, each round
            expected.add_rounds(cfg, C, E, 2 * rounds)
            fed = FedConfig(num_clients=C, **knobs)
            plan = sharded.pod_round_plan(fed, M, C, 1)
            for r, row in enumerate(rec):
                label = f"slice (n1) {name} round {r}"
                check(row["params_equal"], f"{label}: params differ from "
                      "make_spatial_round's")
                check(row["gates_equal"] and row["included"]
                      == row["included_spatial"] == hist[r]["included"]
                      + N1_RUN["n_priority"], f"{label}: gates or included "
                      "count differ from make_spatial_round's")
                check(row["collectives"] == plan, f"{label}: collectives "
                      f"{row['collectives']}, planned {plan}")
            # the round's one fedagg launch against its plain version on
            # the operands the pod reduce gave it, at (n1)'s own shape
            want = [knobs.get("aggregator", "mean"),
                    knobs.get("wire_codec", "identity"), [C, M]]
            holds = rec[0]["plain"] if rec else []
            check([[h["aggregator"], h["codec"], h["shape"]] for h in holds]
                  == [want], f"slice (n1) {name}: fedagg launches held "
                  f"{holds}, expected one {want}")
            for h in holds:
                check(h["finite"] and h["max_abs_err"]
                      <= F32_TOL * h["max_abs_u"], f"slice (n1) {name}: "
                      f"fedagg {h['aggregator']}/{h['codec']} at {h['shape']}"
                      f": max_abs_err {h['max_abs_err']} against the plain "
                      f"version, bound {F32_TOL} x {h['max_abs_u']}")
            ok = all(math.isfinite(h["server_loss"]) for h in hist)
            check(ok and len(hist) == rounds, f"slice (n1) {name}: "
                  "non-finite server loss")
            row = dict(rounds=rounds, M_total=M, plan=plan, plain=holds,
                       server_loss=[h["server_loss"] for h in hist],
                       **{k: [x[k] for x in rec] for k in
                          ("pod_s", "spatial_s", "pod_peak_gb",
                           "spatial_peak_gb", "params_equal", "included")})
            out[name] = row
            print(f"slice (n1) {name}:", json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


N2_MESHES = (("single", []), ("multi", ["--multi-pod"]))


def start_n2(tmp):
    """Start slice (n2)'s dry-run: one CPU subprocess that plans every
    baseline target on both production meshes (the CLI once a mesh), into
    ``tmp``, while slice (n1) holds the card."""
    import os
    code = ("from repro_torch.launch import dryrun\n" + "".join(
        f"dryrun.main({['--out', os.path.join(tmp, mesh)] + flags!r})\n"
        for mesh, flags in N2_MESHES))
    return subprocess.Popen(
        [sys.executable, "-c", code], cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def slice_n2(check: Check, proc, tmp, started):
    """The dry-run planner over every baseline target (10 archs x 4 shapes,
    whisper's long_500k skipped) on the single and the multi-pod
    production mesh (``start_n2``'s subprocess; CPU work, no card): it
    exits 0, and each target's GB a device is printed beside an H100's 80
    GB."""
    log, _ = proc.communicate(timeout=600)
    wall = time.perf_counter() - started
    check(proc.returncode == 0, f"slice (n2) dry-run: exit "
          f"{proc.returncode}: {log[-2000:]}")
    table = {}
    for mesh, _ in N2_MESHES:
        for path in sorted(Path(tmp, mesh).glob("*.json")):
            rec = json.loads(path.read_text())
            key = f"{rec['arch']}/{rec['shape']}/{mesh}"
            if rec["status"] != "ok":
                table[key] = rec["status"]
                continue
            gb = rec["bytes_per_device"]["total"] / 1e9
            table[key] = dict(gb_per_device=gb, of_h100=gb / H100_GB,
                              devices=rec["devices"])
    ok = sum(isinstance(v, dict) for v in table.values())
    check(ok == 78, f"slice (n2): {ok} targets planned, expected 78")
    for key, v in table.items():
        print(f"slice (n2) {key}:", json.dumps(v))
    return {"targets": ok, "wall_s": wall, "max_gb_per_device": max(
        v["gb_per_device"] for v in table.values() if isinstance(v, dict))}


def pod_phases(check: Check):
    """Slices (n1) and (n2), counted on their own: every pod round and the
    spatial round beside it train through K5, K6 and K9 and aggregate
    through K1 (mean), K2 (dp), K3 (median) or K4 (int8) once; (n2)'s CPU
    subprocess runs while (n1) holds the card. Returns
    ({"n1": ..., "n2": ...}, the training launches, the fedagg launches
    by (aggregator, codec))."""
    import tempfile
    from repro_torch.kernels import fedagg as fk
    with tempfile.TemporaryDirectory() as tmp:
        started = time.perf_counter()
        proc = start_n2(tmp)
        try:
            reset_train_counts()
            n_expected = TrainExpected()
            n1 = phase(slice_n1, check, n_expected)
            launches = train_counts()
            variants = dict(fk.fedagg.variant_launches)
            n2 = phase(slice_n2, check, proc, tmp, started)
        finally:
            proc.kill()
    print("pod path launches:", json.dumps(launches), "expected:",
          json.dumps(n_expected), flush=True)
    for name in TRAIN_KERNELS:
        check(launches[name] == n_expected[name], f"pod path: "
              f"{launches[name]} {name} launches, expected {n_expected[name]}")
    want = {("mean", "identity"): 4, ("dp", "identity"): 2,
            ("median", "identity"): 2, ("mean", "int8"): 2}
    check(variants == want, f"pod path: fedagg variants {variants}, "
          f"expected {want}")
    return dict(n1=n1, n2=n2), launches, variants


# ---------------------------------------- slice (o): the pod round's model axis
# (o1): qwen1.5-0.5b at full width (d 1024, 16 / 16 heads, vocab 151,936;
# O1_LAYERS of its 24 layers) in f32 params and f32 compute, 4 clients x 2
# x 512, E 2,
# 2 rounds, on a (data 1, model 2) mesh of two spawned processes on cuda:0
# joined by gloo (NCCL cannot put two ranks on one card), each config held
# against the one-process make_spatial_round on the card on the same
# batches; mean, median, and mean under seq_shard_attn
O1_RUN = dict(arch="qwen1.5-0.5b", clients=4, n_priority=2, per_client=2,
              seq=512, local_epochs=2, lr=0.05)
# 12 of the 24 layers: uncut, the slice took 138.2 s on an H100 (10-20 s a
# pod round), past its ~90 s; every width is the published one
O1_LAYERS = 12
O1_ROUNDS = 2
O1_EPS = 0.5
O1_CASES = (("mean", {}, False), ("median", {"aggregator": "median"}, False),
            ("mean_seq", {}, True))
# x max(1, |param|): tests/test_torch_model_axis.py's params bound, 10x
# the reference's own mesh-vs-one-device gap on a CPU host mesh (1.1912e-7
# there: one ulp of a norm scale above 1); the test holds this constant
# under the bound it measures
O1_PARAMS_TOL = 1.19e-6
O1_TIMEOUT_S = 600


def _digest(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def o1_rank(rank, tmp, device="cuda"):
    """One of (o1)'s two gloo ranks on cuda:0 (a FileStore in ``tmp``):
    every O1_CASES config through ``make_pod_round`` on the (data 1, model
    2) mesh, the params drawn whole from PRNGKey(0) and sharded; per round
    its stats, seconds, peak GB, collectives and trained clients, then its
    launch counts, its replicated leaves' digest and the params gathered
    whole. Rank 0 then runs the one-process ``make_spatial_round`` on the
    same batches (rank 1 waits) and keeps its stats and the params' gap.
    Pickles what it saw to ``tmp/rank<r>.pkl``; a failure is pickled as
    its traceback. ``device="cpu"`` rehearses it without a card (no
    seconds or peaks worth reading)."""
    import os
    import pickle
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedConfig
    from repro_torch.data.tokens import make_token_federation
    from repro_torch.fl import engine, sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_batches
    from repro_torch.models import get_model
    from repro_torch.sharding import model_axis
    from repro_torch.utils import tree_leaves
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 2), rank=rank, world_size=2)
    out = {"cases": {}}
    run, C = O1_RUN, O1_RUN["clients"]
    train_stack = sharded._train_stack
    trained = []

    def counting(model, params, client_batch, rows, *a, **kw):
        trained[-1] += len(rows)
        return train_stack(model, params, client_batch, rows, *a, **kw)

    def stats_np(st):
        return {k: v.detach().cpu().numpy().copy() for k, v in st.items()}
    try:
        mesh = make_host_mesh(2, device_type=dev.type)
        base = get_config(run["arch"]).replace(compute_dtype="float32",
                                               num_layers=O1_LAYERS)
        data = make_token_federation(
            seed=0, vocab=base.vocab_size, n_clients=C,
            n_priority=run["n_priority"], seq_len=run["seq"],
            misalign_max=1.0, tokens_per_client=max(
                8192, run["per_client"] * (run["seq"] + 1) * 4))
        sharded._train_stack = counting
        for name, knobs, seq in O1_CASES:
            cfg = base.replace(seq_shard_attn=seq)
            model = get_model(cfg)
            fed = FedConfig(num_clients=C, num_priority=run["n_priority"],
                            local_epochs=run["local_epochs"], lr=run["lr"],
                            epsilon=O1_EPS, **knobs)
            step = sharded.make_pod_round(model, fed, C, mesh, device=dev)
            state = engine.init_state(step.shard(model.init(
                prng.PRNGKey(0), device=dev)), fed, C)
            rec = dict(stats=[], seconds=[], peak_gb=[], collectives=[])
            trained.clear()
            reset_train_counts()
            rng = np.random.default_rng(0)
            for r in range(O1_ROUNDS):
                batch = build_batches(cfg, data, clients=C,
                                      per_client=run["per_client"],
                                      seq=run["seq"], rng=rng, device=dev,
                                      block=step.pod.block(C))
                sharded.COLLECTIVES.clear()
                trained.append(0)
                sync()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, st = step(state, batch, r)
                sync()
                rec["seconds"].append(time.perf_counter() - t0)
                rec["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9
                                      if cuda else 0.0)
                rec["stats"].append(stats_np(st))
                rec["collectives"].append(list(sharded.COLLECTIVES))
            rec["launches"] = train_counts()
            rec["variants"] = dict(sharded.kops.fedagg.variant_launches)
            rec["trained"] = list(trained)
            rec["M_local"] = sum(t.numel() for t in tree_leaves(state.params))
            rec["replicated"] = _digest(model_axis.replicated_leaves(
                state.params, step.specs))
            full = step.gather(state.params)
            del state
            dist.barrier()
            if rank == 0:
                spatial = sharded.make_spatial_round(model, fed, C, device=dev)
                ref = engine.init_state(model.init(prng.PRNGKey(0), device=dev),
                                        fed, C)
                one = dict(stats=[], seconds=[])
                rng = np.random.default_rng(0)
                for r in range(O1_ROUNDS):
                    batch = build_batches(cfg, data, clients=C,
                                          per_client=run["per_client"],
                                          seq=run["seq"], rng=rng, device=dev)
                    trained.append(0)
                    sync()
                    t0 = time.perf_counter()
                    ref, st = spatial(ref, batch, r)
                    sync()
                    one["seconds"].append(time.perf_counter() - t0)
                    one["stats"].append(stats_np(st))
                rec["one"] = one
                rec["params_err"] = max(
                    float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for a, b in zip(tree_leaves(full), tree_leaves(ref.params)))
                del ref
            del full
            if cuda:
                torch.cuda.empty_cache()
            dist.barrier()
            out["cases"][name] = rec
    except Exception:                   # noqa: BLE001 - sent to the parent
        out["error"] = traceback.format_exc()
    finally:
        sharded._train_stack = train_stack
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def slice_o1(check: Check, device="cuda"):
    """(o1): two ranks on cuda:0 over gloo (``o1_rank``), each config of
    O1_CASES held against the one-process round on the card: every gate
    and backlog the same, each non-priority gap farther than GATE_MARGIN
    from eps; the gathered params within O1_PARAMS_TOL x max(1, |param|);
    both ranks' replicated leaves (the norm scales) the same bits; each
    rank's collectives ``pod_round_plan``'s with the model axis's
    ``LossPlan``; each rank's launches a one-process run's. Returns
    (row, the launches of both ranks summed, their fedagg variants)."""
    import os
    import pickle
    import tempfile
    import numpy as np
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedConfig
    from repro_torch.fl import sharded
    from repro_torch.sharding.model_axis import LossPlan
    run, C = O1_RUN, O1_RUN["clients"]
    P, E = run["n_priority"], run["local_epochs"]
    shape = (run["per_client"], run["seq"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(o1_rank, args=(tmp, device), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + O1_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise RuntimeError("slice (o1): the ranks timed out")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        recs = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    for r, rec in enumerate(recs):
        check("error" not in rec, f"slice (o1) rank {r}: {rec.get('error')}")
    out, launches, variants = {}, {}, {}
    base = get_config(run["arch"]).replace(compute_dtype="float32",
                                           num_layers=O1_LAYERS)
    for name, knobs, seq in O1_CASES:
        label = f"slice (o1) {name}"
        got = [rec["cases"].get(name) for rec in recs]
        if not all(got):
            check(False, f"{label}: a rank has no record")
            continue
        cfg = base.replace(seq_shard_attn=seq)
        fed = FedConfig(num_clients=C, num_priority=P, local_epochs=E,
                        lr=run["lr"], epsilon=O1_EPS, **knobs)
        plan = LossPlan(cfg, 2, shape, shape)
        one = got[0]["one"]
        for r, st in enumerate(one["stats"]):
            gaps = np.abs(st["local_losses"] - st["server_loss"])[P:]
            check(bool(np.all(np.abs(gaps - O1_EPS) > GATE_MARGIN)),
                  f"{label} round {r}: a gap {gaps} within {GATE_MARGIN} of "
                  f"eps {O1_EPS}")
        want = TrainExpected()
        want.add_rounds(cfg, C, E, O1_ROUNDS)
        for k, rec in enumerate(got):
            for r, (g, w) in enumerate(zip(rec["stats"], one["stats"])):
                check(all(np.array_equal(g[key], w[key])
                          for key in ("gates", "backlog")),
                      f"{label} rank {k} round {r}: gates {g['gates']} / "
                      f"backlog {g['backlog']}, one process {w['gates']} / "
                      f"{w['backlog']}")
            for r, coll in enumerate(rec["collectives"]):
                planned = sharded.pod_round_plan(
                    fed, rec["M_local"], C, 1, model=plan,
                    trained=rec["trained"][r])
                check(coll == planned, f"{label} rank {k} round {r}: "
                      f"{len(coll)} collectives, planned {len(planned)}")
            check(rec["launches"] == dict(want), f"{label} rank {k}: launches "
                  f"{rec['launches']}, expected {dict(want)}")
            for key, n in rec["launches"].items():
                launches[key] = launches.get(key, 0) + n
            for key, n in rec["variants"].items():
                variants[key] = variants.get(key, 0) + n
        check(got[0]["replicated"] == got[1]["replicated"],
              f"{label}: the ranks' replicated leaves differ")
        err = got[0]["params_err"]
        check(err <= O1_PARAMS_TOL, f"{label}: params {err} x max(1, |param|) "
              f"from the one-process round's, bound {O1_PARAMS_TOL}")
        colls = got[0]["collectives"][0]
        row = dict(
            pod_s=got[0]["seconds"], pod_s_rank1=got[1]["seconds"],
            spatial_s=one["seconds"],
            peak_gb=[max(rec["peak_gb"]) for rec in got],
            params_err=err, M_local=got[0]["M_local"],
            gates=[st["gates"].tolist() for st in one["stats"]],
            gaps=[np.abs(st["local_losses"] - st["server_loss"])[P:].tolist()
                  for st in one["stats"]],
            server_loss=[float(st["server_loss"]) for st in one["stats"]],
            collectives_a_round={
                grp: dict(count=sum(c["group"] == grp for c in colls),
                          bytes=sum(c["bytes"] for c in colls
                                    if c["group"] == grp))
                for grp in ("model", "data")})
        out[name] = row
        print(f"{label}:", json.dumps(row), flush=True)
    return out, launches, variants


# (o2): K5 / K6 at the model axis' shapes with a query offset: (label, B,
# Sq, Skv, H, KV, hd, causal, window, offsets); qwen1.5-0.5b's 8 local
# heads of (o1), its seq-sharded rows (Sq 256 of 512: rank 0 at 0, rank 1
# at Skv / 2, the default), a middle block of four ranks, and a window
OFFSET_CASES = (
    ("qwen1.5_local_heads", 2, 512, 512, 8, 8, 64, True, 0, (0, None)),
    ("qwen1.5_seq_shard", 2, 256, 512, 16, 16, 64, True, 0, (0, 256, None)),
    ("seq_shard4_mid", 2, 128, 512, 16, 16, 64, True, 0, (128, 384)),
    ("window48_offset_g4", 1, 100, 300, 8, 2, 64, True, 48, (0, 100, 200)),
)
# timed in bf16: (label of OFFSET_CASES, offset)
OFFSET_TIMING = (("qwen1.5_local_heads", 0), ("qwen1.5_seq_shard", 0),
                 ("qwen1.5_seq_shard", 256))


def offset_kernel_phase(check: Check, device="cuda"):
    """(o2): K5 and K6 against their plain versions at each offset of
    OFFSET_CASES, in f32 and bf16, under the LM kernel phase's bounds;
    then each at OFFSET_TIMING in bf16 by graph replay beside the plain
    version, the bound (the visible pairs' operations, or the bytes) and
    scaled_dot_product_attention with the same boolean mask (forward, and
    its backward through autograd). Returns (worst errors, timing rows
    keyed "<label>@<offset>")."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    worst = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, case in enumerate(OFFSET_CASES):
            label, B, Sq, Skv, H, KV, hd, causal, window, offsets = case
            q = lm_inputs((B, Sq, H, hd), dtype, device, 700 + 4 * i)
            k = lm_inputs((B, Skv, KV, hd), dtype, device, 701 + 4 * i)
            v = lm_inputs((B, Skv, KV, hd), dtype, device, 702 + 4 * i)
            do = lm_inputs((B, Sq, H, hd), dtype, device, 703 + 4 * i)
            for off in offsets:
                at = f"{label}@{off}/{dn}"
                kw = dict(causal=causal, window=window, q_offset=off)
                out, lse = fk.flash_attention_fwd(q, k, v, **kw)
                want, want_lse = fk.flash_attention_plain(q, k, v, block_kv=64,
                                                          **kw)
                ok, err = attn_close(out, want, v, dtype)
                lse_err = float(torch.max(torch.abs(lse - want_lse)))
                lse_tol = LM_TOL * max(1.0, float(torch.max(torch.abs(want_lse))))
                check(ok and lse_err <= lse_tol, f"flash_attention {at}: "
                      f"max_abs_err {err}, lse err {lse_err} (bound {lse_tol})")
                worst["flash_attention"] = max(worst["flash_attention"], err)
                got = fk.flash_attention_bwd(q, k, v, out, lse, do, **kw)
                wantb = fk.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
                for name, g, w in zip(("dq", "dk", "dv"), got, wantb):
                    ok, err = bwd_close(g, w, dtype)
                    check(ok, f"flash_attention_bwd {at} {name}: max_abs_err {err}")
                    worst["flash_attention_bwd"] = max(
                        worst["flash_attention_bwd"], err)
            del q, k, v, do
    bf16 = torch.bfloat16
    cases = {c[0]: c for c in OFFSET_CASES}
    rows = {}
    for label, off in OFFSET_TIMING:
        _, B, Sq, Skv, H, KV, hd, causal, window, _ = cases[label]
        q = lm_inputs((B, Sq, H, hd), bf16, device, 1)
        k = lm_inputs((B, Skv, KV, hd), bf16, device, 2)
        v = lm_inputs((B, Skv, KV, hd), bf16, device, 3)
        do = lm_inputs((B, Sq, H, hd), bf16, device, 4)
        kw = dict(causal=causal, window=window, q_offset=off)
        mask = fk._visible(Sq, Skv, causal, window, q.device, off)
        pairs = B * H * int(mask.sum())
        # k / v rows some query sees: the kernels' tile skips never read the
        # others (a causal block at offset 0 of a longer sequence)
        seen = int(mask.any(0).sum())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fwd = lm_row(
            lambda: fk.flash_attention_fwd(q, k, v, **kw),
            lambda: fk.flash_attention_plain(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=KV != H),
            2 * (2 * B * Sq * H * hd + 2 * B * seen * KV * hd) + 4 * B * H * Sq,
            4.0 * hd * pairs, H100_BF16_FLOPS)
        out, lse = fk.flash_attention_fwd(q, k, v, **kw)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        capture = torch.cuda.Stream()
        capture.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(capture):
            o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                                   enable_gqa=KV != H)
        torch.cuda.current_stream().wait_stream(capture)
        dot = do.transpose(1, 2)
        # q, out, do read and dq written; k, v read where seen, and dk, dv
        # written whole (zero where no query sees the row)
        bytes_ = (2 * (4 * B * Sq * H * hd + 2 * B * (seen + Skv) * KV * hd)
                  + 8 * B * H * Sq)
        flops = 10.0 * hd * pairs
        t_b, t_o = bytes_ / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
        kernel = lambda: fk.flash_attention_bwd(q, k, v, out, lse, do, **kw)  # noqa: E731
        ms = graph_ms(kernel)
        bwd = dict(ms=ms, eager_ms=time_ms(kernel),
                   plain_ms=graph_ms(lambda: fk.flash_attention_bwd_plain(
                       q, k, v, out, lse, do, **kw), calls=3, reps=3),
                   library_ms=graph_ms(lambda: torch.autograd.grad(
                       o_lib, (qg, kg, vg), dot, retain_graph=True),
                       stream=capture),
                   bound_ms=1e3 * max(t_b, t_o),
                   bound_by="bytes" if t_b >= t_o else "operations",
                   tflops=flops / (ms * 1e9))
        rows[f"{label}@{off}"] = dict(fwd=fwd, bwd=bwd)
        print(f"slice (o2) {label}@{off}:", json.dumps(rows[f"{label}@{off}"]),
              flush=True)
        del q, k, v, do, out, lse, qg, kg, vg, o_lib
    torch.cuda.empty_cache()
    print("slice (o2) worst:", json.dumps(worst), flush=True)
    return worst, rows


def model_axis_phases(check: Check):
    """Slice (o), counted on its own: (o2) in this process, then (o1)'s two
    ranks, whose launches (K5, K6, K9 and fedagg: K1 under mean, K3 under
    median) are counted in each rank from zero before its pod rounds and
    summed here. Returns ({"o1": ..., "o2": ...}, the launches, the
    fedagg variants, the (o2) worst errors and rows)."""
    worst, rows = phase(offset_kernel_phase, check)
    o1, launches, variants = phase(slice_o1, check)
    print("model axis path launches:", json.dumps(launches), flush=True)
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm", "fedagg"):
        check(launches.get(name, 0) > 0,
              f"model axis path: kernel {name} was never launched")
    want = {("mean", "identity"): 2 * 2 * O1_ROUNDS,
            ("median", "identity"): 2 * O1_ROUNDS}
    check(variants == want, f"model axis path: fedagg variants {variants}, "
          f"expected {want}")
    return dict(o1=o1, o2=rows), launches, variants, worst, rows


def phase(fn, *args, **kw):
    """fn(*args, **kw), its host-clock time printed under its name."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
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
    ptxas_check(check, reports)

    errs = phase(kernel_phase, check)
    verrs = phase(variant_phase, check)
    timings = phase(timing_phase, check)
    vtimings = phase(variant_timing_phase)
    lm_errs = phase(lm_kernel_phase, check)
    lm_times = phase(lm_timing_phase)
    lm_errs["ssm_scan"] = phase(ssm_kernel_phase, check)
    ssm_times = phase(ssm_timing_phase, check)
    lm_times.update(ssm_times)
    lm_errs["ssm_scan"] = max([lm_errs["ssm_scan"]]
                              + [r["max_abs_err"] for r in ssm_times.values()])
    ssm_grad = phase(ssm_grad_phase, check)
    bwd_err = phase(lm_bwd_phase, check)
    bwd_times = phase(lm_bwd_timing)

    # count only the main path from here: slices (a), (b) and (c)
    fk.fedagg.launches = 0
    fk.fedagg.variant_launches.clear()
    a = phase(slice_a, check)
    a_agg = phase(slice_a_aggregators, check)
    a_sel = phase(slice_a_selection, check)
    b, fedn = phase(slice_b, check)
    c = phase(slice_c, check, fedn)
    launches = fk.fedagg.launches
    counts = dict(fk.fedagg.variant_launches)
    print("main path launches per (aggregator, codec):",
          json.dumps({f"{k[0]}/{k[1]}": v for k, v in sorted(counts.items())}))

    k1 = next(r for r in timings
              if r["label"] == "slice_b" and r["dtype"] == "float32")
    k1 = dict(k1, max_abs_err=max(errs["slice_b/float32"],
                                  errs["slice_b_pitched/float32"]))
    rows = {(r["reducer"], r["wire"]): r for r in vtimings
            if r["label"] == "slice_b"}
    kernels = []
    for name, replaces, pick, pair, listed in KERNELS:
        row = k1 if pair == ("mean", "identity_f32") else dict(
            rows[pair], max_abs_err=verrs["/".join(pair)])
        n = sum(v for k, v in counts.items() if pick(*k))
        check(n > 0, f"main path: kernel {name} was never launched")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fedagg.cu",
            "replaces": replaces, "launches": n,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "ms_cold": row["ms_cold"], "eager_ms": row["eager_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": "60x579402", "variant": "/".join(pair)})
        # every timed shape and variant: K1 at each slice's shape and
        # dtype, the others at each wire or reducer they serve (and C = 65)
        kernels[-1]["shapes"] = [dict(
            {k: r.get(k) for k in SHAPE_KEYS}, shape=r["shape"],
            variant=f"mean/{r['dtype']}" if not listed else
            f"{r['reducer']}/{r['wire']}")
            for r in (timings if not listed else vtimings)
            if not listed or (r["reducer"], r["wire"]) in listed]
    # (a): 4 rounds x 2 backends + 6; its aggregators: 4 configs x 2
    # backends x 6; its selection runs: Fig. 5 on 2 backends, 7 x 6; (b):
    # 1 + 3; (c): 3 configs x (1 + 2)
    expected = (2 * 4 + 6 + len(PARITY_AGG) * 2 * 6 + 2 * FIG5_ROUNDS
                + len(SELECTION_RUNS) * 6 + 1 + 3 + len(SLICE_C) * 3)
    check(launches == expected, f"main path: {launches} fedagg launches, "
          f"expected {expected}")

    # the LM serving path: slices (d), (e) and (g), counted on their own
    reset_lm_counts()
    lm_expected = Expected()
    d = phase(slice_d, check, lm_expected)
    e = phase(slice_e, check, lm_expected)
    g1 = phase(slice_g1, check, lm_expected)
    g2 = phase(slice_g2, check, lm_expected)
    lm_launches = lm_counts()
    print("LM main path launches:", json.dumps(lm_launches), "expected:",
          json.dumps(lm_expected), flush=True)
    for name, replaces, row in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:186",
             "qwen1.5_prefill"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:58",
             "qwen1.5_decode"),
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:24",
             "qwen1.5_prefill_norm"),
            ("ssm_scan", "src/repro/kernels/ssm_scan.py:49",
             "jamba_prefill_scan")):
        n = lm_launches[name]
        check(n > 0, f"main path: kernel {name} was never launched")
        check(n == lm_expected[name], f"main path: {n} {name} launches, "
              f"expected {lm_expected[name]}")
        t = lm_times[row]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": n,
            "max_abs_err": lm_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": row})
        timed = {"flash_attention": [r[0] for r in PREFILL_TIMING],
                 "decode_attention": [r[0] for r in DECODE_TIMING],
                 "rmsnorm": [r[0] for r in NORM_TIMING],
                 "ssm_scan": [r[0] for r in SSM_TIMING]}.get(name)
        if timed:
            kernels[-1]["shapes"] = [dict(
                {k: lm_times[lab].get(k) for k in SHAPE_KEYS}, shape=lab)
                for lab in timed]

    # the training path: slices (f1)-(f5) and (g3), counted on their own
    reset_train_counts()
    train_expected = TrainExpected()
    f1 = phase(slice_f1, check, train_expected)
    f2, f2_first = phase(slice_f2, check, train_expected)
    f3 = phase(slice_f3, check, train_expected, f2)
    f4 = phase(slice_f4, check, train_expected, f2, f2_first)
    del f2_first
    f5 = phase(slice_f5, check, train_expected)
    g3 = phase(slice_g3, check, train_expected)
    train_launches = train_counts()
    print("training path launches:", json.dumps(train_launches), "expected:",
          json.dumps(train_expected), flush=True)
    for name in TRAIN_KERNELS:
        check(train_launches[name] == train_expected[name], f"training path: "
              f"{train_launches[name]} {name} launches, expected "
              f"{train_expected[name]}")
    for entry in kernels:
        key = "fedagg" if entry["source"].endswith("fedagg.cu") else entry["name"]
        if key in train_launches and (key != "fedagg" or entry["name"] == KERNELS[0][0]):
            entry["train_path_launches"] = train_launches[key]
        if key == "ssm_scan":
            entry["bwd_ms"] = ssm_grad["bfloat16"]["bwd_ms"]
    check(train_launches["ssm_scan"] > 0,
          "training path: kernel ssm_scan was never launched")
    n = train_launches["flash_attention_bwd"]
    check(n > 0, "training path: kernel flash_attention_bwd was never launched")
    t = bwd_times["qwen1.5_train"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:228", "launches": n,
        "max_abs_err": bwd_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "shape": "qwen1.5_train",
        "shapes": [dict({k: bwd_times[lab].get(k) for k in SHAPE_KEYS}, shape=lab)
                   for lab, *_ in BWD_TIMING]})
    # the asynchronous round and the fault layer: slices (h1)-(h4), counted
    # on their own
    reset_train_counts()
    h_expected = TrainExpected()
    h1 = phase(slice_h1, check, h_expected)
    h2 = phase(slice_h2, check, h_expected, fedn, b)
    h3 = phase(slice_h3, check, h_expected, f2)
    h4 = phase(slice_h4, check, h_expected)
    h_launches = train_counts()
    h_variants = dict(fk.fedagg.variant_launches)
    print("async + fault path launches:", json.dumps(h_launches), "expected:",
          json.dumps(h_expected), flush=True)
    for name in TRAIN_KERNELS:
        check(h_launches[name] == h_expected[name], f"async + fault path: "
              f"{h_launches[name]} {name} launches, expected "
              f"{h_expected[name]}")
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            pick = next(k[2] for k in KERNELS if k[0] == entry["name"])
            entry["fault_path_launches"] = sum(
                v for k, v in h_variants.items() if pick(*k))
        elif entry["name"] in h_launches:
            entry["fault_path_launches"] = h_launches[entry["name"]]
    for name in ("fedagg", "flash_attention", "flash_attention_bwd",
                 "rmsnorm"):
        check(h_launches[name] > 0,
              f"async + fault path: kernel {name} was never launched")
    # candidate pools and checkpoints: slices (i1)-(i5), counted on their
    # own
    reset_train_counts()
    i_expected = TrainExpected()
    i1 = phase(slice_i1, check, i_expected)
    i2 = phase(slice_i2, check, i_expected, fedn, b)
    i3 = phase(slice_i3, check, i_expected)
    i4 = phase(slice_i4, check, i_expected, f2)
    i5 = phase(slice_i5, check, i_expected)
    i_launches = train_counts()
    i_variants = dict(fk.fedagg.variant_launches)
    print("pool + checkpoint path launches:", json.dumps(i_launches),
          "expected:", json.dumps(i_expected), flush=True)
    for name in TRAIN_KERNELS:
        check(i_launches[name] == i_expected[name], f"pool + checkpoint "
              f"path: {i_launches[name]} {name} launches, expected "
              f"{i_expected[name]}")
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            pick = next(k[2] for k in KERNELS if k[0] == entry["name"])
            entry["pool_path_launches"] = sum(
                v for k, v in i_variants.items() if pick(*k))
        elif entry["name"] in i_launches:
            entry["pool_path_launches"] = i_launches[entry["name"]]
    for name in ("fedagg", "flash_attention", "flash_attention_bwd",
                 "rmsnorm"):
        check(i_launches[name] > 0,
              f"pool + checkpoint path: kernel {name} was never launched")
    # the MoE and MLA archs: slices (j1) and (j2), serving and training,
    # counted on their own
    reset_train_counts()
    j_serve, j_train = Expected(), TrainExpected()
    j1 = phase(slice_j1, check, j_serve, j_train)
    j2 = phase(slice_j2, check, j_serve)
    j_launches = dict(train_counts(), decode_attention=lm_counts()["decode_attention"])
    j_expected = {k: j_serve.get(k, 0) + j_train.get(k, 0) for k in j_launches}
    j_variants = dict(fk.fedagg.variant_launches)
    print("MoE + MLA path launches:", json.dumps(j_launches), "expected:",
          json.dumps(j_expected), flush=True)
    for name, n in j_launches.items():
        check(n == j_expected[name], f"MoE + MLA path: {n} {name} launches, "
              f"expected {j_expected[name]}")
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            pick = next(k[2] for k in KERNELS if k[0] == entry["name"])
            entry["moe_mla_path_launches"] = sum(
                v for k, v in j_variants.items() if pick(*k))
        elif entry["name"] in j_launches:
            entry["moe_mla_path_launches"] = j_launches[entry["name"]]
    for name in ("fedagg", "flash_attention", "flash_attention_bwd",
                 "decode_attention", "rmsnorm"):
        check(j_launches[name] > 0,
              f"MoE + MLA path: kernel {name} was never launched")
    # llava and xlstm: slices (k1)-(k4), serving and training, counted on
    # their own
    reset_train_counts()
    k_serve, k_train = Expected(), TrainExpected()
    k1 = phase(slice_k1, check, k_serve, k_train)
    k2 = phase(slice_k2, check, k_serve)
    k3 = phase(slice_k3, check, k_train)
    k4 = phase(slice_k4, check, k_serve, k_train)
    k_launches = dict(train_counts(), decode_attention=lm_counts()["decode_attention"])
    k_expected = {k: k_serve.get(k, 0) + k_train.get(k, 0) for k in k_launches}
    k_variants = dict(fk.fedagg.variant_launches)
    print("llava + xlstm path launches:", json.dumps(k_launches), "expected:",
          json.dumps(k_expected), flush=True)
    for name, n in k_launches.items():
        check(n == k_expected[name], f"llava + xlstm path: {n} {name} launches, "
              f"expected {k_expected[name]}")
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            pick = next(k[2] for k in KERNELS if k[0] == entry["name"])
            entry["vlm_xlstm_path_launches"] = sum(
                v for k, v in k_variants.items() if pick(*k))
        elif entry["name"] in k_launches:
            entry["vlm_xlstm_path_launches"] = k_launches[entry["name"]]
    for name in ("fedagg", "flash_attention", "flash_attention_bwd",
                 "decode_attention", "rmsnorm"):
        check(k_launches[name] > 0,
              f"llava + xlstm path: kernel {name} was never launched")
    # whisper-medium and the two single-card knobs: slices (l1)-(l4),
    # serving and training, counted on their own
    reset_train_counts()
    l_serve, l_train = Expected(), TrainExpected()
    l1 = phase(slice_l1, check, l_serve, l_train)
    l2 = phase(slice_l2, check, l_serve)
    l3 = phase(slice_l3, check, l_train)
    l4 = phase(slice_l4, check, l_train)
    l_launches = dict(train_counts(), decode_attention=lm_counts()["decode_attention"])
    l_expected = {k: l_serve.get(k, 0) + l_train.get(k, 0) for k in l_launches}
    print("whisper + knobs path launches:", json.dumps(l_launches), "expected:",
          json.dumps(l_expected), flush=True)
    for name, n in l_launches.items():
        check(n == l_expected[name], f"whisper + knobs path: {n} {name} launches, "
              f"expected {l_expected[name]}")
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            entry["encdec_path_launches"] = 0
        elif entry["name"] in l_launches:
            entry["encdec_path_launches"] = l_launches[entry["name"]]
    for name in ("flash_attention", "flash_attention_bwd", "decode_attention",
                 "rmsnorm", "ssm_scan"):
        check(l_launches[name] > 0,
              f"whisper + knobs path: kernel {name} was never launched")
    # the paper's experiments: slices (m1)-(m4), counted on their own
    m, m_variants = paper_phases(check, fedn)
    del fedn
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            pick = next(k[2] for k in KERNELS if k[0] == entry["name"])
            entry["paper_path_launches"] = sum(
                v for k, v in m_variants.items() if pick(*k))
        else:
            entry["paper_path_launches"] = 0
    # the pod round's data axes: slices (n1) and (n2), counted on their own
    n, n_launches, n_variants = pod_phases(check)
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            pick = next(k[2] for k in KERNELS if k[0] == entry["name"])
            entry["pod_path_launches"] = sum(
                v for k, v in n_variants.items() if pick(*k))
        else:
            entry["pod_path_launches"] = n_launches.get(entry["name"], 0)
    for name in ("fedagg", "flash_attention", "flash_attention_bwd",
                 "rmsnorm"):
        check(n_launches[name] > 0,
              f"pod path: kernel {name} was never launched")
    # the pod round's model axis: slice (o), counted on its own (in its
    # two ranks)
    o, o_launches, o_variants, o_worst, o_rows = model_axis_phases(check)
    for entry in kernels:
        if entry["source"].endswith("fedagg.cu"):
            pick = next(k[2] for k in KERNELS if k[0] == entry["name"])
            entry["model_axis_path_launches"] = sum(
                v for k, v in o_variants.items() if pick(*k))
        else:
            entry["model_axis_path_launches"] = o_launches.get(entry["name"], 0)
        if entry["name"] in o_worst:
            # K5 / K6 at a query offset: their errors and times there too
            side = "fwd" if entry["name"] == "flash_attention" else "bwd"
            entry["max_abs_err"] = max(entry["max_abs_err"], o_worst[entry["name"]])
            entry["shapes"] += [dict({k: row[side].get(k) for k in SHAPE_KEYS},
                                     shape=label)
                                for label, row in o_rows.items()]
    line = {"kernels": kernels}
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed",
              file=sys.stderr)
        return 1
    print("slices:", json.dumps({
        "a": a, "a_aggregators": {k: v["launches"] for k, v in a_agg.items()},
        "a_selection": {k: {f: v[f] for f in ("seconds", "launches")}
                        for k, v in a_sel.items()},
        "b": {k: b[k] for k in ("seconds_per_round", "launches", "M")},
        "c": {k: {f: v[f] for f in ("seconds_per_round", "launches")}
              for k, v in c.items()},
        "d": d, "e": e, "g1": g1, "g2": g2, "f1": f1, "f2": f2, "f3": f3,
        "f4": f4, "f5": f5, "g3": g3, "g3_ii": ssm_grad, "h1": h1, "h2": h2,
        "h3": h3, "h4": h4, "i1": i1, "i2": i2, "i3": i3, "i4": i4,
        "i5": i5, "j1": j1, "j2": j2, "k1": k1, "k2": k2, "k3": k3,
        "k4": k4, "l1": l1, "l2": l2, "l3": l3, "l4": l4, **m, **n, **o}))
    print(smi_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------- fedagg alone, two checkouts
def fedagg_outputs(path):
    """Save the kernel's output of every mean / dp x wire variant at 60 x
    579,402 (all gates 1, as timed, and mixed gates), its inputs made on
    the host from a seed, so that they are the same bits in every run; and
    at the LM round's shape (f2_case, f32, mean and dp, all and mixed
    gates) the SHA-256 of each output's bytes (1.86 GB each)."""
    import hashlib
    import torch
    from repro_torch.kernels import fedagg as fk
    outs = {}
    for red in ("mean", "dp"):
        for gates in ("all", "mixed"):
            updates, w, g, ops = f2_case(red, gates=gates)
            out = fk.fedagg(updates, w, g, **ops).cpu()
            del updates, ops
            outs[f"{red}/identity_f32_f2/{gates}"] = hashlib.sha256(
                out.numpy().tobytes()).hexdigest()
            torch.cuda.empty_cache()
    for red in ("mean", "dp"):
        for wire in WIRES:
            for gates in ("all", "mixed"):
                updates, w, g, ops = variant_case(red, wire, 60, 579402, "cpu",
                                                  gates=gates)
                dev = lambda t: t.cuda() if torch.is_tensor(t) else t  # noqa: E731
                out = fk.fedagg(dev(updates), dev(w), dev(g),
                                **{k: dev(v) for k, v in ops.items()})
                outs[f"{red}/{wire}/{gates}"] = out.cpu()
    torch.save(outs, path)


def compare_outputs(a_path, b_path) -> dict:
    """For each variant of two fedagg_outputs files: whether they agree bit
    for bit (NaN where NaN) and their largest difference."""
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    res = {}
    for key in sorted(a):
        x, y = a[key], b[key]
        if isinstance(x, str):                 # a digest of the bytes
            res[key] = dict(bit_identical=x == y, max_abs_diff=None)
            continue
        bits = torch.int32 if x.dtype == torch.float32 else torch.int16
        nan = torch.isnan(x.float())
        same = (bool(torch.equal(nan, torch.isnan(y.float())))
                and bool(torch.equal(x[~nan].view(bits), y[~nan].view(bits))))
        diff = (x.float() - y.float())[~nan].abs()
        res[key] = dict(bit_identical=same,
                        max_abs_diff=float(diff.max()) if diff.numel() else 0.0)
    print("compare:", json.dumps(res), flush=True)
    return res


def fedagg_main(argv) -> int:
    """The fedagg kernel alone, so that two checkouts' kernels can be timed
    in turns in one call:

        python3 chip_smoke.py --fedagg-timing ROWS.json [--src DIR] \
            [--outputs OUT.pt]
        python3 chip_smoke.py --compare A.pt B.pt

    ``--fedagg-timing`` builds fedagg and writes timing_phase's and
    variant_timing_phase's rows, the LM round's (label f2) included (with
    the card's name and power limit and ptxas's report of K4's kernels); ``--src`` picks the ``src`` directory
    whose ``repro_torch`` is timed (default: this checkout's), built into
    that checkout's ``build/``; ``--outputs`` saves fedagg_outputs.
    ``--compare`` prints compare_outputs of two saved runs."""
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--fedagg-timing", metavar="ROWS.json")
    ap.add_argument("--src")
    ap.add_argument("--outputs", metavar="OUT.pt")
    ap.add_argument("--compare", nargs=2, metavar="OUT.pt")
    args = ap.parse_args(argv)
    if args.compare:
        compare_outputs(*args.compare)
        return 0
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available() or not args.fedagg_timing:
        print("chip_smoke: --fedagg-timing needs a CUDA card and a path",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    reports = build.build_all(["fedagg"])
    smi = smi_line()
    print(smi, flush=True)
    ptxas = {sym: v for sym, v in ptxas_entries(reports["fedagg"]).items()
             if any(k in sym for k in ("stream_kernel", "sketch_kernel",
                                       "topk_sum_kernel"))}
    check = Check()
    rows = timing_phase(check, f2=True) + variant_timing_phase(f2=True)
    if args.outputs:
        fedagg_outputs(args.outputs)
    Path(args.fedagg_timing).write_text(json.dumps(dict(
        smi=smi, device=torch.cuda.get_device_name(0),
        src=args.src or str(ROOT / "src"), ptxas=ptxas, rows=rows,
        failed=check.failed)))
    return 1 if check.failed else 0


if __name__ == "__main__":
    sys.exit(fedagg_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
