"""Shared federation CLI surface.

The port's own copy of ``repro/configs/cli.py`` (argparse only): the same
flags, defaults and choices, so ``launch/train.py`` takes the reference
launcher's command lines. ``fed_from_args`` returns only the knob groups
whose gating flag left its default, so a default command line yields
``{}``. Knobs the port has not reached are refused later, by
``validate_config`` and ``fl/sharded.py``, not by the parser.
"""
from __future__ import annotations

import argparse


def add_fed_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Register every federation knob on ``parser`` (returns it)."""
    g = parser.add_argument_group(
        "federation", "FedConfig overrides shared by all launchers")
    g.add_argument("--async-depth", type=int, default=0,
                   help="run scan_async overlapped cohorts: the in-flight "
                        "delta buffer (async_depth stacked param-shaped "
                        "deltas, plus per-slot age/validity vectors) joins "
                        "the FederationState")
    g.add_argument("--async-mode", default="fifo", choices=["fifo", "ready"],
                   help="in-flight pop policy: strict fixed-lag pipe, or "
                        "FedBuff-style variable-lag readiness buffer (pops "
                        "every slot aged >= --min-lag, oldest first)")
    g.add_argument("--min-lag", type=int, default=1,
                   help="ready mode: rounds a buffered delta must age "
                        "before it may be applied (1 <= min_lag <= "
                        "async_depth)")
    g.add_argument("--adaptive-staleness", action="store_true",
                   help="discount applied deltas by measured drift "
                        "(staleness_decay**age * max(0, cos vs the last "
                        "applied delta)); adds the [sketch_dim] last_delta "
                        "sketch leaf to the state")
    g.add_argument("--aggregator", default="mean",
                   choices=["mean", "trimmed_mean", "median", "dp",
                            "cosine_filter"],
                   help="Aggregator registry name (core/aggregation.py): "
                        "how the gated client deltas are reduced inside "
                        "the one fused fedagg call")
    g.add_argument("--trim-frac", type=float, default=0.1,
                   help="trimmed_mean: fraction of included clients "
                        "trimmed from EACH side per coordinate (< 0.5)")
    g.add_argument("--dp-clip", type=float, default=1.0,
                   help="dp: per-client delta L2 clip bound (the DP "
                        "sensitivity)")
    g.add_argument("--dp-noise", type=float, default=0.0,
                   help="dp: Gaussian noise multiplier z (sigma = "
                        "z*dp_clip/inclusion_mass per coordinate; 0 = "
                        "clip-only)")
    g.add_argument("--dp-delta", type=float, default=1e-5,
                   help="dp: target delta for the RDP (epsilon, delta) "
                        "report printed after the run")
    g.add_argument("--outlier-cos", type=float, default=0.0,
                   help="cosine_filter: gate out clients whose sketch-"
                        "estimated delta-direction cosine to the gated "
                        "mean direction falls below this")
    g.add_argument("--latency-mode", default="none",
                   choices=["none", "lognormal"],
                   help="event-driven client clock (per-client lognormal "
                        "compute+network times; async depth > 0 requires "
                        "async_mode='ready')")
    g.add_argument("--round-deadline", type=float, default=float("inf"),
                   help="force-land in-flight slots after this many round "
                        "units with only their finished members' mass "
                        "(finite values require --latency-mode)")
    g.add_argument("--failure-model", default="none",
                   choices=["none", "crash", "dropout", "corrupt", "chaos"],
                   help="fault injection (FailureModel registry, "
                        "fl/engine.py): Bernoulli crash (delta lost "
                        "post-train), transient drop-out, delta corruption "
                        "in transit, or all three (chaos)")
    g.add_argument("--crash-rate", type=float, default=0.0)
    g.add_argument("--dropout-rate", type=float, default=0.0)
    g.add_argument("--dropout-len", type=int, default=1)
    g.add_argument("--corrupt-rate", type=float, default=0.0)
    g.add_argument("--corrupt-scale", type=float, default=0.0)
    g.add_argument("--divergence-guard", action="store_true",
                   help="skip non-finite aggregates bit-exactly and track "
                        "consecutive skips")
    g.add_argument("--max-nonfinite-skips", type=int, default=0,
                   help="halt the driver after this many CONSECUTIVE "
                        "guarded skips (0 = never halt)")
    g.add_argument("--wire-codec", default="identity",
                   choices=["identity", "int8", "topk", "sketch"],
                   help="uplink compression (WireCodec registry): encode "
                        "the flattened per-client delta rows before the "
                        "fused fedagg call; decode happens in-register "
                        "inside the kernel")
    g.add_argument("--codec-topk-frac", type=float, default=0.01,
                   help="topk: fraction of coordinates each client keeps")
    g.add_argument("--codec-sketch-dim", type=int, default=2048,
                   help="sketch: CountSketch width each client uplinks")
    g.add_argument("--no-error-feedback", dest="error_feedback",
                   action="store_false", default=True,
                   help="disable the per-client error-feedback "
                        "accumulators (biased compression)")
    g.add_argument("--candidate-pool", type=int, default=0,
                   help="sample-then-evaluate population scaling: each "
                        "round draws this many candidates (priority "
                        "clients always in-pool) and runs eval/gating/"
                        "training/fedagg on the [P] slice only, scattering "
                        "the per-client state rows back at the sampled "
                        "indices; 0 = dense rounds over every client")
    g.add_argument("--pool-weighting", default="uniform",
                   choices=["uniform", "backlog", "ema"],
                   help="non-priority candidate sampling weights: uniform "
                        "Gumbel top-k, backlog-tilted (starved clients "
                        "more likely), or inclusion-EMA-tilted (rarely "
                        "included clients more likely)")
    return parser


def fed_from_args(args: argparse.Namespace) -> dict:
    """FedConfig override kwargs for ``add_fed_args`` values.

    Returns only the knob groups whose gating flag left its default, so
    ``FedConfig(**fed_from_args(args))`` on a default command line equals
    a bare ``FedConfig()`` (and ``fed.replace(**{})`` is the identity)."""
    kw: dict = {}
    if args.async_depth > 0:
        kw.update(async_depth=args.async_depth, backend="scan_async",
                  async_mode=args.async_mode, min_lag=args.min_lag,
                  adaptive_staleness=args.adaptive_staleness)
    if args.aggregator != "mean":
        kw.update(aggregator=args.aggregator, trim_frac=args.trim_frac,
                  dp_clip=args.dp_clip, dp_noise=args.dp_noise,
                  dp_delta=args.dp_delta, outlier_cos=args.outlier_cos)
    if args.latency_mode != "none":
        kw.update(latency_mode=args.latency_mode,
                  round_deadline=args.round_deadline)
    if args.failure_model != "none":
        kw.update(failure_model=args.failure_model,
                  crash_rate=args.crash_rate,
                  dropout_rate=args.dropout_rate,
                  dropout_len=args.dropout_len,
                  corrupt_rate=args.corrupt_rate,
                  corrupt_scale=args.corrupt_scale)
    if args.divergence_guard:
        kw.update(divergence_guard=True,
                  max_nonfinite_skips=args.max_nonfinite_skips)
    if args.wire_codec != "identity":
        kw.update(wire_codec=args.wire_codec,
                  error_feedback=args.error_feedback,
                  codec_topk_frac=args.codec_topk_frac,
                  codec_sketch_dim=args.codec_sketch_dim)
    if args.candidate_pool > 0:
        kw.update(candidate_pool=args.candidate_pool,
                  pool_weighting=args.pool_weighting)
    return kw
