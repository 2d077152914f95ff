"""Dry-run planning: for every (architecture x input shape) target on the
production mesh, the partition specs of its params, federation state,
batches and caches, and each device's bytes under them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all [--multi-pod] [--variant opt] [--out results/dryrun]

Counterpart of ``repro/launch/dryrun.py``, its planning half: the same
targets, skips, per-shape config adjustments (``adapt_config``), perf
variant (``optimize_config``), batch layouts and spec rules, on the
production mesh's shape (``launch/mesh.py: production_mesh_shape``: 256
or 512 devices, no process group). Shapes come from
``models/registry.py: param_shapes`` / ``cache_shapes`` /
``prefill_cache_shapes`` (meta tensors: nothing is allocated, no PRNG
draw runs), so every baseline target is planned in seconds on the CPU.

Each target's record (one JSON file a target in ``--out``, tagged as the
reference tags them) holds the reference's ``arch``, ``shape``,
``multi_pod``, ``variant``, ``status``, ``meta`` and ``n_params``, and:

* ``devices``: the mesh's device count;
* ``bytes_per_device``: exact, from the specs and ``local_shape``, split
  into ``params``, ``state`` (the FederationState beside the params) and
  ``batch`` for train, ``params``, ``batch`` and ``outputs`` (the prefill
  caches and last logits) for prefill, ``params``, ``batch`` (the token
  and the position) and ``caches`` for decode, and their ``total``;
* ``collectives_per_round`` (train targets of the spatial archs): the pod
  round's cross-dp collectives, ``fl/sharded.py: pod_round_plan`` at the
  arch's M_total with one client a dp shard;
* ``not_ported``: each field of the reference's record this port leaves
  out, with the reason. The reference's compiled fields (flops, the
  collective bytes of the TP / FSDP traffic, temp and peak memory, the HLO
  dump) need the model axis traced (ROADMAP A17b).

An ``opt`` target whose ``optimize_config`` turns on ``seq_shard_attn``
(llava, jamba) is planned like the rest: the knob changes no spec, so its
bytes a device come from the same specs; its traced fields stay under
``not_ported``. A failure is recorded as ``status: "error"`` and the
process exits 1 once every target ran.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import traceback

import torch

from repro_torch.configs import ALIASES, ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import FedConfig
from repro_torch.configs.cli import add_fed_args, fed_from_args
from repro_torch.fl import engine, sharded
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.registry import (cache_shapes, param_shapes,
                                         prefill_cache_shapes)
from repro_torch.sharding.specs import (P, auto_batch_specs, auto_param_specs,
                                        auto_tree_specs, dp_axes, dp_size,
                                        federation_state_specs, local_shape,
                                        mesh_axes, spec_pairs,
                                        tree_specs_map)
from repro_torch.utils import param_count

# shape-point skips with reasons (the reference's)
SKIPS = {
    ("whisper-medium", "long_500k"):
        "enc-dec audio: bounded decoder context; 524k-token transcript has no analogue",
}

# archs needing a sliding-window variant to run long_500k sub-quadratically
WINDOW_FOR_LONG = 8192

DRYRUN_FED = FedConfig(local_epochs=5, epsilon=0.2, lr=0.01)
TEMPORAL_COHORT = 4

NOT_PORTED = {
    "flops_per_device": "A17b: needs the model axis traced (the "
                        "reference reads it off the compiled HLO)",
    "collective_bytes_per_device": "A17b: the TP / FSDP collectives need the "
                                   "model axis traced; the pod round's "
                                   "cross-dp plan is collectives_per_round",
    "memory": "A17b: temp and peak memory need the compiled program",
    "lower_s": "A17b: nothing is lowered or compiled",
    "compile_s": "A17b: nothing is lowered or compiled",
}


def adapt_config(cfg, shape_name: str):
    """Per-shape config adjustments: full-attention archs and jamba's
    attention layers run long_500k through a sliding window."""
    if shape_name == "long_500k" and cfg.pattern in ("attn", "jamba"):
        cfg = cfg.replace(sliding_window=WINDOW_FOR_LONG)
    return cfg


def optimize_config(cfg, *, multi_pod: bool, model_axis: int = 16):
    """The reference's perf variant: bf16 attention products everywhere;
    sequence-parallel attention when head counts don't divide the model
    axis on wide models; expert-parallel MoE when expert counts do and the
    experts are fine-grained."""
    kw = dict(attn_bf16=True,
              dp_axes=("pod", "data") if multi_pod else ("data",))
    if (cfg.num_heads % model_axis or cfg.num_kv_heads % model_axis) \
            and cfg.d_model >= 4096:
        kw["seq_shard_attn"] = True
        kw["attn_block_kv"] = 256
    if cfg.moe and cfg.num_experts % model_axis == 0 and cfg.moe_d_ff <= 4096:
        kw["expert_parallel"] = True
    return cfg.replace(**kw)


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_batch_shapes(cfg, C, b, S, *, stacked: bool):
    """Meta tensors of one (client-stacked) token batch."""
    lead = (C, b) if stacked else (b,)
    S_text = S - cfg.num_image_tokens if cfg.vlm else S
    d = {
        "tokens": _meta(*lead, S_text, dtype=torch.int32),
        "labels": _meta(*lead, S_text, dtype=torch.int32),
        "mask": _meta(*lead, S_text, dtype=torch.float32),
    }
    if cfg.vlm:
        d["image_embeds"] = _meta(*lead, cfg.num_image_tokens, cfg.d_model,
                                  dtype=cfg.cdtype)
    if cfg.encdec:
        d["frames"] = _meta(*lead, cfg.num_frames, cfg.d_model,
                            dtype=cfg.cdtype)
    return d


@functools.lru_cache(maxsize=None)
def _params(cfg):
    return param_shapes(cfg)


def _param_specs(cfg, mesh, fsdp):
    return auto_param_specs(_params(cfg), mesh, fsdp=fsdp,
                            expert_parallel=cfg.expert_parallel)


def build_train(cfg, shape, mesh, fed=DRYRUN_FED):
    """Spatial (one client a dp shard) or, for the FSDP archs, temporal
    (a cohort of TEMPORAL_COHORT, the inner batch over dp) round inputs.
    Returns ({part: (shapes, specs)}, meta, param_shapes)."""
    fsdp = sharded.needs_fsdp(cfg)
    dp, dpsize = dp_axes(mesh), dp_size(mesh)
    B, S = shape.global_batch, shape.seq_len
    C = TEMPORAL_COHORT if fsdp else dpsize
    b = B // C
    cspec_prefix = (None, dp) if fsdp else (dp, None)

    clients = _token_batch_shapes(cfg, C, b, S, stacked=True)
    server = _token_batch_shapes(cfg, None, min(b, 8), S, stacked=False)
    batch = {"clients": clients, "server": server,
             "priority_mask": _meta(C, dtype=torch.float32),
             "weights": _meta(C, dtype=torch.float32)}

    def server_spec(leaf):
        sp = [None] * leaf.dim()
        if leaf.shape and leaf.shape[0] % dpsize == 0 and leaf.shape[0] >= dpsize:
            sp[0] = dp
        return P(*sp)

    batch_specs = {
        "clients": tree_specs_map(
            lambda leaf: P(*(list(cspec_prefix) + [None] * (leaf.dim() - 2))),
            clients),
        "server": tree_specs_map(server_spec, server),
        "priority_mask": P(), "weights": P()}
    params = _params(cfg)
    param_specs = _param_specs(cfg, mesh, fsdp)
    state = engine.init_state(params, fed, C)
    state_specs = federation_state_specs(fed, param_specs)
    meta = {"mode": "train", "clients": C, "per_client_batch": b,
            "fsdp": fsdp, "local_steps": fed.local_epochs,
            "server_opt": fed.server_opt, "aggregator": fed.aggregator}
    parts = {"params": (params, param_specs),
             "state": (state.replace(params=()),
                       state_specs.replace(params=())),
             "batch": (batch, batch_specs)}
    return parts, meta, params


def build_prefill(cfg, shape, mesh):
    fsdp = sharded.needs_fsdp(cfg)
    B, S = shape.global_batch, shape.seq_len
    batch = _token_batch_shapes(cfg, None, B, S, stacked=False)
    params = _params(cfg)
    # the prompt's text rows: S less the image rows under cfg.vlm
    caches = prefill_cache_shapes(
        cfg, B, S - cfg.num_image_tokens if cfg.vlm else S)
    logits = _meta(B, cfg.vocab_size, dtype=torch.float32)
    dp, dpsize = dp_axes(mesh), dp_size(mesh)
    logit_spec = P(dp, None) if B % dpsize == 0 and B >= dpsize else P(None, None)
    meta = {"mode": "prefill", "batch": B, "seq": S, "fsdp": fsdp}
    parts = {"params": (params, _param_specs(cfg, mesh, fsdp)),
             "batch": (batch, auto_batch_specs(batch, mesh)),
             "outputs": ((caches, logits),
                         (auto_tree_specs(caches, mesh,
                                          model_dim_order="last"),
                          logit_spec))}
    return parts, meta, params


def build_decode(cfg, shape, mesh):
    fsdp = sharded.needs_fsdp(cfg)
    B, S = shape.global_batch, shape.seq_len
    params = _params(cfg)
    caches = cache_shapes(cfg, B, S)
    dp, dpsize = dp_axes(mesh), dp_size(mesh)
    tok_spec = P(dp, None) if B % dpsize == 0 and B >= dpsize else P(None, None)
    meta = {"mode": "decode", "batch": B, "cache_len": S, "fsdp": fsdp,
            "window": cfg.sliding_window}
    parts = {"params": (params, _param_specs(cfg, mesh, fsdp)),
             "batch": ((_meta(B, 1, dtype=torch.int32),
                        _meta(dtype=torch.int32)), (tok_spec, P())),
             "caches": (caches, auto_tree_specs(caches, mesh))}
    return parts, meta, params


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


def device_bytes(shapes, specs, mesh) -> int:
    """One device's bytes of a tree under its specs (the largest shard of
    an uneven split)."""
    total = 0
    for leaf, spec in spec_pairs(shapes, specs):
        n = 1
        for d in local_shape(tuple(leaf.shape), spec, mesh):
            n *= d
        total += n * leaf.element_size()
    return total


def run_one(arch: str, shape_name: str, *, multi_pod: bool, fed=DRYRUN_FED,
            variant: str = "baseline", cfg_overrides: dict | None = None):
    """One target's record (see the module note)."""
    shape = INPUT_SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "variant": variant}
    if (arch, shape_name) in SKIPS:
        return dict(head, status="skipped", reason=SKIPS[(arch, shape_name)])
    cfg = adapt_config(get_config(arch), shape_name)
    if variant == "opt":
        cfg = optimize_config(cfg, multi_pod=multi_pod)
        fed = fed.replace(agg_dtype="bfloat16")   # bf16 deltas on the wire
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    mesh = production_mesh_shape(multi_pod=multi_pod)
    build = BUILDERS[shape.kind]
    parts, meta, params = (build(cfg, shape, mesh, fed)
                           if shape.kind == "train" else build(cfg, shape, mesh))
    per_device = {name: device_bytes(shapes, specs, mesh)
                  for name, (shapes, specs) in parts.items()}
    per_device["total"] = sum(per_device.values())
    rec = dict(head, status="ok", meta=meta, n_params=param_count(params),
               devices=mesh.size, mesh=mesh_axes(mesh),
               bytes_per_device=per_device, not_ported=dict(NOT_PORTED))
    if shape.kind == "train":
        if meta["fsdp"]:
            rec["not_ported"]["collectives_per_round"] = (
                "A17b: the FSDP temporal pod round is not ported")
        else:
            C = meta["clients"]
            rec["collectives_per_round"] = sharded.pod_round_plan(
                fed, rec["n_params"], C, C, axes=dp_axes(mesh))
    return rec


def tag_of(args, cfg_name: str, shape_name: str) -> str:
    """The reference's record tag for one target under these flags."""
    tag = f"{cfg_name}__{shape_name}__{'multi' if args.multi_pod else 'single'}"
    if args.variant != "baseline":
        tag += f"__{args.variant}"
    if args.async_depth > 0:
        tag += f"__async{args.async_depth}"
        if args.async_mode != "fifo":
            tag += f"__{args.async_mode}{args.min_lag}"
        if args.adaptive_staleness:
            tag += "__adaptive"
    if args.aggregator != "mean":
        tag += f"__{args.aggregator}"
    if args.latency_mode != "none":
        tag += f"__clock-{args.latency_mode}"
        if args.round_deadline != float("inf"):
            tag += f"-dl{args.round_deadline:g}"
    if args.failure_model != "none":
        tag += f"__{args.failure_model}"
    if args.divergence_guard:
        tag += "__guard"
    if args.wire_codec != "identity":
        tag += f"__codec-{args.wire_codec}"
        if not args.error_feedback:
            tag += "-noef"
    if args.candidate_pool > 0:
        tag += f"__pool{args.candidate_pool}"
        if args.pool_weighting != "uniform":
            tag += f"-{args.pool_weighting}"
    return tag


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    add_fed_args(ap)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--dump-hlo", default=None, metavar="DIR",
                    help="not ported (ROADMAP A17b): nothing is lowered, so "
                         "there is no HLO to dump")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.dump_hlo:
        raise SystemExit("--dump-hlo: nothing is lowered in the port's "
                         "dry-run, so there is no HLO (ROADMAP A17b)")
    fed = DRYRUN_FED.replace(**fed_from_args(args))
    archs = ARCH_IDS if args.arch == "all" else [ALIASES.get(args.arch, args.arch)]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    failures, table = [], []
    for a in archs:
        cfg_name = get_config(a).name
        for s in shapes:
            tag = tag_of(args, cfg_name, s)
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip-existing] {tag}")
                continue
            try:
                rec = run_one(cfg_name, s, multi_pod=args.multi_pod,
                              variant=args.variant, fed=fed)
            except Exception as e:  # noqa: BLE001 — record failures, keep going
                rec = {"arch": cfg_name, "shape": s,
                       "multi_pod": args.multi_pod, "variant": args.variant,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures.append((tag, rec["error"]))
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                gb = rec["bytes_per_device"]["total"] / 1e9
                table.append((tag, gb))
                print(f"[dryrun] {tag}: ok, {gb:.3f} GB a device of "
                      f"{rec['devices']}", flush=True)
            else:
                print(f"[dryrun] {tag}: {rec['status']} "
                      f"{rec.get('reason', rec.get('error', ''))[:200]}",
                      flush=True)
    if failures:
        print(f"\n[dryrun] {len(failures)} target(s) FAILED:")
        for tag, err in failures:
            print(f"  FAIL {tag}: {err[:200]}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
