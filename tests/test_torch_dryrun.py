"""The port's dry-run planner (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun`` builders.

The reference's builders run unchanged on a stand-in production mesh (a
``jax.sharding.AbstractMesh`` of the same axes; its ``with mesh:`` made a
no-op, which only ``seq_shard_attn`` reads), so nothing is compiled: each
of their arguments carries its ``NamedSharding``, and one device's bytes
are the sum of ``shard_shape`` x itemsize over the leaves (the prefill
outputs through its ``out_shardings``). The port's ``bytes_per_device``
must equal that sum, part for part, for every baseline target on both
meshes, and for the ``opt`` variant's targets that it plans. The CLI runs
every baseline target with exit 0 and the listed skips, and a failing
target makes it exit 1."""
import dataclasses
import json

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import dryrun as ref  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.fl import sharded  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


class _StandInMesh(AbstractMesh):
    """The production mesh without devices, usable as ``with mesh:``."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


MESHES = {False: _StandInMesh((16, 16), ("data", "model")),
          True: _StandInMesh((2, 16, 16), ("pod", "data", "model"))}
TARGETS = [(a, s, m) for a in JAX_ARCH_IDS for s in JAX_INPUT_SHAPES
           for m in (False, True)]


def _bytes(tree):
    """One device's bytes of a tree of sharded ShapeDtypeStructs."""
    total = 0
    for leaf in jax.tree.leaves(tree):
        total += int(np.prod(leaf.sharding.shard_shape(leaf.shape))) \
            * np.dtype(leaf.dtype).itemsize
    return total


def _out_bytes(shapes, shardings):
    total = 0
    for leaf, sh in zip(jax.tree.leaves(shapes), jax.tree.leaves(shardings)):
        total += int(np.prod(sh.shard_shape(leaf.shape))) \
            * np.dtype(leaf.dtype).itemsize
    return total


def _reference_bytes(arch, shape_name, multi_pod, variant="baseline"):
    """The reference builders' per-device bytes, split as the port's."""
    shape = JAX_INPUT_SHAPES[shape_name]
    cfg = ref.adapt_config(jax_get_config(arch), shape_name)
    fed = ref.DRYRUN_FED
    if variant == "opt":
        cfg = ref.optimize_config(cfg, multi_pod=multi_pod)
        fed = fed.replace(agg_dtype="bfloat16")
    mesh = MESHES[multi_pod]
    if shape.kind == "train":
        _, args, _, _, meta, _ = ref.build_train(cfg, shape, mesh, fed)
        state = args[0]
        parts = {"params": _bytes(state.params),
                 "state": _bytes(state.replace(params=())),
                 "batch": _bytes(args[1])}
    elif shape.kind == "prefill":
        step, args, _, out_sh, meta, _ = ref.build_prefill(cfg, shape, mesh)
        parts = {"params": _bytes(args[0]), "batch": _bytes(args[1]),
                 "outputs": _out_bytes(jax.eval_shape(step, *args), out_sh)}
    else:
        _, args, _, _, meta, _ = ref.build_decode(cfg, shape, mesh)
        parts = {"params": _bytes(args[0]), "caches": _bytes(args[1]),
                 "batch": _bytes(args[2]) + _bytes(args[3])}
    parts["total"] = sum(parts.values())
    return parts, meta


@pytest.mark.parametrize("arch,shape_name,multi_pod", TARGETS,
                         ids=[f"{a}-{s}-{'multi' if m else 'single'}"
                              for a, s, m in TARGETS])
def test_bytes_per_device_match_reference_specs(arch, shape_name, multi_pod):
    name = get_config(arch).name
    rec = dryrun.run_one(name, shape_name, multi_pod=multi_pod)
    if (name, shape_name) in ref.SKIPS:
        assert rec["status"] == "skipped"
        assert rec["reason"] == ref.SKIPS[(name, shape_name)]
        return
    want, meta = _reference_bytes(arch, shape_name, multi_pod)
    assert rec["status"] == "ok"
    assert rec["bytes_per_device"] == want
    assert rec["meta"] == meta
    assert rec["devices"] == int(np.prod(list(MESHES[multi_pod].shape.values())))
    assert all(v.startswith("A17b") for v in rec["not_ported"].values())
    if shape_name == "train_4k" and not meta["fsdp"]:
        C = meta["clients"]
        assert rec["collectives_per_round"] == sharded.pod_round_plan(
            dryrun.DRYRUN_FED, rec["n_params"], C, C,
            axes=("pod", "data") if multi_pod else ("data",))
        # one [M_total] f32 all-reduce a round beside the [C] loss gather
        assert [c["kind"] for c in rec["collectives_per_round"]] == [
            "all_gather", "all_reduce"]
        assert rec["collectives_per_round"][1]["bytes"] == 4 * rec["n_params"]


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "granite_moe_3b_a800m",
                                  "llava_next_34b", "qwen2_5_3b"])
def test_opt_variant_plans_or_skips_as_the_reference_builds(arch):
    """``--variant opt``: bf16 deltas, attn_bf16, expert_parallel where the
    experts divide the model axis (deepseek), seq_shard_attn where heads
    do not on a wide model (llava: planned like the rest, its traced
    fields still under not_ported)."""
    name = get_config(arch).name
    for shape_name in ("train_4k", "decode_32k"):
        rec = dryrun.run_one(name, shape_name, multi_pod=True, variant="opt")
        cfg = ref.optimize_config(jax_get_config(arch), multi_pod=True)
        assert rec["status"] == "ok"
        if cfg.seq_shard_attn:
            assert all(v.startswith("A17b") for v in rec["not_ported"].values())
        want, meta = _reference_bytes(arch, shape_name, True, "opt")
        assert rec["bytes_per_device"] == want and rec["meta"] == meta
        if shape_name == "train_4k" and not meta["fsdp"]:
            # the bf16 wire halves the all-reduce (llava's FSDP round has
            # no plan yet: not_ported)
            assert rec["collectives_per_round"][1]["bytes"] == 2 * rec["n_params"]


def test_planning_constants_mirror_reference():
    assert dryrun.SKIPS == ref.SKIPS
    assert dryrun.TEMPORAL_COHORT == ref.TEMPORAL_COHORT
    assert dryrun.WINDOW_FOR_LONG == ref.WINDOW_FOR_LONG
    assert dataclasses.asdict(dryrun.DRYRUN_FED) == \
        dataclasses.asdict(ref.DRYRUN_FED)
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for shape_name in INPUT_SHAPES:
            got = dryrun.adapt_config(get_config(arch), shape_name)
            want = ref.adapt_config(jax_get_config(arch), shape_name)
            assert got.sliding_window == want.sliding_window
        for multi in (False, True):
            got = dryrun.optimize_config(get_config(arch), multi_pod=multi)
            want = ref.optimize_config(jax_get_config(arch), multi_pod=multi)
            for knob in ("attn_bf16", "seq_shard_attn", "attn_block_kv",
                         "expert_parallel", "dp_axes"):
                assert getattr(got, knob) == getattr(want, knob), knob


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_cli_runs_every_baseline_target(multi, tmp_path, capsys):
    argv = ["--out", str(tmp_path)] + (["--multi-pod"] if multi else [])
    dryrun.main(argv)
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == len(ARCH_IDS) * len(INPUT_SHAPES)
    mesh = "multi" if multi else "single"
    assert {p.name for p in tmp_path.glob("*.json")} == {
        f"{get_config(a).name}__{s}__{mesh}.json"
        for a in ARCH_IDS for s in INPUT_SHAPES}
    skipped = [(r["arch"], r["shape"]) for r in recs if r["status"] == "skipped"]
    assert skipped == list(ref.SKIPS)
    assert all(r["status"] == "ok" for r in recs
               if (r["arch"], r["shape"]) not in ref.SKIPS)
    # a second run finds every record and skips it
    dryrun.main(argv)
    assert capsys.readouterr().out.count("[skip-existing]") == len(recs)


def test_cli_exits_1_on_a_failing_target(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("forced failure")

    monkeypatch.setitem(dryrun.BUILDERS, "decode", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--out", str(tmp_path)])
    assert exc.value.code == 1
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert recs["qwen1.5-0.5b__decode_32k__single.json"]["status"] == "error"
    assert recs["qwen1.5-0.5b__train_4k__single.json"]["status"] == "ok"


def test_cli_refuses_a_knob_the_pod_round_has_not_reached(tmp_path):
    """A train target's plan is the pod round's: a refused knob is an error
    record and exit 1, not a wrong plan."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                     "--aggregator", "cosine_filter", "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert rec["status"] == "error" and "A17b" in rec["error"]
    with pytest.raises(SystemExit):
        dryrun.main(["--dump-hlo", str(tmp_path)])
