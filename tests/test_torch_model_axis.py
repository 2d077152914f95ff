"""The pod round's model axis (``fl/sharded.py: make_pod_round`` with
``model`` > 1, ``sharding/model_axis.py``) as a multi-process job on the
CPU, and K5 / K6's ``q_offset``.

Gloo ranks over three host meshes, one start a layout
(``torch_pod_ranks.model_rank_main``, forked from a forkserver that has
imported the port once), each rank holding only its shard of every leaf
as ``auto_param_specs`` places it:

* ``d2m2``: (data 2, model 2), the smoke qwen1.5: heads split at head
  boundaries, tied embeddings, qkv biases;
* ``m4``: (data 1, model 4), the smoke qwen2.5: ``wk`` / ``wv`` split
  inside a kv head (k and v gathered whole), with and without
  ``seq_shard_attn``;
* ``m2``: (data 1, model 2), the smoke phi3: an untied ``lm_head``.

Each drives MODEL_RUN's rounds under mean, mean_bf16, trimmed_mean,
median and a cohort (``torch_pod_ranks.MODEL_CONFIGS``; (data 1, model
4) the ones the reference is held to and the cohort; (data 1, model 2)
also NaN corruption under the divergence guard). The parent holds what
the ranks saw against:

* the port's one-process ``make_spatial_round`` on the same batches:
  every decision exactly (gates, backlog, the cohort, each farther than
  GATE_MARGIN from its threshold or neighbour), every rank's gathered
  params the same bits and its replicated leaves (the norm scales) the
  same bits as every other model rank's, and the params within
  ``params_bound``: 10x the reference's own mesh-vs-one-device gap, or
  1e-7 x max(1, |param|) where that gap is smaller (under the bf16 wire
  one bf16 quantum of the largest update a round more, as
  tests/test_torch_pod.py allows);
* ``pod_round_plan`` with the model axis's ``LossPlan``: the collectives
  each rank recorded, round by round;
* the reference's jitted round on a (data 1, model 4) host mesh of four
  CPU devices (``tests/jax_mesh_round.py``, one subprocess a job, started
  before the ranks): mean, median and mean with ``seq_shard_attn``, at
  tests/test_torch_train.py's PARITY; its mean runs beside its one-device
  round give the gap the bound is made of.

The q_offset cases hold the plain forward and backward at an offset
against the rows of full-sequence attention; the bf16 route's emulation
at an offset is in tests/test_torch_flash_tc_numerics.py."""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_pod_ranks as ranks  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.fl import sharded  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.mesh import mesh_shape  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.sharding import model_axis, specs  # noqa: E402
from test_torch_train import PARITY  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GATE_MARGIN = 1e-3
BF16_QUANTUM = 2.0 ** -7
FLOOR = 1e-7            # x max(1, |param|): the bound where the gap is smaller
SPAWN_TIMEOUT_S = 600
# the reference's jobs: (label, config, mesh shape, seq_shard_attn); the
# port's m4 layout runs the same model on the same mesh
REF_ARCH = "qwen2.5-3b"
REF_JOBS = [("one_mean", "mean", None, False),
            ("mesh_mean", "mean", (1, 4), False),
            ("mesh_mean_seq", "mean", (1, 4), True),
            ("mesh_median", "median", (1, 4), False)]
REF_CASES = {"mean": "mesh_mean", "mean_seq": "mesh_mean_seq",
             "median": "mesh_median"}
CASES = [(lay, name) for lay, (*_, runs, _) in ranks.MODEL_LAYOUTS.items()
         for name, *_ in runs]
TRAIN_LAYOUTS = [lay for lay, (*_, train) in ranks.MODEL_LAYOUTS.items()
                 if train]


def _config(layout, name):
    return next((c, s) for n, c, s in ranks.MODEL_LAYOUTS[layout][3]
                if n == name)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"one": {arch: {config: one-process run}}, "ref": the reference's
    jobs, layout: [each rank's pickle]}; the reference's subprocesses and
    the ranks run while the parent makes its own runs."""
    root = tmp_path_factory.mktemp("model_axis")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    refs = []
    for label, *job in REF_JOBS:
        spec = dict(arch=REF_ARCH, run=ranks.MODEL_RUN,
                    eps=ranks.MODEL_EPS[REF_ARCH],
                    configs=ranks.MODEL_CONFIGS, jobs=[(label, *job)])
        path = root / f"{label}.jobs"
        path.write_bytes(pickle.dumps(spec))
        refs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "jax_mesh_round.py"),
             str(path), str(root / f"{label}.out")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ctxs = {}
    try:
        with pytest.MonkeyPatch.context() as mp_env:
            for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                        "MKL_NUM_THREADS"):
                mp_env.setenv(var, "1")
            for lay, (world, *_) in ranks.MODEL_LAYOUTS.items():
                (root / lay).mkdir()
                ctxs[lay] = ranks.start_ranks(
                    ranks.model_rank_main, world, (world, lay, str(root / lay)))
        out = {"one": {}, "init": {}}
        for lay, (_, _, arch, runs, _) in ranks.MODEL_LAYOUTS.items():
            out["init"][arch] = ranks._np(ranks.model_setup(arch)["init"])
            for config in dict.fromkeys(c for _, c, _ in runs):
                out["one"].setdefault(arch, {})[config] = ranks.drive_model(
                    arch, config)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for ctx in ctxs.values():
            while not ctx.join(timeout=0.2):
                assert time.monotonic() < deadline, "model-axis ranks timed out"
        out["ref"] = {}
        for (label, *_), proc in zip(REF_JOBS, refs):
            log = proc.communicate(timeout=SPAWN_TIMEOUT_S)[0]
            assert proc.returncode == 0, log[-3000:]
            out["ref"].update(pickle.loads((root / f"{label}.out").read_bytes()))
    finally:
        for proc in refs:
            proc.kill()
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    for lay, (world, *_) in ranks.MODEL_LAYOUTS.items():
        out[lay] = [pickle.loads((root / lay / f"rank{r}.pkl").read_bytes())
                    for r in range(world)]
    return out


def _scale(want):
    return max(1.0, float(np.abs(want).max()))


def reference_gap(results):
    """The reference's own mesh-vs-one-device gap: the largest difference
    of its mesh rounds' params (mean, and mean under seq_shard_attn, which
    is the identity on one device) from its one-device round's, over
    max(1, |param|)."""
    one = results["ref"]["one_mean"]["params"]
    return max(float(np.abs(g - w).max()) / _scale(w)
               for label in ("mesh_mean", "mesh_mean_seq")
               for g, w in zip(results["ref"][label]["params"], one))


def params_bound(results):
    """The params bound, over max(1, |param|)."""
    return max(10.0 * reference_gap(results), FLOOR)


def _assert_margins(one, fed):
    """Every gate of the one-process run lies farther than GATE_MARGIN
    from eps; under a cohort the included non-priority clients it ranks
    are that far apart."""
    P = ranks.MODEL_RUN["n_priority"]
    for st in one["stats"]:
        gaps = np.abs(st["local_losses"] - st["server_loss"])[P:]
        assert np.all(np.abs(gaps - fed.epsilon) > GATE_MARGIN), gaps
        if fed.max_cohort:
            order = np.sort(gaps[gaps <= fed.epsilon])
            assert np.all(np.diff(order) > GATE_MARGIN), order


@pytest.mark.parametrize("layout,name", CASES)
def test_model_axis_decisions_equal_one_process(results, layout, name):
    arch = ranks.MODEL_LAYOUTS[layout][2]
    config, _ = _config(layout, name)
    one = results["one"][arch][config]
    _assert_margins(one, ranks.model_fed(arch, config))
    for rank in results[layout]:
        got = rank["runs"][name]
        for g, w in zip(got["stats"], one["stats"]):
            assert set(g) == set(w)
            for key in ("gates", "backlog", "lost_clients",
                        "skipped_nonfinite"):
                if key in w:
                    np.testing.assert_array_equal(g[key], w[key])
            for key in ("server_loss", "local_losses"):
                err = float(np.abs(g[key] - w[key]).max())
                assert err <= PARITY * _scale(w[key]), (key, err)
        assert got["opt_t"] == one["opt_t"]
    gates = np.stack([st["gates"] for st in one["stats"]])
    assert gates.min() == 0 and gates[:, ranks.MODEL_RUN["n_priority"]:].max() == 1


@pytest.mark.parametrize("layout,name", CASES)
def test_model_axis_params_match_one_process(results, layout, name):
    arch = ranks.MODEL_LAYOUTS[layout][2]
    config, _ = _config(layout, name)
    one = results["one"][arch][config]
    init = results["init"][arch]
    rank0 = results[layout][0]["runs"][name]
    assert ranks.digest(rank0["params"]) == rank0["params_digest"]
    _, m, *_ = ranks.MODEL_LAYOUTS[layout]
    for r, other in enumerate(results[layout]):
        got = other["runs"][name]
        # every rank gathers the same whole params; the leaves a model
        # group holds whole are the same bits on each of its ranks
        assert got["params_digest"] == rank0["params_digest"]
        assert got["replicated"] == results[layout][r - r % m]["runs"][name][
            "replicated"]
    extra = 0.0
    if config == "mean_bf16":
        update = max(float(np.abs(w - i).max()) for w, i in
                     zip(one["params"], init))
        extra = ranks.MODEL_RUN["rounds"] * BF16_QUANTUM * update
    bound = params_bound(results)
    changed = 0.0
    for got, want, i in zip(rank0["params"], one["params"], init):
        err = float(np.abs(got - want).max())
        assert err <= bound * _scale(want) + extra, (err, bound)
        changed = max(changed, float(np.abs(want - i).max()))
    assert changed > 0.0


@pytest.mark.parametrize("layout,name", CASES)
def test_model_axis_collectives_follow_the_plan(results, layout, name):
    world, m, arch, *_ = ranks.MODEL_LAYOUTS[layout]
    config, seq = _config(layout, name)
    run = ranks.MODEL_RUN
    cfg = get_smoke(arch).replace(seq_shard_attn=seq)
    shape = (run["per_client"], run["seq"])
    plan = model_axis.LossPlan(cfg, m, shape, shape)
    fed = ranks.model_fed(arch, config)
    for rank in results[layout]:
        got = rank["runs"][name]
        for r, coll in enumerate(got["collectives"]):
            want = sharded.pod_round_plan(fed, got["M_local"], run["clients"],
                                          world // m, model=plan,
                                          trained=got["trained"][r])
            assert coll == want
        groups = {c["group"] for cs in got["collectives"] for c in cs}
        assert groups == {"data", "model"}
    kinds = {c["kind"] for c in results[layout][0]["runs"][name]["collectives"][0]}
    assert ("all_to_all" in kinds) == seq


@pytest.mark.parametrize("name", list(REF_CASES))
def test_model_axis_matches_reference_mesh_round(results, name):
    """The port's (data 1, model 4) round against the reference's jitted
    round on the same mesh: decisions exactly, losses and params at
    PARITY."""
    ref = results["ref"][REF_CASES[name]]
    got = results["m4"][0]["runs"][name]
    for g, w in zip(got["stats"], ref["stats"]):
        np.testing.assert_array_equal(g["gates"], w["gates"])
        np.testing.assert_array_equal(g["backlog"], w["backlog"])
        err = float(np.abs(g["local_losses"] - w["local_losses"]).max())
        assert err <= PARITY * _scale(w["local_losses"])
    for g, w in zip(got["params"], ref["params"]):
        assert float(np.abs(g - w).max()) <= PARITY * _scale(w)


def test_reference_mesh_decides_as_one_device(results):
    """The yardstick itself: the reference's mesh rounds take the one-
    device round's decisions, and their gap is what the bound is made
    of. chip_smoke.py's (o1) holds the card's params to that bound."""
    one = results["ref"]["one_mean"]
    for label in ("mesh_mean", "mesh_mean_seq"):
        for g, w in zip(results["ref"][label]["stats"], one["stats"]):
            np.testing.assert_array_equal(g["gates"], w["gates"])
    cs = _chip_smoke()
    assert cs.O1_PARAMS_TOL <= params_bound(results)


@pytest.mark.parametrize("layout", TRAIN_LAYOUTS)
def test_train_run_reaches_the_model_axis(results, layout):
    """``launch.train.run(..., mesh=...)`` on a model axis: every rank
    starts from the same whole params, keeps its shard, and returns the
    gathered params of the direct drive's mean run, bit for bit."""
    for rank in results[layout]:
        tr, direct = rank["train_run"], rank["runs"]["mean"]
        assert tr["params_digest"] == direct["params_digest"]
        assert tr["gates"] == [st["gates"].tolist() for st in direct["stats"]]


# ---------------------------------------------------------------- refusals
REFUSED_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b", "minicpm3-4b",
                 "xlstm-125m", "whisper-medium", "jamba-1.5-large-398b",
                 "llava-next-34b"]


@pytest.mark.parametrize("arch", REFUSED_ARCHS)
def test_other_archs_refuse_the_model_axis(arch):
    model = get_model(get_smoke(arch))
    with pytest.raises(NotImplementedError, match="A17b"):
        sharded.make_pod_round(model, FedConfig(num_clients=4), 4,
                               mesh_shape(data=1, model=2), device="cpu")


REFUSED_KNOBS = {
    "dp": dict(aggregator="dp", dp_clip=1.0, dp_noise=0.1),
    "int8": dict(wire_codec="int8"),
    "topk": dict(wire_codec="topk", codec_topk_frac=0.1),
    "sketch": dict(wire_codec="sketch", error_feedback=False),
    "adaptive_staleness": dict(async_depth=1, adaptive_staleness=True),
}


@pytest.mark.parametrize("knob", list(REFUSED_KNOBS))
def test_row_spanning_knobs_refuse_the_model_axis(knob):
    """Their per-row clip norm, int8 scale, top-k, sketch or drift sketch
    spans the shards; on one model rank they stay the pod round's."""
    fed = FedConfig(num_clients=4, **REFUSED_KNOBS[knob])
    model = get_model(get_smoke("qwen1.5-0.5b"))
    with pytest.raises(NotImplementedError, match="A17b"):
        sharded.make_pod_round(model, fed, 4, mesh_shape(data=1, model=2),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="A17b"):
        sharded.pod_round_plan(fed, 10, 4, 1, model=model_axis.LossPlan(
            model.cfg, 2, (1, 8), (1, 8)))
    sharded.check_pod_config(fed)


@pytest.mark.parametrize("case", ["heads", "fallback"])
def test_layouts_the_axis_does_not_split_refuse(case):
    """8 query heads on a model axis of 16 without seq_shard_attn; and a
    leaf the specs place off its layer's dim (model 3: no dim of wq
    divides, so the specs replicate it)."""
    cfg = get_smoke("qwen1.5-0.5b")
    m = 16 if case == "heads" else 3
    if case == "fallback":
        cfg = cfg.replace(seq_shard_attn=True)
    with pytest.raises(NotImplementedError, match="A17b"):
        sharded.make_pod_round(get_model(cfg), FedConfig(num_clients=4), 4,
                               mesh_shape(data=1, model=m), device="cpu")


def test_serving_on_the_model_axis_refuses():
    from repro_torch.models.attention import gqa_attention_block
    cfg = get_smoke("qwen1.5-0.5b")
    with pytest.raises(NotImplementedError, match="A17b"):
        gqa_attention_block({}, torch.zeros(1, 4, cfg.d_model), cfg,
                            positions=torch.arange(4), mode="prefill",
                            tp=object())


# ------------------------------------------------- shards without a group
class _Coord:
    """A mesh's shape and one device's coordinate, no process group."""

    def __init__(self, shape, coord):
        self.shape, self.axis_names = shape.shape, shape.axis_names
        self._coord = coord

    def get_coordinate(self):
        return list(self._coord)


@pytest.mark.parametrize("arch,m", [("qwen1.5-0.5b", 2), ("qwen2.5-3b", 4),
                                    ("phi3-mini-3.8b", 2)])
def test_shards_follow_the_specs(arch, m):
    """``shard_params`` gives each model rank ``local_shape`` of every
    leaf, the shards concatenate back to the leaf along the split dim, and
    the federation state of the shards is shaped by
    ``federation_state_specs``."""
    from repro_torch import prng
    from repro_torch.fl import engine
    from repro_torch.utils import tree_leaves
    cfg = get_smoke(arch)
    params = get_model(cfg).init(prng.PRNGKey(0), device="cpu")
    shape = mesh_shape(data=2, model=m)
    spec_tree = model_axis.param_specs(cfg, shape)
    locals_ = [model_axis.shard_params(params, spec_tree,
                                       _Coord(shape, (1, j)))
               for j in range(m)]
    for i, (leaf, spec) in enumerate(specs.spec_pairs(params, spec_tree)):
        parts = [tree_leaves(loc)[i] for loc in locals_]
        assert all(tuple(p.shape) == specs.local_shape(tuple(leaf.shape),
                                                       spec, shape)
                   for p in parts)
        if "model" in spec:
            d = list(spec).index("model")
            assert torch.equal(torch.cat(parts, dim=d), leaf)
        else:
            assert all(torch.equal(p, leaf) for p in parts)
    fed = FedConfig(num_clients=4, server_opt="adam")
    state_specs = specs.federation_state_specs(fed, spec_tree)
    whole = specs.spec_pairs(engine.init_state(params, fed, 4), state_specs)
    local = specs.spec_pairs(engine.init_state(locals_[0], fed, 4), state_specs)
    for (w, spec), (loc, _) in zip(whole, local, strict=True):
        assert tuple(loc.shape) == specs.local_shape(tuple(w.shape), spec,
                                                     shape)


def test_production_specs_of_the_dense_family_are_the_layers():
    """The dense family on the production (data 16, model 16) mesh: every
    leaf on its layer's dim, so the round's layout check passes; qwen2.5's
    2 kv heads are split inside a head there."""
    from repro_torch.launch.mesh import production_mesh_shape
    mesh = production_mesh_shape()
    for arch in ("qwen1.5-0.5b", "qwen2.5-3b", "phi3-mini-3.8b"):
        cfg = get_config(arch)
        model_axis.check_model(cfg, 16)
        model_axis.param_specs(cfg, mesh)
        assert model_axis.kv_whole(cfg, 16) == (cfg.num_kv_heads % 16 != 0)


# ------------------------------------------------------- K5 / K6 q_offset
OFFSET_CASES = [(True, 0), (True, 24), (False, 0)]


def _qkv(seed, B=2, S=96, H=4, KV=2, hd=32):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return mk(B, S, H, hd), mk(B, S, KV, hd), mk(B, S, KV, hd), mk(B, S, H, hd)


@pytest.mark.parametrize("causal,window", OFFSET_CASES)
def test_plain_forward_at_an_offset_is_rows_of_full_attention(causal, window):
    q, k, v, _ = _qkv(0)
    S = q.shape[1]
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        block_kv=32)
    G = q.shape[2] // k.shape[2]
    for off, n in ((0, 32), (48, 48), (S - 16, 16), (None, 16)):
        start = S - n if off is None else off
        o, l_ = fa.flash_attention_plain(q[:, start:start + n], k, v,
                                         causal=causal, window=window,
                                         block_kv=32, q_offset=off)
        assert torch.equal(o, out[:, start:start + n])
        assert torch.equal(l_, lse.reshape(-1, G, S)[..., start:start + n])
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_plain(q[:, :32], k, v, q_offset=S - 16)


@pytest.mark.parametrize("causal,window", OFFSET_CASES)
def test_plain_backward_over_chunks_sums_to_full(causal, window):
    """dq of each chunk of query rows at its offset is those rows of the
    full backward's; dk and dv summed over the chunks are the full ones
    (the seq_shard_attn backward's sum over the model group)."""
    q, k, v, do = _qkv(1)
    S = q.shape[1]
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                              causal=causal, window=window)
    n = S // 4
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for r in range(4):
        rows = slice(r * n, (r + 1) * n)
        o, l_ = fa.flash_attention_plain(q[:, rows], k, v, causal=causal,
                                         window=window, q_offset=r * n)
        gq, gk, gv = fa.flash_attention_bwd_plain(
            q[:, rows], k, v, o, l_, do[:, rows], causal=causal,
            window=window, q_offset=r * n)
        assert float((gq - dq[:, rows]).abs().max()) <= 1e-6 * float(dq.abs().max())
        dk_sum += gk
        dv_sum += gv
    for got, want in ((dk_sum, dk), (dv_sum, dv)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # the kernel wrapper takes the offset through the same Function
    qr = q[:, :n].clone().requires_grad_(True)
    y = fa.flash_attention(qr, k, v, causal=causal, window=window, q_offset=0)
    y.backward(do[:, :n])
    assert torch.equal(y.detach(), fa.flash_attention_plain(
        q[:, :n], k, v, causal=causal, window=window, q_offset=0)[0])
    assert qr.grad is not None


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_model_axis",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
