"""The pod round (``fl/sharded.py: make_pod_round``) as a multi-process
job on the CPU: gloo ranks over a (data=2) and a (pod=2, data=2) host
mesh, one start a layout (``torch_pod_ranks.rank_main``), each rank
driving the smoke qwen1.5 with 8 clients for 2 rounds under every config
of ``torch_pod_ranks.CONFIGS``. The parent holds what the ranks saw
against:

* the port's one-process ``make_spatial_round`` on the same batches:
  every decision exactly (gates, included counts, backlog, the cohort as
  its gates; the local losses of round 0 bit for bit, as each rank
  evaluates its clients as the one process does), every rank's params bit
  for bit the others', and the params bit for bit under trimmed_mean /
  median (K3 over the same gathered rows) or within POD_F32 of the
  largest magnitude under the linear reducers, where the mean is a sum of
  the ranks' partials (one quantum of the run's largest int8 row scale
  more under the int8 wire, as tests/test_torch_train_round.py allows;
  under the bf16 wire each rank's share is rounded to bf16 before the
  sum, so one bf16 quantum of the largest update a round more);
* the reference's jitted ``make_spatial_round`` on the CPU, for
  JAX_CONFIGS, at tests/test_torch_train.py's PARITY;
* ``pod_round_plan``: the collectives each rank recorded, round by round;
* the DTensor placements of the smoke leaves on a (data=2, model=2) mesh
  (``distribute_tensor`` holds ``local_shape`` and gathers back).

Every gate decision of the one-process run lies farther than GATE_MARGIN
from eps, and every rank a cohort or topk_align orders from its
neighbour, so exact equality is meaningful. The ranks start before the
parent's own runs, so the two overlap."""
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_pod_ranks as ranks  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data.tokens import make_token_federation  # noqa: E402
from repro_torch.fl import sharded  # noqa: E402
from test_torch_train import PARITY  # noqa: E402

GATE_MARGIN = 1e-3
POD_F32 = 1e-6          # x max(1, |param|): the ranks' partial sums' order
ORDER_STATS = ("trimmed", "median_cohort")
INT8 = ("int8_cohort", "int8_welfare")
BF16 = ("mean_bf16",)
BF16_QUANTUM = 2.0 ** -7  # x |value|: bf16's 8 significant bits
JAX_CONFIGS = ("mean", "dp", "median_cohort", "int8_cohort")
SPAWN_TIMEOUT_S = 600
CASES = [(lay, name) for lay in ranks.LAYOUTS for name in ranks.CONFIGS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_drive(fed_kw):
    """``ranks.drive`` through the reference's jitted spatial round."""
    from repro.data.tokens import make_token_federation as jax_tokens
    from repro.fl import engine, sharded as jsharded
    from repro.launch.train import build_batches
    run = ranks.RUN
    C = run["clients"]
    cfg = jax_get_smoke("qwen1.5-0.5b")
    model = jax_get_model(cfg)
    fed = JaxFedConfig(num_clients=C, num_priority=run["n_priority"],
                       local_epochs=run["local_epochs"], lr=run["lr"],
                       **fed_kw)
    data = jax_tokens(seed=0, vocab=cfg.vocab_size, n_clients=C,
                      n_priority=run["n_priority"], seq_len=run["seq"],
                      misalign_max=1.0,
                      tokens_per_client=max(8192, run["per_client"]
                                            * (run["seq"] + 1) * 4))
    step = jax.jit(jsharded.make_round_step(model, fed, C, fsdp=False))
    state = engine.init_state(model.init(jax.random.PRNGKey(0)), fed, C)
    rng = np.random.default_rng(0)
    stats = []
    for r in range(run["rounds"]):
        batch = build_batches(cfg, data, clients=C,
                              per_client=run["per_client"], seq=run["seq"],
                              rng=rng)
        state, st = step(state, batch, jnp.int32(r))
        stats.append({k: np.asarray(st[k]) for k in
                      ("server_loss", "gates", "local_losses", "backlog")})
    return {"stats": stats,
            "params": [np.asarray(x) for x in jax.tree.leaves(state.params)]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"one": one-process runs, "jax": reference runs, layout: [each
    rank's pickle]}; the ranks run while the parent makes its own."""
    root = tmp_path_factory.mktemp("pod")
    ctxs = {}
    with pytest.MonkeyPatch.context() as env:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            env.setenv(var, "1")
        for lay, (world, pods) in ranks.LAYOUTS.items():
            (root / lay).mkdir()
            ctxs[lay] = ranks.start_ranks(
                ranks.rank_main, world, (world, pods, str(root / lay)))
        # the launcher's --mesh path, one rank alone (a HashStore)
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--mesh", "1,1", "--clients", "4", "--rounds", "2",
             "--seq", "16"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path)))
    try:
        # the reference's rounds (XLA compiles, mostly) in a thread beside
        # the port's one-process rounds
        with ThreadPoolExecutor(1) as pool:
            jax_runs = pool.submit(lambda: {n: _jax_drive(ranks.CONFIGS[n])
                                            for n in JAX_CONFIGS})
            out = {"one": {n: ranks.drive(kw)
                           for n, kw in ranks.CONFIGS.items()},
                   "init": ranks._np(ranks._setup()["init"])}
            out["jax"] = jax_runs.result()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for ctx in ctxs.values():
            while not ctx.join(timeout=1.0):
                assert time.monotonic() < deadline, "pod ranks timed out"
        out["cli"] = (cli.communicate(timeout=SPAWN_TIMEOUT_S)[0],
                      cli.returncode)
    finally:
        cli.kill()
        for ctx in ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    for lay, (world, _) in ranks.LAYOUTS.items():
        out[lay] = []
        for r in range(world):
            with open(root / lay / f"rank{r}.pkl", "rb") as f:
                out[lay].append(pickle.load(f))
    return out


def _scale(want):
    return max(1.0, float(np.abs(want).max()))


def _assert_margins(one, fed_kw):
    """The one-process run's decisions lie farther than GATE_MARGIN from
    eps, and the ranks a cohort or topk_align orders from each other."""
    P = ranks.RUN["n_priority"]
    backlog = np.zeros(ranks.RUN["clients"])
    boost = FedConfig(**{k: v for k, v in fed_kw.items()
                         if k == "backlog_boost"}).backlog_boost
    for st in one["stats"]:
        gaps = np.abs(st["local_losses"] - st["server_loss"])[P:]
        if fed_kw.get("selection", "fedalign") in ("fedalign", "topk_align"):
            assert np.all(np.abs(gaps - fed_kw["epsilon"]) > GATE_MARGIN), gaps
        if fed_kw.get("max_cohort", 0) or fed_kw.get("selection") == "topk_align":
            order = np.sort(gaps - boost * backlog[P:])
            assert np.all(np.diff(order) > GATE_MARGIN), order
        backlog = st["backlog"]


@pytest.mark.parametrize("layout,name", CASES)
def test_pod_decisions_equal_one_process(results, layout, name):
    one = results["one"][name]
    _assert_margins(one, ranks.CONFIGS[name])
    for rank in results[layout]:
        got = rank["runs"][name]
        for r, (g, w) in enumerate(zip(got["stats"], one["stats"])):
            assert set(g) == set(w)
            for key in ("gates", "backlog"):
                np.testing.assert_array_equal(g[key], w[key])
            for key in ("lost_clients", "skipped_nonfinite", "staleness",
                        "applied_valid", "inflight_occupancy"):
                if key in w:
                    np.testing.assert_array_equal(g[key], w[key])
            if r == 0:       # the received model is the same bits
                np.testing.assert_array_equal(g["local_losses"],
                                              w["local_losses"])
                np.testing.assert_array_equal(g["server_loss"],
                                              w["server_loss"])
        assert got["opt_t"] == one["opt_t"]
    # the config's decisions are not all one way: some gate is 0 in some
    # round unless every client is taken
    gates = np.stack([st["gates"] for st in one["stats"]])
    assert ranks.CONFIGS[name].get("selection") == "all" or gates.min() == 0


@pytest.mark.parametrize("layout,name", CASES)
def test_pod_params_match_one_process(results, layout, name):
    one = results["one"][name]
    rank0 = results[layout][0]["runs"][name]
    assert ranks.digest(rank0["params"]) == rank0["params_digest"]
    for other in results[layout][1:]:        # every rank the same bits
        assert other["runs"][name]["params_digest"] == rank0["params_digest"]
    extra = max(rank0["scales"] + one["scales"]) if name in INT8 else 0.0
    if name in BF16:
        update = max(float(np.abs(w - i).max()) for w, i in
                     zip(one["params"], results["init"]))
        extra = ranks.RUN["rounds"] * BF16_QUANTUM * update
    changed = 0.0
    for got, want, init in zip(rank0["params"], one["params"],
                               results["init"]):
        if name in ORDER_STATS:
            np.testing.assert_array_equal(got, want)
        else:
            err = float(np.abs(got - want).max())
            assert err <= POD_F32 * _scale(want) + extra, err
        changed = max(changed, float(np.abs(want - init).max()))
    assert changed > 0.0            # the rounds moved the params


@pytest.mark.parametrize("layout,name", CASES)
def test_pod_collectives_follow_the_plan(results, layout, name):
    world, pods = ranks.LAYOUTS[layout]
    fed = FedConfig(num_clients=ranks.RUN["clients"], **ranks.CONFIGS[name])
    M = sum(p.size for p in results["one"][name]["params"])
    plan = sharded.pod_round_plan(
        fed, M, ranks.RUN["clients"], world,
        axes=("pod", "data") if pods else ("data",))
    for rank in results[layout]:
        assert rank["runs"][name]["collectives"] == plan * ranks.RUN["rounds"]
    kinds = [c["kind"] for c in plan]
    if name in ORDER_STATS:       # the documented gather of the rows
        assert kinds == ["all_gather", "all_gather"]
    else:                         # one delta-sized all-reduce a round
        assert kinds == ["all_gather", "all_reduce"]
        assert plan[0]["bytes"] == 4 * ranks.RUN["clients"] < plan[1]["bytes"]


@pytest.mark.parametrize("layout", list(ranks.LAYOUTS))
@pytest.mark.parametrize("name", INT8)
def test_error_feedback_rows_stay_with_their_owner(results, layout, name):
    """Each rank advances its own clients' rows of ``ef_accum`` (global
    indices, the cohort's too) and no other: its rows match the one
    process's, the others' stay at their initial zeros."""
    world, _ = ranks.LAYOUTS[layout]
    C = ranks.RUN["clients"]
    n = C // world
    one = results["one"][name]
    extra = max(one["scales"])
    for r, rank in enumerate(results[layout]):
        got = rank["runs"][name]
        extra = max(extra, max(got["scales"]))
        for g, w in zip(got["ef_mine"], one["ef"]):
            err = float(np.abs(g - w[r * n:(r + 1) * n]).max())
            assert err <= POD_F32 * _scale(w) + extra, err
        assert got["ef_rest_zero"]
    assert any(np.abs(w).max() > 0 for w in one["ef"])


@pytest.mark.parametrize("layout", list(ranks.LAYOUTS))
def test_dp_noise_is_drawn_once(results, layout):
    """The dp noise enters once, not once a rank: its per-coordinate scale
    (dp_noise x dp_clip / the round's mass) is thousands of times the
    params' bound, which the pod round meets."""
    kw = ranks.CONFIGS["dp"]
    data = make_token_federation(seed=0, vocab=get_smoke("qwen1.5-0.5b").vocab_size,
                                 n_clients=ranks.RUN["clients"],
                                 n_priority=ranks.RUN["n_priority"],
                                 seq_len=ranks.RUN["seq"],
                                 tokens_per_client=8192)
    noise = kw["dp_noise"] * kw["dp_clip"] / float(np.sum(data["weights"]))
    assert noise > 1e3 * POD_F32 * max(_scale(p) for p in
                                       results["one"]["dp"]["params"])
    test_pod_params_match_one_process(results, layout, "dp")


@pytest.mark.parametrize("layout", list(ranks.LAYOUTS))
@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_pod_matches_reference_round(results, layout, name):
    ref = results["jax"][name]
    got = results[layout][0]["runs"][name]
    for g, w in zip(got["stats"], ref["stats"]):
        np.testing.assert_array_equal(g["gates"], w["gates"])
        np.testing.assert_array_equal(g["backlog"], w["backlog"])
        err = float(np.abs(g["local_losses"] - w["local_losses"]).max())
        assert err <= PARITY * _scale(w["local_losses"])
    extra = max(got["scales"]) if name in INT8 else 0.0
    for g, w in zip(got["params"], ref["params"]):
        assert float(np.abs(g - w).max()) <= PARITY * _scale(w) + extra


@pytest.mark.parametrize("layout", list(ranks.LAYOUTS))
def test_train_run_reaches_the_pod_round(results, layout):
    """``launch.train.run(..., mesh=...)`` runs the pod round: its params
    and gates are the direct drive's, bit for bit, on every rank."""
    for rank in results[layout]:
        tr, direct = rank["train_run"], rank["runs"]["mean"]
        assert tr["params_digest"] == direct["params_digest"]
        assert tr["gates"] == [st["gates"].tolist() for st in direct["stats"]]


def test_train_main_mesh_runs_one_rank_alone(results):
    """``python -m repro_torch.launch.train --mesh 1,1``: the process group
    of one rank (a HashStore), its mesh, the pod round, and the group torn
    down: exit 0 and every round printed."""
    log, code = results["cli"]
    assert code == 0, log[-2000:]
    assert "round   1" in log and "clients=4" in log


def test_dtensor_placements_round_trip(results):
    for rank in results["pod2_data2"]:
        check = rank["dtensor"]
        assert "A17b" in check["refusal"]
        sharded_dims = set()
        for spec, local, want, same in check["leaves"]:
            assert local == want and same, (spec, local, want)
            sharded_dims.update(a for a in spec if a is not None)
        assert {"data", "model"} <= sharded_dims


def test_build_batches_block_is_the_full_batch_slice():
    """A pod rank's batch (``build_batches(..., block=...)``) holds the
    full batch's rows of its clients and draws as the full batch does."""
    from repro_torch.launch.train import build_batches
    setup = ranks._setup()
    C = ranks.RUN["clients"]
    kw = dict(clients=C, per_client=2, seq=ranks.RUN["seq"], device="cpu")
    rngs = np.random.default_rng(3), np.random.default_rng(3)
    full = build_batches(setup["cfg"], setup["data"], rng=rngs[0], **kw)
    part = build_batches(setup["cfg"], setup["data"], rng=rngs[1],
                         block=(2, 3), **kw)
    for k, v in full["clients"].items():
        assert part["clients"][k].shape[0] == 3
        assert torch.equal(part["clients"][k], v[2:5])
    for k in ("priority_mask", "weights"):
        assert torch.equal(part[k], full[k])
    for k, v in full["server"].items():
        assert torch.equal(part["server"][k], v)
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_pod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("aggregator,codec", [
    ("mean", "identity"), ("dp", "identity"), ("median", "identity"),
    ("mean", "int8")])
def test_chip_smoke_holds_fedagg_by_columns(aggregator, codec, monkeypatch):
    """``chip_smoke.py`` (n1)'s hold of a pod reduce's fedagg output
    against ``fedagg_plain``, a few columns at a time: the plain output
    itself passes, max|u| is over the included rows decoded, and a fault
    in the last chunk's last column is found at its size."""
    from repro_torch.kernels.fedagg import fedagg_plain
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "N1_PLAIN_COLS", 7)
    gen = torch.Generator().manual_seed(0)
    C, M = 4, 30
    u = torch.randn(C, M, generator=gen)
    w = torch.rand(C, generator=gen) + 0.1
    g = torch.tensor([1.0, 0.0, 1.0, 1.0])
    ops = dict(aggregator=aggregator)
    if aggregator == "dp":
        ops.update(row_scale=torch.rand(C, generator=gen),
                   noise=torch.randn(M, generator=gen), noise_scale=0.3)
    decoded = u
    if codec == "int8":
        scale = u.abs().amax(1) / 127.0
        u = torch.round(u / scale[:, None]).to(torch.int8)
        decoded = u.float() * scale[:, None]
        ops.update(codec="int8", dequant_scale=scale)
    want = fedagg_plain(u, w, g, **ops)
    err, top = cs.plain_by_columns(u, w, g, ops, want)
    assert err <= 1e-6
    assert top == float(decoded[g > 0].abs().max())
    bad = want.clone()
    bad[-1] += 0.5
    err, _ = cs.plain_by_columns(u, w, g, ops, bad)
    assert abs(err - 0.5) <= 1e-6


def test_ranks_import_no_jax():
    src = open(os.path.join(os.path.dirname(__file__),
                            "torch_pod_ranks.py")).read()
    assert "import jax" not in src and "from repro." not in src
