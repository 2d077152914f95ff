"""Client selection in the port against the JAX package on the CPU:
partial participation and the topk_align, welfare and grad_sim
strategies.

* ``engine.participation_mask``: the Bernoulli draw (the priority set
  never empty) and the straggler cadence, exactly equal to the
  reference's over many keys and rates.
* ``compute_gates`` under topk_align (budgets 0 to past C, ``inf``
  statistics, participation), welfare and grad_sim on seeded contexts:
  gates exactly.
* ``cosine_to_priority`` within 1e-6 (f32 sums in another order).
* Rounds under each strategy (grad_sim exact and on CountSketches), both
  backends: gates and backlog exactly, params within 1e-4 of each leaf's
  largest magnitude (tests/test_torch_round.py's bound).
* Paper App. C.3 / Fig. 5 shortened through ``run_federation`` on both
  backends: the FMNIST stand-in, ``logreg``, 60 clients (18 priority),
  participation 0.3, E = 5, 3 rounds; the History held to
  tests/test_torch_round.py's bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.data.shards import make_benchmark_federation as jax_bench  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data.shards import make_benchmark_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from test_torch_cohort import BASE, _assert_parity, _rounds  # noqa: E402
from test_torch_round import _assert_history_parity, _runs, one_blas_thread  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one torch thread for the module (see
    tests/test_torch_round.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with one_blas_thread():
        yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ participation
@pytest.mark.parametrize("straggler_period", [0, 3])
@pytest.mark.parametrize("rate", [0.05, 0.3, 0.5, 0.9, 1.0])
def test_participation_mask_matches_reference(rate, straggler_period):
    """40 keys a rate, C = 13 with 3 priority clients; the low rate makes
    the draw miss every priority client often (the fix-up path)."""
    kw = dict(participation=rate, straggler_period=straggler_period)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    pm = np.zeros(13, bool)
    pm[[0, 4, 9]] = True
    fixups = 0
    for seed in range(40):
        r = seed % 7
        want = np.asarray(jengine.participation_mask(
            jfed, jax.random.PRNGKey(seed), jnp.asarray(pm), r))
        got = engine.participation_mask(fed, prng.PRNGKey(seed),
                                        torch.from_numpy(pm), r)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(seed))
        draw = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), rate,
                                               (13,)))
        fixups += rate < 1.0 and not draw[pm].any()
    assert rate != 0.05 or fixups > 0


# ------------------------------------------------------------ strategies
def _contexts(seed, C=11):
    rng = np.random.default_rng(seed)
    align = rng.choice([0.1, 0.2, 0.3, 0.35, 0.6], size=C).astype(np.float32)
    align[rng.random(C) < 0.1] = np.inf
    pm = rng.random(C) < 0.3
    part = rng.random(C) < 0.8
    util = rng.random(C).astype(np.float32) * 0.6
    incl = rng.random(C).astype(np.float32)
    cos = rng.uniform(-1, 1, C).astype(np.float32)
    w = rng.random(C).astype(np.float32)
    common = dict(global_align=0.25, eps=0.2, welfare_floor=0.3,
                  sim_threshold=0.1)
    j = jengine.SelectionContext(
        align_vals=jnp.asarray(align), priority_mask=jnp.asarray(pm),
        weights=jnp.asarray(w), participation=jnp.asarray(part),
        util_ema=jnp.asarray(util), incl_ema=jnp.asarray(incl),
        delta_cos=jnp.asarray(cos), warmup=bool(seed % 5 == 0), **common)
    t = engine.SelectionContext(
        align_vals=torch.from_numpy(align), priority_mask=torch.from_numpy(pm),
        weights=torch.from_numpy(w), participation=torch.from_numpy(part),
        util_ema=torch.from_numpy(util), incl_ema=torch.from_numpy(incl),
        delta_cos=torch.from_numpy(cos), warmup=bool(seed % 5 == 0), **common)
    return j, t


@pytest.mark.parametrize("selection,topk", [
    ("topk_align", 0), ("topk_align", 1), ("topk_align", 3),
    ("topk_align", 11), ("topk_align", 40), ("welfare", 4),
    ("grad_sim", 4)])
def test_strategy_gates_match_reference(selection, topk):
    for seed in range(25):
        j, t = _contexts(seed)
        j.topk = t.topk = topk
        for with_part in (True, False):
            if not with_part:
                j.participation = t.participation = None
            want = np.asarray(jengine.compute_gates(j, selection))
            got = engine.compute_gates(t, selection)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"seed {seed}")


def test_stateless_welfare_and_deltaless_grad_sim_raise():
    _, t = _contexts(0)
    t.util_ema = None
    with pytest.raises(ValueError, match="welfare needs"):
        engine.compute_gates(t, "welfare")
    t.delta_cos = None
    with pytest.raises(ValueError, match="grad_sim needs"):
        engine.compute_gates(t, "grad_sim")


@pytest.mark.parametrize("seed", range(4))
def test_cosine_to_priority_matches_reference(seed):
    rng = np.random.default_rng(seed)
    C, M = 9, 1000 + 317 * seed
    flat = rng.normal(0, 1, (C, M)).astype(np.float32)
    flat[3] *= 1e-3
    w = rng.random(C).astype(np.float32)
    pm = np.arange(C) < 3
    want = np.asarray(jengine.cosine_to_priority(
        jnp.asarray(flat), jnp.asarray(w), jnp.asarray(pm)))
    got = engine.cosine_to_priority(torch.from_numpy(flat),
                                    torch.from_numpy(w), torch.from_numpy(pm))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sketch_key_matches_reference():
    for r in (0, 1, 17):
        np.testing.assert_array_equal(
            engine.sketch_key(FedConfig(seed=5), r).numpy(),
            np.asarray(jengine.sketch_key(JaxFedConfig(seed=5), r)))


# ------------------------------------------------------------ rounds
STRATEGY_ROUNDS = {
    "topk_align": dict(selection="topk_align", topk=2, participation=0.6),
    "welfare": dict(selection="welfare", welfare_floor=0.4, utility_ema=0.5),
    "grad_sim": dict(selection="grad_sim", sim_threshold=0.2),
    "grad_sim_sketch": dict(selection="grad_sim", sim_threshold=0.2,
                            grad_sim_sketch=True, sketch_dim=32),
}


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
@pytest.mark.parametrize("name", sorted(STRATEGY_ROUNDS))
def test_strategy_rounds_match_reference(name, backend):
    cfg = dict(BASE, backend=backend, **STRATEGY_ROUNDS[name])
    ts, tstats, js, jstats = _rounds(cfg)
    gates = np.array([s["gates"].numpy() for s in tstats])
    npri = cfg["num_priority"]
    # the strategy decides: some non-priority client in and some out
    assert 0 < gates[:, npri:].sum() < gates[:, npri:].size
    _assert_parity(ts, tstats, js, jstats)


# ------------------------------------------------------------ paper Fig. 5
FIG5 = dict(num_clients=60, num_priority=18, rounds=3, local_epochs=5,
            epsilon=0.2, lr=0.1, warmup_frac=0.1, participation=0.3)


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
def test_fig5_partial_participation_matches_reference(backend):
    """App. C.3: 60 FMNIST-stand-in clients (40 samples each), 18
    priority, 30% sampled a round; the logreg gates on accuracies."""
    kw = dict(seed=0, n_priority=18, samples_per_client=40, test_samples=400)
    tfedn = make_benchmark_federation(**kw)
    hj, ht = _runs("logreg", dict(FIG5, backend=backend), jax_bench(**kw),
                   tfedn, eval_every=1)
    gates = np.array(ht.gates)
    # partial participation: priority clients are sampled out too
    assert 0 < gates[:, :18].sum() < gates[:, :18].size
    assert gates[:, 18:].sum() > 0
    _assert_history_parity(hj, ht, len(tfedn.test_y))
