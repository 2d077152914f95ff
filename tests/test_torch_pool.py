"""Candidate pools (``fed.candidate_pool``) of the port against the JAX
package on the CPU: ``prng.gumbel`` and the identity-keyed Bernoulli
draws, ``engine.pool_select`` under the three weightings, the pooled
``make_round_fn`` stepped round by round beside the reference's on
tests/test_pool.py's federation (SYNTH seed 11, 3 priority + 9
non-priority clients, 64 samples, ``synth_logreg``, P = 6), the
pool-keyed failure plans, and both smoke LM rounds under ``_pool_wrap``;
plus the dense contract: P = 0 and P >= C are the dense round, bit for
bit, for every strategy on every backend.

Tolerances: pool indices, gates, backlog, lost clients and fault masks
exactly, after checking that in every round the P-th and (P+1)-th largest
finite pool scores differ by more than POOL_MARGIN (the port's logs may
sit an ulp or so off XLA's, and a top-P boundary on a tie would decide by
rounding); Gumbel draws within GUMBEL_ATOL (the uniform is bit-exact, the
two logs are the host's); params within tests/test_torch_round.py's 1e-4
max|p|; the int8 run's error-feedback rows as tests/test_torch_failures.py
holds them; the LM rounds at tests/test_torch_temporal.py's tolerances
and their params within tests/test_torch_train.py's PARITY. Every
out-of-pool row of ``backlog``, ``util_ema``, ``incl_ema`` and
``ef_accum`` is held bit for bit across each round."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.data.synth import make_synth_federation as jax_synth  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.models.small import SMALL_MODELS as JAX_MODELS  # noqa: E402
from repro.models.small import make_loss_fn as jax_loss_fn  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.fl.simulator import federation_tensors  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_failures import assert_ef_rows_match  # noqa: E402
from test_torch_round import _init, one_torch_thread  # noqa: E402,F401
from test_torch_train import PARITY  # noqa: E402

POOL_MARGIN = 1e-4
GUMBEL_ATOL = 2e-6
FEDN = dict(seed=11, n_priority=3, n_nonpriority=9, samples_per_client=64)
C, P = 12, 6
BASE = dict(num_clients=C, num_priority=3, rounds=6, local_epochs=1,
            epsilon=0.5, warmup_frac=0.0, align_stat="loss",
            candidate_pool=P)
PER_CLIENT = ("backlog", "util_ema", "incl_ema")


@functools.lru_cache(maxsize=None)
def federations():
    """FEDN in both packages, made once per module: the SYNTH generator
    draws each client with small SVDs, which crawl beside other test
    workers."""
    return jax_synth(**FEDN), make_synth_federation(**FEDN)


@functools.lru_cache(maxsize=None)
def init_params():
    return _init("synth_logreg")


@pytest.mark.parametrize("seed,shape", [(0, (12,)), (3, (1000,)),
                                        (7, (4, 5))])
def test_gumbel_and_identity_draws_match_jax(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)
    # identity-keyed: vmap(fold_in) over the ids, one scalar draw a key
    ids = np.array([0, 2, 5, 11, 4096, 2**31 - 1]) + seed
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(seed), jnp.asarray(ids))
    keys = prng.fold_in(prng.PRNGKey(seed), torch.from_numpy(ids))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    for rate in (0.3, 0.7):
        want = jax.vmap(lambda k: jax.random.bernoulli(k, rate))(jkeys)
        np.testing.assert_array_equal(prng.bernoulli(keys, rate, ()).numpy(),
                                      np.asarray(want))


def pool_scores(fed, key, pm, backlog, incl_ema):
    """The reference's pool scores (jnp), +inf for priority clients."""
    g = jax.random.gumbel(jnp.asarray(key.numpy().astype(np.uint32)),
                          pm.shape, jnp.float32)
    if fed.pool_weighting == "backlog":
        g = g + jnp.log1p(jnp.asarray(backlog, jnp.float32))
    elif fed.pool_weighting == "ema":
        g = g + jnp.log(jnp.maximum(
            1.0 + 1e-6 - jnp.asarray(incl_ema, jnp.float32), 1e-6))
    return np.where(pm, np.inf, np.asarray(g))


def assert_pool_margin(scores, pool):
    """The P-th and (P+1)-th largest finite scores are POOL_MARGIN apart
    (the +inf ones are all in: P >= num_priority)."""
    finite = np.sort(scores[np.isfinite(scores)])[::-1]
    k = pool - int(np.isinf(scores).sum())
    gap = finite[k - 1] - finite[k]
    assert gap > POOL_MARGIN, (gap, finite)


@pytest.mark.parametrize("weighting", ["uniform", "backlog", "ema"])
def test_pool_select_matches_reference(weighting):
    """20 draws over 40 clients (5 priority), P = 12, with aged ledgers:
    the index sets exactly, sorted, priority always in."""
    fed = FedConfig(num_clients=40, num_priority=5, candidate_pool=12,
                    pool_weighting=weighting)
    jfed = JaxFedConfig(num_clients=40, num_priority=5, candidate_pool=12,
                        pool_weighting=weighting)
    rng = np.random.default_rng(0)
    pm = np.arange(40) < 5
    seen = set()
    for s in range(20):
        backlog = rng.integers(0, 6, 40).astype(np.int32)
        incl = rng.random(40).astype(np.float32)
        key = prng.split(prng.PRNGKey(s))[1]
        assert_pool_margin(pool_scores(fed, key, pm, backlog, incl), 12)
        want = jengine.pool_select(
            jfed, jnp.asarray(key.numpy().astype(np.uint32)),
            jnp.asarray(pm), jnp.asarray(backlog), jnp.asarray(incl), 12)
        got = engine.pool_select(fed, key, torch.from_numpy(pm),
                                 torch.from_numpy(backlog),
                                 torch.from_numpy(incl), 12)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert set(range(5)) <= set(got.tolist())
        seen.add(tuple(got.tolist()))
    assert len(seen) > 10


def _run(fed, backend, rounds=1, state=None):
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    fn = engine.make_round_fn(loss_fn, fed, backend=backend)
    p0 = params_from_jax(jax.tree.map(np.asarray, init_params()),
                         "cpu")
    state = state or engine.init_state(p0, fed, C)
    args = federation_tensors(federations()[1], "cpu")
    for r in range(rounds):
        state, stats = fn(state, *args, prng.PRNGKey(1 + r), 2 + r)
    return state, stats


@pytest.mark.parametrize("backend", engine.BACKENDS)
@pytest.mark.parametrize("selection", sorted(engine.STRATEGIES))
def test_pool_disabled_and_full_are_dense(selection, backend):
    """candidate_pool 0, C and C + 7 run the dense round: every state leaf
    and the gates bit-identical, and no pool_idx stat."""
    fed = FedConfig(**dict(BASE, candidate_pool=0), selection=selection,
                    topk=2, welfare_floor=0.05)
    dense_state, dense_stats = _run(fed, backend)
    for pool in (0, C, C + 7):
        state, stats = _run(fed.replace(candidate_pool=pool), backend)
        assert sorted(stats) == sorted(dense_stats)
        assert torch.equal(stats["gates"], dense_stats["gates"])
        for a, b in zip(tree_leaves(vars(state)),
                        tree_leaves(vars(dense_state))):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _snapshot(state):
    return {name: [t.clone() for t in tree_leaves(getattr(state, name))]
            for name in PER_CLIENT + ("ef_accum",)}


def stepped_pool_rounds(cfg):
    """Both packages' make_round_fn on the pool federation, stepped from
    the same init and key chain; checks each round's pool margin, pool,
    gates, backlog and lost clients exactly and the out-of-pool rows bit
    for bit. Yields (round, jax state, port state) after every round."""
    jfed, fed = JaxFedConfig(**cfg), FedConfig(**cfg)
    p0 = init_params()
    jfedn = federations()[0]
    jround = jax.jit(jengine.make_round_fn(
        jax_loss_fn(JAX_MODELS["synth_logreg"][1]), jfed))
    jstate = jengine.init_state(p0, jfed, C)
    jargs = ({"x": jnp.asarray(jfedn.x), "y": jnp.asarray(jfedn.y)},
             jnp.asarray(jfedn.priority_mask), jnp.asarray(jfedn.weights))
    tround = engine.make_round_fn(
        make_loss_fn(SMALL_MODELS["synth_logreg"][1]), fed)
    tstate = engine.init_state(
        params_from_jax(jax.tree.map(np.asarray, p0), "cpu"), fed, C)
    targs = federation_tensors(federations()[1], "cpu")
    pm = targs[1].numpy()
    jrng, trng = jax.random.PRNGKey(fed.seed), prng.PRNGKey(fed.seed)
    for r in range(fed.rounds):
        jrng, jkey = jax.random.split(jrng)
        trng, tkey = prng.split(trng)
        assert_pool_margin(pool_scores(fed, prng.split(tkey)[1], pm,
                                       tstate.backlog.numpy(),
                                       tstate.incl_ema.numpy()), P)
        before = _snapshot(tstate)
        jstate, jstats = jround(jstate, *jargs, jkey, r)
        tstate, tstats = tround(tstate, *targs, tkey, r)
        for k in ("pool_idx", "gates", "backlog", "lost_clients",
                  "skipped_nonfinite", "staleness", "applied_valid"):
            if k in jstats:
                np.testing.assert_array_equal(tstats[k].numpy(),
                                              np.asarray(jstats[k]),
                                              err_msg=f"{k} round {r}")
        out = np.setdiff1d(np.arange(C), tstats["pool_idx"].numpy())
        for name, old in before.items():
            for a, b in zip(tree_leaves(getattr(tstate, name)), old):
                assert torch.equal(a[out], b[out]), (name, r)
        assert not tstats["gates"][out].any()
        yield r, jstate, tstate


# name: knobs over BASE (uniform weighting on vmap_spatial unless named)
POOLED = {
    "uniform": dict(),
    "backlog_cohort4_momentum_temporal": dict(
        pool_weighting="backlog", max_cohort=4, epsilon=1.0,
        backlog_boost=0.1, server_opt="momentum", server_lr=0.5,
        backend="scan_temporal"),
    "ema_welfare_participation": dict(
        pool_weighting="ema", selection="welfare", welfare_floor=0.3,
        participation=0.5),
    "async_ready_clock_chaos": dict(
        backend="scan_async", async_depth=2, async_mode="ready",
        latency_mode="lognormal", round_deadline=2.0, failure_model="chaos",
        crash_rate=0.2, dropout_rate=0.2, dropout_len=2, corrupt_rate=0.2,
        corrupt_scale=3.0),
    "dp_crash": dict(aggregator="dp", dp_clip=0.5, dp_noise=0.1,
                     failure_model="crash", crash_rate=0.3),
    "median_int8_ef": dict(aggregator="median", wire_codec="int8",
                           error_feedback=True),
}


@pytest.mark.parametrize("case", sorted(POOLED))
def test_pooled_round_matches_reference(case):
    cfg = dict(BASE, **POOLED[case])
    for r, jstate, tstate in stepped_pool_rounds(cfg):
        for k, want in jstate.params.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                tstate.params[k].numpy(), want, rtol=0,
                atol=1e-4 * np.abs(want).max(), err_msg=f"{k} round {r}")
        if cfg.get("wire_codec") == "int8":
            assert_ef_rows_match(tree_leaves(tstate.ef_accum),
                                 jax.tree.leaves(jstate.ef_accum))
    if cfg.get("pool_weighting") == "backlog":
        # the cohort overflows, so the weighting sees a non-zero backlog
        assert int(tstate.backlog.max()) > 0


@pytest.mark.parametrize("model", ["none", "crash", "dropout", "corrupt",
                                   "chaos"])
def test_pool_keyed_failure_plans_match_reference(model):
    """Four rounds of plans over a drawn pool of 6 of 12 clients, in pool
    space, mask for mask against the reference's."""
    kw = dict(failure_model=model, seed=5, crash_rate=0.3, dropout_rate=0.3,
              dropout_len=2, corrupt_rate=0.3)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    pm = torch.arange(C) < 3
    for r in range(4):
        idx = engine.pool_select(FedConfig(candidate_pool=P),
                                 prng.PRNGKey(r), pm,
                                 torch.zeros(C, dtype=torch.int32),
                                 torch.zeros(C), P)
        jplan = jengine.failure_plan(jfed, r, P,
                                     client_ids=jnp.asarray(idx.numpy()))
        plan = engine.failure_plan(fed, r, P, client_ids=idx)
        if model == "none":
            assert jplan is None and plan is None
            continue
        for name in ("available", "crashed", "corrupt"):
            want, got = getattr(jplan, name), getattr(plan, name)
            assert (got is None) == (want is None), name
            if want is not None:
                assert got.shape == (P,)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"{name} round {r}")


# name: (temporal round, knobs). 4 clients (2 priority), a pool of 3
LM_POOLED = {
    "spatial_ema_crash": (False, dict(
        candidate_pool=3, pool_weighting="ema", epsilon=0.1,
        failure_model="crash", crash_rate=0.3)),
    "temporal_chaos_momentum": (True, dict(
        candidate_pool=3, epsilon=0.1, failure_model="chaos",
        crash_rate=0.3, dropout_rate=0.3, corrupt_rate=0.0,
        server_opt="momentum", server_lr=0.5)),
}


@pytest.mark.parametrize("case", sorted(LM_POOLED))
def test_pooled_lm_round_matches_reference(case, monkeypatch):
    """The smoke LM rounds under ``_pool_wrap``, 2 rounds: pool_idx,
    gates, backlog and lost clients exactly (the pool is drawn from the
    named ``candidate_pool`` stream), out-of-pool rows bit-identical."""
    from repro_torch.fl import sharded
    from test_torch_temporal import (assert_margins, assert_state_parity,
                                     jax_rounds, port_rounds)
    fsdp, kw = LM_POOLED[case]
    snaps = []
    make_step = sharded.make_round_step

    def recording(*a, **k):
        step = make_step(*a, **k)

        def stepped(state, batch, round_idx=0):
            before = _snapshot(state)
            state, stats = step(state, batch, round_idx)
            snaps.append((before, state, stats["pool_idx"].clone()))
            return state, stats
        return stepped
    monkeypatch.setattr(sharded, "make_round_step", recording)
    tstate, tstats = port_rounds(kw, rounds=2, fsdp=fsdp)
    assert_margins(tstats, kw["epsilon"])
    jstate, jstats = jax_rounds(kw, 2, fsdp=fsdp)
    for t, j in zip(tstats, jstats):
        for k in ("pool_idx", "lost_clients"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert_state_parity(tstate, tstats, jstate, jstats)
    for got, want in zip(tree_leaves(tstate.params),
                         jax.tree.leaves(jstate.params)):
        want = np.asarray(want)
        assert (float(np.abs(got.numpy() - want).max())
                <= PARITY * max(1.0, float(np.abs(want).max())))
    fed = FedConfig(**kw)
    pm = np.arange(4) < 2
    for r, (before, after, idx) in enumerate(snaps):
        assert_pool_margin(pool_scores(
            fed, sharded.pool_round_key(fed, r), pm,
            before["backlog"][0].numpy(), before["incl_ema"][0].numpy()), 3)
        out = np.setdiff1d(np.arange(4), idx.numpy())
        for name, old in before.items():
            for a, b in zip(tree_leaves(getattr(after, name)), old):
                assert torch.equal(a[out], b[out]), name
