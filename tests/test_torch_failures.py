"""The fault layer of the port against the JAX package on the CPU: each
failure model's plans, the event clock (latency draws, lost masks, slot
timers), the divergence guard and its skip counter, ``run_federation``'s
halt, the ``delta_transform`` seam composed with corruption, and the
reference's ``ValueError``s for bad fault and buffer knobs.
Runs on the shortened quickstart of tests/test_torch_round.py (C = 8, E =
2, 6 rounds).

Tolerances: fault masks, timers, lost masks, skip counts and halting
rounds exactly; the latency draws within 1e-5 relative (the port's
``prng.normal`` sits a few ulp off jax's on a few draws), every completion
time checked to lie farther than LATENCY_MARGIN from each integer up to
ceil(deadline) and from the deadline, where a ceiling or a comparison
would flip; runs at tests/test_torch_round.py's tolerances; error-feedback
rows within 1e-3 of their row's quantum, or a flip of the int8 code on at
most 1% of the elements (``assert_ef_rows_match``), a corrupted client's
row kept bit for bit."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.configs.base import validate_config as jax_validate  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro_torch.configs.base import FedConfig, validate_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.fl.simulator import federation_tensors, run_federation  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_async import assert_stats_equal, recorded_runs  # noqa: E402
from test_torch_round import (BASE, FED_KW, _assert_history_parity,  # noqa: E402
                              _init, one_torch_thread)

LATENCY_MARGIN = 1e-4
RATES = dict(crash_rate=0.3, dropout_rate=0.25, dropout_len=2,
             corrupt_rate=0.2)


@pytest.mark.parametrize("model", ["none", "crash", "dropout", "corrupt",
                                   "chaos"])
def test_failure_plans_match_reference(model):
    """Six rounds of plans over 20 clients, mask for mask."""
    kw = dict(failure_model=model, seed=5, **RATES)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    for r in range(6):
        jplan = jengine.failure_plan(jfed, r, 20)
        plan = engine.failure_plan(fed, r, 20)
        if model == "none":
            assert jplan is None and plan is None
            continue
        for name in ("available", "crashed", "corrupt"):
            want, got = getattr(jplan, name), getattr(plan, name)
            assert (got is None) == (want is None), name
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"{name} round {r}")
    if model == "dropout":
        # one draw per window of dropout_len rounds
        a, b = (engine.failure_plan(fed, r, 20).available for r in (2, 3))
        assert torch.equal(a, b)


def assert_latency_margins(latency, deadline):
    lat = engine.client_latency(latency).numpy().astype(np.float64)
    marks = list(range(1, math.ceil(deadline) + 1)) + [deadline]
    gap = min(abs(x - m) for x in lat for m in marks)
    assert gap > LATENCY_MARGIN, (lat, gap)


@pytest.mark.parametrize("deadline", [1.5, 2.0, float("inf")])
def test_event_clock_matches_reference(deadline):
    """init_latency within 1e-5; lost masks and slot timers exactly, for
    every gate pattern of a 12-client round under crash faults."""
    kw = dict(latency_mode="lognormal", round_deadline=deadline,
              failure_model="crash", crash_rate=0.2, seed=3)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    C = 12
    jlat = jengine.init_latency(jfed, C)
    lat = engine.init_latency(fed, C)
    for k in ("compute", "net"):
        np.testing.assert_allclose(lat[k].numpy(), np.asarray(jlat[k]),
                                   rtol=1e-5)
    assert_latency_margins(lat, 3.0 if deadline == float("inf") else deadline)
    jstate = jengine.FederationState(None, None, None, None, None,
                                     latency=jlat)
    state = engine.FederationState(None, None, None, None, None, latency=lat)
    gates_rng = np.random.default_rng(0)
    for r in range(4):
        jplan = jengine.failure_plan(jfed, r, C)
        plan = engine.failure_plan(fed, r, C)
        jlost = jengine.lost_mask(jfed, jstate, jplan)
        lost = engine.lost_mask(fed, state, plan)
        np.testing.assert_array_equal(lost.numpy(), np.asarray(jlost))
        g = (gates_rng.random(C) < 0.6).astype(np.float32)
        g = g * (1.0 - np.asarray(jlost, np.float32))
        assert int(engine.slot_timer(fed, lat, torch.from_numpy(g))) == int(
            jengine.slot_timer(jfed, jlat, jnp.asarray(g)))
    assert int(engine.slot_timer(fed, lat, torch.zeros(C))) == 1


def _bits(tree):
    return [t.numpy().tobytes() for t in tree_leaves(tree)]


def _port_run(cfg, **kw):
    p0 = params_from_jax(jax.tree.map(np.asarray, _init("synth_logreg")),
                         "cpu")
    return run_federation(make_loss_fn(SMALL_MODELS["synth_logreg"][1]), p0,
                          FedConfig(**cfg), make_synth_federation(**FED_KW),
                          device="cpu", **kw)


def test_none_model_and_guard_alone_are_the_plain_round():
    """failure_model 'none' and the guard on a finite run change nothing:
    the same params, bit for bit, and the guard counts no skip."""
    plain = _port_run(BASE)
    for kw in (dict(failure_model="none"), dict(divergence_guard=True)):
        h = _port_run(dict(BASE, **kw))
        assert _bits(h.params) == _bits(plain.params)
        np.testing.assert_array_equal(np.array(h.gates),
                                      np.array(plain.gates))
    assert int(h.state.nonfinite_skips) == 0


def test_nan_corruption_skip_keeps_params_and_adam_bit_identical():
    """One round whose corrupted (NaN) priority client reaches the mean:
    the guard skips it, and params and every adam moment, t included, stay
    bit-identical; the reference counts the same skip."""
    kw = dict(BASE, failure_model="corrupt", corrupt_rate=0.5,
              divergence_guard=True, server_opt="adam", server_lr=0.01,
              warmup_frac=0.0)
    fed = FedConfig(**kw)
    plan = engine.failure_plan(fed, 0, 8)
    assert bool(plan.corrupt[:4].any())         # a priority client is hit
    fedn = make_synth_federation(**FED_KW)
    data, pm, w = federation_tensors(fedn, "cpu")
    p0 = params_from_jax(jax.tree.map(np.asarray, _init("synth_logreg")),
                         "cpu")
    state = engine.init_state(p0, fed, 8)
    round_fn = engine.make_round_fn(
        make_loss_fn(SMALL_MODELS["synth_logreg"][1]), fed)
    new, stats = round_fn(state, data, pm, w, prng.PRNGKey(1), 0)
    assert int(stats["skipped_nonfinite"]) == 1
    assert _bits(new.params) == _bits(state.params)
    assert _bits(new.opt_state) == _bits(state.opt_state)
    assert int(new.opt_state["t"]) == 0
    from repro.models.small import SMALL_MODELS as JAX_MODELS
    from repro.models.small import make_loss_fn as jax_loss_fn
    jfed = JaxFedConfig(**kw)
    jround = jengine.make_round_fn(jax_loss_fn(JAX_MODELS["synth_logreg"][1]),
                                   jfed)
    _, jstats = jround(jengine.init_state(_init("synth_logreg"), jfed, 8),
                       {"x": jnp.asarray(fedn.x), "y": jnp.asarray(fedn.y)},
                       jnp.asarray(fedn.priority_mask),
                       jnp.asarray(fedn.weights), jax.random.PRNGKey(1), 0)
    assert int(jstats["skipped_nonfinite"]) == 1
    np.testing.assert_array_equal(stats["gates"].numpy(),
                                  np.asarray(jstats["gates"]))


# name: (knobs, whether the guard must skip). NaN corruption at 0.3 hits
# an included client in some rounds and none in others, so the counter
# climbs and resets. Under chaos at seed 3 some rounds' NaN rows are all
# lost or gated out and must leave the aggregate finite; under the int8
# wire a NaN row encodes to zeros (its scale falls back to 1, NaN converts
# to the integer 0, in both packages): no skip, and the error-feedback
# rows keep their last finite residual
NAN_CHAOS = dict(failure_model="chaos", crash_rate=0.3, corrupt_rate=0.2,
                 divergence_guard=True, seed=3)
GUARDED = {
    "skip_counter_resets": (dict(failure_model="corrupt", corrupt_rate=0.3,
                                 divergence_guard=True), True),
    "chaos_sync": (dict(failure_model="chaos", divergence_guard=True,
                        server_opt="momentum", server_lr=0.5, **RATES), True),
    "trimmed_nan_chaos": (dict(NAN_CHAOS, aggregator="trimmed_mean",
                               trim_frac=0.2), True),
    "int8_ef_nan_chaos": (dict(NAN_CHAOS, wire_codec="int8",
                               error_feedback=True), False),
    # a NaN aggregate is zeroed before it enters the in-flight buffer
    "async_clock_chaos": (dict(backend="scan_async", async_depth=2,
                               async_mode="ready", latency_mode="lognormal",
                               round_deadline=2.0, failure_model="chaos",
                               crash_rate=0.2, dropout_rate=0.2,
                               dropout_len=2, corrupt_rate=0.1,
                               divergence_guard=True), True),
}


@pytest.mark.parametrize("case", sorted(GUARDED))
def test_guarded_run_matches_reference(case, monkeypatch):
    knobs, skips_expected = GUARDED[case]
    cfg = dict(BASE, **knobs)
    if cfg.get("latency_mode") == "lognormal":
        assert_latency_margins(engine.init_latency(FedConfig(**cfg), 8),
                               cfg["round_deadline"])
    hj, ht, jstats, tstats = recorded_runs(cfg, monkeypatch)
    _assert_history_parity(hj, ht, FED_KW["test_samples"])
    assert_stats_equal(jstats, tstats)
    skips = [int(s["skipped_nonfinite"]) for s in tstats]
    assert (max(skips) > 0) == skips_expected, skips
    if case == "skip_counter_resets":
        # a finite round after a skip resets the count
        assert any(a > 0 and b == 0 for a, b in zip(skips, skips[1:])), skips
    assert_ef_rows_match(tree_leaves(ht.state.ef_accum),
                         jax.tree.leaves(hj.state.ef_accum))


# the error-feedback rows' bound, as a fraction of the row's quantum
EF_ROW_RTOL = 1e-3
EF_MAX_FLIPS = 0.01


def assert_ef_rows_match(got_leaves, want_leaves):
    """Error-feedback rows [C, ...] element by element: each within
    EF_ROW_RTOL of the row's quantum (at least twice its largest residual,
    a residual being at most half a quantum) of the reference's, or a
    one-quantum flip of its int8 code, where a last-bit difference of
    x / scale crossed a rounding boundary. A flip turns a residual r near
    +-q/2 into r -+ q, so the two values are opposite within the same
    bound; at most EF_MAX_FLIPS of the elements may flip."""
    flips = total = 0
    for got, want in zip(got_leaves, want_leaves):
        a = got.numpy().reshape(got.shape[0], -1).astype(np.float64)
        b = np.asarray(want).reshape(a.shape).astype(np.float64)
        assert np.isfinite(a).all()
        tol = EF_ROW_RTOL * 2 * np.abs(b).max(axis=1, keepdims=True)
        same = np.abs(a - b) <= tol
        flip = ~same & (np.abs(a + b) <= tol)
        assert (same | flip).all(), np.argwhere(~(same | flip))[:5]
        flips += int(flip.sum())
        total += a.size
    assert flips <= EF_MAX_FLIPS * total, (flips, total)


def stepped_rounds(cfg, jax_transform=None, port_transform=None):
    """Both packages' make_round_fn stepped round by round from the same
    init and key chain (the simulators' split per round), with an optional
    delta_transform each: yields (round, jax state, jax stats, port state,
    port stats) after every round."""
    from repro.models.small import SMALL_MODELS as JAX_MODELS
    from repro.models.small import make_loss_fn as jax_loss_fn
    from test_torch_round import jax_synth
    jfed, fed = JaxFedConfig(**cfg), FedConfig(**cfg)
    p0 = _init("synth_logreg")
    jfedn = jax_synth(**FED_KW)
    jround = jax.jit(jengine.make_round_fn(
        jax_loss_fn(JAX_MODELS["synth_logreg"][1]), jfed,
        delta_transform=jax_transform))
    jstate = jengine.init_state(p0, jfed, 8)
    jargs = ({"x": jnp.asarray(jfedn.x), "y": jnp.asarray(jfedn.y)},
             jnp.asarray(jfedn.priority_mask), jnp.asarray(jfedn.weights))
    tround = engine.make_round_fn(
        make_loss_fn(SMALL_MODELS["synth_logreg"][1]), fed,
        delta_transform=port_transform)
    tstate = engine.init_state(
        params_from_jax(jax.tree.map(np.asarray, p0), "cpu"), fed, 8)
    targs = federation_tensors(make_synth_federation(**FED_KW), "cpu")
    jrng, trng = jax.random.PRNGKey(fed.seed), prng.PRNGKey(fed.seed)
    for r in range(fed.rounds):
        jrng, jkey = jax.random.split(jrng)
        trng, tkey = prng.split(trng)
        jstate, jstats = jround(jstate, *jargs, jkey, r)
        tstate, tstats = tround(tstate, *targs, tkey, r)
        np.testing.assert_array_equal(tstats["gates"].numpy(),
                                      np.asarray(jstats["gates"]))
        yield r, jstate, jstats, tstate, tstats


def test_int8_error_feedback_rows_step_with_reference():
    """int8 + error feedback under NaN chaos, stepped round by round in
    both packages: after every round the rows match the reference's
    (assert_ef_rows_match), and every corrupted (NaN) client's row keeps
    its last finite residual bit for bit, in the port as in the
    reference, whether or not the client transmitted (some do)."""
    cfg = dict(BASE, **GUARDED["int8_ef_nan_chaos"][0])
    fed = FedConfig(**cfg)
    told = jold = None                      # init_state's rows are zeros
    sent_nan = 0
    for r, jstate, jstats, tstate, tstats in stepped_rounds(cfg):
        assert int(tstats["skipped_nonfinite"]) == 0
        tnew = [t.clone() for t in tree_leaves(tstate.ef_accum)]
        jnew = [np.asarray(t) for t in jax.tree.leaves(jstate.ef_accum)]
        assert_ef_rows_match(tnew, jnew)
        told = told or [torch.zeros_like(t) for t in tnew]
        jold = jold or [np.zeros_like(t) for t in jnew]
        bad = engine.failure_plan(fed, r, 8).corrupt.numpy()
        sent_nan += int((bad & (tstats["gates"].numpy() > 0)).sum())
        for c in np.flatnonzero(bad):
            for new, old in zip(tnew, told):
                assert torch.equal(new[c], old[c]), (r, c)
            for new, old in zip(jnew, jold):
                np.testing.assert_array_equal(new[c], old[c])
        told, jold = tnew, jnew
    assert sent_nan > 0


def _attack(where):
    """An attacker for the delta_transform seam: clients 1 and 5, by
    identity, send -3 times their delta plus 0.01 (not a pure scaling, so
    the order of composition with a scaled corruption shows)."""
    def transform(cp, gp, idx):
        bad = (idx == 1) | (idx == 5)
        out = {}
        for k in cp:
            b = bad.reshape((-1,) + (1,) * (cp[k].ndim - 1))
            out[k] = where(b, gp[k][None] - 3.0 * (cp[k] - gp[k][None])
                           + 0.01, cp[k])
        return out
    return transform


# (max_cohort, candidate_pool): the dense round, a cohort round, a pooled
# round (4 priority + 2 sampled of 8)
SEAM = [(0, 0), (3, 0), (0, 6)]


@pytest.mark.parametrize("max_cohort,pool", SEAM, ids=["0", "3", "pool6"])
def test_delta_transform_composes_with_corruption(max_cohort, pool):
    """A user delta_transform composed over scaled corruption, on the dense
    round, on a cohort round (rows in cohort space, the transform
    targeting client identities) and on a pooled round, stepped round by
    round against the reference's make_round_fn: gates exactly, params
    within tests/test_torch_round.py's 1e-4 max|p| every round. A pooled
    round hands the seam pool-local indices, as the reference's code does
    (its docstring says identities): ``arange(P)``, so the attacker is the
    pool's rows 1 and 5. An attacker is included in some round, so the
    transform moves the result."""
    cfg = dict(BASE, failure_model="corrupt", corrupt_rate=0.3,
               corrupt_scale=4.0, max_cohort=max_cohort, candidate_pool=pool)
    calls = {"jax": 0, "port": 0}
    seen = []

    def counted(name, fn):
        def transform(cp, gp, idx):
            calls[name] += 1
            if name == "port":
                seen.append(idx.tolist())
            return fn(cp, gp, idx)
        return transform

    attacked = 0
    for r, jstate, jstats, tstate, tstats in stepped_rounds(
            cfg, counted("jax", _attack(jnp.where)),
            counted("port", _attack(torch.where))):
        rows = (tstats["pool_idx"].tolist() if pool
                else list(range(cfg["num_clients"])))
        attacked += sum(int(tstats["gates"][rows[i]] > 0) for i in (1, 5))
        if pool:
            np.testing.assert_array_equal(tstats["pool_idx"].numpy(),
                                          np.asarray(jstats["pool_idx"]))
            assert seen[-1] == list(range(pool))
        for k, want in jstate.params.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                tstate.params[k].numpy(), want, rtol=0,
                atol=1e-4 * np.abs(want).max(), err_msg=f"{k} round {r}")
    assert calls["port"] == cfg["rounds"] and calls["jax"] >= 1
    assert attacked > 0


def test_run_federation_halt_matches_reference(monkeypatch):
    cfg = dict(BASE, failure_model="corrupt", corrupt_rate=0.5,
               divergence_guard=True, max_nonfinite_skips=2, rounds=8)
    hj, ht, jstats, tstats = recorded_runs(cfg, monkeypatch, eval_every=1)
    assert hj.diverged_at is not None
    assert ht.diverged_at == hj.diverged_at
    assert ht.rounds == hj.rounds and len(ht.rounds) < cfg["rounds"]
    assert_stats_equal(jstats, tstats)
    assert ht.dp_epsilon is None
    _assert_history_parity(hj, ht, FED_KW["test_samples"])


# knobs the reference refuses with a ValueError, and the match of its text
VALUE_ERRORS = [
    (dict(async_depth=2, async_mode="lifo"), "async_mode"),
    (dict(async_depth=2, async_mode="ready", min_lag=3), "min_lag"),
    (dict(async_depth=2, async_mode="ready", min_lag=0), "min_lag"),
    (dict(latency_mode="gamma"), "latency_mode"),
    (dict(latency_mode="lognormal", latency_sigma=-1.0), "latency_sigma"),
    (dict(latency_mode="lognormal", latency_net_sigma=-0.1),
     "latency_net_sigma"),
    (dict(latency_mode="lognormal", async_depth=2), "async_mode='ready'"),
    (dict(latency_mode="lognormal", round_deadline=0.0), "round_deadline"),
    (dict(round_deadline=2.0), "latency_mode='lognormal'"),
    (dict(failure_model="meteor"), "failure model"),
    (dict(failure_model="crash", crash_rate=1.5), "crash_rate"),
    (dict(failure_model="chaos", corrupt_rate=-0.1), "corrupt_rate"),
    (dict(failure_model="dropout", dropout_rate=0.2, dropout_len=0),
     "dropout_len"),
    (dict(max_nonfinite_skips=-1), "max_nonfinite_skips"),
]


@pytest.mark.parametrize("kw,match", VALUE_ERRORS,
                         ids=[",".join(f"{k}={v}" for k, v in kw.items())
                              for kw, _ in VALUE_ERRORS])
def test_reference_value_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        jax_validate(JaxFedConfig(**kw))
    with pytest.raises(ValueError, match=match):
        validate_config(FedConfig(**kw))


def test_async_depth_needs_the_async_backend():
    fed = FedConfig(**BASE, async_depth=2)
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    with pytest.raises(ValueError, match="scan_async"):
        engine.make_round_fn(loss_fn, fed)
    assert callable(engine.make_round_fn(loss_fn, fed, backend="scan_async"))


def test_pool_keyed_fault_draws_are_not_ported():
    """Once a refusal (ROADMAP A13), now the pool-keyed draws: every
    failure model's plan over a pool of identities equals the reference's,
    mask for mask, and each client's draw is the one it gets in any other
    pool."""
    ids = np.array([0, 3, 7, 19, 1000])
    for model in ("crash", "dropout", "corrupt", "chaos"):
        kw = dict(failure_model=model, seed=5, **RATES)
        jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
        for r in range(3):
            jplan = jengine.failure_plan(jfed, r, 5,
                                         client_ids=jnp.asarray(ids))
            plan = engine.failure_plan(fed, r, 5,
                                       client_ids=torch.from_numpy(ids))
            alone = engine.failure_plan(fed, r, 1,
                                        client_ids=torch.tensor([19]))
            for name in ("available", "crashed", "corrupt"):
                want, got = getattr(jplan, name), getattr(plan, name)
                assert (got is None) == (want is None), name
                if want is not None:
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))
                    assert bool(getattr(alone, name)[0]) == bool(got[3])
