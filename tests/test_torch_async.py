"""The asynchronous round (``scan_async``) of the port against the JAX
package on the CPU: ``run_federation`` on the shortened quickstart of
tests/test_torch_round.py (C = 8, E = 2, 6 rounds) under the fifo pipe and
the variable-lag buffer, ``adaptive_staleness`` under momentum, the drain,
and ``async_apply`` itself on hand-built buffers (several pops in a round,
a force-pop on a full buffer, clocked ready sets that are no prefix, the
drift clamp and its zero-reference fallback).

Tolerances: tests/test_torch_round.py's (gates exact, global loss rtol
1e-5, params 1e-4 max|p|); every stat the buffer adds (``staleness``,
``applied_valid``, ``inflight_occupancy``) exactly. On hand-built buffers:
ready sets, ages, timers, occupancy and the moved delta slots exactly,
params and moments within 1e-6 (one optimizer step, the same f32 ops).
Each drift cosine of a run is checked to lie farther than COS_MARGIN from
0, where its clamp would flip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.fl.simulator import run_federation  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_round import (BASE, FED_KW, _assert_history_parity,  # noqa: E402
                              _init, jax_synth, one_torch_thread)

COS_MARGIN = 1e-3
# the stats a buffer or the fault layer adds, held exactly
DISCRETE = ("staleness", "applied_valid", "inflight_occupancy",
            "lost_clients", "skipped_nonfinite", "backlog", "gates")


def recorded_runs(cfg, monkeypatch, drain=False, eval_every=2):
    """run_federation of both packages on the same federation and init,
    every round's stats recorded (the simulators' History.log sees them
    all). Returns (jax history, port history, jax stats, port stats)."""
    from repro.core.metrics import History as JaxHistory
    from repro.fl import simulator as jsim
    from repro.fl.simulator import run_federation as jax_run
    from repro.models.small import SMALL_MODELS as JAX_MODELS
    from repro.models.small import make_loss_fn as jax_loss_fn
    from repro_torch.core.metrics import History
    from repro_torch.fl import simulator as tsim
    recs = {"jax": [], "port": []}

    def recording(base, name):
        class Recording(base):
            def log(self, stats, **kw):
                recs[name].append({k: np.asarray(v) for k, v in stats.items()})
                return super().log(stats, **kw)
        return Recording
    monkeypatch.setattr(jsim, "History", recording(JaxHistory, "jax"))
    monkeypatch.setattr(tsim, "History", recording(History, "port"))
    p0 = _init("synth_logreg")
    hj = jax_run(jax_loss_fn(JAX_MODELS["synth_logreg"][1]), p0,
                 JaxFedConfig(**cfg), jax_synth(**FED_KW),
                 eval_every=eval_every, drain_inflight=drain)
    ht = run_federation(make_loss_fn(SMALL_MODELS["synth_logreg"][1]),
                        params_from_jax(jax.tree.map(np.asarray, p0), "cpu"),
                        FedConfig(**cfg), make_synth_federation(**FED_KW),
                        eval_every=eval_every, drain_inflight=drain,
                        device="cpu")
    return hj, ht, recs["jax"], recs["port"]


def assert_stats_equal(jstats, tstats):
    assert len(jstats) == len(tstats)
    for j, t in zip(jstats, tstats):
        assert sorted(j) == sorted(t)
        for k in DISCRETE:
            if k in j:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_depth0_scan_async_is_vmap_spatial():
    """At async_depth 0 scan_async is the synchronous round, bit for bit."""
    fedn = make_synth_federation(**FED_KW)
    p0 = params_from_jax(jax.tree.map(np.asarray, _init("synth_logreg")),
                         "cpu")
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    runs = [run_federation(loss_fn, p0, FedConfig(**BASE, backend=b), fedn,
                           device="cpu")
            for b in ("vmap_spatial", "scan_async")]
    np.testing.assert_array_equal(np.array(runs[0].gates),
                                  np.array(runs[1].gates))
    for k in p0:
        assert torch.equal(runs[0].params[k], runs[1].params[k])
    assert runs[1].state.inflight == ()


# name: (knobs, drain). fifo: every delta lands exactly D rounds late;
# ready with min_lag 2 keeps two slots in flight, one landing a round
ASYNC = {
    "fifo_d2_drain": (dict(async_depth=2, staleness_decay=0.7), True),
    "ready_d3_lag2_momentum": (dict(async_depth=3, async_mode="ready",
                                    min_lag=2, staleness_decay=0.8,
                                    server_opt="momentum", server_lr=0.5),
                               False),
}


@pytest.mark.parametrize("case", sorted(ASYNC))
def test_async_run_matches_reference(case, monkeypatch):
    knobs, drain = ASYNC[case]
    cfg = dict(BASE, backend="scan_async", **knobs)
    hj, ht, jstats, tstats = recorded_runs(cfg, monkeypatch, drain=drain)
    _assert_history_parity(hj, ht, FED_KW["test_samples"])
    assert_stats_equal(jstats, tstats)
    D = knobs["async_depth"]
    lag = D if knobs.get("async_mode", "fifo") == "fifo" else knobs["min_lag"]
    # the pipe fills for `lag` rounds, then one delta lands each round
    assert [int(s["applied_valid"]) for s in tstats] == (
        [0] * lag + [1] * (BASE["rounds"] - lag))
    assert [int(s["staleness"]) for s in tstats[lag:]] == [lag] * (
        BASE["rounds"] - lag)
    valid = ht.state.inflight["valid"]
    if drain:
        assert float(valid.sum()) == 0.0
        np.testing.assert_array_equal(
            valid.numpy(), np.asarray(hj.state.inflight["valid"]))
    else:
        assert float(valid.sum()) == lag


def test_adaptive_staleness_matches_reference(monkeypatch):
    """ready, D = 2, momentum, the drift-measured discount: the first pop
    meets the zero reference (factor 1), later ones the cosine to the last
    landed delta, each > COS_MARGIN from 0."""
    cosines = []
    factor = engine.drift_factor

    def recording(sketch, last):
        n = float(torch.linalg.vector_norm(last))
        if n > 0:
            cosines.append(float(torch.dot(sketch, last))
                           / (float(torch.linalg.vector_norm(sketch)) * n))
        return factor(sketch, last)
    monkeypatch.setattr(engine, "drift_factor", recording)
    cfg = dict(BASE, backend="scan_async", async_depth=2, async_mode="ready",
               min_lag=1, staleness_decay=0.9, adaptive_staleness=True,
               sketch_dim=64, server_opt="momentum", server_lr=0.5)
    hj, ht, jstats, tstats = recorded_runs(cfg, monkeypatch)
    _assert_history_parity(hj, ht, FED_KW["test_samples"])
    assert_stats_equal(jstats, tstats)
    assert len(cosines) == BASE["rounds"] - 2       # pops after the first
    assert all(abs(c) > COS_MARGIN for c in cosines), cosines
    np.testing.assert_allclose(ht.state.last_delta.numpy(),
                               np.asarray(hj.state.last_delta),
                               rtol=1e-4, atol=1e-4 * float(
                                   np.abs(np.asarray(hj.state.last_delta)).max()))


def test_drain_is_a_no_op_on_a_sync_state():
    fed = FedConfig(**BASE)
    p0 = params_from_jax(jax.tree.map(np.asarray, _init("synth_logreg")),
                         "cpu")
    state = engine.init_state(p0, fed, 8)
    assert engine.drain_inflight(fed, state) is state


# ------------------------------------------------------ hand-built buffers
def _buffer(D, rng, valid, age, timer=None):
    deltas = {"b": rng.normal(0, 0.1, (D, 3)).astype(np.float32),
              "w": rng.normal(0, 0.1, (D, 2, 3)).astype(np.float32)}
    buf = {"delta": deltas, "valid": np.asarray(valid, np.float32),
           "age": np.asarray(age, np.int32)}
    if timer is not None:
        buf["timer"] = np.asarray(timer, np.int32)
    return buf


# name: (knobs, valid, age, timer or None, push_timer, (popped slots))
HAND_BUILT = {
    "ready_two_pops": (dict(async_mode="ready", min_lag=2), [1, 1, 1],
                       [2, 1, 0], None, None, (0, 1)),
    "ready_force_pop": (dict(async_mode="ready", min_lag=3), [1, 1, 1],
                        [1, 1, 0], None, None, (0,)),
    "fifo_force_pop": (dict(), [1, 1, 1], [1, 0, 0], None, None, (0,)),
    "fifo_nothing_ready": (dict(), [1, 1, 0], [1, 0, 0], None, None, ()),
    "clocked_no_prefix": (dict(async_mode="ready", latency_mode="lognormal"),
                          [1, 1, 1], [2, 1, 0], [3, 1, 2], 2, (1,)),
    "clocked_two_of_three": (dict(async_mode="ready",
                                  latency_mode="lognormal"),
                             [1, 1, 1], [2, 1, 0], [1, 4, 1], 3, (0, 2)),
    "clocked_force_pop": (dict(async_mode="ready", latency_mode="lognormal"),
                          [1, 1, 1], [2, 1, 0], [3, 3, 3], 1, (0,)),
}


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_async_apply_on_hand_built_buffers(case):
    knobs, valid, age, timer, push_timer, popped = HAND_BUILT[case]
    D = len(valid)
    kw = dict(async_depth=D, staleness_decay=0.8, server_opt="momentum",
              server_lr=0.5, **knobs)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    rng = np.random.default_rng(hash(case) % 2**31)
    params = {"b": rng.normal(0, 1, 3).astype(np.float32),
              "w": rng.normal(0, 1, (2, 3)).astype(np.float32)}
    mom = {"m": {k: rng.normal(0, 0.1, v.shape).astype(np.float32)
                 for k, v in params.items()}}
    buf = _buffer(D, rng, valid, age, timer)
    fresh = {k: rng.normal(0, 0.1, v.shape).astype(np.float32)
             for k, v in params.items()}
    jout = jengine.async_apply(jfed, _as_jax(params), _as_jax(mom),
                               _as_jax(buf), _as_jax(fresh),
                               push_timer=push_timer)
    tbuf = _as_torch(buf)
    tout = engine.async_apply(fed, _as_torch(params), _as_torch(mom), tbuf,
                              _as_torch(fresh), push_timer=push_timer)
    jp, jm, jbuf, _, jinfo = jout
    tp, tm, tb, _, tinfo = tout
    assert int(tinfo["applied_valid"]) == len(popped)
    for k in ("applied_valid", "applied_age"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    for k in ("valid", "age", "timer"):
        if k in jbuf:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jbuf[k]),
                                          err_msg=k)
    # the buffer is updated in place, every leaf: the one passed in is
    # the new one
    assert all(tb[k] is tbuf[k] for k in tbuf) and sorted(tb) == sorted(tbuf)
    n = int(np.asarray(jbuf["valid"]).sum())
    for got, want in zip(tree_leaves(tb["delta"]),
                         jax.tree.leaves(jbuf["delta"])):
        np.testing.assert_array_equal(got[:n].numpy(), np.asarray(want)[:n])
    for got, want in zip(tree_leaves((tp, tm)), jax.tree.leaves((jp, jm))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["clamp", "zero_reference"])
def test_drift_clamp_and_zero_reference(fallback):
    """ready, D = 2, both slots popping, adaptive staleness under momentum:
    slot 0 holds d and slot 1 -d. Against the reference sketch of d, slot
    0 lands (cos 1) and slot 1 is clamped to 0 and dropped: params,
    momentum and the reference stay as slot 0 left them. From a zero
    reference slot 0 lands at factor 1 and becomes the reference, and
    slot 1 is clamped against it."""
    kw = dict(async_depth=2, async_mode="ready", min_lag=1,
              staleness_decay=0.8, adaptive_staleness=True, sketch_dim=16,
              server_opt="momentum", server_lr=0.5)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(0, 1, (4, 5)).astype(np.float32)}
    mom = {"m": {"w": rng.normal(0, 0.1, (4, 5)).astype(np.float32)}}
    d = rng.normal(0, 0.1, (4, 5)).astype(np.float32)
    buf = {"delta": {"w": np.stack([d, -d])},
           "valid": np.ones(2, np.float32), "age": np.array([1, 0], np.int32)}
    last = (np.zeros(16, np.float32) if fallback else np.asarray(
        jengine.delta_sketch({"w": jnp.asarray(d)},
                             jengine.drift_sketch_key(jfed), 16)))
    fresh = {"w": np.zeros((4, 5), np.float32)}
    jp, jm, _, jlast, jinfo = jengine.async_apply(
        jfed, _as_jax(params), _as_jax(mom), _as_jax(buf), _as_jax(fresh),
        last_delta=jnp.asarray(last))
    tp, tm, _, tlast, tinfo = engine.async_apply(
        fed, _as_torch(params), _as_torch(mom), _as_torch(buf),
        _as_torch(fresh), last_delta=torch.from_numpy(last.copy()))
    assert int(tinfo["applied_valid"]) == int(jinfo["applied_valid"]) == 2
    # one landed step: p - lr * (beta m - 0.8^2 d) with beta 0.9
    m1 = 0.9 * mom["m"]["w"] - 0.8 ** 2 * d
    np.testing.assert_allclose(tm["m"]["w"].numpy(), m1, rtol=1e-5,
                               atol=1e-7)
    for got, want in zip(tree_leaves((tp, tm, tlast)),
                         jax.tree.leaves((jp, jm, jlast))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
