"""The training cohort (``max_cohort`` with backlog fairness) in the port
against the JAX package on the CPU.

* ``engine.cohort_select``: cohort indices, cohort gates and effective
  gates exactly equal to the reference's on seeded cases with tied gaps,
  ``inf`` and NaN statistics, live backlogs and boosts, and on the
  reference's own worked examples.
* Engine rounds under ``max_cohort`` with overflow, on both backends and
  under each server optimizer: gates, backlog and adam / yogi's step count
  exactly; params within 1e-4 of each leaf's largest magnitude and the
  global loss at rtol 1e-5 (tests/test_torch_round.py's bounds); the
  first moment, a sum of deltas whose error is the params' error, within
  the params' bound, the second moment within 1e-4 of its largest; the
  utility EMA, an EMA of gaps |F_k - F| between losses that
  agree to rtol 1e-5, within 1e-5 of the largest loss; with error
  feedback, the cohort's rows gathered and scattered back.
* Port against port: a cohort that does not overflow equals the dense
  round (gates and backlog exactly; params and moments within 1e-5 of
  each leaf's largest magnitude: the cohort's rows are summed in another
  order, and three rounds of training carry the difference), and grad_sim ignores ``max_cohort`` (bit for bit)."""
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
from repro_torch.fl import engine  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_round import one_blas_thread  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tensors of a few hundred elements: one torch thread for the module
    (see tests/test_torch_round.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with one_blas_thread():
        yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ cohort_select
def _select_both(gates, align, g, pm, k, backlog=None, boost=0.0):
    j = jengine.cohort_select(
        jnp.asarray(gates, jnp.float32), jnp.asarray(align, jnp.float32),
        jnp.float32(g), jnp.asarray(pm, jnp.float32), k,
        backlog=None if backlog is None else jnp.asarray(backlog, jnp.int32),
        backlog_boost=boost)
    t = engine.cohort_select(
        torch.tensor(gates, dtype=torch.float32),
        torch.tensor(align, dtype=torch.float32),
        torch.tensor(g, dtype=torch.float32),
        torch.tensor(pm, dtype=torch.float32), k,
        backlog=(None if backlog is None
                 else torch.tensor(backlog, dtype=torch.int32)),
        backlog_boost=boost)
    return j, t


def _assert_select_equal(j, t):
    for name, a, b in zip(("cohort_idx", "cohort_gates", "eff_gates"), t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _seeded_case(seed):
    """C in [3, 24]: gates 0 / 1 / fractional, priority clients, align
    values from a few levels (ties are common) with the odd inf and NaN,
    a backlog of small ints, K in [1, C]."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(3, 25))
    gates = rng.choice([0.0, 1.0, 1.0, 0.5], size=C)
    pm = rng.random(C) < 0.25
    align = rng.choice([0.1, 0.2, 0.25, 0.5, 0.7], size=C).astype(np.float32)
    align += np.where(rng.random(C) < 0.3, rng.normal(0, 1e-3, C), 0.0)
    specials = rng.random(C)
    align[specials < 0.08] = np.inf
    align[(specials >= 0.08) & (specials < 0.16)] = np.nan
    align[(specials >= 0.16) & (specials < 0.2)] = -np.inf
    backlog = rng.integers(0, 4, C) * (rng.random(C) < 0.5)
    k = int(rng.integers(1, C + 1))
    return gates, align.astype(np.float32), 0.3, pm, k, backlog


@pytest.mark.parametrize("boost", [0.0, 0.05, 2.0])
@pytest.mark.parametrize("seed", range(12))
def test_cohort_select_matches_reference_on_seeded_cases(seed, boost):
    gates, align, g, pm, k, backlog = _seeded_case(seed)
    _assert_select_equal(*_select_both(gates, align, g, pm, k, backlog,
                                       boost))
    _assert_select_equal(*_select_both(gates, align, g, pm, k, None, boost))


WORKED = {
    # the reference's tests/test_cohort.py examples
    "overflow_drops_worst": ([1] * 6, [0.0, 0.0, 0.9, 0.1, 0.5, 0.3],
                             [1, 1, 0, 0, 0, 0], 4, None, 0.0),
    "padding_zero_gates": ([1, 0, 1, 0], [0.0, 0.1, 0.2, 0.3], [1, 0, 0, 0],
                           4, None, 0.0),
    "backlog_breaks_tie": ([1] * 4, [0.0, 0.2, 0.2, 0.2], [1, 0, 0, 0], 2,
                           [0, 0, 1, 1], 0.0),
    "boost_near_tie": ([1] * 3, [0.0, 0.2, 0.2005], [1, 0, 0], 2,
                       [0, 0, 6], 1e-4),
    "boost_never_displaces_priority": ([1] * 3, [0.5, 0.0, 0.0], [1, 0, 0],
                                       2, [0, 100000, 0], 10.0),
    "nan_gap_sorts_last": ([1] * 5, [0.0, np.nan, 0.3, np.nan, 0.1],
                           [1, 0, 0, 0, 0], 4, [0, 2, 0, 0, 0], 0.0),
    "nan_gap_boosted": ([1] * 5, [0.0, np.nan, 0.3, np.nan, 0.1],
                        [1, 0, 0, 0, 0], 5, [0, 2, 0, 1, 0], 0.5),
    "inf_gap_capped": ([1] * 4, [0.0, np.inf, 1e31, 0.4], [1, 0, 0, 0], 3,
                       [0, 0, 3, 0], 0.0),
}


@pytest.mark.parametrize("case", sorted(WORKED))
def test_cohort_select_worked_cases_match_reference(case):
    gates, align, pm, k, backlog, boost = WORKED[case]
    _assert_select_equal(*_select_both(gates, align, 0.0, pm, k, backlog,
                                       boost))


def test_cohort_select_nan_gap_sorts_last():
    """A NaN gap ranks after every other key, the gated-out padding's inf
    included, in both packages."""
    j, t = _select_both([1, 1, 1, 0], [0.0, np.nan, 0.2, 0.1], 0.0,
                        [1, 0, 0, 0], 4)
    _assert_select_equal(j, t)
    np.testing.assert_array_equal(t[0].numpy(), [0, 2, 3, 1])


# ------------------------------------------------------------ cohort rounds
FED_KW = dict(seed=11, n_priority=3, n_nonpriority=5, samples_per_client=32,
              test_samples=20)
# lr 0.05: at lr 0.1 local SGD on this federation carries f32 rounding
# far enough that the port and the reference part by up to 4.6e-5 in
# params and 3.5e-5 in global loss after 3 rounds (1.9e-5 in params on
# the plain fedalign round too); at 0.05, below 5e-6 under every knob here
BASE = dict(num_clients=8, num_priority=3, rounds=4, local_epochs=2,
            epsilon=0.3, lr=0.05, warmup_frac=0.0, batch_size=8,
            align_stat="loss")


def _init():
    p = JAX_MODELS["synth_logreg"][0](jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return {k: jnp.asarray(rng.normal(0, 0.05, v.shape), jnp.float32)
            for k, v in p.items()}


def _rounds(cfg, rounds=3, ref=True, fedn=None):
    """``rounds`` state-threaded rounds of the port (and of the reference
    with ``ref``) from the same params and keys; returns the final states
    and each round's stats."""
    fedn = fedn or jax_synth(**FED_KW)
    p0 = _init()
    C = cfg["num_clients"]
    tround = engine.make_round_fn(make_loss_fn(SMALL_MODELS["synth_logreg"][1]),
                                  FedConfig(**cfg))
    ts = engine.init_state(params_from_jax(jax.tree.map(np.asarray, p0),
                                           "cpu"), FedConfig(**cfg), C)
    tdata = {"x": torch.from_numpy(fedn.x),
             "y": torch.from_numpy(fedn.y).long()}
    targs = (torch.from_numpy(fedn.priority_mask),
             torch.from_numpy(fedn.weights))
    tstats, jstats, js = [], [], None
    if ref:
        jround = jax.jit(jengine.make_round_fn(
            jax_loss_fn(JAX_MODELS["synth_logreg"][1]), JaxFedConfig(**cfg)))
        js = jengine.init_state(p0, JaxFedConfig(**cfg), C)
        jdata = {"x": jnp.asarray(fedn.x), "y": jnp.asarray(fedn.y)}
        jargs = (jnp.asarray(fedn.priority_mask), jnp.asarray(fedn.weights))
    for r in range(rounds):
        ts, st = tround(ts, tdata, *targs,
                        prng.fold_in(prng.PRNGKey(7), r), r)
        tstats.append(st)
        if ref:
            js, sj = jround(js, jdata, *jargs,
                            jax.random.fold_in(jax.random.PRNGKey(7), r), r)
            jstats.append(sj)
    return ts, tstats, js, jstats


def _assert_parity(ts, tstats, js, jstats):
    for st, sj in zip(tstats, jstats):
        for k in ("gates", "backlog", "included_nonpriority"):
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]),
                                          err_msg=k)
        np.testing.assert_allclose(st["global_loss"].numpy(),
                                   np.asarray(sj["global_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(ts.backlog.numpy(), np.asarray(js.backlog))
    loss_scale = max(float(np.abs(np.asarray(sj["local_losses"])).max())
                     for sj in jstats)
    np.testing.assert_allclose(ts.util_ema.numpy(), np.asarray(js.util_ema),
                               rtol=0, atol=1e-5 * loss_scale)
    np.testing.assert_allclose(ts.incl_ema.numpy(), np.asarray(js.incl_ema),
                               rtol=1e-5, atol=1e-7)
    for k in ts.params:
        want = np.asarray(js.params[k])
        np.testing.assert_allclose(ts.params[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    opt = ts.opt_state
    assert len(tree_leaves(opt)) == len(jax.tree.leaves(js.opt_state))
    if "t" in opt:
        assert int(opt["t"]) == int(js.opt_state["t"])
    for name in ("m", "v"):
        for k in opt.get(name, {}) if opt else {}:
            want = np.asarray(js.opt_state[name][k])
            # m is in the deltas' units, whose error is the params' error:
            # the params' bound; v (squared deltas) relative to its own
            scale = (np.abs(np.asarray(js.params[k])).max() if name == "m"
                     else np.abs(want).max())
            np.testing.assert_allclose(opt[name][k].numpy(), want, rtol=0,
                                       atol=1e-4 * scale, err_msg=name + k)


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
@pytest.mark.parametrize("server_opt", ["sgd", "momentum", "adam", "yogi"])
def test_cohort_rounds_match_reference(server_opt, backend):
    """K = 4 of 8 clients (3 priority), eps admitting more than one
    non-priority client: overflow every round, a backlog that grows and
    resets, and boosted ranks."""
    cfg = dict(BASE, max_cohort=4, backlog_boost=0.05, server_opt=server_opt,
               backend=backend, server_lr=0.5)
    ts, tstats, js, jstats = _rounds(cfg)
    assert any(int(s["backlog"].max()) > 0 for s in tstats)     # overflow
    _assert_parity(ts, tstats, js, jstats)
    if server_opt in ("adam", "yogi"):
        assert int(ts.opt_state["t"]) == 3


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
def test_cohort_rounds_with_padding_and_topk_align_match_reference(backend):
    """K larger than the included set (zero-gate padding slots), under
    topk_align, participation sampling and the straggler cadence."""
    cfg = dict(BASE, max_cohort=6, selection="topk_align", topk=2,
               participation=0.7, straggler_period=3, backend=backend)
    _assert_parity(*_rounds(cfg))


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
def test_cohort_rounds_with_error_feedback_match_reference(backend):
    """int8 + error feedback under overflow: only the cohort's rows
    advance, gathered and scattered back."""
    cfg = dict(BASE, max_cohort=4, wire_codec="int8", backend=backend)
    ts, tstats, js, jstats = _rounds(cfg)
    _assert_parity(ts, tstats, js, jstats)
    for a, b in zip(tree_leaves(ts.ef_accum), jax.tree.leaves(js.ef_accum)):
        b = np.asarray(b)
        # a last-bit difference of a delta can cross an int8 rounding
        # boundary: one quantum of the row's scale (tests/test_torch_codecs.py)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2 * np.abs(b).max() / 127 + 1e-7)


def _assert_same_rounds(a, b, rel=0.0):
    (sa, ta, _, _), (sb, tb, _, _) = a, b
    for x, y in zip(ta, tb):
        assert torch.equal(x["gates"], y["gates"])
        assert torch.equal(x["backlog"], y["backlog"])
    for x, y in zip(tree_leaves(sa.params) + tree_leaves(sa.opt_state),
                    tree_leaves(sb.params) + tree_leaves(sb.opt_state)):
        if rel == 0.0 or not x.is_floating_point():
            assert torch.equal(x, y)
        else:
            np.testing.assert_allclose(
                x.numpy(), y.numpy(), rtol=0,
                atol=rel * float(y.abs().max()))


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
def test_cohort_without_overflow_equals_dense_round(backend):
    cfg = dict(BASE, backend=backend, server_opt="adam", server_lr=0.5)
    _assert_same_rounds(_rounds(cfg, ref=False),
                        _rounds(dict(cfg, max_cohort=8), ref=False), rel=1e-5)


@pytest.mark.parametrize("sketch", [False, True], ids=["exact", "sketch"])
def test_grad_sim_ignores_max_cohort(sketch):
    cfg = dict(BASE, selection="grad_sim", grad_sim_sketch=sketch,
               sketch_dim=16)
    _assert_same_rounds(_rounds(cfg, ref=False),
                        _rounds(dict(cfg, max_cohort=2), ref=False))
