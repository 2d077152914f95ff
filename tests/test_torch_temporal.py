"""The temporal (streamed-client) LM round of the port against the JAX
package's ``repro.fl.sharded.make_temporal_round`` on the CPU, at the
smoke qwen1.5-0.5b of tests/test_sharded.py (f32, 4 clients of which 2
priority, 2 sequences of 32 tokens, E = 2, lr 0.05), 2 rounds on the
batches ``launch.train.build_batches`` draws: the gated mean stream with
eps open and eps tight (FedAvgM, so the server moments are held too),
``max_cohort`` (unread: the same round, bit for bit), a zero-mass round,
the reference's two ``ValueError``s, ``needs_fsdp`` and
``make_round_step(fsdp=True)``; and the port's temporal round against its
spatial round on the smoke jamba. The robust gather, dp, the int8 wire
and grad_sim: tests/test_torch_temporal_agg.py.

Tolerances: gates and backlog exactly, after checking every gate decision
lies farther than GATE_MARGIN from eps in the port's run; losses within
1e-5 relative; params, the server moments and the EMAs within atol = rtol
= 5e-5 (tests/test_sharded.py's between the reference's two rounds: E = 2
SGD steps of f32 gradients that agree to ~2e-6 relative, and the running
sum against the mean in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data.tokens import make_token_federation  # noqa: E402
from repro_torch.fl import engine, sharded  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

C, B, S, ROUNDS = 4, 2, 32, 2
BASE = dict(local_epochs=2, lr=0.05)
TOL = dict(atol=5e-5, rtol=5e-5)
LOSS_RTOL = 1e-5
GATE_MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_rounds(fed_kw, rounds=ROUNDS, arch="qwen1_5_0_5b", fsdp=True):
    """The reference's temporal round (``fsdp=False``: its spatial round),
    jitted, as tests/test_sharded.py builds it (its smoke config and
    batches)."""
    from repro.data.tokens import make_token_federation as jax_tokens
    from repro.fl import engine as jengine, sharded as jsharded
    from repro.launch.train import build_batches as jax_batches
    cfg = jax_get_smoke(arch).replace(remat=False)
    model = jax_get_model(cfg)
    fed = JaxFedConfig(**BASE, **fed_kw)
    data = jax_tokens(seed=0, vocab=cfg.vocab_size, n_clients=C, n_priority=2,
                      seq_len=S, tokens_per_client=(S + 1) * 8)
    step = jax.jit(jsharded.make_round_step(model, fed, C, fsdp=fsdp))
    state = jengine.init_state(model.init(jax.random.PRNGKey(0)), fed, C)
    rng = np.random.default_rng(0)
    stats = []
    for r in range(rounds):
        batch = jax_batches(cfg, data, clients=C, per_client=B, seq=S, rng=rng)
        state, st = step(state, batch, jnp.int32(r))
        stats.append({k: np.asarray(v) for k, v in st.items()})
    return state, stats


def port_batches(cfg, rounds=ROUNDS):
    data = make_token_federation(seed=0, vocab=cfg.vocab_size, n_clients=C,
                                 n_priority=2, seq_len=S,
                                 tokens_per_client=(S + 1) * 8)
    rng = np.random.default_rng(0)
    return [build_batches(cfg, data, clients=C, per_client=B, seq=S, rng=rng,
                          device="cpu") for _ in range(rounds)]


def port_rounds(fed_kw, rounds=ROUNDS, fsdp=True, arch="qwen1_5_0_5b",
                batches=None):
    cfg = get_smoke(arch)
    model = get_model(cfg)
    fed = FedConfig(**BASE, **fed_kw)
    step = sharded.make_round_step(model, fed, C, fsdp=fsdp, device="cpu")
    state = engine.init_state(model.init(prng.PRNGKey(0), device="cpu"), fed,
                              C)
    stats = []
    for r, batch in enumerate(batches or port_batches(cfg, rounds)):
        state, st = step(state, batch, r)
        stats.append({k: v.numpy() for k, v in st.items()})
    return state, stats


def assert_margins(stats, eps):
    for st in stats:
        gaps = np.abs(st["local_losses"] - st["server_loss"])[2:]
        assert np.all(np.abs(gaps - eps) > GATE_MARGIN), (gaps, eps)


def assert_state_parity(tstate, tstats, jstate, jstats, extra_atol=0.0):
    """Gates and backlog exactly, losses, then every float leaf of the
    state: params, the server moments, the EMAs and the error-feedback
    rows."""
    assert len(tstats) == len(jstats)
    for t, j in zip(tstats, jstats):
        assert set(t) == set(j)
        np.testing.assert_array_equal(t["gates"], j["gates"])
        np.testing.assert_array_equal(t["backlog"], j["backlog"])
        np.testing.assert_allclose(t["server_loss"], j["server_loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["local_losses"], j["local_losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["theta_round"], j["theta_round"],
                                   rtol=LOSS_RTOL)
    np.testing.assert_array_equal(tstate.backlog.numpy(),
                                  np.asarray(jstate.backlog))
    for name in ("params", "opt_state", "util_ema", "incl_ema", "ef_accum"):
        got = tree_leaves(getattr(tstate, name))
        want = jax.tree.leaves(getattr(jstate, name))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=TOL["atol"] + extra_atol,
                                       rtol=TOL["rtol"])


# name: (FedConfig knobs, eps). eps 0.1 gates client 2 in and client 3 out
# in round 0 and both out in round 1 (every decision > 0.02 from eps)
MEAN = {
    "eps_open": dict(epsilon=1e9),
    "eps_tight_momentum": dict(epsilon=0.1, server_opt="momentum",
                               server_lr=0.5),
}


@pytest.mark.parametrize("case", sorted(MEAN))
def test_mean_stream_matches_reference(case, monkeypatch):
    fed_kw = MEAN[case]
    calls = {"fedagg": 0, "trained": 0}
    server_delta, train_steps = engine.server_delta, sharded._train_steps

    def counting_delta(*a, **k):
        calls["fedagg"] += 1
        return server_delta(*a, **k)

    def counting_train(*a, **k):
        calls["trained"] += 1
        return train_steps(*a, **k)
    monkeypatch.setattr(engine, "server_delta", counting_delta)
    monkeypatch.setattr(sharded, "_train_steps", counting_train)
    tstate, tstats = port_rounds(fed_kw)
    if fed_kw["epsilon"] < 1e3:
        assert_margins(tstats, fed_kw["epsilon"])
        assert 0 < sum(st["gates"][2:].sum() for st in tstats) < 2 * ROUNDS
    # the mean stream reaches no fedagg and trains only the gated-in clients
    assert calls["fedagg"] == 0
    assert calls["trained"] == sum(int(st["gates"].sum()) for st in tstats)
    jstate, jstats = jax_rounds(fed_kw)
    assert_state_parity(tstate, tstats, jstate, jstats)


def _bits(tree):
    return [t.numpy().tobytes() for t in tree_leaves(tree)]


def test_max_cohort_is_not_read():
    """The reference's temporal round never reads max_cohort: the port's
    round with a cohort of 2 is the round without one, bit for bit."""
    kw = MEAN["eps_tight_momentum"]
    a_state, a_stats = port_rounds(kw)
    b_state, b_stats = port_rounds(dict(kw, max_cohort=2))
    for a, b in zip(a_stats, b_stats):
        np.testing.assert_array_equal(a["gates"], b["gates"])
        np.testing.assert_array_equal(a["backlog"], b["backlog"])
    assert _bits(a_state.params) == _bits(b_state.params)
    assert _bits(a_state.opt_state) == _bits(b_state.opt_state)


def test_zero_mass_round_keeps_params_and_moments_bit_identical():
    """Round 0 moves params and the momentum; round 1 has every client
    weight 0: params and moments stay bit-identical, and the streamed
    delta is an exact zero."""
    cfg = get_smoke("qwen1_5_0_5b")
    batches = port_batches(cfg)
    batches[1] = dict(batches[1], weights=torch.zeros_like(batches[1]["weights"]))
    fed_kw = dict(epsilon=1e9, server_opt="momentum", server_lr=0.5)
    state0, _ = port_rounds(fed_kw, rounds=1, batches=batches[:1])
    state1, stats = port_rounds(fed_kw, batches=batches)
    assert float(stats[1]["gates"].sum()) == C        # gated in, no mass
    assert _bits(state0.params) == _bits(state1.params)
    assert _bits(state0.opt_state) == _bits(state1.opt_state)
    assert _bits(state0.params) != _bits(
        engine.init_state(get_model(cfg).init(prng.PRNGKey(0), device="cpu"),
                          FedConfig(**BASE, **fed_kw), C).params)


def test_value_errors_of_the_reference():
    model = get_model(get_smoke("qwen1_5_0_5b"))
    with pytest.raises(ValueError, match="grad_sim_sketch=True"):
        sharded.make_temporal_round(model, FedConfig(selection="grad_sim"), C,
                                    device="cpu")
    with pytest.raises(ValueError, match="corrupt_rate"):
        sharded.make_temporal_round(
            model, FedConfig(failure_model="corrupt", corrupt_rate=0.1), C,
            device="cpu")
    # the spatial round scores exact cosines, and corrupts the trained
    # rows it holds (tests/test_torch_async_lm.py runs it)
    assert callable(sharded.make_round_step(
        model, FedConfig(selection="grad_sim"), C, fsdp=False, device="cpu"))
    assert callable(sharded.make_round_step(
        model, FedConfig(failure_model="corrupt", corrupt_rate=0.1), C,
        fsdp=False, device="cpu"))


def test_needs_fsdp_picks_jamba():
    from repro.fl import sharded as jsharded
    assert sharded.FSDP_ARCHS == jsharded.FSDP_ARCHS
    assert sharded.needs_fsdp(get_config("jamba-1.5-large-398b"))
    assert not sharded.needs_fsdp(get_config("qwen2.5-3b"))
    assert not sharded.needs_fsdp(get_smoke("qwen1.5-0.5b"))


def test_temporal_round_needs_a_card_unless_asked_for_the_cpu():
    model = get_model(get_smoke("qwen1_5_0_5b"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded.make_temporal_round(model, FedConfig(), C)


def test_jamba_temporal_round_matches_spatial_round():
    """The smoke jamba (attention + 7 Mamba mixers, MoE) trained through
    both rounds of the port: gates exactly, params within TOL; the
    temporal round trains only its gated-in clients."""
    kw = dict(epsilon=0.1)
    batches = port_batches(get_smoke("jamba_1_5_large_398b"))
    t_state, t_stats = port_rounds(kw, fsdp=True, arch="jamba_1_5_large_398b",
                                   batches=batches)
    s_state, s_stats = port_rounds(kw, fsdp=False,
                                   arch="jamba_1_5_large_398b",
                                   batches=batches)
    assert_margins(s_stats, kw["epsilon"])
    assert 0 < sum(st["gates"][2:].sum() for st in s_stats) < 2 * ROUNDS
    for t, s in zip(t_stats, s_stats):
        np.testing.assert_array_equal(t["gates"], s["gates"])
        np.testing.assert_allclose(t["local_losses"], s["local_losses"],
                                   rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves(t_state.params), tree_leaves(s_state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
