"""The spatial LM round under the selection knobs: the port's
``sharded.make_round_step`` on the CPU against the JAX package's, 3 rounds
at smoke size in f32 (qwen1.5-0.5b, 4 clients, 2 sequences of 64 tokens,
E = 2), on the batches ``launch.train.run`` draws.

* ``max_cohort=2`` with adam and a backlog boost (2 priority clients,
  eps admitting every client: overflow each round), ``max_cohort=3``
  with yogi and a boost, and under median + int8 with error feedback:
  gates, backlog and adam's / yogi's ``t`` exactly; the client stack has
  K rows and only the K cohort clients train.
* ``grad_sim`` exact and on CountSketches, ``topk_align`` and ``welfare``
  under momentum: gates and backlog exactly.

Losses and params at tests/test_torch_train.py's tolerances (PARITY of
the largest magnitude; under int8 one more quantum of the run's largest
row scale); the moments in the deltas' units (the first moment, the
square root of the second), whose error is the params', within the
params' bound. Every gate decision, and every rank a cohort or
topk_align orders, is checked to lie farther than GATE_MARGIN from its
threshold or its neighbour in the port's run, so that exact equality is
meaningful."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data.tokens import make_token_federation  # noqa: E402
from repro_torch.fl import engine, sharded  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_train import PARITY  # noqa: E402

GATE_MARGIN = 1e-3
RUN = dict(rounds=3, clients=4, per_client=2, seq=64, local_epochs=2,
           lr=0.05)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fed_kw(n_priority, eps, fed_kw):
    return dict(num_clients=RUN["clients"], num_priority=n_priority,
                local_epochs=RUN["local_epochs"], epsilon=eps, lr=RUN["lr"],
                **fed_kw)


def _jax_rounds(n_priority, eps, fed_kw):
    from repro.data.tokens import make_token_federation as jax_tokens
    from repro.fl import engine as jengine, sharded as jsharded
    from repro.launch.train import build_batches as jax_batches
    cfg = jax_get_smoke("qwen1.5-0.5b")
    model = jax_get_model(cfg)
    fed = JaxFedConfig(**_fed_kw(n_priority, eps, fed_kw))
    data = jax_tokens(seed=0, vocab=cfg.vocab_size, n_clients=RUN["clients"],
                      n_priority=n_priority, seq_len=RUN["seq"],
                      misalign_max=1.0, tokens_per_client=8192)
    step = jax.jit(jsharded.make_round_step(model, fed, RUN["clients"],
                                            fsdp=False))
    state = jengine.init_state(model.init(jax.random.PRNGKey(0)), fed,
                               RUN["clients"])
    rng = np.random.default_rng(0)
    stats = []
    for r in range(RUN["rounds"]):
        batch = jax_batches(cfg, data, clients=RUN["clients"],
                            per_client=RUN["per_client"], seq=RUN["seq"],
                            rng=rng)
        state, st = step(state, batch, jnp.int32(r))
        stats.append({k: np.asarray(v) for k, v in st.items()})
    return state, stats


def _port_rounds(n_priority, eps, fed_kw):
    cfg = get_smoke("qwen1.5-0.5b")
    model = get_model(cfg)
    fed = FedConfig(**_fed_kw(n_priority, eps, fed_kw))
    data = make_token_federation(seed=0, vocab=cfg.vocab_size,
                                 n_clients=RUN["clients"],
                                 n_priority=n_priority, seq_len=RUN["seq"],
                                 misalign_max=1.0, tokens_per_client=8192)
    step = sharded.make_round_step(model, fed, RUN["clients"], fsdp=False,
                                   device="cpu")
    state = engine.init_state(model.init(prng.PRNGKey(0), device="cpu"),
                              fed, RUN["clients"])
    rng = np.random.default_rng(0)
    stats = []
    for r in range(RUN["rounds"]):
        batch = build_batches(cfg, data, clients=RUN["clients"],
                              per_client=RUN["per_client"], seq=RUN["seq"],
                              rng=rng, device="cpu")
        state, st = step(state, batch, r)
        stats.append({k: v.numpy() for k, v in st.items()})
    return state, stats


def _close(got, want, scale, tol=PARITY):
    assert float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= tol * scale


def _assert_margins(stats, eps, n_priority, fed_kw):
    """Gate decisions in the port's run lie farther than GATE_MARGIN from
    eps, and the ranks a cohort or topk_align orders (the gaps, less the
    boost times the backlog going into the round) from each other."""
    backlog = np.zeros_like(stats[0]["backlog"])
    boost = fed_kw.get("backlog_boost", 0.0)
    for st in stats:
        gaps = np.abs(st["local_losses"] - st["server_loss"])[n_priority:]
        if fed_kw.get("selection", "fedalign") in ("fedalign", "topk_align"):
            assert np.all(np.abs(gaps - eps) > GATE_MARGIN), gaps
        if fed_kw.get("max_cohort", 0) or fed_kw.get("selection") == "topk_align":
            ranks = np.sort(gaps - boost * backlog[n_priority:])
            assert np.all(np.diff(ranks) > GATE_MARGIN), ranks
        backlog = st["backlog"]


def _assert_parity(tstate, tstats, jstate, jstats, extra_atol=0.0):
    for t, j in zip(tstats, jstats):
        np.testing.assert_array_equal(t["gates"], j["gates"])
        np.testing.assert_array_equal(t["backlog"], j["backlog"])
        _close(t["server_loss"], j["server_loss"],
               max(1.0, abs(float(j["server_loss"]))))
        _close(t["local_losses"], j["local_losses"],
               max(1.0, float(np.abs(j["local_losses"]).max())))
    np.testing.assert_array_equal(tstate.backlog.numpy(),
                                  np.asarray(jstate.backlog))
    jp = jax.tree.leaves(jstate.params)
    scales = [max(1.0, float(np.abs(np.asarray(w)).max())) for w in jp]
    for got, want, s in zip(tree_leaves(tstate.params), jp, scales):
        assert (float(np.abs(got.numpy() - np.asarray(want)).max())
                <= PARITY * s + extra_atol)
    opt, jopt = tstate.opt_state, jstate.opt_state
    assert len(tree_leaves(opt)) == len(jax.tree.leaves(jopt))
    if "t" in opt:
        assert int(opt["t"]) == int(jopt["t"])
    for name in ("m", "v"):
        if name not in opt:
            continue
        for got, want, s in zip(tree_leaves(opt[name]),
                                jax.tree.leaves(jopt[name]), scales):
            got, want = got.numpy(), np.asarray(want)
            if name == "v":
                got, want = np.sqrt(got), np.sqrt(want)
            assert float(np.abs(got - want).max()) <= PARITY * s + extra_atol


class _Spy:
    """Counts the LM round's local trainings and the client rows each
    aggregation receives."""

    def __init__(self, monkeypatch):
        self.trained, self.rows = 0, []
        train_steps, server_delta = sharded._train_steps, engine.server_delta

        def counting_train(*a, **k):
            self.trained += 1
            return train_steps(*a, **k)

        def recording_delta(fed, gp, cp, w, g, **k):
            self.rows.append((tree_leaves(cp)[0].shape[0], w.shape[0],
                              g.shape[0]))
            return server_delta(fed, gp, cp, w, g, **k)
        monkeypatch.setattr(sharded, "_train_steps", counting_train)
        monkeypatch.setattr(engine, "server_delta", recording_delta)


# (priority clients, eps, knobs): eps admits every client, so each round
# overflows; K = 2 keeps the two priority clients, K = 3 ranks the two
# non-priority ones (boosted by their backlog) for the third slot
COHORT = {
    "k2_adam_boost": (2, 10.0, dict(max_cohort=2, server_opt="adam",
                                   server_lr=0.01, backlog_boost=0.05)),
    "k3_yogi_boost": (2, 10.0, dict(max_cohort=3, server_opt="yogi",
                                   server_lr=0.01, backlog_boost=0.2)),
    # sgd: under adam or yogi a one-quantum difference of the int8 wire
    # would reach the params scaled by server_lr / server_eps
    "k3_median_int8": (2, 10.0, dict(max_cohort=3, aggregator="median",
                                     wire_codec="int8")),
}


@pytest.mark.parametrize("case", sorted(COHORT))
def test_cohort_lm_round_matches_reference(case, monkeypatch):
    n_priority, eps, fed_kw = COHORT[case]
    K = fed_kw["max_cohort"]
    scales = []
    if fed_kw.get("wire_codec") == "int8":
        from repro_torch.core import aggregation as tagg
        encode = tagg._Int8Codec.encode

        def recording_encode(fed, buf):
            q, kw = encode(fed, buf)
            scales.append(float(kw["dequant_scale"].max()))
            return q, kw
        monkeypatch.setattr(tagg._Int8Codec, "encode",
                            staticmethod(recording_encode))
    spy = _Spy(monkeypatch)
    tstate, tstats = _port_rounds(n_priority, eps, fed_kw)
    assert spy.rows == [(K, K, K)] * RUN["rounds"]
    assert spy.trained == K * RUN["rounds"]
    # eps admits every client: more gate in than K, so the cohort overflows
    assert all(st["gates"].sum() == K for st in tstats)
    assert int(tstats[0]["backlog"].max()) > 0
    _assert_margins(tstats, eps, n_priority, fed_kw)
    jstate, jstats = _jax_rounds(n_priority, eps, fed_kw)
    _assert_parity(tstate, tstats, jstate, jstats,
                   extra_atol=max(scales) if scales else 0.0)
    if "t" in tstate.opt_state:
        assert int(tstate.opt_state["t"]) == RUN["rounds"]


STRATEGIES = {
    "grad_sim": (2, 0.15, dict(selection="grad_sim", sim_threshold=0.0)),
    "grad_sim_sketch": (2, 0.15, dict(selection="grad_sim",
                                      sim_threshold=0.0, grad_sim_sketch=True,
                                      sketch_dim=64)),
    "topk_align_momentum": (2, 0.5, dict(selection="topk_align", topk=1,
                                         server_opt="momentum",
                                         server_lr=0.5)),
    "welfare": (2, 0.15, dict(selection="welfare", welfare_floor=0.2,
                              utility_ema=0.5)),
}


@pytest.mark.parametrize("case", sorted(STRATEGIES))
def test_strategy_lm_round_matches_reference(case, monkeypatch):
    n_priority, eps, fed_kw = STRATEGIES[case]
    spy = _Spy(monkeypatch)
    tstate, tstats = _port_rounds(n_priority, eps, fed_kw)
    assert spy.trained == RUN["clients"] * RUN["rounds"]
    _assert_margins(tstats, eps, n_priority, fed_kw)
    jstate, jstats = _jax_rounds(n_priority, eps, fed_kw)
    _assert_parity(tstate, tstats, jstate, jstats)


def test_grad_sim_lm_round_ignores_max_cohort(monkeypatch):
    kw = STRATEGIES["grad_sim"]
    a_state, a_stats = _port_rounds(*kw)
    spy = _Spy(monkeypatch)
    b_state, b_stats = _port_rounds(kw[0], kw[1], dict(kw[2], max_cohort=2))
    assert spy.rows[0][0] == RUN["clients"]
    for a, b in zip(a_stats, b_stats):
        np.testing.assert_array_equal(a["gates"], b["gates"])
    for x, y in zip(tree_leaves(a_state.params), tree_leaves(b_state.params)):
        assert torch.equal(x, y)
