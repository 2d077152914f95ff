"""The port's optimizers and server optimizers against the JAX package on
the CPU, and the zero-mass round's skip of the server step.

* ``repro_torch.optim.optimizers`` (sgd with and without momentum and
  nesterov, adam, yogi, adamw): a few steps on the same f32 params and
  gradients, params and moments within rel 1e-6 of the largest magnitude
  (the same f32 operations in the same order; ``pow`` may differ in its
  last bit), adam's / yogi's step count ``t`` exactly.
* ``core.aggregation.apply_server_opt`` under each server optimizer, the
  aggregated delta entering as the pseudo-gradient, at the same bound.
* A round with zero inclusion mass leaves params and every server moment
  (adam's ``t`` too) bit-identical, in ``engine.make_round_fn`` on both
  backends and in ``sharded.make_spatial_round``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.data.tokens import make_token_federation  # noqa: E402
from repro_torch.fl import engine, sharded  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

REL = 1e-6
SHAPES = {"b": (7,), "w": (5, 3), "z": (2, 2, 4)}
from test_torch_round import one_blas_thread  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors and smoke-size LM rounds: one torch thread for the
    module (see tests/test_torch_train.py; with several test workers a
    pool per worker oversubscribes the host's cores), the previous count
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with one_blas_thread():
        yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), tree)


def _assert_tree_close(got, want, rel=REL):
    """Leaf by leaf (sorted keys on both sides), within rel of the leaf's
    largest magnitude; integer leaves (``t``) exactly."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=rel * max(float(np.abs(b).max()), 1e-30))


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(), 0.1),
    "sgd_momentum": (lambda m: m.sgd(momentum=0.9), 0.1),
    "sgd_nesterov": (lambda m: m.sgd(momentum=0.8, nesterov=True), 0.1),
    "adam": (lambda m: m.adam(), 0.01),
    "adam_fed": (lambda m: m.adam(0.9, 0.99, 1e-3), 1.0),
    "yogi": (lambda m: m.yogi(), 0.01),
    "yogi_fed": (lambda m: m.yogi(0.9, 0.99, 1e-3), 1.0),
    "adamw": (lambda m: m.adamw(weight_decay=0.05), 0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    make, lr = OPTIMIZERS[name]
    jo, to = make(jopt), make(topt)
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), _to_torch(p0)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        # the gradients' scale changes, so yogi's sign(v - g^2) takes both
        # signs across the steps
        g = _tree(rng, scale=[1.0, 0.1, 3.0, 0.5][step])
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        tp, ts = to.update(_to_torch(g), ts, tp, lr)
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts, js)
    if "adam" in name or "yogi" in name:
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 4


@pytest.mark.parametrize("server_opt", ["sgd", "momentum", "adam", "yogi"])
def test_apply_server_opt_matches_reference(server_opt):
    kw = dict(server_opt=server_opt, server_lr=0.5, server_momentum=0.7,
              server_b1=0.8, server_b2=0.95, server_eps=1e-3)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    rng = np.random.default_rng(5)
    p0 = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), _to_torch(p0)
    js = jagg.server_optimizer(jfed).init(jp)
    ts = tagg.server_optimizer(fed).init(tp)
    for _ in range(3):
        d = _tree(rng, scale=0.1)
        jp, js = jagg.apply_server_opt(jfed, jp, js,
                                       jax.tree.map(jnp.asarray, d))
        tp, ts = tagg.apply_server_opt(fed, tp, ts, _to_torch(d))
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts, js)


def test_unknown_server_opt_raises_value_error():
    with pytest.raises(ValueError, match="unknown server optimizer"):
        engine.init_state({"w": torch.zeros(2)},
                          FedConfig(server_opt="lamb"), 2)


def _bits(tree):
    return [x.clone() for x in tree_leaves(tree)]


def _assert_bits_equal(before, tree):
    after = tree_leaves(tree)
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
@pytest.mark.parametrize("server_opt", ["momentum", "adam", "yogi"])
def test_zero_mass_engine_round_keeps_params_and_moments(server_opt,
                                                         backend):
    """Round 0 moves params and moments; round 1 has every client weight 0
    (zero inclusion mass): params, m, v and t stay bit-identical."""
    fedn = make_synth_federation(seed=2, n_priority=2, n_nonpriority=2,
                                 samples_per_client=16, test_samples=20)
    init_fn, apply_fn = SMALL_MODELS["synth_logreg"]
    fed = FedConfig(num_clients=4, num_priority=2, rounds=2, local_epochs=1,
                    batch_size=8, epsilon=0.5, warmup_frac=0.0,
                    server_opt=server_opt, backend=backend)
    rnd = engine.make_round_fn(make_loss_fn(apply_fn), fed)
    state = engine.init_state(init_fn(0, "cpu"), fed, 4)
    data = {"x": torch.from_numpy(fedn.x), "y": torch.from_numpy(fedn.y).long()}
    pm = torch.from_numpy(fedn.priority_mask)
    w = torch.from_numpy(fedn.weights)
    state, _ = rnd(state, data, pm, w, prng.PRNGKey(0), 0)
    assert len(tree_leaves(state.opt_state)) > 0
    params, moments = _bits(state.params), _bits(state.opt_state)
    state, stats = rnd(state, data, pm, torch.zeros_like(w),
                       prng.PRNGKey(1), 1)
    assert float(stats["gates"].sum()) > 0      # gated in, but no mass
    _assert_bits_equal(params, state.params)
    _assert_bits_equal(moments, state.opt_state)
    if server_opt != "momentum":
        assert int(state.opt_state["t"]) == 1


@pytest.mark.parametrize("server_opt", ["momentum", "adam", "yogi"])
def test_zero_mass_lm_round_keeps_params_and_moments(server_opt):
    """The spatial LM round at smoke size: a round with all weights 0
    after a round with mass keeps params and moments bit-identical."""
    cfg = get_smoke("qwen1.5-0.5b")
    model = get_model(cfg)
    fed = FedConfig(num_clients=2, num_priority=1, local_epochs=1,
                    epsilon=0.5, lr=0.05, server_opt=server_opt,
                    server_lr=0.01)
    fed_data = make_token_federation(seed=0, vocab=cfg.vocab_size,
                                     n_clients=2, n_priority=1, seq_len=16,
                                     misalign_max=1.0, tokens_per_client=8192)
    step = sharded.make_round_step(model, fed, 2, fsdp=False, device="cpu")
    state = engine.init_state(model.init(prng.PRNGKey(0), device="cpu"),
                              fed, 2)
    rng = np.random.default_rng(0)
    batch = build_batches(cfg, fed_data, clients=2, per_client=1, seq=16,
                          rng=rng, device="cpu")
    state, _ = step(state, batch, 0)
    params, moments = _bits(state.params), _bits(state.opt_state)
    batch = dict(batch, weights=torch.zeros_like(batch["weights"]))
    state, stats = step(state, batch, 1)
    assert float(stats["gates"].sum()) > 0
    _assert_bits_equal(params, state.params)
    _assert_bits_equal(moments, state.opt_state)
    if server_opt != "momentum":
        assert int(state.opt_state["t"]) == 1
