"""The FedALIGN round end to end: the port's make_round_fn and
run_federation against the JAX package on a shortened quickstart config
(C=8, 4 priority, 40 samples per client, E=2, batch 8, 6 rounds), both
backends, with the reference's initial weights carried across.

Tolerances: gates and included counts are exact (the PRNG chain and the
minibatch order are bit-exact, and the accuracies they are computed from
are exact counts over the same examples); the global loss per round at
rtol 1e-5 and the final params within 1e-4 * max|p| (f32 on both sides,
only the order of sums differs, and 6 rounds of SGD carry it along); the
test accuracy within one test example, 1 / n_test."""
import functools
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.data.synth import Federation as JaxFederation  # noqa: E402
from repro.data.synth import make_synth_federation as reference_synth  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl.simulator import run_federation as jax_run  # noqa: E402
from repro.models.small import SMALL_MODELS as JAX_MODELS  # noqa: E402
from repro.models.small import make_loss_fn as jax_loss_fn  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.data.synth import Federation  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.fl.simulator import run_federation  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402

BASE = dict(num_clients=8, num_priority=4, rounds=6, local_epochs=2,
            epsilon=0.2, lr=0.1, warmup_frac=0.1, batch_size=8)
FED_KW = dict(seed=0, n_priority=4, n_nonpriority=4, samples_per_client=40,
              test_samples=200)


try:
    from threadpoolctl import threadpool_limits
except ImportError:                  # the limit only saves time
    threadpool_limits = None


def one_blas_thread():
    """numpy's BLAS at one thread while the block runs. SYNTH draws each
    client's inputs through ``multivariate_normal`` (an SVD of a 60 x 60
    matrix); at the BLAS's default of a thread a core, beside the other
    test workers, those SVDs crawl (the quickstart federation: 12 s with
    every core busy, 0.12 s at one thread). The data are the same bits at
    any thread count."""
    return (threadpool_limits(1, user_api="blas") if threadpool_limits
            else nullcontext())


@functools.lru_cache(maxsize=None)
def jax_synth(**kw):
    """The reference's SYNTH federation, built once a process for each set
    of arguments: its per-client SVDs take seconds, and crawl beside other
    test workers. Shared by the modules that import it (the round, async,
    failure and aggregator tests); its arrays are only read."""
    return reference_synth(**kw)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These rounds work on tensors of a few hundred elements, where torch's
    intra-op thread pool costs more than it saves (4-5x here, more with
    several test workers on the host's cores): one thread for the module,
    the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with one_blas_thread():
        yield
    torch.set_num_threads(n)


def _init(model, seed=42):
    """The reference's init; the zero-init logreg gets small random weights
    so round 0 does not start from all-tied logits."""
    p = JAX_MODELS[model][0](jax.random.PRNGKey(seed))
    if model in ("logreg", "synth_logreg"):
        rng = np.random.default_rng(seed)
        p = {k: jnp.asarray(rng.normal(0, 0.05, v.shape), jnp.float32)
             for k, v in p.items()}
    return p


def _runs(model, cfg, jfedn, tfedn, eval_every=2):
    p0 = _init(model)
    hj = jax_run(jax_loss_fn(JAX_MODELS[model][1]), p0, JaxFedConfig(**cfg),
                 jfedn, eval_every=eval_every)
    ht = run_federation(make_loss_fn(SMALL_MODELS[model][1]),
                        params_from_jax(jax.tree.map(np.asarray, p0), "cpu"),
                        FedConfig(**cfg), tfedn, eval_every=eval_every,
                        device="cpu")
    return hj, ht


def _assert_history_parity(hj, ht, n_test, params_extra_atol=0.0):
    np.testing.assert_array_equal(np.array(ht.gates), np.array(hj.gates))
    assert ht.included == hj.included
    assert ht.rounds == hj.rounds
    np.testing.assert_allclose(ht.global_loss, hj.global_loss, rtol=1e-5)
    np.testing.assert_allclose(ht.test_acc, hj.test_acc, rtol=0,
                               atol=1.0 / n_test)
    pj = jax.tree.map(np.asarray, hj.params)
    pt = params_to_numpy(ht.params)
    for k in pj:
        np.testing.assert_allclose(
            pt[k], pj[k], rtol=0,
            atol=1e-4 * np.abs(pj[k]).max() + params_extra_atol, err_msg=k)


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
def test_run_federation_matches_reference(backend):
    cfg = dict(BASE, backend=backend)
    hj, ht = _runs("synth_logreg", cfg, jax_synth(**FED_KW),
                   make_synth_federation(**FED_KW))
    assert 0 < sum(ht.included) < 4 * cfg["rounds"]   # the gate does select
    _assert_history_parity(hj, ht, FED_KW["test_samples"])


VARIANTS = {
    "loss_stat_warmup": dict(align_stat="loss", epsilon=0.5, warmup_frac=0.34),
    "fedprox_paper_decay": dict(algorithm="fedprox", prox_mu=0.1,
                                lr_schedule="paper_decay", mu_strong=2.0,
                                gamma_decay=10.0),
    "all_stragglers": dict(selection="all", straggler_period=3),
    "priority_only_exp_eps": dict(selection="priority_only",
                                  epsilon_schedule="exp", epsilon_decay=0.2),
    "linear_eps_bf16_wire": dict(epsilon_schedule="linear",
                                 epsilon_decay=0.1, agg_dtype="bfloat16"),
    "step_eps_per_leaf": dict(epsilon_schedule="step", epsilon_decay=0.5,
                              fused_agg=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_run_federation_variants_match_reference(variant):
    cfg = dict(BASE, **VARIANTS[variant])
    hj, ht = _runs("synth_logreg", cfg, jax_synth(**FED_KW),
                   make_synth_federation(**FED_KW), eval_every=3)
    _assert_history_parity(hj, ht, FED_KW["test_samples"])


def _prototype_federation(seed=0, C=6, n=24, dim=784, classes=47):
    """A small 784-dim class-prototype federation for mlp2 (the FMNIST /
    EMNIST stand-ins generate 60k images, too many for a unit test)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (classes, dim)).astype(np.float32)
    y = rng.integers(0, 6, (C, n)).astype(np.int32)
    x = (protos[y] + rng.normal(0, 2, (C, n, dim))).astype(np.float32)
    ty = rng.integers(0, 6, 100).astype(np.int32)
    tx = (protos[ty] + rng.normal(0, 2, (100, dim))).astype(np.float32)
    pm = np.zeros(C, bool)
    pm[:2] = True
    w = np.full(C, 0.5, np.float32)
    return (JaxFederation(x, y, pm, w, tx, ty), Federation(x, y, pm, w, tx, ty))


def test_mlp2_run_matches_reference():
    jf, tf = _prototype_federation()
    cfg = dict(num_clients=6, num_priority=2, rounds=3, local_epochs=1,
               epsilon=0.3, lr=0.05, warmup_frac=0.0, batch_size=8)
    hj, ht = _runs("mlp2", cfg, jf, tf, eval_every=1)
    _assert_history_parity(hj, ht, 100)


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
def test_round_fn_stats_match_reference(backend):
    """One make_round_fn call, stats key by key, with the same key."""
    fedn = make_synth_federation(**FED_KW)
    p0 = _init("synth_logreg")
    jfed, fed = JaxFedConfig(**BASE), FedConfig(**BASE)
    jround = jengine.make_round_fn(jax_loss_fn(JAX_MODELS["synth_logreg"][1]),
                                   jfed, backend=backend)
    jstate = jengine.init_state(p0, jfed, 8)
    jdata = {"x": jnp.asarray(fedn.x), "y": jnp.asarray(fedn.y)}
    jargs = (jnp.asarray(fedn.priority_mask), jnp.asarray(fedn.weights))
    tround = engine.make_round_fn(make_loss_fn(SMALL_MODELS["synth_logreg"][1]),
                                  fed, backend=backend)
    tstate = engine.init_state(
        params_from_jax(jax.tree.map(np.asarray, p0), "cpu"), fed, 8)
    tdata = {"x": torch.from_numpy(fedn.x), "y": torch.from_numpy(fedn.y).long()}
    targs = (torch.from_numpy(fedn.priority_mask), torch.from_numpy(fedn.weights))
    for r in range(3):
        jstate, js = jround(jstate, jdata, *jargs,
                            jax.random.fold_in(jax.random.PRNGKey(9), r), r)
        tstate, ts = tround(tstate, tdata, *targs,
                            prng.fold_in(prng.PRNGKey(9), r), r)
        assert sorted(ts) == sorted(js)
        for k in ("round", "gates", "backlog", "warmup",
                  "included_nonpriority"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=k)
        for k in ("lr", "eps", "global_loss", "local_losses", "theta_round"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-5, err_msg=k)
        for name in ("util_ema", "incl_ema"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)),
                                       rtol=1e-5, atol=1e-7, err_msg=name)

